// Shared device code of the two-block attention kernels (K1, K2): type
// conversion, warp reductions and the joint-softmax core.
//
// The core is the CUDA counterpart of segmminterest_tpu/core/attention.py
// _joint_probs (:374-396) followed by the two AV products of
// _attn_group_fwd (:399-445): logits of one query row over two key blocks,
// fill -10000 where the pair mask is 0, x scale (the fill comes first),
// one fp32 softmax over both blocks, probabilities rounded to the value
// type, p1.v1 and p2.v2 accumulated in fp32 and summed before the output
// cast. A fully padded query row keeps its -10000 logits, so it becomes the
// uniform softmax of a constant, exactly as on the TPU.
//
// Its operands all sit in shared memory, so shared-memory loads per FMA
// count: each warp reads q, k and p four values at a time (16-byte loads),
// and may take R query rows at once, so that one key or value read serves
// every row. More rows need more shared memory for probabilities (fewer
// blocks per SM), so each kernel picks its R.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace segmm {

constexpr float kMaskFill = -10000.0f;
// Row stride (floats) of the q/k/v tiles for head dim D (D % 4 == 0): a
// multiple of 4 for 16-byte loads, and 4 mod 32 words, so that the eight
// lanes of one 16-byte load phase reading eight key rows hit all 32 banks.
__host__ __device__ constexpr int tile_stride(int D) { return D + 4; }

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded to T's precision, returned as float
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Floats of one probability row: block 1 at [0, L1), block 2 at
// [pad4(L1), pad4(L1) + L2), each 16-byte aligned.
__host__ __device__ inline int prob_row_len(int L1, int L2) { return pad4(L1) + pad4(L2); }

// Shared-memory bytes the core needs beyond the six q/k/v tiles: the three
// masks (padded to keep what follows 16-byte aligned) and R probability
// rows per warp.
__host__ __device__ inline size_t core_extra_bytes(int Lq, int L1, int L2, int nwarps, int R) {
  return sizeof(int) * (size_t)pad4(Lq + L1 + L2) +
         sizeof(float) * (size_t)nwarps * R * prob_row_len(L1, L2);
}

// Logits of the warp's query rows qr[] against one key block (keys split over
// the lanes), filled, scaled, written to p[r * lds + j] and folded into mx[].
template <int R>
__device__ __forceinline__ void block_logits(const float* sq, const float* sk, int ds, int D,
                                             const int* smk, int L, const int* qr,
                                             const int* mqr, float scale, float* p, int lds,
                                             float* mx) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < L; j += 32) {
    const float* kr = sk + j * ds;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(sq + qr[r] * ds + d);
        acc[r] = fmaf(qv.x, kv.x, acc[r]);
        acc[r] = fmaf(qv.y, kv.y, acc[r]);
        acc[r] = fmaf(qv.z, kv.z, acc[r]);
        acc[r] = fmaf(qv.w, kv.w, acc[r]);
      }
    }
    const int mk = smk[j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float l = ((mqr[r] * mk) > 0 ? acc[r] : kMaskFill) * scale;
      p[r * lds + j] = l;
      mx[r] = fmaxf(mx[r], l);
    }
  }
}

// a[r] += sum_j p[r * lds + j] * sv[j * ds + d] over one value block, j in order.
template <int R>
__device__ __forceinline__ void block_av(const float* p, int lds, const float* sv, int ds,
                                         int L, int d, float* a) {
  int j = 0;
  for (; j + 4 <= L; j += 4) {
    const float v0 = sv[j * ds + d], v1 = sv[(j + 1) * ds + d];
    const float v2 = sv[(j + 2) * ds + d], v3 = sv[(j + 3) * ds + d];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(p + r * lds + j);
      a[r] = fmaf(pv.x, v0, a[r]);
      a[r] = fmaf(pv.y, v1, a[r]);
      a[r] = fmaf(pv.z, v2, a[r]);
      a[r] = fmaf(pv.w, v3, a[r]);
    }
  }
  for (; j < L; ++j) {
    const float v = sv[j * ds + d];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = fmaf(p[r * lds + j], v, a[r]);
  }
}

// R query rows per warp at a time. sq*/sk*/sv* are float tiles in shared
// memory with row stride ds = tile_stride(D), 16-byte aligned; pbuf holds R
// prob_row_len(L1, L2) rows per warp, 16-byte aligned. Row q of the output
// is written at out + q * out_row_stride (D contiguous values).
template <typename T, int R>
__device__ void joint_attention_rows(
    const float* sq1, const float* sq2, const float* sk1, const float* sk2,
    const float* sv1, const float* sv2, int ds, int D,
    const int* smq, const int* smk1, const int* smk2,
    int Lq, int L1, int L2, float scale, float* pbuf,
    T* out, long out_row_stride) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int off2 = pad4(L1);
  const int lds = prob_row_len(L1, L2);
  float* p = pbuf + (size_t)warp * R * lds;
  for (int q0 = warp * R; q0 < Lq; q0 += nwarps * R) {
    // rows past Lq repeat the last row and are not written
    int qr[R], mqr[R];
    float mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      qr[r] = min(q0 + r, Lq - 1);
      mqr[r] = smq[qr[r]];
      mx[r] = -INFINITY;
    }
    block_logits<R>(sq1, sk1, ds, D, smk1, L1, qr, mqr, scale, p, lds, mx);
    block_logits<R>(sq2, sk2, ds, D, smk2, L2, qr, mqr, scale, p + off2, lds, mx);
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mx[r] = warp_max(mx[r]);
      float* pr = p + r * lds;
      float acc = 0.f;
      for (int j = lane; j < L1; j += 32) {
        const float e = expf(pr[j] - mx[r]);
        pr[j] = e;
        acc += e;
      }
      for (int j = lane; j < L2; j += 32) {
        const float e = expf(pr[off2 + j] - mx[r]);
        pr[off2 + j] = e;
        acc += e;
      }
      s[r] = warp_sum(acc);
      for (int j = lane; j < L1; j += 32) pr[j] = round_to<T>(pr[j] / s[r]);
      for (int j = lane; j < L2; j += 32) pr[off2 + j] = round_to<T>(pr[off2 + j] / s[r]);
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float a1[R], a2[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a1[r] = a2[r] = 0.f;
      block_av<R>(p, lds, sv1, ds, L1, d, a1);
      block_av<R>(p + off2, lds, sv2, ds, L2, d, a2);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (q0 + r < Lq) out[(long)(q0 + r) * out_row_stride + d] = from_f<T>(a1[r] + a2[r]);
    }
    __syncwarp();
  }
}

}  // namespace segmm
