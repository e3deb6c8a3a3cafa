// Shared device code of the two-block attention kernels (K1, K2, forward and
// backward): type conversion, warp reductions, the dropout mask and the
// joint-softmax core in both directions.
//
// The forward core is the CUDA counterpart of
// segmminterest_tpu/core/attention.py _joint_probs (:374-396) followed by
// the two AV products of _attn_group_fwd (:399-445): logits of one query
// row over two key blocks, fill -10000 where the pair mask is 0, in training
// keep ? l / (1 - rate) : 0, x scale (the fill comes first), one fp32
// softmax over both blocks, probabilities rounded to the value type, p1.v1
// and p2.v2 accumulated in fp32 and summed before the output cast. A fully
// padded query row keeps its -10000 logits, so it becomes the uniform
// softmax of a constant, exactly as on the TPU.
//
// The backward core is the counterpart of _attn_group_bwd (:448-524):
// probabilities recomputed in fp32 (not rounded), dv = p^T g,
// dp = g v^T, s = sum dp1 p1 + sum dp2 p2 over both blocks,
// dl = p (dp - s) scale, then the dropout mask, then the pair mask,
// dq = dl k, dk = dl^T q, all accumulated in fp32.
//
// The operands all sit in shared memory, so shared-memory loads per FMA
// count: the logits read q and k four values at a time (16-byte loads) and
// may take R query rows at once, so that one key read serves every row;
// the products of the backward give each lane one column of the head and
// each warp four rows, so that one load of a q/k/v/g value serves four FMAs.
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

// ---------------------------------------------------------------------------
// Dropout on the attention logits: the interpret-mode hash of the JAX
// package (attention.py:114-123), so that the kernels draw the bits the JAX
// kernels draw under interpret=True. Iota axes: row within the batch tile
// (8 rows when B % 8 == 0, else all B), query row, key column within the
// block; seed = caller's seed + batch tile index; salt = 2h (block 1) or
// 2h + 1 (block 2); uint32 arithmetic with wrap-around.
struct Dropout {
  float rate;      // > 0 (kernels without dropout are separate instantiations)
  float keep_div;  // 1 - rate, formed in double and rounded once to fp32 by the caller
  unsigned seed;   // caller's seed + batch tile index
  unsigned row;    // row within the batch tile
};

__device__ __forceinline__ Dropout make_dropout(float rate, float keep_div, unsigned seed, int b,
                                                int B) {
  const int bt = (B % 8 == 0) ? 8 : B;
  return Dropout{rate, keep_div, seed + (unsigned)(b / bt), (unsigned)(b % bt)};
}

__device__ __forceinline__ bool dropout_keep(Dropout dr, int i, int j, unsigned salt) {
  unsigned h = ((dr.row * 2654435761u) ^ ((unsigned)i * 40503u) ^ ((unsigned)j * 69069u)) +
               dr.seed * 2246822519u + salt * 3266489917u;
  h = (h ^ (h >> 15)) * 2246822519u;
  h = h ^ (h >> 13);
  const float u = (float)(h >> 8) * (1.0f / 16777216.0f);
  return u >= dr.rate;
}

// ---------------------------------------------------------------------------
// Staging: head h of batch row b of a (B, L, H, D) tensor (rows of H * D
// values) into a float tile of row stride ds.
template <typename T>
__device__ __forceinline__ void load_head_rows(const T* __restrict__ src, float* dst, int b, int L,
                                               int H, int h, int D, int ds) {
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    dst[r * ds + d] = to_f<T>(src[(((long)b * L + r) * H + h) * D + d]);
  }
}

__device__ __forceinline__ void load_masks(const int* __restrict__ mq, const int* __restrict__ mk1,
                                           const int* __restrict__ mk2, int b, int Lq, int L1,
                                           int L2, int* smq, int* smk1, int* smk2) {
  for (int i = threadIdx.x; i < Lq; i += blockDim.x) smq[i] = mq[(long)b * Lq + i];
  for (int i = threadIdx.x; i < L1; i += blockDim.x) smk1[i] = mk1[(long)b * L1 + i];
  for (int i = threadIdx.x; i < L2; i += blockDim.x) smk2[i] = mk2[(long)b * L2 + i];
}

// Floats of one probability row: block 1 at [0, L1), block 2 at
// [pad4(L1), pad4(L1) + L2), each 16-byte aligned.
__host__ __device__ inline int prob_row_len(int L1, int L2) { return pad4(L1) + pad4(L2); }

// Shared-memory bytes the forward core needs beyond the six q/k/v tiles: the
// three masks (padded to keep what follows 16-byte aligned) and R
// probability rows per warp.
__host__ __device__ inline size_t core_extra_bytes(int Lq, int L1, int L2, int nwarps, int R) {
  return sizeof(int) * (size_t)pad4(Lq + L1 + L2) +
         sizeof(float) * (size_t)nwarps * R * prob_row_len(L1, L2);
}

// Shared-memory bytes of the backward core: seven tiles (q1, q2, g, k1, v1,
// k2, v2), the masks and the whole (Lq x prob_row_len) probability matrix,
// which is overwritten by dl.
__host__ __device__ inline size_t bwd_core_bytes(int Lq, int L1, int L2, int D) {
  return sizeof(float) * (size_t)(3 * Lq + 2 * L1 + 2 * L2) * tile_stride(D) +
         sizeof(int) * (size_t)pad4(Lq + L1 + L2) +
         sizeof(float) * (size_t)Lq * prob_row_len(L1, L2);
}

// Logits of the warp's query rows qr[] against one key block (keys split over
// the lanes): filled, dropped (kDrop: training with rate > 0), scaled,
// written to p[r * lds + j] and folded into mx[].
template <int R, bool kDrop>
__device__ __forceinline__ void block_logits(const float* sq, const float* sk, int ds, int D,
                                             const int* smk, int L, const int* qr,
                                             const int* mqr, float scale, Dropout dr,
                                             unsigned salt, float* p, int lds, float* mx) {
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
      float l = (mqr[r] * mk) > 0 ? acc[r] : kMaskFill;
      if (kDrop) l = dropout_keep(dr, qr[r], j, salt) ? l / dr.keep_div : 0.f;
      l *= scale;
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

// Forward. R query rows per warp at a time. sq*/sk*/sv* are float tiles in
// shared memory with row stride ds = tile_stride(D), 16-byte aligned; pbuf
// holds R prob_row_len(L1, L2) rows per warp, 16-byte aligned. Row q of the
// output is written at out + q * out_row_stride (D contiguous values). h is
// the head (the dropout salt); kDrop applies the dropout mask.
template <typename T, int R, bool kDrop>
__device__ void joint_attention_rows(
    const float* sq1, const float* sq2, const float* sk1, const float* sk2,
    const float* sv1, const float* sv2, int ds, int D,
    const int* smq, const int* smk1, const int* smk2,
    int Lq, int L1, int L2, float scale, Dropout dr, int h, float* pbuf,
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
    block_logits<R, kDrop>(sq1, sk1, ds, D, smk1, L1, qr, mqr, scale, dr, 2u * h, p, lds, mx);
    block_logits<R, kDrop>(sq2, sk2, ds, D, smk2, L2, qr, mqr, scale, dr, 2u * h + 1u, p + off2,
                           lds, mx);
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

// ---------------------------------------------------------------------------
// Backward helpers.

constexpr int kBwdRows = 4;  // output rows per warp in the backward products
constexpr int kBwdMaxL = 128;
constexpr int kBwdSlots = kBwdMaxL / 32;  // keys per lane and block

// out[r * out_stride + d] = sum_{k < K} A[r * sr + k * sk] * S[k * ds + d]
// for r < nrows and d < D: a warp takes kBwdRows rows, a lane one column
// (the A reads are broadcasts, the S reads conflict-free), k in order.
template <typename TOut>
__device__ void rows_times_tile(const float* A, int sr, int sk, int K, const float* S, int ds,
                                int D, int nrows, TOut* out, long out_stride) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r0 = warp * kBwdRows; r0 < nrows; r0 += nwarps * kBwdRows) {
    const float* ar[kBwdRows];
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) ar[r] = A + (long)min(r0 + r, nrows - 1) * sr;
    for (int d = lane; d < D; d += 32) {
      float acc[kBwdRows];
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) acc[r] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float s = S[k * ds + d];
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) acc[r] = fmaf(ar[r][(long)k * sk], s, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r)
        if (r0 + r < nrows) out[(long)(r0 + r) * out_stride + d] = from_f<TOut>(acc[r]);
    }
  }
}

__device__ __forceinline__ float dot_rows(const float* a, const float* b, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// Backward of one (batch row, head). Tiles in shared memory with row stride
// ds (q1, q2, g: Lq rows; k1, v1: L1; k2, v2: L2), masks, and P: Lq rows of
// prob_row_len(L1, L2) floats. Every length <= kBwdMaxL. Outputs: row r of
// each gradient at <ptr> + r * out_stride (D values), in TOut; kDrop applies
// the dropout mask. Ends with a __syncthreads, so the caller may reuse the
// shared memory.
template <typename TOut, bool kDrop>
__device__ void joint_attention_bwd(
    const float* sq1, const float* sq2, const float* sg, const float* sk1, const float* sv1,
    const float* sk2, const float* sv2, int ds, int D, const int* smq, const int* smk1,
    const int* smk2, int Lq, int L1, int L2, float scale, Dropout dr, int h, float* P,
    TOut* dq1, TOut* dq2, TOut* dk1, TOut* dk2, TOut* dv1, TOut* dv2, long out_stride) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int off2 = pad4(L1);
  const int lds = prob_row_len(L1, L2);
  const unsigned salt1 = 2u * h, salt2 = 2u * h + 1u;

  // 1. probabilities in fp32, one warp per query row
  for (int i = warp; i < Lq; i += nwarps) {
    float* pr = P + (size_t)i * lds;
    const int qi[1] = {i}, mqi[1] = {smq[i]};
    float mx[1] = {-INFINITY};
    block_logits<1, kDrop>(sq1, sk1, ds, D, smk1, L1, qi, mqi, scale, dr, salt1, pr, lds, mx);
    block_logits<1, kDrop>(sq2, sk2, ds, D, smk2, L2, qi, mqi, scale, dr, salt2, pr + off2, lds,
                           mx);
    const float m = warp_max(mx[0]);
    float acc = 0.f;
    for (int j = lane; j < L1; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      acc += e;
    }
    for (int j = lane; j < L2; j += 32) {
      const float e = expf(pr[off2 + j] - m);
      pr[off2 + j] = e;
      acc += e;
    }
    const float s = warp_sum(acc);
    for (int j = lane; j < L1; j += 32) pr[j] = pr[j] / s;
    for (int j = lane; j < L2; j += 32) pr[off2 + j] = pr[off2 + j] / s;
  }
  __syncthreads();

  // 2. dv = p^T g for both blocks
  rows_times_tile<TOut>(P, 1, lds, Lq, sg, ds, D, L1, dv1, out_stride);
  rows_times_tile<TOut>(P + off2, 1, lds, Lq, sg, ds, D, L2, dv2, out_stride);
  __syncthreads();

  // 3. dl in place of p, one warp per query row; dp stays in registers
  for (int i = warp; i < Lq; i += nwarps) {
    float* pr = P + (size_t)i * lds;
    const float* gi = sg + i * ds;
    const int mqi = smq[i];
    float dp1[kBwdSlots], dp2[kBwdSlots];
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < kBwdSlots; ++t) {
      const int j = lane + 32 * t;
      dp1[t] = j < L1 ? dot_rows(gi, sv1 + j * ds, D) : 0.f;
      dp2[t] = j < L2 ? dot_rows(gi, sv2 + j * ds, D) : 0.f;
      if (j < L1) part = fmaf(dp1[t], pr[j], part);
      if (j < L2) part = fmaf(dp2[t], pr[off2 + j], part);
    }
    const float s = warp_sum(part);
#pragma unroll
    for (int t = 0; t < kBwdSlots; ++t) {
      const int j = lane + 32 * t;
      if (j < L1) {
        float dl = pr[j] * (dp1[t] - s) * scale;
        if (kDrop) dl = dropout_keep(dr, i, j, salt1) ? dl / dr.keep_div : 0.f;
        pr[j] = (mqi * smk1[j]) > 0 ? dl : 0.f;
      }
      if (j < L2) {
        float dl = pr[off2 + j] * (dp2[t] - s) * scale;
        if (kDrop) dl = dropout_keep(dr, i, j, salt2) ? dl / dr.keep_div : 0.f;
        pr[off2 + j] = (mqi * smk2[j]) > 0 ? dl : 0.f;
      }
    }
  }
  __syncthreads();

  // 4. dq = dl k and 5. dk = dl^T q
  rows_times_tile<TOut>(P, lds, 1, L1, sk1, ds, D, Lq, dq1, out_stride);
  rows_times_tile<TOut>(P + off2, lds, 1, L2, sk2, ds, D, Lq, dq2, out_stride);
  rows_times_tile<TOut>(P, 1, lds, Lq, sq1, ds, D, L1, dk1, out_stride);
  rows_times_tile<TOut>(P + off2, 1, lds, Lq, sq2, ds, D, L2, dk2, out_stride);
  __syncthreads();
}

}  // namespace segmm
