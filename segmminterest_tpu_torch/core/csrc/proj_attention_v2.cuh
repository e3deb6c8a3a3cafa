// The per-(head, batch row) block bodies of K6, the weight-interleaved
// version 2 of the projection-fused two-block attention
// (segmminterest_tpu/core/attention.py _fp2_fwd_kernel :1198 and
// _fp2_bwd_kernel :1253), shared by proj_two_block_attention_v2.cu (K6f)
// and proj_two_block_attention_v2_bwd.cu (K6b).
//
// The Q and K weights arrive interleaved per head, in nn.Linear layout
// (2d, d): rows [2h DH, 2h DH + DH) of Wq_c are wq1's rows of head h and the
// next DH rows wq2's; Wk1_c holds [wk1_h | 0] and Wk2_c [0 | wk2_h]. The
// value weights wv1, wv2 are (d, d). For head h of one batch row a block
// computes, with _proj's rounding (projection.cuh):
//   q_c  (Lq x 2DH)  = [q1_h | q2_h], one row of width 2 DH per query;
//   k_cat (Lk x 2DH) = [k1_h | 0] for the L1 keys of block 1, then
//                      [0 | k2_h] for the L2 keys of block 2 (Lk = L1 + L2);
//   v_cat (Lk x DH)  = v1_h then v2_h;
// then one logit row of Lk per query (q_c . k_cat), fill -10000 where the
// pair mask (query mask x concatenated key mask) is 0, in training
// keep ? l / (1 - rate) : 0 with the mask drawn over (query, concatenated
// key) with salt h (the single-block form of joint_attention.cuh's hash),
// x scale, one fp32 softmax over Lk, p rounded to the value type, PV over
// Lk in fp32.
//
// The structurally zero halves of k_cat are neither projected nor
// multiplied: key j < L1 meets only the first DH columns of q_c and key
// j >= L1 only the second, so the 2 DH contraction is DH products per key,
// as in K2. The shared tile of keys holds the nonzero half of each row.
#pragma once

#include "proj_attention.cuh"

namespace segmm {

// The backward keeps one dp value per key and lane slot in registers: the
// concatenated key axis is at most kV2MaxLk long (each block <= kK2MaxL).
constexpr int kV2MaxLk = 2 * kK2MaxL;
constexpr int kV2Slots = kV2MaxLk / 32;

// K6's ten parameters: Wq_c, bq_c, Wk1_c, bk1_c, Wk2_c, bk2_c (interleaved,
// (2d, d) and (2d,)), then wv1, bv1, wv2, bv2 ((d, d) and (d,)).
template <typename T>
struct V2Weights {
  const T* p[10];
};

template <typename T>
inline V2Weights<T> v2_weights(const void* const* ptrs) {
  V2Weights<T> w;
  for (int i = 0; i < 10; ++i) w.p[i] = static_cast<const T*>(ptrs[i]);
  return w;
}

// Shared-memory bytes of the projected tiles (q_c, then the nonzero halves
// of k_cat and v_cat) and the concatenated masks.
__host__ __device__ inline size_t v2_tile_bytes(int Lq, int Lk, int DH) {
  return sizeof(float) * ((size_t)Lq * tile_stride(2 * DH) + 2 * (size_t)Lk * tile_stride(DH)) +
         sizeof(int) * (size_t)pad4(Lq + Lk);
}

// Shared-memory bytes of proj_v2_fwd_block: the projection stage, the
// tiles, and R probability rows of pad4(Lk) per warp.
inline size_t k6_smem_bytes(bool tensor_cores, int Lq, int L1, int L2, int DH) {
  const int Lk = L1 + L2;
  return k2_stage_bytes(tensor_cores, max3(Lq, L1, L2), DH) + v2_tile_bytes(Lq, Lk, DH) +
         sizeof(float) * (size_t)kK2Warps * kK2Rows * pad4(Lk);
}

// Shared-memory bytes of proj_v2_qkv_bwd_block: the stage, the tiles, g
// (Lq x DH) and the whole (Lq x pad4(Lk)) probability matrix.
inline size_t k6b_smem_bytes(bool tensor_cores, int Lq, int L1, int L2, int DH) {
  const int Lk = L1 + L2;
  return k2_stage_bytes(tensor_cores, max3(Lq, L1, L2), DH) + v2_tile_bytes(Lq, Lk, DH) +
         sizeof(float) * (size_t)Lq * (tile_stride(DH) + pad4(Lk));
}

// q_c, the nonzero halves of k_cat, and v_cat of head h, batch row b, into
// sq (row stride tile_stride(2 DH)), sk and sv (row stride tile_stride(DH),
// block 1's rows first). project_pair reads rows h DH + n of the weight it
// is given, so a pointer advanced by h DH rows reads row 2h DH + n of an
// interleaved weight, and by a further DH rows the second slot.
template <typename T, int DH>
__device__ __forceinline__ void v2_projections(const T* __restrict__ xq, const T* __restrict__ x1,
                                               const T* __restrict__ x2, V2Weights<T> w, int Lq,
                                               int L1, int L2, int dm, int h, int b,
                                               unsigned char* stage, float* sq, float* sk,
                                               float* sv) {
  constexpr int DS = tile_stride(DH);
  const T* const* p = w.p;
  const long hq = (long)h * DH * dm;  // h DH rows of an interleaved weight
  const long half = (long)DH * dm;    // the second slot of a head
  project_pair<T, DH>(xq + (long)b * Lq * dm, Lq, dm, p[0] + hq, p[1] + h * DH,
                      p[0] + hq + half, p[1] + h * DH + DH, h, stage, sq, sq + DH,
                      tile_stride(2 * DH));
  project_pair<T, DH>(x1 + (long)b * L1 * dm, L1, dm, p[2] + hq, p[3] + h * DH, p[6], p[7], h,
                      stage, sk, sv);
  project_pair<T, DH>(x2 + (long)b * L2 * dm, L2, dm, p[4] + hq + half, p[5] + h * DH + DH, p[8],
                      p[9], h, stage, sk + L1 * DS, sv + L1 * DS);
}

// Logits of the warp's query rows qr[] over the concatenated keys (keys
// over the lanes): key j < L1 meets q1 (the first DH columns of its q_c
// row), key j >= L1 meets q2; filled, dropped (kDrop), scaled, written to
// p[r * lds + j] and folded into mx[].
template <int DH, int R, bool kDrop>
__device__ __forceinline__ void concat_logits(const float* sq, const float* sk, const int* smk,
                                              int L1, int Lk, const int* qr, const int* mqr,
                                              float scale, Dropout dr, unsigned salt, float* p,
                                              int lds, float* mx) {
  constexpr int DS = tile_stride(DH), QS = tile_stride(2 * DH);
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < Lk; j += 32) {
    const float* kr = sk + j * DS;
    const float* qh = sq + (j < L1 ? 0 : DH);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qh + qr[r] * QS + d);
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

// Softmax of one row of Lk logits in place, one warp: exp(l - max) / sum,
// rounded to T's precision (the forward's cast before PV) when kRound.
template <typename T, bool kRound>
__device__ __forceinline__ void softmax_row(float* pr, int Lk, float mx) {
  const int lane = threadIdx.x & 31;
  const float m = warp_max(mx);
  float acc = 0.f;
  for (int j = lane; j < Lk; j += 32) {
    const float e = expf(pr[j] - m);
    pr[j] = e;
    acc += e;
  }
  const float s = warp_sum(acc);
  for (int j = lane; j < Lk; j += 32) pr[j] = kRound ? round_to<T>(pr[j] / s) : pr[j] / s;
}

// Forward of head h, batch row b: out row q of the head at
// out + (b * Lq + q) * dm + h * DH. x*, masks and out are the whole
// (B, L, d) / (B, L) tensors.
template <typename T, int DH, bool kDrop>
__device__ __forceinline__ void proj_v2_fwd_block(const T* __restrict__ xq,
                                                  const T* __restrict__ x1,
                                                  const T* __restrict__ x2, V2Weights<T> w,
                                                  const int* __restrict__ mq,
                                                  const int* __restrict__ mk1,
                                                  const int* __restrict__ mk2, T* __restrict__ out,
                                                  int Lq, int L1, int L2, int dm, float scale,
                                                  Dropout dr, int h, int b) {
  constexpr int DS = tile_stride(DH), QS = tile_stride(2 * DH);
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value;
  constexpr int R = kK2Rows;
  const int Lk = L1 + L2, lds = pad4(Lk);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stage = smem;  // first: wmma and float4 need aligned tiles
  float* sq = reinterpret_cast<float*>(smem + k2_stage_bytes(kTc, max3(Lq, L1, L2), DH));
  float* sk = sq + Lq * QS;
  float* sv = sk + Lk * DS;
  int* smq = reinterpret_cast<int*>(sv + Lk * DS);
  int* smk = smq + Lq;  // block 1's key mask, then block 2's
  float* pbuf = reinterpret_cast<float*>(smq + pad4(Lq + Lk));

  v2_projections<T, DH>(xq, x1, x2, w, Lq, L1, L2, dm, h, b, stage, sq, sk, sv);
  load_masks(mq, mk1, mk2, b, Lq, L1, L2, smq, smk, smk + L1);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* p = pbuf + (size_t)warp * R * lds;
  T* o = out + (long)b * Lq * dm + h * DH;
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
    concat_logits<DH, R, kDrop>(sq, sk, smk, L1, Lk, qr, mqr, scale, dr, (unsigned)h, p, lds, mx);
#pragma unroll
    for (int r = 0; r < R; ++r) softmax_row<T, true>(p + r * lds, Lk, mx[r]);
    __syncwarp();
    for (int d = lane; d < DH; d += 32) {
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = 0.f;
      block_av<R>(p, lds, sv, DS, Lk, d, a);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (q0 + r < Lq) o[(long)(q0 + r) * dm + d] = from_f<T>(a[r]);
    }
    __syncwarp();
  }
}

// The qkv pass of head h, batch row b: fp32 dq_c into (B, Lq, 2d) (head h
// at columns [2h DH, 2h DH + 2DH): dq1 then dq2), and the gradients of the
// nonzero halves of the keys and of the values, dk1, dv1 (B, L1, d) and
// dk2, dv2 (B, L2, d). The halves of dk_cat that meet the interleaved
// weights' zeros are not formed: their weight gradients are thrown away.
// g: (B, Lq, d) in T.
template <typename T, int DH, bool kDrop>
__device__ __forceinline__ void proj_v2_qkv_bwd_block(
    const T* __restrict__ xq, const T* __restrict__ x1, const T* __restrict__ x2,
    V2Weights<T> w, const int* __restrict__ mq, const int* __restrict__ mk1,
    const int* __restrict__ mk2, const T* __restrict__ g, float* __restrict__ dqc,
    float* __restrict__ dk1, float* __restrict__ dk2, float* __restrict__ dv1,
    float* __restrict__ dv2, int Lq, int L1, int L2, int dm, float scale, Dropout dr, int h,
    int b) {
  constexpr int DS = tile_stride(DH), QS = tile_stride(2 * DH);
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value;
  const int H = dm / DH, Lk = L1 + L2, lds = pad4(Lk);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stage = smem;
  float* sq = reinterpret_cast<float*>(smem + k2_stage_bytes(kTc, max3(Lq, L1, L2), DH));
  float* sk = sq + Lq * QS;
  float* sv = sk + Lk * DS;
  int* smq = reinterpret_cast<int*>(sv + Lk * DS);
  int* smk = smq + Lq;
  float* sg = reinterpret_cast<float*>(smq + pad4(Lq + Lk));
  float* P = sg + Lq * DS;

  v2_projections<T, DH>(xq, x1, x2, w, Lq, L1, L2, dm, h, b, stage, sq, sk, sv);
  load_head_rows<T>(g, sg, b, Lq, H, h, DH, DS);
  load_masks(mq, mk1, mk2, b, Lq, L1, L2, smq, smk, smk + L1);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  // 1. probabilities in fp32 (not rounded), one warp per query row
  for (int i = warp; i < Lq; i += nwarps) {
    float* pr = P + (size_t)i * lds;
    const int qi[1] = {i}, mqi[1] = {smq[i]};
    float mx[1] = {-INFINITY};
    concat_logits<DH, 1, kDrop>(sq, sk, smk, L1, Lk, qi, mqi, scale, dr, (unsigned)h, pr, lds,
                                mx);
    softmax_row<float, false>(pr, Lk, mx[0]);
  }
  __syncthreads();

  // 2. dv_cat = p^T g: block 1's rows, then block 2's
  const long o1 = (long)b * L1 * dm + h * DH, o2 = (long)b * L2 * dm + h * DH;
  rows_times_tile<float>(P, 1, lds, Lq, sg, DS, DH, L1, dv1 + o1, (long)dm);
  rows_times_tile<float>(P + L1, 1, lds, Lq, sg, DS, DH, L2, dv2 + o2, (long)dm);
  __syncthreads();

  // 3. dl = p (dp - sum dp p) scale, then the dropout mask, then the pair
  // mask, in place of p; one warp per query row, dp in registers
  for (int i = warp; i < Lq; i += nwarps) {
    float* pr = P + (size_t)i * lds;
    const float* gi = sg + i * DS;
    const int mqi = smq[i];
    float dp[kV2Slots];
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < kV2Slots; ++t) {
      const int j = lane + 32 * t;
      dp[t] = j < Lk ? dot_rows(gi, sv + j * DS, DH) : 0.f;
      if (j < Lk) part = fmaf(dp[t], pr[j], part);
    }
    const float s = warp_sum(part);
#pragma unroll
    for (int t = 0; t < kV2Slots; ++t) {
      const int j = lane + 32 * t;
      if (j < Lk) {
        float dl = pr[j] * (dp[t] - s) * scale;
        if (kDrop) dl = dropout_keep(dr, i, j, (unsigned)h) ? dl / dr.keep_div : 0.f;
        pr[j] = (mqi * smk[j]) > 0 ? dl : 0.f;
      }
    }
  }
  __syncthreads();

  // 4. dq_c = dl k_cat: its first half from block 1's keys, its second from
  // block 2's; 5. the nonzero halves of dk_cat = dl^T q_c: block 1's keys
  // against q1, block 2's against q2
  const long oq = (long)b * Lq * 2 * dm + 2 * h * DH;
  rows_times_tile<float>(P, lds, 1, L1, sk, DS, DH, Lq, dqc + oq, 2L * dm);
  rows_times_tile<float>(P + L1, lds, 1, L2, sk + L1 * DS, DS, DH, Lq, dqc + oq + DH, 2L * dm);
  rows_times_tile<float>(P, 1, lds, Lq, sq, QS, DH, L1, dk1 + o1, (long)dm);
  rows_times_tile<float>(P + L1, 1, lds, Lq, sq + DH, QS, DH, L2, dk2 + o2, (long)dm);
  __syncthreads();
}

}  // namespace segmm
