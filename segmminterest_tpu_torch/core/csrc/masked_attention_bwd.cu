// K3b: single-block masked attention, backward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _bwd_kernel
// (:156), launched by _call_bwd (:249, pallas_call :281) from the custom VJP
// of fused_masked_attention (:297-321). Nothing of the forward is saved: the
// kernel recomputes the probabilities in fp32 from q, k and the masks (and
// the dropout mask from the seed, salt h), then
//   dv = p^T g,  dp = g v^T,  dl = p (dp - sum dp p) scale, dropout mask and
//   divisor, pair mask,  dq = dl k,  dk = dl^T q,
// all in fp32, and writes dq, dk, dv in the input dtype. Inputs (B, L, H, D)
// contiguous, fp32 or bf16, Dqk = Dv = D; masks int32 (B, L); g (B, Lq, H, D).
//
// Design: K1b's with one key block. One thread block per (head, batch row)
// stages q, g, k and v as fp32 and keeps the whole (Lq x Lk) probability
// matrix in shared memory, which dl then overwrites in place (at (40, 100) or
// (100, 40), D=32: 56 KB). Logits and dp split the keys over the lanes (each
// lane holds up to four keys of a row in registers, so Lk <= 128); the three
// products give each lane one column of the head and each warp four rows.
//
// What bounds it on an H100: device memory. It reads q, k, v and g once and
// writes dq, dk and dv (1.09 GB in fp32 at B=1024, (40, 100), 16 heads of 32)
// against ~10 Lq Lk D FLOP per (row, head) (21 GFLOP), about as long on the
// fp32 units. This first version waits on its fp32 FMAs with every operand
// in shared memory.
#include "joint_attention.cuh"

namespace segmm {

constexpr int kK3bThreads = 256;

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kK3bThreads)
masked_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ mq, const int* __restrict__ mk,
                  const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
                  T* __restrict__ dv, int Lq, int Lk, int H, int D, float scale, float rate,
                  float keep_div, unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int ds = tile_stride(D);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sg = sq + Lq * ds;
  float* sk = sg + Lq * ds;
  float* sv = sk + Lk * ds;
  int* smq = reinterpret_cast<int*>(sv + Lk * ds);
  int* smk = smq + Lq;
  float* P = reinterpret_cast<float*>(smq + pad4(Lq + Lk));

  load_head_rows<T>(q, sq, b, Lq, H, h, D, ds);
  load_head_rows<T>(g, sg, b, Lq, H, h, D, ds);
  load_head_rows<T>(k, sk, b, Lk, H, h, D, ds);
  load_head_rows<T>(v, sv, b, Lk, H, h, D, ds);
  for (int i = threadIdx.x; i < Lq; i += blockDim.x) smq[i] = mq[(long)b * Lq + i];
  for (int i = threadIdx.x; i < Lk; i += blockDim.x) smk[i] = mk[(long)b * Lk + i];
  __syncthreads();

  const Dropout dr = make_dropout(rate, keep_div, seed, b, gridDim.y);
  const unsigned salt = (unsigned)h;
  const int lds = pad4(Lk);

  // 1. probabilities in fp32 (not rounded), one warp per query row
  for (int i = warp; i < Lq; i += nwarps) {
    float* pr = P + (size_t)i * lds;
    const int qi[1] = {i}, mqi[1] = {smq[i]};
    float mx[1] = {-INFINITY};
    block_logits<1, kDrop>(sq, sk, ds, D, smk, Lk, qi, mqi, scale, dr, salt, pr, lds, mx);
    const float m = warp_max(mx[0]);
    float acc = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      acc += e;
    }
    const float s = warp_sum(acc);
    for (int j = lane; j < Lk; j += 32) pr[j] = pr[j] / s;
  }
  __syncthreads();

  const long stride = (long)H * D;
  const long oq = ((long)b * Lq * H + h) * D;
  const long ok = ((long)b * Lk * H + h) * D;
  // 2. dv = p^T g
  rows_times_tile<T>(P, 1, lds, Lq, sg, ds, D, Lk, dv + ok, stride);
  __syncthreads();

  // 3. dl in place of p, one warp per query row; dp stays in registers
  for (int i = warp; i < Lq; i += nwarps) {
    float* pr = P + (size_t)i * lds;
    const float* gi = sg + i * ds;
    const int mqi = smq[i];
    float dp[kBwdSlots];
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < kBwdSlots; ++t) {
      const int j = lane + 32 * t;
      dp[t] = j < Lk ? dot_rows(gi, sv + j * ds, D) : 0.f;
      if (j < Lk) part = fmaf(dp[t], pr[j], part);
    }
    const float s = warp_sum(part);
#pragma unroll
    for (int t = 0; t < kBwdSlots; ++t) {
      const int j = lane + 32 * t;
      if (j < Lk) {
        float dl = pr[j] * (dp[t] - s) * scale;
        if (kDrop) dl = dropout_keep(dr, i, j, salt) ? dl / dr.keep_div : 0.f;
        pr[j] = (mqi * smk[j]) > 0 ? dl : 0.f;
      }
    }
  }
  __syncthreads();

  // 4. dq = dl k and 5. dk = dl^T q
  rows_times_tile<T>(P, lds, 1, Lk, sk, ds, D, Lq, dq + oq, stride);
  rows_times_tile<T>(P, 1, lds, Lq, sq, ds, D, Lk, dk + ok, stride);
}

inline size_t k3b_smem_bytes(int Lq, int Lk, int D) {
  return sizeof(float) * (size_t)(2 * Lq + 2 * Lk) * tile_stride(D) +
         sizeof(int) * (size_t)pad4(Lq + Lk) + sizeof(float) * (size_t)Lq * pad4(Lk);
}

template <typename T, bool kDrop>
cudaError_t launch_k3b_variant(const void* q, const void* k, const void* v, const int* mq,
                               const int* mk, const void* g, void* dq, void* dk, void* dv, int B,
                               int Lq, int Lk, int H, int D, float scale, float rate,
                               float keep_div, unsigned seed, cudaStream_t stream) {
  const size_t smem = k3b_smem_bytes(Lq, Lk, D);
  cudaError_t err = cudaFuncSetAttribute(masked_bwd_kernel<T, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  masked_bwd_kernel<T, kDrop><<<dim3(H, B), kK3bThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mq, mk,
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      Lq, Lk, H, D, scale, rate, keep_div, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k3b(const void* q, const void* k, const void* v, const int* mq, const int* mk,
                       const void* g, void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H,
                       int D, float scale, float rate, float keep_div, unsigned seed,
                       cudaStream_t stream) {
  auto launch = rate > 0.f ? launch_k3b_variant<T, true> : launch_k3b_variant<T, false>;
  return launch(q, k, v, mq, mk, g, dq, dk, dv, B, Lq, Lk, H, D, scale, rate, keep_div, seed,
                stream);
}

}  // namespace segmm

// dtype: 0 = float32, 1 = bfloat16. Inputs q, k, v, the masks and g;
// outputs dq, dk, dv (same shapes and dtype as q, k, v). Lq, Lk <= 128,
// D in {16, 32, 64} (the wrapper checks). Returns a cudaError_t (0 =
// launched).
extern "C" int segmm_masked_attention_bwd(int dtype, const void* q, const void* k,
                                          const void* v, const int* mq, const int* mk,
                                          const void* g, void* dq, void* dk, void* dv, int B,
                                          int Lq, int Lk, int H, int D, float scale, float rate,
                                          float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)segmm::launch_k3b<float>(q, k, v, mq, mk, g, dq, dk, dv, B, Lq, Lk, H, D, scale,
                                         rate, keep_div, seed, s);
  if (dtype == 1)
    return (int)segmm::launch_k3b<__nv_bfloat16>(q, k, v, mq, mk, g, dq, dk, dv, B, Lq, Lk, H,
                                                 D, scale, rate, keep_div, seed, s);
  return (int)cudaErrorInvalidValue;
}
