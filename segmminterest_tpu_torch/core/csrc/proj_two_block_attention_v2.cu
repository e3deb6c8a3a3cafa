// K6f: projection-fused two-block attention, version 2 (weight-interleaved
// concat-KV), forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py
// _fp2_fwd_kernel (:1198), launched by _fp2_call_fwd (:1375) behind
// fused_proj_two_block_attention version 2 (SEGMM_ATTN_V2=1, :1116-1131).
// The function is K2f's; the dropout mask is drawn once over (query,
// concatenated key) with salt h, and the softmax and PV run over one key
// axis of Lk = L1 + L2 (proj_attention_v2.cuh).
//
// Design: one thread block (256 threads, 8 warps) per (head, batch row), as
// K2f. The block projects its head's q row of width 2 DH from the
// interleaved Wq_c, the nonzero half of each concatenated key row from
// Wk1_c / Wk2_c and the values from wv1 / wv2 (projection.cuh: wmma tensor
// cores in bf16, CUDA cores in fp32), keeps them in shared memory as fp32,
// then takes two query rows per warp: one logit row of Lk floats, one
// softmax, one PV over Lk. The zero halves of Wk1_c / Wk2_c are not
// multiplied, so the logit loop does DH products per key, as K2f's.
//
// What bounds it on an H100: operations, as K2f (the same projections and
// the same logit and PV products). This first version re-reads x and the
// weight slices from L2 for every (head, batch row) and runs the attention
// core as fp32 FMAs from shared memory, as K2f does.
#include "proj_attention_v2.cuh"

namespace segmm {

template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kK2Threads)
proj_v2_fwd_kernel(const T* __restrict__ xq, const T* __restrict__ x1, const T* __restrict__ x2,
                   V2Weights<T> w, const int* __restrict__ mq, const int* __restrict__ mk1,
                   const int* __restrict__ mk2, T* __restrict__ out, int Lq, int L1, int L2,
                   int dm, float scale, float rate, float keep_div, unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  proj_v2_fwd_block<T, DH, kDrop>(xq, x1, x2, w, mq, mk1, mk2, out, Lq, L1, L2, dm, scale,
                                  make_dropout(rate, keep_div, seed, b, gridDim.y), h, b);
}

template <typename T, int DH>
cudaError_t launch_v2_fwd(const void* const* p, const int* mq, const int* mk1, const int* mk2,
                          void* out, int B, int Lq, int L1, int L2, int dm, float scale,
                          float rate, float keep_div, unsigned seed, cudaStream_t stream) {
  const size_t smem = k6_smem_bytes(std::is_same<T, __nv_bfloat16>::value, Lq, L1, L2, DH);
  auto kernel = rate > 0.f ? proj_v2_fwd_kernel<T, DH, true> : proj_v2_fwd_kernel<T, DH, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const T* const* a = reinterpret_cast<const T* const*>(p);
  kernel<<<dim3(dm / DH, B), kK2Threads, smem, stream>>>(
      a[0], a[1], a[2], v2_weights<T>(p + 3), mq, mk1, mk2, static_cast<T*>(out), Lq, L1, L2,
      dm, scale, rate, keep_div, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_v2_fwd(int DH, const void* const* p, const int* mq, const int* mk1,
                            const int* mk2, void* out, int B, int Lq, int L1, int L2, int dm,
                            float scale, float rate, float keep_div, unsigned seed,
                            cudaStream_t s) {
#define SEGMM_K6(DH_)                                                                          \
  launch_v2_fwd<T, DH_>(p, mq, mk1, mk2, out, B, Lq, L1, L2, dm, scale, rate, keep_div, seed, \
                        s)
  switch (DH) {
    case 16: return SEGMM_K6(16);
    case 32: return SEGMM_K6(32);
    case 64: return SEGMM_K6(64);
    default: return cudaErrorInvalidValue;
  }
#undef SEGMM_K6
}

}  // namespace segmm

// dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t segmm_proj_two_block_attention_v2_smem_bytes(int dtype, int Lq, int L1, int L2,
                                                               int DH) {
  return segmm::k6_smem_bytes(dtype == 1, Lq, L1, L2, DH);
}

// ptrs: xq, x1, x2, Wq_c, bq_c, Wk1_c, bk1_c, Wk2_c, bk2_c (interleaved,
// (2d, d) and (2d,)), wv1, bv1, wv2, bv2 ((d, d), (d,)); device pointers,
// 16-byte aligned. dtype: 0 = float32, 1 = bfloat16. DH in {16, 32, 64},
// d % 32 == 0, L1 and L2 <= 128. rate > 0 applies the dropout mask of
// `seed` (keep_div = 1 - rate in fp32). Returns a cudaError_t (0 =
// launched).
extern "C" int segmm_proj_two_block_attention_v2_fwd(
    int dtype, const void* const* ptrs, const int* mq, const int* mk1, const int* mk2,
    void* out, int B, int Lq, int L1, int L2, int dm, int H, float scale, float rate,
    float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DH = dm / H;
  if (dtype == 0)
    return (int)segmm::dispatch_v2_fwd<float>(DH, ptrs, mq, mk1, mk2, out, B, Lq, L1, L2, dm,
                                              scale, rate, keep_div, seed, s);
  if (dtype == 1)
    return (int)segmm::dispatch_v2_fwd<__nv_bfloat16>(DH, ptrs, mq, mk1, mk2, out, B, Lq, L1, L2,
                                                      dm, scale, rate, keep_div, seed, s);
  return (int)cudaErrorInvalidValue;
}
