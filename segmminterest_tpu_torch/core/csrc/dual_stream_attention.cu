// K5f: dual-stream projection-fused attention, forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/dual_kernel.py
// _ds_fwd_kernel (:68), launched by _ds_call_fwd (:190) behind
// fused_dual_stream_attention: both attention streams of one SegFormerX
// layer in one launch,
//   video stream: xq = xv, blocks (xv, xu), weights wa, query mask mv
//   user stream:  xq = xu, blocks (xv, xu), weights wb, query mask mu
// each exactly K2f's math (proj_attention.cuh:proj_fwd_block). Both
// streams share the seed; the user stream salts its dropout mask from head
// H on (salt 2(H + h) + block, dual_kernel.py:100-101).
//
// Design: K2f's block body over a grid with a stream axis, (H, B, 2): one
// block per (head, batch row, stream), 256 threads, the dynamic shared
// memory of the larger stream. What bounds it on an H100 is what bounds
// K2f (operations, held back by L2 re-reads and the fp32 attention core);
// one launch instead of two saves a launch and lets the two streams' blocks
// fill the card together, nothing more: the TPU kernel's gain (both
// streams' activations loaded once per grid step) has no counterpart here,
// where every block reads its own rows from L2.
#include "proj_attention.cuh"

namespace segmm {

template <typename T>
struct DualArgs {
  const T* xv;
  const T* xu;
  ProjWeights<T> wa, wb;
  const int* mv;
  const int* mu;
  T* ov;
  T* ou;
};

template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kK2Threads)
dual_stream_fwd_kernel(DualArgs<T> a, int Lv, int Lu, int dm, float scale, float rate,
                       float keep_div, unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  const Dropout dr = make_dropout(rate, keep_div, seed, b, gridDim.y);
  if (blockIdx.z == 0)
    proj_fwd_block<T, DH, kDrop>(a.xv, a.xv, a.xu, a.wa, a.mv, a.mv, a.mu, a.ov, Lv, Lv, Lu, dm,
                                 scale, dr, h, h, b);
  else
    proj_fwd_block<T, DH, kDrop>(a.xu, a.xv, a.xu, a.wb, a.mu, a.mv, a.mu, a.ou, Lu, Lv, Lu, dm,
                                 scale, dr, h, gridDim.x + h, b);
}

inline size_t k5_smem_bytes(bool tc, int Lv, int Lu, int DH) {
  const size_t v = k2_smem_bytes(tc, Lv, Lv, Lu, DH), u = k2_smem_bytes(tc, Lu, Lv, Lu, DH);
  return v > u ? v : u;
}

template <typename T, int DH>
cudaError_t launch_k5(const DualArgs<T>& a, int B, int Lv, int Lu, int dm, float scale,
                      float rate, float keep_div, unsigned seed, cudaStream_t stream) {
  const size_t smem = k5_smem_bytes(std::is_same<T, __nv_bfloat16>::value, Lv, Lu, DH);
  auto kernel = rate > 0.f ? dual_stream_fwd_kernel<T, DH, true>
                           : dual_stream_fwd_kernel<T, DH, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(dm / DH, B, 2), kK2Threads, smem, stream>>>(a, Lv, Lu, dm, scale, rate,
                                                            keep_div, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k5(const void* const* p, const int* mv, const int* mu, void* ov, void* ou,
                        int B, int Lv, int Lu, int dm, int H, float scale, float rate,
                        float keep_div, unsigned seed, cudaStream_t s) {
  const DualArgs<T> a{static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
                      proj_weights<T>(p + 2), proj_weights<T>(p + 14), mv, mu,
                      static_cast<T*>(ov), static_cast<T*>(ou)};
  switch (dm / H) {
    case 16: return launch_k5<T, 16>(a, B, Lv, Lu, dm, scale, rate, keep_div, seed, s);
    case 32: return launch_k5<T, 32>(a, B, Lv, Lu, dm, scale, rate, keep_div, seed, s);
    case 64: return launch_k5<T, 64>(a, B, Lv, Lu, dm, scale, rate, keep_div, seed, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace segmm

// dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t segmm_dual_stream_attention_smem_bytes(int dtype, int Lv, int Lu, int DH) {
  return segmm::k5_smem_bytes(dtype == 1, Lv, Lu, DH);
}

// ptrs: xv, xu, then the video stream's wq1, bq1, wq2, bq2, wk1, bk1, wk2,
// bk2, wv1, bv1, wv2, bv2, then the user stream's (26 device pointers,
// 16-byte aligned). mv (B, Lv), mu (B, Lu) int32; ov (B, Lv, d), ou
// (B, Lu, d). DH = d / H in {16, 32, 64}, d % 32 == 0, Lv, Lu <= 128.
// Returns a cudaError_t (0 = launched).
extern "C" int segmm_dual_stream_attention_fwd(int dtype, const void* const* ptrs, const int* mv,
                                               const int* mu, void* ov, void* ou, int B, int Lv,
                                               int Lu, int dm, int H, float scale, float rate,
                                               float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)segmm::dispatch_k5<float>(ptrs, mv, mu, ov, ou, B, Lv, Lu, dm, H, scale, rate,
                                          keep_div, seed, s);
  if (dtype == 1)
    return (int)segmm::dispatch_k5<__nv_bfloat16>(ptrs, mv, mu, ov, ou, B, Lv, Lu, dm, H, scale,
                                                  rate, keep_div, seed, s);
  return (int)cudaErrorInvalidValue;
}
