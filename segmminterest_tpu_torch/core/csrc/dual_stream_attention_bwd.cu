// K5b: dual-stream projection-fused attention, backward.
//
// Replaces the TPU kernel segmminterest_tpu/core/dual_kernel.py
// _ds_bwd_kernel (:104), launched by _ds_call_bwd (:230) from the custom
// VJP of fused_dual_stream_attention. Two passes, as K2b's:
//  (a) qkv pass of BOTH streams in one launch, grid (H, B, 2): K2b's block
//      body (proj_attention.cuh:proj_qkv_bwd_block) on each stream, the
//      user stream salted from head H; twelve fp32 (B, L, d) workspaces
//      (each stream's dq1, dq2, dk1, dk2, dv1, dv2).
//  (b) the chain (chain_gemm.cuh): dxv and dxu as sums of six products
//      each, as :151-160 sums them (the video input feeds the video
//      stream's queries and block-1 keys and values and the user stream's
//      block-1 keys and values; the user input the rest), then the 12 fp32
//      dW = dy^T x and db = sum dy over the batch in K5_DW_SPLITS row chunks
//      added in order (deterministic, no atomics).
// Four launches in all: the qkv pass, dx, dW partials, their sum.
//
// What bounds it on an H100: operations, as K2b's (twice the work): the
// projection recompute on the bf16 tensor cores, dx and dW with fp32
// operands on the CUDA cores, the attention core in fp32.
#include "chain_gemm.cuh"
#include "proj_attention.cuh"

namespace segmm {

template <typename T>
struct DualBwdArgs {
  const T* xv;
  const T* xu;
  ProjWeights<T> wa, wb;
  const int* mv;
  const int* mu;
  const T* gv;
  const T* gu;
  float* d[12];  // video stream dq1 dq2 dk1 dk2 dv1 dv2, then the user stream's
};

template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kK2Threads)
dual_stream_qkv_bwd_kernel(DualBwdArgs<T> a, int Lv, int Lu, int dm, float scale, float rate,
                           float keep_div, unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  const Dropout dr = make_dropout(rate, keep_div, seed, b, gridDim.y);
  if (blockIdx.z == 0)
    proj_qkv_bwd_block<T, T, DH, kDrop>(a.xv, a.xv, a.xu, a.wa, a.mv, a.mv, a.mu, a.gv, a.d[0],
                                        a.d[1], a.d[2], a.d[3], a.d[4], a.d[5], Lv, Lv, Lu, dm,
                                        scale, dr, h, h, b);
  else
    proj_qkv_bwd_block<T, T, DH, kDrop>(a.xu, a.xv, a.xu, a.wb, a.mu, a.mv, a.mu, a.gu, a.d[6],
                                        a.d[7], a.d[8], a.d[9], a.d[10], a.d[11], Lu, Lv, Lu,
                                        dm, scale, dr, h, gridDim.x + h, b);
}

inline size_t k5b_smem_bytes(bool tc, int Lv, int Lu, int DH) {
  const size_t v = k2b_smem_bytes(tc, Lv, Lv, Lu, DH), u = k2b_smem_bytes(tc, Lu, Lv, Lu, DH);
  return v > u ? v : u;
}

template <typename T, int DH>
cudaError_t launch_k5b_qkv(const DualBwdArgs<T>& a, int B, int Lv, int Lu, int dm, float scale,
                           float rate, float keep_div, unsigned seed, cudaStream_t stream) {
  const size_t smem = k5b_smem_bytes(std::is_same<T, __nv_bfloat16>::value, Lv, Lu, DH);
  auto kernel = rate > 0.f ? dual_stream_qkv_bwd_kernel<T, DH, true>
                           : dual_stream_qkv_bwd_kernel<T, DH, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(dm / DH, B, 2), kK2Threads, smem, stream>>>(a, Lv, Lu, dm, scale, rate,
                                                            keep_div, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k5b(const void* const* p, const int* mv, const int* mu, const void* gv,
                       const void* gu, float* const* dys, void* const* dx, float* const* dwdb,
                       float* scratch, int B, int Lv, int Lu, int dm, int H, float scale,
                       float rate, float keep_div, unsigned seed, int splits,
                       cudaStream_t s) {
  if (splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
  DualBwdArgs<T> a{static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
                   proj_weights<T>(p + 2), proj_weights<T>(p + 14), mv, mu,
                   static_cast<const T*>(gv), static_cast<const T*>(gu), {}};
  for (int i = 0; i < 12; ++i) a.d[i] = dys[i];
  cudaError_t err;
  switch (dm / H) {
    case 16: err = launch_k5b_qkv<T, 16>(a, B, Lv, Lu, dm, scale, rate, keep_div, seed, s); break;
    case 32: err = launch_k5b_qkv<T, 32>(a, B, Lv, Lu, dm, scale, rate, keep_div, seed, s); break;
    case 64: err = launch_k5b_qkv<T, 64>(a, B, Lv, Lu, dm, scale, rate, keep_div, seed, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  // dxv and dxu (dual_kernel.py:153-160); W of projection i of stream a is
  // p[2 + 2i], of stream b p[14 + 2i] (i: q1 q2 k1 k2 v1 v2)
  DxJobs<6> xj{};
  const float* av[6] = {dys[0], dys[1], dys[2], dys[4], dys[8], dys[10]};
  const void* wv[6] = {p[2], p[4], p[6], p[10], p[18], p[22]};
  const float* au[6] = {dys[6], dys[7], dys[3], dys[5], dys[9], dys[11]};
  const void* wu[6] = {p[14], p[16], p[8], p[12], p[20], p[24]};
  xj.job[0] = dx_job<6>(av, wv, 6, dx[0], nullptr, B * Lv, dm, dm);
  xj.job[1] = dx_job<6>(au, wu, 6, dx[1], nullptr, B * Lu, dm, dm);
  err = launch_dx<T, 6>(xj, 2, B * (Lv > Lu ? Lv : Lu), dm, s);
  if (err != cudaSuccess) return err;

  // the 12 dW, db: stream a's q1 q2 k1 k2 v1 v2 from xv xv xv xu xv xu,
  // stream b's from xu xu xv xu xv xu
  const void* xs[12] = {p[0], p[0], p[0], p[1], p[0], p[1],
                        p[1], p[1], p[0], p[1], p[0], p[1]};
  const int lens[12] = {Lv, Lv, Lv, Lu, Lv, Lu, Lu, Lu, Lv, Lu, Lv, Lu};
  DwJobs wj{};
  ReduceJobs rj{};
  int nj = 0, nr = 0;
  for (int w = 0; w < 12; ++w)
    if (!add_wgrad(wj, nj, rj, nr, dys[w], xs[w], B * lens[w], dm, dm, splits,
                   scratch + w * wgrad_part_floats(dm, dm, splits), dwdb[w], dwdb[12 + w]))
      return cudaErrorInvalidValue;
  return launch_wgrads<T>(wj, nj, rj, nr, dm, dm, splits, s);
}

}  // namespace segmm

// dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t segmm_dual_stream_attention_bwd_smem_bytes(int dtype, int Lv, int Lu, int DH) {
  return segmm::k5b_smem_bytes(dtype == 1, Lv, Lu, DH);
}

// ptrs: as segmm_dual_stream_attention_fwd's (xv, xu, 12 + 12 parameters);
// gv (B, Lv, d), gu (B, Lu, d) in x's dtype; dys: 12 fp32 workspaces (the
// video stream's dq1 dq2 dk1 dk2 dv1 dv2, then the user stream's, each
// (B, L, d)); dx: dxv, dxu (x's dtype); dwdb: the 12 fp32 dW ((d, d),
// nn.Linear layout; video stream's q1 q2 k1 k2 v1 v2, then the user
// stream's) then the 12 db; scratch: fp32, 12 * splits * (d * d + d).
// 1 <= splits <= 4. Returns a cudaError_t (0 = launched).
extern "C" int segmm_dual_stream_attention_bwd(int dtype, const void* const* ptrs, const int* mv,
                                               const int* mu, const void* gv, const void* gu,
                                               float* const* dys, void* const* dx,
                                               float* const* dwdb, float* scratch, int B, int Lv,
                                               int Lu, int dm, int H, float scale, float rate,
                                               float keep_div, unsigned seed, int splits,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)segmm::launch_k5b<float>(ptrs, mv, mu, gv, gu, dys, dx, dwdb, scratch, B, Lv, Lu,
                                         dm, H, scale, rate, keep_div, seed, splits, s);
  if (dtype == 1)
    return (int)segmm::launch_k5b<__nv_bfloat16>(ptrs, mv, mu, gv, gu, dys, dx, dwdb, scratch, B,
                                                 Lv, Lu, dm, H, scale, rate, keep_div, seed,
                                                 splits, s);
  return (int)cudaErrorInvalidValue;
}
