// K6b: projection-fused two-block attention, version 2 (weight-interleaved
// concat-KV), backward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py
// _fp2_bwd_kernel (:1253), launched by _fp2_call_bwd (:1423) from the
// custom VJP of fused_proj_two_block_attention version 2 (:1491-1549).
//
// K6's function is K2's: with the zero halves of the interleaved weights,
// head h's q_c . k_cat^T is q1_h . k1_h^T over block 1's keys and q2_h .
// k2_h^T over block 2's, one softmax over both; dq_c . Wq_c = dq1 . Wq1 +
// dq2 . Wq2 up to the order of the sum; dWq_c de-interleaves into dWq1 and
// dWq2; the halves of dk_cat that meet the nonzero weights are K2's dk1
// and dk2. Only the dropout mask differs: one mask over (query,
// concatenated key) with salt h, block 2's key j at L1 + j (:1236-1239).
//
// bf16, on the tensor cores: K2b's three pieces on the (d, d) weights in
// K2's layout, no interleaved weight formed:
//  (a) K2f's projection GEMM (proj_gemm.cuh) into a bf16 workspace, then
//      K2b's core (two_block_mma.cuh) with K6's key indexing (kConcatKeys:
//      salt h, the key counted on the concatenated axis);
//  (b), (c) K2b's chain (launch_k2_chain): dx and the six dW, db, dy in
//      three bf16 parts, dW in k2_dw_chunk row chunks added in order.
// The gradients come out in K2's layout: nothing to de-interleave.
//
// fp32, the first, CUDA-core body. Three passes, as K2b's:
//  (a) qkv pass, one thread block per (head, batch row): recompute q_c,
//      k_cat and v_cat (proj_attention_v2.cuh), the probabilities in fp32
//      over the concatenated key axis (one row of Lk = L1 + L2 per query:
//      140 at the flagship's (Lq, 40, 100), past K2b's 128 per block), dv,
//      dl with the dropout mask of salt h, and write fp32 dq_c (B, Lq, 2d),
//      dk1, dv1 (B, L1, d) and dk2, dv2 (B, L2, d) to a workspace. dk1 and
//      dk2 are the halves of dk_cat that meet the nonzero weights; the other
//      halves would only feed the interleaved weights' zero halves, whose
//      gradients _fp2_bwd_rule throws away, so they are not formed.
//  (b) dx, as :1346-1350 computes it: dxq = dq_c . Wq_c (one product over
//      2d), dx1 = dk1 . Wk1 + dv1 . Wv1, dx2 = dk2 . Wk2 + dv2 . Wv2, fp32
//      products, one output cast to x's dtype. Wk1 and Wk2 are the nonzero
//      halves of Wk1_c and Wk2_c, passed as the (d, d) weights they are.
//  (c) dW = dy^T x and db = sum dy over the whole batch in fp32: the
//      interleaved (2d, d) dWq_c (de-interleaved by the caller) and the
//      (d, d) dWk1, dWk2, dWv1, dWv2, each 128x128 tile summed by
//      K2_DW_SPLITS blocks over consecutive row chunks and the chunks added
//      in order (chain_gemm.cuh): no atomics.
//
// What bounds it on an H100: operations, as K2b's (the same recompute, the
// same core products, the same dx and dW products): in bf16 the recompute
// at the bf16 rate, the core's products with p and dl in two bf16 parts,
// the chain's in three. The wrapper picks the bodies by dtype (k6_body).
#include "chain_gemm.cuh"
#include "proj_attention_v2.cuh"
#include "proj_gemm.cuh"
#include "two_block_mma.cuh"

namespace segmm {

template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kK2Threads)
proj_v2_qkv_bwd_kernel(const T* __restrict__ xq, const T* __restrict__ x1,
                       const T* __restrict__ x2, V2Weights<T> w, const int* __restrict__ mq,
                       const int* __restrict__ mk1, const int* __restrict__ mk2,
                       const T* __restrict__ g, float* __restrict__ dqc, float* __restrict__ dk1,
                       float* __restrict__ dk2, float* __restrict__ dv1, float* __restrict__ dv2,
                       int Lq, int L1, int L2, int dm, float scale, float rate, float keep_div,
                       unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  proj_v2_qkv_bwd_block<T, DH, kDrop>(xq, x1, x2, w, mq, mk1, mk2, g, dqc, dk1, dk2, dv1, dv2,
                                      Lq, L1, L2, dm, scale,
                                      make_dropout(rate, keep_div, seed, b, gridDim.y), h, b);
}

template <typename T, int DH>
cudaError_t launch_v2_qkv(const void* const* p, const int* mq, const int* mk1, const int* mk2,
                          const T* g, float* const* o, int B, int Lq, int L1, int L2, int dm,
                          float scale, float rate, float keep_div, unsigned seed,
                          cudaStream_t stream) {
  const size_t smem = k6b_smem_bytes(std::is_same<T, __nv_bfloat16>::value, Lq, L1, L2, DH);
  auto kernel = rate > 0.f ? proj_v2_qkv_bwd_kernel<T, DH, true>
                           : proj_v2_qkv_bwd_kernel<T, DH, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const T* const* a = reinterpret_cast<const T* const*>(p);
  kernel<<<dim3(dm / DH, B), kK2Threads, smem, stream>>>(
      a[0], a[1], a[2], v2_weights<T>(p + 3), mq, mk1, mk2, g, o[0], o[1], o[2], o[3], o[4], Lq,
      L1, L2, dm, scale, rate, keep_div, seed);
  return cudaGetLastError();
}

// p: xq x1 x2, the ten K6 parameters, wk1 wk2; dys: dq_c dk1 dk2 dv1 dv2;
// dx: dxq dx1 dx2; dwdb: dWq_c dWk1 dWk2 dWv1 dWv2, then their db.
template <typename T>
cudaError_t launch_v2_bwd(const void* const* p, const int* mq, const int* mk1, const int* mk2,
                          const void* g, float* const* dys, void* const* dx, float* const* dwdb,
                          float* scratch, int B, int Lq, int L1, int L2, int d, int H,
                          float scale, float rate, float keep_div, unsigned seed, int splits,
                          cudaStream_t s) {
  if (splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
  const T* gt = static_cast<const T*>(g);
  cudaError_t err;
  switch (d / H) {
    case 16:
      err = launch_v2_qkv<T, 16>(p, mq, mk1, mk2, gt, dys, B, Lq, L1, L2, d, scale, rate,
                                 keep_div, seed, s);
      break;
    case 32:
      err = launch_v2_qkv<T, 32>(p, mq, mk1, mk2, gt, dys, B, Lq, L1, L2, d, scale, rate,
                                 keep_div, seed, s);
      break;
    case 64:
      err = launch_v2_qkv<T, 64>(p, mq, mk1, mk2, gt, dys, B, Lq, L1, L2, d, scale, rate,
                                 keep_div, seed, s);
      break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  // (b) dxq = dq_c . Wq_c over 2d; dx1, dx2 over the key and value weights
  DxJobs<2> xj{};
  {
    const float* a[1] = {dys[0]};
    const void* w[1] = {p[3]};
    xj.job[0] = dx_job<2>(a, w, 1, dx[0], nullptr, B * Lq, 2 * d, d);
  }
  {
    const float* a[2] = {dys[1], dys[3]};
    const void* w[2] = {p[13], p[9]};  // wk1, wv1
    xj.job[1] = dx_job<2>(a, w, 2, dx[1], nullptr, B * L1, d, d);
  }
  {
    const float* a[2] = {dys[2], dys[4]};
    const void* w[2] = {p[14], p[11]};  // wk2, wv2
    xj.job[2] = dx_job<2>(a, w, 2, dx[2], nullptr, B * L2, d, d);
  }
  err = launch_dx<T, 2>(xj, 3, B * max3(Lq, L1, L2), d, s);
  if (err != cudaSuccess) return err;

  // (c) dWq_c (2d, d) from xq, then dWk1 dWk2 dWv1 dWv2 (d, d) from x1 x2 x1 x2
  DwJobs wj{};
  ReduceJobs rj{};
  int nj = 0, nr = 0;
  if (!add_wgrad(wj, nj, rj, nr, dys[0], p[0], B * Lq, 2 * d, d, splits, scratch, dwdb[0],
                 dwdb[5]))
    return cudaErrorInvalidValue;
  float* part = scratch + wgrad_part_floats(2 * d, d, splits);
  const int w_x[4] = {1, 2, 1, 2};
  const int w_len[4] = {L1, L2, L1, L2};
  for (int i = 0; i < 4; ++i)
    if (!add_wgrad(wj, nj, rj, nr, dys[1 + i], p[w_x[i]], B * w_len[i], d, d, splits,
                   part + i * wgrad_part_floats(d, d, splits), dwdb[1 + i], dwdb[6 + i]))
      return cudaErrorInvalidValue;
  return launch_wgrads<T>(wj, nj, rj, nr, 2 * d, d, splits, s);
}

}  // namespace segmm

// dtype: 0 = float32 (the CUDA-core qkv pass), 1 = bfloat16 (K2b's core
// block).
extern "C" size_t segmm_proj_two_block_attention_v2_bwd_smem_bytes(int dtype, int Lq, int L1,
                                                                   int L2, int DH) {
  if (dtype == 1) return segmm::k2_core_bwd_smem_bytes(Lq, L1, L2, DH);
  return segmm::k6b_smem_bytes(false, Lq, L1, L2, DH);
}

// ptrs: xq, x1, x2, the ten parameters of segmm_proj_two_block_attention_v2_fwd,
// then wk1, wk2 ((d, d)); g (B, Lq, d) in x's dtype; dys: fp32 workspaces
// dq_c (B, Lq, 2d), dk1 (B, L1, d), dk2 (B, L2, d), dv1 (B, L1, d),
// dv2 (B, L2, d); dx: dxq, dx1, dx2 (x's dtype); dwdb: fp32 dWq_c (2d, d),
// dWk1, dWk2, dWv1, dWv2 ((d, d), nn.Linear layout), then dbq_c (2d) and
// the four db (d); scratch: fp32, splits * 6 * (d * d + d). DH in
// {16, 32, 64}, d % 32 == 0, L1 and L2 <= 128; 1 <= splits <= 4. float32
// only (dtype 0). Returns a cudaError_t (0 = launched).
extern "C" int segmm_proj_two_block_attention_v2_bwd(
    int dtype, const void* const* ptrs, const int* mq, const int* mk1, const int* mk2,
    const void* g, float* const* dys, void* const* dx, float* const* dwdb, float* scratch, int B,
    int Lq, int L1, int L2, int dm, int H, float scale, float rate, float keep_div,
    unsigned seed, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)segmm::launch_v2_bwd<float>(ptrs, mq, mk1, mk2, g, dys, dx, dwdb, scratch, B, Lq,
                                            L1, L2, dm, H, scale, rate, keep_div, seed, splits,
                                            s);
  return (int)cudaErrorInvalidValue;
}

// bf16 K6b on K2b's pieces. ptrs: xq, x1, x2, then wq1, bq1, wq2, bq2, wk1,
// bk1, wk2, bk2, wv1, bv1, wv2, bv2 (K2's layout, bf16, 16-byte aligned);
// g (B, Lq, d) bf16; dys: fp32 dq1 dq2 dk1 dk2 dv1 dv2 ((B, L, d) each);
// ws: the projections' workspace, as K2f's; dx: dxq, dx1, dx2 (bf16);
// dwdb: fp32 dW of q1 q2 k1 k2 v1 v2 ((d, d), nn.Linear layout) then their
// db; scratch (fp32): the sum over the six weights of dw_chunks(rows,
// chunk) * (d * d + d), chunk % 32 == 0. DH in {16, 32, 64}, d % 32 == 0,
// every length <= 128. Five launches. Returns a cudaError_t.
extern "C" int segmm_proj_two_block_attention_v2_bwd_mma(
    const void* const* ptrs, const int* mq, const int* mk1, const int* mk2, const void* g,
    float* const* dys, void* const* ws, void* const* dx, float* const* dwdb, float* scratch,
    int B, int Lq, int L1, int L2, int dm, int H, float scale, float rate, float keep_div,
    unsigned seed, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = segmm::launch_k2_projections(ptrs, ws, B, Lq, L1, L2, dm, s);
  if (err != cudaSuccess) return (int)err;
  segmm::K2CoreArgs a =
      segmm::k2_core_args(ws, mq, mk1, mk2, Lq, L1, L2, H, scale, rate, keep_div, seed);
  a.g = static_cast<const __nv_bfloat16*>(g);
  for (int i = 0; i < 6; ++i) a.dy[i] = dys[i];
  err = segmm::launch_k2_core<true, false, segmm::kConcatKeys>(a, dm / H, B, s);
  if (err != cudaSuccess) return (int)err;
  return (int)segmm::launch_k2_chain(ptrs, dys, dx, dwdb, nullptr, nullptr, 0, B, Lq, L1, L2, dm,
                                     chunk, scratch, s);
}
