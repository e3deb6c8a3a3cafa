// K2b: projection-fused two-block attention, backward (and K7b, its first
// pass alone).
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _fp_bwd_kernel
// (:808), launched by _fp_call_bwd (:943) from the custom VJP of
// fused_proj_two_block_attention v1 (:1007-1051), and, through its first
// pass alone, _fp3_bwd_kernel (:1568, K7b, behind SEGMM_ATTN_V3_BWD=1).
// Three passes:
//  (a) qkv pass: recompute the six projections with _proj's rounding, then
//      the joint softmax backward (probabilities recomputed in fp32, the
//      dropout mask from the seed), and write dq1, dq2, dk1, dk2, dv1, dv2
//      as fp32 (B, L, d) (~0.75 GB at B=1024, (40, 40, 100)). On the TPU
//      they stayed in VMEM; here the batch rows run in parallel, so the sums
//      over the batch below need them all.
//  (b) dx, as :858-868 computes it: dxq = dq1.Wq1 + dq2.Wq2,
//      dx1 = dk1.Wk1 + dv1.Wv1, dx2 = dk2.Wk2 + dv2.Wv2 (W in nn.Linear
//      layout (out, in)), fp32 products, one output cast to x's dtype.
//  (c) dW = dy^T x and db = sum dy over the whole batch in fp32 (:870-894).
//      The TPU carried the sums across its sequential grid; here the rows
//      are cut into chunks summed by blocks of their own, and a last pass
//      adds the chunks in order: no atomics, so repeated steps give the same
//      bits.
//
// What bounds it on an H100: operations. At B=1024, (40, 40, 100), d=512:
// the projection recompute is 193 GFLOP on the bf16 tensor cores (0.2 ms),
// dx and dW are 2 x 193 GFLOP at fp32 accuracy, the attention core 29
// GFLOP.
//
// bf16, on the tensor cores:
//  (a) K2f's projection GEMM (proj_gemm.cuh) into a bf16 workspace, then
//      proj_two_block_core_bwd_kernel (two_block_mma.cuh): one block per
//      (head, batch row), mma.sync m16n8k16 with p and dl as bf16 hi / lo
//      halves;
//  (b), (c) chain_dx_kernel, chain_dw_kernel and chain_dw_reduce_kernel
//      (proj_gemm.cuh): dy split into three bf16 parts as its tiles are
//      read (x and W are bf16 values), three products into one fp32
//      accumulator: the fp32 products on the bf16 tensor cores. dW's row
//      chunks are `chunk` rows each (the wrapper's k2_dw_chunk rule).
// fp32: (a) is the wrapper's (the projections recomputed, K1b's 3xTF32
// core; core/attention.py), (b) and (c) 128x128 tiles of 8x8 fp32 FMAs per
// thread (chain_gemm.cuh, shared with K5b and K4b), dW in `splits` row
// chunks. The wrapper picks the bodies by dtype.
#include "chain_gemm.cuh"
#include "proj_gemm.cuh"
#include "two_block_mma.cuh"

namespace segmm {

// bf16 K1b's core (its gradients in bf16) is instantiated in
// proj_two_block_attention_bwd.k1.cu, compiled beside this file
// (core/build.py), so that the two compiles run side by side.
extern template cudaError_t launch_k2_core<true, false, kBlockKeys, __nv_bfloat16>(
    const K2CoreArgs&, int, int, cudaStream_t);

template <typename T>
cudaError_t launch_chain(const void* const* in, float* const* dys, void* const* dx,
                         float* const* dwdb, float* scratch, int B, int Lq, int L1, int L2,
                         int d, int splits, cudaStream_t stream) {
  if (splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
  const int L[3] = {Lq, L1, L2};
  // (b) dx = dy_a . W_a + dy_b . W_b
  DxJobs<2> xj{};
  const int pair_dy[3][2] = {{0, 1}, {2, 4}, {3, 5}};  // dq1 dq2 | dk1 dv1 | dk2 dv2
  const int pair_w[3][2] = {{3, 5}, {7, 11}, {9, 13}};  // Wq1 Wq2 | Wk1 Wv1 | Wk2 Wv2
  int max_rows = 0;
  for (int s = 0; s < 3; ++s) {
    const float* a[2] = {dys[pair_dy[s][0]], dys[pair_dy[s][1]]};
    const void* w[2] = {in[pair_w[s][0]], in[pair_w[s][1]]};
    xj.job[s] = dx_job<2>(a, w, 2, dx[s], nullptr, B * L[s], d, d);
    max_rows = max(max_rows, B * L[s]);
  }
  cudaError_t err = launch_dx<T, 2>(xj, 3, max_rows, d, stream);
  if (err != cudaSuccess) return err;

  // (c) dW_w = dy_w^T x_w in row chunks; w = q1 q2 k1 k2 v1 v2
  const int w_x[6] = {0, 0, 1, 2, 1, 2};  // xq xq x1 x2 x1 x2
  const int w_len[6] = {Lq, Lq, L1, L2, L1, L2};
  DwJobs wj{};
  ReduceJobs rj{};
  int nj = 0, nr = 0;
  for (int w = 0; w < 6; ++w)
    if (!add_wgrad(wj, nj, rj, nr, dys[w], in[w_x[w]], B * w_len[w], d, d, splits,
                   scratch + w * wgrad_part_floats(d, d, splits), dwdb[w], dwdb[6 + w]))
      return cudaErrorInvalidValue;
  return launch_wgrads<T>(wj, nj, rj, nr, d, d, splits, stream);
}

}  // namespace segmm

// dtype: 1 = bfloat16 (the core's block); any other dtype has no block
// here (0 bytes).
extern "C" size_t segmm_proj_two_block_attention_bwd_smem_bytes(int dtype, int Lq, int L1, int L2,
                                                                int DH) {
  return dtype == 1 ? segmm::k2_core_smem_bytes(Lq, L1, L2, DH, true) : 0;
}

// Pass (a) (K7b alone). ptrs: xq, x1, x2, wq1, bq1, wq2, bq2, wk1, bk1, wk2,
// bk2, wv1, bv1, wv2, bv2 (16-byte aligned); g (B, Lq, d); out: fp32
// dq1, dq2, dk1, dk2, dv1, dv2, each (B, L, d); ws: the projections'
// workspace, as K2f's. dtype: 1 = bfloat16 (any other is refused). DH in
// SEGMM_K2_HEAD_DIMS, d % 32 == 0, any lengths. Returns a cudaError_t
// (0 = launched).
extern "C" int segmm_proj_two_block_attention_qkv_bwd(
    int dtype, const void* const* ptrs, const int* mq, const int* mk1, const int* mk2,
    const void* g, float* const* out, void* const* ws, int B, int Lq, int L1, int L2, int dm,
    int H, float scale, float rate, float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DH = dm / H;
  if (dtype == 1) {
    cudaError_t err = segmm::launch_k2_projections(ptrs, ws, B, Lq, L1, L2, dm, s);
    if (err != cudaSuccess) return (int)err;
    segmm::K2CoreArgs a = segmm::k2_core_args(ws, dm, mq, mk1, mk2, Lq, L1, L2, H, scale, rate,
                                              keep_div, seed);
    a.g = static_cast<const __nv_bfloat16*>(g);
    for (int i = 0; i < 6; ++i) a.dy[i] = out[i];
    return (int)segmm::launch_k2_core<true>(a, DH, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Passes (b) and (c). ptrs as above; dys: the six fp32 outputs of pass (a);
// dx: dxq, dx1, dx2 (x's dtype); dwdb: fp32 dWq1 dWq2 dWk1 dWk2 dWv1 dWv2
// ((d, d), nn.Linear layout) then the six db (d); scratch (fp32 values):
// 6 * splits * (d * d + d) for fp32 (1 <= splits <= 4), the sum over the
// six weights of dw_chunks(rows, chunk) * (d * d + d) for bf16 (chunk %
// 32 == 0). Returns a cudaError_t.
extern "C" int segmm_proj_two_block_attention_chain_bwd(
    int dtype, const void* const* ptrs, float* const* dys, void* const* dx, float* const* dwdb,
    float* scratch, int B, int Lq, int L1, int L2, int dm, int splits, int chunk,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)segmm::launch_chain<float>(ptrs, dys, dx, dwdb, scratch, B, Lq, L1, L2, dm,
                                           splits, s);
  if (dtype == 1)
    return (int)segmm::launch_k2_chain(ptrs, dys, dx, dwdb, nullptr, nullptr, 0, B, Lq, L1, L2,
                                       dm, chunk, scratch, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 K1b, and bf16 K3b at the shapes its own body does not take, on this
// core, its gradients stored in bf16 straight from the accumulators: the
// operands as segmm_two_block_core_fwd's, g (B, Lq, H, D), dq1, dq2, dk1,
// dk2, dv1, dv2 as their operands (bf16; K3: dq2, dk2, dv2 null). acc: on
// the key-chunk path over several query windows (k2_chunk_windows(Lq) > 1,
// two_block_mma.cuh), an fp32 scratch of B (2 L1 + 2 L2) H D values that
// the windows sum dk and dv into; else null. Returns a cudaError_t.
extern "C" int segmm_two_block_core_bwd(const void* q1, const void* q2, const void* k1,
                                        const void* k2, const void* v1, const void* v2,
                                        const int* mq, const int* mk1, const int* mk2,
                                        const void* g, void* const* grads, float* acc, int B,
                                        int Lq, int L1, int L2, int H, int D, float scale,
                                        float rate, float keep_div, unsigned seed, int k3,
                                        void* stream) {
  using bf = const __nv_bfloat16*;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  segmm::K2CoreArgs a{};
  a.q1 = static_cast<bf>(q1);
  a.q2 = static_cast<bf>(q2);
  a.k1 = static_cast<bf>(k1);
  a.v1 = static_cast<bf>(v1);
  a.k2 = static_cast<bf>(k2);
  a.v2 = static_cast<bf>(v2);
  a.rs = (long)H * D;
  a.mq = mq;
  a.mk1 = mk1;
  a.mk2 = mk2;
  a.g = static_cast<bf>(g);
  for (int i = 0; i < 6; ++i) a.dy[i] = grads[i];
  a.Lq = Lq;
  a.L1 = L1;
  a.L2 = k3 ? 0 : L2;
  a.H = H;
  a.scale = scale;
  a.rate = rate;
  a.keep_div = keep_div;
  a.seed = seed;
  a.acc = acc;
  if (k3) {
    a.concat = 1;
    a.dy_bf16 = 1;
    return (int)segmm::launch_k2_chunked(a, D, true, B, s);
  }
  return (int)segmm::launch_k2_core<true, false, segmm::kBlockKeys, __nv_bfloat16>(a, D, B, s);
}
