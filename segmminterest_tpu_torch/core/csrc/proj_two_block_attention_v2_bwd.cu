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
// fp32 runs no body of this file: the wrapper runs K2b's fp32 route (the
// projections recomputed, K1b's 3xTF32 core with K6's keys, K2b's
// CUDA-core chain; core/attention.py), its gradients in K2's layout too.
//
// What bounds it on an H100: operations, as K2b's (the same recompute, the
// same core products, the same dx and dW products): in bf16 the recompute
// at the bf16 rate, the core's products with p and dl in two bf16 parts,
// the chain's in three. The wrapper picks the bodies by dtype (k6_body).
#include "proj_gemm.cuh"
#include "two_block_mma.cuh"

// dtype: 1 = bfloat16 (K2b's core block); any other dtype has no block
// here (0 bytes).
extern "C" size_t segmm_proj_two_block_attention_v2_bwd_smem_bytes(int dtype, int Lq, int L1,
                                                                   int L2, int DH) {
  return dtype == 1 ? segmm::k2_core_smem_bytes(Lq, L1, L2, DH, true) : 0;
}

// bf16 K6b on K2b's pieces. ptrs: xq, x1, x2, then wq1, bq1, wq2, bq2, wk1,
// bk1, wk2, bk2, wv1, bv1, wv2, bv2 (K2's layout, bf16, 16-byte aligned);
// g (B, Lq, d) bf16; dys: fp32 dq1 dq2 dk1 dk2 dv1 dv2 ((B, L, d) each);
// ws: the projections' workspace, as K2f's; dx: dxq, dx1, dx2 (bf16);
// dwdb: fp32 dW of q1 q2 k1 k2 v1 v2 ((d, d), nn.Linear layout) then their
// db; scratch (fp32): the sum over the six weights of dw_chunks(rows,
// chunk) * (d * d + d), chunk % 32 == 0. DH in SEGMM_K2_HEAD_DIMS,
// d % 32 == 0, every length <= 128. Five launches. Returns a cudaError_t.
extern "C" int segmm_proj_two_block_attention_v2_bwd_mma(
    const void* const* ptrs, const int* mq, const int* mk1, const int* mk2, const void* g,
    float* const* dys, void* const* ws, void* const* dx, float* const* dwdb, float* scratch,
    int B, int Lq, int L1, int L2, int dm, int H, float scale, float rate, float keep_div,
    unsigned seed, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = segmm::launch_k2_projections(ptrs, ws, B, Lq, L1, L2, dm, s);
  if (err != cudaSuccess) return (int)err;
  segmm::K2CoreArgs a =
      segmm::k2_core_args(ws, dm, mq, mk1, mk2, Lq, L1, L2, H, scale, rate, keep_div, seed);
  a.g = static_cast<const __nv_bfloat16*>(g);
  for (int i = 0; i < 6; ++i) a.dy[i] = dys[i];
  err = segmm::launch_k2_core<true, false, segmm::kConcatKeys>(a, dm / H, B, s);
  if (err != cudaSuccess) return (int)err;
  return (int)segmm::launch_k2_chain(ptrs, dys, dx, dwdb, nullptr, nullptr, 0, B, Lq, L1, L2, dm,
                                     chunk, scratch, s);
}
