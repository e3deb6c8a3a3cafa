// K6f: projection-fused two-block attention, version 2 (weight-interleaved
// concat-KV), forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py
// _fp2_fwd_kernel (:1198), launched by _fp2_call_fwd (:1375) behind
// fused_proj_two_block_attention version 2 (SEGMM_ATTN_V2=1, :1116-1131).
// The function is K2f's; the dropout mask is drawn once over (query,
// concatenated key) with salt h, and the softmax and PV run over one key
// axis of Lk = L1 + L2.
//
// What bounds it on an H100: operations, as K2f (the same projections and
// the same logit and PV products).
//
// bf16: K2f's two launches on the tensor cores (the wrapper picks the body
// by dtype, k6_body). The projections as K2f's one grouped GEMM on the
// (d, d) weights in K2's layout (proj_gemm.cuh), nothing interleaved;
// then K2f's two-block core (two_block_mma.cuh) with K6's dropout keys
// (kConcatKeys: one key axis of L1 + L2 keys, salt h, block 2's key j
// hashed as L1 + j). Head h's q_c . [k1_h | 0] is q1_h . k1_h and
// q_c . [0 | k2_h] is q2_h . k2_h, so the logits, the fill, the softmax
// over both blocks and PV are K2f's; only the keep bits are K6's.
// fp32 runs no body of this file: the wrapper runs K2f's fp32 route (the
// projections and K1f's 3xTF32 core) with K6's keys (core/attention.py).
#include "proj_gemm.cuh"
#include "two_block_mma.cuh"

// bf16 K6f on K2f's pieces. ptrs: xq, x1, x2, then wq1, bq1, wq2, bq2, wk1,
// bk1, wk2, bk2, wv1, bv1, wv2, bv2 (K2's layout, bf16, 16-byte aligned);
// ws: the projections' workspace, as K2f's; out (B, Lq, d) bf16. DH in
// SEGMM_K2_HEAD_DIMS, d % 32 == 0, every length <= 128. Two launches.
// Returns a cudaError_t (0 = launched).
extern "C" int segmm_proj_two_block_attention_v2_fwd_mma(
    const void* const* ptrs, const int* mq, const int* mk1, const int* mk2, void* out,
    void* const* ws, int B, int Lq, int L1, int L2, int dm, int H, float scale, float rate,
    float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = segmm::launch_k2_projections(ptrs, ws, B, Lq, L1, L2, dm, s);
  if (err != cudaSuccess) return (int)err;
  segmm::K2CoreArgs a =
      segmm::k2_core_args(ws, dm, mq, mk1, mk2, Lq, L1, L2, H, scale, rate, keep_div, seed);
  a.out = static_cast<__nv_bfloat16*>(out);
  return (int)segmm::launch_k2_core<false, false, segmm::kConcatKeys>(a, dm / H, B, s);
}
