// K5f: dual-stream projection-fused attention, forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/dual_kernel.py
// _ds_fwd_kernel (:68), launched by _ds_call_fwd (:190) behind
// fused_dual_stream_attention: both attention streams of one SegFormerX
// layer in one launch,
//   video stream: xq = xv, blocks (xv, xu), weights wa, query mask mv
//   user stream:  xq = xu, blocks (xv, xu), weights wb, query mask mu
// each exactly K2f's math. Both streams share the seed; the user stream
// salts its dropout mask from head H on (salt 2(H + h) + block,
// dual_kernel.py:100-101).
//
// bf16: K2f's two launches on the tensor cores for both streams (the
// wrapper picks the body by dtype, k5_body), as bf16 K5b takes K2b's:
//  (1) both streams' six projections as one grouped GEMM (proj_gemm.cuh,
//      launch_k5_projections) into six transient bf16 (B, L, 2d)
//      workspaces;
//  (2) dual_stream_core_fwd_kernel (two_block_mma.cuh): K2f's core over a
//      grid (H, B, 2), stream z taking its own query workspace, query mask
//      and key workspaces, the user stream salted from head H; the block
//      has the larger stream's shared memory and warps.
// fp32 runs no body of this file: the wrapper runs K2f's fp32 route (the
// projections and K1f's 3xTF32 core) on each stream, the user stream's
// salts from head H (core/dual_kernel.py).
#include "proj_gemm.cuh"
#include "two_block_mma.cuh"

// bf16 K5f on K2f's pieces. ptrs: xv, xu, then the video stream's wq1,
// bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, then the user
// stream's (26 device pointers, bf16, 16-byte aligned). mv (B, Lv), mu
// (B, Lu) int32; ov (B, Lv, d), ou (B, Lu, d); ws: six bf16 workspaces as
// segmm_dual_stream_attention_bwd_mma's. DH in SEGMM_K2_HEAD_DIMS,
// d % 32 == 0, Lv and Lu <= 128. Two launches. Returns a cudaError_t (0 =
// launched).
extern "C" int segmm_dual_stream_attention_fwd_mma(const void* const* ptrs, const int* mv,
                                                   const int* mu, void* ov, void* ou,
                                                   void* const* ws, int B, int Lv, int Lu,
                                                   int dm, int H, float scale, float rate,
                                                   float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = segmm::launch_k5_projections(ptrs, ws, B, Lv, Lu, dm, s);
  if (err != cudaSuccess) return (int)err;
  segmm::K2CoreArgs a =
      segmm::k2_core_args(ws, dm, mv, mv, mu, Lv, Lv, Lu, H, scale, rate, keep_div, seed);
  segmm::K2CoreArgs u =
      segmm::k2_core_args(ws + 3, dm, mu, mv, mu, Lu, Lv, Lu, H, scale, rate, keep_div, seed);
  a.out = static_cast<__nv_bfloat16*>(ov);
  u.out = static_cast<__nv_bfloat16*>(ou);
  return (int)segmm::launch_dual_core<false>(a, u, dm / H, B, s);
}
