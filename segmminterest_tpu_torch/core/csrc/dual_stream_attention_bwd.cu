// K5b: dual-stream projection-fused attention, backward.
//
// Replaces the TPU kernel segmminterest_tpu/core/dual_kernel.py
// _ds_bwd_kernel (:104), launched by _ds_call_bwd (:230) from the custom
// VJP of fused_dual_stream_attention. Each stream is K2b's math; the user
// stream's dropout salts count from head H (:100-101).
//
// bf16, on K2b's tensor-core pieces, five launches:
//  (1) both streams' projections as one grouped GEMM of six sources
//      (proj_gemm.cuh qkv_gemm_kernel): the video stream's xv -> q1|q2,
//      xv -> k1|v1, xu -> k2|v2 and the user stream's xu -> q1|q2,
//      xv -> k1|v1, xu -> k2|v2, into six transient bf16 (B, L, 2d)
//      tensors;
//  (2) both streams' core backward in one launch (two_block_mma.cuh
//      dual_stream_core_bwd_kernel, grid z = 2, the user stream's salts
//      from head H) into twelve fp32 (B, L, d) gradients;
//  (3) dxv and dxu, each one fp32 accumulator over its six products in
//      :151-160's order, cast once (chain_dx_kernel over six pairs, dy in
//      three bf16 parts);
//  (4), (5) the 12 dW = dy^T x and db = sum dy in row chunks of `chunk`
//      rows (the wrapper's k5_dw_chunk rule), then their sums in chunk
//      order: no atomics, the same bits on every call.
//
// fp32: each stream's qkv pass is the wrapper's (K2b's fp32 route: the
// projections recomputed, K1b's 3xTF32 core, the user stream salted from
// head H; core/dual_kernel.py) into twelve fp32 (B, L, d) workspaces; here
// the chain (chain_gemm.cuh): dxv and dxu as sums of six products each, as
// :151-160 sums them (the video input feeds the video stream's queries and
// block-1 keys and values and the user stream's block-1 keys and values;
// the user input the rest), then the 12 fp32 dW = dy^T x and db = sum dy
// over the batch in K5_DW_SPLITS row chunks added in order
// (deterministic, no atomics): three launches.
//
// What bounds it on an H100: operations, as K2b's (twice the work): in
// bf16 the projection recompute at the bf16 rate, the cores' products with
// p and dl in two bf16 parts, dx and dW in three. The wrapper picks the
// bodies by dtype (k5_body).
#include "chain_gemm.cuh"
#include "proj_gemm.cuh"
#include "two_block_mma.cuh"

namespace segmm {

// fp32: dxv, dxu and the 12 dW, db from the twelve dq1..dv2 in dys.
template <typename T>
cudaError_t launch_k5b_chain(const void* const* p, float* const* dys, void* const* dx,
                             float* const* dwdb, float* scratch, int B, int Lv, int Lu, int dm,
                             int splits, cudaStream_t s) {
  if (splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
  cudaError_t err;
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

// bf16 K5b on K2b's pieces (the file's head). p: xv, xu, then the video
// stream's 12 parameters and the user stream's (bf16); ws: the six
// projections' workspaces in the order of the GEMM's sources.
inline cudaError_t launch_k5b_mma(const void* const* p, const int* mv, const int* mu,
                                  const void* gv, const void* gu, float* const* dys,
                                  void* const* ws, void* const* dx, float* const* dwdb,
                                  float* scratch, int B, int Lv, int Lu, int d, int H, float scale,
                                  float rate, float keep_div, unsigned seed, int chunk,
                                  cudaStream_t s) {
  const bf16* const* t = reinterpret_cast<const bf16* const*>(p);
  // (1) both streams' six projections (launch_k5_projections)
  cudaError_t err = launch_k5_projections(p, ws, B, Lv, Lu, d, s);
  if (err != cudaSuccess) return err;
  // (2) the two cores: video queries (Lv) and user queries (Lu) over the
  // key blocks (Lv, Lu)
  K2CoreArgs a = k2_core_args(ws, d, mv, mv, mu, Lv, Lv, Lu, H, scale, rate, keep_div, seed);
  K2CoreArgs u = k2_core_args(ws + 3, d, mu, mv, mu, Lu, Lv, Lu, H, scale, rate, keep_div, seed);
  a.g = static_cast<const bf16*>(gv);
  u.g = static_cast<const bf16*>(gu);
  for (int i = 0; i < 6; ++i) {
    a.dy[i] = dys[i];
    u.dy[i] = dys[6 + i];
  }
  err = launch_dual_core<true>(a, u, d / H, B, s);
  if (err != cudaSuccess) return err;
  // (3) dxv, dxu over their six pairs (dual_kernel.py:151-160); W of
  // projection i of the video stream is t[2 + 2i], of the user stream
  // t[14 + 2i] (i: q1 q2 k1 k2 v1 v2)
  const float* dyx[12] = {dys[0], dys[1], dys[2], dys[4], dys[8], dys[10],
                          dys[6], dys[7], dys[3], dys[5], dys[9], dys[11]};
  const bf16* wx[12] = {t[2],  t[4],  t[6], t[10], t[18], t[22],
                        t[14], t[16], t[8], t[12], t[20], t[24]};
  bf16* dxo[2] = {static_cast<bf16*>(dx[0]), static_cast<bf16*>(dx[1])};
  const int Mx[2] = {B * Lv, B * Lu};
  err = launch_chain_dx<6>(dyx, wx, dxo, Mx, 2, d, nullptr, s);
  if (err != cudaSuccess) return err;
  // (4), (5) the 12 dW, db: the video stream's q1 q2 k1 k2 v1 v2 from xv
  // xv xv xu xv xu, the user stream's from xu xu xv xu xv xu
  const int src[12] = {0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 0, 1};
  DwWeight dws[12];
  for (int i = 0; i < 12; ++i)
    dws[i] = DwWeight{dys[i], t[src[i]], B * (src[i] ? Lu : Lv), d, d, dwdb[i], dwdb[12 + i]};
  return launch_chain_dw(dws, 12, chunk, scratch, s);
}

}  // namespace segmm

// dtype: 1 = bfloat16 (K2b's core block, the larger of the two streams');
// any other dtype has no block here (0 bytes).
extern "C" size_t segmm_dual_stream_attention_bwd_smem_bytes(int dtype, int Lv, int Lu, int DH) {
  if (dtype != 1) return 0;
  const size_t v = segmm::k2_core_smem_bytes(Lv, Lv, Lu, DH, true),
               u = segmm::k2_core_smem_bytes(Lu, Lv, Lu, DH, true);
  return v > u ? v : u;
}

// fp32 K5b's chain. ptrs: xv, xu, then the video stream's wq1, bq1, wq2,
// bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, then the user stream's (26
// device pointers, 16-byte aligned); dys: 12 fp32 workspaces (the video
// stream's dq1 dq2 dk1 dk2 dv1 dv2, then the user stream's, each (B, L,
// d)), the wrapper's qkv passes; dx: dxv, dxu; dwdb: the 12 fp32 dW ((d,
// d), nn.Linear layout; video stream's q1 q2 k1 k2 v1 v2, then the user
// stream's) then the 12 db; scratch: fp32, 12 * splits * (d * d + d).
// 1 <= splits <= 4. Returns a cudaError_t (0 = launched).
extern "C" int segmm_dual_stream_attention_chain_bwd(const void* const* ptrs, float* const* dys,
                                                     void* const* dx, float* const* dwdb,
                                                     float* scratch, int B, int Lv, int Lu,
                                                     int dm, int splits, void* stream) {
  return (int)segmm::launch_k5b_chain<float>(ptrs, dys, dx, dwdb, scratch, B, Lv, Lu, dm, splits,
                                             static_cast<cudaStream_t>(stream));
}

// bf16 K5b on K2b's pieces. ptrs: as segmm_dual_stream_attention_chain_bwd's,
// in bf16; gv (B, Lv, d), gu (B, Lu, d); dys, dx, dwdb: as there, in bf16;
// ws: six bf16 workspaces, (B, Lv, 2d), (B, Lv, 2d), (B, Lu, 2d) of the
// video stream (q1|q2, k1|v1, k2|v2), then (B, Lu, 2d), (B, Lv, 2d),
// (B, Lu, 2d) of the user stream; scratch (fp32): the sum over the 12
// weights of dw_chunks(rows, chunk) * (d * d + d), chunk % 32 == 0, at most
// 96 chunks in all. DH in SEGMM_K2_HEAD_DIMS, d % 32 == 0, Lv and Lu <= 128.
// Five launches. Returns a cudaError_t (0 = launched).
extern "C" int segmm_dual_stream_attention_bwd_mma(
    const void* const* ptrs, const int* mv, const int* mu, const void* gv, const void* gu,
    float* const* dys, void* const* ws, void* const* dx, float* const* dwdb, float* scratch,
    int B, int Lv, int Lu, int dm, int H, float scale, float rate, float keep_div, unsigned seed,
    int chunk, void* stream) {
  return (int)segmm::launch_k5b_mma(ptrs, mv, mu, gv, gu, dys, ws, dx, dwdb, scratch, B, Lv, Lu,
                                    dm, H, scale, rate, keep_div, seed, chunk,
                                    static_cast<cudaStream_t>(stream));
}
