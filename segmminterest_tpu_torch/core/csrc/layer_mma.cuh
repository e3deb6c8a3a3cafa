// bf16 K4's epilogue on the tensor cores, both directions (layer_stream.cu,
// layer_stream_bwd.cu): the three Dense layers, their dropout, both
// LayerNorms and the GELU of one encoder-layer stream over rows of
// (B * Lq), on mma.sync m16n8k16 with fp32 accumulators (mma_sync.cuh gives
// the fragment layout).
//
// Function (segmminterest_tpu/core/layer_kernel.py _epilogue_fwd :107 and
// _fl_bwd_kernel's epilogue backward :265-289), with the roundings of the
// port's plain versions (core/layer_kernel.py):
//   h = bf16(bf16(att . W_ff^T) + b_ff), dropped: bf16(h / bf16(1 - rate))
//   r1 = bf16(xq + h), y1 = bf16(LN1(r1))          fp32 fast-variance LN
//   u = bf16(bf16(y1 . W_m1^T) + b_m1), g = bf16(gelu(u)), dropout
//   m = bf16(bf16(g . W_m2^T) + b_m2), dropout, r2 = bf16(y1 + m)
//   out = LN2(r2)
// backward, every product with an fp32 operand:
//   dr2 = LN2'(g_out), dm = drop(dr2), dg = drop(dm . W_m2),
//   du = dg gelu'(u), dy1 = dr2 + du . W_m1, dr1 = LN1'(dy1),
//   dh = drop(dr1), d_att = dh . W_ff
// with the three salts 2H, 2H + 1, 2H + 2 (h, g, m) and a backward divisor
// 1 - rate in fp32.
//
// Geometry. A LayerNorm needs a whole row of d, so one block owns its rows
// and every output column: 16 warps, each a 32-row accumulator tile, in
// one of two geometries (layer_mma_body.cuh, once per namespace):
//  * lm512, d, ff <= 512: 64 rows a block, 2 x 8 warps of 32 x 64 tiles
//    (64 fp32 a thread, so that 512 threads fit an SM's registers; eight
//    warps of 64 x 64 tiles left the epilogues half as many warps to hide
//    their latency, and ran them ~15% slower on an H100);
//  * lm768, d, ff <= 768: 32 rows a block, 1 x 16 warps of 32 x 48 tiles
//    (48 fp32 a thread): 64 rows of 768 columns would need 96 fp32 a
//    thread, past what 512 threads have, and the ring's stages (32 + 768
//    rows of 40 bf16) still fit three deep.
// A product's
// operands stream through a ring of kLmStages shared-memory stages by
// cp.async, 32 deep a stage (gm_mainloop): the block's 64 rows of A (bf16,
// or fp32, which the block splits once a stage into three bf16 planes) and
// the whole weight. Each product's epilogue (bias, dropout, residual,
// GELU, the LayerNorms and their backward) works on the accumulators
// moved to an fp32 tile in the ring, a warp per row (below, "The
// epilogues"). Between the products, y1, g (forward) and dm, du, dh
// (backward) go through device memory, where the backward's weight
// gradients need them anyway; each block reads back only its own rows.
// Dropout: each row's hash terms once, then a hash per element; the
// backward draws each salt's bits again where it needs them.
//
// What bounds it on an H100: operations. Per row the forward is 2 (d^2 +
// 2 d ff) FLOP on the bf16 tensor cores; the backward recomputes it and
// runs its three dgrad products in three bf16 parts. Each block reads the
// three weights (1.5 MB at d = ff = 512) from L2 once a product.
#pragma once

#include "layer_epilogue.cuh"
#include "proj_gemm.cuh"

namespace segmm {

struct LmFwdArgs {
  const bf16* att;   // (rows, d)
  const bf16* xq;    // (rows, d)
  bf16* y1;          // (rows, d)
  bf16* gact;        // (rows, ff), after its dropout
  bf16* out;         // (rows, d), forward only
  EpParams<bf16> ep;
  int rows, Lq, B, d, ff, H;
  float rate, epi_div;
  unsigned seed;
};

struct LmBwdArgs {
  LmFwdArgs f;       // att, xq, y1, gact (written), out unused
  const bf16* g;     // (rows, d), the upstream gradient
  float* r1;         // (rows, d): r1, then dr1 (the residual's gradient into xq)
  float* u;          // (rows, ff): u, then du
  float* dm;         // (rows, d)
  float* dh;         // (rows, d): dr2, then dh
  bf16* datt_hi;     // (rows, d): d_att = hi + lo, two bf16 halves (the
  bf16* datt_lo;     //   core stages them as K2b's g)
  float* part;       // (blocks, 4, d): column sums of g xhat2, g, dy1 xhat1, dy1
  float keep_div;    // 1 - rate in fp32 (the backward's divisor)
};

// The two geometries (the file's head).
namespace lm512 {
constexpr int kLmRows = 64, kLmWarpsN = 8, kLmNT = 8;
#include "layer_mma_body.cuh"
}  // namespace lm512

namespace lm768 {
constexpr int kLmRows = 32, kLmWarpsN = 16, kLmNT = 6;
#include "layer_mma_body.cuh"
}  // namespace lm768

// ---------------------------------------------------------------------------
// Host side: the geometry of a width

constexpr int kLmThreads = lm512::kLmThreads;

inline bool lm_narrow(int d, int ff) { return lm512::lm_takes(d, ff); }
inline bool lm_takes(int d, int ff) { return lm512::lm_takes(d, ff) || lm768::lm_takes(d, ff); }
inline int lm_rows(int d, int ff) { return lm_narrow(d, ff) ? lm512::kLmRows : lm768::kLmRows; }
inline int lm_blocks(int rows, int d, int ff) {
  const int r = lm_rows(d, ff);
  return (rows + r - 1) / r;
}
inline size_t lm_fwd_smem_bytes(int d, int ff) {
  return lm_narrow(d, ff) ? lm512::kLmFwdSmemBytes : lm768::kLmFwdSmemBytes;
}
inline size_t lm_bwd_smem_bytes(int d, int ff) {
  return lm_narrow(d, ff) ? lm512::kLmBwdSmemBytes : lm768::kLmBwdSmemBytes;
}
inline void (*lm_fwd_kernel(int d, int ff, bool drop))(LmFwdArgs) {
  if (lm_narrow(d, ff))
    return drop ? lm512::layer_epilogue_fwd_mma_kernel<true>
                : lm512::layer_epilogue_fwd_mma_kernel<false>;
  return drop ? lm768::layer_epilogue_fwd_mma_kernel<true>
              : lm768::layer_epilogue_fwd_mma_kernel<false>;
}
inline void (*lm_bwd_kernel(int d, int ff, bool drop))(LmBwdArgs) {
  if (lm_narrow(d, ff))
    return drop ? lm512::layer_epilogue_bwd_mma_kernel<true>
                : lm512::layer_epilogue_bwd_mma_kernel<false>;
  return drop ? lm768::layer_epilogue_bwd_mma_kernel<true>
              : lm768::layer_epilogue_bwd_mma_kernel<false>;
}

}  // namespace segmm
