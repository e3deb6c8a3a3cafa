// K1b: two-block jointly normalised attention, backward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _bwd2_kernel
// (:558), launched by _call2_bwd (:659) from the custom VJP of
// fused_two_block_attention (:704-729). Nothing of the forward is saved:
// the kernel recomputes the probabilities from q/k and the masks (and the
// dropout mask from the seed), then
//   dv = p^T g,  dp = g v^T,  s = sum dp1 p1 + sum dp2 p2 (both blocks),
//   dl = p (dp - s) scale, dropout mask, pair mask,  dq = dl k,  dk = dl^T q,
// all in fp32 (tf32_attention.cuh), and writes dq1, dq2, dk1, dk2, dv1, dv2
// in the input dtype. Inputs (B, L, H, D) contiguous, fp32; masks int32
// (B, L); g (B, Lq, H, D). bf16 K1b runs on K2's bf16 two-block core
// (segmm_two_block_core_bwd, proj_two_block_attention_bwd.cu).
//
// fp32 (the default training config's dtype): every product on the TF32
// tensor cores in 3xTF32, as PyTorch's memory-efficient SDPA backward runs
// its fp32 GEMMs (tf32_attention.cuh has the design and the numerics).
// One block per (head, batch row); the keys of both blocks on one axis
// [k1 | k2], block 2 from column pad8(L1); q1, q2, g, k1, v1, k2, v2 staged
// by cp.async as fp32 tiles of row stride D + 4 (D rounded up to 16, 32 or
// 64) over their lengths rounded up to 8, one fp32 [query][key] buffer that
// holds p, then dl. Shared memory per block at D = 32
// (tf32_bwd_smem_bytes), with the blocks an H100 SM holds by shared memory
// and by registers (ptxas, CUDA 12.8, phase build of chip_smoke.py: 253
// registers without dropout and 255 with it at (40 | 100) keys, no spill;
// 123 / 128 at (40 | 1), 24 bytes of spill with dropout; more than 144
// keys, and D = 16 or 64 (the 256-key tile only), spill at 255):
//   (40, 40, 100)   q/g 17.3 + k/v 41.5 + masks/keep bits 1.9 + P 23.7
//                   = 84.3 KB: 2 blocks of 4 warps
//   (100, 40, 100)  44.9 + 41.5 + 3.7 + 61.6 = 151.6 KB: 1 block, of 8
//                   warps, as only one block fits
//   (40, 40, 1)     17.3 + 13.8 + 0.7 + 8.3 = 40.2 KB: 4 blocks (registers)
//   (1, 40, 1)      3.5 + 13.8 + 0.4 + 1.7 = 19.3 KB: 4 blocks (registers)
// At D = 64 the largest stream takes 228.4 KB, within the 227 KB of one
// block; past it (96, 128) the body runs the queries in windows of blocks
// of their own and sums dk and dv over them in order (tf32_attention.cuh).
// The wrapper's rule (k1_body) holds the shapes it takes.
// A 16-row query tile at Lq = 1 does 16 rows' products for one (15/16 of
// pass 1's tensor-core work wasted; its rows draw no dropout bits); the
// shape's time is in PERF.md.
//
// What bounds it on an H100: device memory. It reads q1, q2, k1, v1, k2,
// v2 and g once and writes six gradients (1.6 GB in fp32 at B=1024,
// (40, 40, 100): 0.476 ms at 3.35 TB/s), against ~10 Lq (L1 + L2) D FLOP
// per (row, head), 29 GFLOP, three times over in 3xTF32: 0.18 ms at a third
// of the 495 TFLOP/s TF32 peak.
#include "joint_attention.cuh"
#include "tf32_attention.cuh"

namespace segmm {
// The fp32 body at head dims up to 16, from 36 to 64, to 96 and to 128
// is instantiated in two_block_attention_bwd.d16.cu, .d64.cu, .d96.cu and
// .d128.cu, the bodies with dropout at 64 and 128 in .d64_drop.cu and
// .d128_drop.cu, compiled beside this file (core/build.py), so that its
// longest compiles run side by side.
#define SEGMM_K1B_EXTERN(d)                                                              \
  extern template cudaError_t launch_tf32_bwd_drop<2, d, false>(const Tf32BwdArgs<2>&, \
                                                                 int, cudaStream_t);   \
  extern template cudaError_t launch_tf32_bwd_drop<2, d, true>(const Tf32BwdArgs<2>&,  \
                                                                int, cudaStream_t);
SEGMM_K1B_EXTERN(16)
SEGMM_K1B_EXTERN(64)
SEGMM_K1B_EXTERN(96)
SEGMM_K1B_EXTERN(128)
#undef SEGMM_K1B_EXTERN
}  // namespace segmm

namespace segmm {

// The bytes of the body's query window (tf32_bwd_window; all Lq where it
// fits), or of all Lq where no window fits.
inline size_t k1b_smem_bytes(int Lq, int L1, int L2, int D) {
  const int L[2] = {L1, L2};
  const int w = tf32_bwd_window(2, Lq, L, D);
  return tf32_bwd_smem_bytes(2, w ? w : Lq, L, D);
}

}  // namespace segmm

// dtype as below
extern "C" size_t segmm_two_block_attention_bwd_smem_bytes(int dtype, int Lq, int L1, int L2,
                                                           int D) {
  return dtype == 0 ? segmm::k1b_smem_bytes(Lq, L1, L2, D) : 0;
}

// The fp32 body's query windows at a shape (0: none fits); the wrapper
// gives windows - 1 part slots of scratch (tf32_part_floats).
extern "C" int segmm_two_block_attention_bwd_windows(int Lq, int L1, int L2, int D) {
  const int L[2] = {L1, L2};
  return segmm::tf32_windows(Lq, segmm::tf32_bwd_window(2, Lq, L, D));
}

// dtype: 0 = float32 (the 3xTF32 body; any other is refused). Inputs q1, q2,
// k1, k2, v1, v2, then the masks and g; outputs dq1, dq2, dk1, dk2, dv1,
// dv2 (same shapes and dtype as the inputs). Every length <= 128,
// D % 4 == 0 and D <= 128. part: scratch of (windows - 1) part slots, or
// null where there is one window. salt_h0, concat: as
// segmm_two_block_attention_fwd's.
// Returns a cudaError_t (0 = launched).
extern "C" int segmm_two_block_attention_bwd(
    int dtype, const void* q1, const void* q2, const void* k1, const void* k2,
    const void* v1, const void* v2, const int* mq, const int* mk1, const int* mk2,
    const void* g, void* dq1, void* dq2, void* dk1, void* dk2, void* dv1, void* dv2, int B,
    int Lq, int L1, int L2, int H, int D, float scale, float rate, float keep_div,
    unsigned seed, float* part, int salt_h0, int concat, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[6] = {q1, q2, k1, k2, v1, v2};
  void* out[6] = {dq1, dq2, dk1, dk2, dv1, dv2};
  if (dtype == 0) {
    const float* const* a = reinterpret_cast<const float* const*>(in);
    float* const* o = reinterpret_cast<float* const*>(out);
    const segmm::Tf32BwdArgs<2> args{{a[0], a[1]}, {a[2], a[3]}, {a[4], a[5]},
                                     static_cast<const float*>(g), mq, {mk1, mk2},
                                     {o[0], o[1]}, {o[2], o[3]}, {o[4], o[5]}, Lq, {L1, L2}, H, D,
                                     scale, rate, keep_div, seed, 0, part, salt_h0, concat};
    return (int)segmm::launch_tf32_attention_bwd<2>(args, B, s);
  }
  return (int)cudaErrorInvalidValue;
}
