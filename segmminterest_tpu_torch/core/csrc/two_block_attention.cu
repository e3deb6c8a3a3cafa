// K1: two-block jointly normalised attention, forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _fwd2_kernel
// (:527), launched by _call2_fwd (:625) behind fused_two_block_attention
// (:732). One query set (q1 for key block 1, q2 for key block 2) attends two
// key/value blocks with one softmax over both:
//   l1 = q1.k1^T, l2 = q2.k2^T; fill -10000 where mq x mk is 0; in training
//   keep ? l / (1 - rate) : 0 (joint_attention.cuh's hash mask); x scale;
//   softmax over [l1 | l2] in fp32; out = p1.v1 + p2.v2.
// Inputs (B, L, H, D) contiguous, fp32; masks int32 (B, L). bf16 K1f runs
// on K2's bf16 two-block core (segmm_two_block_core_fwd,
// proj_two_block_attention.cu).
//
// fp32 (the default config's dtype): on the TF32 tensor cores in 3xTF32,
// as PyTorch's memory-efficient SDPA forward runs its fp32 GEMMs
// (tf32_attention.cuh has the design and the numerics). One block per
// (head, batch row), a warp per 16-row query tile (at most four); the keys
// of both blocks on one axis [k1 | k2], block 2 from column pad8(L1); q1,
// q2, k1, v1, k2, v2 staged by cp.async as fp32 tiles of row stride D + 4
// (D rounded up to 16, 32 or 64) over their lengths rounded up to 8; S, the
// softmax over both blocks and p in registers, out = p1 v1 + p2 v2 on the
// tensor cores with p's C tiles as the A operand, out in 16-byte stores.
// Shared memory per block at D = 32 (tf32_fwd_smem_bytes): (40, 40, 100)
// 53.7 KB, (100, 40, 100) 72.4 KB, (40, 40, 1) 25.7 KB, (1, 40, 1) 16.4 KB.
// Registers (ptxas, nvcc 12.9, chip_smoke.py phase build): 168 without
// dropout and 217 with it at 18 key tiles ((40 | 100) keys), 96 / 119 at
// 6, no spill; the 256-key tile and head dims 16 and 64 (their largest
// tile only) take 247-255 and spill with dropout (D = 64 also without),
// off the model's streams.
// Dropout costs the two-block body most: 3 blocks an SM fit at (40, 40,
// 100) where 4 do without it, and each key tile picks its block's salt and
// key offset at run time before it hashes.
//
// The body takes head dims D % 4 == 0 up to 128 at every length: in one
// chunk where its key axis pad8(L1) + pad8(L2) fits its register tile (256
// keys, 144 past head dim 64) and a query window fits one block (every
// stream of the model's configurations), else on its key-chunk path
// (tf32_chunked.cu), by the shape (tf32_whole) and never on a failure.
//
// What bounds it on an H100: device memory. Every q/k/v value is read once
// and the output written once (0.84 GB in fp32 at B=1024, (40, 40, 100), 16
// heads of 32: 0.251 ms at 3.35 TB/s); the arithmetic is ~4 Lq (L1 + L2) D
// FLOP per (row, head), 11.7 GFLOP there, three times over in 3xTF32: 0.071
// ms at a third of the 495 TFLOP/s TF32 peak.
#include "projection.cuh"
#include "tf32_attention.cuh"

namespace segmm {
// The fp32 body at each head dim is instantiated in two_block_attention.d16.cu,
// .d32.cu, .d64.cu, .d96.cu and .d128.cu, compiled beside this file
// (core/build.py), so that its long compiles run side by side.
#define SEGMM_K1F_EXTERN(d)                                                          \
  extern template cudaError_t launch_tf32_fwd_nt<2, d>(const Tf32FwdArgs<2>&, int, \
                                                       cudaStream_t);
SEGMM_K1F_EXTERN(16)
SEGMM_K1F_EXTERN(32)
SEGMM_K1F_EXTERN(64)
SEGMM_K1F_EXTERN(96)
SEGMM_K1F_EXTERN(128)
#undef SEGMM_K1F_EXTERN
}  // namespace segmm

// Shared memory of a block of the one-chunk body (tf32 = 1; 0 has no
// body).
extern "C" size_t segmm_two_block_attention_smem_bytes(int tf32, int Lq, int L1, int L2, int D) {
  const int L[2] = {L1, L2};
  if (!tf32) return 0;
  const int w = segmm::tf32_fwd_window(2, Lq, L, D);  // the query window's
  return segmm::tf32_fwd_smem_bytes(2, w ? w : Lq, L, D);
}

// fp32 projections of the fp32 routes of K2, K4, K5 and K6, as _proj
// rounds them (the fp32 dot, then the bias):
// job s projects x_s (B, L_s, d) through two (d, d) weights into two fp32
// (B, L_s, d) outputs; a block takes one batch row's 32 columns of both
// (projection.cuh's CUDA-core pair, its head as 32 columns), its rows
// kK2MaxL at a time, grid (d / 32, B, jobs).
struct ProjPairJobs {
  const float* x[6];
  const float *wa[6], *ba[6], *wb[6], *bb[6];
  float *oa[6], *ob[6];
  int L[6];
};

__global__ void __launch_bounds__(segmm::kK2Threads)
    proj_pairs_f32_kernel(const ProjPairJobs j, int dm) {
  const int s = blockIdx.z, h = blockIdx.x, b = blockIdx.y;
  extern __shared__ __align__(16) float pp_stage[];
  for (int r0 = 0; r0 < j.L[s]; r0 += segmm::kK2MaxL) {
    const long off = ((long)b * j.L[s] + r0) * dm;
    const int n = min(segmm::kK2MaxL, j.L[s] - r0);
    segmm::project_pair_f32<32>(j.x[s] + off, n, dm, j.wa[s], j.ba[s], j.wb[s], j.bb[s], h,
                                pp_stage, j.oa[s] + off + h * 32, j.ob[s] + off + h * 32, dm);
  }
}

// x: n sources; w: wa, ba, wb, bb of each; out: its two outputs; L: its
// rows a batch row. d % 32 == 0, n <= 6. Returns a cudaError_t.
extern "C" int segmm_project_pairs_f32(const void* const* x, const void* const* w,
                                       void* const* out, const int* L, int n, int B, int dm,
                                       void* stream) {
  if (n < 1 || n > 6 || dm % 32) return (int)cudaErrorInvalidValue;
  ProjPairJobs j{};
  int lmax = 0;
  for (int s = 0; s < n; ++s) {
    j.x[s] = static_cast<const float*>(x[s]);
    j.wa[s] = static_cast<const float*>(w[4 * s]);
    j.ba[s] = static_cast<const float*>(w[4 * s + 1]);
    j.wb[s] = static_cast<const float*>(w[4 * s + 2]);
    j.bb[s] = static_cast<const float*>(w[4 * s + 3]);
    j.oa[s] = static_cast<float*>(out[2 * s]);
    j.ob[s] = static_cast<float*>(out[2 * s + 1]);
    j.L[s] = L[s];
    lmax = L[s] > lmax ? L[s] : lmax;
  }
  const size_t smem = segmm::k2_stage_bytes(lmax < segmm::kK2MaxL ? lmax : segmm::kK2MaxL, 32);
  cudaError_t err = cudaFuncSetAttribute(proj_pairs_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  proj_pairs_f32_kernel<<<dim3(dm / 32, B, n), segmm::kK2Threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(j, dm);
  return (int)cudaGetLastError();
}

// fp32 q1..v2 (B, L, H, D), D % 4 == 0 up to 128 (refused otherwise), any
// lengths. rate > 0 applies the dropout mask of `seed` (keep_div = 1 -
// rate in fp32). salt_h0, concat: the dropout salts' first head and K6's
// concatenated key axis (Tf32BwdArgs), where the fp32 routes of K2, K5 and
// K6 run on this one. Returns a cudaError_t (0 = launched).
extern "C" int segmm_two_block_attention_fwd(
    const void* q1, const void* q2, const void* k1, const void* k2,
    const void* v1, const void* v2, const int* mq, const int* mk1, const int* mk2,
    void* out, int B, int Lq, int L1, int L2, int H, int D, float scale, float rate,
    float keep_div, unsigned seed, int salt_h0, int concat, void* stream) {
  using f = const float*;
  const segmm::Tf32FwdArgs<2> args{{static_cast<f>(q1), static_cast<f>(q2)},
                                   {static_cast<f>(k1), static_cast<f>(k2)},
                                   {static_cast<f>(v1), static_cast<f>(v2)},
                                   mq, {mk1, mk2}, static_cast<float*>(out), Lq, {L1, L2}, H,
                                   D, scale, rate, keep_div, seed, 0, salt_h0, concat};
  return (int)segmm::launch_tf32_attention_fwd<2>(args, B, static_cast<cudaStream_t>(stream));
}
