// K1: two-block jointly normalised attention, forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _fwd2_kernel
// (:527), launched by _call2_fwd (:625) behind fused_two_block_attention
// (:732). One query set (q1 for key block 1, q2 for key block 2) attends two
// key/value blocks with one softmax over both:
//   l1 = q1.k1^T, l2 = q2.k2^T; fill -10000 where mq x mk is 0; in training
//   keep ? l / (1 - rate) : 0 (joint_attention.cuh's hash mask); x scale;
//   softmax over [l1 | l2] in fp32; out = p1.v1 + p2.v2.
// Inputs (B, L, H, D) contiguous, fp32 or bf16; masks int32 (B, L).
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
// The shape rule (core/attention.py k1_forward_body, tested on the CPU):
// the tensor-core body takes head dims D % 4 == 0 up to 64 and key axes
// pad8(L1) + pad8(L2) <= 256 (its largest register tile) where its tiles
// fit one block's shared memory: every stream of the model's
// configurations at head dims up to 64. The wrapper sends every other fp32
// shape (D = 128 under --nhead 4 at d_model 512, longer key axes) to the
// CUDA-core body below, by that rule and never on a failure; a body that
// does not build or launch raises.
//
// bf16, and fp32 outside the rule: the CUDA-core body of joint_attention.cuh.
// The block stages its head's q1, q2, k1, v1, k2, v2 rows in shared memory
// as fp32, then each warp takes one query row at a time: lanes split the
// keys for the logits, the whole row's softmax stays in shared memory, and
// lanes split the head dimension for the AV products. Its fp32 FMAs, with
// all operands in shared memory, are what it waits on.
//
// What bounds it on an H100: device memory. Every q/k/v value is read once
// and the output written once (0.84 GB in fp32 at B=1024, (40, 40, 100), 16
// heads of 32: 0.251 ms at 3.35 TB/s); the arithmetic is ~4 Lq (L1 + L2) D
// FLOP per (row, head), 11.7 GFLOP there, three times over in 3xTF32: 0.071
// ms at a third of the 495 TFLOP/s TF32 peak.
#include "joint_attention.cuh"
#include "projection.cuh"
#include "tf32_attention.cuh"

namespace segmm {
// The fp32 body at head dims past 64 is instantiated in two_block_attention.d96.cu and
// .d128.cu, compiled beside this file (core/build.py), so that its longest
// compiles run side by side.
extern template cudaError_t launch_tf32_fwd_nt<2, 96>(const Tf32FwdArgs<2>&, int,
                                                          cudaStream_t);
extern template cudaError_t launch_tf32_fwd_nt<2, 128>(const Tf32FwdArgs<2>&, int,
                                                           cudaStream_t);
}  // namespace segmm

namespace segmm {

constexpr int kK1Threads = 256;
// one query row per warp at a time: more would cost blocks per SM
constexpr int kK1Rows = 1;

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kK1Threads)
two_block_fwd_kernel(const T* __restrict__ q1, const T* __restrict__ q2,
                     const T* __restrict__ k1, const T* __restrict__ k2,
                     const T* __restrict__ v1, const T* __restrict__ v2,
                     const int* __restrict__ mq, const int* __restrict__ mk1,
                     const int* __restrict__ mk2, T* __restrict__ out,
                     int Lq, int L1, int L2, int H, int D, float scale, float rate,
                     float keep_div, unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int ds = tile_stride(D);
  extern __shared__ __align__(16) float smem[];
  float* sq1 = smem;
  float* sq2 = sq1 + Lq * ds;
  float* sk1 = sq2 + Lq * ds;
  float* sv1 = sk1 + L1 * ds;
  float* sk2 = sv1 + L1 * ds;
  float* sv2 = sk2 + L2 * ds;
  int* smq = reinterpret_cast<int*>(sv2 + L2 * ds);
  int* smk1 = smq + Lq;
  int* smk2 = smk1 + L1;
  float* pbuf = reinterpret_cast<float*>(smq + pad4(Lq + L1 + L2));

  load_head_rows<T>(q1, sq1, b, Lq, H, h, D, ds);
  load_head_rows<T>(q2, sq2, b, Lq, H, h, D, ds);
  load_head_rows<T>(k1, sk1, b, L1, H, h, D, ds);
  load_head_rows<T>(v1, sv1, b, L1, H, h, D, ds);
  load_head_rows<T>(k2, sk2, b, L2, H, h, D, ds);
  load_head_rows<T>(v2, sv2, b, L2, H, h, D, ds);
  load_masks(mq, mk1, mk2, b, Lq, L1, L2, smq, smk1, smk2);
  __syncthreads();

  const Dropout dr = make_dropout(rate, keep_div, seed, b, gridDim.y);
  joint_attention_rows<T, kK1Rows, kDrop>(sq1, sq2, sk1, sk2, sv1, sv2, ds, D, smq, smk1, smk2,
                          Lq, L1, L2, scale, dr, h, pbuf,
                          out + ((long)b * Lq * H + h) * D, (long)H * D);
}

inline size_t k1_smem_bytes(int Lq, int L1, int L2, int D) {
  return sizeof(float) * (size_t)(2 * Lq + 2 * L1 + 2 * L2) * tile_stride(D) +
         core_extra_bytes(Lq, L1, L2, kK1Threads / 32, kK1Rows);
}

template <typename T, bool kDrop>
cudaError_t launch_k1_variant(const void* q1, const void* q2, const void* k1, const void* k2,
                              const void* v1, const void* v2, const int* mq, const int* mk1,
                              const int* mk2, void* out, int B, int Lq, int L1, int L2, int H,
                              int D, float scale, float rate, float keep_div, unsigned seed,
                              cudaStream_t stream) {
  const size_t smem = k1_smem_bytes(Lq, L1, L2, D);
  cudaError_t err = cudaFuncSetAttribute(two_block_fwd_kernel<T, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  two_block_fwd_kernel<T, kDrop><<<dim3(H, B), kK1Threads, smem, stream>>>(
      static_cast<const T*>(q1), static_cast<const T*>(q2), static_cast<const T*>(k1),
      static_cast<const T*>(k2), static_cast<const T*>(v1), static_cast<const T*>(v2),
      mq, mk1, mk2, static_cast<T*>(out), Lq, L1, L2, H, D, scale, rate, keep_div, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k1(const void* q1, const void* q2, const void* k1, const void* k2,
                      const void* v1, const void* v2, const int* mq, const int* mk1,
                      const int* mk2, void* out, int B, int Lq, int L1, int L2,
                      int H, int D, float scale, float rate, float keep_div, unsigned seed,
                      cudaStream_t stream) {
  auto launch = rate > 0.f ? launch_k1_variant<T, true> : launch_k1_variant<T, false>;
  return launch(q1, q2, k1, k2, v1, v2, mq, mk1, mk2, out, B, Lq, L1, L2, H, D, scale, rate,
                keep_div, seed, stream);
}

}  // namespace segmm

// Shared memory of a block of each body: the CUDA-core one, and (tf32 = 1)
// the fp32 tensor-core one.
extern "C" size_t segmm_two_block_attention_smem_bytes(int tf32, int Lq, int L1, int L2, int D) {
  const int L[2] = {L1, L2};
  if (!tf32) return segmm::k1_smem_bytes(Lq, L1, L2, D);
  const int w = segmm::tf32_fwd_window(2, Lq, L, D);  // the query window's
  return segmm::tf32_fwd_smem_bytes(2, w ? w : Lq, L, D);
}

// fp32 projections of the fp32 routes of K2, K4, K5 and K6, as _proj
// rounds them (the fp32 dot, then the bias):
// job s projects x_s (B, L_s, d) through two (d, d) weights into two fp32
// (B, L_s, d) outputs; a block takes one batch row's 32 columns of both
// (projection.cuh's CUDA-core pair, its head as 32 columns), grid
// (d / 32, B, jobs).
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
  const long off = (long)b * j.L[s] * dm;
  if (j.L[s] > 0)
    segmm::project_pair_f32<32>(j.x[s] + off, j.L[s], dm, j.wa[s], j.ba[s], j.wb[s], j.bb[s],
                                h, pp_stage, j.oa[s] + off + h * 32, j.ob[s] + off + h * 32,
                                dm);
}

// x: n sources; w: wa, ba, wb, bb of each; out: its two outputs; L: its
// rows a batch row (<= 128). d % 32 == 0, n <= 6. Returns a cudaError_t.
extern "C" int segmm_project_pairs_f32(const void* const* x, const void* const* w,
                                       void* const* out, const int* L, int n, int B, int dm,
                                       void* stream) {
  if (n < 1 || n > 6 || dm % 32) return (int)cudaErrorInvalidValue;
  ProjPairJobs j{};
  int lmax = 0;
  for (int s = 0; s < n; ++s) {
    if (L[s] > segmm::kK2MaxL) return (int)cudaErrorInvalidValue;
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
  const size_t smem = segmm::k2_stage_bytes(lmax, 32);
  cudaError_t err = cudaFuncSetAttribute(proj_pairs_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  proj_pairs_f32_kernel<<<dim3(dm / 32, B, n), segmm::kK2Threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(j, dm);
  return (int)cudaGetLastError();
}

// Copies n values between fp32 and bf16 (to_bf16: fp32 -> bf16, rounded
// to nearest even; else bf16 -> fp32, exact): the bf16 K1 shapes that the
// CUDA-core bodies do not take run the fp32 tensor-core bodies on fp32
// copies of their inputs, and their outputs are rounded back.
__global__ void convert_kernel(const void* __restrict__ src, void* __restrict__ dst, long n,
                               int to_bf16) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    if (to_bf16)
      static_cast<__nv_bfloat16*>(dst)[i] = __float2bfloat16(static_cast<const float*>(src)[i]);
    else
      static_cast<float*>(dst)[i] = __bfloat162float(static_cast<const __nv_bfloat16*>(src)[i]);
  }
}

extern "C" int segmm_convert(int to_bf16, const void* src, void* dst, long n, void* stream) {
  if (n > 0)
    convert_kernel<<<4 * 132, 256, 0, static_cast<cudaStream_t>(stream)>>>(src, dst, n, to_bf16);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. tf32 = 1 runs the fp32 tensor-core body
// (refused outside its templates: D % 4 == 0 up to 128, pad8(L1) +
// pad8(L2) <= 256; past 64 its queries in windows where one block's tiles
// exceed shared memory), 0 the CUDA-core body. dtype 1 with tf32 = 1: the
// fp32 body on fp32 copies of bf16 inputs (q..v and out fp32), p rounded
// to bf16 before p v. rate > 0 applies the dropout mask of
// `seed` (keep_div = 1 - rate in fp32). Returns a cudaError_t (0 =
// launched).
// salt_h0, concat (the fp32 body only): the dropout salts' first head and
// K6's concatenated key axis (Tf32BwdArgs), where the fp32 routes of K2,
// K5 and K6 run on this one.
extern "C" int segmm_two_block_attention_fwd(
    int dtype, int tf32, const void* q1, const void* q2, const void* k1, const void* k2,
    const void* v1, const void* v2, const int* mq, const int* mk1, const int* mk2,
    void* out, int B, int Lq, int L1, int L2, int H, int D, float scale, float rate,
    float keep_div, unsigned seed, int salt_h0, int concat, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tf32) {
    using f = const float*;
    const segmm::Tf32FwdArgs<2> args{{static_cast<f>(q1), static_cast<f>(q2)},
                                     {static_cast<f>(k1), static_cast<f>(k2)},
                                     {static_cast<f>(v1), static_cast<f>(v2)},
                                     mq, {mk1, mk2}, static_cast<float*>(out), Lq, {L1, L2}, H,
                                     D, scale, rate, keep_div, seed, 0, dtype == 1, salt_h0,
                                     concat};
    return (int)segmm::launch_tf32_attention_fwd<2>(args, B, s);
  }
  if (dtype == 0)
    return (int)segmm::launch_k1<float>(q1, q2, k1, k2, v1, v2, mq, mk1, mk2, out,
                                        B, Lq, L1, L2, H, D, scale, rate, keep_div, seed, s);
  if (dtype == 1)
    return (int)segmm::launch_k1<__nv_bfloat16>(q1, q2, k1, k2, v1, v2, mq, mk1, mk2,
                                                out, B, Lq, L1, L2, H, D, scale, rate,
                                                keep_div, seed, s);
  return (int)cudaErrorInvalidValue;
}
