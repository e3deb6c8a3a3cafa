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
// Design: one thread block per (head, batch row). The block stages its
// head's q1, q2, k1, v1, k2, v2 rows in shared memory as fp32 (at the
// largest stream, Lq=100, L1=40, L2=100, D=32: 69 KB), then each warp takes
// one query row at a time: lanes split the keys for the logits, the
// whole row's softmax stays in shared memory (Lk <= 200, so no online
// softmax), and lanes split the head dimension for the AV products. The
// logits and probabilities never reach device memory.
//
// What bounds it on an H100: device memory. Every q/k/v value is read once
// and the output written once; the arithmetic is ~2*Lq*(L1+L2)*D*2 FLOP per
// (row, head), far below the bytes-to-FLOP balance of the card, so the
// kernel's floor is its bytes over 3.35 TB/s. The core's fp32 FMAs, with
// all operands in shared memory, are what this version actually waits on.
#include "joint_attention.cuh"

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

extern "C" size_t segmm_two_block_attention_smem_bytes(int Lq, int L1, int L2, int D) {
  return segmm::k1_smem_bytes(Lq, L1, L2, D);
}

// dtype: 0 = float32, 1 = bfloat16. rate > 0 applies the dropout mask of
// `seed` (keep_div = 1 - rate in fp32). Returns a cudaError_t (0 = launched).
extern "C" int segmm_two_block_attention_fwd(
    int dtype, const void* q1, const void* q2, const void* k1, const void* k2,
    const void* v1, const void* v2, const int* mq, const int* mk1, const int* mk2,
    void* out, int B, int Lq, int L1, int L2, int H, int D, float scale, float rate,
    float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)segmm::launch_k1<float>(q1, q2, k1, k2, v1, v2, mq, mk1, mk2, out,
                                        B, Lq, L1, L2, H, D, scale, rate, keep_div, seed, s);
  if (dtype == 1)
    return (int)segmm::launch_k1<__nv_bfloat16>(q1, q2, k1, k2, v1, v2, mq, mk1, mk2,
                                                out, B, Lq, L1, L2, H, D, scale, rate,
                                                keep_div, seed, s);
  return (int)cudaErrorInvalidValue;
}
