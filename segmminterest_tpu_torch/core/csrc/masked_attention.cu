// K3f: single-block masked attention, forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _fwd_kernel
// (:126), launched by _call_fwd (:212, pallas_call :238) behind
// fused_masked_attention (:324): the attention of the CrossAtt and SelfAtt
// ablations, one query set over one key block.
//   l = q.k^T in fp32; fill -10000 where mq x mk is 0; in training
//   keep ? l / (1 - rate) : 0 (joint_attention.cuh's hash mask, salt h);
//   x scale; fp32 softmax; p rounded to v's type; out = p.v in fp32, cast.
// Inputs (B, L, H, D) contiguous, fp32 or bf16, Dqk = Dv = D; masks int32
// (B, L). A fully padded query row keeps its -10000 logits and becomes the
// uniform softmax of a constant, as on the TPU.
//
// Design: K1f's with one key block. One thread block per (head, batch row)
// stages its head's q, k and v rows in shared memory as fp32 (at the
// largest launch of the flagship, (Lq, Lk) = (40, 100) or (100, 40), D=32:
// 35 KB); each warp takes one query row at a time, lanes split the keys for
// the logits, the whole row's softmax stays in shared memory (Lk <= 128, no
// online softmax), and lanes split the head dimension for the AV product.
// The logits and probabilities never reach device memory.
//
// What bounds it on an H100: device memory. q, k and v are read once and
// the output written once (0.59 GB in fp32 at B=1024, (40, 100), 16 heads
// of 32) against 4 Lq Lk D FLOP per (row, head) (8.4 GFLOP), which the fp32
// units would finish sooner. This first version, like K1f, waits on its
// fp32 FMAs with every operand in shared memory.
#include "joint_attention.cuh"

namespace segmm {

constexpr int kK3Threads = 256;
constexpr int kK3Rows = 1;  // query rows per warp at a time, as K1f

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kK3Threads)
masked_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ mq,
                  const int* __restrict__ mk, T* __restrict__ out, int Lq, int Lk, int H,
                  int D, float scale, float rate, float keep_div, unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int ds = tile_stride(D);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = sq + Lq * ds;
  float* sv = sk + Lk * ds;
  int* smq = reinterpret_cast<int*>(sv + Lk * ds);
  int* smk = smq + Lq;
  float* pbuf = reinterpret_cast<float*>(smq + pad4(Lq + Lk));

  load_head_rows<T>(q, sq, b, Lq, H, h, D, ds);
  load_head_rows<T>(k, sk, b, Lk, H, h, D, ds);
  load_head_rows<T>(v, sv, b, Lk, H, h, D, ds);
  for (int i = threadIdx.x; i < Lq; i += blockDim.x) smq[i] = mq[(long)b * Lq + i];
  for (int i = threadIdx.x; i < Lk; i += blockDim.x) smk[i] = mk[(long)b * Lk + i];
  __syncthreads();

  const Dropout dr = make_dropout(rate, keep_div, seed, b, gridDim.y);
  const int lds = pad4(Lk);
  float* p = pbuf + (size_t)warp * kK3Rows * lds;
  T* o = out + ((long)b * Lq * H + h) * D;
  const long ostride = (long)H * D;
  for (int q0 = warp * kK3Rows; q0 < Lq; q0 += nwarps * kK3Rows) {
    // rows past Lq repeat the last row and are not written
    int qr[kK3Rows], mqr[kK3Rows];
    float mx[kK3Rows];
#pragma unroll
    for (int r = 0; r < kK3Rows; ++r) {
      qr[r] = min(q0 + r, Lq - 1);
      mqr[r] = smq[qr[r]];
      mx[r] = -INFINITY;
    }
    block_logits<kK3Rows, kDrop>(sq, sk, ds, D, smk, Lk, qr, mqr, scale, dr, (unsigned)h, p,
                                 lds, mx);
#pragma unroll
    for (int r = 0; r < kK3Rows; ++r) {
      const float m = warp_max(mx[r]);
      float* pr = p + r * lds;
      float acc = 0.f;
      for (int j = lane; j < Lk; j += 32) {
        const float e = expf(pr[j] - m);
        pr[j] = e;
        acc += e;
      }
      const float s = warp_sum(acc);
      for (int j = lane; j < Lk; j += 32) pr[j] = round_to<T>(pr[j] / s);
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float a[kK3Rows];
#pragma unroll
      for (int r = 0; r < kK3Rows; ++r) a[r] = 0.f;
      block_av<kK3Rows>(p, lds, sv, ds, Lk, d, a);
#pragma unroll
      for (int r = 0; r < kK3Rows; ++r)
        if (q0 + r < Lq) o[(long)(q0 + r) * ostride + d] = from_f<T>(a[r]);
    }
    __syncwarp();
  }
}

inline size_t k3_smem_bytes(int Lq, int Lk, int D) {
  return sizeof(float) * (size_t)(Lq + 2 * Lk) * tile_stride(D) +
         sizeof(int) * (size_t)pad4(Lq + Lk) +
         sizeof(float) * (size_t)(kK3Threads / 32) * kK3Rows * pad4(Lk);
}

template <typename T, bool kDrop>
cudaError_t launch_k3_variant(const void* q, const void* k, const void* v, const int* mq,
                              const int* mk, void* out, int B, int Lq, int Lk, int H, int D,
                              float scale, float rate, float keep_div, unsigned seed,
                              cudaStream_t stream) {
  const size_t smem = k3_smem_bytes(Lq, Lk, D);
  cudaError_t err = cudaFuncSetAttribute(masked_fwd_kernel<T, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  masked_fwd_kernel<T, kDrop><<<dim3(H, B), kK3Threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mq, mk,
      static_cast<T*>(out), Lq, Lk, H, D, scale, rate, keep_div, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k3(const void* q, const void* k, const void* v, const int* mq, const int* mk,
                      void* out, int B, int Lq, int Lk, int H, int D, float scale, float rate,
                      float keep_div, unsigned seed, cudaStream_t stream) {
  auto launch = rate > 0.f ? launch_k3_variant<T, true> : launch_k3_variant<T, false>;
  return launch(q, k, v, mq, mk, out, B, Lq, Lk, H, D, scale, rate, keep_div, seed, stream);
}

}  // namespace segmm

// dtype: 0 = float32, 1 = bfloat16. rate > 0 applies the dropout mask of
// `seed` (keep_div = 1 - rate in fp32). Lq, Lk <= 128, D in {16, 32, 64}
// (the wrapper checks). Returns a cudaError_t (0 = launched).
extern "C" int segmm_masked_attention_fwd(int dtype, const void* q, const void* k,
                                          const void* v, const int* mq, const int* mk, void* out,
                                          int B, int Lq, int Lk, int H, int D, float scale,
                                          float rate, float keep_div, unsigned seed,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)segmm::launch_k3<float>(q, k, v, mq, mk, out, B, Lq, Lk, H, D, scale, rate,
                                        keep_div, seed, s);
  if (dtype == 1)
    return (int)segmm::launch_k3<__nv_bfloat16>(q, k, v, mq, mk, out, B, Lq, Lk, H, D, scale,
                                                rate, keep_div, seed, s);
  return (int)cudaErrorInvalidValue;
}
