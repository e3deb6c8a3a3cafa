// K1b: two-block jointly normalised attention, backward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _bwd2_kernel
// (:558), launched by _call2_bwd (:659) from the custom VJP of
// fused_two_block_attention (:704-729). Nothing of the forward is saved:
// the kernel recomputes the probabilities from q/k and the masks (and the
// dropout mask from the seed), then
//   dv = p^T g,  dp = g v^T,  s = sum dp1 p1 + sum dp2 p2 (both blocks),
//   dl = p (dp - s) scale, dropout mask, pair mask,  dq = dl k,  dk = dl^T q,
// all in fp32 (joint_attention.cuh), and writes dq1, dq2, dk1, dk2, dv1, dv2
// in the input dtype. Inputs (B, L, H, D) contiguous, fp32 or bf16; masks
// int32 (B, L); g (B, Lq, H, D).
//
// Design: one thread block per (head, batch row), as in K1's forward. The
// block stages its head's q1, q2, g, k1, v1, k2, v2 rows in shared memory as
// fp32 and keeps the whole (Lq x (L1 + L2)) probability matrix there, which
// dl then overwrites in place (at the largest stream, Lq=100, L1=40,
// L2=100, D=32: 140 KB, one block per SM). Logits and dp split the keys over
// the lanes; the four products give each lane one column of the head and
// each warp four rows.
//
// What bounds it on an H100: device memory. It reads q1, q2, k1, v1, k2,
// v2 and g once and writes six gradients (about 1.6 GB in fp32 at B=1024,
// (40, 40, 100)), against ~10 Lq (L1 + L2) D FLOP per (row, head) (29 GFLOP),
// which the card would finish sooner on its fp32 units. This first version
// waits on its fp32 FMAs with every operand in shared memory instead.
#include "joint_attention.cuh"

namespace segmm {

constexpr int kK1bThreads = 256;

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kK1bThreads)
two_block_bwd_kernel(const T* __restrict__ q1, const T* __restrict__ q2,
                     const T* __restrict__ k1, const T* __restrict__ k2,
                     const T* __restrict__ v1, const T* __restrict__ v2,
                     const int* __restrict__ mq, const int* __restrict__ mk1,
                     const int* __restrict__ mk2, const T* __restrict__ g,
                     T* __restrict__ dq1, T* __restrict__ dq2, T* __restrict__ dk1,
                     T* __restrict__ dk2, T* __restrict__ dv1, T* __restrict__ dv2,
                     int Lq, int L1, int L2, int H, int D, float scale, float rate,
                     float keep_div, unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int ds = tile_stride(D);
  extern __shared__ __align__(16) float smem[];
  float* sq1 = smem;
  float* sq2 = sq1 + Lq * ds;
  float* sg = sq2 + Lq * ds;
  float* sk1 = sg + Lq * ds;
  float* sv1 = sk1 + L1 * ds;
  float* sk2 = sv1 + L1 * ds;
  float* sv2 = sk2 + L2 * ds;
  int* smq = reinterpret_cast<int*>(sv2 + L2 * ds);
  int* smk1 = smq + Lq;
  int* smk2 = smk1 + L1;
  float* P = reinterpret_cast<float*>(smq + pad4(Lq + L1 + L2));

  load_head_rows<T>(q1, sq1, b, Lq, H, h, D, ds);
  load_head_rows<T>(q2, sq2, b, Lq, H, h, D, ds);
  load_head_rows<T>(g, sg, b, Lq, H, h, D, ds);
  load_head_rows<T>(k1, sk1, b, L1, H, h, D, ds);
  load_head_rows<T>(v1, sv1, b, L1, H, h, D, ds);
  load_head_rows<T>(k2, sk2, b, L2, H, h, D, ds);
  load_head_rows<T>(v2, sv2, b, L2, H, h, D, ds);
  load_masks(mq, mk1, mk2, b, Lq, L1, L2, smq, smk1, smk2);
  __syncthreads();

  const Dropout dr = make_dropout(rate, keep_div, seed, b, gridDim.y);
  const long stride = (long)H * D;
  const long oq = ((long)b * Lq * H + h) * D;
  const long o1 = ((long)b * L1 * H + h) * D;
  const long o2 = ((long)b * L2 * H + h) * D;
  joint_attention_bwd<T, kDrop>(sq1, sq2, sg, sk1, sv1, sk2, sv2, ds, D, smq, smk1, smk2, Lq,
                                L1, L2, scale, dr, h, P, dq1 + oq, dq2 + oq, dk1 + o1, dk2 + o2,
                                dv1 + o1, dv2 + o2, stride);
}

inline size_t k1b_smem_bytes(int Lq, int L1, int L2, int D) {
  return bwd_core_bytes(Lq, L1, L2, D);
}

template <typename T, bool kDrop>
cudaError_t launch_k1b_variant(const void* const* in, const int* mq, const int* mk1,
                               const int* mk2, const void* g, void* const* out, int B, int Lq,
                               int L1, int L2, int H, int D, float scale, float rate,
                               float keep_div, unsigned seed, cudaStream_t stream) {
  const size_t smem = k1b_smem_bytes(Lq, L1, L2, D);
  cudaError_t err = cudaFuncSetAttribute(two_block_bwd_kernel<T, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const T* const* a = reinterpret_cast<const T* const*>(in);
  T* const* o = reinterpret_cast<T* const*>(out);
  two_block_bwd_kernel<T, kDrop><<<dim3(H, B), kK1bThreads, smem, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], mq, mk1, mk2, static_cast<const T*>(g), o[0], o[1],
      o[2], o[3], o[4], o[5], Lq, L1, L2, H, D, scale, rate, keep_div, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k1b(const void* const* in, const int* mq, const int* mk1, const int* mk2,
                       const void* g, void* const* out, int B, int Lq, int L1, int L2, int H,
                       int D, float scale, float rate, float keep_div, unsigned seed,
                       cudaStream_t stream) {
  auto launch = rate > 0.f ? launch_k1b_variant<T, true> : launch_k1b_variant<T, false>;
  return launch(in, mq, mk1, mk2, g, out, B, Lq, L1, L2, H, D, scale, rate, keep_div, seed,
                stream);
}

}  // namespace segmm

extern "C" size_t segmm_two_block_attention_bwd_smem_bytes(int Lq, int L1, int L2, int D) {
  return segmm::k1b_smem_bytes(Lq, L1, L2, D);
}

// dtype: 0 = float32, 1 = bfloat16. Inputs q1, q2, k1, k2, v1, v2, then
// the masks and g; outputs dq1, dq2, dk1, dk2, dv1, dv2 (same shapes and
// dtype as the inputs). Every length <= 128, D % 4 == 0 and D <= 64.
// Returns a cudaError_t (0 = launched).
extern "C" int segmm_two_block_attention_bwd(
    int dtype, const void* q1, const void* q2, const void* k1, const void* k2,
    const void* v1, const void* v2, const int* mq, const int* mk1, const int* mk2,
    const void* g, void* dq1, void* dq2, void* dk1, void* dk2, void* dv1, void* dv2, int B,
    int Lq, int L1, int L2, int H, int D, float scale, float rate, float keep_div,
    unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[6] = {q1, q2, k1, k2, v1, v2};
  void* out[6] = {dq1, dq2, dk1, dk2, dv1, dv2};
  if (dtype == 0)
    return (int)segmm::launch_k1b<float>(in, mq, mk1, mk2, g, out, B, Lq, L1, L2, H, D, scale,
                                         rate, keep_div, seed, s);
  if (dtype == 1)
    return (int)segmm::launch_k1b<__nv_bfloat16>(in, mq, mk1, mk2, g, out, B, Lq, L1, L2, H,
                                                 D, scale, rate, keep_div, seed, s);
  return (int)cudaErrorInvalidValue;
}
