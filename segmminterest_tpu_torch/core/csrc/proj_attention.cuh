// The per-(head, batch row) block bodies of the projection-fused kernels,
// shared by K2 (proj_two_block_attention*.cu), K5 (dual_stream_attention*.cu)
// and K4 (layer_stream*.cu):
//  * proj_fwd_block: K2f's forward. The six projections of head h with
//    _proj's rounding (projection.cuh), then the joint-softmax core of
//    joint_attention.cuh; the head's DH output columns of batch row b.
//  * proj_qkv_bwd_block: K2b's qkv pass. The projections recomputed, then
//    the joint-softmax backward; fp32 dq1, dq2, dk1, dk2, dv1, dv2 of head
//    h of batch row b. The upstream gradient g may be the compute dtype
//    (K2b, K5b) or fp32 (K4b, whose epilogue backward gives an fp32 g).
// `salt_h` is the head index the dropout mask is salted with: h for K2 and
// K4 and K5's video stream, H + h for K5's user stream.
#pragma once

#include "projection.cuh"

namespace segmm {

// The twelve projection parameters of one stream: wq1, bq1, wq2, bq2, wk1,
// bk1, wk2, bk2, wv1, bv1, wv2, bv2 (nn.Linear layout (out, in), (d,)).
template <typename T>
struct ProjWeights {
  const T* p[12];
};

template <typename T>
inline ProjWeights<T> proj_weights(const void* const* ptrs) {
  ProjWeights<T> w;
  for (int i = 0; i < 12; ++i) w.p[i] = static_cast<const T*>(ptrs[i]);
  return w;
}

__host__ __device__ inline int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// Shared-memory bytes of proj_fwd_block.
inline size_t k2_smem_bytes(bool tensor_cores, int Lq, int L1, int L2, int DH) {
  return k2_stage_bytes(tensor_cores, max3(Lq, L1, L2), DH) +
         sizeof(float) * (size_t)(2 * Lq + 2 * L1 + 2 * L2) * tile_stride(DH) +
         core_extra_bytes(Lq, L1, L2, kK2Threads / 32, kK2Rows);
}

// Shared-memory bytes of proj_qkv_bwd_block.
inline size_t k2b_smem_bytes(bool tensor_cores, int Lq, int L1, int L2, int DH) {
  return k2_stage_bytes(tensor_cores, max3(Lq, L1, L2), DH) + bwd_core_bytes(Lq, L1, L2, DH);
}

// Forward of head h, batch row b: out row q of the head at
// out + (b * Lq + q) * dm + h * DH. x*, masks and out are the whole
// (B, L, d) / (B, L) tensors.
template <typename T, int DH, bool kDrop>
__device__ __forceinline__ void proj_fwd_block(const T* __restrict__ xq, const T* __restrict__ x1,
                                               const T* __restrict__ x2, ProjWeights<T> w,
                                               const int* __restrict__ mq,
                                               const int* __restrict__ mk1,
                                               const int* __restrict__ mk2, T* __restrict__ out,
                                               int Lq, int L1, int L2, int dm, float scale,
                                               Dropout dr, int h, int salt_h, int b) {
  constexpr int DS = tile_stride(DH);
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stage = smem;  // first: wmma and float4 need aligned tiles
  float* sq1 = reinterpret_cast<float*>(smem + k2_stage_bytes(kTc, max3(Lq, L1, L2), DH));
  float* sq2 = sq1 + Lq * DS;
  float* sk1 = sq2 + Lq * DS;
  float* sv1 = sk1 + L1 * DS;
  float* sk2 = sv1 + L1 * DS;
  float* sv2 = sk2 + L2 * DS;
  int* smq = reinterpret_cast<int*>(sv2 + L2 * DS);
  int* smk1 = smq + Lq;
  int* smk2 = smk1 + L1;
  float* pbuf = reinterpret_cast<float*>(smq + pad4(Lq + L1 + L2));

  const T* const* p = w.p;
  project_pair<T, DH>(xq + (long)b * Lq * dm, Lq, dm, p[0], p[1], p[2], p[3], h, stage, sq1, sq2);
  project_pair<T, DH>(x1 + (long)b * L1 * dm, L1, dm, p[4], p[5], p[8], p[9], h, stage, sk1, sv1);
  project_pair<T, DH>(x2 + (long)b * L2 * dm, L2, dm, p[6], p[7], p[10], p[11], h, stage, sk2,
                      sv2);
  load_masks(mq, mk1, mk2, b, Lq, L1, L2, smq, smk1, smk2);
  __syncthreads();

  joint_attention_rows<T, kK2Rows, kDrop>(sq1, sq2, sk1, sk2, sv1, sv2, DS, DH, smq, smk1, smk2,
                                          Lq, L1, L2, scale, dr, salt_h, pbuf,
                                          out + (long)b * Lq * dm + h * DH, (long)dm);
}

// The qkv pass of head h, batch row b: fp32 gradients of q1, q2 (Lq rows),
// k1, v1 (L1), k2, v2 (L2), written into (B, L, d) tensors. g: (B, Lq, d)
// of type TG.
template <typename T, typename TG, int DH, bool kDrop>
__device__ __forceinline__ void proj_qkv_bwd_block(
    const T* __restrict__ xq, const T* __restrict__ x1, const T* __restrict__ x2,
    ProjWeights<T> w, const int* __restrict__ mq, const int* __restrict__ mk1,
    const int* __restrict__ mk2, const TG* __restrict__ g, float* __restrict__ dq1,
    float* __restrict__ dq2, float* __restrict__ dk1, float* __restrict__ dk2,
    float* __restrict__ dv1, float* __restrict__ dv2, int Lq, int L1, int L2, int dm,
    float scale, Dropout dr, int h, int salt_h, int b) {
  constexpr int DS = tile_stride(DH);
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value;
  const int H = dm / DH;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stage = smem;
  float* sq1 = reinterpret_cast<float*>(smem + k2_stage_bytes(kTc, max3(Lq, L1, L2), DH));
  float* sq2 = sq1 + Lq * DS;
  float* sg = sq2 + Lq * DS;
  float* sk1 = sg + Lq * DS;
  float* sv1 = sk1 + L1 * DS;
  float* sk2 = sv1 + L1 * DS;
  float* sv2 = sk2 + L2 * DS;
  int* smq = reinterpret_cast<int*>(sv2 + L2 * DS);
  int* smk1 = smq + Lq;
  int* smk2 = smk1 + L1;
  float* P = reinterpret_cast<float*>(smq + pad4(Lq + L1 + L2));

  const T* const* p = w.p;
  project_pair<T, DH>(xq + (long)b * Lq * dm, Lq, dm, p[0], p[1], p[2], p[3], h, stage, sq1, sq2);
  project_pair<T, DH>(x1 + (long)b * L1 * dm, L1, dm, p[4], p[5], p[8], p[9], h, stage, sk1, sv1);
  project_pair<T, DH>(x2 + (long)b * L2 * dm, L2, dm, p[6], p[7], p[10], p[11], h, stage, sk2,
                      sv2);
  load_head_rows<TG>(g, sg, b, Lq, H, h, DH, DS);
  load_masks(mq, mk1, mk2, b, Lq, L1, L2, smq, smk1, smk2);
  __syncthreads();

  const long oq = (long)b * Lq * dm + h * DH;
  const long o1 = (long)b * L1 * dm + h * DH;
  const long o2 = (long)b * L2 * dm + h * DH;
  joint_attention_bwd<float, kDrop>(sq1, sq2, sg, sk1, sv1, sk2, sv2, DS, DH, smq, smk1, smk2,
                                    Lq, L1, L2, scale, dr, salt_h, P, dq1 + oq, dq2 + oq,
                                    dk1 + o1, dk2 + o2, dv1 + o1, dv2 + o2, (long)dm);
}

// The attention of K2 as its own kernel: one block per (head, batch row).
template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kK2Threads)
proj_two_block_fwd_kernel(const T* __restrict__ xq, const T* __restrict__ x1,
                          const T* __restrict__ x2, ProjWeights<T> w,
                          const int* __restrict__ mq, const int* __restrict__ mk1,
                          const int* __restrict__ mk2, T* __restrict__ out, int Lq, int L1,
                          int L2, int dm, float scale, float rate, float keep_div,
                          unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  proj_fwd_block<T, DH, kDrop>(xq, x1, x2, w, mq, mk1, mk2, out, Lq, L1, L2, dm, scale,
                               make_dropout(rate, keep_div, seed, b, gridDim.y), h, h, b);
}

template <typename T, int DH>
cudaError_t launch_proj_fwd(const void* const* p, const int* mq, const int* mk1, const int* mk2,
                            void* out, int B, int Lq, int L1, int L2, int dm, float scale,
                            float rate, float keep_div, unsigned seed, cudaStream_t stream) {
  const size_t smem = k2_smem_bytes(std::is_same<T, __nv_bfloat16>::value, Lq, L1, L2, DH);
  auto kernel = rate > 0.f ? proj_two_block_fwd_kernel<T, DH, true>
                           : proj_two_block_fwd_kernel<T, DH, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const T* const* a = reinterpret_cast<const T* const*>(p);
  kernel<<<dim3(dm / DH, B), kK2Threads, smem, stream>>>(
      a[0], a[1], a[2], proj_weights<T>(p + 3), mq, mk1, mk2, static_cast<T*>(out), Lq, L1,
      L2, dm, scale, rate, keep_div, seed);
  return cudaGetLastError();
}

// K2's attention launch for head dim DH: p = xq, x1, x2, then the twelve
// projection parameters.
template <typename T>
cudaError_t dispatch_proj_fwd(int DH, const void* const* p, const int* mq, const int* mk1,
                              const int* mk2, void* out, int B, int Lq, int L1, int L2, int dm,
                              float scale, float rate, float keep_div, unsigned seed,
                              cudaStream_t s) {
#define SEGMM_K2(DH_)                                                                   \
  launch_proj_fwd<T, DH_>(p, mq, mk1, mk2, out, B, Lq, L1, L2, dm, scale, rate, keep_div, \
                          seed, s)
  switch (DH) {
    case 16: return SEGMM_K2(16);
    case 32: return SEGMM_K2(32);
    case 64: return SEGMM_K2(64);
    default: return cudaErrorInvalidValue;
  }
#undef SEGMM_K2
}

// K2b's qkv pass as its own kernel: one block per (head, batch row).
template <typename T, typename TG, int DH, bool kDrop>
__global__ void __launch_bounds__(kK2Threads)
proj_two_block_qkv_bwd_kernel(const T* __restrict__ xq, const T* __restrict__ x1,
                              const T* __restrict__ x2, ProjWeights<T> w,
                              const int* __restrict__ mq, const int* __restrict__ mk1,
                              const int* __restrict__ mk2, const TG* __restrict__ g,
                              float* __restrict__ dq1, float* __restrict__ dq2,
                              float* __restrict__ dk1, float* __restrict__ dk2,
                              float* __restrict__ dv1, float* __restrict__ dv2, int Lq, int L1,
                              int L2, int dm, float scale, float rate, float keep_div,
                              unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  proj_qkv_bwd_block<T, TG, DH, kDrop>(xq, x1, x2, w, mq, mk1, mk2, g, dq1, dq2, dk1, dk2, dv1,
                                       dv2, Lq, L1, L2, dm, scale,
                                       make_dropout(rate, keep_div, seed, b, gridDim.y), h, h, b);
}

template <typename T, typename TG, int DH>
cudaError_t launch_qkv_bwd(const void* const* p, const int* mq, const int* mk1, const int* mk2,
                           const TG* g, float* const* o, int B, int Lq, int L1, int L2, int dm,
                           float scale, float rate, float keep_div, unsigned seed,
                           cudaStream_t stream) {
  const size_t smem = k2b_smem_bytes(std::is_same<T, __nv_bfloat16>::value, Lq, L1, L2, DH);
  auto kernel = rate > 0.f ? proj_two_block_qkv_bwd_kernel<T, TG, DH, true>
                           : proj_two_block_qkv_bwd_kernel<T, TG, DH, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const T* const* a = reinterpret_cast<const T* const*>(p);
  kernel<<<dim3(dm / DH, B), kK2Threads, smem, stream>>>(
      a[0], a[1], a[2], proj_weights<T>(p + 3), mq, mk1, mk2, g, o[0], o[1], o[2], o[3], o[4],
      o[5], Lq, L1, L2, dm, scale, rate, keep_div, seed);
  return cudaGetLastError();
}

// K2b's qkv pass for head dim DH; p as dispatch_proj_fwd, o: the six fp32
// outputs.
template <typename T, typename TG>
cudaError_t dispatch_qkv_bwd(int DH, const void* const* p, const int* mq, const int* mk1,
                             const int* mk2, const TG* g, float* const* o, int B, int Lq, int L1,
                             int L2, int dm, float scale, float rate, float keep_div,
                             unsigned seed, cudaStream_t s) {
#define SEGMM_QKV(DH_)                                                                        \
  launch_qkv_bwd<T, TG, DH_>(p, mq, mk1, mk2, g, o, B, Lq, L1, L2, dm, scale, rate, keep_div, \
                             seed, s)
  switch (DH) {
    case 16: return SEGMM_QKV(16);
    case 32: return SEGMM_QKV(32);
    case 64: return SEGMM_QKV(64);
    default: return cudaErrorInvalidValue;
  }
#undef SEGMM_QKV
}

}  // namespace segmm
