// K2: projection-fused two-block attention, forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _fp_fwd_kernel
// (:776), launched by _fp_call_fwd (:897) behind
// fused_proj_two_block_attention v1 (:1054), with its head loop
// _attn_group_fwd (:399). It is K1 with the six q/k/v projections computed
// inside the kernel:
//   q1 = xq.Wq1 + bq1, q2 = xq.Wq2 + bq2   (query source xq, (B, Lq, d))
//   k1 = x1.Wk1 + bk1, v1 = x1.Wv1 + bv1   (key block 1, (B, L1, d))
//   k2 = x2.Wk2 + bk2, v2 = x2.Wv2 + bv2   (key block 2, (B, L2, d))
// then the joint softmax core of joint_attention.cuh; out (B, Lq, d).
// Weights arrive in nn.Linear layout (out, in), biases (d,). Rounding as on
// the TPU (_proj, :769-773): the fp32 dot is cast to the input type and the
// bias is then added in that type.
//
// Design: one thread block (256 threads, 8 warps) per (head, batch row).
// For its head the block computes the DH columns of each projection, two
// projections that share a source at a time, walking d in tiles staged in
// shared memory (projection.cuh: wmma tensor cores in bf16, CUDA cores in
// fp32). The projected tiles stay in shared memory as fp32 for the
// attention core; q, k and v never reach device memory. In training the
// core applies the dropout mask of joint_attention.cuh.
//
// What bounds it on an H100: operations. Per (row, head) the projections
// are 2*(2Lq + 2L1 + 2L2)*d*DH FLOP against ~(Lq + L1 + L2)*d input values,
// well above the card's bytes-to-FLOP balance, so the floor is the bf16
// tensor-core rate. This design is held back by what it re-reads instead:
// every head re-reads its batch row's x, and every batch row re-reads the
// head's weight slice, from L2 (about 6 GB of L2 reads per launch at
// B=1024, Lq=40, L1=40, L2=100), and the attention core runs as fp32 FMAs
// whose operands all come from shared memory. Several heads or batch rows
// per block, wgmma with TMA, and tensor-core logits and AV products are the
// ways past that.
#include "projection.cuh"

namespace segmm {

template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kK2Threads)
proj_two_block_fwd_kernel(const T* __restrict__ xq, const T* __restrict__ x1,
                          const T* __restrict__ x2,
                          const T* __restrict__ wq1, const T* __restrict__ bq1,
                          const T* __restrict__ wq2, const T* __restrict__ bq2,
                          const T* __restrict__ wk1, const T* __restrict__ bk1,
                          const T* __restrict__ wk2, const T* __restrict__ bk2,
                          const T* __restrict__ wv1, const T* __restrict__ bv1,
                          const T* __restrict__ wv2, const T* __restrict__ bv2,
                          const int* __restrict__ mq, const int* __restrict__ mk1,
                          const int* __restrict__ mk2, T* __restrict__ out,
                          int Lq, int L1, int L2, int dm, float scale, float rate,
                          float keep_div, unsigned seed) {
  constexpr int DS = tile_stride(DH);
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value;
  const int h = blockIdx.x, b = blockIdx.y;
  const int Lmax = max(Lq, max(L1, L2));
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stage = smem;  // first: wmma and float4 need aligned tiles
  float* sq1 = reinterpret_cast<float*>(smem + k2_stage_bytes(kTc, Lmax, DH));
  float* sq2 = sq1 + Lq * DS;
  float* sk1 = sq2 + Lq * DS;
  float* sv1 = sk1 + L1 * DS;
  float* sk2 = sv1 + L1 * DS;
  float* sv2 = sk2 + L2 * DS;
  int* smq = reinterpret_cast<int*>(sv2 + L2 * DS);
  int* smk1 = smq + Lq;
  int* smk2 = smk1 + L1;
  float* pbuf = reinterpret_cast<float*>(smq + pad4(Lq + L1 + L2));

  project_pair<T, DH>(xq + (long)b * Lq * dm, Lq, dm, wq1, bq1, wq2, bq2, h, stage, sq1, sq2);
  project_pair<T, DH>(x1 + (long)b * L1 * dm, L1, dm, wk1, bk1, wv1, bv1, h, stage, sk1, sv1);
  project_pair<T, DH>(x2 + (long)b * L2 * dm, L2, dm, wk2, bk2, wv2, bv2, h, stage, sk2, sv2);
  load_masks(mq, mk1, mk2, b, Lq, L1, L2, smq, smk1, smk2);
  __syncthreads();

  const Dropout dr = make_dropout(rate, keep_div, seed, b, gridDim.y);
  joint_attention_rows<T, kK2Rows, kDrop>(sq1, sq2, sk1, sk2, sv1, sv2, DS, DH, smq, smk1, smk2,
                          Lq, L1, L2, scale, dr, h, pbuf,
                          out + (long)b * Lq * dm + h * DH, (long)dm);
}

inline size_t k2_smem_bytes(bool tensor_cores, int Lq, int L1, int L2, int DH) {
  const int Lmax = Lq > L1 ? (Lq > L2 ? Lq : L2) : (L1 > L2 ? L1 : L2);
  return k2_stage_bytes(tensor_cores, Lmax, DH) +
         sizeof(float) * (size_t)(2 * Lq + 2 * L1 + 2 * L2) * tile_stride(DH) +
         core_extra_bytes(Lq, L1, L2, kK2Threads / 32, kK2Rows);
}

template <typename T, int DH>
cudaError_t launch_k2(const void* const* p, const int* mq, const int* mk1, const int* mk2,
                      void* out, int B, int Lq, int L1, int L2, int dm, float scale,
                      float rate, float keep_div, unsigned seed, cudaStream_t stream) {
  const size_t smem =
      k2_smem_bytes(std::is_same<T, __nv_bfloat16>::value, Lq, L1, L2, DH);
  auto kernel = rate > 0.f ? proj_two_block_fwd_kernel<T, DH, true>
                            : proj_two_block_fwd_kernel<T, DH, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const T* const* a = reinterpret_cast<const T* const*>(p);
  kernel<<<dim3(dm / DH, B), kK2Threads, smem, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], a[10], a[11], a[12],
      a[13], a[14], mq, mk1, mk2, static_cast<T*>(out), Lq, L1, L2, dm, scale, rate, keep_div,
      seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k2(int DH, const void* const* p, const int* mq, const int* mk1,
                        const int* mk2, void* out, int B, int Lq, int L1, int L2, int dm,
                        float scale, float rate, float keep_div, unsigned seed,
                        cudaStream_t s) {
#define SEGMM_K2(DH_) \
  launch_k2<T, DH_>(p, mq, mk1, mk2, out, B, Lq, L1, L2, dm, scale, rate, keep_div, seed, s)
  switch (DH) {
    case 16: return SEGMM_K2(16);
    case 32: return SEGMM_K2(32);
    case 64: return SEGMM_K2(64);
    default: return cudaErrorInvalidValue;
  }
#undef SEGMM_K2
}

}  // namespace segmm

// dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t segmm_proj_two_block_attention_smem_bytes(int dtype, int Lq, int L1, int L2,
                                                            int DH) {
  return segmm::k2_smem_bytes(dtype == 1, Lq, L1, L2, DH);
}

// ptrs: xq, x1, x2, wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2
// (device pointers, 16-byte aligned). dtype: 0 = float32, 1 = bfloat16.
// DH in {16, 32, 64}, d % 32 == 0, every length <= 128. rate > 0 applies
// the dropout mask of `seed` (keep_div = 1 - rate in fp32). Returns a
// cudaError_t (0 = launched).
extern "C" int segmm_proj_two_block_attention_fwd(
    int dtype, const void* const* ptrs, const int* mq, const int* mk1, const int* mk2,
    void* out, int B, int Lq, int L1, int L2, int dm, int H, float scale, float rate,
    float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DH = dm / H;
  if (dtype == 0)
    return (int)segmm::dispatch_k2<float>(DH, ptrs, mq, mk1, mk2, out, B, Lq, L1, L2, dm,
                                          scale, rate, keep_div, seed, s);
  if (dtype == 1)
    return (int)segmm::dispatch_k2<__nv_bfloat16>(DH, ptrs, mq, mk1, mk2, out, B, Lq, L1,
                                                  L2, dm, scale, rate, keep_div, seed, s);
  return (int)cudaErrorInvalidValue;
}
