// K2f's projection stage alone, as the per-(head, batch row) bf16 body of
// proj_attention.cuh runs it: one block per (head, batch row) computes its
// head's columns of the six projections (projection.cuh: wmma 16x16x16, x
// and the head's weight rows staged by cp.async from L2) into shared
// memory, then skips the attention core. Built by kernels_ab.py against a
// checkout's core/csrc, which times it beside the whole kernel; not part of
// the port.
#include "proj_attention.cuh"

namespace {

template <int DH>
__global__ void __launch_bounds__(segmm::kK2Threads)
k2_proj_stage_kernel(const __nv_bfloat16* __restrict__ xq, const __nv_bfloat16* __restrict__ x1,
                     const __nv_bfloat16* __restrict__ x2,
                     segmm::ProjWeights<__nv_bfloat16> w, float* __restrict__ sink, int Lq,
                     int L1, int L2, int dm) {
  using namespace segmm;
  constexpr int DS = tile_stride(DH);
  const int h = blockIdx.x, b = blockIdx.y;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stage = smem;
  float* sq1 = reinterpret_cast<float*>(smem + k2_stage_bytes(true, max3(Lq, L1, L2), DH));
  float* sq2 = sq1 + Lq * DS;
  float* sk1 = sq2 + Lq * DS;
  float* sv1 = sk1 + L1 * DS;
  float* sk2 = sv1 + L1 * DS;
  float* sv2 = sk2 + L2 * DS;
  const __nv_bfloat16* const* p = w.p;
  project_pair<__nv_bfloat16, DH>(xq + (long)b * Lq * dm, Lq, dm, p[0], p[1], p[2], p[3], h,
                                  stage, sq1, sq2);
  project_pair<__nv_bfloat16, DH>(x1 + (long)b * L1 * dm, L1, dm, p[4], p[5], p[8], p[9], h,
                                  stage, sk1, sv1);
  project_pair<__nv_bfloat16, DH>(x2 + (long)b * L2 * dm, L2, dm, p[6], p[7], p[10], p[11], h,
                                  stage, sk2, sv2);
  __syncthreads();
  // one value a block keeps the stage from being optimised away
  if (threadIdx.x == 0)
    sink[(long)b * gridDim.x + h] = sq1[0] + sq2[0] + sk1[0] + sv1[0] + sk2[0] + sv2[0];
}

}  // namespace

// ptrs: xq, x1, x2, then the twelve projection parameters (bf16); sink: B * H
// floats. DH = 32 only. Returns a cudaError_t.
extern "C" int k2_proj_stage(const void* const* ptrs, float* sink, int B, int Lq, int L1, int L2,
                             int dm, int H, void* stream) {
  using namespace segmm;
  if (dm / H != 32) return (int)cudaErrorInvalidValue;
  const size_t smem = k2_stage_bytes(true, max3(Lq, L1, L2), 32) +
                      sizeof(float) * (size_t)(2 * Lq + 2 * L1 + 2 * L2) * tile_stride(32);
  cudaError_t err = cudaFuncSetAttribute(k2_proj_stage_kernel<32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const bf* const* a = reinterpret_cast<const bf* const*>(ptrs);
  k2_proj_stage_kernel<32><<<dim3(H, B), kK2Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a[0], a[1], a[2], proj_weights<bf>(ptrs + 3), sink, Lq, L1, L2, dm);
  return (int)cudaGetLastError();
}
