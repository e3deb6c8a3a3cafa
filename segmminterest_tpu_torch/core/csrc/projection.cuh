// The fp32 projection stage of K2's fp32 route (segmm_project_pairs_f32,
// two_block_attention.cu): for head h of one batch row, the DH columns of
// two projections that share a source (q1/q2 from xq, k1/v1 from x1, k2/v2
// from x2), as segmminterest_tpu/core/attention.py _proj (:769-773)
// computes them: the fp32 dot, then the bias added (proj_epilogue: in bf16
// the dot is cast first, as the bf16 GEMMs of proj_gemm.cuh and
// layer_mma.cuh round it). On the CUDA cores, one column for up to
// 128/(256/DH) rows of both products per thread, so that the fp32 route
// keeps full fp32 products (no TF32). The projected tiles land in shared
// memory as fp32 with row stride `ost`.
#pragma once

#include <type_traits>

#include "joint_attention.cuh"
#include "mma_sync.cuh"  // cp_async16

namespace segmm {

constexpr int kK2Threads = 256;
constexpr int kK2MaxL = 128;  // longest stream one block projects
constexpr int kK2Chunk = 32;  // d-tile of the fp32 projections

// Shared-memory bytes of the projection stage: one buffer of x and weight
// tiles, reused by the projection pairs.
__host__ __device__ inline size_t k2_stage_bytes(int Lmax, int DH) {
  return sizeof(float) * ((size_t)Lmax * kK2Chunk + 2 * (size_t)kK2Chunk * (DH + 1));
}

template <typename T> __device__ __forceinline__ float proj_epilogue(float acc, float bias);
template <> __device__ __forceinline__ float proj_epilogue<float>(float acc, float bias) {
  return acc + bias;
}
template <> __device__ __forceinline__ float proj_epilogue<__nv_bfloat16>(float acc, float bias) {
  // bf16(bf16(dot) + bias): the dot is cast first, the add rounds again
  return round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(acc) + bias);
}

// fp32: outa = x.Wa^T + ba and outb = x.Wb^T + bb for head h, rows [0, L)
// (L <= kK2MaxL), into tiles of row stride ost, on the CUDA cores.
template <int DH>
__device__ void project_pair_f32(const float* __restrict__ x, int L, int dm,
                                 const float* __restrict__ wa, const float* __restrict__ ba,
                                 const float* __restrict__ wb, const float* __restrict__ bb,
                                 int h, float* stage, float* outa, float* outb, int ost) {
  constexpr int G = kK2Threads / DH;  // row groups (threads past G DH idle)
  constexpr int MAXR = (kK2MaxL + G - 1) / G;
  constexpr int KC = kK2Chunk;
  constexpr int WS = DH + 1;  // weight tile row stride (conflict-free stores)
  float* sx = stage;  // first, so the float4 reads are 16-byte aligned
  float* swa = sx + L * KC;
  float* swb = swa + KC * WS;
  const int tid = threadIdx.x;
  const int n = tid % DH, g = tid / DH;
  float acca[MAXR], accb[MAXR];
#pragma unroll
  for (int i = 0; i < MAXR; ++i) acca[i] = accb[i] = 0.f;

  for (int kc = 0; kc < dm; kc += KC) {
    __syncthreads();  // the previous tiles are consumed
    for (int i = tid; i < L * KC; i += kK2Threads) {
      const int r = i / KC, c = i - r * KC;
      sx[r * KC + c] = x[(long)r * dm + kc + c];
    }
    for (int i = tid; i < KC * DH; i += kK2Threads) {
      const int nn = i / KC, k = i - nn * KC;
      const long src = (long)(h * DH + nn) * dm + kc + k;
      swa[k * WS + nn] = wa[src];
      swb[k * WS + nn] = wb[src];
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < KC; k += 4) {
      const float wa0 = swa[k * WS + n], wa1 = swa[(k + 1) * WS + n];
      const float wa2 = swa[(k + 2) * WS + n], wa3 = swa[(k + 3) * WS + n];
      const float wb0 = swb[k * WS + n], wb1 = swb[(k + 1) * WS + n];
      const float wb2 = swb[(k + 2) * WS + n], wb3 = swb[(k + 3) * WS + n];
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int r = g + i * G;
        if (g < G && r < L) {
          const float4 xv = *reinterpret_cast<const float4*>(sx + r * KC + k);
          acca[i] = fmaf(xv.x, wa0, acca[i]);
          acca[i] = fmaf(xv.y, wa1, acca[i]);
          acca[i] = fmaf(xv.z, wa2, acca[i]);
          acca[i] = fmaf(xv.w, wa3, acca[i]);
          accb[i] = fmaf(xv.x, wb0, accb[i]);
          accb[i] = fmaf(xv.y, wb1, accb[i]);
          accb[i] = fmaf(xv.z, wb2, accb[i]);
          accb[i] = fmaf(xv.w, wb3, accb[i]);
        }
      }
    }
  }
  const float bias_a = ba[h * DH + n];
  const float bias_b = bb[h * DH + n];
#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    const int r = g + i * G;
    if (g < G && r < L) {
      outa[r * ost + n] = proj_epilogue<float>(acca[i], bias_a);
      outb[r * ost + n] = proj_epilogue<float>(accb[i], bias_b);
    }
  }
}

}  // namespace segmm
