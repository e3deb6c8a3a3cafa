// Projection stage of the projection-fused kernels (K2 forward and
// backward): for head h of one batch row, the DH columns of two projections
// that share a source (q1/q2 from xq, k1/v1 from x1, k2/v2 from x2), as
// segmminterest_tpu/core/attention.py _proj (:769-773) computes them: the
// fp32 dot cast to the input type, then the bias added in that type.
//  * bf16: tensor cores through nvcuda::wmma 16x16x16 tiles with fp32
//    accumulators; the x rows are padded to a multiple of 16 with zeros,
//    each warp owns up to four 16x16 output tiles of [a | b], d-tiles arrive
//    by cp.async into two buffers (one loading while the other is
//    multiplied), and the accumulators go through shared memory once for
//    the rounding epilogue.
//  * fp32: CUDA cores, one column for up to 128/(256/DH) rows of both
//    products per thread, so that the fp32 route keeps full fp32 products
//    (no TF32).
// The projected tiles land in shared memory as fp32 with row stride
// tile_stride(DH), or `ost` where the caller gives one (K6 lays q1 and q2
// of a head side by side in one row of 2 DH).
#pragma once

#include <mma.h>

#include <type_traits>

#include "joint_attention.cuh"

namespace segmm {

constexpr int kK2Threads = 256;
constexpr int kK2Warps = kK2Threads / 32;
constexpr int kK2MaxL = 128;  // longest stream one block projects
// query rows per warp in the attention core: two halve its key and value
// reads, and two blocks per SM still fit
constexpr int kK2Rows = 2;
constexpr int kK2Chunk = 32;  // d-tile of the fp32 (CUDA-core) projections
// d-tile of the bf16 (tensor-core) projections: two buffers of it keep the
// largest launch (Lq=100, L1=40, L2=100) under 114 KB, two blocks per SM
constexpr int kTcK = 32;
// bf16 row stride of the staged x / W tiles: a multiple of 8 as wmma needs,
// padded so that neighbouring rows start in other banks
constexpr int kTcLd = kTcK + 8;

__host__ __device__ inline int round_up16(int x) { return (x + 15) & ~15; }

// Shared-memory bytes of the projection stage (the bf16 path's two buffers
// of x and weight tiles, then its fp32 accumulator tile; the fp32 path's one
// buffer), reused by the three projection pairs.
__host__ __device__ inline size_t k2_stage_bytes(bool tensor_cores, int Lmax, int DH) {
  if (tensor_cores) {
    const size_t mp = round_up16(Lmax);
    const size_t tiles = 2 * sizeof(__nv_bfloat16) * (mp + 2 * DH) * kTcLd;
    const size_t acc = sizeof(float) * mp * (2 * DH + 4);
    return tiles > acc ? tiles : acc;
  }
  return sizeof(float) * ((size_t)Lmax * kK2Chunk + 2 * (size_t)kK2Chunk * (DH + 1));
}

// 16-byte asynchronous copy global -> shared (sm_80+); fills zeros when
// `valid` is false, reading nothing from `src`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T> __device__ __forceinline__ float proj_epilogue(float acc, float bias);
template <> __device__ __forceinline__ float proj_epilogue<float>(float acc, float bias) {
  return acc + bias;
}
template <> __device__ __forceinline__ float proj_epilogue<__nv_bfloat16>(float acc, float bias) {
  // bf16(bf16(dot) + bias): the dot is cast first, the add rounds again
  return round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(acc) + bias);
}

// fp32: outa = x.Wa^T + ba and outb = x.Wb^T + bb for head h, rows [0, L),
// into shared tiles of row stride tile_stride(DH), on the CUDA cores.
template <int DH>
__device__ void project_pair_f32(const float* __restrict__ x, int L, int dm,
                                 const float* __restrict__ wa, const float* __restrict__ ba,
                                 const float* __restrict__ wb, const float* __restrict__ bb,
                                 int h, float* stage, float* outa, float* outb, int ost) {
  constexpr int G = kK2Threads / DH;  // row groups
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
        if (r < L) {
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
    if (r < L) {
      outa[r * ost + n] = proj_epilogue<float>(acca[i], bias_a);
      outb[r * ost + n] = proj_epilogue<float>(accb[i], bias_b);
    }
  }
}

// bf16: the same pair of projections on the tensor cores. The output tile
// [a | b] is (MP x 2DH) with MP = L rounded up to 16; 16x16 tile t belongs
// to warp t % 8. The d-tiles are copied with cp.async into two buffers, so
// that tile k+1 is in flight while tile k is multiplied. Every global read
// is 16 bytes (d % 8 == 0 and 16-byte aligned rows are checked by the
// wrapper).
template <int DH>
__device__ void project_pair_tc(const __nv_bfloat16* __restrict__ x, int L, int dm,
                                const __nv_bfloat16* __restrict__ wa,
                                const __nv_bfloat16* __restrict__ ba,
                                const __nv_bfloat16* __restrict__ wb,
                                const __nv_bfloat16* __restrict__ bb, int h,
                                unsigned char* stage, float* outa, float* outb, int ost) {
  using namespace nvcuda;
  constexpr int NT = 2 * DH / 16;  // 16-column tiles of [a | b]
  constexpr int MAXT = (kK2MaxL / 16 * NT + kK2Warps - 1) / kK2Warps;
  constexpr int LDA = 2 * DH + 4;  // fp32 row stride of the accumulator tile
  constexpr int VEC = 8;           // bf16 values per 16-byte copy
  constexpr int VPR = kTcK / VEC;  // copies per staged row
  const int MP = round_up16(L);
  const int T = (MP / 16) * NT;
  const int rows = MP + 2 * DH;  // staged rows: x's, then Wa's and Wb's head rows
  const int tid = threadIdx.x, warp = tid >> 5;
  __nv_bfloat16* buf[2] = {reinterpret_cast<__nv_bfloat16*>(stage),
                           reinterpret_cast<__nv_bfloat16*>(stage) + rows * kTcLd};
  float* sacc = reinterpret_cast<float*>(stage);  // [MP][LDA], after the d loop

  // copy d-tile [kc, kc + kTcK) of x (rows < L, zeros below) and of the two
  // weight slices into dst
  auto issue = [&](__nv_bfloat16* dst, int kc) {
    for (int i = tid; i < rows * VPR; i += kK2Threads) {
      const int r = i / VPR, c = (i - r * VPR) * VEC;
      const __nv_bfloat16* src;
      bool valid = kc + c < dm;
      if (r < MP) {
        valid = valid && r < L;
        src = x + (long)r * dm;
      } else {
        const int n = r - MP;
        src = n < DH ? wa + (long)(h * DH + n) * dm : wb + (long)(h * DH + n - DH) * dm;
      }
      cp_async16(dst + r * kTcLd + c, valid ? src + kc + c : x, valid);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXT];
#pragma unroll
  for (int i = 0; i < MAXT; ++i) wmma::fill_fragment(acc[i], 0.f);

  __syncthreads();  // the stage region is free (the last epilogue has read it)
  issue(buf[0], 0);
  for (int kc = 0, it = 0; kc < dm; kc += kTcK, ++it) {
    if (kc + kTcK < dm) {
      issue(buf[(it + 1) & 1], kc + kTcK);
      cp_async_wait<1>();  // tile `it` has landed; tile it+1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sx = buf[it & 1];
    const __nv_bfloat16* sw = sx + MP * kTcLd;
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 16) {
#pragma unroll
      for (int i = 0; i < MAXT; ++i) {
        const int t = warp + i * kK2Warps;
        if (t < T) {
          const int mt = t / NT, nt = t - mt * NT;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(af, sx + mt * 16 * kTcLd + kk, kTcLd);
          // W is (out, in) row-major, so W^T (k x n) is column-major
          wmma::load_matrix_sync(bf, sw + nt * 16 * kTcLd + kk, kTcLd);
          wmma::mma_sync(acc[i], af, bf, acc[i]);
        }
      }
    }
    __syncthreads();  // buffer it & 1 is consumed before it is refilled
  }
#pragma unroll
  for (int i = 0; i < MAXT; ++i) {
    const int t = warp + i * kK2Warps;
    if (t < T) {
      const int mt = t / NT, nt = t - mt * NT;
      wmma::store_matrix_sync(sacc + mt * 16 * LDA + nt * 16, acc[i], LDA,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = tid; i < L * 2 * DH; i += kK2Threads) {
    const int r = i / (2 * DH), c = i - r * (2 * DH);
    const float v = sacc[r * LDA + c];
    if (c < DH)
      outa[r * ost + c] = proj_epilogue<__nv_bfloat16>(v, to_f(ba[h * DH + c]));
    else
      outb[r * ost + c - DH] = proj_epilogue<__nv_bfloat16>(v, to_f(bb[h * DH + c - DH]));
  }
}

template <typename T, int DH>
__device__ __forceinline__ void project_pair(const T* x, int L, int dm, const T* wa,
                                             const T* ba, const T* wb, const T* bb, int h,
                                             unsigned char* stage, float* outa, float* outb,
                                             int ost = tile_stride(DH)) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    project_pair_tc<DH>(x, L, dm, wa, ba, wb, bb, h, stage, outa, outb, ost);
  else
    project_pair_f32<DH>(x, L, dm, wa, ba, wb, bb, h, reinterpret_cast<float*>(stage), outa,
                         outb, ost);
}

}  // namespace segmm
