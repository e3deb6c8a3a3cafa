// Device code of K4's epilogue (layer_stream.cu, layer_stream_bwd.cu): the
// exact GELU of the TPU kernel, the epilogue's dropout masks and
// parameters (both bodies), and fp32 K4's row-tile products and
// fast-variance LayerNorm (bf16 K4's are layer_mma.cuh's).
//
// fp32: a block owns RT rows of the (B * Lq, d) stream and keeps them in
// shared memory across the epilogue's three Dense layers; the weights
// stream through shared memory in (128 output columns) x (32 deep) chunks:
//  * tile_gemm_tn: C (RT, N) = A (RT, K) . W^T, W (N, K) nn.Linear layout,
//    fp32 FMAs on the CUDA cores (no TF32). The forward's products
//    (layer_kernel.py _proj: fp32 dot, then the bias).
//  * tile_gemm_nn_f32: C (RT, N) = A (RT, K) . W, A fp32, W (K, N) widened
//    to fp32, fp32 FMAs. The backward's products dy . W (t_chain, :246-250),
//    whose dy is fp32 whatever the compute dtype.
// C lands in shared memory as fp32 with row stride ldc.
#pragma once

#include "projection.cuh"

namespace segmm {

constexpr int kEpThreads = 256;
constexpr int kEpWarps = kEpThreads / 32;
constexpr int kEpPanel = 128;     // output columns per pass
constexpr int kEpK = 32;          // depth of a staged weight chunk
constexpr int kEpFwdRows = 32;    // rows per block, forward
constexpr int kEpBwdRows = 16;    // rows per block, backward
// Wider layers keep fewer rows a block, so that a block's full rows of d
// and ff stay in shared memory: kEpFwdRows / kEpBwdRows where they fit
// (every width up to 512), else 8, else
// 2 (ep_fwd_rows / ep_bwd_rows). Each row's sums run in the same order
// whatever its block's rows.
constexpr int kEpNarrowRows = 8, kEpNarrowestRows = 2;
constexpr float kLnEps = 1e-12f;  // models/segformerx.py LN_EPS
constexpr int kEpSalt = 2;        // the epilogue's salts: 2H, 2H + 1, 2H + 2

// Row stride (elements) of a shared tile `w` wide: bf16 tiles a multiple of
// 8, fp32 tiles a multiple of 4 (float4); padded off the banks.
template <typename T> __host__ __device__ constexpr int tile_ld(int w) {
  return std::is_same<T, float>::value ? w + 4 : w + 8;
}

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Bytes of the weight-chunk stage of the products.
__host__ __device__ inline size_t ep_stage_bytes() {
  const size_t tn = sizeof(float) * kEpK * (kEpPanel + 1);  // transposed
  const size_t nn = sizeof(float) * kEpK * (kEpPanel + 4);  // as is
  return tn > nn ? tn : nn;
}

// the ten epilogue parameters: w_ff, b_ff, ln1_s, ln1_b, w_m1, b_m1, w_m2,
// b_m2, ln2_s, ln2_b (LayerNorm parameters fp32, the rest the compute dtype)
template <typename T>
struct EpParams {
  const T* wff;
  const T* bff;
  const float* ln1s;
  const float* ln1b;
  const T* wm1;
  const T* bm1;
  const T* wm2;
  const T* bm2;
  const float* ln2s;
  const float* ln2b;
};

template <typename T>
inline EpParams<T> ep_params(const void* const* p) {
  return EpParams<T>{static_cast<const T*>(p[0]),     static_cast<const T*>(p[1]),
                     static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
                     static_cast<const T*>(p[4]),     static_cast<const T*>(p[5]),
                     static_cast<const T*>(p[6]),     static_cast<const T*>(p[7]),
                     static_cast<const float*>(p[8]), static_cast<const float*>(p[9])};
}

// ---------------------------------------------------------------------------
// exact GELU: erf by the Abramowitz-Stegun 7.1.26 polynomial
// (layer_kernel.py:58-80)

__device__ __forceinline__ float erf_poly(float x) {
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.0f - poly * expf(-ax * ax);
  return x < 0.f ? -e : e;
}

__device__ __forceinline__ float gelu_f32(float x) {
  return 0.5f * x * (1.0f + erf_poly(x * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad_f32(float x) {
  const float cdf = 0.5f * (1.0f + erf_poly(x * 0.70710678118654752f));
  const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;
  return cdf + x * pdf;
}

// The epilogue's dropout keep-bit of (stream row `row` = b * Lq + q,
// feature c) for salt 2H + i: the attention mask's hash over (row within
// the batch tile, query row, feature), seed + tile (layer_kernel.py:115-132).
__device__ __forceinline__ bool ep_keep(float rate, unsigned seed, int row, int Lq, int B, int c,
                                        unsigned salt) {
  const Dropout dr = make_dropout(rate, 1.f, seed, row / Lq, B);
  return dropout_keep(dr, row % Lq, c, salt);
}

// ---------------------------------------------------------------------------
// products

// A's four values at a (16 bytes of fp32, or 8 of bf16 widened).
__device__ __forceinline__ float4 load4_f(const float* a) {
  return *reinterpret_cast<const float4*>(a);
}
__device__ __forceinline__ float4 load4_f(const __nv_bfloat16* a) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + 2));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Thread (column n of the panel, row group g) sums RT / 2 rows in fp32;
// the weight chunk is staged transposed ([k][n], stride 129: conflict-free
// stores and reads) as fp32, A's rows are read as four-value broadcasts.
// T: fp32 (fp32 K4) or bf16 (bf16 K4 past its tensor-core epilogue's
// widths: products of bf16 values, summed in fp32).
template <int RT, typename T = float>
__device__ void tile_gemm_tn(const T* sA, int lda, int K, const T* __restrict__ W, int N,
                             float* sC, int ldc, unsigned char* stage) {
  constexpr int G = kEpThreads / kEpPanel, RPT = RT / G, WS = kEpPanel + 1;
  float* sw = reinterpret_cast<float*>(stage);
  const int tid = threadIdx.x, n = tid % kEpPanel, g = tid / kEpPanel;
  for (int n0 = 0; n0 < N; n0 += kEpPanel) {
    const int pw = min(kEpPanel, N - n0);
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kEpK) {
      __syncthreads();
      for (int i = tid; i < pw * kEpK; i += kEpThreads) {
        const int nn = i / kEpK, k = i - nn * kEpK;
        sw[k * WS + nn] = to_f<T>(W[(long)(n0 + nn) * K + k0 + k]);
      }
      __syncthreads();
      if (n < pw) {
#pragma unroll 2
        for (int k = 0; k < kEpK; k += 4) {
          const float w0 = sw[k * WS + n], w1 = sw[(k + 1) * WS + n];
          const float w2 = sw[(k + 2) * WS + n], w3 = sw[(k + 3) * WS + n];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float4 a = load4_f(sA + (g + i * G) * lda + k0 + k);
            acc[i] = fmaf(a.x, w0, acc[i]);
            acc[i] = fmaf(a.y, w1, acc[i]);
            acc[i] = fmaf(a.z, w2, acc[i]);
            acc[i] = fmaf(a.w, w3, acc[i]);
          }
        }
      }
    }
    if (n < pw) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) sC[(g + i * G) * ldc + n0 + n] = acc[i];
    }
  }
  __syncthreads();
}

// fp32 A times W (K, N) of type TW, as is ([k][n] chunks, stride 132).
template <typename TW, int RT>
__device__ void tile_gemm_nn_f32(const float* sA, int lda, int K, const TW* __restrict__ W, int N,
                                 float* sC, int ldc, unsigned char* stage) {
  constexpr int G = kEpThreads / kEpPanel, RPT = RT / G, WS = kEpPanel + 4;
  float* sw = reinterpret_cast<float*>(stage);
  const int tid = threadIdx.x, n = tid % kEpPanel, g = tid / kEpPanel;
  for (int n0 = 0; n0 < N; n0 += kEpPanel) {
    const int pw = min(kEpPanel, N - n0);
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kEpK) {
      __syncthreads();
      for (int i = tid; i < pw * kEpK; i += kEpThreads) {
        const int k = i / pw, nn = i - k * pw;
        sw[k * WS + nn] = to_f<TW>(W[(long)(k0 + k) * N + n0 + nn]);
      }
      __syncthreads();
      if (n < pw) {
#pragma unroll 2
        for (int k = 0; k < kEpK; k += 4) {
          const float w0 = sw[k * WS + n], w1 = sw[(k + 1) * WS + n];
          const float w2 = sw[(k + 2) * WS + n], w3 = sw[(k + 3) * WS + n];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(sA + (g + i * G) * lda + k0 + k);
            acc[i] = fmaf(a.x, w0, acc[i]);
            acc[i] = fmaf(a.y, w1, acc[i]);
            acc[i] = fmaf(a.z, w2, acc[i]);
            acc[i] = fmaf(a.w, w3, acc[i]);
          }
        }
      }
    }
    if (n < pw) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) sC[(g + i * G) * ldc + n0 + n] = acc[i];
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// LayerNorm with the fast variance (layer_kernel.py:83-99), one warp per
// row: mean and inverse deviation of row r of `src` into mu[r], inv[r].
template <int RT>
__device__ void ln_stats(const float* src, int ld, int d, float* mu, float* inv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < RT; r += kEpWarps) {
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float x = src[r * ld + c];
      s += x;
      s2 = fmaf(x, x, s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float m = s / (float)d;
    const float var = s2 / (float)d - m * m;
    if (lane == 0) {
      mu[r] = m;
      inv[r] = 1.0f / sqrtf(var + kLnEps);
    }
  }
  __syncthreads();
}

}  // namespace segmm
