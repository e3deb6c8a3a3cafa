// Shared device code of the attention kernels: type conversion, warp
// reductions and the dropout mask (the interpret-mode hash of the JAX
// package's attention kernels), with the -10000 fill of a masked logit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace segmm {

constexpr float kMaskFill = -10000.0f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded to T's precision, returned as float
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Dropout on the attention logits: the interpret-mode hash of the JAX
// package (attention.py:114-123), so that the kernels draw the bits the JAX
// kernels draw under interpret=True. Iota axes: row within the batch tile
// (8 rows when B % 8 == 0, else all B), query row, key column within the
// block; seed = caller's seed + batch tile index; salt = 2h (block 1) or
// 2h + 1 (block 2); uint32 arithmetic with wrap-around.
struct Dropout {
  float rate;      // > 0
  float keep_div;  // 1 - rate, formed in double and rounded once to fp32 by the caller
  unsigned seed;   // caller's seed + batch tile index
  unsigned row;    // row within the batch tile
};

__device__ __forceinline__ Dropout make_dropout(float rate, float keep_div, unsigned seed, int b,
                                                int B) {
  const int bt = (B % 8 == 0) ? 8 : B;
  return Dropout{rate, keep_div, seed + (unsigned)(b / bt), (unsigned)(b % bt)};
}

__device__ __forceinline__ bool dropout_keep(Dropout dr, int i, int j, unsigned salt) {
  unsigned h = ((dr.row * 2654435761u) ^ ((unsigned)i * 40503u) ^ ((unsigned)j * 69069u)) +
               dr.seed * 2246822519u + salt * 3266489917u;
  h = (h ^ (h >> 15)) * 2246822519u;
  h = h ^ (h >> 13);
  const float u = (float)(h >> 8) * (1.0f / 16777216.0f);
  return u >= dr.rate;
}

}  // namespace segmm
