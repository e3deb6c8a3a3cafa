// The fp32 3xTF32 attention core (tf32_attention.cuh) over key chunks and
// query windows, both directions: every shape its one-chunk bodies do not
// take (a key axis past their register tile, a stream past 128 in the
// backward or in K3, no query window within one block's shared memory),
// so that fp32 K1, K3 and the fp32 routes of K2, K4, K5 and K6 have a
// kernel at every length, as the JAX kernels (attention.py _fwd2_kernel
// :527 / _bwd2_kernel :558, _fwd_kernel :126 / _bwd_kernel :156), which
// take whole arrays as blocks, do. The function is the core's; the sums
// run in another order.
//
// Numerics as the core's: every product on the TF32 tensor cores in
// 3xTF32, p and dl in fp32.
//
// Forward, grid (H, B, windows): a block stages q of each key block over
// its window of kTf32ChunkRows query rows (a warp per 16), then walks each
// block's keys in chunks of kTf32ChunkKeys (a chunk never spans two
// blocks): S = q_b k^T, fill, dropout (the block's salt, each key at its
// own index: within its block, or with K6's concat past L1) and scale as
// the core does, an online softmax (a running max and sum per row, the
// output accumulator rescaled), o += p v. out = o / sum.
//
// Backward, grid (H, B): one block walks the windows in order. Sweep 1
// over every block's chunks takes each row's max, sum and s = sum dp p
// with online rescaling (dp = g v^T). Sweep 2, block by block and chunk by
// chunk: p recomputed into an fp32 [query][key] buffer, dv = p^T g; dl =
// p (dp - s) scale, dropout, pair mask in p's place, dq_b = dl k summed in
// registers over the block's chunks; dk = dl^T q_b. The windows add their
// dk and dv into the outputs in window order (the first stores): no
// atomics, the same bits on every run.
//
// What bounds it on an H100: it is the long-stream path, held for
// correctness, not speed (PERF.md has its times).
#include "tf32_attention.cuh"

namespace segmm {

// The chunk's logit tile (rows q0 of the window, keys k0 .. k0 + nv of its
// block) -> masked, dropped and scaled logits as tf32_probs forms them
// (-inf past nv); keep: the dropout keep bits (bit 4 n + c); mx: each of
// the lane's two rows' max over the chunk (over the quad).
__device__ __forceinline__ void tf32c_fill(float (&s)[kTf32ChunkNT][4], unsigned& keep,
                                           const int* smq, const int* smk, int q0, int zq,
                                           int k0, int nv, int koff, unsigned salt, float scale,
                                           bool drop, Dropout dr, float (&mx)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mqr[2] = {smq[q0 + g], smq[q0 + g + 8]};
  const float inv_keep = 1.f / dr.keep_div;
  keep = 0u;
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < kTf32ChunkNT; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1, j = 8 * n + 2 * t + (c & 1);
      float l = -INFINITY;
      if (j < nv) {
        l = (mqr[r] * smk[j]) > 0 ? s[n][c] : kMaskFill;
        if (drop) {
          const bool kept = dropout_keep(dr, zq + q0 + g + 8 * r, k0 + j + koff, salt);
          keep |= (unsigned)kept << (4 * n + c);
          l = kept ? l * inv_keep : 0.f;
        }
        l *= scale;
      }
      s[n][c] = l;
      mx[r] = fmaxf(mx[r], l);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// A block's dropout salt and the key index its first key is hashed at, as
// tf32_stage_keys sets them.
__device__ __forceinline__ unsigned tf32c_salt(int NB, int i, int h, int salt_h0, int concat) {
  return NB == 1 || concat ? (unsigned)h : 2u * (salt_h0 + h) + i;
}

template <int NT>
__device__ __forceinline__ void tf32c_zero_tile(float (&s)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
}

// Rows r0 + g, r0 + g + 8 (those < L) and columns < D of a 16 x DP
// accumulator tile into dst + row * stride: stored, or added.
template <int DP>
__device__ __forceinline__ void tf32c_put_rows(const float (&acc)[DP / 8][4], int r0, int L,
                                               int D, float* dst, long stride, bool first) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= L) continue;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = 8 * dn + 2 * t;
      if (col >= D) continue;
      float2* p = reinterpret_cast<float2*>(dst + row * stride + col);
      float2 v = make_float2(acc[dn][2 * r], acc[dn][2 * r + 1]);
      if (!first) {
        const float2 w = *p;
        v.x = w.x + v.x;
        v.y = w.y + v.y;
      }
      *p = v;
    }
  }
}

__host__ __device__ inline size_t tf32_chunked_smem_bytes(int NB, int D, bool bwd) {
  const int LD = tf32_dp(D) + 4;
  size_t floats = (size_t)(NB + (bwd ? 1 : 0)) * kTf32ChunkRows * LD +
                  2 * (size_t)kTf32ChunkKeys * LD;
  if (bwd) floats += (size_t)kTf32ChunkRows * (kTf32ChunkKeys + 4);
  return sizeof(float) * floats + sizeof(int) * (kTf32ChunkRows + kTf32ChunkKeys);
}

// ---------------------------------------------------------------------------
// Forward

template <int DP, int NB>
__device__ __forceinline__ void tf32c_fwd(const Tf32FwdArgs<NB>& a) {
  constexpr int LD = DP + 4, NT = kTf32ChunkNT, WQ = kTf32ChunkRows, KC = kTf32ChunkKeys;
  const int h = blockIdx.x, b = blockIdx.y, zq = blockIdx.z * WQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = min(WQ, a.Lq - zq), D = a.D;
  extern __shared__ __align__(16) float tf32c_fsmem[];
  const float* sq[NB];
  float* at = tf32c_fsmem;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    tf32_stage<DP>(a.q[i], at, b, nq, WQ, a.H, h, D, zq, a.Lq);
    sq[i] = at;
    at += WQ * LD;
  }
  float* sk = at;
  float* sv = sk + KC * LD;
  int* smq = reinterpret_cast<int*>(sv + KC * LD);
  int* smk = smq + WQ;
  tf32_stage_mask(a.mq, smq, b, nq, WQ, zq, a.Lq);
  const Dropout dr = make_dropout(a.rate, a.keep_div, a.seed, b, gridDim.y);
  const bool drop = a.rate > 0.f;
  const int q0 = warp * 16;
  const bool live = q0 < nq;
  float o[DP / 8][4];
  tf32_zero<DP>(o);
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    const int L = a.L[i], koff = a.concat && i ? a.L[0] : 0;
    const unsigned salt = tf32c_salt(NB, i, h, a.salt_h0, a.concat);
    for (int k0 = 0; k0 < L; k0 += KC) {
      const int nv = min(KC, L - k0), ntc = (nv + 7) / 8;
      __syncthreads();  // the previous chunk is consumed
      tf32_stage<DP>(a.k[i], sk, b, nv, KC, a.H, h, D, k0, L);
      tf32_stage<DP>(a.v[i], sv, b, nv, KC, a.H, h, D, k0, L);
      tf32_stage_mask(a.mk[i], smk, b, nv, KC, k0, L);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (!live) continue;
      float s[NT][4];
      tf32c_zero_tile<NT>(s);
      tf32_rows_times_rowsT<DP, NT>(sq[i], q0, WQ, sk, 0, ntc, s);
      unsigned keep;
      float cm[2];
      tf32c_fill(s, keep, smq, smk, q0, zq, k0, nv, koff, salt, a.scale, drop, dr, cm);
      float ref[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(mx[r], cm[r]);
        ref[r] = mn == -INFINITY ? 0.f : mn;
        alpha[r] = mx[r] == -INFINITY ? 0.f : expf(mx[r] - ref[r]);
        mx[r] = mn;
        sum[r] *= alpha[r];
      }
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float e = expf(s[n][c] - ref[c >> 1]);
          s[n][c] = e;
          sum[c >> 1] += e;
        }
      tf32_regs_times_rows<DP, NT>(s, 0, ntc, sv, o);
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    const float inv = 1.f / sum[r];
    const int row = zq + q0 + g + 8 * r;
    if (row >= a.Lq) continue;
    float* dst = a.out + (((long)b * a.Lq + row) * a.H + h) * D;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = 8 * dn + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
    }
  }
}

// The kernels, named for the profiler's rows as the core's: K1f's, K3f's.
template <int DP>
__global__ void __launch_bounds__(32 * kTf32ChunkWarps)
two_block_fwd_chunked_tf32_kernel(const __grid_constant__ Tf32FwdArgs<2> a) {
  tf32c_fwd<DP, 2>(a);
}

template <int DP>
__global__ void __launch_bounds__(32 * kTf32ChunkWarps)
masked_fwd_chunked_tf32_kernel(const __grid_constant__ Tf32FwdArgs<1> a) {
  tf32c_fwd<DP, 1>(a);
}

template <int DP, int NB>
cudaError_t launch_tf32_chunked_fwd_dp(const Tf32FwdArgs<NB>& a, int B, cudaStream_t stream) {
  void (*kern)(Tf32FwdArgs<NB>);
  if constexpr (NB == 2)
    kern = two_block_fwd_chunked_tf32_kernel<DP>;
  else
    kern = masked_fwd_chunked_tf32_kernel<DP>;
  const size_t smem = tf32_chunked_smem_bytes(NB, a.D, false);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, B, (a.Lq + kTf32ChunkRows - 1) / kTf32ChunkRows);
  kern<<<grid, 32 * kTf32ChunkWarps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_tf32_chunked_fwd(const Tf32FwdArgs<NB>& a, int B, cudaStream_t s) {
  if (a.Lq < 1) return cudaErrorInvalidValue;
  switch (tf32_dp(a.D)) {
    case 16: return launch_tf32_chunked_fwd_dp<16, NB>(a, B, s);
    case 32: return launch_tf32_chunked_fwd_dp<32, NB>(a, B, s);
    case 64: return launch_tf32_chunked_fwd_dp<64, NB>(a, B, s);
    case 96: return launch_tf32_chunked_fwd_dp<96, NB>(a, B, s);
    case 128: return launch_tf32_chunked_fwd_dp<128, NB>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template cudaError_t launch_tf32_chunked_fwd<1>(const Tf32FwdArgs<1>&, int, cudaStream_t);
template cudaError_t launch_tf32_chunked_fwd<2>(const Tf32FwdArgs<2>&, int, cudaStream_t);

// ---------------------------------------------------------------------------
// Backward

template <int DP, int NB>
__device__ __forceinline__ void tf32c_bwd(const Tf32BwdArgs<NB>& a) {
  constexpr int LD = DP + 4, NT = kTf32ChunkNT, WQ = kTf32ChunkRows, KC = kTf32ChunkKeys;
  constexpr int ldp = KC + 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int D = a.D, Lq = a.Lq;
  const long stride = (long)a.H * D;
  extern __shared__ __align__(16) float tf32c_bsmem[];
  float* sq[NB];
  float* at = tf32c_bsmem;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    sq[i] = at;
    at += WQ * LD;
  }
  float* sg = at;
  float* sk = sg + WQ * LD;
  float* sv = sk + KC * LD;
  float* P = sv + KC * LD;
  int* smq = reinterpret_cast<int*>(P + WQ * ldp);
  int* smk = smq + WQ;
  const Dropout dr = make_dropout(a.rate, a.keep_div, a.seed, b, gridDim.y);
  const bool drop = a.rate > 0.f;
  const float inv_keep = 1.f / dr.keep_div;
  const int q0 = warp * 16;

  for (int zq = 0; zq < Lq; zq += WQ) {
    const int nq = min(WQ, Lq - zq), nq8 = (nq + 7) / 8;
    const bool live = q0 < nq, first = zq == 0;
    __syncthreads();  // the previous window is consumed
#pragma unroll
    for (int i = 0; i < NB; ++i) tf32_stage<DP>(a.q[i], sq[i], b, nq, WQ, a.H, h, D, zq, Lq);
    tf32_stage<DP>(a.g, sg, b, nq, WQ, a.H, h, D, zq, Lq);
    tf32_stage_mask(a.mq, smq, b, nq, WQ, zq, Lq);

    // sweep 1: each row's max, sum and sum of dp p over every key
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, sdp[2] = {0.f, 0.f};
#pragma unroll 1
    for (int i = 0; i < NB; ++i) {
      const int L = a.L[i], koff = a.concat && i ? a.L[0] : 0;
      const unsigned salt = tf32c_salt(NB, i, h, a.salt_h0, a.concat);
      for (int k0 = 0; k0 < L; k0 += KC) {
        const int nv = min(KC, L - k0), ntc = (nv + 7) / 8;
        __syncthreads();
        tf32_stage<DP>(a.k[i], sk, b, nv, KC, a.H, h, D, k0, L);
        tf32_stage<DP>(a.v[i], sv, b, nv, KC, a.H, h, D, k0, L);
        tf32_stage_mask(a.mk[i], smk, b, nv, KC, k0, L);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (!live) continue;
        float s[NT][4], dp[NT][4];
        tf32c_zero_tile<NT>(s);
        tf32c_zero_tile<NT>(dp);
        tf32_rows_times_rowsT<DP, NT>(sq[i], q0, WQ, sk, 0, ntc, s);
        unsigned keep;
        float cm[2];
        tf32c_fill(s, keep, smq, smk, q0, zq, k0, nv, koff, salt, a.scale, drop, dr, cm);
        tf32_rows_times_rowsT<DP, NT>(sg, q0, WQ, sv, 0, ntc, dp);
        float ref[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(mx[r], cm[r]);
          ref[r] = mn == -INFINITY ? 0.f : mn;
          const float alpha = mx[r] == -INFINITY ? 0.f : expf(mx[r] - ref[r]);
          mx[r] = mn;
          sum[r] *= alpha;
          sdp[r] *= alpha;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float e = expf(s[n][c] - ref[c >> 1]);
            sum[c >> 1] += e;
            sdp[c >> 1] = fmaf(dp[n][c], e, sdp[c >> 1]);
          }
      }
    }
    float inv[2], srow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      sdp[r] += __shfl_xor_sync(0xffffffffu, sdp[r], 1);
      sdp[r] += __shfl_xor_sync(0xffffffffu, sdp[r], 2);
      inv[r] = 1.f / sum[r];
      srow[r] = sdp[r] * inv[r];
      if (mx[r] == -INFINITY) mx[r] = 0.f;
    }

    // sweep 2, block by block: p, dv, dl, dq (in registers), dk
#pragma unroll 1
    for (int i = 0; i < NB; ++i) {
      const int L = a.L[i], koff = a.concat && i ? a.L[0] : 0;
      const unsigned salt = tf32c_salt(NB, i, h, a.salt_h0, a.concat);
      float dq[DP / 8][4];
      tf32_zero<DP>(dq);
      for (int k0 = 0; k0 < L; k0 += KC) {
        const int nv = min(KC, L - k0), ntc = (nv + 7) / 8;
        __syncthreads();
        tf32_stage<DP>(a.k[i], sk, b, nv, KC, a.H, h, D, k0, L);
        tf32_stage<DP>(a.v[i], sv, b, nv, KC, a.H, h, D, k0, L);
        tf32_stage_mask(a.mk[i], smk, b, nv, KC, k0, L);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        unsigned keep = 0u;
        if (live) {
          float p[NT][4];
          tf32c_zero_tile<NT>(p);
          tf32_rows_times_rowsT<DP, NT>(sq[i], q0, WQ, sk, 0, ntc, p);
          float cm[2];
          tf32c_fill(p, keep, smq, smk, q0, zq, k0, nv, koff, salt, a.scale, drop, dr, cm);
          const bool rl[2] = {zq + q0 + g < Lq, zq + q0 + g + 8 < Lq};
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int r = c >> 1;
              p[n][c] = rl[r] ? expf(p[n][c] - mx[r]) * inv[r] : 0.f;
            }
          tf32_store_tile<NT>(p, NT, q0, WQ, P, ldp);
        }
        __syncthreads();
        // dv = p^T g over the window's rows, a warp per 16 keys
        for (int kk = warp * 16; kk < nv; kk += nwarps * 16) {
          float acc[DP / 8][4];
          tf32_zero<DP>(acc);
          tf32_colsT_times_rows<DP>(P, ldp, 0, kk, nv, nq8, sg, acc);
          tf32c_put_rows<DP>(acc, kk, nv, D, a.dv[i] + (((long)b * L + k0) * a.H + h) * D,
                             stride, first);
        }
        __syncthreads();
        if (live) {
          float dp[NT][4];
          tf32c_zero_tile<NT>(dp);
          tf32_rows_times_rowsT<DP, NT>(sg, q0, WQ, sv, 0, ntc, dp);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = q0 + g + 8 * r;
              const float2 pv =
                  *reinterpret_cast<const float2*>(P + row * ldp + 8 * n + 2 * t);
              const float pr[2] = {pv.x, pv.y};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = 2 * r + e, j = 8 * n + 2 * t + e;
                float dl = 0.f;
                if (zq + row < Lq && j < nv) {
                  dl = pr[e] * (dp[n][c] - srow[r]) * a.scale;
                  if (drop) dl = (keep >> (4 * n + c)) & 1u ? dl * inv_keep : 0.f;
                  dl = (smq[row] * smk[j]) > 0 ? dl : 0.f;
                }
                dp[n][c] = dl;
              }
            }
          }
          __syncwarp();  // every lane has read its p before any overwrites it
          tf32_store_tile<NT>(dp, NT, q0, WQ, P, ldp);
          tf32_regs_times_rows<DP, NT>(dp, 0, ntc, sk, dq);
        }
        __syncthreads();
        // dk = dl^T q_i
        for (int kk = warp * 16; kk < nv; kk += nwarps * 16) {
          float acc[DP / 8][4];
          tf32_zero<DP>(acc);
          tf32_colsT_times_rows<DP>(P, ldp, 0, kk, nv, nq8, sq[i], acc);
          tf32c_put_rows<DP>(acc, kk, nv, D, a.dk[i] + (((long)b * L + k0) * a.H + h) * D,
                             stride, first);
        }
      }
      if (live)
        tf32_write_rows<DP>(dq, q0, nq, D, a.dq[i] + (((long)b * Lq + zq) * a.H + h) * D,
                            stride);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(32 * kTf32ChunkWarps)
two_block_bwd_chunked_tf32_kernel(const __grid_constant__ Tf32BwdArgs<2> a) {
  tf32c_bwd<DP, 2>(a);
}

template <int DP>
__global__ void __launch_bounds__(32 * kTf32ChunkWarps)
masked_bwd_chunked_tf32_kernel(const __grid_constant__ Tf32BwdArgs<1> a) {
  tf32c_bwd<DP, 1>(a);
}

template <int DP, int NB>
cudaError_t launch_tf32_chunked_bwd_dp(const Tf32BwdArgs<NB>& a, int B, cudaStream_t stream) {
  void (*kern)(Tf32BwdArgs<NB>);
  if constexpr (NB == 2)
    kern = two_block_bwd_chunked_tf32_kernel<DP>;
  else
    kern = masked_bwd_chunked_tf32_kernel<DP>;
  const size_t smem = tf32_chunked_smem_bytes(NB, a.D, true);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.H, B), 32 * kTf32ChunkWarps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_tf32_chunked_bwd(const Tf32BwdArgs<NB>& a, int B, cudaStream_t s) {
  if (a.Lq < 1) return cudaErrorInvalidValue;
  switch (tf32_dp(a.D)) {
    case 16: return launch_tf32_chunked_bwd_dp<16, NB>(a, B, s);
    case 32: return launch_tf32_chunked_bwd_dp<32, NB>(a, B, s);
    case 64: return launch_tf32_chunked_bwd_dp<64, NB>(a, B, s);
    case 96: return launch_tf32_chunked_bwd_dp<96, NB>(a, B, s);
    case 128: return launch_tf32_chunked_bwd_dp<128, NB>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template cudaError_t launch_tf32_chunked_bwd<1>(const Tf32BwdArgs<1>&, int, cudaStream_t);
template cudaError_t launch_tf32_chunked_bwd<2>(const Tf32BwdArgs<2>&, int, cudaStream_t);

}  // namespace segmm
