// K3b: single-block masked attention, backward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _bwd_kernel
// (:156), launched by _call_bwd (:249, pallas_call :281) from the custom VJP
// of fused_masked_attention (:297-321). Nothing of the forward is saved: the
// kernel recomputes the probabilities in fp32 from q, k and the masks (and
// the dropout mask from the seed, salt h), then
//   dv = p^T g,  dp = g v^T,  dl = p (dp - sum dp p) scale, dropout mask and
//   divisor, pair mask,  dq = dl k,  dk = dl^T q,
// all accumulated in fp32, and writes dq, dk, dv in the input dtype. Inputs
// (B, L, H, D) contiguous, fp32 or bf16, Dqk = Dv = D; masks int32 (B, L);
// g (B, Lq, H, D).
//
// What bounds it on an H100: device memory. It reads q, k, v and g once and
// writes dq, dk and dv (0.55 GB in bf16 at B=1024, (40, 100), 16 heads of
// 32: 0.163 ms at 3.35 TB/s) against ~10 Lq Lk D FLOP per (row, head).
//
// bf16 (masked_bwd_mma_kernel): every product on the tensor cores.
//   * One block per (head, batch row), up to four warps; q, g, k, v and the
//     masks are staged by cp.async, q, g, k and v as bf16 tiles (72 KB with
//     the p and dl halves at (40, 100), D=32: three blocks per SM). Two
//     stages over four batch rows a block, so that the next row loads while
//     this one is computed, measured slower (k3_ab.py, H100 80GB HBM3 at
//     700 W, B=1024: 0.85 against 0.67 ms at (40, 100)): the second stage
//     costs the third block per SM.
//   * Numerics. q.k^T and dp = g v^T take the bf16 inputs as they are: one
//     bf16 mma.sync each, fp32 accumulators. The JAX kernel multiplies the
//     unrounded fp32 p and dl (attention.py:185-203); rounding them once to
//     bf16 would move each term by up to 2^-9. So each is split into
//     hi = bf16(x) and lo = bf16(x - hi), and both halves go through the
//     tensor cores into the same fp32 accumulator: x to about 2^-17
//     relative, below the outputs' own bf16 rounding (the test of the split
//     in tests/test_torch_masked_attention.py holds it to 1e-4 of the fp32
//     backward).
//   * Pass 1, warps over 16-row query tiles: S and p in fp32 registers (as
//     the forward); p's halves go to shared memory, and p is read back as
//     hi + lo from there on, so that p and dp are never both held in
//     registers; dp = g v^T, sum dp p by quad shuffles, dl in registers
//     (dropout from the keep bits the softmax drew, divisor, pair mask),
//     dl's halves to shared memory, dq = dl k with dl's halves straight from
//     registers as A fragments. The four bf16 [query][key] tiles take 43 KB
//     at (40, 100).
//   * Pass 2, after a block barrier, warps over 16-row key tiles:
//     dv = p^T g and dk = dl^T q, the A fragments by ldmatrix.trans of the
//     p and dl tiles.
//   * Each block owns its (b, h) gradients: no atomics, and the order of
//     every sum is fixed from run to run.
//   Registers: dp of a 16-row tile, 4 NT floats a thread (64 at Lk > 64);
//   ptxas's report (chip_smoke.py, phase build) shows any spill.
//
// fp32 (masked_bwd_kernel) keeps its CUDA-core body: K1b's with one key block, the
// whole P in shared memory and fp32 FMAs with operands in shared memory.
// TF32 would change its numbers; its gap to SDPA's backward (1.16x) is left
// to a later change.
#include "joint_attention.cuh"
#include "masked_attention_mma.cuh"

namespace segmm {

constexpr int kK3bThreads = 256;

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kK3bThreads)
masked_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ mq, const int* __restrict__ mk,
                  const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
                  T* __restrict__ dv, int Lq, int Lk, int H, int D, float scale, float rate,
                  float keep_div, unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int ds = tile_stride(D);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sg = sq + Lq * ds;
  float* sk = sg + Lq * ds;
  float* sv = sk + Lk * ds;
  int* smq = reinterpret_cast<int*>(sv + Lk * ds);
  int* smk = smq + Lq;
  float* P = reinterpret_cast<float*>(smq + pad4(Lq + Lk));

  load_head_rows<T>(q, sq, b, Lq, H, h, D, ds);
  load_head_rows<T>(g, sg, b, Lq, H, h, D, ds);
  load_head_rows<T>(k, sk, b, Lk, H, h, D, ds);
  load_head_rows<T>(v, sv, b, Lk, H, h, D, ds);
  for (int i = threadIdx.x; i < Lq; i += blockDim.x) smq[i] = mq[(long)b * Lq + i];
  for (int i = threadIdx.x; i < Lk; i += blockDim.x) smk[i] = mk[(long)b * Lk + i];
  __syncthreads();

  const Dropout dr = make_dropout(rate, keep_div, seed, b, gridDim.y);
  const unsigned salt = (unsigned)h;
  const int lds = pad4(Lk);

  // 1. probabilities in fp32 (not rounded), one warp per query row
  for (int i = warp; i < Lq; i += nwarps) {
    float* pr = P + (size_t)i * lds;
    const int qi[1] = {i}, mqi[1] = {smq[i]};
    float mx[1] = {-INFINITY};
    block_logits<1, kDrop>(sq, sk, ds, D, smk, Lk, qi, mqi, scale, dr, salt, pr, lds, mx);
    const float m = warp_max(mx[0]);
    float acc = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      acc += e;
    }
    const float s = warp_sum(acc);
    for (int j = lane; j < Lk; j += 32) pr[j] = pr[j] / s;
  }
  __syncthreads();

  const long stride = (long)H * D;
  const long oq = ((long)b * Lq * H + h) * D;
  const long ok = ((long)b * Lk * H + h) * D;
  // 2. dv = p^T g
  rows_times_tile<T>(P, 1, lds, Lq, sg, ds, D, Lk, dv + ok, stride);
  __syncthreads();

  // 3. dl in place of p, one warp per query row; dp stays in registers
  for (int i = warp; i < Lq; i += nwarps) {
    float* pr = P + (size_t)i * lds;
    const float* gi = sg + i * ds;
    const int mqi = smq[i];
    float dp[kBwdSlots];
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < kBwdSlots; ++t) {
      const int j = lane + 32 * t;
      dp[t] = j < Lk ? dot_rows(gi, sv + j * ds, D) : 0.f;
      if (j < Lk) part = fmaf(dp[t], pr[j], part);
    }
    const float s = warp_sum(part);
#pragma unroll
    for (int t = 0; t < kBwdSlots; ++t) {
      const int j = lane + 32 * t;
      if (j < Lk) {
        float dl = pr[j] * (dp[t] - s) * scale;
        if (kDrop) dl = dropout_keep(dr, i, j, salt) ? dl / dr.keep_div : 0.f;
        pr[j] = (mqi * smk[j]) > 0 ? dl : 0.f;
      }
    }
  }
  __syncthreads();

  // 4. dq = dl k and 5. dk = dl^T q
  rows_times_tile<T>(P, lds, 1, Lk, sk, ds, D, Lq, dq + oq, stride);
  rows_times_tile<T>(P, 1, lds, Lq, sq, ds, D, Lk, dk + ok, stride);
}

inline size_t k3b_smem_bytes(int Lq, int Lk, int D) {
  return sizeof(float) * (size_t)(2 * Lq + 2 * Lk) * tile_stride(D) +
         sizeof(int) * (size_t)pad4(Lq + Lk) + sizeof(float) * (size_t)Lq * pad4(Lk);
}

template <typename T, bool kDrop>
cudaError_t launch_k3b_variant(const void* q, const void* k, const void* v, const int* mq,
                               const int* mk, const void* g, void* dq, void* dk, void* dv, int B,
                               int Lq, int Lk, int H, int D, float scale, float rate,
                               float keep_div, unsigned seed, cudaStream_t stream) {
  const size_t smem = k3b_smem_bytes(Lq, Lk, D);
  cudaError_t err = cudaFuncSetAttribute(masked_bwd_kernel<T, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  masked_bwd_kernel<T, kDrop><<<dim3(H, B), kK3bThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mq, mk,
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      Lq, Lk, H, D, scale, rate, keep_div, seed);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

// x's hi and lo halves into two bf16 [query][key] tiles of row stride ldp:
// rows q0 .. q0 + 16, keys [0, 16 nk16).
template <int NT>
__device__ __forceinline__ void k3b_store_split(const float (&x)[NT][4], int q0, int nk16,
                                                __nv_bfloat16* hi, __nv_bfloat16* lo, int ldp) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n / 2 < nk16) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float h0, l0, h1, l1;
        split_bf16(x[n][2 * r], h0, l0);
        split_bf16(x[n][2 * r + 1], h1, l1);
        const int at = (q0 + g + 8 * r) * ldp + n * 8 + 2 * t;
        *reinterpret_cast<unsigned*>(hi + at) = pack_bf16(h0, h1);
        *reinterpret_cast<unsigned*>(lo + at) = pack_bf16(l0, l1);
      }
    }
  }
}

// acc[dn] += X^T . S over the queries for keys k0 .. k0 + 16: X given by
// its two halves, bf16 [query][key] tiles of row stride ldp, S a
// [query][d] tile; nq16 query tiles.
template <int D>
__device__ __forceinline__ void k3b_colsT_times_rows(const __nv_bfloat16* xh,
                                                     const __nv_bfloat16* xl, int ldp, int k0,
                                                     int nq16, const __nv_bfloat16* st,
                                                     float (&acc)[D / 8][4]) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31;
  for (int ki = 0; ki < nq16; ++ki) {
    // matrices (transposed): keys k0.. and k0+8.. of queries 16ki.., then
    // of queries 16ki+8..
    const int at = (16 * ki + (lane & 7) + ((lane >> 4) << 3)) * ldp + k0 + ((lane >> 3) & 1) * 8;
    unsigned ah[4], al[4];
    ldsm_x4_t(ah, xh + at);
    ldsm_x4_t(al, xl + at);
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      unsigned bb[4];
      ldsm_x4_t(bb, st + (16 * ki + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 8 +
                        (lane >> 4) * 8);
      mma_bf16(acc[dn], ah, bb[0], bb[1]);
      mma_bf16(acc[dn + 1], ah, bb[2], bb[3]);
      mma_bf16(acc[dn], al, bb[0], bb[1]);
      mma_bf16(acc[dn + 1], al, bb[2], bb[3]);
    }
  }
}

// Rows r0 + g and r0 + g + 8 (those < L) of a 16 x D accumulator tile, as
// bf16 pairs, to dst + row * stride.
template <int D>
__device__ __forceinline__ void k3b_write_rows(const float (&acc)[D / 8][4], int r0, int L,
                                               __nv_bfloat16* dst, long stride) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < L) {
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<unsigned*>(dst + row * stride + dn * 8 + 2 * t) =
            pack_bf16(acc[dn][2 * r], acc[dn][2 * r + 1]);
    }
  }
}

// x = hi + lo at (row, key) and (row, key + 1) of two bf16 tiles of row
// stride ldp.
__device__ __forceinline__ float2 k3b_load_split(const __nv_bfloat16* hi,
                                                 const __nv_bfloat16* lo, int at) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hi + at));
  const float2 l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(lo + at));
  return make_float2(h.x + l.x, h.y + l.y);
}

// Shared-memory bytes of the four [query][key] halves (p and dl).
__host__ __device__ inline size_t k3b_split_bytes(int Lq, int Lk) {
  return sizeof(__nv_bfloat16) * 4 * (size_t)pad16(Lq) * (pad16(Lk) + 8);
}

template <int D, int NT, bool kDrop>
__global__ void __launch_bounds__(kK3MmaThreads)
masked_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ mq,
                      const int* __restrict__ mk, const __nv_bfloat16* __restrict__ g,
                      __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int H, float scale,
                      float rate, float keep_div, unsigned seed) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int mq16 = pad16(Lq), mk16 = pad16(Lk);
  const int nk16 = mk16 / 16, nq16 = mq16 / 16;
  const int ldp = mk16 + 8;
  const int gi = lane >> 2, ti = lane & 3;
  const long stride = (long)H * D;
  const unsigned salt = (unsigned)h;
  extern __shared__ __align__(16) unsigned char k3b_smem[];
  // the halves of p and dl, then the inputs
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(k3b_smem);
  __nv_bfloat16* pl = ph + mq16 * ldp;
  __nv_bfloat16* dlh = pl + mq16 * ldp;
  __nv_bfloat16* dll = dlh + mq16 * ldp;
  const K3Stage st = k3_stage_at(k3b_smem + k3b_split_bytes(Lq, Lk), Lq, Lk, D, true);
  k3_load<D>(st, q, g, k, v, mq, mk, b, Lq, Lk, H, h);
  __syncthreads();

  const Dropout dr = make_dropout(rate, keep_div, seed, b, gridDim.y);
  // pass 1: a warp per 16-row query tile
  for (int q0 = warp * 16; q0 < Lq; q0 += nwarps * 16) {
    const bool live[2] = {q0 + gi < Lq, q0 + gi + 8 < Lq};
    unsigned long long keep;
    {
      float p[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
      k3_rows_times_rowsT<D, NT>(st.q, q0, st.k, nk16, p);
      keep = k3_probs<NT, kDrop>(p, st.mq, st.mk, q0, Lk, nk16, scale, dr, salt);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (!live[c >> 1]) p[n][c] = 0.f;  // a row past Lq takes no part
      k3b_store_split<NT>(p, q0, nk16, ph, pl, ldp);
    }
    // p is read back as hi + lo (2^-17 relative) from here on, so that
    // it and dp are not both held in registers
    float dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    k3_rows_times_rowsT<D, NT>(st.g, q0, st.v, nk16, dp);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n / 2 < nk16) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 pv = k3b_load_split(ph, pl, (q0 + gi + 8 * r) * ldp + n * 8 + 2 * ti);
          const int j = n * 8 + 2 * ti;
          if (j < Lk) sum[r] = fmaf(dp[n][2 * r], pv.x, sum[r]);
          if (j + 1 < Lk) sum[r] = fmaf(dp[n][2 * r + 1], pv.y, sum[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    // dl in place of dp
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n / 2 < nk16) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = q0 + gi + 8 * r;
          const float2 pv = k3b_load_split(ph, pl, i * ldp + n * 8 + 2 * ti);
          const float pr[2] = {pv.x, pv.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 2 * r + e, j = n * 8 + 2 * ti + e;
            float dl = 0.f;
            if (live[r] && j < Lk) {
              dl = pr[e] * (dp[n][c] - sum[r]) * scale;
              if (kDrop) dl = (keep >> (4 * n + c)) & 1ull ? dl / dr.keep_div : 0.f;
              dl = (st.mq[i] * st.mk[j]) > 0 ? dl : 0.f;
            }
            dp[n][c] = dl;
          }
        }
      }
    }
    k3b_store_split<NT>(dp, q0, nk16, dlh, dll, ldp);

    float acc[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
    k3_regs_times_rows<D, NT, true>(dp, nk16, st.k, acc);
    k3b_write_rows<D>(acc, q0, Lq, dq + ((long)b * Lq * H + h) * D, stride);
  }
  __syncthreads();

  // pass 2: a warp per 16-row key tile
  for (int k0 = warp * 16; k0 < Lk; k0 += nwarps * 16) {
    float av[D / 8][4], ak[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int c = 0; c < 4; ++c) av[dn][c] = ak[dn][c] = 0.f;
    k3b_colsT_times_rows<D>(ph, pl, ldp, k0, nq16, st.g, av);
    k3b_colsT_times_rows<D>(dlh, dll, ldp, k0, nq16, st.q, ak);
    const long ok = ((long)b * Lk * H + h) * D;
    k3b_write_rows<D>(av, k0, Lk, dv + ok, stride);
    k3b_write_rows<D>(ak, k0, Lk, dk + ok, stride);
  }
}

template <int D, int NT>
cudaError_t launch_k3b_mma(const void* q, const void* k, const void* v, const int* mq,
                           const int* mk, const void* g, void* dq, void* dk, void* dv, int B,
                           int Lq, int Lk, int H, float scale, float rate, float keep_div,
                           unsigned seed, cudaStream_t stream) {
  auto kern = rate > 0.f ? masked_bwd_mma_kernel<D, NT, true> : masked_bwd_mma_kernel<D, NT, false>;
  const size_t smem = k3b_split_bytes(Lq, Lk) + k3_stage_bytes(Lq, Lk, D, true);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // a warp per query tile in pass 1 and per key tile in pass 2, at most four
  const int tiles = (Lq > Lk ? pad16(Lq) : pad16(Lk)) / 16;
  const int warps = tiles < kK3MmaWarps ? tiles : kK3MmaWarps;
  using bf = __nv_bfloat16;
  kern<<<dim3(H, B), 32 * warps, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), mq, mk,
      static_cast<const bf*>(g), static_cast<bf*>(dq), static_cast<bf*>(dk), static_cast<bf*>(dv),
      Lq, Lk, H, scale, rate, keep_div, seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_k3b_mma_d(const void* q, const void* k, const void* v, const int* mq,
                             const int* mk, const void* g, void* dq, void* dk, void* dv, int B,
                             int Lq, int Lk, int H, float scale, float rate, float keep_div,
                             unsigned seed, cudaStream_t stream) {
  auto launch = Lk <= 16   ? launch_k3b_mma<D, 2>
                : Lk <= 32 ? launch_k3b_mma<D, 4>
                : Lk <= 64 ? launch_k3b_mma<D, 8>
                           : launch_k3b_mma<D, 16>;
  return launch(q, k, v, mq, mk, g, dq, dk, dv, B, Lq, Lk, H, scale, rate, keep_div, seed,
                stream);
}

}  // namespace segmm

// dtype: 0 = float32 (FMA body), 1 = bfloat16 (tensor cores). Inputs q, k,
// v, the masks and g; outputs dq, dk, dv (same shapes and dtype as q, k,
// v). Lq, Lk <= 128, D in {16, 32, 64}; bf16 pointers 16-byte aligned (the
// wrapper checks). Returns a cudaError_t (0 = launched).
extern "C" int segmm_masked_attention_bwd(int dtype, const void* q, const void* k,
                                          const void* v, const int* mq, const int* mk,
                                          const void* g, void* dq, void* dk, void* dv, int B,
                                          int Lq, int Lk, int H, int D, float scale, float rate,
                                          float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    auto launch = rate > 0.f ? segmm::launch_k3b_variant<float, true>
                             : segmm::launch_k3b_variant<float, false>;
    return (int)launch(q, k, v, mq, mk, g, dq, dk, dv, B, Lq, Lk, H, D, scale, rate, keep_div,
                       seed, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  auto launch = D == 16   ? segmm::launch_k3b_mma_d<16>
                : D == 32 ? segmm::launch_k3b_mma_d<32>
                : D == 64 ? segmm::launch_k3b_mma_d<64>
                          : nullptr;
  if (!launch) return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, mq, mk, g, dq, dk, dv, B, Lq, Lk, H, scale, rate, keep_div, seed,
                     s);
}
