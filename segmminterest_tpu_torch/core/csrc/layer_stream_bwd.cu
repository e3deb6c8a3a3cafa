// K4b: one whole SegFormerX encoder-layer stream, backward.
//
// Replaces the TPU kernel segmminterest_tpu/core/layer_kernel.py
// _fl_bwd_kernel (:178), launched by _fl_call_bwd (:381) from the custom
// VJP of fused_layer_stream, which saves only the layer inputs: everything
// else is recomputed here, and the backward runs in the TPU kernel's order
// (LN2, W_m2, GELU', W_m1, LN1, W_ff, then the attention).
//
// bf16, eight launches, every product on the tensor cores:
//  (1), (2) att recomputed by K2f's projection GEMM (into a transient bf16
//      workspace that (5) reads again) and two-block core, as K4f makes it.
//  (3) the epilogue backward (layer_mma.cuh): a block of 8 warps per 64
//      rows of (B * Lq) recomputes the epilogue forward on mma.sync, then
//      runs LN2', W_m2, GELU', W_m1, LN1' and W_ff with its dgrad products'
//      fp32 operand in three bf16 parts, full rows in its registers; it
//      writes what (4)-(8) read, as the fp32 kernel below does. Past 768
//      the fp32 kernel below runs in bf16 instead, d_att as two halves.
//  (4) the LayerNorm gradients, its blocks' column sums added in order.
//  (5) K2b's core (two_block_mma.cuh) on g = d_att in fp32, which (3)
//      writes as bf16 hi and lo halves (the TPU kernel keeps its `sdatt`
//      fp32, :427).
//  (6) dxq = dq1.Wq1 + dq2.Wq2 + dr1, dx1, dx2 (proj_gemm.cuh chain, dy in
//      three bf16 parts, dr1 added before the one cast).
//  (7), (8) the nine dW = dy^T x, db = sum dy in row chunks of `chunk`
//      rows (the wrapper's k4_dw_chunk rule), then their sums in chunk
//      order.
// fp32, on the CUDA cores between the wrapper's launches of K2's fp32
// route (core/attention.py: the projections and K1's 3xTF32 core):
//  (1) att, recomputed by the wrapper as the forward made it.
//  (2) the epilogue-backward row-tile kernel, one block of 256 threads per
//      16 rows of (B * Lq) (8, then 2, where a wider layer's rows would not
//      fit; ep_bwd_rows): the epilogue forward recomputed in shared memory
//      (layer_epilogue.cuh products, the forward's roundings and dropout
//      bits), then
//        dr2 = LN2'(g), dm = drop(dr2), dgd = drop(dm . W_m2),
//        du = dgd gelu'(u), dy1 = dr2 + du . W_m1, dr1 = LN1'(dy1),
//        dh = drop(dr1), d_att = dh . W_ff
//      with fp32 products on the CUDA cores (dy is fp32 whatever the
//      compute dtype, as in t_chain, :246-250). It writes d_att in fp32
//      (the TPU kernel's fp32 `sdatt` scratch, :427), dr1 (the LN1
//      residual's gradient into xq, :296-297), what the weight gradients
//      need (dm, du, dh fp32; y1, g in the compute dtype) and each block's
//      column sums of g xhat2, g, dy1 xhat1, dy1 (the LayerNorm gradients).
//  (3) those partial sums added over the blocks in order.
//  (4) K2b's qkv pass on g = d_att in fp32, by the wrapper (K1b's 3xTF32
//      core on the recomputed projections).
//  (5) dxq = dq1.Wq1 + dq2.Wq2 + dr1, dx1, dx2 (chain_gemm.cuh).
//  (6) the nine dW = dy^T x and db = sum dy (the six projections and
//      W_ff, W_m1, W_m2) in row chunks,
//  (7) then their sums in chunk order: no atomics, so repeated steps give
//      the same bits.
//
// What bounds it on an H100: operations, K2b's plus the epilogue's (its
// forward recompute, a dgrad product per Dense and the three dW): in bf16
// the recompute at the bf16 rate, the core's products with p, dl and g in
// two bf16 parts, the chain's and the epilogue's dgrad and dW in three.
#include "chain_gemm.cuh"
#include "layer_epilogue.cuh"
#include "layer_mma.cuh"
#include "proj_gemm.cuh"
#include "two_block_mma.cuh"

namespace segmm {

// K2's core in the two directions that bf16 K4b runs: the forward
// (recomputing att) is compiled once, in k2_core_fwd.cu (core/build.py's
// COMMON), and linked into each library that runs it; the backward on an
// fp32 g is instantiated in layer_stream_bwd.core.cu, compiled beside this
// file (core/build.py), so that the two compiles run side by side.
extern template cudaError_t launch_k2_core<false, false, kBlockKeys, float>(const K2CoreArgs&,
                                                                            int, int,
                                                                            cudaStream_t);
extern template cudaError_t launch_k2_core<true, true, kBlockKeys, float>(const K2CoreArgs&,
                                                                          int, int,
                                                                          cudaStream_t);

// what the epilogue-backward kernel reads and writes besides the weights
template <typename T>
struct EpBwdIO {
  const T* att;   // (rows, d), recomputed
  const T* xq;    // (rows, d)
  const T* g;     // (rows, d), the upstream gradient
  T* y1;          // (rows, d)
  T* gact;        // (rows, ff), after its dropout
  float* datt;    // (rows, d)
  float* dr1;     // (rows, d); holds r1 until dr1 replaces it
  float* dm;      // (rows, d)
  float* dh;      // (rows, d)
  float* du;      // (rows, ff); holds u until du replaces it
  float* part;    // (blocks, 4, d): sums of g xhat2, g, dy1 xhat1, dy1
  // T = bf16 (the bf16 K4b's widths past the tensor-core epilogue): d_att
  // as bf16 hi and lo halves, as the bf16 core stages K4b's g; datt unused
  bf16* datt_hi;
  bf16* datt_lo;
};

// shared memory over rt rows: the A tile (att in T, then the backward's
// fp32 operands dm, du, dh), y1 (T), the fp32 product tile, r2 / dr2
// (fp32), the weight stage, the two LayerNorms' row stats
template <typename T>
struct EpBwdLayout {
  size_t a, y1, c, r2, stage, stats, total;
  __host__ __device__ EpBwdLayout(int d, int ff, int rt = kEpBwdRows) {
    const int w = d > ff ? d : ff;
    const size_t at = sizeof(T) * rt * tile_ld<T>(w);
    const size_t af = sizeof(float) * rt * (w + 4);
    a = 0;
    y1 = a + align128(at > af ? at : af);
    c = y1 + align128(sizeof(T) * rt * tile_ld<T>(d));
    r2 = c + align128(sizeof(float) * rt * (w + 4));
    stage = r2 + align128(sizeof(float) * rt * (d + 4));
    stats = stage + align128(ep_stage_bytes());
    total = stats + 4 * sizeof(float) * rt;
  }
};

// The backward row-tile epilogue's rows a block at widths d, ff: the most
// of kEpBwdRows, kEpNarrowRows and kEpNarrowestRows whose layout fits one
// block (0: none does); its LayerNorm partials are ceil(B Lq / rows)
// blocks' (core/layer_kernel.py k4_epilogue_rows).
template <typename T> inline int ep_bwd_rows(int d, int ff) {
  const int rts[3] = {kEpBwdRows, kEpNarrowRows, kEpNarrowestRows};
  for (int rt : rts)
    if (EpBwdLayout<T>(d, ff, rt).total <= kK2MaxBlockSmem) return rt;
  return 0;
}

template <typename T, bool kDrop, int RT>
__global__ void __launch_bounds__(kEpThreads)
layer_epilogue_bwd_kernel(EpBwdIO<T> io, EpParams<T> ep, int rows, int Lq, int B, int d, int ff,
                          int H, float rate, float keep_div, float epi_div, unsigned seed) {
  extern __shared__ __align__(128) unsigned char smem[];
  const EpBwdLayout<T> lay(d, ff, RT);
  const int w = d > ff ? d : ff, lda = tile_ld<T>(w), ldf = w + 4, ldy = tile_ld<T>(d);
  const int ldc = w + 4, ldr = d + 4;
  T* sA = reinterpret_cast<T*>(smem + lay.a);
  float* sF = reinterpret_cast<float*>(smem + lay.a);  // the same region, fp32
  T* sY = reinterpret_cast<T*>(smem + lay.y1);
  float* sC = reinterpret_cast<float*>(smem + lay.c);
  float* sR = reinterpret_cast<float*>(smem + lay.r2);
  unsigned char* stage = smem + lay.stage;
  float* mu1 = reinterpret_cast<float*>(smem + lay.stats);
  float* inv1 = mu1 + RT;
  float* mu2 = inv1 + RT;
  float* inv2 = mu2 + RT;
  const int r0 = blockIdx.x * RT, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nrows = min(RT, rows - r0);
  const unsigned salt0 = kEpSalt * H;
  const float inv_d = 1.0f / (float)d;

  // ---- the epilogue forward, as layer_stream.cu computes it ----
  for (int i = tid; i < RT * d; i += kEpThreads) {
    const int r = i / d, c = i - r * d;
    sA[r * lda + c] = r < nrows ? io.att[(long)(r0 + r) * d + c] : from_f<T>(0.f);
  }
  __syncthreads();
  tile_gemm_tn<RT, T>(sA, lda, d, ep.wff, d, sC, ldc, stage);
  for (int i = tid; i < RT * d; i += kEpThreads) {
    const int r = i / d, c = i - r * d;
    float v = 0.f;
    if (r < nrows) {
      float h = proj_epilogue<T>(sC[r * ldc + c], to_f<T>(ep.bff[c]));
      if (kDrop)
        h = ep_keep(rate, seed, r0 + r, Lq, B, c, salt0) ? round_to<T>(h / epi_div) : 0.f;
      v = round_to<T>(to_f<T>(io.xq[(long)(r0 + r) * d + c]) + h);
      io.dr1[(long)(r0 + r) * d + c] = v;  // r1, for LN1's backward
    }
    sC[r * ldc + c] = v;
  }
  __syncthreads();
  ln_stats<RT>(sC, ldc, d, mu1, inv1);
  for (int i = tid; i < RT * d; i += kEpThreads) {
    const int r = i / d, c = i - r * d;
    const T y = from_f<T>((sC[r * ldc + c] - mu1[r]) * inv1[r] * ep.ln1s[c] + ep.ln1b[c]);
    sY[r * ldy + c] = y;
    if (r < nrows) io.y1[(long)(r0 + r) * d + c] = y;
  }
  __syncthreads();
  tile_gemm_tn<RT, T>(sY, ldy, d, ep.wm1, ff, sC, ldc, stage);
  for (int i = tid; i < RT * ff; i += kEpThreads) {
    const int r = i / ff, c = i - r * ff;
    const float u = proj_epilogue<T>(sC[r * ldc + c], to_f<T>(ep.bm1[c]));
    float g = round_to<T>(gelu_f32(u));
    if (r < nrows) {
      if (kDrop)
        g = ep_keep(rate, seed, r0 + r, Lq, B, c, salt0 + 1) ? round_to<T>(g / epi_div) : 0.f;
      io.du[(long)(r0 + r) * ff + c] = u;  // u, for GELU's derivative
      io.gact[(long)(r0 + r) * ff + c] = from_f<T>(g);
    }
    sA[r * lda + c] = from_f<T>(g);
  }
  __syncthreads();
  tile_gemm_tn<RT, T>(sA, lda, ff, ep.wm2, d, sC, ldc, stage);
  for (int i = tid; i < RT * d; i += kEpThreads) {
    const int r = i / d, c = i - r * d;
    float m = proj_epilogue<T>(sC[r * ldc + c], to_f<T>(ep.bm2[c]));
    if (kDrop && r < nrows)
      m = ep_keep(rate, seed, r0 + r, Lq, B, c, salt0 + 2) ? round_to<T>(m / epi_div) : 0.f;
    sR[r * ldr + c] = round_to<T>(to_f<T>(sY[r * ldy + c]) + m);
  }
  __syncthreads();
  ln_stats<RT>(sR, ldr, d, mu2, inv2);

  // ---- LN2: the block's column sums of g xhat2 and g, then dr2 ----
  float* part = io.part + (long)blockIdx.x * 4 * d;
  for (int c = tid; c < d; c += kEpThreads) {
    float s0 = 0.f, s1 = 0.f;
    for (int r = 0; r < nrows; ++r) {
      const float gg = to_f<T>(io.g[(long)(r0 + r) * d + c]);
      s0 = fmaf(gg, (sR[r * ldr + c] - mu2[r]) * inv2[r], s0);
      s1 += gg;
    }
    part[c] = s0;
    part[d + c] = s1;
  }
  __syncthreads();
  for (int r = warp; r < RT; r += kEpWarps) {
    float m1 = 0.f, m2 = 0.f;
    if (r < nrows) {
      for (int c = lane; c < d; c += 32) {
        const float dx = to_f<T>(io.g[(long)(r0 + r) * d + c]) * ep.ln2s[c];
        m1 += dx;
        m2 = fmaf(dx, (sR[r * ldr + c] - mu2[r]) * inv2[r], m2);
      }
      m1 = warp_sum(m1) * inv_d;
      m2 = warp_sum(m2) * inv_d;
    }
    for (int c = lane; c < d; c += 32) {
      float dr2 = 0.f, dm = 0.f;
      if (r < nrows) {
        const float xhat = (sR[r * ldr + c] - mu2[r]) * inv2[r];
        const float dx = to_f<T>(io.g[(long)(r0 + r) * d + c]) * ep.ln2s[c];
        dr2 = inv2[r] * (dx - m1 - xhat * m2);
        dm = dr2;
        if (kDrop)
          dm = ep_keep(rate, seed, r0 + r, Lq, B, c, salt0 + 2) ? dr2 / keep_div : 0.f;
        io.dm[(long)(r0 + r) * d + c] = dm;
      }
      sR[r * ldr + c] = dr2;
      sF[r * ldf + c] = dm;
    }
  }
  __syncthreads();

  // ---- W_m2, the GELU's dropout and derivative ----
  tile_gemm_nn_f32<T, RT>(sF, ldf, d, ep.wm2, ff, sC, ldc, stage);
  for (int i = tid; i < RT * ff; i += kEpThreads) {
    const int r = i / ff, c = i - r * ff;
    float du = 0.f;
    if (r < nrows) {
      float dg = sC[r * ldc + c];
      if (kDrop) dg = ep_keep(rate, seed, r0 + r, Lq, B, c, salt0 + 1) ? dg / keep_div : 0.f;
      const long o = (long)(r0 + r) * ff + c;
      du = dg * gelu_grad_f32(io.du[o]);
      io.du[o] = du;
    }
    sF[r * ldf + c] = du;
  }
  __syncthreads();

  // ---- W_m1: dy1 = dr2 + du . W_m1 ----
  tile_gemm_nn_f32<T, RT>(sF, ldf, ff, ep.wm1, d, sC, ldc, stage);
  for (int i = tid; i < RT * d; i += kEpThreads) {
    const int r = i / d, c = i - r * d;
    sC[r * ldc + c] += sR[r * ldr + c];
  }
  __syncthreads();

  // ---- LN1: column sums of dy1 xhat1 and dy1, then dr1 and dh ----
  for (int c = tid; c < d; c += kEpThreads) {
    float s2 = 0.f, s3 = 0.f;
    for (int r = 0; r < nrows; ++r) {
      const float dy = sC[r * ldc + c];
      s2 = fmaf(dy, (io.dr1[(long)(r0 + r) * d + c] - mu1[r]) * inv1[r], s2);
      s3 += dy;
    }
    part[2 * d + c] = s2;
    part[3 * d + c] = s3;
  }
  __syncthreads();
  for (int r = warp; r < RT; r += kEpWarps) {
    float m1 = 0.f, m2 = 0.f;
    if (r < nrows) {
      for (int c = lane; c < d; c += 32) {
        const float dx = sC[r * ldc + c] * ep.ln1s[c];
        m1 += dx;
        m2 = fmaf(dx, (io.dr1[(long)(r0 + r) * d + c] - mu1[r]) * inv1[r], m2);
      }
      m1 = warp_sum(m1) * inv_d;
      m2 = warp_sum(m2) * inv_d;
    }
    for (int c = lane; c < d; c += 32) {
      float dh = 0.f;
      if (r < nrows) {
        const long o = (long)(r0 + r) * d + c;
        const float xhat = (io.dr1[o] - mu1[r]) * inv1[r];
        const float dr1 = inv1[r] * (sC[r * ldc + c] * ep.ln1s[c] - m1 - xhat * m2);
        io.dr1[o] = dr1;
        dh = dr1;
        if (kDrop) dh = ep_keep(rate, seed, r0 + r, Lq, B, c, salt0) ? dr1 / keep_div : 0.f;
        io.dh[o] = dh;
      }
      sF[r * ldf + c] = dh;
    }
  }
  __syncthreads();

  // ---- W_ff: d_att = dh . W_ff ----
  tile_gemm_nn_f32<T, RT>(sF, ldf, d, ep.wff, d, sC, ldc, stage);
  for (int i = tid; i < nrows * d; i += kEpThreads) {
    const int r = i / d, c = i - r * d;
    const long o = (long)(r0 + r) * d + c;
    if constexpr (std::is_same<T, float>::value) {
      io.datt[o] = sC[r * ldc + c];
    } else {
      float hi, lo;
      split_bf16(sC[r * ldc + c], hi, lo);
      io.datt_hi[o] = __float2bfloat16(hi);
      io.datt_lo[o] = __float2bfloat16(lo);
    }
  }
}

// out[j][c] = sum over blocks (in order) of part[blk][j][c]
__global__ void ln_partial_sum_kernel(const float* __restrict__ part, int nblk, int d,
                                      float* dln2s, float* dln2b, float* dln1s, float* dln1b) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 4 * d) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[(long)b * 4 * d + e];
  const int j = e / d, c = e - j * d;
  float* out[4] = {dln2s, dln2b, dln1s, dln1b};
  out[j][c] = s;
}

template <typename T, int RT>
cudaError_t launch_k4b_epilogue_rt(const EpBwdIO<T>& io, const void* const* p,
                                   float* const* grads, int B, int Lq, int d, int H, int ff,
                                   float rate, float keep_div, float epi_div, unsigned seed,
                                   cudaStream_t s) {
  const int rows = B * Lq;
  const size_t smem = EpBwdLayout<T>(d, ff, RT).total;
  auto kernel = rate > 0.f ? layer_epilogue_bwd_kernel<T, true, RT>
                           : layer_epilogue_bwd_kernel<T, false, RT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nblk = (rows + RT - 1) / RT;
  if (nblk > 0)
    kernel<<<nblk, kEpThreads, smem, s>>>(io, ep_params<T>(p + 15), rows, Lq, B, d, ff, H, rate,
                                          keep_div, epi_div, seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_partial_sum_kernel<<<(4 * d + 255) / 256, 256, 0, s>>>(io.part, nblk, d, grads[20],
                                                              grads[21], grads[14], grads[15]);
  return cudaGetLastError();
}

// (2) and (3) of fp32 K4b: the row-tile epilogue backward on att (work[0],
// the wrapper's) and the LayerNorm gradients; also bf16 K4b's (3) and (4)
// at widths past the tensor-core epilogue's (lm_takes), d_att into
// work[3]'s bytes as bf16 hi and lo halves.
template <typename T>
cudaError_t launch_k4b_epilogue(const void* const* p, const void* g, float* const* work,
                                float* const* grads, int B, int Lq, int dm, int H, int ff,
                                float rate, float keep_div, float epi_div, unsigned seed,
                                cudaStream_t s) {
  const int d = dm;
  bf16* hi = reinterpret_cast<bf16*>(work[3]);
  const EpBwdIO<T> io{static_cast<const T*>((const void*)work[0]),
                      static_cast<const T*>(p[0]),
                      static_cast<const T*>(g),
                      reinterpret_cast<T*>(work[1]),
                      reinterpret_cast<T*>(work[2]),
                      work[3], work[4], work[5], work[6], work[7], work[8], hi,
                      hi + (long)B * Lq * d};
  switch (ep_bwd_rows<T>(d, ff)) {
    case kEpBwdRows:
      return launch_k4b_epilogue_rt<T, kEpBwdRows>(io, p, grads, B, Lq, d, H, ff, rate,
                                                   keep_div, epi_div, seed, s);
    case kEpNarrowRows:
      return launch_k4b_epilogue_rt<T, kEpNarrowRows>(io, p, grads, B, Lq, d, H, ff, rate,
                                                      keep_div, epi_div, seed, s);
    case kEpNarrowestRows:
      return launch_k4b_epilogue_rt<T, kEpNarrowestRows>(io, p, grads, B, Lq, d, H, ff, rate,
                                                         keep_div, epi_div, seed, s);
    default: return cudaErrorInvalidValue;
  }
}

// fp32 (5)-(7): dx and the nine dW, db from the six fp32 dq1..dv2 of the
// attention's qkv pass (work[9..14], the wrapper's).
template <typename T>
cudaError_t launch_k4b_chain(const void* const* p, float* const* work, void* const* dx,
                             float* const* grads, float* scratch, int B, int Lq, int L1, int L2,
                             int dm, int ff, int splits, cudaStream_t s) {
  if (splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
  const int rows = B * Lq, d = dm;
  const void* att = work[0];
  float* const* dys = work + 9;
  cudaError_t err;
  // (5) dxq (+ dr1), dx1, dx2
  DxJobs<2> xj{};
  const int L[3] = {Lq, L1, L2};
  const int pair_dy[3][2] = {{0, 1}, {2, 4}, {3, 5}};  // dq1 dq2 | dk1 dv1 | dk2 dv2
  const int pair_w[3][2] = {{3, 5}, {7, 11}, {9, 13}};  // Wq1 Wq2 | Wk1 Wv1 | Wk2 Wv2
  int max_rows = 0;
  for (int j = 0; j < 3; ++j) {
    const float* a[2] = {dys[pair_dy[j][0]], dys[pair_dy[j][1]]};
    const void* wp[2] = {p[pair_w[j][0]], p[pair_w[j][1]]};
    xj.job[j] = dx_job<2>(a, wp, 2, dx[j], j == 0 ? work[4] : nullptr, B * L[j], d, d);
    max_rows = max(max_rows, B * L[j]);
  }
  err = launch_dx<T, 2>(xj, 3, max_rows, d, s);
  if (err != cudaSuccess) return err;
  // (6) the nine weight gradients
  DwJobs wj{};
  ReduceJobs rj{};
  int nj = 0, nr = 0;
  float* part = scratch;
  const int w_x[6] = {0, 0, 1, 2, 1, 2};  // xq xq x1 x2 x1 x2
  for (int w = 0; w < 6; ++w) {
    if (!add_wgrad(wj, nj, rj, nr, dys[w], p[w_x[w]], B * L[w_x[w]], d, d, splits, part,
                   grads[w], grads[6 + w]))
      return cudaErrorInvalidValue;
    part += wgrad_part_floats(d, d, splits);
  }
  // W_ff: dh^T att; W_m1: du^T y1; W_m2: dm^T g
  const struct { const float* dy; const void* x; int M, N, gi; } ep_w[3] = {
      {work[6], att, d, d, 12}, {work[7], work[1], ff, d, 16}, {work[5], work[2], d, ff, 18}};
  for (const auto& e : ep_w) {
    if (!add_wgrad(wj, nj, rj, nr, e.dy, e.x, rows, e.M, e.N, splits, part, grads[e.gi],
                   grads[e.gi + 1]))
      return cudaErrorInvalidValue;
    part += wgrad_part_floats(e.M, e.N, splits);
  }
  const int wmax = d > ff ? d : ff;
  return launch_wgrads<T>(wj, nj, rj, nr, wmax, wmax, splits, s);
}

inline cudaError_t launch_layer_epilogue_bwd_mma(const LmBwdArgs& a, cudaStream_t s) {
  const int d = a.f.d, ff = a.f.ff;
  if (!lm_takes(d, ff)) return cudaErrorInvalidValue;
  auto kernel = lm_bwd_kernel(d, ff, a.f.rate > 0.f);
  const size_t smem = lm_bwd_smem_bytes(d, ff);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.f.rows > 0) kernel<<<lm_blocks(a.f.rows, d, ff), kLmThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// bf16 K4b's (3) and (4) at the tensor-core epilogue's widths: the
// epilogue backward on mma.sync and the LayerNorm gradients.
inline cudaError_t launch_k4b_epilogue_mma(const void* const* p, const void* g,
                                           float* const* work, float* const* grads,
                                           const bf16* att, bf16* datt_hi, bf16* datt_lo, int B,
                                           int Lq, int d, int H, int ff, float rate,
                                           float keep_div, float epi_div, unsigned seed,
                                           cudaStream_t s) {
  const int rows = B * Lq;
  cudaError_t err;
  // (3) the epilogue backward
  LmBwdArgs e{};
  e.f = LmFwdArgs{att, static_cast<const bf16*>(p[0]), reinterpret_cast<bf16*>(work[1]),
                  reinterpret_cast<bf16*>(work[2]), nullptr, ep_params<bf16>(p + 15), rows, Lq,
                  B, d, ff, H, rate, epi_div, seed};
  e.g = static_cast<const bf16*>(g);
  e.datt_hi = datt_hi;
  e.datt_lo = datt_lo;
  e.r1 = work[4];
  e.dm = work[5];
  e.dh = work[6];
  e.u = work[7];
  e.part = work[8];
  e.keep_div = keep_div;
  err = launch_layer_epilogue_bwd_mma(e, s);
  if (err != cudaSuccess) return err;
  // (4) the LayerNorm gradients
  if (rows > 0) {
    ln_partial_sum_kernel<<<(4 * d + 255) / 256, 256, 0, s>>>(
        work[8], lm_blocks(rows, d, ff), d, grads[20], grads[21], grads[14], grads[15]);
    err = cudaGetLastError();
  }
  return err;
}

// bf16: work as segmm_layer_stream_bwd's, then K2's projection workspace
// (three (B, L, 2d) tensors) at work[15..17]; the epilogue backward on the
// tensor cores up to widths of 768 (lm_takes), past them the row-tile one.
inline cudaError_t launch_k4b_mma(const void* const* p, const int* mq, const int* m1,
                                  const int* m2, const void* g, float* const* work,
                                  void* const* dx, float* const* grads, float* scratch, int B,
                                  int Lq, int L1, int L2, int dm, int H, int ff, int chunk,
                                  float scale, float rate, float keep_div, float epi_div,
                                  unsigned seed, cudaStream_t s) {
  const int rows = B * Lq, d = dm;
  void* const ws[3] = {work[15], work[16], work[17]};
  bf16* att = reinterpret_cast<bf16*>(work[0]);
  // (1), (2) att
  cudaError_t err = launch_k2_projections(p, ws, B, Lq, L1, L2, dm, s);
  if (err != cudaSuccess) return err;
  K2CoreArgs a = k2_core_args(ws, dm, mq, m1, m2, Lq, L1, L2, H, scale, rate, keep_div, seed);
  a.out = att;
  err = launch_k2_core<false>(a, dm / H, B, s);
  if (err != cudaSuccess) return err;
  // d_att's fp32 buffer holds its two bf16 halves
  bf16* datt_hi = reinterpret_cast<bf16*>(work[3]);
  bf16* datt_lo = datt_hi + (long)rows * d;
  if (!lm_takes(d, ff)) {
    // (3), (4) past the tensor-core epilogue's widths: the row-tile
    // epilogue backward in bf16 and the LayerNorm gradients
    err = launch_k4b_epilogue<bf16>(p, g, work, grads, B, Lq, d, H, ff, rate, keep_div, epi_div,
                                    seed, s);
    if (err != cudaSuccess) return err;
  } else {
    err = launch_k4b_epilogue_mma(p, g, work, grads, att, datt_hi, datt_lo, B, Lq, d, H, ff,
                                  rate, keep_div, epi_div, seed, s);
    if (err != cudaSuccess) return err;
  }
  // (5) the attention's core backward on g = d_att (fp32, as two halves)
  a.g = datt_hi;
  a.glo = datt_lo;
  for (int i = 0; i < 6; ++i) a.dy[i] = work[9 + i];
  err = launch_k2_core<true, true>(a, dm / H, B, s);
  if (err != cudaSuccess) return err;
  // (6)-(8) dx (dxq + dr1) and the nine dW, db: W_ff dh^T att, W_m1 du^T y1,
  // W_m2 dm^T g
  const DwWeight extra[3] = {
      {work[6], att, rows, d, d, grads[12], grads[13]},
      {work[7], reinterpret_cast<const bf16*>(work[1]), rows, ff, d, grads[16], grads[17]},
      {work[5], reinterpret_cast<const bf16*>(work[2]), rows, d, ff, grads[18], grads[19]}};
  return launch_k2_chain(p, work + 9, dx, grads, work[4], extra, 3, B, Lq, L1, L2, d, chunk,
                         scratch, s);
}

}  // namespace segmm

// ptrs: as segmm_layer_stream_fwd's; g (B, Lq, d) in x's dtype. work:
// att, y1 (B, Lq, d) and g (B, Lq, ff) in x's dtype; d_att, dr1, dm, dh
// (B, Lq, d) and du (B, Lq, ff) fp32; the LayerNorm partials (blocks, 4,
// d) fp32, blocks = ceil(B Lq / rows), rows the epilogue body's
// (core/layer_kernel.py k4_epilogue_rows: the row-tile body's ep_bwd_rows,
// or bf16's tensor-core body's lm_rows up to 768); the
// six fp32 dq1, dq2, dk1, dk2, dv1, dv2 ((B, L, d) each); bf16 only, the
// projections' (B, Lq, 2d), (B, L1, 2d), (B, L2, 2d) bf16. dx: dxq, dx1,
// dx2 (x's dtype). grads (fp32): dW of the six projections, their six db,
// then dW_ff, db_ff, dln1_s, dln1_b, dW_m1, db_m1, dW_m2, db_m2, dln2_s,
// dln2_b. scratch: fp32; fp32, splits * (6 (d^2 + d) + d^2 + 2 d ff + 2 d
// + ff) with 1 <= splits <= 4; bf16, the sum over the nine weights of
// dw_chunks(rows, chunk) * (Mo Ni + Mo) with chunk % 32 == 0. fp32 runs
// (2) and (3) alone, on att in work[0] (the wrapper's); its qkv pass and
// chain follow (the wrapper's, then segmm_layer_stream_chain_bwd).
// Returns a cudaError_t.
extern "C" int segmm_layer_stream_bwd(int dtype, const void* const* ptrs, const int* mq,
                                      const int* m1, const int* m2, const void* g,
                                      float* const* work, void* const* dx, float* const* grads,
                                      float* scratch, int B, int Lq, int L1, int L2, int dm,
                                      int H, int ff, int splits, int chunk, float scale,
                                      float rate, float keep_div, float epi_div, unsigned seed,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)segmm::launch_k4b_epilogue<float>(ptrs, g, work, grads, B, Lq, dm, H, ff, rate,
                                                  keep_div, epi_div, seed, s);
  if (dtype == 1)
    return (int)segmm::launch_k4b_mma(ptrs, mq, m1, m2, g, work, dx, grads, scratch, B, Lq, L1,
                                      L2, dm, H, ff, chunk, scale, rate, keep_div, epi_div, seed,
                                      s);
  return (int)cudaErrorInvalidValue;
}

// fp32 (5)-(7): dxq (+ dr1), dx1, dx2 and the nine dW, db, from work[9..14]
// (the six fp32 dq1..dv2 of the wrapper's qkv pass on d_att) and what
// segmm_layer_stream_bwd wrote; ptrs, work, dx, grads and scratch as
// there, 1 <= splits <= 4. Returns a cudaError_t.
extern "C" int segmm_layer_stream_chain_bwd(const void* const* ptrs, float* const* work,
                                            void* const* dx, float* const* grads, float* scratch,
                                            int B, int Lq, int L1, int L2, int dm, int ff,
                                            int splits, void* stream) {
  return (int)segmm::launch_k4b_chain<float>(ptrs, work, dx, grads, scratch, B, Lq, L1, L2, dm,
                                             ff, splits, static_cast<cudaStream_t>(stream));
}
