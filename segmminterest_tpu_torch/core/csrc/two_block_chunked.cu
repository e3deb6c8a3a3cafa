// The bf16 two-block core (two_block_mma.cuh) over key chunks and query
// windows: every shape that the core's one-chunk bodies do not take (a key
// axis past their register tile, or one (head, batch row)'s tiles past a
// block's shared memory), so that the JAX kernels' any-length blocks
// (attention.py _fp_fwd_kernel :776 / _fp_bwd_kernel :808 and K1's, K4's,
// K5's and K6's, which all take whole arrays as blocks) have a kernel at
// every length. The function is the core's; the sums run in another order.
//
// Forward, grid (H, B, windows): a block stages q1 and q2 of its window of
// kK2ChunkRows query rows (a warp per 16), then walks the key axis
// (block 1 at [0, pad8(L1)), block 2 after, as the core lays it out) in
// chunks of kK2ChunkKeys keys: S = q k^T of the chunk on mma.sync, fill,
// dropout (each key hashed at its own index of the axis, in either of the
// core's key modes) and scale as the core does, then an online softmax: a
// running max and sum per query row (quad shuffles), the output
// accumulator rescaled by exp(old max - new max), p = exp(l - max) rounded
// to bf16 before p v. The output is divided by the sum at the end.
//
// Backward, grid (H, B): one block walks the query windows in order. Sweep
// 1 over the chunks takes each row's max, sum and s = sum dp p with online
// rescaling (dp = g v^T); sweep 2 per chunk recomputes p, stages it as bf16
// hi / lo planes (p at fp32 accuracy, as the core keeps it), dv = p^T g,
// then dl = p (dp - s) scale, dropout, pair mask over p's planes, dq = dl k
// summed in registers across the chunks (block 1's part written where the
// axis crosses into block 2), dk = dl^T q_b. The windows add their dk and
// dv into the outputs in window order (fp32 gradients in place; bf16 ones
// through the fp32 scratch a.acc, cast at the end): no atomics, the same
// bits on every run. K4b's fp32 g comes as two bf16 halves (a.glo), and
// every product with g takes both.
//
// What bounds it on an H100: it is the long-stream path, held for
// correctness, not speed (PERF.md has its times); the backward's (head,
// batch row) blocks walk their windows one after another.
#include "two_block_mma.cuh"

namespace segmm {

// Key j of the axis in the launch's key mode (k2_key's two modes).
__device__ __forceinline__ K2Key k2c_key(int j, int c1, int L1, int L2, int h, bool concat) {
  return concat ? k2_key<kConcatKeys>(j, c1, L1, L2, h) : k2_key<kBlockKeys>(j, c1, L1, L2, h);
}

// Rows [row0, row0 + n) of a bf16 tensor of row stride rs (src already at
// the head's column) into a tile of `rows` rows of ld D + 8; zeros past n.
// Only issues the copies.
template <int D>
__device__ __forceinline__ void k2c_stage_rows(const __nv_bfloat16* src, long rs,
                                               __nv_bfloat16* dst, long row0, int n, int rows) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks, k = c - r * kChunks;
    const bool ok = r < n;
    cp_async16(dst + r * (D + 8) + k * 8, ok ? src + (row0 + r) * rs + k * 8 : src, ok);
  }
}

// k (or with v the values) of axis columns [j0, j0 + kK2ChunkKeys) of
// batch row blockIdx.y, head blockIdx.x, and the key mask over the same
// columns (0 past each block's length). Only issues the copies.
template <int D>
__device__ __forceinline__ void k2c_stage_chunk(const K2CoreArgs& a, __nv_bfloat16* sk,
                                                __nv_bfloat16* sv, int* smk, int j0, int c1) {
  constexpr int kChunks = D / 8;
  const int b = blockIdx.y, col = blockIdx.x * D;
  for (int c = threadIdx.x; c < 2 * kK2ChunkKeys * kChunks; c += blockDim.x) {
    const bool v = c >= kK2ChunkKeys * kChunks;
    const int cc = v ? c - kK2ChunkKeys * kChunks : c;
    const int r = cc / kChunks, k = cc - r * kChunks, j = j0 + r;
    const bool second = j >= c1;
    const int jj = second ? j - c1 : j;
    const bool ok = jj < (second ? a.L2 : a.L1);
    const __nv_bfloat16* s = a.k1;
    if (ok)
      s = (second ? (v ? a.v2 : a.k2) + ((long)b * a.L2 + jj) * a.rs
                  : (v ? a.v1 : a.k1) + ((long)b * a.L1 + jj) * a.rs) +
          col + k * 8;
    cp_async16((v ? sv : sk) + r * (D + 8) + k * 8, s, ok);
  }
  for (int r = threadIdx.x; r < kK2ChunkKeys; r += blockDim.x) {
    const int j = j0 + r;
    const bool second = j >= c1;
    const int jj = second ? j - c1 : j;
    const bool ok = jj < (second ? a.L2 : a.L1);
    const int* s = a.mk1;
    if (ok) s = second ? a.mk2 + (long)b * a.L2 + jj : a.mk1 + (long)b * a.L1 + jj;
    cp_async4(smk + r, s, ok);
  }
}

// The dropout keep bits of this lane's elements of query tile q0 (the row
// of the batch row's queries, as the hash counts it) over the chunk's n8
// tiles (word n / 8, bit 4 (n % 8) + c), k2_keep_bits' layout.
__device__ __forceinline__ void k2c_keep_bits(unsigned (&keep)[kK2ChunkNT / 8], int q0, int j0,
                                              int c1, int L1, int L2, int nkc, Dropout dr,
                                              int h, bool concat) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int w = 0; w < kK2ChunkNT / 8; ++w) {
    unsigned word = 0u;
#pragma unroll 4
    for (int e = 0; e < 32; ++e) {
      const int n = 8 * w + (e >> 2), c = e & 3;
      if (n >= 2 * nkc) break;
      const K2Key key = k2c_key(j0 + n * 8 + 2 * t + (c & 1), c1, L1, L2, h, concat);
      if (key.j < key.len && dropout_keep(dr, q0 + g + 8 * (c >> 1), key.hj, key.salt))
        word |= 1u << e;
    }
    keep[w] = word;
  }
}

// The chunk's logit tile -> masked, dropped and scaled logits as k2_probs
// forms them (-inf past each block's length); returns each of the lane's
// two rows' max over the chunk (over the quad).
__device__ __forceinline__ void k2c_fill(float (&s)[kK2ChunkNT][4],
                                         const unsigned (&keep)[kK2ChunkNT / 8], const int* smq,
                                         const int* smk, int q0, int j0, int c1, int L1, int L2,
                                         int nkc, float scale, float inv_keep, bool drop,
                                         bool concat, int h, float (&mx)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mqr[2] = {smq[q0 + g], smq[q0 + g + 8]};
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < kK2ChunkNT; ++n) {
    if (n / 2 < nkc) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, jl = n * 8 + 2 * t + (c & 1);
        const K2Key key = k2c_key(j0 + jl, c1, L1, L2, h, concat);
        float l = -INFINITY;
        if (key.j < key.len) {
          l = (mqr[r] * smk[jl]) > 0 ? s[n][c] : kMaskFill;
          if (drop) l = (keep[n / 8] >> (4 * (n % 8) + c)) & 1u ? l * inv_keep : 0.f;
          l *= scale;
        }
        s[n][c] = l;
        mx[r] = fmaxf(mx[r], l);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

template <int NT>
__device__ __forceinline__ void k2c_zero_tile(float (&s)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
}

// ---------------------------------------------------------------------------
// Forward

template <int D>
__global__ void __launch_bounds__(32 * kK2ChunkWarps)
k2_chunked_fwd_kernel(const __grid_constant__ K2CoreArgs a) {
  constexpr int LD = D + 8, NT = kK2ChunkNT, WQ = kK2ChunkRows, KC = kK2ChunkKeys;
  const int h = blockIdx.x, b = blockIdx.y, z0 = blockIdx.z * WQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int sh = a.salt_h0 + h;
  extern __shared__ __align__(16) unsigned char k2c_fsmem[];
  __nv_bfloat16* sq1 = reinterpret_cast<__nv_bfloat16*>(k2c_fsmem);
  __nv_bfloat16* sq2 = sq1 + WQ * LD;
  __nv_bfloat16* sk = sq2 + WQ * LD;
  __nv_bfloat16* sv = sk + KC * LD;
  int* smq = reinterpret_cast<int*>(sv + KC * LD);
  int* smk = smq + WQ;
  const int nq = min(WQ, a.Lq - z0);
  const int c1 = k2_c1(a.L1), nk16 = k2_keys16(a.L1, a.L2);
  const long row0 = (long)b * a.Lq + z0;
  k2c_stage_rows<D>(a.q1 + h * D, a.rs, sq1, row0, nq, WQ);
  k2c_stage_rows<D>(a.q2 + h * D, a.rs, sq2, row0, nq, WQ);
  for (int r = threadIdx.x; r < WQ; r += blockDim.x)
    cp_async4(smq + r, r < nq ? a.mq + row0 + r : a.mq, r < nq);
  const int q0 = warp * 16;
  const bool live = q0 < nq;
  const Dropout dr = make_dropout(a.rate, a.keep_div, a.seed, b, gridDim.y);
  const bool drop = a.rate > 0.f;
  const float inv_keep = 1.f / dr.keep_div;
  float o[D / 8][4];
  k2_zero<D>(o);
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < nk16; j0 += KC) {
    k2c_stage_chunk<D>(a, sk, sv, smk, j0, c1);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (live) {
      const int nkc = min(KC, nk16 - j0) / 16;
      float s[NT][4];
      k2c_zero_tile<NT>(s);
      k2_logits<D, NT>(sq1, sq2, q0, sk, c1 - j0, nkc, s);
      unsigned keep[NT / 8] = {};
      if (drop) k2c_keep_bits(keep, z0 + q0, j0, c1, a.L1, a.L2, nkc, dr, sh, a.concat);
      float cm[2];
      k2c_fill(s, keep, smq, smk, q0, j0, c1, a.L1, a.L2, nkc, a.scale, inv_keep, drop,
               a.concat, sh, cm);
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
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n / 2 < nkc) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float e = expf(s[n][c] - ref[c >> 1]);
            s[n][c] = e;
            sum[c >> 1] += e;
          }
        }
      }
      k3_regs_times_rows<D, NT, false>(s, nkc, sv, o);
    }
    __syncthreads();
  }
  if (!live) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    inv[r] = 1.f / sum[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = z0 + q0 + g + 8 * r;
    if (i >= a.Lq) continue;
    __nv_bfloat16* dst = a.out + (((long)b * a.Lq + i) * a.H + h) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<unsigned*>(dst + dn * 8 + 2 * t) =
          pack_bf16(o[dn][2 * r] * inv[r], o[dn][2 * r + 1] * inv[r]);
  }
}

// ---------------------------------------------------------------------------
// Backward

// Half r of a 16 x D accumulator tile into row `at` of a (B, L, d) tensor:
// fp32 stored (first) or added, or bf16 stored.
template <int D>
__device__ __forceinline__ void k2c_put_row(const float (&acc)[D / 8][4], int r, void* base,
                                            long at, bool bf16, bool first) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const long i = at + dn * 8 + 2 * t;
    if (bf16) {
      *reinterpret_cast<unsigned*>(static_cast<__nv_bfloat16*>(base) + i) =
          pack_bf16(acc[dn][2 * r], acc[dn][2 * r + 1]);
    } else {
      float2* p = reinterpret_cast<float2*>(static_cast<float*>(base) + i);
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

// Key rows k0 + g, k0 + g + 8 of the axis (within their block's length)
// of dk (kind 0) or dv (kind 1): into the gradients, or with bf16
// gradients over several windows into the scratch a.acc.
template <int D>
__device__ __forceinline__ void k2c_put_key_rows(const K2CoreArgs& a, const float (&acc)[D / 8][4],
                                                 int k0, int c1, int kind, bool first,
                                                 bool scratch) {
  const int g = (threadIdx.x & 31) >> 2, h = blockIdx.x, b = blockIdx.y;
  const long dm = (long)a.H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + g + 8 * r;
    const bool second = j >= c1;
    const int jj = second ? j - c1 : j, L = second ? a.L2 : a.L1;
    if (jj >= L) continue;
    const long at = ((long)b * L + jj) * dm + h * D;
    if (scratch) {
      // dk1, dk2, dv1, dv2 one after another
      const long off = (long)gridDim.y * dm *
                       (kind == 0 ? (second ? a.L1 : 0) : (second ? 2 * a.L1 + a.L2 : a.L1 + a.L2));
      k2c_put_row<D>(acc, r, a.acc + off, at, false, first);
    } else {
      k2c_put_row<D>(acc, r, a.dy[2 + 2 * kind + (second ? 1 : 0)], at, a.dy_bf16, first);
    }
  }
}

// Query rows z0 + q0 + g, + 8 (those < Lq) of dq_b into dy[b] (null: K3's
// absent block 2); with `zero` zeros.
template <int D>
__device__ __forceinline__ void k2c_put_q_rows(const K2CoreArgs& a, const float (&acc)[D / 8][4],
                                               int z0q0, int blk, bool zero) {
  const int g = (threadIdx.x & 31) >> 2, h = blockIdx.x, b = blockIdx.y;
  if (!a.dy[blk]) return;
  float z[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) z[dn][c] = zero ? 0.f : acc[dn][c];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = z0q0 + g + 8 * r;
    if (i < a.Lq)
      k2c_put_row<D>(z, r, a.dy[blk], (((long)b * a.Lq + i) * a.H + h) * D, a.dy_bf16, true);
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kK2ChunkWarps)
k2_chunked_bwd_kernel(const __grid_constant__ K2CoreArgs a) {
  constexpr int LD = D + 8, NT = kK2ChunkNT, WQ = kK2ChunkRows, KC = kK2ChunkKeys;
  constexpr int ldp = KC + 8;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int gi = lane >> 2, ti = lane & 3;
  const int sh = a.salt_h0 + h;
  const bool g32 = a.glo != nullptr;
  extern __shared__ __align__(16) unsigned char k2c_bsmem[];
  __nv_bfloat16* sq1 = reinterpret_cast<__nv_bfloat16*>(k2c_bsmem);
  __nv_bfloat16* sq2 = sq1 + WQ * LD;
  __nv_bfloat16* sg = sq2 + WQ * LD;
  __nv_bfloat16* sglo = sg + WQ * LD;
  __nv_bfloat16* sk = sg + (g32 ? 2 : 1) * WQ * LD;
  __nv_bfloat16* sv = sk + KC * LD;
  int* smq = reinterpret_cast<int*>(sv + KC * LD);
  int* smk = smq + WQ;
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(smk + KC);
  __nv_bfloat16* pl = ph + WQ * ldp;
  const int Lq = a.Lq, L1 = a.L1, L2 = a.L2;
  const int c1 = k2_c1(L1), nk16 = k2_keys16(L1, L2);
  const long dm = (long)a.H * D;
  const int nwin = k2_chunk_windows(Lq);
  const bool scratch = a.dy_bf16 && nwin > 1;
  const Dropout dr = make_dropout(a.rate, a.keep_div, a.seed, b, gridDim.y);
  const bool drop = a.rate > 0.f;
  const float inv_keep = 1.f / dr.keep_div;
  const int q0 = warp * 16;

  for (int z0 = 0; z0 < Lq; z0 += WQ) {
    const int nq = min(WQ, Lq - z0), nq16 = pad16(nq) / 16;
    const bool live = q0 < nq, first = z0 == 0;
    const long row0 = (long)b * Lq + z0;
    k2c_stage_rows<D>(a.q1 + h * D, a.rs, sq1, row0, nq, WQ);
    k2c_stage_rows<D>(a.q2 + h * D, a.rs, sq2, row0, nq, WQ);
    k2c_stage_rows<D>(a.g + h * D, dm, sg, row0, nq, WQ);
    if (g32) k2c_stage_rows<D>(a.glo + h * D, dm, sglo, row0, nq, WQ);
    for (int r = threadIdx.x; r < WQ; r += blockDim.x)
      cp_async4(smq + r, r < nq ? a.mq + row0 + r : a.mq, r < nq);

    // sweep 1: each row's max, sum and sum of dp p over the whole axis
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, sdp[2] = {0.f, 0.f};
    for (int j0 = 0; j0 < nk16; j0 += KC) {
      k2c_stage_chunk<D>(a, sk, sv, smk, j0, c1);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (live) {
        const int nkc = min(KC, nk16 - j0) / 16;
        float s[NT][4], dp[NT][4];
        k2c_zero_tile<NT>(s);
        k2c_zero_tile<NT>(dp);
        k2_logits<D, NT>(sq1, sq2, q0, sk, c1 - j0, nkc, s);
        unsigned keep[NT / 8] = {};
        if (drop) k2c_keep_bits(keep, z0 + q0, j0, c1, L1, L2, nkc, dr, sh, a.concat);
        float cm[2];
        k2c_fill(s, keep, smq, smk, q0, j0, c1, L1, L2, nkc, a.scale, inv_keep, drop, a.concat,
                 sh, cm);
        k3_rows_times_rowsT<D, NT>(sg, q0, sv, nkc, dp);
        if (g32) k3_rows_times_rowsT<D, NT>(sglo, q0, sv, nkc, dp);
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
        for (int n = 0; n < NT; ++n) {
          if (n / 2 < nkc) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float e = expf(s[n][c] - ref[c >> 1]);
              sum[c >> 1] += e;
              sdp[c >> 1] = fmaf(dp[n][c], e, sdp[c >> 1]);
            }
          }
        }
      }
      __syncthreads();
    }
    float inv[2] = {0.f, 0.f}, srow[2] = {0.f, 0.f};
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

    // sweep 2: per chunk p, dv, dl, dq (in registers), dk
    float dq[D / 8][4];
    k2_zero<D>(dq);
    bool second = false;  // dq holds block 2's part
    for (int j0 = 0; j0 < nk16; j0 += KC) {
      const int nkc = min(KC, nk16 - j0) / 16;
      k2c_stage_chunk<D>(a, sk, sv, smk, j0, c1);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      unsigned keep[NT / 8] = {};
      if (live) {
        float p[NT][4];
        k2c_zero_tile<NT>(p);
        k2_logits<D, NT>(sq1, sq2, q0, sk, c1 - j0, nkc, p);
        if (drop) k2c_keep_bits(keep, z0 + q0, j0, c1, L1, L2, nkc, dr, sh, a.concat);
        float cm[2];
        k2c_fill(p, keep, smq, smk, q0, j0, c1, L1, L2, nkc, a.scale, inv_keep, drop, a.concat,
                 sh, cm);
        const bool rl[2] = {z0 + q0 + gi < Lq, z0 + q0 + gi + 8 < Lq};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n / 2 < nkc) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int r = c >> 1;
              p[n][c] = rl[r] ? expf(p[n][c] - mx[r]) * inv[r] : 0.f;
            }
          }
        }
        k3b_store_split<NT>(p, q0, nkc, ph, pl, ldp);
      }
      __syncthreads();
      // dv = p^T g over the window's rows, a warp per 16 keys
      for (int k0 = warp * 16; k0 < nkc * 16; k0 += nwarps * 16) {
        float acc[D / 8][4];
        k2_zero<D>(acc);
        k3b_colsT_times_rows<D>(ph, pl, ldp, k0, nq16, sg, acc);
        if (g32) k3b_colsT_times_rows<D>(ph, pl, ldp, k0, nq16, sglo, acc);
        k2c_put_key_rows<D>(a, acc, j0 + k0, c1, 1, first, scratch);
      }
      __syncthreads();
      if (live) {
        float dp[NT][4];
        k2c_zero_tile<NT>(dp);
        k3_rows_times_rowsT<D, NT>(sg, q0, sv, nkc, dp);
        if (g32) k3_rows_times_rowsT<D, NT>(sglo, q0, sv, nkc, dp);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n / 2 < nkc) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = q0 + gi + 8 * r;
              const float2 pv = k3b_load_split(ph, pl, i * ldp + n * 8 + 2 * ti);
              const float pr[2] = {pv.x, pv.y};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = 2 * r + e, jl = n * 8 + 2 * ti + e;
                float dl = pr[e] * (dp[n][c] - srow[r]) * a.scale;
                if (drop) dl = (keep[n / 8] >> (4 * (n % 8) + c)) & 1u ? dl * inv_keep : 0.f;
                dp[n][c] = (smq[i] * smk[jl]) > 0 ? dl : 0.f;
              }
            }
          }
        }
        __syncwarp();
        k3b_store_split<NT>(dp, q0, nkc, ph, pl, ldp);
        // dq: block 1's keys are the n8 tiles before (c1 - j0) / 8
        const int nb = (c1 - j0) / 8;
        if (!second) {
          k2_regs_times_rows<D, NT>(dp, 0, nb, nkc, sk, dq);
          if (nb < 2 * nkc) {
            k2c_put_q_rows<D>(a, dq, z0 + q0, 0, false);
            k2_zero<D>(dq);
            second = true;
            k2_regs_times_rows<D, NT>(dp, nb > 0 ? nb : 0, 2 * nkc, nkc, sk, dq);
          }
        } else {
          k2_regs_times_rows<D, NT>(dp, 0, 2 * nkc, nkc, sk, dq);
        }
      }
      __syncthreads();
      // dk = dl^T q1 (block 1's keys), dl^T q2 (block 2's)
      for (int k0 = warp * 16; k0 < nkc * 16; k0 += nwarps * 16) {
        const bool lo2 = j0 + k0 >= c1, hi2 = j0 + k0 + 8 >= c1;
        float acc[D / 8][4];
        k2_zero<D>(acc);
        if (!lo2 || !hi2) k3b_colsT_times_rows<D>(ph, pl, ldp, k0, nq16, sq1, acc, !lo2, !hi2);
        if (lo2 || hi2) k3b_colsT_times_rows<D>(ph, pl, ldp, k0, nq16, sq2, acc, lo2, hi2);
        k2c_put_key_rows<D>(a, acc, j0 + k0, c1, 0, first, scratch);
      }
      __syncthreads();
    }
    if (live) {
      if (second) {
        k2c_put_q_rows<D>(a, dq, z0 + q0, 1, false);
      } else {
        k2c_put_q_rows<D>(a, dq, z0 + q0, 0, false);
        k2c_put_q_rows<D>(a, dq, z0 + q0, 1, true);
      }
    }
  }
  if (!scratch) return;
  // bf16 gradients over several windows: the sums in a.acc, cast
  __syncthreads();
  for (int kind = 0; kind < 2; ++kind) {
    for (int blk = 0; blk < 2; ++blk) {
      const int L = blk ? L2 : L1;
      const long off = (long)gridDim.y * dm *
                       (kind == 0 ? (blk ? L1 : 0) : (blk ? 2 * L1 + L2 : L1 + L2));
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.dy[2 + 2 * kind + blk]);
      for (int c = threadIdx.x; c < L * (D / 2); c += blockDim.x) {
        const int r = c / (D / 2), d = (c - r * (D / 2)) * 2;
        const long at = ((long)b * L + r) * dm + h * D + d;
        const float2 v = *reinterpret_cast<const float2*>(a.acc + off + at);
        *reinterpret_cast<unsigned*>(dst + at) = pack_bf16(v.x, v.y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side

template <int D>
cudaError_t launch_k2_chunked_d(const K2CoreArgs& a, bool bwd, int B, cudaStream_t stream) {
  const size_t smem = k2_chunked_smem_bytes(D, bwd, bwd && a.glo != nullptr);
  void (*kern)(K2CoreArgs) = bwd ? k2_chunked_bwd_kernel<D> : k2_chunked_fwd_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, B, bwd ? 1 : k2_chunk_windows(a.Lq));
  kern<<<grid, 32 * kK2ChunkWarps, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_k2_chunked(const K2CoreArgs& a, int D, bool bwd, int B, cudaStream_t stream) {
  if (a.Lq < 1 || a.L1 < 1 || a.L2 < 0) return cudaErrorInvalidValue;
  if (bwd && a.dy_bf16 && k2_chunk_windows(a.Lq) > 1 && !a.acc) return cudaErrorInvalidValue;
  switch (D) {
#define SEGMM_K2_CASE(d) \
  case d: return launch_k2_chunked_d<d>(a, bwd, B, stream);
    SEGMM_K2_HEAD_DIMS(SEGMM_K2_CASE)
#undef SEGMM_K2_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace segmm
