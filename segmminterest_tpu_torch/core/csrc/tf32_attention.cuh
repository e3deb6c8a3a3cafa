// The fp32 masked attention kernels on the TF32 tensor cores in 3xTF32,
// both directions: K1f / K1b over two key blocks under one softmax
// (two_block_attention.cu, two_block_attention_bwd.cu) and K3f / K3b over
// one (masked_attention.cu, masked_attention_bwd.cu).
//
// Function. The probabilities in fp32 from q, k and the masks (attention.py
// _fwd2_kernel :527 / _fwd_kernel :126): l = q k^T, fill -10000 where
// mq x mk is 0 (before the scale), in training keep ? l / (1 - rate) : 0
// with the keep bits of salt 2h / 2h + 1 per block (h for one block) and
// the key counted within its block, x scale, one softmax over every key of
// every block. The forward writes out = sum over blocks of p v. The
// backward (_attn_group_bwd :448 / _bwd_kernel :156) recomputes p, then
//   dv = p^T g,  dp = g v^T,  s = sum dp p (all blocks),  dl = p (dp - s) scale,
//   dropout mask and divisor, pair mask,  dq = dl k,  dk = dl^T q,
// each gradient in fp32.
//
// Numerics. Every product (q k^T, p v; g v^T, dl k, p^T g, dl^T q) runs on
// mma.sync m16n8k8 in TF32 three times: each fp32 operand x is split into
// big = tf32(x) and small = tf32(x - big) (cvt.rna), and big.small +
// small.big + big.big go into one fp32 accumulator (mma_sync.cuh). That
// leaves each product ~2^-21 from the fp32 one, where one TF32 rounding
// leaves ~2^-11; tests/test_torch_attention_fwd.py,
// tests/test_torch_attention_bwd.py and tests/test_torch_masked_attention.py
// emulate the arithmetic on the CPU and hold it within 1e-5 of the fp32
// plain versions. p and dl stay fp32 throughout; l / (1 - rate) is l times
// the reciprocal (within an ulp), the softmax's 1 / sum likewise.
//
// Geometry of one (batch row, head). The keys of the blocks lie on one axis,
// block b from column c0[b] (c0[0] = 0, c0[1] = pad8(L1)) over pad8(L_b)
// columns, so that each n8 tile of the axis belongs to one block. A warp
// owns 16 query rows (the forward, and the backward's pass 1) or 16 keys of
// one block (the backward's pass 2).
//   * Tiles in shared memory, fp32 rows of LD = DP + 4 floats (DP: D rounded
//     up to 16, 32 or 64; columns past D and rows past L are zero): q of
//     each block (and g) over pad8(Lq) rows, k and v of each block over
//     pad8(L_b) rows (a 16-row query tile whose upper 8 rows lie past
//     pad8(Lq) reads them as 0). LD = 4 mod 8 words makes the fragment reads
//     conflict-free in both directions: (row g, col t) reads hit bank
//     4g + t (+ const), and reads of rows 2t and 2t + 1 at column g (the B
//     fragments of p v, dq, dv and dk, see mma_sync.cuh for the order of the
//     sum) hit 8t + g and 8t + 4 + g.
//   * Forward, per 16-row query tile: S = q k^T in registers (n8 tiles of
//     the key axis), the softmax in registers (quad shuffles), out = p v
//     with p's C tiles as the A fragments (no P buffer), the output through
//     the tile's own q rows in shared memory and out in 16-byte stores. No
//     barrier after the staging.
//   * Backward: P, [query][key] fp32 of pad8(Lq) rows and row stride
//     ldp = nk + 4 (nk = the sum of pad8(L_b), also 4 mod 8): pass 2 reads
//     rows 2t, 2t + 1 at columns g, g + 8 (conflict-free as above); pass 1
//     writes and reads float2 at (row g, cols 2t, 2t + 1).
// Backward pass 1, per 16-row query tile: the forward's S and softmax, p and
// its dropout keep bits (a word a lane and 8 key tiles) to shared memory.
// Pass 2, per 16 keys of a block: dv = p^T g. Pass 1 again: dp = g v^T in
// registers, sum dp p from P, dl in dp's registers and over p in P,
// dq = dl k straight from the registers. Pass 2 again: dk = dl^T q. Three
// block barriers and one Lq x Lk buffer: p and dl in two buffers (one pass
// of each) took more time at every stream shape and leave no room for K1b
// at (100, 40, 100); the numbers are in PERF.md.
//
// Head dims past 64 (96, 128; 4 heads at d_model 512): the tiles of one
// (batch row, head) exceed one block's shared memory at the flagship's
// longest stream (K1b at (100, 40, 100) and D = 128 would need ~307 KB), so
// the launcher splits the queries into windows (tf32_fwd_window /
// tf32_bwd_window: the most rows, a multiple of 16, whose tiles fit), one
// block each (grid z), each staging k and v whole. The forward's windows
// share nothing; the backward's dq is each window's own, its dk and dv
// sums over the windows: window 0 writes them, the others into part slots
// that tf32_sum_windows_kernel adds in window order (no atomics: the same
// bits on every run). Where all of Lq fits (every shape at D <= 64) there
// is one window and nothing changes. The register tile past 64 is 18 n8
// tiles (144 keys, the flagship's 40 | 100): 32 spilled some 4 KB a thread.
// The salts' first head (salt_h0, K5's user stream) and K6's key axis
// (concat) let the fp32 routes of K2, K4, K5 and K6 run on this body.
//
// Every key row's dk and dv is written, 0 where no query reaches it; keys
// past L_b get p = 0 and take no part in the max or the sum; masked keys
// inside L_b keep -10000; a fully padded query row is the uniform softmax
// over the keys; query rows past Lq get p = dl = 0 and are not written.
// Each block owns its (b, h) outputs: no atomics, the same order of every
// sum on every run.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "joint_attention.cuh"
#include "mma_sync.cuh"

namespace segmm {

// A warp takes a 16-row query tile in pass 1 and a 16-key tile in pass 2,
// at most four warps a block, or eight where the block's shared memory
// leaves room for one block per SM only.
constexpr int kTf32BwdThreads = 256;
constexpr int kSmBytes = 233472;  // an H100 SM's shared memory, 1 KB a block reserved

template <int N> __host__ __device__ inline int round_up(int n) { return (n + N - 1) / N * N; }

// the head dim as the kernels tile it (0: unsupported)
__host__ __device__ inline int tf32_dp(int D) {
  return D % 4 ? 0 : D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 96 ? 96 : D <= 128 ? 128 : 0;
}

// The most shared memory one block may use on an H100 (227 KB).
constexpr size_t kTf32MaxBlockSmem = 232448;

// Key-axis geometry of NB blocks (L[1] unused when NB == 1).
struct Tf32KeyAxis {
  int c0[2];  // first column of each block
  int nk;     // columns pass 1 computes: sum of pad8(L_b)
  int ldp;    // row stride of P
};

__host__ __device__ inline Tf32KeyAxis tf32_key_axis(int NB, const int* L) {
  Tf32KeyAxis ax;
  ax.c0[0] = 0;
  ax.c0[1] = round_up<8>(L[0]);
  const int last = NB - 1;
  ax.nk = ax.c0[last] + round_up<8>(L[last]);
  ax.ldp = ax.nk + 4;
  return ax;
}

// The dropout keep bits of pass 1, kept for pass 1 again: per 16-row query
// tile one 32-bit word per lane and 8 n8 tiles of the key axis.
__host__ __device__ inline int tf32_keep_words(int Lq, int nk) {
  return (Lq + 15) / 16 * ((nk + 63) / 64) * 32;
}

// q, g (pad8(Lq) rows) and k, v (pad8(L_b) rows) tiles, the masks, the keep
// words and P.
__host__ __device__ inline size_t tf32_bwd_smem_bytes(int NB, int Lq, const int* L, int D) {
  const int LD = tf32_dp(D) + 4, mq8 = round_up<8>(Lq);
  const Tf32KeyAxis ax = tf32_key_axis(NB, L);
  size_t floats = (size_t)(NB + 1) * mq8 * LD + (size_t)mq8 * ax.ldp;
  for (int b = 0; b < NB; ++b) floats += 2 * (size_t)round_up<8>(L[b]) * LD;
  const size_t ints = mq8 + ax.nk + tf32_keep_words(Lq, ax.nk);
  return sizeof(float) * floats + sizeof(int) * ints;
}

template <int NB> struct Tf32BwdArgs {
  const float* q[NB];
  const float* k[NB];
  const float* v[NB];
  const float* g;
  const int* mq;
  const int* mk[NB];
  float* dq[NB];
  float* dk[NB];
  float* dv[NB];
  int Lq, L[NB], H, D;
  float scale, rate, keep_div;
  unsigned seed;
  // set by the launcher (tf32_windows): the query rows of a block, a
  // multiple of 16 or all of Lq; where there are several windows, window
  // z > 0 writes its dk and dv into part + (z - 1) slot (dk of each block,
  // then dv of each block, (B, L_b, H, D) each), which tf32_sum_windows
  // adds to dk and dv in window order
  int qw;
  float* part;
  // the dropout salts' first head (K5's user stream: H) and, with concat,
  // K6's key axis (block 2's key j hashed as L[0] + j, every key with salt
  // h), where K2's, K5's and K6's fp32 bodies run on this one
  int salt_h0, concat;
};

// Floats of one window's part slot: dk and dv of every block.
template <int NB>
__host__ __device__ inline long tf32_part_floats(const Tf32BwdArgs<NB>& a, int B) {
  long n = 0;
  for (int i = 0; i < NB; ++i) n += 2L * B * a.L[i] * a.H * a.D;
  return n;
}

// Rows [0, L) of head h of batch row b of a (B, L, H, D) fp32 tensor into a
// tile of `rows` rows of LD = DP + 4; columns [D, DP) and rows [L, rows)
// are zero. 16-byte copies where the tensor starts on a 16-byte boundary,
// else 4-byte ones. Only issues the copies.
// With a window: rows [r0, r0 + L) of a tensor of Ls rows a batch row.
template <int DP>
__device__ __forceinline__ void tf32_stage(const float* __restrict__ src, float* dst, int b,
                                           int L, int rows, int H, int h, int D, int r0 = 0,
                                           int Ls = -1) {
  constexpr int LD = DP + 4, kChunks = DP / 4;
  const bool a16 = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks, d = (c - r * kChunks) * 4;
    float* t = dst + r * LD + d;
    if (r >= L || d >= D) {
      *reinterpret_cast<float4*>(t) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* s = src + (((long)b * (Ls < 0 ? L : Ls) + r0 + r) * H + h) * D + d;
    if (a16) {
      cp_async16(t, s, true);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(t + e, s + e, true);
    }
  }
}

__device__ __forceinline__ void tf32_stage_mask(const int* __restrict__ src, int* dst, int b,
                                                int L, int rows, int r0 = 0, int Ls = -1) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    cp_async4(dst + i, i < L ? src + (long)b * (Ls < 0 ? L : Ls) + r0 + i : src, i < L);
}

// acc[n] += A[q0 .. q0 + 16) . B[8 (n - n0) .. + 8)^T over DP for the n8
// tiles n0 <= n < n1: A rows from tile sa (rows past arows, a multiple of 8,
// read as 0), B rows from tile sb, both [row][d] of stride DP + 4.
template <int DP, int NT>
__device__ __forceinline__ void tf32_rows_times_rowsT(const float* sa, int q0, int arows,
                                                      const float* sb, int n0, int n1,
                                                      float (&acc)[NT][4]) {
  constexpr int LD = DP + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int G = NT % 6 == 0 ? 6 : 4;  // n8 tiles a group
  const float* a = sa + (q0 + g) * LD + t;
  const bool hi = q0 + 16 <= arows;  // rows q0 + 8 .. q0 + 16 are in the tile
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const Tf32A af = split_a(a[8 * kk], hi ? a[8 * LD + 8 * kk] : 0.f, a[8 * kk + 4],
                             hi ? a[8 * LD + 8 * kk + 4] : 0.f);
#pragma unroll
    for (int ng = 0; ng < NT; ng += G) {
      if (ng >= n1 || ng + G <= n0) continue;
      // the group's B fragments first, then the three passes over its tiles
      Tf32B bf[G];
      bool on[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        on[j] = ng + j >= n0 && ng + j < n1;
        const float* br = sb + (8 * (ng + j - n0) + g) * LD + 8 * kk + t;
        bf[j] = on[j] ? split_b(br[0], br[4]) : Tf32B{};
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (on[j]) mma_tf32(acc[ng + j], af.big, bf[j].small[0], bf[j].small[1]);
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (on[j]) mma_tf32(acc[ng + j], af.small, bf[j].big[0], bf[j].big[1]);
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (on[j]) mma_tf32(acc[ng + j], af.big, bf[j].big[0], bf[j].big[1]);
    }
  }
}

// acc[dn] += X . S over the keys of n8 tiles n0 <= n < n1: X (16 query rows) in registers in the
// accumulator layout, S a [key][d] tile whose row 0 is the key of column
// 8 n0. X's C tile is the A fragment in the order
// {c0, c2, c1, c3} with S's rows 2t and 2t + 1 (mma_sync.cuh).
template <int DP, int NT>
__device__ __forceinline__ void tf32_regs_times_rows(const float (&x)[NT][4], int n0, int n1,
                                                     const float* st,
                                                     float (&acc)[DP / 8][4]) {
  constexpr int LD = DP + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= n0 && n < n1) {
      const Tf32A af = split_a(x[n][0], x[n][2], x[n][1], x[n][3]);
      const float* br = st + (8 * (n - n0) + 2 * t) * LD + g;
      Tf32B bf[DP / 8];
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) bf[dn] = split_b(br[8 * dn], br[LD + 8 * dn]);
      mma_3xtf32<DP / 8>(acc, af, bf);
    }
  }
}

// acc[dn] += X^T . S over the queries for keys k0 .. k0 + 16 of a block: X
// a [query][key] buffer of row stride ldp whose block starts at column c0,
// keys >= kend read as 0; S a [query][d] tile; nq8 steps of 8 queries.
template <int DP>
__device__ __forceinline__ void tf32_colsT_times_rows(const float* X, int ldp, int c0, int k0,
                                                      int kend, int nq8, const float* st,
                                                      float (&acc)[DP / 8][4]) {
  constexpr int LD = DP + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ka = k0 + g, kb = k0 + g + 8;
  const bool va = ka < kend, vb = kb < kend;
  for (int kq = 0; kq < nq8; ++kq) {
    const float* x0 = X + (8 * kq + 2 * t) * ldp + c0;
    const float* x1 = x0 + ldp;
    const Tf32A af = split_a(va ? x0[ka] : 0.f, vb ? x0[kb] : 0.f, va ? x1[ka] : 0.f,
                             vb ? x1[kb] : 0.f);
    const float* br = st + (8 * kq + 2 * t) * LD + g;
    Tf32B bf[DP / 8];
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) bf[dn] = split_b(br[8 * dn], br[LD + 8 * dn]);
    mma_3xtf32<DP / 8>(acc, af, bf);
  }
}

// Rows r0 + g and r0 + g + 8 (those < L) and columns < D of a 16 x DP
// accumulator tile to dst + row * stride.
template <int DP>
__device__ __forceinline__ void tf32_write_rows(const float (&acc)[DP / 8][4], int r0, int L,
                                                int D, float* dst, long stride) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < L) {
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        const int col = 8 * dn + 2 * t;
        if (col < D)
          *reinterpret_cast<float2*>(dst + row * stride + col) =
              make_float2(acc[dn][2 * r], acc[dn][2 * r + 1]);
      }
    }
  }
}

template <int DP> __device__ __forceinline__ void tf32_zero(float (&acc)[DP / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
}

// The blocks of one (batch row, head) as pass 1 sees them.
template <int NB> struct Tf32Blocks {
  int L[NB], n0[NB], n1[NB], koff[NB];  // koff: the dropout hash's first key
  const int* mk[NB];  // key masks in shared memory
  unsigned salt[NB];
  // the block of n8 tile n of the key axis
  __device__ __forceinline__ int of(int n) const { return NB > 1 && n >= n0[NB - 1] ? NB - 1 : 0; }
  __device__ __forceinline__ int len(int b) const { return b ? L[NB - 1] : L[0]; }
  __device__ __forceinline__ int first(int b) const { return b ? n0[NB - 1] : n0[0]; }
  __device__ __forceinline__ const int* mask(int b) const { return b ? mk[NB - 1] : mk[0]; }
  __device__ __forceinline__ unsigned salt_of(int b) const { return b ? salt[NB - 1] : salt[0]; }
  __device__ __forceinline__ int koff_of(int b) const { return b ? koff[NB - 1] : koff[0]; }
};

// k and v of each block at `at` (pad8(L_b) rows each) and the blocks'
// geometry and salts; returns the first float past them. Only issues the
// copies.
template <int DP, int NB>
__device__ __forceinline__ float* tf32_stage_keys(const float* const (&k)[NB],
                                                  const float* const (&v)[NB],
                                                  const int (&L)[NB], const Tf32KeyAxis& ax,
                                                  int b, int H, int h, int D, float* at,
                                                  const float* (&sk)[NB], const float* (&sv)[NB],
                                                  Tf32Blocks<NB>& bk, int salt_h0 = 0,
                                                  int concat = 0) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int rows = round_up<8>(L[i]);
    tf32_stage<DP>(k[i], at, b, L[i], rows, H, h, D);
    sk[i] = at;
    at += rows * LD;
    tf32_stage<DP>(v[i], at, b, L[i], rows, H, h, D);
    sv[i] = at;
    at += rows * LD;
    bk.L[i] = L[i];
    bk.n0[i] = ax.c0[i] / 8;
    bk.n1[i] = bk.n0[i] + rows / 8;
    bk.salt[i] = NB == 1 || concat ? (unsigned)h : 2u * (salt_h0 + h) + i;
    bk.koff[i] = concat && i ? L[0] : 0;
  }
  return at;
}

// The query mask (pad8(Lq) entries) at smq, then each block's key mask
// (pad8(L_b)); returns the first int past them. Only issues the copies.
// With a window, query rows [zq, zq + Lq) of the mq of aLq rows.
template <int NB>
__device__ __forceinline__ int* tf32_stage_masks(const int* mq, const int* const (&mk)[NB], int b,
                                                 int Lq, int* smq, Tf32Blocks<NB>& bk,
                                                 int zq = 0, int aLq = -1) {
  tf32_stage_mask(mq, smq, b, Lq, round_up<8>(Lq), zq, aLq);
  int* at = smq + round_up<8>(Lq);
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    tf32_stage_mask(mk[i], at, b, bk.L[i], round_up<8>(bk.L[i]));
    bk.mk[i] = at;
    at += round_up<8>(bk.L[i]);
  }
  return at;
}


// The logit tile s -> probabilities in fp32 over the whole key axis: fill
// -10000 where mq x mk is 0, in training keep ? l / (1 - rate) : 0 (each
// block's salt, key within its block), x scale, one softmax; columns past
// their block's length get p = 0 and take no part in the max or the sum.
// Rows past Lq are zeroed (and draw no dropout bits). Keep bits go to
// keep[n / 8] bit 4 (n % 8) + c (the forward drops them). zq: the query
// row of the window's row 0, as the dropout hash counts it.
template <int NT, int NB, bool kDrop>
__device__ __forceinline__ void tf32_probs(float (&s)[NT][4], unsigned (&keep)[(NT + 7) / 8],
                                           const Tf32Blocks<NB>& bk, int nt, const int* smq,
                                           int q0, int Lq, float scale, Dropout dr, int zq = 0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + g, q0 + g + 8};
  // smq holds pad8(Lq) rows; a row past Lq reads no mask
  const int mqr[2] = {rows[0] < Lq ? smq[rows[0]] : 0, rows[1] < Lq ? smq[rows[1]] : 0};
  // x / (1 - rate) as x times its reciprocal (within an ulp): an IEEE
  // division a logit, unrolled over the tile, costs registers and time
  const float inv_keep = 1.f / dr.keep_div;
#pragma unroll
  for (int w = 0; w < (NT + 7) / 8; ++w) keep[w] = 0u;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < nt) {
      const int b = bk.of(n);
      const int L = bk.len(b);
      const int* mk = bk.mask(b);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, j = 8 * (n - bk.first(b)) + 2 * t + (c & 1);
        float l = -INFINITY;
        if (j < L && rows[r] >= Lq) {
          l = 0.f;  // a row past Lq: finite, zeroed below
        } else if (j < L) {
          l = (mqr[r] * mk[j]) > 0 ? s[n][c] : kMaskFill;
          if (kDrop) {
            const bool kept = dropout_keep(dr, zq + rows[r], j + bk.koff_of(b), bk.salt_of(b));
            keep[n / 8] |= (unsigned)kept << (4 * (n % 8) + c);
            l = kept ? l * inv_keep : 0.f;
          }
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
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(s[n][c] - mx[c >> 1]);
        s[n][c] = e;
        sum[c >> 1] += e;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    sum[r] = rows[r] < Lq ? 1.f / sum[r] : 0.f;  // a row past Lq takes no part
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] *= sum[c >> 1];
    }
  }
}

// x's rows q0 .. q0 + 16 (those below rows, a multiple of 8) over the first
// nt n8 tiles into a [query][key] buffer of row stride ldp.
template <int NT>
__device__ __forceinline__ void tf32_store_tile(const float (&x)[NT][4], int nt, int q0,
                                                int rows, float* buf, int ldp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool hi = q0 + 16 <= rows;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (r == 0 || hi)
          *reinterpret_cast<float2*>(buf + (q0 + g + 8 * r) * ldp + 8 * n + 2 * t) =
              make_float2(x[n][2 * r], x[n][2 * r + 1]);
    }
  }
}

// dp = g v^T of the query tile q0, then dl in its place: p from P,
// s = sum dp p over the key axis, dl = p (dp - s) scale, dropout (the keep
// bits pass 1 drew), pair mask; rows past Lq and keys past their block's
// length get 0.
template <int DP, int NT, int NB, bool kDrop>
__device__ __forceinline__ void tf32_dl(float (&dp)[NT][4], const unsigned (&keep)[(NT + 7) / 8],
                                        const Tf32Blocks<NB>& bk, int nt, const float* sg,
                                        const float* const (&sv)[NB], const float* P, int ldp,
                                        const int* smq, int q0, int Lq, float scale,
                                        Dropout dr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float inv_keep = 1.f / dr.keep_div;  // as in tf32_probs
  const int mq8 = round_up<8>(Lq);
  const bool hi = q0 + 16 <= mq8;  // P holds rows q0 + 8 .. q0 + 16
#pragma unroll
  for (int n = 0; n < NT; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
  for (int b = 0; b < NB; ++b)
    tf32_rows_times_rowsT<DP, NT>(sg, q0, mq8, sv[b], bk.n0[b], bk.n1[b], dp);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 1 && !hi) continue;
        const float2 pv =
            *reinterpret_cast<const float2*>(P + (q0 + g + 8 * r) * ldp + 8 * n + 2 * t);
        sum[r] = fmaf(dp[n][2 * r], pv.x, sum[r]);
        sum[r] = fmaf(dp[n][2 * r + 1], pv.y, sum[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < nt) {
      const int b = bk.of(n);
      const int L = bk.len(b);
      const int* mk = bk.mask(b);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = q0 + g + 8 * r;
        const float2 pv = r == 0 || hi
                              ? *reinterpret_cast<const float2*>(P + i * ldp + 8 * n + 2 * t)
                              : make_float2(0.f, 0.f);
        const float pr[2] = {pv.x, pv.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * r + e, j = 8 * (n - bk.first(b)) + 2 * t + e;
          float dl = 0.f;
          if (i < Lq && j < L) {
            dl = pr[e] * (dp[n][c] - sum[r]) * scale;
            if (kDrop) {
              const bool kept = (keep[n / 8] >> (4 * (n % 8) + c)) & 1u;
              dl = kept ? dl * inv_keep : 0.f;
            }
            dl = (smq[i] * mk[j]) > 0 ? dl : 0.f;
          }
          dp[n][c] = dl;
        }
      }
    }
  }
}

// Pass 2 over X, a [query][key] buffer (p or dl): for each 16 keys of each
// block, X^T . S (S = s0 for block 1, s1 for block 2) to out[block], a warp
// a tile.
template <int DP, int NB>
__device__ __forceinline__ void tf32_pass2(const float* X, int ldp, const Tf32KeyAxis& ax,
                                           const Tf32BwdArgs<NB>& a, int Lq, const float* s0,
                                           const float* s1, float* const (&out)[NB], int b,
                                           int h) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nq8 = round_up<8>(Lq) / 8, t0 = (a.L[0] + 15) / 16;
  const int ntiles = t0 + (NB > 1 ? (a.L[NB - 1] + 15) / 16 : 0);
  for (int tt = warp; tt < ntiles; tt += nwarps) {
    const bool second = NB > 1 && tt >= t0;
    const int L = second ? a.L[NB - 1] : a.L[0];
    const int k0 = 16 * (second ? tt - t0 : tt);
    float acc[DP / 8][4];
    tf32_zero<DP>(acc);
    tf32_colsT_times_rows<DP>(X, ldp, second ? ax.c0[1] : 0, k0, L, nq8, second ? s1 : s0, acc);
    float* dst = (second ? out[NB - 1] : out[0]) + ((long)b * L * a.H + h) * a.D;
    tf32_write_rows<DP>(acc, k0, L, a.D, dst, (long)a.H * a.D);
  }
}

template <int DP, int NT, int NB, bool kDrop>
__device__ __forceinline__ void tf32_attention_bwd(const Tf32BwdArgs<NB>& a) {
  constexpr int LD = DP + 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  // the block's query window: rows [zq, zq + Lq) of a.Lq
  const int zq = blockIdx.z * a.qw;
  const int Lq = min(a.qw, a.Lq - zq), D = a.D, mq8 = round_up<8>(Lq);
  const Tf32KeyAxis ax = tf32_key_axis(NB, a.L);
  const int nt = ax.nk / 8, ldp = ax.ldp;
  const long stride = (long)a.H * D;

  extern __shared__ __align__(16) float tf32_smem[];
  const float* sq[NB];
  const float* sk[NB];
  const float* sv[NB];
  float* at = tf32_smem;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    tf32_stage<DP>(a.q[i], at, b, Lq, mq8, a.H, h, D, zq, a.Lq);
    sq[i] = at;
    at += mq8 * LD;
  }
  float* sg = at;
  tf32_stage<DP>(a.g, sg, b, Lq, mq8, a.H, h, D, zq, a.Lq);
  at += mq8 * LD;
  Tf32Blocks<NB> bk;
  int* smq = reinterpret_cast<int*>(tf32_stage_keys<DP, NB>(a.k, a.v, a.L, ax, b, a.H, h, D, at,
                                                            sk, sv, bk, a.salt_h0, a.concat));
  // the masks, the keep words, then P
  unsigned* KW = reinterpret_cast<unsigned*>(
      tf32_stage_masks<NB>(a.mq, a.mk, b, Lq, smq, bk, zq, a.Lq));
  const int kwords = (ax.nk + 63) / 64;
  float* P = reinterpret_cast<float*>(KW + tf32_keep_words(Lq, ax.nk));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const Dropout dr = make_dropout(a.rate, a.keep_div, a.seed, b, gridDim.y);
  const long oq = ((long)b * a.Lq + zq) * stride + (long)h * D;
  const int lane = threadIdx.x & 31;
  // dk and dv: window 0's to the outputs, the others' to their part slots
  float* dk[NB];
  float* dv[NB];
  {
    float* part = blockIdx.z ? a.part + (blockIdx.z - 1) * tf32_part_floats(a, gridDim.y) : nullptr;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const long n = (long)gridDim.y * a.L[i] * stride;
      dk[i] = part ? part : a.dk[i];
      if (part) part += n;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const long n = (long)gridDim.y * a.L[i] * stride;
      dv[i] = part ? part : a.dv[i];
      if (part) part += n;
    }
  }
  // pass 1: p and its keep bits
  for (int q0 = warp * 16; q0 < Lq; q0 += nwarps * 16) {
    unsigned keep[(NT + 7) / 8];
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      tf32_rows_times_rowsT<DP, NT>(sq[i], q0, mq8, sk[i], bk.n0[i], bk.n1[i], s);
    tf32_probs<NT, NB, kDrop>(s, keep, bk, nt, smq, q0, Lq, a.scale, dr, zq);
    tf32_store_tile<NT>(s, nt, q0, mq8, P, ldp);
    if (kDrop) {
#pragma unroll
      for (int w = 0; w < (NT + 7) / 8; ++w)
        if (w < kwords) KW[((q0 / 16) * kwords + w) * 32 + lane] = keep[w];
    }
  }
  __syncthreads();

  // pass 2: dv = p^T g
  tf32_pass2<DP, NB>(P, ldp, ax, a, Lq, sg, sg, dv, b, h);
  __syncthreads();

  // pass 1 again: dl over p, dq = dl k
  for (int q0 = warp * 16; q0 < Lq; q0 += nwarps * 16) {
    unsigned keep[(NT + 7) / 8] = {};
    if (kDrop) {
#pragma unroll
      for (int w = 0; w < (NT + 7) / 8; ++w)
        if (w < kwords) keep[w] = KW[((q0 / 16) * kwords + w) * 32 + lane];
    }
    float dp[NT][4];
    tf32_dl<DP, NT, NB, kDrop>(dp, keep, bk, nt, sg, sv, P, ldp, smq, q0, Lq, a.scale, dr);
    __syncwarp();  // every lane has read its p before any overwrites it
    tf32_store_tile<NT>(dp, nt, q0, mq8, P, ldp);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      float acc[DP / 8][4];
      tf32_zero<DP>(acc);
      tf32_regs_times_rows<DP, NT>(dp, bk.n0[i], bk.n1[i], sk[i], acc);
      tf32_write_rows<DP>(acc, q0, Lq, D, a.dq[i] + oq, stride);
    }
  }
  __syncthreads();

  // pass 2 again: dk = dl^T q
  tf32_pass2<DP, NB>(P, ldp, ax, a, Lq, sq[0], sq[NB - 1], dk, b, h);
}

// The kernels, named for the profiler's rows: K1b's and K3b's.
template <int DP, int NT, bool kDrop>
__global__ void __launch_bounds__(kTf32BwdThreads)
two_block_bwd_tf32_kernel(const Tf32BwdArgs<2> a) {
  tf32_attention_bwd<DP, NT, 2, kDrop>(a);
}

template <int DP, int NT, bool kDrop>
__global__ void __launch_bounds__(kTf32BwdThreads)
masked_bwd_tf32_kernel(const Tf32BwdArgs<1> a) {
  tf32_attention_bwd<DP, NT, 1, kDrop>(a);
}

template <int DP, int NT, int NB, bool kDrop>
constexpr auto tf32_bwd_kernel() {
  if constexpr (NB == 2)
    return two_block_bwd_tf32_kernel<DP, NT, kDrop>;
  else
    return masked_bwd_tf32_kernel<DP, NT, kDrop>;
}

// The register tile, in n8 tiles of the key axis, that each body is
// instantiated for; calls launch(std::integral_constant<int, NT>()) with the
// least NT >= nt. At D <= 32 (the flagship's 32): one block of at most 128
// keys (K3) in 4 / 8 / 16, two (K1: pad8(L1) + pad8(L2) <= 256) in
// 6 / 18 / 32, so that the flagship's streams, (40 | 100) and (40 | 1)
// keys, fill their register tiles exactly. Head dims 16 and 64 lie on no
// path the configurations time: the largest tile only (16 / 32), which
// keeps nvcc's time down. A key axis past the largest tile is refused.
template <int NB, int DP, class Launch>
cudaError_t tf32_with_nt(int nt, Launch&& launch) {
  // past 64, K1's register tile is 18 n8 tiles (the flagship's 40 | 100
  // keys), the largest: beside the accumulator of DP / 8 n8 tiles a tile of
  // 32 spilled some 4 KB a thread at DP = 128 and took nvcc minutes
  constexpr int kMost = NB == 1 ? 16 : DP > 64 ? 18 : 32;
  if constexpr (DP == 32) {
    if (nt <= (NB == 1 ? 4 : 6)) return launch(std::integral_constant<int, NB == 1 ? 4 : 6>());
    if (nt <= (NB == 1 ? 8 : 18)) return launch(std::integral_constant<int, NB == 1 ? 8 : 18>());
  }
  if (nt <= kMost) return launch(std::integral_constant<int, kMost>());
  return cudaErrorInvalidValue;
}

// The query rows of a block (tf32_windows): all Lq where one block's
// tiles fit its shared memory, else the most rows, a multiple of 16, that
// fit (0: none), so that a head dim past 64 stages its k and v whole and
// its queries in windows of blocks of their own (grid z). The forward's
// windows share nothing; the backward's dk and dv are sums over the
// windows, each window's in a part slot of its own, added in window order
// by tf32_sum_windows (no atomics: the same bits on every run).
inline int tf32_bwd_window(int NB, int Lq, const int* L, int D) {
  if (tf32_bwd_smem_bytes(NB, Lq, L, D) <= kTf32MaxBlockSmem) return Lq;
  for (int w = (Lq - 1) / 16 * 16; w >= 16; w -= 16)
    if (tf32_bwd_smem_bytes(NB, w, L, D) <= kTf32MaxBlockSmem) return w;
  return 0;
}

// windows of qw rows over Lq (0 where qw is 0)
inline int tf32_windows(int Lq, int qw) { return qw ? (Lq + qw - 1) / qw : 0; }

// dk and dv += the part slots of windows 1 .. nz - 1, in order.
template <int NB>
__global__ void tf32_sum_windows_kernel(const Tf32BwdArgs<NB> a, int B, int nz) {
  const long slot = tf32_part_floats(a, B);
  long base = 0;
#pragma unroll
  for (int o = 0; o < 2 * NB; ++o) {
    const int i = o % NB;
    float* dst = o < NB ? a.dk[i] : a.dv[i];
    const long n = (long)B * a.L[i] * a.H * a.D;
    for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < n;
         e += (long)gridDim.x * blockDim.x) {
      float acc = dst[e];
      for (int z = 1; z < nz; ++z) acc += a.part[(z - 1) * slot + base + e];
      dst[e] = acc;
    }
    base += n;
  }
}

template <int DP, int NT, int NB, bool kDrop>
cudaError_t launch_tf32_bwd(Tf32BwdArgs<NB> a, int B, cudaStream_t stream) {
  auto kern = tf32_bwd_kernel<DP, NT, NB, kDrop>();
  a.qw = tf32_bwd_window(NB, a.Lq, a.L, a.D);
  const int nz = tf32_windows(a.Lq, a.qw);
  if (!nz || (nz > 1 && !a.part)) return cudaErrorInvalidValue;
  const size_t smem = tf32_bwd_smem_bytes(NB, a.qw, a.L, a.D);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // a warp per query tile in pass 1 and per key tile in pass 2
  const int most = 2 * (smem + 1024) > kSmBytes ? 8 : 4;
  int tiles = (a.qw + 15) / 16, ktiles = 0;
  for (int i = 0; i < NB; ++i) ktiles += (a.L[i] + 15) / 16;
  tiles = tiles > ktiles ? tiles : ktiles;
  const int warps = tiles < most ? tiles : most;
  kern<<<dim3(a.H, B, nz), 32 * warps, smem, stream>>>(a);
  if (nz > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    tf32_sum_windows_kernel<NB><<<4 * 132, 256, 0, stream>>>(a, B, nz);
  }
  return cudaGetLastError();
}

// The body at head dim DP with dropout (kDrop) or without: a library may
// instantiate the two in files of their own, compiled side by side
// (two_block_attention_bwd.d64.cu, .d64_drop.cu...).
template <int NB, int DP, bool kDrop>
cudaError_t launch_tf32_bwd_drop(const Tf32BwdArgs<NB>& a, int B, cudaStream_t s) {
  return tf32_with_nt<NB, DP>(tf32_key_axis(NB, a.L).nk / 8, [&](auto nt) {
    return launch_tf32_bwd<DP, decltype(nt)::value, NB, kDrop>(a, B, s);
  });
}

template <int NB, int DP>
cudaError_t launch_tf32_bwd_nt(const Tf32BwdArgs<NB>& a, int B, cudaStream_t s) {
  return a.rate > 0.f ? launch_tf32_bwd_drop<NB, DP, true>(a, B, s)
                      : launch_tf32_bwd_drop<NB, DP, false>(a, B, s);
}

// Whether the bodies above take a shape (tf32_whole, below), else the
// key-chunk path (tf32_chunked.cu).
inline bool tf32_whole(int NB, int Lq, const int* L, int D, bool bwd);
template <int NB>
cudaError_t launch_tf32_chunked_bwd(const Tf32BwdArgs<NB>& a, int B, cudaStream_t s);

template <int NB>
cudaError_t launch_tf32_attention_bwd(const Tf32BwdArgs<NB>& a, int B, cudaStream_t s) {
  if (!tf32_whole(NB, a.Lq, a.L, a.D, true)) return launch_tf32_chunked_bwd<NB>(a, B, s);
  switch (tf32_dp(a.D)) {
    case 16: return launch_tf32_bwd_nt<NB, 16>(a, B, s);
    case 32: return launch_tf32_bwd_nt<NB, 32>(a, B, s);
    case 64: return launch_tf32_bwd_nt<NB, 64>(a, B, s);
    case 96: return launch_tf32_bwd_nt<NB, 96>(a, B, s);
    case 128: return launch_tf32_bwd_nt<NB, 128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// Forward: K1f (NB = 2) and K3f (NB = 1)

// a warp per 16-row query tile, at most four
constexpr int kTf32FwdWarps = 4;

template <int NB> struct Tf32FwdArgs {
  const float* q[NB];
  const float* k[NB];
  const float* v[NB];
  const int* mq;
  const int* mk[NB];
  float* out;
  int Lq, L[NB], H, D;
  float scale, rate, keep_div;
  unsigned seed;
  int qw;  // set by the launcher: the query rows of a block (tf32_windows)
  int salt_h0, concat;  // as Tf32BwdArgs's
};

// q of each block (pad8(Lq) rows), k and v (pad8(L_b) rows) and the masks.
__host__ __device__ inline size_t tf32_fwd_smem_bytes(int NB, int Lq, const int* L, int D) {
  const int LD = tf32_dp(D) + 4, mq8 = round_up<8>(Lq);
  size_t floats = (size_t)NB * mq8 * LD, ints = mq8;
  for (int b = 0; b < NB; ++b) {
    floats += 2 * (size_t)round_up<8>(L[b]) * LD;
    ints += round_up<8>(L[b]);
  }
  return sizeof(float) * floats + sizeof(int) * ints;
}

template <int DP, int NT, int NB, bool kDrop>
__device__ __forceinline__ void tf32_attention_fwd(const Tf32FwdArgs<NB>& a) {
  constexpr int LD = DP + 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the block's query window: rows [zq, zq + Lq) of a.Lq
  const int zq = blockIdx.z * a.qw;
  const int Lq = min(a.qw, a.Lq - zq), D = a.D, mq8 = round_up<8>(Lq);
  const Tf32KeyAxis ax = tf32_key_axis(NB, a.L);
  const int nt = ax.nk / 8;

  extern __shared__ __align__(16) float tf32_smem[];
  const float* sq[NB];
  const float* sk[NB];
  const float* sv[NB];
  float* at = tf32_smem;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    tf32_stage<DP>(a.q[i], at, b, Lq, mq8, a.H, h, D, zq, a.Lq);
    sq[i] = at;
    at += mq8 * LD;
  }
  Tf32Blocks<NB> bk;
  int* smq = reinterpret_cast<int*>(tf32_stage_keys<DP, NB>(a.k, a.v, a.L, ax, b, a.H, h, D, at,
                                                            sk, sv, bk, a.salt_h0, a.concat));
  tf32_stage_masks<NB>(a.mq, a.mk, b, Lq, smq, bk, zq, a.Lq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const Dropout dr = make_dropout(a.rate, a.keep_div, a.seed, b, gridDim.y);
  // the tile's q rows of block 1, read by this warp alone, hold its output
  // on the way out
  float* so = tf32_smem;
  for (int q0 = warp * 16; q0 < Lq; q0 += nwarps * 16) {
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      tf32_rows_times_rowsT<DP, NT>(sq[i], q0, mq8, sk[i], bk.n0[i], bk.n1[i], s);
    unsigned keep[(NT + 7) / 8];  // the backward's
    tf32_probs<NT, NB, kDrop>(s, keep, bk, nt, smq, q0, Lq, a.scale, dr, zq);
    float o[DP / 8][4];
    tf32_zero<DP>(o);
#pragma unroll
    for (int i = 0; i < NB; ++i) tf32_regs_times_rows<DP, NT>(s, bk.n0[i], bk.n1[i], sv[i], o);
    __syncwarp();  // every lane has read its q rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + g + 8 * r;
      if (row < mq8) {
#pragma unroll
        for (int dn = 0; dn < DP / 8; ++dn)
          *reinterpret_cast<float2*>(so + row * LD + 8 * dn + 2 * t) =
              make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
      }
    }
    __syncwarp();
    const int chunks = D / 4;  // 16-byte chunks of an output row
    for (int c = lane; c < 16 * chunks; c += 32) {
      const int r = c / chunks, kc = c - r * chunks, i = q0 + r;
      if (i < Lq)
        *reinterpret_cast<float4*>(a.out + (((long)b * a.Lq + zq + i) * a.H + h) * D + 4 * kc) =
            *reinterpret_cast<const float4*>(so + i * LD + 4 * kc);
    }
  }
}

// The kernels, named for the profiler's rows: K1f's and K3f's.
template <int DP, int NT, bool kDrop>
__global__ void __launch_bounds__(32 * kTf32FwdWarps)
two_block_fwd_tf32_kernel(const Tf32FwdArgs<2> a) {
  tf32_attention_fwd<DP, NT, 2, kDrop>(a);
}

template <int DP, int NT, bool kDrop>
__global__ void __launch_bounds__(32 * kTf32FwdWarps)
masked_fwd_tf32_kernel(const Tf32FwdArgs<1> a) {
  tf32_attention_fwd<DP, NT, 1, kDrop>(a);
}

template <int DP, int NT, int NB, bool kDrop>
constexpr auto tf32_fwd_kernel() {
  if constexpr (NB == 2)
    return two_block_fwd_tf32_kernel<DP, NT, kDrop>;
  else
    return masked_fwd_tf32_kernel<DP, NT, kDrop>;
}

inline int tf32_fwd_window(int NB, int Lq, const int* L, int D) {
  if (tf32_fwd_smem_bytes(NB, Lq, L, D) <= kTf32MaxBlockSmem) return Lq;
  for (int w = (Lq - 1) / 16 * 16; w >= 16; w -= 16)
    if (tf32_fwd_smem_bytes(NB, w, L, D) <= kTf32MaxBlockSmem) return w;
  return 0;
}

// The key-chunk path (tf32_chunked.cu): any lengths, kTf32ChunkKeys keys
// of one block at a time with an online softmax, the queries in windows
// of kTf32ChunkRows rows (a warp per 16; the backward's block walks its
// windows in order and adds their dk and dv in place). Its kernels are
// compiled once (core/build.py links them into every library).
constexpr int kTf32ChunkNT = 8;                        // n8 key tiles a chunk
constexpr int kTf32ChunkKeys = 8 * kTf32ChunkNT;       // 64 keys
constexpr int kTf32ChunkWarps = 4;
constexpr int kTf32ChunkRows = 16 * kTf32ChunkWarps;   // 64 query rows

// The bodies above take a shape where its key axis fits their register
// tile (tf32_with_nt), a query window's tiles fit one block and, for K3
// and for K1b, every length is at most 128 (the lengths they are tested
// at); core/attention.py tf32_whole holds the same rule.
inline bool tf32_whole(int NB, int Lq, const int* L, int D, bool bwd) {
  const int dp = tf32_dp(D);
  const int most = NB == 1 ? 16 : dp > 64 ? 18 : 32;
  int lmax = Lq;
  for (int b = 0; b < NB; ++b) lmax = L[b] > lmax ? L[b] : lmax;
  if (!dp || tf32_key_axis(NB, L).nk / 8 > most) return false;
  if ((NB == 1 || bwd) && lmax > 128) return false;
  return (bwd ? tf32_bwd_window(NB, Lq, L, D) : tf32_fwd_window(NB, Lq, L, D)) > 0;
}

template <int NB>
cudaError_t launch_tf32_chunked_fwd(const Tf32FwdArgs<NB>& a, int B, cudaStream_t s);

template <int DP, int NT, int NB>
cudaError_t launch_tf32_fwd(Tf32FwdArgs<NB> a, int B, cudaStream_t stream) {
  auto kern = a.rate > 0.f ? tf32_fwd_kernel<DP, NT, NB, true>()
                           : tf32_fwd_kernel<DP, NT, NB, false>();
  a.qw = tf32_fwd_window(NB, a.Lq, a.L, a.D);
  const int nz = tf32_windows(a.Lq, a.qw);
  if (!nz) return cudaErrorInvalidValue;
  const size_t smem = tf32_fwd_smem_bytes(NB, a.qw, a.L, a.D);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.qw + 15) / 16;  // Lq = 1 runs one warp, and no warp idles
  const int warps = tiles < kTf32FwdWarps ? tiles : kTf32FwdWarps;
  kern<<<dim3(a.H, B, nz), 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NB, int DP>
cudaError_t launch_tf32_fwd_nt(const Tf32FwdArgs<NB>& a, int B, cudaStream_t s) {
  return tf32_with_nt<NB, DP>(tf32_key_axis(NB, a.L).nk / 8, [&](auto nt) {
    return launch_tf32_fwd<DP, decltype(nt)::value, NB>(a, B, s);
  });
}

// Refuses (cudaErrorInvalidValue) a head dim past 128 or not a multiple of
// 4; a shape the bodies above do not take runs on the key-chunk path.
template <int NB>
cudaError_t launch_tf32_attention_fwd(const Tf32FwdArgs<NB>& a, int B, cudaStream_t s) {
  if (!tf32_whole(NB, a.Lq, a.L, a.D, false)) return launch_tf32_chunked_fwd<NB>(a, B, s);
  switch (tf32_dp(a.D)) {
    case 16: return launch_tf32_fwd_nt<NB, 16>(a, B, s);
    case 32: return launch_tf32_fwd_nt<NB, 32>(a, B, s);
    case 64: return launch_tf32_fwd_nt<NB, 64>(a, B, s);
    case 96: return launch_tf32_fwd_nt<NB, 96>(a, B, s);
    case 128: return launch_tf32_fwd_nt<NB, 128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace segmm
