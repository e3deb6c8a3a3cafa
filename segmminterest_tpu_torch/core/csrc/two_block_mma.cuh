// The two-block joint-softmax core of K2 in bf16 on the tensor cores, both
// directions (proj_two_block_attention*.cu), over the bf16 q/k/v that
// qkv_gemm_kernel (proj_gemm.cuh) writes: xq's (B, Lq, 2d) rows hold q1 |
// q2, x1's k1 | v1 and x2's k2 | v2, head h at columns h D and d + h D.
// bf16 K1 (and bf16 K3 past its own body) runs on it too, over its six
// (B, L, H, D) tensors (K2CoreArgs: six operand pointers, one row stride),
// K1b's gradients stored in bf16 (the backward's TY).
//
// Lengths. The bodies below hold the whole key axis in a register tile
// and one (head, batch row)'s tiles in one block: the model's streams.
// Every other shape (k2_core_whole) runs the key-chunk path,
// two_block_chunked.cu: an online softmax over chunks of 128 keys, the
// queries in windows of 64 rows.
//
// Function (attention.py _fp_fwd_kernel :776 / _fp_bwd_kernel :808 after
// their projections, with _joint_probs :374 and _attn_group_bwd :448):
//   l = q1 k1^T | q2 k2^T, fill -10000 where mq x mk is 0 (before the
//   scale), in training keep ? l / (1 - rate) : 0 with the keep bits of
//   salt 2h (block 1) / 2h + 1 (block 2), the key counted within its block,
//   x scale, one fp32 softmax over both blocks;
//   forward: p rounded to bf16, out = p1 v1 + p2 v2 in fp32, cast;
//   backward: p recomputed in fp32, dv = p^T g, dp = g v^T,
//   s = sum dp p over both blocks, dl = p (dp - s) scale, dropout mask and
//   divisor, pair mask, dq_b = dl_b k_b, dk_b = dl_b^T q_b, each in fp32.
// A fully padded query row keeps its -10000 logits: the uniform softmax of
// a constant over L1 + L2 keys, as on the TPU.
//
// Numerics. q, k, v and g are bf16 values, so every product with them as
// both operands (S, dp) is exact-input bf16 mma.sync m16n8k16 with fp32
// accumulators; the forward's p is rounded to bf16 before p v, as the JAX
// kernel does. The backward keeps p and dl at fp32 accuracy as bf16 hi and
// lo halves, both through the tensor cores into one accumulator (~2^-17
// relative), as K3b's bf16 body does (masked_attention_bwd.cu). K4b's
// g (d_att) is fp32, as the TPU kernel keeps it (layer_kernel.py:427):
// staged as bf16 hi and lo halves too, each product with g (dv, dp) takes
// both.
//
// Geometry of one (batch row, head), a block of its own (no atomics, the
// same order of every sum on every run):
//   * both key blocks on one axis: block 1 at columns [0, L1) of a span of
//     c1 = pad8(L1), block 2 from c1, nk16 = pad16(c1 + L2) columns, so
//     that each n8 tile belongs to one block; k and v as one [key][d] tile
//     each, zero past each block's length;
//   * bf16 tiles of row stride D + 8 (masked_attention_mma.cuh), staged by
//     cp.async 16 bytes a thread; q1, q2 (and g) over pad16(Lq) rows;
//   * a warp per 16-row query tile: S in registers (q1 or q2 as the A
//     fragment by the n8 tile's block), the softmax in registers (quad
//     shuffles), p's C tiles as p v's A fragments;
//   * the backward as tf32_attention.cuh's, with one [query][key] buffer
//     (bf16 hi and lo planes) for p, then dl: pass 1 p and its keep bits;
//     pass 2 (a warp per 16 keys) dv = p^T g; pass 1 again dp, dl over p,
//     dq_b from dl's registers masked to block b's tiles; pass 2 again
//     dk = dl^T q_b, a 16-key tile across the block boundary taking q1 for
//     its first 8 keys and q2 for the rest.
// Head dims 16, 32, 48, 64, 96 and 128 (SEGMM_K2_HEAD_DIMS; m16n8k16
// steps over D, its n8 tiles in pairs). Past 64 the backward's tiles no
// longer fit one block staged at once: at (100, 40, 100) and D = 128 they
// and the [query][key] planes take 241,536 bytes (K4b's fp32 g: 272,000)
// against 232,448. Of the ways to cut them (the planes per 16-row tile,
// q2 left unstaged, the query tiles over two blocks with dk and dv summed
// after), the kernel stages its operands in turns (k2_load_restaged), as
// each pass needs only some of them: pass 1 q1, q2 and k; passes 2 and 1
// again g and v (in q2's and q1's place) and k; pass 2 again q1 and q2 (in
// v's and k's place). That keeps one block per (head, batch row), its
// passes and every sum's order, and costs q1 and q2 read twice (from L2)
// and two more barriers; the tiles take 2 max(pad16(Lq), key axis) +
// pad16(Lq) rows (+ pad16(Lq) for an fp32 g): 180,608 bytes at (100, 40,
// 100) and D = 128, 211,072 with K4b's g. The planes per tile would have
// needed a pass order of its own for dv and dk, and two blocks a sum
// kernel and a scratch of dk and dv. At 64 and below nothing changes. The
// wide head dims hold 6 or 18 n8 key tiles in registers (kK2WideKeys16):
// the output accumulator of D / 8 n8 tiles (64 floats a lane at 128)
// beside a logit tile of 32 spilled, and the flagship's streams need 18.
// The forward takes K6's dropout keys too (kKeys) and K5's second stream
// (dual_stream_core_fwd_kernel, salts from head H), as the backward does.
// What bounds it on an H100: device memory. The forward reads q, k, v
// (0.38 GB at B=1024, (40, 40, 100), 16 heads of 32) and writes out (0.04
// GB): ~0.13 ms at 3.35 TB/s; the backward also reads g and writes six fp32
// gradients (0.75 GB).
#pragma once

#include <type_traits>

#include "masked_attention_mma.cuh"

namespace segmm {

constexpr int kK2MmaWarps = 4;     // a block's warps, or
constexpr int kK2MmaWarpsMax = 8;  // where one block fills an SM
constexpr size_t kK2SmBytes = 233472;  // an H100 SM's shared memory, 1 KB a block reserved

__host__ __device__ inline int k2_c1(int L1) { return (L1 + 7) & ~7; }
__host__ __device__ inline int k2_keys16(int L1, int L2) { return pad16(k2_c1(L1) + L2); }

// The operands of one launch: q1, q2 (B, Lq, .), k1, v1 (B, L1, .), k2, v2
// (B, L2, .), head h at column h D of rows of stride rs (bf16 K2, K4, K5
// and K6: the projections' (B, L, 2d) workspaces, q2 = q1 + d, v = k + d,
// rs = 2d; bf16 K1: six (B, L, H, D) tensors, rs = d = H D), the masks,
// and the output (forward) or g and the six gradients (backward: dq1 dq2
// dk1 dk2 dv1 dv2 as (B, L, d), fp32 for K2's chain or bf16 for K1b, the
// launch's TY). g is bf16 (K2b), or an fp32 g given as bf16 hi and lo
// halves (K4b's d_att: g and glo), as the core keeps p and dl.
struct K2CoreArgs {
  const __nv_bfloat16 *q1, *q2, *k1, *v1, *k2, *v2;
  long rs;
  const int *mq, *mk1, *mk2;
  __nv_bfloat16* out;       // forward: (B, Lq, d)
  const __nv_bfloat16* g;   // backward: (B, Lq, d)
  const __nv_bfloat16* glo; // backward with an fp32 g: its lo half, (B, Lq, d)
  void* dy[6];
  int Lq, L1, L2, H;
  float scale, rate, keep_div;
  unsigned seed;
  // The key-chunk path only (two_block_chunked.cu), set at run time: the
  // dropout salts' first head (K5's user stream: H), K6's keys (concat),
  // bf16 gradients (dy_bf16), and where those span several query windows
  // an fp32 scratch of dk1, dk2, dv1, dv2 (B, L, d) that the windows sum
  // into before the cast (acc).
  int salt_h0, concat, dy_bf16;
  float* acc;
};

// 32-bit keep words a lane holds per 16-row query tile (4 bits an n8 tile)
__host__ __device__ inline int k2_keep_words(int nk16) { return (nk16 / 8 + 7) / 8; }

__host__ __device__ inline size_t k2_core_fwd_smem_bytes(int Lq, int L1, int L2, int D) {
  const int mq16 = pad16(Lq), nk16 = k2_keys16(L1, L2);
  return sizeof(__nv_bfloat16) * (size_t)(2 * mq16 + 2 * nk16) * (D + 8) +
         sizeof(int) * (size_t)(mq16 + nk16) +
         sizeof(unsigned) * (size_t)kK2MmaWarps * k2_keep_words(nk16) * 32;
}

// Head dims past this stage the backward's operands in turns (k2_core_bwd):
// q1, q2 and k for pass 1, then g and v in q1's and q2's place, then q1
// and q2 again in v's and k's place.
constexpr int kK2RestageD = 64;

// bf16 rows of the backward's tiles: all at once (D <= kK2RestageD: q1, q2,
// g (and glo) over pad16(Lq) rows, k and v over the key axis), or in turns
// (two regions of max(pad16(Lq), key axis) rows, q2's / g's region of
// pad16(Lq) rows, and glo's).
__host__ __device__ inline int k2_bwd_tile_rows(int mq16, int nk16, int D, bool glo) {
  if (D <= kK2RestageD) return (glo ? 4 : 3) * mq16 + 2 * nk16;
  const int big = mq16 > nk16 ? mq16 : nk16;
  return 2 * big + (glo ? 2 : 1) * mq16;
}

__host__ __device__ inline size_t k2_core_bwd_smem_bytes(int Lq, int L1, int L2, int D,
                                                         bool glo = false) {
  const int mq16 = pad16(Lq), nk16 = k2_keys16(L1, L2);
  return sizeof(__nv_bfloat16) * (size_t)k2_bwd_tile_rows(mq16, nk16, D, glo) * (D + 8) +
         sizeof(int) * (size_t)(mq16 + nk16) +
         sizeof(unsigned) * (size_t)(mq16 / 16) * k2_keep_words(nk16) * 32 +
         sizeof(__nv_bfloat16) * 2 * (size_t)mq16 * (nk16 + 8);
}

// Rows [0, L) of batch row b of a (B, L, rs) bf16 tensor, columns
// [col, col + D), into a tile of `rows` rows of ld D + 8; zeros past L.
// Only issues the copies.
template <int D>
__device__ __forceinline__ void k2_stage(const __nv_bfloat16* __restrict__ src, long rs, int col,
                                         __nv_bfloat16* dst, int b, int L, int rows) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks, k = c - r * kChunks;
    const bool ok = r < L;
    cp_async16(dst + r * (D + 8) + k * 8, ok ? src + ((long)b * L + r) * rs + col + k * 8 : src,
               ok);
  }
}

__device__ __forceinline__ void k2_stage_mask(const int* __restrict__ src, int* dst, int b, int L,
                                              int rows) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    cp_async4(dst + i, i < L ? src + (long)b * L + i : src, i < L);
}

// The staged operands of one (batch row, head); with a.glo, g's lo half in
// glo.
struct K2Tiles {
  __nv_bfloat16 *q1, *q2, *g, *glo, *k, *v;
  int *mq, *mk;
  int c1, nk16;
};

// Stages q1, q2 (and g, with its lo half where given), k and v of both
// blocks on one axis and the masks (the key mask on the same axis, 0 past
// each block's length) at `smem`; returns the first byte past them. Waits
// for the copies; the caller synchronises the block.
template <int D>
__device__ __forceinline__ unsigned char* k2_load(const K2CoreArgs& a, unsigned char* smem,
                                                  bool with_g, K2Tiles& t, bool glo = false) {
  constexpr int LD = D + 8;
  const int h = blockIdx.x, b = blockIdx.y;
  const int dm = a.H * D;
  const long rs = a.rs;
  const int mq16 = pad16(a.Lq);
  t.c1 = k2_c1(a.L1);
  t.nk16 = k2_keys16(a.L1, a.L2);
  __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(smem);
  t.q1 = at;
  t.q2 = t.q1 + mq16 * LD;
  t.g = with_g ? t.q2 + mq16 * LD : nullptr;
  t.glo = with_g && glo ? t.g + mq16 * LD : nullptr;
  t.k = t.q2 + (1 + (with_g ? 1 : 0) + (t.glo ? 1 : 0)) * mq16 * LD;
  t.v = t.k + t.nk16 * LD;
  t.mq = reinterpret_cast<int*>(t.v + t.nk16 * LD);
  t.mk = t.mq + mq16;
  k2_stage<D>(a.q1, rs, h * D, t.q1, b, a.Lq, mq16);
  k2_stage<D>(a.q2, rs, h * D, t.q2, b, a.Lq, mq16);
  if (with_g) k2_stage<D>(a.g, dm, h * D, t.g, b, a.Lq, mq16);
  if (t.glo) k2_stage<D>(a.glo, dm, h * D, t.glo, b, a.Lq, mq16);
  k2_stage<D>(a.k1, rs, h * D, t.k, b, a.L1, t.c1);
  k2_stage<D>(a.k2, rs, h * D, t.k + t.c1 * LD, b, a.L2, t.nk16 - t.c1);
  k2_stage<D>(a.v1, rs, h * D, t.v, b, a.L1, t.c1);
  k2_stage<D>(a.v2, rs, h * D, t.v + t.c1 * LD, b, a.L2, t.nk16 - t.c1);
  k2_stage_mask(a.mq, t.mq, b, a.Lq, mq16);
  k2_stage_mask(a.mk1, t.mk, b, a.L1, t.c1);
  k2_stage_mask(a.mk2, t.mk + t.c1, b, a.L2, t.nk16 - t.c1);
  cp_async_commit();
  cp_async_wait<0>();
  return reinterpret_cast<unsigned char*>(t.mk + t.nk16);
}

// One key-axis operand of both blocks (k1 | k2, or with v v1 | v2, head
// h = blockIdx.x) into a tile of t.nk16 rows, zeros past each block's
// length. Only issues the copies.
template <int D>
__device__ __forceinline__ void k2_stage_keys(const K2CoreArgs& a, bool v, __nv_bfloat16* dst,
                                              const K2Tiles& t) {
  const int b = blockIdx.y, col = blockIdx.x * D;
  k2_stage<D>(v ? a.v1 : a.k1, a.rs, col, dst, b, a.L1, t.c1);
  k2_stage<D>(v ? a.v2 : a.k2, a.rs, col, dst + t.c1 * (D + 8), b, a.L2, t.nk16 - t.c1);
}

// The backward's first operands when they are staged in turns (D >
// kK2RestageD): q1 in region A (v's later, then q1's again), q2 in region
// B (g's later), k in region K (q2's at the end), glo (with `glo`) and the
// masks; returns the first byte past them. Waits for the copies; the
// caller synchronises the block.
template <int D>
__device__ __forceinline__ unsigned char* k2_load_restaged(const K2CoreArgs& a,
                                                           unsigned char* smem, K2Tiles& t,
                                                           bool glo) {
  constexpr int LD = D + 8;
  const int h = blockIdx.x, b = blockIdx.y;
  const int dm = a.H * D;
  const int mq16 = pad16(a.Lq);
  t.c1 = k2_c1(a.L1);
  t.nk16 = k2_keys16(a.L1, a.L2);
  const int big = mq16 > t.nk16 ? mq16 : t.nk16;
  t.q1 = t.v = reinterpret_cast<__nv_bfloat16*>(smem);
  t.q2 = t.g = t.q1 + big * LD;
  t.k = t.q2 + mq16 * LD;
  t.glo = glo ? t.k + big * LD : nullptr;
  t.mq = reinterpret_cast<int*>(t.k + (big + (glo ? mq16 : 0)) * LD);
  t.mk = t.mq + mq16;
  k2_stage<D>(a.q1, a.rs, h * D, t.q1, b, a.Lq, mq16);
  k2_stage<D>(a.q2, a.rs, h * D, t.q2, b, a.Lq, mq16);
  k2_stage_keys<D>(a, false, t.k, t);
  if (glo) k2_stage<D>(a.glo, dm, h * D, t.glo, b, a.Lq, mq16);
  k2_stage_mask(a.mq, t.mq, b, a.Lq, mq16);
  k2_stage_mask(a.mk1, t.mk, b, a.L1, t.c1);
  k2_stage_mask(a.mk2, t.mk + t.c1, b, a.L2, t.nk16 - t.c1);
  cp_async_commit();
  cp_async_wait<0>();
  return reinterpret_cast<unsigned char*>(t.mk + t.nk16);
}

// acc[n] += q_b[q0 .. q0 + 16) . k[8n .. 8n + 8)^T over D for the n8 tiles
// of nkc 16-key chunks, q_b = q1 for the tiles of block 1 (n < c1 / 8),
// q2 for block 2's.
template <int D, int NT>
__device__ __forceinline__ void k2_logits(const __nv_bfloat16* sq1, const __nv_bfloat16* sq2,
                                          int q0, const __nv_bfloat16* sk, int c1, int nkc,
                                          float (&acc)[NT][4]) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31;
  const int nb1 = c1 / 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a1[4], a2[4];
    const int at = (q0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(a1, sq1 + at);
    ldsm_x4(a2, sq2 + at);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (n / 2 < nkc) {
        unsigned bb[4];
        ldsm_x4(bb, sk + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        unsigned a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = n < nb1 ? a1[i] : a2[i];
          c[i] = n + 1 < nb1 ? a1[i] : a2[i];
        }
        mma_bf16(acc[n], a, bb[0], bb[1]);
        mma_bf16(acc[n + 1], c, bb[2], bb[3]);
      }
    }
  }
}

// How the dropout hash counts a key: kBlockKeys, K2's (and K4's, K5's):
// salt 2h for block 1 and 2h + 1 for block 2, the key counted within its
// block (attention.py:791-796); kConcatKeys, K6's: one key axis of L1 + L2
// keys, salt h, block 2's key j at L1 + j (attention.py:1236-1239). Only
// k2_key reads it: K2's instances compile as they did without it.
enum K2Keys : int { kBlockKeys = 0, kConcatKeys = 1 };

// Key j of the axis: its block's length, its index within the block, the
// index and salt its dropout bit is hashed with.
struct K2Key {
  int len, j, hj;
  unsigned salt;
};
template <int kKeys = kBlockKeys>
__device__ __forceinline__ K2Key k2_key(int j, int c1, int L1, int L2, int h) {
  const bool second = j >= c1;
  const int jj = second ? j - c1 : j;
  if (kKeys == kConcatKeys)
    return K2Key{second ? L2 : L1, jj, second ? L1 + jj : jj, (unsigned)h};
  return K2Key{second ? L2 : L1, jj, jj, 2u * h + (second ? 1u : 0u)};
}

// The dropout keep bits of this lane's elements of query tile q0 (n8 tile
// n, element c: word n / 8, bit 4 (n % 8) + c; 0 past each block's length)
// into kw[w * 32], w < kwords; h is the salt's head (K5's user stream
// counts from H). The hash sits in the code eight times, not
// once an element of the logit tile: unrolled over every element (in
// k2_probs) it made the backward core ~2x slower than without dropout,
// and a trivial hash in its place was as slow, so the cost was the code's
// size, not the hash's arithmetic. The forward, a smaller kernel, was
// ~15% faster fully unrolled; one way for both is kept.
template <int kKeys = kBlockKeys>
__device__ __forceinline__ void k2_keep_bits(unsigned* kw, int kwords, int q0, int c1, int L1,
                                             int L2, int nkc, Dropout dr, int h) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int w = 0; w < kwords; ++w) {
    unsigned word = 0u;
#pragma unroll 8
    for (int e = 0; e < 32; ++e) {
      const int n = 8 * w + (e >> 2), c = e & 3;
      if (n >= 2 * nkc) break;
      const K2Key key = k2_key<kKeys>(n * 8 + 2 * t + (c & 1), c1, L1, L2, h);
      if (key.j < key.len && dropout_keep(dr, q0 + g + 8 * (c >> 1), key.hj, key.salt))
        word |= 1u << e;
    }
    kw[w * 32] = word;
  }
}

// The logit tile s -> probabilities in fp32 over both blocks (fill, the
// keep bits of k2_keep_bits, scale, one softmax; keys past their block's
// length get p = 0 and take no part in the max or the sum).
template <int NT, bool kDrop>
__device__ __forceinline__ void k2_probs(float (&s)[NT][4], const unsigned (&keep)[(NT + 7) / 8],
                                         const int* smq, const int* smk, int q0, int c1, int L1,
                                         int L2, int nkc, float scale, Dropout dr, int h) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + g, q0 + g + 8};
  const int mqr[2] = {smq[rows[0]], smq[rows[1]]};
  const float inv_keep = 1.f / dr.keep_div;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n / 2 < nkc) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, j = n * 8 + 2 * t + (c & 1);
        const K2Key key = k2_key(j, c1, L1, L2, h);
        float l = -INFINITY;
        if (key.j < key.len) {
          l = (mqr[r] * smk[j]) > 0 ? s[n][c] : kMaskFill;
          if (kDrop) l = (keep[n / 8] >> (4 * (n % 8) + c)) & 1u ? l * inv_keep : 0.f;
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
    if (n / 2 < nkc) {
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
    sum[r] = 1.f / sum[r];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n / 2 < nkc) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] *= sum[c >> 1];
    }
  }
}

// acc[dn] += X . S over the keys of the n8 tiles t0 <= n < t1: X (16 query
// rows x 8 NT keys) in registers, as bf16 hi + lo halves, the other tiles
// as 0; S a [key][d] tile.
template <int D, int NT>
__device__ __forceinline__ void k2_regs_times_rows(const float (&x)[NT][4], int t0, int t1,
                                                   int nkc, const __nv_bfloat16* st,
                                                   float (&acc)[D / 8][4]) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kj = 0; kj < NT / 2; ++kj) {
    const bool on0 = 2 * kj >= t0 && 2 * kj < t1, on1 = 2 * kj + 1 >= t0 && 2 * kj + 1 < t1;
    if (kj < nkc && (on0 || on1)) {
      float h[8], l[8];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        split_bf16(on0 ? x[2 * kj][c] : 0.f, h[c], l[c]);
        split_bf16(on1 ? x[2 * kj + 1][c] : 0.f, h[4 + c], l[4 + c]);
      }
      unsigned hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hi[r] = pack_bf16(h[2 * r], h[2 * r + 1]);
        lo[r] = pack_bf16(l[2 * r], l[2 * r + 1]);
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        unsigned bb[4];
        ldsm_x4_t(bb, st + (16 * kj + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 8 +
                          (lane >> 4) * 8);
        mma_bf16(acc[dn], hi, bb[0], bb[1]);
        mma_bf16(acc[dn + 1], hi, bb[2], bb[3]);
        mma_bf16(acc[dn], lo, bb[0], bb[1]);
        mma_bf16(acc[dn + 1], lo, bb[2], bb[3]);
      }
    }
  }
}

template <int D> __device__ __forceinline__ void k2_zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
}

// Row `row` (< L) of a 16 x D accumulator tile (its half r) to dst (D
// contiguous values): fp32 (K2's chain), or rounded to bf16 (K1b).
template <int D, typename TY>
__device__ __forceinline__ void k2_write_row(const float (&acc)[D / 8][4], int r, TY* dst) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    if constexpr (std::is_same<TY, float>::value)
      *reinterpret_cast<float2*>(dst + dn * 8 + 2 * t) =
          make_float2(acc[dn][2 * r], acc[dn][2 * r + 1]);
    else
      *reinterpret_cast<unsigned*>(dst + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][2 * r], acc[dn][2 * r + 1]);
  }
}

// Query rows q0 + g, q0 + g + 8 (those < Lq) of head h of batch row b.
template <int D, typename TY>
__device__ __forceinline__ void k2_write_q_rows(const float (&acc)[D / 8][4], int q0, int Lq,
                                                int H, TY* dst) {
  const int g = (threadIdx.x & 31) >> 2, h = blockIdx.x, b = blockIdx.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + g + 8 * r;
    if (i < Lq) k2_write_row<D, TY>(acc, r, dst + (((long)b * Lq + i) * H + h) * D);
  }
}

// Key rows k0 + g, k0 + g + 8 of the axis, each to its block's gradient
// (d1 for block 1, d2 for block 2), those within their block's length.
template <int D, typename TY>
__device__ __forceinline__ void k2_write_key_rows(const float (&acc)[D / 8][4], int k0, int c1,
                                                  int L1, int L2, int H, TY* d1, TY* d2) {
  const int g = (threadIdx.x & 31) >> 2, h = blockIdx.x, b = blockIdx.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + g + 8 * r;
    const bool second = j >= c1;
    const int jj = second ? j - c1 : j, L = second ? L2 : L1;
    if (jj < L)
      k2_write_row<D, TY>(acc, r, (second ? d2 : d1) + (((long)b * L + jj) * H + h) * D);
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (head, batch row), a warp per 16-row query tile.
// kKeys: how the dropout hash counts the keys (K2Keys); h: the head the
// dropout salts count from (blockIdx.x, or K5's user stream's H +
// blockIdx.x).
template <int D, int NT, bool kDrop, int kKeys>
__device__ __forceinline__ void k2_core_fwd(const K2CoreArgs& a, int h) {
  constexpr int LD = D + 8;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  extern __shared__ __align__(16) unsigned char k2f_smem[];
  K2Tiles st;
  const int kwords = k2_keep_words(k2_keys16(a.L1, a.L2));
  // the warp's keep words after the masks
  unsigned* kw = reinterpret_cast<unsigned*>(k2_load<D>(a, k2f_smem, false, st)) +
                 warp * kwords * 32 + lane;
  __syncthreads();
  const int nkc = st.nk16 / 16;
  const Dropout dr = make_dropout(a.rate, a.keep_div, a.seed, b, gridDim.y);
  for (int q0 = warp * 16; q0 < a.Lq; q0 += nwarps * 16) {
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    k2_logits<D, NT>(st.q1, st.q2, q0, st.k, st.c1, nkc, s);
    unsigned keep[(NT + 7) / 8] = {};
    if (kDrop) {
      k2_keep_bits<kKeys>(kw, kwords, q0, st.c1, a.L1, a.L2, nkc, dr, h);
#pragma unroll
      for (int w = 0; w < (NT + 7) / 8; ++w)
        if (w < kwords) keep[w] = kw[w * 32];
    }
    k2_probs<NT, kDrop>(s, keep, st.mq, st.mk, q0, st.c1, a.L1, a.L2, nkc, a.scale, dr, h);
    float o[D / 8][4];
    k2_zero<D>(o);
    k3_regs_times_rows<D, NT, false>(s, nkc, st.v, o);
    // the tile's q1 rows, read by this warp alone, hold its output on the
    // way out
    __syncwarp();
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<unsigned*>(st.q1 + (q0 + g) * LD + dn * 8 + 2 * t) =
          pack_bf16(o[dn][0], o[dn][1]);
      *reinterpret_cast<unsigned*>(st.q1 + (q0 + g + 8) * LD + dn * 8 + 2 * t) =
          pack_bf16(o[dn][2], o[dn][3]);
    }
    __syncwarp();
    for (int c = lane; c < 16 * (D / 8); c += 32) {
      const int r = c / (D / 8), kc = c - r * (D / 8);
      const int i = q0 + r;
      if (i < a.Lq)
        *reinterpret_cast<uint4*>(a.out + (((long)b * a.Lq + i) * a.H + blockIdx.x) * D +
                                  kc * 8) =
            *reinterpret_cast<const uint4*>(st.q1 + i * LD + kc * 8);
    }
  }
}

template <int D, int NT, bool kDrop, int kKeys>
__global__ void __launch_bounds__(32 * kK2MmaWarps)
proj_two_block_core_fwd_kernel(const __grid_constant__ K2CoreArgs a) {
  k2_core_fwd<D, NT, kDrop, kKeys>(a, blockIdx.x);
}

// K5f's core: both streams of a layer in one launch, grid z = 2, as
// dual_stream_core_bwd_kernel below (the user stream salted from head H).
template <int D, int NT, bool kDrop>
__global__ void __launch_bounds__(32 * kK2MmaWarps)
dual_stream_core_fwd_kernel(const __grid_constant__ K2CoreArgs a,
                            const __grid_constant__ K2CoreArgs u) {
  const bool user = blockIdx.z != 0;
  k2_core_fwd<D, NT, kDrop, kBlockKeys>(user ? u : a, blockIdx.x + (user ? a.H : 0));
}

// ---------------------------------------------------------------------------
// Backward: one block per (head, batch row); passes as the file's head says.
// kG32: g is fp32, given as bf16 hi and lo halves (a.g, a.glo), and the
// products with g (dv, dp) take both halves into one accumulator. kKeys:
// how the dropout hash counts the keys (K2Keys). sh: the head the dropout
// salts count from (blockIdx.x, or K5's user stream's H + blockIdx.x). TY:
// the gradients' type (fp32 for K2's chain, bf16 for K1b).
template <int D, int NT, bool kDrop, bool kG32, int kKeys, typename TY>
__device__ __forceinline__ void k2_core_bwd(const K2CoreArgs& a, int sh) {
  TY* const* dy = reinterpret_cast<TY* const*>(a.dy);
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int gi = lane >> 2, ti = lane & 3;
  extern __shared__ __align__(16) unsigned char k2b_smem[];
  // head dims past kK2RestageD stage q1, q2 and k, then g and v, then q1
  // and q2 (k2_load_restaged)
  constexpr bool kRestage = D > kK2RestageD;
  K2Tiles st;
  unsigned char* past;
  if constexpr (kRestage)
    past = k2_load_restaged<D>(a, k2b_smem, st, kG32);
  else
    past = k2_load<D>(a, k2b_smem, true, st, kG32);
  unsigned* KW = reinterpret_cast<unsigned*>(past);
  const int Lq = a.Lq, L1 = a.L1, L2 = a.L2, c1 = st.c1;
  const int mq16 = pad16(Lq), nkc = st.nk16 / 16, nq16 = mq16 / 16, nb1 = c1 / 8;
  const int kwords = k2_keep_words(st.nk16);
  const int ldp = st.nk16 + 8;
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(KW + nq16 * kwords * 32);
  __nv_bfloat16* pl = ph + mq16 * ldp;
  __syncthreads();
  const Dropout dr = make_dropout(a.rate, a.keep_div, a.seed, b, gridDim.y);
  const float inv_keep = 1.f / dr.keep_div;

  // pass 1: p (rows past Lq zero) and its keep bits
  for (int q0 = warp * 16; q0 < Lq; q0 += nwarps * 16) {
    float p[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
    k2_logits<D, NT>(st.q1, st.q2, q0, st.k, c1, nkc, p);
    unsigned keep[(NT + 7) / 8] = {};
    if (kDrop) {
      unsigned* kw = KW + (q0 / 16) * kwords * 32 + lane;
      k2_keep_bits<kKeys>(kw, kwords, q0, c1, L1, L2, nkc, dr, sh);
#pragma unroll
      for (int w = 0; w < (NT + 7) / 8; ++w)
        if (w < kwords) keep[w] = kw[w * 32];
    }
    k2_probs<NT, kDrop>(p, keep, st.mq, st.mk, q0, c1, L1, L2, nkc, a.scale, dr, sh);
    const bool live[2] = {q0 + gi < Lq, q0 + gi + 8 < Lq};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (!live[c >> 1]) p[n][c] = 0.f;
    k3b_store_split<NT>(p, q0, nkc, ph, pl, ldp);
  }
  __syncthreads();
  if constexpr (kRestage) {  // g in q2's place, v in q1's
    k2_stage<D>(a.g, a.H * D, blockIdx.x * D, st.g, b, Lq, mq16);
    k2_stage_keys<D>(a, true, st.v, st);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // pass 2: dv = p^T g
  for (int k0 = warp * 16; k0 < st.nk16; k0 += nwarps * 16) {
    float acc[D / 8][4];
    k2_zero<D>(acc);
    k3b_colsT_times_rows<D>(ph, pl, ldp, k0, nq16, st.g, acc);
    if (kG32) k3b_colsT_times_rows<D>(ph, pl, ldp, k0, nq16, st.glo, acc);
    k2_write_key_rows<D, TY>(acc, k0, c1, L1, L2, a.H, dy[4], dy[5]);
  }
  __syncthreads();

  // pass 1 again: dp = g v^T, dl over p, dq1 and dq2
  for (int q0 = warp * 16; q0 < Lq; q0 += nwarps * 16) {
    unsigned keep[(NT + 7) / 8] = {};
    if (kDrop) {
#pragma unroll
      for (int w = 0; w < (NT + 7) / 8; ++w)
        if (w < kwords) keep[w] = KW[((q0 / 16) * kwords + w) * 32 + lane];
    }
    float dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    k3_rows_times_rowsT<D, NT>(st.g, q0, st.v, nkc, dp);
    if (kG32) k3_rows_times_rowsT<D, NT>(st.glo, q0, st.v, nkc, dp);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n / 2 < nkc) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 pv = k3b_load_split(ph, pl, (q0 + gi + 8 * r) * ldp + n * 8 + 2 * ti);
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
    // dl in place of dp; p is 0 past each block's length and past Lq, and
    // the pair mask is 0 there too
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
            const int c = 2 * r + e, j = n * 8 + 2 * ti + e;
            float dl = pr[e] * (dp[n][c] - sum[r]) * a.scale;
            if (kDrop) dl = (keep[n / 8] >> (4 * (n % 8) + c)) & 1u ? dl * inv_keep : 0.f;
            dp[n][c] = (st.mq[i] * st.mk[j]) > 0 ? dl : 0.f;
          }
        }
      }
    }
    __syncwarp();  // every lane has read its p before any overwrites it
    k3b_store_split<NT>(dp, q0, nkc, ph, pl, ldp);
    float acc[D / 8][4];
    k2_zero<D>(acc);
    k2_regs_times_rows<D, NT>(dp, 0, nb1, nkc, st.k, acc);
    k2_write_q_rows<D, TY>(acc, q0, Lq, a.H, dy[0]);
    k2_zero<D>(acc);
    k2_regs_times_rows<D, NT>(dp, nb1, 2 * nkc, nkc, st.k, acc);
    k2_write_q_rows<D, TY>(acc, q0, Lq, a.H, dy[1]);
  }
  __syncthreads();
  if constexpr (kRestage) {  // q1 in v's place, q2 in k's
    st.q2 = st.k;
    k2_stage<D>(a.q1, a.rs, blockIdx.x * D, st.q1, b, Lq, mq16);
    k2_stage<D>(a.q2, a.rs, blockIdx.x * D, st.q2, b, Lq, mq16);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // pass 2 again: dk = dl^T q1 (block 1's keys), dl^T q2 (block 2's)
  for (int k0 = warp * 16; k0 < st.nk16; k0 += nwarps * 16) {
    const bool lo2 = k0 >= c1, hi2 = k0 + 8 >= c1;  // its halves in block 2
    float acc[D / 8][4];
    k2_zero<D>(acc);
    if (!lo2 || !hi2) k3b_colsT_times_rows<D>(ph, pl, ldp, k0, nq16, st.q1, acc, !lo2, !hi2);
    if (lo2 || hi2) k3b_colsT_times_rows<D>(ph, pl, ldp, k0, nq16, st.q2, acc, lo2, hi2);
    k2_write_key_rows<D, TY>(acc, k0, c1, L1, L2, a.H, dy[2], dy[3]);
  }
}

template <int D, int NT, bool kDrop, bool kG32, int kKeys, typename TY>
__global__ void __launch_bounds__(32 * kK2MmaWarpsMax)
proj_two_block_core_bwd_kernel(const __grid_constant__ K2CoreArgs a) {
  k2_core_bwd<D, NT, kDrop, kG32, kKeys, TY>(a, blockIdx.x);
}

// K5b's core: both streams of a layer in one launch, grid z = 2 (z = 0 the
// video stream a, z = 1 the user stream u, whose dropout salts count from
// head H: 2 (H + h) + block, dual_kernel.py:100-101). The streams share
// their key axis (L1 = Lv, L2 = Lu) and differ in Lq.
template <int D, int NT, bool kDrop>
__global__ void __launch_bounds__(32 * kK2MmaWarpsMax)
dual_stream_core_bwd_kernel(const __grid_constant__ K2CoreArgs a,
                            const __grid_constant__ K2CoreArgs u) {
  const bool user = blockIdx.z != 0;
  k2_core_bwd<D, NT, kDrop, false, kBlockKeys, float>(user ? u : a,
                                                    blockIdx.x + (user ? a.H : 0));
}

// ---------------------------------------------------------------------------
// Host side

// A launch's arguments over the projections' outputs ws (xq's, x1's, x2's:
// (B, L, 2 dm) each); the caller sets out, or g and dy.
inline K2CoreArgs k2_core_args(void* const* ws, int dm, const int* mq, const int* mk1,
                               const int* mk2, int Lq, int L1, int L2, int H, float scale,
                               float rate, float keep_div, unsigned seed) {
  K2CoreArgs a{};
  const __nv_bfloat16* w[3] = {static_cast<const __nv_bfloat16*>(ws[0]),
                               static_cast<const __nv_bfloat16*>(ws[1]),
                               static_cast<const __nv_bfloat16*>(ws[2])};
  a.q1 = w[0];
  a.q2 = w[0] + dm;
  a.k1 = w[1];
  a.v1 = w[1] + dm;
  a.k2 = w[2];
  a.v2 = w[2] + dm;
  a.rs = 2L * dm;
  a.mq = mq;
  a.mk1 = mk1;
  a.mk2 = mk2;
  a.Lq = Lq;
  a.L1 = L1;
  a.L2 = L2;
  a.H = H;
  a.scale = scale;
  a.rate = rate;
  a.keep_div = keep_div;
  a.seed = seed;
  return a;
}

// A backward block's warps: one per query or key tile, at most four, eight
// where one block fills an SM.
inline int k2_bwd_warps(int tiles, size_t smem) {
  const int cap = 2 * (smem + 1024) > kK2SmBytes ? kK2MmaWarpsMax : kK2MmaWarps;
  return tiles < cap ? tiles : cap;
}

// The register tiles of head dim D: 6, 12, 18, 24 and 32 n8 key tiles at
// 16, 32 and 64; at the other head dims 6 and 18 only (the flagship's
// streams: 48 and 144 keys), which keeps nvcc's time down.
template <int D> constexpr bool kK2AllTiles = D == 16 || D == 32 || D == 64;
constexpr int kK2WideKeys16 = 9;

// ---------------------------------------------------------------------------
// The key-chunk path (two_block_chunked.cu): a key axis past the register
// tile, or tiles past one block's shared memory, in chunks of kK2ChunkKeys
// keys with an online softmax, the queries in windows of kK2ChunkRows rows
// (a warp per 16). Its kernels are compiled once (core/build.py links the
// object into every library of the core) and take the launch's options at
// run time.
constexpr int kK2ChunkNT = 16;                       // n8 key tiles of a chunk
constexpr int kK2ChunkKeys = 8 * kK2ChunkNT;         // 128 keys
constexpr int kK2ChunkWarps = 4;
constexpr int kK2ChunkRows = 16 * kK2ChunkWarps;     // a query window: 64 rows
constexpr size_t kK2MaxBlockSmem = 232448;           // what one block may use

__host__ __device__ inline int k2_chunk_windows(int Lq) {
  return (Lq + kK2ChunkRows - 1) / kK2ChunkRows;
}

// The key-chunk path's shared memory: bf16 tiles of row stride D + 8, q1,
// q2 (and g, with g32 its lo half) over a window, k and v over a chunk;
// the masks; the backward's hi / lo planes of p and dl over window x chunk.
__host__ __device__ inline size_t k2_chunked_smem_bytes(int D, bool bwd, bool g32) {
  const int qt = bwd ? (g32 ? 4 : 3) : 2;
  size_t n = sizeof(__nv_bfloat16) * (size_t)(qt * kK2ChunkRows + 2 * kK2ChunkKeys) * (D + 8) +
             sizeof(int) * (size_t)(kK2ChunkRows + kK2ChunkKeys);
  if (bwd) n += sizeof(__nv_bfloat16) * 2 * (size_t)kK2ChunkRows * (kK2ChunkKeys + 8);
  return n;
}

// Whether the core takes a shape in one chunk (the whole key axis in the
// register tile, every tile of one (head, batch row) in one block's shared
// memory): the bodies above, as they run at the model's streams. Every
// other shape runs the key-chunk path. core/attention.py k2_core_whole
// holds the same rule.
__host__ __device__ inline bool k2_core_whole(int Lq, int L1, int L2, int D, bool bwd, bool g32) {
  const int nkc = k2_keys16(L1, L2) / 16;
  const int tiles = (D == 16 || D == 32 || D == 64) ? 16 : kK2WideKeys16;
  const size_t smem =
      bwd ? k2_core_bwd_smem_bytes(Lq, L1, L2, D, g32) : k2_core_fwd_smem_bytes(Lq, L1, L2, D);
  return nkc <= tiles && smem <= kK2MaxBlockSmem;
}

// A block's shared memory on the path the shape takes.
__host__ __device__ inline size_t k2_core_smem_bytes(int Lq, int L1, int L2, int D, bool bwd,
                                                     bool g32 = false) {
  if (!k2_core_whole(Lq, L1, L2, D, bwd, g32)) return k2_chunked_smem_bytes(D, bwd, g32);
  return bwd ? k2_core_bwd_smem_bytes(Lq, L1, L2, D, g32) : k2_core_fwd_smem_bytes(Lq, L1, L2, D);
}

// The key-chunk path in either direction for head dim D
// (SEGMM_K2_HEAD_DIMS): forward grid (H, B, windows), backward (H, B), one
// block walking the windows in order. a.glo set: the backward's g is fp32
// (K4b). a.dy_bf16 with several windows needs a.acc. Defined in
// two_block_chunked.cu.
cudaError_t launch_k2_chunked(const K2CoreArgs& a, int D, bool bwd, int B, cudaStream_t stream);

// n8 key tiles the templates hold in registers (2 x the 16-key chunks)
template <int D, bool kBwd, bool kG32, int kKeys, int NT, typename TY>
cudaError_t launch_k2_core_nt(const K2CoreArgs& a, int B, cudaStream_t stream) {
  size_t smem;
  void (*kern)(K2CoreArgs);
  if constexpr (kBwd) {
    smem = k2_core_bwd_smem_bytes(a.Lq, a.L1, a.L2, D, kG32);
    kern = a.rate > 0.f ? proj_two_block_core_bwd_kernel<D, NT, true, kG32, kKeys, TY>
                        : proj_two_block_core_bwd_kernel<D, NT, false, kG32, kKeys, TY>;
  } else {
    smem = k2_core_fwd_smem_bytes(a.Lq, a.L1, a.L2, D);
    kern = a.rate > 0.f ? proj_two_block_core_fwd_kernel<D, NT, true, kKeys>
                        : proj_two_block_core_fwd_kernel<D, NT, false, kKeys>;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // a warp per query tile (forward), or per query or key tile (backward):
  // at most four, eight where one block fills an SM
  const int qt = pad16(a.Lq) / 16, kt = k2_keys16(a.L1, a.L2) / 16;
  const int warps = kBwd ? k2_bwd_warps(qt > kt ? qt : kt, smem)
                         : (qt < kK2MmaWarps ? qt : kK2MmaWarps);
  kern<<<dim3(a.H, B), 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool kBwd, bool kG32, int kKeys, typename TY>
cudaError_t launch_k2_core_d(const K2CoreArgs& a, int B, cudaStream_t stream) {
  const int nkc = k2_keys16(a.L1, a.L2) / 16;
  if (nkc <= 3) return launch_k2_core_nt<D, kBwd, kG32, kKeys, 6, TY>(a, B, stream);
  if constexpr (kK2AllTiles<D>) {
    if (nkc <= 6) return launch_k2_core_nt<D, kBwd, kG32, kKeys, 12, TY>(a, B, stream);
    if (nkc <= 9) return launch_k2_core_nt<D, kBwd, kG32, kKeys, 18, TY>(a, B, stream);
    if (nkc <= 12) return launch_k2_core_nt<D, kBwd, kG32, kKeys, 24, TY>(a, B, stream);
    return launch_k2_core_nt<D, kBwd, kG32, kKeys, 32, TY>(a, B, stream);
  } else {
    return launch_k2_core_nt<D, kBwd, kG32, kKeys, 18, TY>(a, B, stream);
  }
}

// The head dims the core takes (m16n8k16 steps over D; D / 8 n8 tiles in
// pairs): 16, 32, 48, 64, 96, 128. The backward stages its operands in
// turns past kK2RestageD.
#define SEGMM_K2_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(96) X(128)

// K2's core in either direction for head dim D (SEGMM_K2_HEAD_DIMS), any
// lengths: in one chunk where k2_core_whole takes the shape, else on the
// key-chunk path. kG32 (backward): g is fp32, as a.g and a.glo. kKeys: the
// dropout's key indexing, K2Keys. TY (backward): the gradients' type.
template <bool kBwd, bool kG32 = false, int kKeys = kBlockKeys, typename TY = float>
cudaError_t launch_k2_core(const K2CoreArgs& a, int D, int B, cudaStream_t stream) {
  if (!k2_core_whole(a.Lq, a.L1, a.L2, D, kBwd, kG32)) {
    K2CoreArgs c = a;
    c.concat = kKeys == kConcatKeys;
    c.dy_bf16 = !std::is_same<TY, float>::value;
    if (!kG32) c.glo = nullptr;
    return launch_k2_chunked(c, D, kBwd, B, stream);
  }
  switch (D) {
#define SEGMM_K2_CASE(d) \
  case d: return launch_k2_core_d<d, kBwd, kG32, kKeys, TY>(a, B, stream);
    SEGMM_K2_HEAD_DIMS(SEGMM_K2_CASE)
#undef SEGMM_K2_CASE
    default: return cudaErrorInvalidValue;
  }
}

// K5's two streams, a (video) and u (user), on one key axis, in one launch
// (grid z = 2) with the larger stream's shared memory and warps.
template <int D, int NT, bool kBwd>
cudaError_t launch_dual_core_nt(const K2CoreArgs& a, const K2CoreArgs& u, int B,
                                cudaStream_t stream) {
  size_t sa, su;
  void (*kern)(K2CoreArgs, K2CoreArgs);
  if constexpr (kBwd) {
    sa = k2_core_bwd_smem_bytes(a.Lq, a.L1, a.L2, D);
    su = k2_core_bwd_smem_bytes(u.Lq, u.L1, u.L2, D);
    kern = a.rate > 0.f ? dual_stream_core_bwd_kernel<D, NT, true>
                        : dual_stream_core_bwd_kernel<D, NT, false>;
  } else {
    sa = k2_core_fwd_smem_bytes(a.Lq, a.L1, a.L2, D);
    su = k2_core_fwd_smem_bytes(u.Lq, u.L1, u.L2, D);
    kern = a.rate > 0.f ? dual_stream_core_fwd_kernel<D, NT, true>
                        : dual_stream_core_fwd_kernel<D, NT, false>;
  }
  const size_t smem = sa > su ? sa : su;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int lq = a.Lq > u.Lq ? a.Lq : u.Lq;
  const int qt = pad16(lq) / 16, kt = k2_keys16(a.L1, a.L2) / 16;
  const int warps = kBwd ? k2_bwd_warps(qt > kt ? qt : kt, smem)
                         : (qt < kK2MmaWarps ? qt : kK2MmaWarps);
  kern<<<dim3(a.H, B, 2), 32 * warps, smem, stream>>>(a, u);
  return cudaGetLastError();
}

template <int D, bool kBwd>
cudaError_t launch_dual_core_d(const K2CoreArgs& a, const K2CoreArgs& u, int B,
                               cudaStream_t stream) {
  const int nkc = k2_keys16(a.L1, a.L2) / 16;
  if (nkc <= 3) return launch_dual_core_nt<D, 6, kBwd>(a, u, B, stream);
  if constexpr (kK2AllTiles<D>) {
    if (nkc <= 6) return launch_dual_core_nt<D, 12, kBwd>(a, u, B, stream);
    if (nkc <= 9) return launch_dual_core_nt<D, 18, kBwd>(a, u, B, stream);
    if (nkc <= 12) return launch_dual_core_nt<D, 24, kBwd>(a, u, B, stream);
    return launch_dual_core_nt<D, 32, kBwd>(a, u, B, stream);
  } else {
    return launch_dual_core_nt<D, 18, kBwd>(a, u, B, stream);
  }
}

// K5's core in either direction for head dim D (SEGMM_K2_HEAD_DIMS): the
// video stream a (Lq = L1) and the user stream u (Lq = L2) over the same
// key blocks, any lengths: one launch where k2_core_whole takes both
// streams, else each stream on the key-chunk path (u salted from head H).
template <bool kBwd>
cudaError_t launch_dual_core(const K2CoreArgs& a, const K2CoreArgs& u, int D, int B,
                             cudaStream_t stream) {
  if (a.L1 != u.L1 || a.L2 != u.L2 || a.H != u.H) return cudaErrorInvalidValue;
  if (!k2_core_whole(a.Lq, a.L1, a.L2, D, kBwd, false) ||
      !k2_core_whole(u.Lq, u.L1, u.L2, D, kBwd, false)) {
    K2CoreArgs c = u;
    c.salt_h0 = u.H;
    cudaError_t err = launch_k2_chunked(a, D, kBwd, B, stream);
    return err != cudaSuccess ? err : launch_k2_chunked(c, D, kBwd, B, stream);
  }
  switch (D) {
#define SEGMM_K2_CASE(d) \
  case d: return launch_dual_core_d<d, kBwd>(a, u, B, stream);
    SEGMM_K2_HEAD_DIMS(SEGMM_K2_CASE)
#undef SEGMM_K2_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace segmm
