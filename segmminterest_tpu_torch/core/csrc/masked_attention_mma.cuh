// Shared device code of K3f and K3b in bf16 on the tensor cores
// (masked_attention.cu, masked_attention_bwd.cu): staging of one head's rows
// by cp.async, the 16-row tile products on mma.sync m16n8k16 (mma_sync.cuh
// gives the fragment layout), and the masked softmax of a logit tile held in
// fp32 accumulator registers.
//
// Tiles live in shared memory as bf16 rows of ld = D + 8 elements (2D + 16
// bytes: 16-byte aligned for ldmatrix and cp.async, and the eight rows of
// one 8x8 matrix fall in eight different 4-bank groups). A tile of L rows
// has pad16(L) rows; the rows past L are zero, so that a padded key or query
// adds 0 to a product instead of a stale NaN.
//
// A warp owns 16 query rows. Its logits are NT n8 tiles of keys, NT even and
// 8 NT >= Lk: s[n][c] holds query row q0 + g + 8 (c / 2) and key
// 8 n + 2t + (c % 2) (g = lane / 4, t = lane % 4).
#pragma once

#include "joint_attention.cuh"
#include "mma_sync.cuh"

namespace segmm {

constexpr int kK3MmaWarps = 4;
constexpr int kK3MmaThreads = 32 * kK3MmaWarps;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// Rows [0, L) of head h of batch row b of a (B, L, H, D) bf16 tensor into a
// tile of `rows` rows of ld = D + 8; rows [L, rows) are zero-filled. Only
// issues the copies: the caller commits and waits.
template <int D>
__device__ __forceinline__ void k3_stage(const __nv_bfloat16* __restrict__ src,
                                         __nv_bfloat16* dst, int b, int L, int rows, int H,
                                         int h) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks, k = c - r * kChunks;
    const bool ok = r < L;
    const __nv_bfloat16* s = ok ? src + (((long)b * L + r) * H + h) * D + k * 8 : src;
    cp_async16(dst + r * (D + 8) + k * 8, s, ok);
  }
}

// One batch row's staged inputs: q (and g, in the backward) over pad16(Lq)
// rows, k and v over pad16(Lk), the two masks (int32, zero past their
// lengths).
struct K3Stage {
  __nv_bfloat16 *q, *g, *k, *v;
  int *mq, *mk;
};

__host__ __device__ inline size_t k3_stage_bytes(int Lq, int Lk, int D, bool with_g) {
  return sizeof(__nv_bfloat16) * (size_t)((with_g ? 2 : 1) * pad16(Lq) + 2 * pad16(Lk)) *
             (D + 8) +
         sizeof(int) * (size_t)(pad16(Lq) + pad16(Lk));
}

__device__ __forceinline__ K3Stage k3_stage_at(unsigned char* base, int Lq, int Lk, int D,
                                               bool with_g) {
  const int mq16 = pad16(Lq), mk16 = pad16(Lk);
  K3Stage st;
  st.q = reinterpret_cast<__nv_bfloat16*>(base);
  st.g = with_g ? st.q + mq16 * (D + 8) : nullptr;
  st.k = st.q + (with_g ? 2 : 1) * mq16 * (D + 8);
  st.v = st.k + mk16 * (D + 8);
  st.mq = reinterpret_cast<int*>(st.v + mk16 * (D + 8));
  st.mk = st.mq + mq16;
  return st;
}

// Copies batch row b's inputs (head h) into `st`, by cp.async, and waits
// for them; the caller synchronises the block.
template <int D>
__device__ __forceinline__ void k3_load(const K3Stage& st, const __nv_bfloat16* q,
                                        const __nv_bfloat16* g, const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, const int* mq, const int* mk,
                                        int b, int Lq, int Lk, int H, int h) {
  const int mq16 = pad16(Lq), mk16 = pad16(Lk);
  k3_stage<D>(q, st.q, b, Lq, mq16, H, h);
  if (st.g) k3_stage<D>(g, st.g, b, Lq, mq16, H, h);
  k3_stage<D>(k, st.k, b, Lk, mk16, H, h);
  k3_stage<D>(v, st.v, b, Lk, mk16, H, h);
  for (int i = threadIdx.x; i < mq16; i += blockDim.x)
    cp_async4(st.mq + i, i < Lq ? mq + (long)b * Lq + i : mq, i < Lq);
  for (int j = threadIdx.x; j < mk16; j += blockDim.x)
    cp_async4(st.mk + j, j < Lk ? mk + (long)b * Lk + j : mk, j < Lk);
  cp_async_commit();
  cp_async_wait<0>();
}

// acc[n] += A[q0 .. q0 + 16) . B[8n .. 8n + 8)^T over D: A rows from tile
// `sa` (queries), B rows from tile `sb` (keys), both [row][d]. Only the
// first 2 nk16 key tiles are computed (the rest of acc is left as it is).
template <int D, int NT>
__device__ __forceinline__ void k3_rows_times_rowsT(const __nv_bfloat16* sa, int q0,
                                                    const __nv_bfloat16* sb, int nk16,
                                                    float (&acc)[NT][4]) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(a, sa + (q0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (n / 2 < nk16) {
        // matrices: keys 8n.. with d 0-7 and 8-15, keys 8n+8.. with both
        unsigned bb[4];
        ldsm_x4(bb, sb + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(acc[n], a, bb[0], bb[1]);
        mma_bf16(acc[n + 1], a, bb[2], bb[3]);
      }
    }
  }
}

// acc[dn] += X . S over the keys: X (16 query rows x 8 NT keys) in
// registers in the logit layout, S a [key][d] tile; X goes to the tensor
// cores rounded to bf16, or with kSplit as hi = bf16(x) and lo = bf16(x - hi)
// into the same accumulator (about 2^-17 relative to the fp32 x).
template <int D, int NT, bool kSplit>
__device__ __forceinline__ void k3_regs_times_rows(const float (&x)[NT][4], int nk16,
                                                   const __nv_bfloat16* st,
                                                   float (&acc)[D / 8][4]) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kj = 0; kj < NT / 2; ++kj) {
    if (kj < nk16) {
      // a[0..1] from key tile 2kj, a[2..3] from key tile 2kj + 1
      unsigned hi[4], lo[4];
      if (kSplit) {
        float h[8], l[8];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          split_bf16(x[2 * kj][c], h[c], l[c]);
          split_bf16(x[2 * kj + 1][c], h[4 + c], l[4 + c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          hi[r] = pack_bf16(h[2 * r], h[2 * r + 1]);
          lo[r] = pack_bf16(l[2 * r], l[2 * r + 1]);
        }
      } else {
        hi[0] = pack_bf16(x[2 * kj][0], x[2 * kj][1]);
        hi[1] = pack_bf16(x[2 * kj][2], x[2 * kj][3]);
        hi[2] = pack_bf16(x[2 * kj + 1][0], x[2 * kj + 1][1]);
        hi[3] = pack_bf16(x[2 * kj + 1][2], x[2 * kj + 1][3]);
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        // matrices (transposed): keys 16kj.. and 16kj+8.. of d-tile dn, then
        // of d-tile dn + 1
        unsigned bb[4];
        ldsm_x4_t(bb, st + (16 * kj + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 8 +
                          (lane >> 4) * 8);
        mma_bf16(acc[dn], hi, bb[0], bb[1]);
        mma_bf16(acc[dn + 1], hi, bb[2], bb[3]);
        if (kSplit) {
          mma_bf16(acc[dn], lo, bb[0], bb[1]);
          mma_bf16(acc[dn + 1], lo, bb[2], bb[3]);
        }
      }
    }
  }
}

// The logit tile s (q . k^T in fp32) -> probabilities in fp32, as
// _fwd_kernel (attention.py:141-150): fill -10000 where mq x mk is 0, in
// training keep ? l / (1 - rate) : 0 (salt h), x scale, softmax over the Lk
// keys. Keys j >= Lk, there only because Lk is rounded up to a tile, get
// p = 0 and take no part in the max or the sum; a fully padded query row
// keeps its -10000 logits and becomes the uniform softmax over Lk. The
// row max and sum are taken over the four lanes that share a row; each
// exponential is multiplied by the reciprocal of its row's sum (within an
// fp32 ulp of the division). Key tiles past 2 nk16 are left as they are.
// Returns the dropout keep bits (bit 4n + c; 0 without dropout).
template <int NT, bool kDrop>
__device__ __forceinline__ unsigned long long k3_probs(float (&s)[NT][4], const int* smq,
                                                       const int* smk, int q0, int Lk,
                                                       int nk16, float scale, Dropout dr,
                                                       unsigned salt) {
  static_assert(NT * 4 <= 64, "keep bits fit one 64-bit word");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + g, q0 + g + 8};
  const int mqr[2] = {smq[rows[0]], smq[rows[1]]};
  unsigned long long keep = 0;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n / 2 < nk16) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, j = n * 8 + 2 * t + (c & 1);
        float l = -INFINITY;
        if (j < Lk) {
          l = (mqr[r] * smk[j]) > 0 ? s[n][c] : kMaskFill;
          if (kDrop) {
            const bool kept = dropout_keep(dr, rows[r], j, salt);
            keep |= (unsigned long long)kept << (4 * n + c);
            l = kept ? l / dr.keep_div : 0.f;
          }
          l *= scale;
        }
        s[n][c] = l;
        mx[r] = fmaxf(mx[r], l);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n / 2 < nk16) {
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
    if (n / 2 < nk16) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] *= sum[c >> 1];
    }
  }
  return keep;
}

}  // namespace segmm
