// The body of bf16 K4's epilogue at one geometry (layer_mma.cuh has the
// design): included by layer_mma.cuh once per geometry, inside a namespace
// that defines kLmRows, kLmWarpsN and kLmNT. Not a header of its own.

// kLmRows, kLmWarpsN and kLmNT come from the namespace that includes this
// file (layer_mma.cuh): rows of a block, warps across the columns, n8
// tiles of a warp's accumulator
constexpr int kLmThreads = 512;
constexpr int kLmWarps = kLmThreads / 32;
constexpr int kLmMaxN = 8 * kLmNT * kLmWarpsN;  // the widest d and ff
static_assert(kLmRows == 32 * (kLmWarps / kLmWarpsN), "32 rows a warp");
constexpr int kLmK = 32;                // depth of a stage
constexpr int kLmStages = 3;
constexpr int kLmLdNK = kLmK + 8;     // bf16 [row][k]: A, and W (N, K) in the forward
constexpr int kLmLdKN = kLmMaxN + 8;  // bf16 [k][n]: W (K, N) in the backward
constexpr int kLmLdA32 = kLmK + 8;    // fp32 [row][k]: A in the backward
constexpr int kLmTnBytes = (kLmRows + kLmMaxN) * kLmLdNK * 2;
constexpr int kLmNnBytes = kLmRows * kLmLdA32 * 4 + kLmK * kLmLdKN * 2;
constexpr int kLmStageBytes = kLmTnBytes > kLmNnBytes ? kLmTnBytes : kLmNnBytes;
// shared memory: the ring (also the epilogues' tile), in the backward
// LN1's row statistics and the three bf16 planes of a stage's fp32 A, then
// the bias and LayerNorm vectors
constexpr size_t kLmRingBytes = (size_t)kLmStages * kLmStageBytes;
constexpr size_t kLmStatsBytes = sizeof(float) * 2 * kLmRows;
constexpr size_t kLmPlaneBytes = 3 * sizeof(bf16) * kLmRows * kLmLdNK;
constexpr size_t kLmVecsBytes = sizeof(float) * 7 * kLmMaxN;  // LmVecs
constexpr size_t kLmFwdSmemBytes = kLmRingBytes + kLmVecsBytes;
constexpr size_t kLmBwdSmemBytes = kLmRingBytes + kLmStatsBytes + kLmPlaneBytes + kLmVecsBytes;

// Warp w's 32 x 8 kLmNT accumulator tile, rows 32 (w / kLmWarpsN),
// columns 8 kLmNT (w % kLmWarpsN): [m16 i][n8 j][4]; element (i, j, c) is
// row 32 (w / kLmWarpsN) + 16 i + g + 8 (c / 2), column 8 kLmNT
// (w % kLmWarpsN) + 8 j + 2 t + c % 2.
using LmAcc = float[2][kLmNT][4];

__device__ __forceinline__ int lm_wm() { return (threadIdx.x >> 5) / kLmWarpsN; }
__device__ __forceinline__ int lm_wn() { return (threadIdx.x >> 5) % kLmWarpsN; }

__device__ __forceinline__ void lm_zero(LmAcc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kLmNT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

__device__ __forceinline__ int lm_row(int i, int c) {
  return 32 * lm_wm() + 16 * i + ((threadIdx.x & 31) >> 2) + 8 * (c >> 1);
}
__device__ __forceinline__ int lm_col(int j) {
  return 8 * kLmNT * lm_wn() + 8 * j + 2 * (threadIdx.x & 3);
}

// acc += A . W^T: A the block's rows (nrows valid, row stride K) bf16, W
// (N, K) bf16 in nn.Linear layout, i.e. the [n][k] operand; rows of W past
// N read as 0.
struct LmTnOp {
  static constexpr int kStages = kLmStages, kStageBytes = kLmStageBytes;
  const bf16* a;
  const bf16* w;
  int nrows, K, N;

  __device__ __forceinline__ void issue(unsigned char* st, int step) const {
    bf16* sa = reinterpret_cast<bf16*>(st);
    bf16* sw = sa + kLmRows * kLmLdNK;
    const int k0 = step * kLmK;
    for (int c = threadIdx.x; c < (kLmRows + kLmMaxN) * (kLmK / 8); c += kLmThreads) {
      const bool isw = c >= kLmRows * (kLmK / 8);
      const int cc = isw ? c - kLmRows * (kLmK / 8) : c;
      const int r = cc / (kLmK / 8), k = (cc % (kLmK / 8)) * 8;
      const bool ok = r < (isw ? N : nrows);
      const bf16* src = (isw ? w : a) + (long)r * K + k0 + k;
      cp_async16((isw ? sw : sa) + r * kLmLdNK + k, ok ? src : a, ok);
    }
  }

  __device__ __forceinline__ void compute(const unsigned char* st, LmAcc& acc) const {
    const bf16* sa = reinterpret_cast<const bf16*>(st);
    const bf16* sw = sa + kLmRows * kLmLdNK;
    const int lane = threadIdx.x & 31, wm = lm_wm(), wn = lm_wn();
#pragma unroll
    for (int kk = 0; kk < kLmK; kk += 16) {
      unsigned b[kLmNT][2];
#pragma unroll
      for (int j = 0; j < kLmNT; j += 2) {
        unsigned r[4];
        ldsm_x4(r, sw + (8 * kLmNT * wn + 8 * j + (lane & 7) + ((lane >> 4) << 3)) * kLmLdNK + kk +
                       ((lane >> 3) & 1) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        unsigned a[4];
        ldsm_x4(a, sa + (32 * wm + 16 * i + (lane & 15)) * kLmLdNK + kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < kLmNT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
};

// acc += A . W: A the block's rows (nrows valid, row stride K) fp32, split
// into three bf16 parts (hi, mid, lo) once a stage, by the whole block,
// into three bf16 planes after the ring, which the warps read as A
// fragments (lo . W, mid . W, hi . W into one accumulator, as gm_mma3);
// W (K, N) bf16 row-major, i.e. the [k][n] operand, read by
// ldmatrix.trans; columns of W past N read as 0.
struct LmNnOp {
  static constexpr int kStages = kLmStages, kStageBytes = kLmStageBytes;
  const float* a;
  const bf16* w;
  bf16* planes;  // three [64][kLmLdNK] bf16 planes: lo, mid, hi
  int nrows, K, N;

  __device__ __forceinline__ void issue(unsigned char* st, int step) const {
    float* sa = reinterpret_cast<float*>(st);
    bf16* sw = reinterpret_cast<bf16*>(sa + kLmRows * kLmLdA32);
    const int k0 = step * kLmK;
    for (int c = threadIdx.x; c < kLmRows * (kLmK / 4); c += kLmThreads) {
      const int r = c / (kLmK / 4), k = (c % (kLmK / 4)) * 4;
      const bool ok = r < nrows;
      cp_async16(sa + r * kLmLdA32 + k, ok ? a + (long)r * K + k0 + k : a, ok);
    }
    for (int c = threadIdx.x; c < kLmK * (kLmMaxN / 8); c += kLmThreads) {
      const int r = c / (kLmMaxN / 8), n = (c % (kLmMaxN / 8)) * 8;
      const bool ok = n < N;
      cp_async16(sw + r * kLmLdKN + n, ok ? w + (long)(k0 + r) * N + n : w, ok);
    }
  }

  // Runs on a landed stage after a block barrier (gm_mainloop), so the
  // planes are free: the previous step's reads ended before that barrier.
  __device__ __forceinline__ void compute(const unsigned char* st, LmAcc& acc) const {
    const float* sa = reinterpret_cast<const float*>(st);
    const bf16* sw = reinterpret_cast<const bf16*>(sa + kLmRows * kLmLdA32);
    constexpr int kPlane = kLmRows * kLmLdNK;
    // 4 values a thread: row c / 8, columns 4 (c % 8) .. (every thread at
    // 64 rows, as the 512-wide geometry ran it before it had a second one;
    // half of them at 32)
    const int c = threadIdx.x;
    if (kLmRows * kLmK == 4 * kLmThreads || c < kLmRows * kLmK / 4) {
      const int r = c >> 3, k = (c & 7) * 4;
      const float4 x = *reinterpret_cast<const float4*>(sa + r * kLmLdA32 + k);
      const float v[4] = {x.x, x.y, x.z, x.w};
      unsigned hi[2], mid[2], lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float h0, m0, l0, h1, m1, l1;
        split3_bf16(v[2 * e], h0, m0, l0);
        split3_bf16(v[2 * e + 1], h1, m1, l1);
        hi[e] = pack_bf16(h0, h1);
        mid[e] = pack_bf16(m0, m1);
        lo[e] = pack_bf16(l0, l1);
      }
      const int at = r * kLmLdNK + k;
      *reinterpret_cast<uint2*>(planes + at) = make_uint2(lo[0], lo[1]);
      *reinterpret_cast<uint2*>(planes + kPlane + at) = make_uint2(mid[0], mid[1]);
      *reinterpret_cast<uint2*>(planes + 2 * kPlane + at) = make_uint2(hi[0], hi[1]);
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, wm = lm_wm(), wn = lm_wn();
#pragma unroll
    for (int kk = 0; kk < kLmK; kk += 16) {
      unsigned b[kLmNT][2];
#pragma unroll
      for (int j = 0; j < kLmNT; j += 2) {
        unsigned r[4];
        ldsm_x4_t(r, sw + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLmLdKN + 8 * kLmNT * wn +
                         8 * j + (lane >> 4) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          unsigned af[4];
          ldsm_x4(af, planes + p * kPlane + (32 * wm + 16 * i + (lane & 15)) * kLmLdNK + kk +
                          (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < kLmNT; ++j) mma_bf16(acc[i][j], af, b[j][0], b[j][1]);
        }
    }
  }
};

// The epilogues. After each product the block's accumulators go to a
// [64][kLmLdT] fp32 tile in the ring (free once the product is done); then
// each warp takes whole rows of it (rows warp, warp + 16, ..), its lanes a
// column pair each, 64 columns apart: the row sums of a LayerNorm are one
// warp's, the device-memory reads and writes of a row are coalesced, and
// the loops stay loops. (Unrolled over a thread's accumulator elements,
// the forward's epilogues took over twice as long as its products on an
// H100.) Column sums (the LayerNorm parameters' gradients) run with a
// thread per column pair over the rows, in row order.
constexpr int kLmLdT = kLmMaxN + 4;  // 4 mod 32 words: the fragment stores miss no bank
static_assert(sizeof(float) * kLmRows * kLmLdT <= kLmRingBytes, "the tile fits the ring");

__device__ __forceinline__ void lm_to_tile(const LmAcc& acc, float* T) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kLmNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(T + lm_row(i, 2 * h) * kLmLdT + lm_col(j)) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
}

// One row's dropout: the hash's per-row terms once (row = b * Lq + q of
// the stream), then keep(col, salt) per element.
struct LmRowDrop {
  Dropout dr;
  int q;
  __device__ __forceinline__ LmRowDrop(float rate, unsigned seed, int row, int Lq, int B)
      : dr(make_dropout(rate, 1.f, seed, row / Lq, B)), q(row % Lq) {}
  __device__ __forceinline__ bool keep(int col, unsigned salt) const {
    return dropout_keep(dr, q, col, salt);
  }
};

__device__ __forceinline__ float2 lm_ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void lm_st_bf2(bf16* p, float x, float y) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(x, y);
}

// The epilogue's bias and LayerNorm vectors in shared memory as fp32, each
// kLmMaxN wide (zeros past d or ff): b_ff, b_m1, b_m2, ln1 s, b, ln2 s, b.
struct LmVecs {
  float *bff, *bm1, *bm2, *ln1s, *ln1b, *ln2s, *ln2b;
};

// Visible to the block after its next barrier (the first product's).
__device__ __forceinline__ LmVecs lm_load_vecs(const EpParams<bf16>& ep, int d, int ff,
                                               float* base) {
  LmVecs v{base,           base + kLmMaxN,     base + 2 * kLmMaxN, base + 3 * kLmMaxN,
           base + 4 * kLmMaxN, base + 5 * kLmMaxN, base + 6 * kLmMaxN};
  for (int c = threadIdx.x; c < kLmMaxN; c += kLmThreads) {
    const bool in_d = c < d, in_ff = c < ff;
    v.bff[c] = in_d ? __bfloat162float(ep.bff[c]) : 0.f;
    v.bm1[c] = in_ff ? __bfloat162float(ep.bm1[c]) : 0.f;
    v.bm2[c] = in_d ? __bfloat162float(ep.bm2[c]) : 0.f;
    v.ln1s[c] = in_d ? ep.ln1s[c] : 0.f;
    v.ln1b[c] = in_d ? ep.ln1b[c] : 0.f;
    v.ln2s[c] = in_d ? ep.ln2s[c] : 0.f;
    v.ln2b[c] = in_d ? ep.ln2b[c] : 0.f;
  }
  return v;
}

// mu and 1 / sqrt(var + eps) of a row from the warp's sums of x and x^2
// (the fast variance, layer_kernel.py:83-99)
__device__ __forceinline__ float2 lm_ln_stats(float s1, float s2, int d) {
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mu = s1 / (float)d;
  const float var = s2 / (float)d - mu * mu;
  return make_float2(mu, 1.0f / sqrtf(var + kLnEps));
}

// ---------------------------------------------------------------------------
// The forward's products (shared with the backward's recompute).


// h = att . W_ff^T + b_ff, its dropout, r1 = xq + h, y1 = LN1(r1) (written);
// the backward's r1 (fp32) to r1_out and LN1's row statistics to stats1.
template <bool kDrop>
__device__ __forceinline__ void lm_fwd_ln1(const LmFwdArgs& a, const LmVecs& v, int r0,
                                           int nrows, unsigned char* smem, float* r1_out,
                                           float2* stats1) {
  const int d = a.d, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned salt = kEpSalt * a.H;
  float* T = reinterpret_cast<float*>(smem);
  {
    LmAcc acc;
    lm_zero(acc);
    gm_mainloop(LmTnOp{a.att + (long)r0 * d, a.ep.wff, nrows, d, d}, d / kLmK, smem, acc);
    lm_to_tile(acc, T);
  }
  for (int r = warp; r < nrows; r += kLmWarps) {
    const long o = (long)(r0 + r) * d;
    float* Tr = T + r * kLmLdT;
    const LmRowDrop rd(a.rate, a.seed, r0 + r, a.Lq, a.B);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 x = lm_ld_bf2(a.xq + o + c);
      float h0 = proj_epilogue<bf16>(Tr[c], v.bff[c]);
      float h1 = proj_epilogue<bf16>(Tr[c + 1], v.bff[c + 1]);
      if (kDrop) {
        h0 = rd.keep(c, salt) ? round_to<bf16>(h0 / a.epi_div) : 0.f;
        h1 = rd.keep(c + 1, salt) ? round_to<bf16>(h1 / a.epi_div) : 0.f;
      }
      const float y0 = round_to<bf16>(x.x + h0), y1 = round_to<bf16>(x.y + h1);
      Tr[c] = y0;
      Tr[c + 1] = y1;
      s1 += y0 + y1;
      s2 = fmaf(y0, y0, fmaf(y1, y1, s2));
      if (r1_out) *reinterpret_cast<float2*>(r1_out + o + c) = make_float2(y0, y1);
    }
    const float2 m = lm_ln_stats(s1, s2, d);
    if (stats1 && lane == 0) stats1[r] = m;
#pragma unroll 4
    for (int c = 2 * lane; c < d; c += 64)
      lm_st_bf2(a.y1 + o + c, (Tr[c] - m.x) * m.y * v.ln1s[c] + v.ln1b[c],
                (Tr[c + 1] - m.x) * m.y * v.ln1s[c + 1] + v.ln1b[c + 1]);
  }
}

// u = y1 . W_m1^T + b_m1, g = gelu(u), its dropout -> gact (written); u
// (fp32) to u_out where given.
template <bool kDrop>
__device__ __forceinline__ void lm_fwd_gelu(const LmFwdArgs& a, const LmVecs& v, int r0,
                                            int nrows, unsigned char* smem, float* u_out) {
  const int d = a.d, ff = a.ff, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned salt = kEpSalt * a.H + 1;
  float* T = reinterpret_cast<float*>(smem);
  __syncthreads();  // y1 of every warp is written, the tile read
  {
    LmAcc acc;
    lm_zero(acc);
    gm_mainloop(LmTnOp{a.y1 + (long)r0 * d, a.ep.wm1, nrows, d, ff}, d / kLmK, smem, acc);
    lm_to_tile(acc, T);
  }
  for (int r = warp; r < nrows; r += kLmWarps) {
    const long o = (long)(r0 + r) * ff;
    const float* Tr = T + r * kLmLdT;
    const LmRowDrop rd(a.rate, a.seed, r0 + r, a.Lq, a.B);
#pragma unroll 4
    for (int c = 2 * lane; c < ff; c += 64) {
      float u[2], g[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        u[e] = proj_epilogue<bf16>(Tr[c + e], v.bm1[c + e]);
        g[e] = round_to<bf16>(gelu_f32(u[e]));
        if (kDrop) g[e] = rd.keep(c + e, salt) ? round_to<bf16>(g[e] / a.epi_div) : 0.f;
      }
      lm_st_bf2(a.gact + o + c, g[0], g[1]);
      if (u_out) *reinterpret_cast<float2*>(u_out + o + c) = make_float2(u[0], u[1]);
    }
  }
}

// m = g . W_m2^T + b_m2, its dropout, r2 = y1 + m into the tile, then per
// row fin(r, row of the tile, LN2's (mu, inv)) on the row's warp.
template <bool kDrop, class Fin>
__device__ __forceinline__ void lm_fwd_r2(const LmFwdArgs& a, const LmVecs& v, int r0,
                                          int nrows, unsigned char* smem, Fin fin) {
  const int d = a.d, ff = a.ff, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned salt = kEpSalt * a.H + 2;
  float* T = reinterpret_cast<float*>(smem);
  __syncthreads();  // gact of every warp is written, the tile read
  {
    LmAcc acc;
    lm_zero(acc);
    gm_mainloop(LmTnOp{a.gact + (long)r0 * ff, a.ep.wm2, nrows, ff, d}, ff / kLmK, smem, acc);
    lm_to_tile(acc, T);
  }
  for (int r = warp; r < nrows; r += kLmWarps) {
    const long o = (long)(r0 + r) * d;
    float* Tr = T + r * kLmLdT;
    const LmRowDrop rd(a.rate, a.seed, r0 + r, a.Lq, a.B);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 y = lm_ld_bf2(a.y1 + o + c);
      float m0 = proj_epilogue<bf16>(Tr[c], v.bm2[c]);
      float m1 = proj_epilogue<bf16>(Tr[c + 1], v.bm2[c + 1]);
      if (kDrop) {
        m0 = rd.keep(c, salt) ? round_to<bf16>(m0 / a.epi_div) : 0.f;
        m1 = rd.keep(c + 1, salt) ? round_to<bf16>(m1 / a.epi_div) : 0.f;
      }
      const float x0 = round_to<bf16>(y.x + m0), x1 = round_to<bf16>(y.y + m1);
      Tr[c] = x0;
      Tr[c + 1] = x1;
      s1 += x0 + x1;
      s2 = fmaf(x0, x0, fmaf(x1, x1, s2));
    }
    fin(r, Tr, lm_ln_stats(s1, s2, d), rd);
  }
}

// Forward: one block per kLmRows rows of (B * Lq).
template <bool kDrop>
__global__ void __launch_bounds__(kLmThreads, 1)
    layer_epilogue_fwd_mma_kernel(const __grid_constant__ LmFwdArgs a) {
  extern __shared__ __align__(128) unsigned char lm_smem[];
  const LmVecs v =
      lm_load_vecs(a.ep, a.d, a.ff, reinterpret_cast<float*>(lm_smem + kLmRingBytes));
  const int r0 = blockIdx.x * kLmRows, nrows = min(kLmRows, a.rows - r0), d = a.d;
  const int lane = threadIdx.x & 31;
  lm_fwd_ln1<kDrop>(a, v, r0, nrows, lm_smem, nullptr, nullptr);
  lm_fwd_gelu<kDrop>(a, v, r0, nrows, lm_smem, nullptr);
  // out = LN2(r2)
  lm_fwd_r2<kDrop>(a, v, r0, nrows, lm_smem,
                   [&](int r, const float* Tr, float2 m, const LmRowDrop&) {
                     bf16* o = a.out + (long)(r0 + r) * d;
#pragma unroll 4
                     for (int c = 2 * lane; c < d; c += 64)
                       lm_st_bf2(o + c, (Tr[c] - m.x) * m.y * v.ln2s[c] + v.ln2b[c],
                                 (Tr[c + 1] - m.x) * m.y * v.ln2s[c + 1] + v.ln2b[c + 1]);
                   });
}

// ---------------------------------------------------------------------------
// Backward: the forward recomputed, then LN2', W_m2, GELU', W_m1, LN1',
// W_ff, one block per kLmRows rows.


// Column sums over the block's rows (in row order) of f(r, c) -> (x, y) at
// columns c, c + 1: a thread per column pair; (x, y) to out_x, out_y.
template <class F>
__device__ __forceinline__ void lm_col_sums(F f, int nrows, int d, float* out_x, float* out_y) {
  for (int c = 2 * threadIdx.x; c < d; c += 2 * kLmThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // x(c), x(c + 1), y(c), y(c + 1)
#pragma unroll 4
    for (int r = 0; r < nrows; ++r) {
      const float4 t = f(r, c);
      acc.x += t.x;
      acc.y += t.y;
      acc.z += t.z;
      acc.w += t.w;
    }
    *reinterpret_cast<float2*>(out_x + c) = make_float2(acc.x, acc.y);
    *reinterpret_cast<float2*>(out_y + c) = make_float2(acc.z, acc.w);
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(kLmThreads, 1)
    layer_epilogue_bwd_mma_kernel(const __grid_constant__ LmBwdArgs a) {
  extern __shared__ __align__(128) unsigned char lm_smem[];
  unsigned char* tail = lm_smem + kLmRingBytes;
  float2* stats1 = reinterpret_cast<float2*>(tail);
  bf16* planes = reinterpret_cast<bf16*>(tail + kLmStatsBytes);
  const LmFwdArgs& f = a.f;
  const LmVecs v = lm_load_vecs(f.ep, f.d, f.ff,
                                reinterpret_cast<float*>(tail + kLmStatsBytes + kLmPlaneBytes));
  const int r0 = blockIdx.x * kLmRows, nrows = min(kLmRows, f.rows - r0);
  const int d = f.d, ff = f.ff, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_d = 1.0f / (float)d;
  const unsigned salt_h = kEpSalt * f.H, salt_g = salt_h + 1, salt_m = salt_h + 2;
  float* part = a.part + (long)blockIdx.x * 4 * d;
  float* T = reinterpret_cast<float*>(lm_smem);
  auto drop = [&](float x, const LmRowDrop& rd, int c, unsigned salt) {
    return !kDrop || rd.keep(c, salt) ? (kDrop ? x / a.keep_div : x) : 0.f;
  };

  // ---- the forward, recomputed: r1 and LN1's statistics kept, y1, u, g;
  // then LN2' on each row: xhat2 into the tile, dr2 (into dh), dm ----
  lm_fwd_ln1<kDrop>(f, v, r0, nrows, lm_smem, a.r1, stats1);
  lm_fwd_gelu<kDrop>(f, v, r0, nrows, lm_smem, a.u);
  lm_fwd_r2<kDrop>(
      f, v, r0, nrows, lm_smem, [&](int r, float* Tr, float2 m, const LmRowDrop& rd) {
        const long o = (long)(r0 + r) * d;
        float m1 = 0.f, m2 = 0.f;
#pragma unroll 4
        for (int c = 2 * lane; c < d; c += 64) {
          const float2 g = lm_ld_bf2(a.g + o + c);
          const float x0 = (Tr[c] - m.x) * m.y, x1 = (Tr[c + 1] - m.x) * m.y;
          Tr[c] = x0;
          Tr[c + 1] = x1;
          const float gs0 = g.x * v.ln2s[c], gs1 = g.y * v.ln2s[c + 1];
          m1 += gs0 + gs1;
          m2 = fmaf(gs0, x0, fmaf(gs1, x1, m2));
        }
        m1 = warp_sum(m1) * inv_d;
        m2 = warp_sum(m2) * inv_d;
#pragma unroll 4
        for (int c = 2 * lane; c < d; c += 64) {
          const float2 g = lm_ld_bf2(a.g + o + c);
          const float dr0 = m.y * (g.x * v.ln2s[c] - m1 - Tr[c] * m2);
          const float dr1 = m.y * (g.y * v.ln2s[c + 1] - m1 - Tr[c + 1] * m2);
          *reinterpret_cast<float2*>(a.dh + o + c) = make_float2(dr0, dr1);
          *reinterpret_cast<float2*>(a.dm + o + c) =
              make_float2(drop(dr0, rd, c, salt_m), drop(dr1, rd, c + 1, salt_m));
        }
      });
  __syncthreads();  // xhat2 of every row is in the tile
  lm_col_sums(
      [&](int r, int c) {
        const float2 g = lm_ld_bf2(a.g + (long)(r0 + r) * d + c);
        const float* Tr = T + r * kLmLdT;
        return make_float4(g.x * Tr[c], g.y * Tr[c + 1], g.x, g.y);
      },
      nrows, d, part, part + d);
  __syncthreads();  // dm of every warp is written, the tile read

  // ---- W_m2, the GELU's dropout and derivative: du (over u) ----
  {
    LmAcc acc;
    lm_zero(acc);
    gm_mainloop(LmNnOp{a.dm + (long)r0 * d, f.ep.wm2, planes, nrows, d, ff}, d / kLmK, lm_smem,
                acc);
    lm_to_tile(acc, T);
  }
  for (int r = warp; r < nrows; r += kLmWarps) {
    const long o = (long)(r0 + r) * ff;
    const float* Tr = T + r * kLmLdT;
    const LmRowDrop rd(f.rate, f.seed, r0 + r, f.Lq, f.B);
#pragma unroll 4
    for (int c = 2 * lane; c < ff; c += 64) {
      const float2 u = *reinterpret_cast<const float2*>(a.u + o + c);
      *reinterpret_cast<float2*>(a.u + o + c) =
          make_float2(drop(Tr[c], rd, c, salt_g) * gelu_grad_f32(u.x),
                      drop(Tr[c + 1], rd, c + 1, salt_g) * gelu_grad_f32(u.y));
    }
  }
  __syncthreads();  // du of every warp is written, the tile read

  // ---- W_m1: dy1 = dr2 + du . W_m1 into the tile ----
  {
    LmAcc acc;
    lm_zero(acc);
    gm_mainloop(LmNnOp{a.u + (long)r0 * ff, f.ep.wm1, planes, nrows, ff, d}, ff / kLmK, lm_smem,
                acc);
    lm_to_tile(acc, T);
  }
  for (int r = warp; r < nrows; r += kLmWarps) {
    const long o = (long)(r0 + r) * d;
    float* Tr = T + r * kLmLdT;
#pragma unroll 4
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 dr2 = *reinterpret_cast<const float2*>(a.dh + o + c);
      Tr[c] += dr2.x;
      Tr[c + 1] += dr2.y;
    }
  }
  __syncthreads();

  // ---- LN1': column sums of dy1 xhat1 and dy1, then dr1 (over r1), dh ----
  lm_col_sums(
      [&](int r, int c) {
        const float2 r1 = *reinterpret_cast<const float2*>(a.r1 + (long)(r0 + r) * d + c);
        const float2 m = stats1[r];
        const float* Tr = T + r * kLmLdT;
        return make_float4(Tr[c] * (r1.x - m.x) * m.y, Tr[c + 1] * (r1.y - m.x) * m.y, Tr[c],
                           Tr[c + 1]);
      },
      nrows, d, part + 2 * d, part + 3 * d);
  __syncthreads();  // r1 read by every column pass before dr1 replaces it
  for (int r = warp; r < nrows; r += kLmWarps) {
    const long o = (long)(r0 + r) * d;
    const float* Tr = T + r * kLmLdT;
    const float2 m = stats1[r];
    const LmRowDrop rd(f.rate, f.seed, r0 + r, f.Lq, f.B);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll 4
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 r1 = *reinterpret_cast<const float2*>(a.r1 + o + c);
      const float ds0 = Tr[c] * v.ln1s[c], ds1 = Tr[c + 1] * v.ln1s[c + 1];
      m1 += ds0 + ds1;
      m2 = fmaf(ds0, (r1.x - m.x) * m.y, fmaf(ds1, (r1.y - m.x) * m.y, m2));
    }
    m1 = warp_sum(m1) * inv_d;
    m2 = warp_sum(m2) * inv_d;
#pragma unroll 4
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 r1 = *reinterpret_cast<const float2*>(a.r1 + o + c);
      const float d0 = m.y * (Tr[c] * v.ln1s[c] - m1 - (r1.x - m.x) * m.y * m2);
      const float d1 = m.y * (Tr[c + 1] * v.ln1s[c + 1] - m1 - (r1.y - m.x) * m.y * m2);
      *reinterpret_cast<float2*>(a.r1 + o + c) = make_float2(d0, d1);
      *reinterpret_cast<float2*>(a.dh + o + c) =
          make_float2(drop(d0, rd, c, salt_h), drop(d1, rd, c + 1, salt_h));
    }
  }
  __syncthreads();  // dh of every warp is written, the tile read

  // ---- W_ff: d_att = dh . W_ff, as bf16 hi and lo halves ----
  {
    LmAcc acc;
    lm_zero(acc);
    gm_mainloop(LmNnOp{a.dh + (long)r0 * d, f.ep.wff, planes, nrows, d, d}, d / kLmK, lm_smem,
                acc);
    lm_to_tile(acc, T);
  }
  for (int r = warp; r < nrows; r += kLmWarps) {
    const long o = (long)(r0 + r) * d;
    const float* Tr = T + r * kLmLdT;
#pragma unroll 4
    for (int c = 2 * lane; c < d; c += 64) {
      float hi[2], lo[2];
      split_bf16(Tr[c], hi[0], lo[0]);
      split_bf16(Tr[c + 1], hi[1], lo[1]);
      lm_st_bf2(a.datt_hi + o + c, hi[0], hi[1]);
      lm_st_bf2(a.datt_lo + o + c, lo[0], lo[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side of this geometry

inline bool lm_takes(int d, int ff) {
  return d > 0 && ff > 0 && d <= kLmMaxN && ff <= kLmMaxN && d % kLmK == 0 && ff % kLmK == 0;
}
