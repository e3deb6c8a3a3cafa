// The tensor-core GEMMs of the projection-fused kernels in bf16 (K2f and
// K2b, proj_two_block_attention*.cu; K4f and K4b's attention,
// layer_stream*.cu), on mma.sync m16n8k16 with fp32
// accumulators (mma_sync.cuh gives the fragment layout), operands staged
// by cp.async through a ring of shared-memory tiles:
//  * qkv_gemm_kernel, the projections: for each source s (xq, x1, x2; K5b's
//    six, three a stream),
//    out_s = x_s . [Wa_s; Wb_s]^T with _proj's rounding (attention.py
//    :769-773: the fp32 dot cast to bf16, then the bias added in bf16), one
//    grouped GEMM of M = B L_s rows, N = 2d, K = d. W in nn.Linear layout
//    (out, in) is already the [n][k] operand mma.sync's B wants. The bf16
//    outputs (B, L_s, 2d) -- Wa's d columns, then Wb's -- are the
//    attention cores' q1|q2, k1|v1 and k2|v2.
//  * chain_dx_kernel: dx_s = dy_a . W_a + dy_b . W_b (+ K4b's LN1 residual
//    gradient for xq, in fp32), one output cast to bf16 (attention.py
//    :858-868, layer_kernel.py:296-297), K = 2d; K5b's dxv and dxu over
//    six pairs each (dual_kernel.py:151-160), K = 6d.
//  * chain_dw_kernel and chain_dw_reduce_kernel: dW = dy^T x and
//    db = sum dy over every row (:870-894) for up to twelve weights of any
//    (out, in) shape (K2b's six projections; K4b's with W_ff, W_m1 and
//    W_m2 too; K5b's twelve), each weight's rows cut into chunks of
//    `chunk` rows whose partial sums the reduction adds in chunk order: no
//    atomics, the same bits on every call.
// The chain's products keep fp32 accuracy on the bf16 tensor cores: dy
// (fp32) is split, as its tile is read, into three bf16 parts, hi =
// bf16(dy), mid = bf16(dy - hi), lo = bf16(dy - hi - mid), which sum to dy
// within ~2^-24 relative; W and x are bf16 values, exact in bf16, so
// lo.W + mid.W + hi.W into one fp32 accumulator is the fp32 product up to
// the order of the sum (tests/test_torch_proj_attention.py emulates it).
//
// Geometry: output tiles of 128 rows by BN columns (128 for the
// projections, 256 for the chain), 8 warps of 64 x BN / 4 (2 x 4), k-steps
// of 32. Staged tiles and their row strides (no bank conflict in the
// fragment reads):
//   bf16 [row][k] (x, W of the projections): 40 elements (80 bytes);
//   bf16 [k][n] (W and x of the chain, read by ldmatrix.trans): BN + 8;
//   fp32 [m][k] (dy of dx, float2 reads at (row g, col 2t)): 40 floats;
//   fp32 [k][m] (dy^T of dW, reads at (row 2t, col g)): 132 floats.
// What bounds them on an H100: the projections move ~0.57 GB and do 193
// GFLOP at B=1024, (40, 40, 100), d = 512 (0.195 ms on the bf16 tensor
// cores, 0.17 ms of device memory); the chain 2 x 193 GFLOP three times
// (1.17 ms at 989 TFLOP/s) against ~2.3 GB. mma.sync reaches about two
// thirds of wgmma's rate on Hopper; wgmma with TMA is the way past that.
#pragma once

#include "mma_sync.cuh"
#include "projection.cuh"  // proj_epilogue

namespace segmm {

constexpr int kGmBM = 128, kGmBK = 32;
constexpr int kGmThreads = 2 * kGmBM;  // warps of 64 rows, 4 across N
constexpr int kGmLdRK = kGmBK + 8;  // bf16 [row][k]
constexpr int kGmLdMK = kGmBK + 8;  // fp32 [m][k]
constexpr int kGmLdKM = kGmBM + 4;  // fp32 [k][m]
// Output tile widths, ring depths and the blocks an SM keeps: the
// projections 128 wide, four stages, two blocks; the chain 256 wide, three
// stages, one block, which halves the re-reads of its fp32 A tiles
// (faster than 128 wide for the chain, slower for the projections; 256
// rows a tile, with 16 warps, was slower for both).
constexpr int kQkvBN = 128, kQkvStages = 4, kQkvMinBlocks = 2;
constexpr int kChainBN = 256, kChainStages = 3, kChainMinBlocks = 1;
// bf16 [k][n] tiles and the output tile: BN + 8 elements a row
__host__ __device__ constexpr int gm_ld_kn(int BN) { return BN + 8; }

using bf16 = __nv_bfloat16;

// x = hi + mid + lo to ~2^-24 relative, each a bf16 value
__device__ __forceinline__ void split3_bf16(float x, float& hi, float& mid, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r = x - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = r - mid;
}

// One A fragment (four pairs, mma_sync.cuh's a[0..3] order) as three bf16
// fragments.
struct Split3A {
  unsigned hi[4], mid[4], lo[4];
};

__device__ __forceinline__ Split3A split3_a(const float (&v)[8]) {
  Split3A r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float h0, m0, l0, h1, m1, l1;
    split3_bf16(v[2 * i], h0, m0, l0);
    split3_bf16(v[2 * i + 1], h1, m1, l1);
    r.hi[i] = pack_bf16(h0, h1);
    r.mid[i] = pack_bf16(m0, m1);
    r.lo[i] = pack_bf16(l0, l1);
  }
  return r;
}

// The warp's 64 x (BN / 4) accumulator tile: [m16][n8][4] (8 warps, 2
// across M and 4 across N).
template <int BN> using GmAcc = float[4][BN / 32][4];

template <int BN> __device__ __forceinline__ void gm_zero(GmAcc<BN>& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < BN / 32; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// The B fragments of the warp's n8 tiles for k16 step kk from a bf16
// [k][n] tile (ldmatrix.trans): b[j] = (rows 2t, 2t+1 / 2t+8, 2t+9; col g).
template <int BN>
__device__ __forceinline__ void gm_b_kn(const bf16* sb, int kk, int wn,
                                        unsigned (&b)[BN / 32][2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < BN / 32; j += 2) {
    unsigned r[4];
    ldsm_x4_t(r, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * gm_ld_kn(BN) + wn * (BN / 4) +
                     j * 8 + (lane >> 4) * 8);
    b[j][0] = r[0];
    b[j][1] = r[1];
    b[j + 1][0] = r[2];
    b[j + 1][1] = r[3];
  }
}

// acc[i][j] += A_i . B_j in three passes, lo, mid, hi (the small parts
// first).
template <int NJ>
__device__ __forceinline__ void gm_mma3(float (&acc)[NJ][4], const Split3A& a,
                                        const unsigned (&b)[NJ][2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(acc[j], a.lo, b[j][0], b[j][1]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(acc[j], a.mid, b[j][0], b[j][1]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(acc[j], a.hi, b[j][0], b[j][1]);
}

// The k-loop over a ring of Op::kStages stages: op.issue(stage, step)
// copies k-step `step`'s tiles into a stage (cp.async, not committed),
// op.compute(stage, acc) multiplies a landed stage into the warp's tile.
// Ends with every copy landed and a block barrier, so that the caller may
// reuse the stages.
template <class Op, class Acc>
__device__ __forceinline__ void gm_mainloop(const Op& op, int nsteps, unsigned char* smem,
                                            Acc& acc) {
  constexpr int S = Op::kStages;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nsteps) op.issue(smem + s * Op::kStageBytes, s);
    cp_async_commit();
  }
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // step `it` has landed; stage (it - 1) % S is free
    const int nxt = it + S - 1;
    if (nxt < nsteps) op.issue(smem + (nxt % S) * Op::kStageBytes, nxt);
    cp_async_commit();
    op.compute(smem + (it % S) * Op::kStageBytes, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The block's bf16 output tile: the warps' accumulators, each through
// f(value, row, column) (within the tile), into shared memory, then out
// in 16-byte stores to dst rows m0 + r < M, columns n0 + c < N (row stride
// ldd). N % 8 == 0.
template <int BN, class F>
__device__ __forceinline__ void gm_store_bf16(const GmAcc<BN>& acc, F f, unsigned char* smem,
                                              bf16* dst, long ldd, int m0, int n0, int M,
                                              int N) {
  constexpr int LD = gm_ld_kn(BN);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  bf16* so = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < BN / 32; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wm * 64 + i * 16 + g + 8 * r, col = wn * (BN / 4) + j * 8 + 2 * t;
        *reinterpret_cast<unsigned*>(so + row * LD + col) =
            pack_bf16(f(acc[i][j][2 * r], row, col), f(acc[i][j][2 * r + 1], row, col + 1));
      }
  __syncthreads();
  for (int c = threadIdx.x; c < kGmBM * (BN / 8); c += kGmThreads) {
    const int r = c / (BN / 8), k = (c - r * (BN / 8)) * 8;
    if (m0 + r < M && n0 + k < N)
      *reinterpret_cast<uint4*>(dst + (long)(m0 + r) * ldd + n0 + k) =
          *reinterpret_cast<const uint4*>(so + r * LD + k);
  }
}

// ---------------------------------------------------------------------------
// The projections

// One source: rows x (M, d), weights wa, wb (d, d) and biases; out (M, 2d).
struct QkvJob {
  const bf16* x;
  const bf16* w[2];
  const bf16* bias[2];
  bf16* out;
  int M;
  int tile0;  // the job's first block
};
constexpr int kMaxQkvJobs = 6;
struct QkvJobs {
  QkvJob job[kMaxQkvJobs];
  int njobs, d;
};

struct QkvOp {
  static constexpr int kBN = kQkvBN, kStages = kQkvStages;
  static constexpr int kStageBytes = (kGmBM + kBN) * kGmLdRK * (int)sizeof(bf16);
  const bf16* x;
  const bf16* wa;
  const bf16* wb;
  int M, d, m0, n0;

  __device__ __forceinline__ void issue(unsigned char* st, int step) const {
    bf16* sa = reinterpret_cast<bf16*>(st);
    bf16* sb = sa + kGmBM * kGmLdRK;
    const int k0 = step * kGmBK;
    for (int c = threadIdx.x; c < (kGmBM + kBN) * (kGmBK / 8); c += kGmThreads) {
      const bool isb = c >= kGmBM * (kGmBK / 8);
      const int cc = isb ? c - kGmBM * (kGmBK / 8) : c;
      const int r = cc / (kGmBK / 8), k = (cc - r * (kGmBK / 8)) * 8;
      const bf16* src;
      bool ok;
      if (!isb) {
        ok = m0 + r < M;
        src = x + (long)(m0 + r) * d + k0 + k;
      } else {
        const int n = n0 + r;
        ok = n < 2 * d;
        src = (n < d ? wa + (long)n * d : wb + (long)(n - d) * d) + k0 + k;
      }
      cp_async16((isb ? sb : sa) + r * kGmLdRK + k, ok ? src : x, ok);
    }
  }

  __device__ __forceinline__ void compute(const unsigned char* st, GmAcc<kBN>& acc) const {
    const bf16* sa = reinterpret_cast<const bf16*>(st);
    const bf16* sb = sa + kGmBM * kGmLdRK;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int kk = 0; kk < kGmBK; kk += 16) {
      unsigned b[kBN / 32][2];
#pragma unroll
      for (int j = 0; j < kBN / 32; j += 2) {
        unsigned r[4];
        ldsm_x4(r, sb + (wn * (kBN / 4) + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * kGmLdRK + kk +
                       ((lane >> 3) & 1) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned a[4];
        ldsm_x4(a, sa + (wm * 64 + i * 16 + (lane & 15)) * kGmLdRK + kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < kBN / 32; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
};

__global__ void __launch_bounds__(kGmThreads, kQkvMinBlocks)
    qkv_gemm_kernel(const __grid_constant__ QkvJobs jobs) {
  extern __shared__ __align__(128) unsigned char gm_smem[];
  int j = 0;
  while (j + 1 < jobs.njobs && (int)blockIdx.x >= jobs.job[j + 1].tile0) ++j;
  const QkvJob& job = jobs.job[j];
  const int d = jobs.d, N = 2 * d;
  const int nt = (N + kQkvBN - 1) / kQkvBN;
  const int tile = blockIdx.x - job.tile0;
  // the n tiles of one row tile run side by side: x's rows are read once
  const int m0 = (tile / nt) * kGmBM, n0 = (tile % nt) * kQkvBN;
  QkvOp op{job.x, job.w[0], job.w[1], job.M, d, m0, n0};
  GmAcc<kQkvBN> acc;
  gm_zero<kQkvBN>(acc);
  gm_mainloop(op, d / kGmBK, gm_smem, acc);
  const bf16* ba = job.bias[0];
  const bf16* bb = job.bias[1];
  gm_store_bf16<kQkvBN>(
      acc,
      [&](float v, int, int col) {
        const int n = n0 + col;
        const float bias = n < d ? __bfloat162float(ba[n])
                                 : n < N ? __bfloat162float(bb[n - d]) : 0.f;
        return proj_epilogue<bf16>(v, bias);
      },
      gm_smem, job.out, N, m0, n0, job.M, N);
}

// ---------------------------------------------------------------------------
// dx = dy_a . W_a + dy_b . W_b (+ add, fp32, before the one cast); NP pairs
// in all (2, or K5b's 6), summed in their order into one accumulator

template <int NP>
struct ChainDxJobT {
  const float* dy[NP];
  const bf16* w[NP];
  const float* add;  // (M, d) or null
  bf16* out;
  int M;
  int tile0;
};
template <int NP>
struct ChainDxJobsT {
  ChainDxJobT<NP> job[3];
  int njobs, d;
};
using ChainDxJob = ChainDxJobT<2>;
using ChainDxJobs = ChainDxJobsT<2>;

template <int NP>
struct ChainDxOpT {
  static constexpr int kBN = kChainBN, kStages = kChainStages;
  static constexpr int kStageBytes =
      kGmBM * kGmLdMK * (int)sizeof(float) + kGmBK * gm_ld_kn(kBN) * (int)sizeof(bf16);
  const ChainDxJobT<NP>* job;
  int d, m0, n0;

  __device__ __forceinline__ void issue(unsigned char* st, int step) const {
    float* sa = reinterpret_cast<float*>(st);
    bf16* sb = reinterpret_cast<bf16*>(sa + kGmBM * kGmLdMK);
    const int ksteps = d / kGmBK;
    // pair a, then pair b (and on)
    const int p = NP == 2 ? (int)(step >= ksteps) : step / ksteps;
    const int k0 = (step - p * ksteps) * kGmBK;
    const float* dy = job->dy[p];
    const bf16* w = job->w[p];
    // A: dy rows m0.., columns k0.. (8 chunks of 4 floats a row)
    for (int c = threadIdx.x; c < kGmBM * (kGmBK / 4); c += kGmThreads) {
      const int r = c / (kGmBK / 4), k = (c - r * (kGmBK / 4)) * 4;
      const bool ok = m0 + r < job->M;
      cp_async16(sa + r * kGmLdMK + k, ok ? dy + (long)(m0 + r) * d + k0 + k : dy, ok);
    }
    // B: W rows k0.. (out features), columns n0.. (in features)
    for (int c = threadIdx.x; c < kGmBK * (kBN / 8); c += kGmThreads) {
      const int r = c / (kBN / 8), n = (c - r * (kBN / 8)) * 8;
      const bool ok = n0 + n < d;
      cp_async16(sb + r * gm_ld_kn(kBN) + n, ok ? w + (long)(k0 + r) * d + n0 + n : w, ok);
    }
  }

  __device__ __forceinline__ void compute(const unsigned char* st, GmAcc<kBN>& acc) const {
    const float* sa = reinterpret_cast<const float*>(st);
    const bf16* sb = reinterpret_cast<const bf16*>(sa + kGmBM * kGmLdMK);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int kk = 0; kk < kGmBK; kk += 16) {
      unsigned b[kBN / 32][2];
      gm_b_kn<kBN>(sb, kk, wn, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* a0 = sa + (wm * 64 + i * 16 + g) * kGmLdMK + kk + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(a0);
        const float2 x1 = *reinterpret_cast<const float2*>(a0 + 8 * kGmLdMK);
        const float2 x2 = *reinterpret_cast<const float2*>(a0 + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(a0 + 8 * kGmLdMK + 8);
        const float v[8] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y, x3.x, x3.y};
        gm_mma3(acc[i], split3_a(v), b);
      }
    }
  }
};

using ChainDxOp = ChainDxOpT<2>;

// kAdd: jobs may carry an addend (K4b); K2b's launch has none. NP: pairs a
// job (2; K5b's 6).
template <bool kAdd, int NP = 2>
__global__ void __launch_bounds__(kGmThreads, kChainMinBlocks)
    chain_dx_kernel(const __grid_constant__ ChainDxJobsT<NP> jobs) {
  extern __shared__ __align__(128) unsigned char gm_smem[];
  int j = 0;
  while (j + 1 < jobs.njobs && (int)blockIdx.x >= jobs.job[j + 1].tile0) ++j;
  const ChainDxJobT<NP>& job = jobs.job[j];
  const int d = jobs.d;
  const int nt = (d + kChainBN - 1) / kChainBN;
  const int tile = blockIdx.x - job.tile0;
  const int m0 = (tile / nt) * kGmBM, n0 = (tile % nt) * kChainBN;
  ChainDxOpT<NP> op{&job, d, m0, n0};
  GmAcc<kChainBN> acc;
  gm_zero<kChainBN>(acc);
  gm_mainloop(op, NP * (d / kGmBK), gm_smem, acc);
  gm_store_bf16<kChainBN>(
      acc,
      [&](float v, int row, int col) {
        const int m = m0 + row, n = n0 + col;
        return kAdd && job.add && m < job.M && n < d ? v + job.add[(long)m * d + n] : v;
      },
      gm_smem, job.out, d, m0, n0, job.M, d);
}

// ---------------------------------------------------------------------------
// dW = dy^T x and db = sum dy, in row chunks

// One weight: dW (Mo, Ni) = dy^T x and db (Mo) = sum dy over M rows (dy
// (M, Mo) fp32, x (M, Ni) bf16, both row-major), in `count` chunks of the
// launch's `chunk` rows whose partial sums sit at part (count * Mo * Ni)
// and db_part (count * Mo); its chunks are jobs first .. first + count - 1.
struct ChainDwW {
  const float* dy;
  const bf16* x;
  float* part;
  float* db_part;
  float* dw;
  float* db;
  int M, Mo, Ni, first, count;
};
constexpr int kMaxDwWeights = 12;
constexpr int kMaxDwChunks = 96;
struct ChainDwJobs {
  ChainDwW w[kMaxDwWeights];
  unsigned char job_w[kMaxDwChunks];  // each (weight, chunk) job's weight
  int chunk, nw;
};

struct ChainDwOp {
  static constexpr int kBN = kChainBN, kStages = kChainStages;
  static constexpr int kStageBytes =
      kGmBK * kGmLdKM * (int)sizeof(float) + kGmBK * gm_ld_kn(kBN) * (int)sizeof(bf16);
  const ChainDwW* w;
  int r0, r1, m0, n0;

  __device__ __forceinline__ void issue(unsigned char* st, int step) const {
    float* sa = reinterpret_cast<float*>(st);
    bf16* sb = reinterpret_cast<bf16*>(sa + kGmBK * kGmLdKM);
    const int k0 = r0 + step * kGmBK;
    // A: dy rows k0.., columns m0.. (32 chunks of 4 floats a row)
    for (int c = threadIdx.x; c < kGmBK * (kGmBM / 4); c += kGmThreads) {
      const int r = c / (kGmBM / 4), m = (c - r * (kGmBM / 4)) * 4;
      const bool ok = k0 + r < r1 && m0 + m < w->Mo;
      cp_async16(sa + r * kGmLdKM + m, ok ? w->dy + (long)(k0 + r) * w->Mo + m0 + m : w->dy, ok);
    }
    // B: x rows k0.., columns n0..
    for (int c = threadIdx.x; c < kGmBK * (kBN / 8); c += kGmThreads) {
      const int r = c / (kBN / 8), n = (c - r * (kBN / 8)) * 8;
      const bool ok = k0 + r < r1 && n0 + n < w->Ni;
      cp_async16(sb + r * gm_ld_kn(kBN) + n, ok ? w->x + (long)(k0 + r) * w->Ni + n0 + n : w->x,
                 ok);
    }
  }

  __device__ __forceinline__ void compute(const unsigned char* st, GmAcc<kBN>& acc) const {
    const float* sa = reinterpret_cast<const float*>(st);
    const bf16* sb = reinterpret_cast<const bf16*>(sa + kGmBK * kGmLdKM);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int kk = 0; kk < kGmBK; kk += 16) {
      unsigned b[kBN / 32][2];
      gm_b_kn<kBN>(sb, kk, wn, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A(m, k) = dy[k][m]: (m = g, k = 2t, 2t + 1), (m = g + 8, ...),
        // then k + 8
        const float* a0 = sa + (kk + 2 * t) * kGmLdKM + wm * 64 + i * 16 + g;
        const float v[8] = {a0[0],
                            a0[kGmLdKM],
                            a0[8],
                            a0[kGmLdKM + 8],
                            a0[8 * kGmLdKM],
                            a0[9 * kGmLdKM],
                            a0[8 * kGmLdKM + 8],
                            a0[9 * kGmLdKM + 8]};
        gm_mma3(acc[i], split3_a(v), b);
      }
    }
  }

  // the tile's dy columns summed over its rows, in row order, into colsum
  // (threads < 128)
  __device__ __forceinline__ void column_sums(const unsigned char* st, float& colsum) const {
    const float* sa = reinterpret_cast<const float*>(st);
#pragma unroll 8
    for (int k = 0; k < kGmBK; ++k) colsum += sa[k * kGmLdKM + threadIdx.x];
  }
};

// db's column sums ride on the k-loop of the blocks of column tile 0: a
// wrapper op that adds them after each step's products.
struct ChainDwDbOp : ChainDwOp {
  float* colsum;
  __device__ __forceinline__ void compute(const unsigned char* st, GmAcc<kBN>& acc) const {
    ChainDwOp::compute(st, acc);
    if (threadIdx.x < kGmBM) column_sums(st, *colsum);
  }
};

// blockIdx.y: the (weight, chunk) job; blockIdx.x: the (m, n) tile of its
// Mo x Ni (blocks past the weight's tiles return at once).
__global__ void __launch_bounds__(kGmThreads, kChainMinBlocks)
    chain_dw_kernel(const __grid_constant__ ChainDwJobs jobs) {
  extern __shared__ __align__(128) unsigned char gm_smem[];
  const ChainDwW& w = jobs.w[jobs.job_w[blockIdx.y]];
  const int c = blockIdx.y - w.first;
  const int nt = (w.Ni + kChainBN - 1) / kChainBN, mt = (w.Mo + kGmBM - 1) / kGmBM;
  if ((int)blockIdx.x >= mt * nt) return;
  const int m0 = (blockIdx.x / nt) * kGmBM, n0 = (blockIdx.x % nt) * kChainBN;
  const int r0 = c * jobs.chunk, r1 = min(r0 + jobs.chunk, w.M);
  const int nsteps = (r1 - r0 + kGmBK - 1) / kGmBK;
  float* part = w.part + (long)c * w.Mo * w.Ni;
  GmAcc<kChainBN> acc;
  gm_zero<kChainBN>(acc);
  float colsum = 0.f;
  if (n0 == 0) {
    gm_mainloop(ChainDwDbOp{{&w, r0, r1, m0, n0}, &colsum}, nsteps, gm_smem, acc);
    if (threadIdx.x < kGmBM && m0 + (int)threadIdx.x < w.Mo)
      w.db_part[(long)c * w.Mo + m0 + threadIdx.x] = colsum;
  } else {
    gm_mainloop(ChainDwOp{&w, r0, r1, m0, n0}, nsteps, gm_smem, acc);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kChainBN / 32; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + wm * 64 + i * 16 + g + 8 * r,
                  n = n0 + wn * (kChainBN / 4) + j * 8 + 2 * t;
        if (m < w.Mo && n < w.Ni)
          *reinterpret_cast<float2*>(part + (long)m * w.Ni + n) =
              make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
      }
}

// blockIdx.y: the weight; its chunks' partial sums added in chunk order.
__global__ void chain_dw_reduce_kernel(const __grid_constant__ ChainDwJobs jobs) {
  const ChainDwW& s = jobs.w[blockIdx.y];
  const long dd = (long)s.Mo * s.Ni;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < dd + s.Mo;
       e += (long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (e < dd) {
      for (int c = 0; c < s.count; ++c) acc += s.part[c * dd + e];
      s.dw[e] = acc;
    } else {
      const long f = e - dd;
      for (int c = 0; c < s.count; ++c) acc += s.db_part[c * (long)s.Mo + f];
      s.db[f] = acc;
    }
  }
}

// Shared-memory bytes of each launch.
template <class Op> inline size_t gm_smem_bytes() {
  const size_t pipe = (size_t)Op::kStages * Op::kStageBytes;
  const size_t out = (size_t)kGmBM * gm_ld_kn(Op::kBN) * sizeof(bf16);
  return pipe > out ? pipe : out;
}

// Host side: the projections of n <= kMaxQkvJobs sources into (B, L, 2d)
// bf16 outputs. x[s], w[2s], w[2s + 1]: the source and its weight pair (K2:
// xq with Wq1, Wq2; x1 with Wk1, Wv1; x2 with Wk2, Wv2).
inline cudaError_t launch_qkv_gemm(const bf16* const* x, const bf16* const* w,
                                   const bf16* const* bias, bf16* const* out, const int* M, int n,
                                   int d, cudaStream_t stream) {
  if (d % kGmBK || d % 8 || n > kMaxQkvJobs) return cudaErrorInvalidValue;
  QkvJobs jobs{};
  jobs.d = d;
  int tiles = 0;
  for (int s = 0; s < n; ++s) {
    if (M[s] <= 0) continue;
    QkvJob& j = jobs.job[jobs.njobs++];
    j = QkvJob{x[s], {w[2 * s], w[2 * s + 1]}, {bias[2 * s], bias[2 * s + 1]}, out[s], M[s],
               tiles};
    tiles += ((M[s] + kGmBM - 1) / kGmBM) * ((2 * d + kQkvBN - 1) / kQkvBN);
  }
  if (!tiles) return cudaSuccess;
  const size_t smem = gm_smem_bytes<QkvOp>();
  cudaError_t err = cudaFuncSetAttribute(qkv_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  qkv_gemm_kernel<<<tiles, kGmThreads, smem, stream>>>(jobs);
  return cudaGetLastError();
}

// Host side: K2's six projections. p: xq, x1, x2, then wq1, bq1, wq2, bq2,
// wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2 (bf16); ws: xq's (B, Lq, 2d)
// output (q1 | q2), x1's (k1 | v1) and x2's (k2 | v2).
inline cudaError_t launch_k2_projections(const void* const* p, void* const* ws, int B, int Lq,
                                         int L1, int L2, int d, cudaStream_t stream) {
  const bf16* const* t = reinterpret_cast<const bf16* const*>(p);
  const bf16* const x[3] = {t[0], t[1], t[2]};
  const bf16* const w[6] = {t[3], t[5], t[7], t[11], t[9], t[13]};
  const bf16* const bias[6] = {t[4], t[6], t[8], t[12], t[10], t[14]};
  bf16* const out[3] = {static_cast<bf16*>(ws[0]), static_cast<bf16*>(ws[1]),
                        static_cast<bf16*>(ws[2])};
  const int M[3] = {B * Lq, B * L1, B * L2};
  return launch_qkv_gemm(x, w, bias, out, M, 3, d, stream);
}

// K5's projections, both streams in one grouped GEMM. p: xv, xu, then the
// video stream's 12 parameters and the user stream's; ws: per stream (the
// video stream's at 0, the user stream's at 3) q1|q2 of its queries, k1|v1
// of xv, k2|v2 of xu, (B, L, 2d) bf16 each.
inline cudaError_t launch_k5_projections(const void* const* p, void* const* ws, int B, int Lv,
                                         int Lu, int d, cudaStream_t stream) {
  const bf16* const* t = reinterpret_cast<const bf16* const*>(p);
  const bf16* x[6] = {t[0], t[0], t[1], t[1], t[0], t[1]};
  const bf16* w[12];
  const bf16* bias[12];
  bf16* out[6];
  for (int st = 0; st < 2; ++st) {
    const int o = 2 + 12 * st;
    const int pair[3][2] = {{0, 2}, {4, 8}, {6, 10}};  // q1 q2 | k1 v1 | k2 v2
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 2; ++k) {
        w[2 * (3 * st + j) + k] = t[o + pair[j][k]];
        bias[2 * (3 * st + j) + k] = t[o + pair[j][k] + 1];
      }
  }
  for (int i = 0; i < 6; ++i) out[i] = static_cast<bf16*>(ws[i]);
  const int M[6] = {B * Lv, B * Lv, B * Lu, B * Lu, B * Lv, B * Lu};
  return launch_qkv_gemm(x, w, bias, out, M, 6, d, stream);
}

// Host side: dx of n <= 3 sources over NP pairs each, dx_s = dy[NP s] .
// w[NP s] + ... + dy[NP s + NP - 1] . w[NP s + NP - 1] in that order, dx_0
// with add0 (M[0] x d fp32) added before its cast where given.
template <int NP>
inline cudaError_t launch_chain_dx(const float* const* dy, const bf16* const* w, bf16* const* dx,
                                   const int* M, int n, int d, const float* add0,
                                   cudaStream_t stream) {
  if (n > 3) return cudaErrorInvalidValue;
  ChainDxJobsT<NP> jobs{};
  jobs.d = d;
  int tiles = 0;
  for (int s = 0; s < n; ++s) {
    if (M[s] <= 0) continue;
    ChainDxJobT<NP>& j = jobs.job[jobs.njobs++];
    for (int p = 0; p < NP; ++p) {
      j.dy[p] = dy[NP * s + p];
      j.w[p] = w[NP * s + p];
    }
    j.add = s ? nullptr : add0;
    j.out = dx[s];
    j.M = M[s];
    j.tile0 = tiles;
    tiles += ((M[s] + kGmBM - 1) / kGmBM) * ((d + kChainBN - 1) / kChainBN);
  }
  if (!tiles) return cudaSuccess;
  const size_t smem = gm_smem_bytes<ChainDxOpT<NP>>();
  auto kernel = add0 ? chain_dx_kernel<true, NP> : chain_dx_kernel<false, NP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles, kGmThreads, smem, stream>>>(jobs);
  return cudaGetLastError();
}

// Chunks of `chunk` rows over M rows.
__host__ __device__ inline int dw_chunks(int M, int chunk) { return (M + chunk - 1) / chunk; }

// One weight of launch_chain_dw: dW (Mo, Ni) = dy^T x, db = sum dy over M
// rows (dy (M, Mo) fp32, x (M, Ni) bf16).
struct DwWeight {
  const float* dy;
  const bf16* x;
  int M, Mo, Ni;
  float* dw;
  float* db;
};

// Host side: dW and db of nw <= kMaxDwWeights weights, each in
// dw_chunks(M, chunk) row chunks whose partials go to `scratch` (sum over
// the weights of dw_chunks * (Mo * Ni + Mo) floats) and are then added in
// chunk order. Mo % 4 == 0, Ni % 8 == 0.
inline cudaError_t launch_chain_dw(const DwWeight* ws, int nw, int chunk, float* scratch,
                                   cudaStream_t stream) {
  if (chunk <= 0 || chunk % kGmBK || nw > kMaxDwWeights) return cudaErrorInvalidValue;
  ChainDwJobs jobs{};
  jobs.chunk = chunk;
  jobs.nw = nw;
  int nj = 0, tiles = 0;
  for (int w = 0; w < nw; ++w) {
    const DwWeight& in = ws[w];
    if (in.Mo % 4 || in.Ni % 8) return cudaErrorInvalidValue;
    const int count = dw_chunks(in.M, chunk);
    if (nj + count > kMaxDwChunks) return cudaErrorInvalidValue;
    const long dd = (long)in.Mo * in.Ni;
    jobs.w[w] = ChainDwW{in.dy, in.x, scratch, scratch + count * dd, in.dw, in.db,
                         in.M, in.Mo, in.Ni, nj, count};
    scratch += count * (dd + in.Mo);
    for (int c = 0; c < count; ++c) jobs.job_w[nj++] = (unsigned char)w;
    const int t = ((in.Mo + kGmBM - 1) / kGmBM) * ((in.Ni + kChainBN - 1) / kChainBN);
    tiles = t > tiles ? t : tiles;
  }
  const size_t smem = gm_smem_bytes<ChainDwOp>();
  cudaError_t err = cudaFuncSetAttribute(chain_dw_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (nj) {
    chain_dw_kernel<<<dim3(tiles, nj), kGmThreads, smem, stream>>>(jobs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  chain_dw_reduce_kernel<<<dim3(64, nw), 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// Host side: K2's chain in bf16 (K2b, and K4b's attention). in: xq, x1,
// x2, then wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2 (bf16);
// dys: fp32 dq1 dq2 dk1 dk2 dv1 dv2 ((B, L, d) each). dx: dxq, dx1, dx2
// (bf16), dxq with dxq_add (fp32, (B, Lq, d)) added before its cast where
// given; dwdb: fp32 dW of q1 q2 k1 k2 v1 v2 ((d, d), nn.Linear layout),
// then their db. `extra` weights (K4b's epilogue) join the dW launch.
inline cudaError_t launch_k2_chain(const void* const* in, const float* const* dys,
                                   void* const* dx, float* const* dwdb, const float* dxq_add,
                                   const DwWeight* extra, int nextra, int B, int Lq, int L1,
                                   int L2, int d, int chunk, float* scratch,
                                   cudaStream_t stream) {
  const bf16* const* t = reinterpret_cast<const bf16* const*>(in);
  // dx pairs: dq1 dq2 | dk1 dv1 | dk2 dv2 with Wq1 Wq2 | Wk1 Wv1 | Wk2 Wv2
  const float* const dyx[6] = {dys[0], dys[1], dys[2], dys[4], dys[3], dys[5]};
  const bf16* const wx[6] = {t[3], t[5], t[7], t[11], t[9], t[13]};
  bf16* const out[3] = {static_cast<bf16*>(dx[0]), static_cast<bf16*>(dx[1]),
                        static_cast<bf16*>(dx[2])};
  const int Mx[3] = {B * Lq, B * L1, B * L2};
  cudaError_t err = launch_chain_dx<2>(dyx, wx, out, Mx, 3, d, dxq_add, stream);
  if (err != cudaSuccess) return err;
  // dW: q1 q2 k1 k2 v1 v2 over xq xq x1 x2 x1 x2, then the extra weights
  if (nextra < 0 || 6 + nextra > kMaxDwWeights) return cudaErrorInvalidValue;
  DwWeight ws[kMaxDwWeights];
  const int src[6] = {0, 0, 1, 2, 1, 2};
  const int len[6] = {Lq, Lq, L1, L2, L1, L2};
  for (int w = 0; w < 6; ++w)
    ws[w] = DwWeight{dys[w], t[src[w]], B * len[w], d, d, dwdb[w], dwdb[6 + w]};
  for (int w = 0; w < nextra; ++w) ws[6 + w] = extra[w];
  return launch_chain_dw(ws, 6 + nextra, chunk, scratch, stream);
}

}  // namespace segmm
