// The tiled fp32 products of the fp32 backward kernels' chains (K2b, K4b,
// K5b, K6b; their bf16 bodies run proj_gemm.cuh's):
// dx = sum of dy . W over up to kMaxPairs (dy, W) pairs, and dW = dy^T x,
// db = sum dy over every row, summed in row chunks and then in chunk order
// (no atomics, so repeated steps give the same bits).
//
// C[m][n] = sum_k A(m, k) B(k, n), A and B fp32 (B: x or W):
//   A_COL = false: A(m, k) = a[m * lda + k]   (dx: a = dy, (M, K) rows)
//   A_COL = true:  A(m, k) = a[k * lda + m]   (dW: a = dy, A = dy^T)
//   B(k, n) = b[k * ldb + n]                  (dx: W (out, in); dW: x)
// 128x128 tiles of C, 8x8 outputs per thread, operands through
// double-buffered shared memory.
#pragma once

#include "joint_attention.cuh"

namespace segmm {

constexpr int kBM = 128, kBN = 128, kBK = 8, kGemmThreads = 256;
constexpr int kAsLd = kBM + 4;  // conflict-free transposed stores of A

template <int NP>
struct GemmJob {
  const float* a[NP];  // up to NP (A, B) pairs summed into one output
  const void* b[NP];
  int npairs;
  void* c;            // C (M, N) row-major, row stride N
  float* csum;        // A_COL only: sum over the block's k of A(m, k), or null
  const float* add;   // fp32 (M, N) added to C before its cast, or null
  int M, N, K;        // K rows of each A/B pair
  int lda, ldb;
  int k_begin, k_end; // the block's k range
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One 128x128 tile of C. Each thread owns 8x8 outputs (rows ty*4 + {0..3}
// and 64 + ty*4 + {0..3}, the same for columns), read four at a time from
// shared memory. The k-tiles (8 deep) are double-buffered: the next tile's
// global loads (one 16-byte A load and one 4-value B load per thread) are
// in flight while the current one is multiplied, one barrier per tile.
// Needs N, lda, ldb and the vector axis of A (m when A_COL, else k) in
// multiples of 4, with 16-byte aligned rows: d % 4 == 0 gives all of them.
template <typename TB, typename TC, bool A_COL, int NP>
__device__ void gemm_tile(const GemmJob<NP>& job, int m0, int n0) {
  __shared__ __align__(16) float As[2][kBK][kAsLd];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // this thread's slots in a k-tile
  const int a_k = A_COL ? tid / 32 : (tid % 2) * 4;       // A_COL: row k; else k..k+3
  const int a_m = A_COL ? (tid % 32) * 4 : tid / 2;       // A_COL: m..m+3; else row m
  const int b_k = tid / 32, b_n = (tid % 32) * 4;
  const int nk = (job.k_end - job.k_begin + kBK - 1) / kBK;
  const int ntiles = nk * job.npairs;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float colsum = 0.f;  // A_COL with csum: row m0 + tid's sum over k

  float4 ra, rb;
  auto fetch = [&](int t) {
    const int p = t / nk;
    const int k0 = job.k_begin + (t - p * nk) * kBK;
    const float* A = job.a[p];
    const TB* Bm = static_cast<const TB*>(job.b[p]);
    ra = make_float4(0.f, 0.f, 0.f, 0.f);
    rb = ra;
    const int ka = k0 + a_k, ma = m0 + a_m;
    if (ka < job.k_end && ma < job.M)
      ra = A_COL ? load4(A + (long)ka * job.lda + ma) : load4(A + (long)ma * job.lda + ka);
    const int kb = k0 + b_k, nb = n0 + b_n;
    if (kb < job.k_end && nb < job.N) rb = load4(Bm + (long)kb * job.ldb + nb);
  };
  auto stash = [&](int buf) {
    if (A_COL) {
      *reinterpret_cast<float4*>(&As[buf][a_k][a_m]) = ra;
    } else {
      As[buf][a_k][a_m] = ra.x;
      As[buf][a_k + 1][a_m] = ra.y;
      As[buf][a_k + 2][a_m] = ra.z;
      As[buf][a_k + 3][a_m] = ra.w;
    }
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = rb;
  };

  if (ntiles > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) fetch(t + 1);
    if (A_COL && job.csum != nullptr && tid < kBM) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) colsum += As[buf][kk][tid];
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < ntiles) stash(buf ^ 1);
    __syncthreads();
  }
  TC* C = static_cast<TC*>(job.c);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= job.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < job.N) {
        float v = acc[i][j];
        if (job.add != nullptr) v += job.add[(long)m * job.N + n];
        C[(long)m * job.N + n] = from_f<TC>(v);
      }
    }
  }
  if (A_COL && job.csum != nullptr && tid < kBM && m0 + tid < job.M) job.csum[m0 + tid] = colsum;
}

// dx: blockIdx.z picks the job; M = B * L rows
template <int NP>
struct DxJobs {
  GemmJob<NP> job[3];
};

template <typename T, int NP>
__global__ void __launch_bounds__(kGemmThreads) dx_kernel(DxJobs<NP> jobs) {
  const GemmJob<NP>& job = jobs.job[blockIdx.z];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (m0 >= job.M || n0 >= job.N) return;
  gemm_tile<T, T, false, NP>(job, m0, n0);
}

// dW partials: blockIdx.z = one (weight, row chunk) job; the blocks of the
// first column tile also sum dy for db. 48 jobs keep the parameter block
// under 4 KB.
constexpr int kMaxDwJobs = 48;
constexpr int kMaxSplits = 4;
struct DwJobs {
  GemmJob<1> job[kMaxDwJobs];
};

template <typename T>
__global__ void __launch_bounds__(kGemmThreads) dw_kernel(DwJobs jobs) {
  GemmJob<1> job = jobs.job[blockIdx.z];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (m0 >= job.M || n0 >= job.N) return;
  if (blockIdx.x != 0) job.csum = nullptr;
  gemm_tile<T, float, true, 1>(job, m0, n0);
}

// One weight's partials: `splits` chunks of its (M, N) dW, then `splits`
// chunks of its (M,) db; the reduction writes their sums in chunk order.
struct ReduceJob {
  const float* part;
  float* dw;
  float* db;
  int M, N;
};
constexpr int kMaxReduceJobs = 24;
struct ReduceJobs {
  ReduceJob job[kMaxReduceJobs];
};

__global__ void dw_reduce_kernel(ReduceJobs jobs, int splits) {
  const ReduceJob j = jobs.job[blockIdx.y];
  const long mn = (long)j.M * j.N;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < mn + j.M;
       e += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (e < mn) {
      for (int k = 0; k < splits; ++k) s += j.part[k * mn + e];
      j.dw[e] = s;
    } else {
      const long f = e - mn;
      for (int k = 0; k < splits; ++k) s += j.part[splits * mn + k * (long)j.M + f];
      j.db[f] = s;
    }
  }
}

// Floats of one weight's partials.
inline long wgrad_part_floats(int M, int N, int splits) {
  return (long)splits * ((long)M * N + M);
}

// Host side: adds the jobs of dW (M, N) = dy^T x over `rows` rows, dy
// (rows, M) fp32 and x (rows, N), in `splits` row chunks whose partials go
// to `part` (wgrad_part_floats floats), and the reduction of that weight
// into dw, db. Returns false when a table is full.
inline bool add_wgrad(DwJobs& jobs, int& njobs, ReduceJobs& red, int& nred, const float* dy,
                      const void* x, int rows, int M, int N, int splits, float* part, float* dw,
                      float* db) {
  if (njobs + splits > kMaxDwJobs || nred >= kMaxReduceJobs) return false;
  const int chunk = ((rows + splits - 1) / splits + kBK - 1) / kBK * kBK;
  const long mn = (long)M * N;
  for (int s = 0; s < splits; ++s) {
    GemmJob<1>& j = jobs.job[njobs++];
    j.npairs = 1;
    j.a[0] = dy;
    j.b[0] = x;
    j.c = part + s * mn;
    j.csum = part + splits * mn + (long)s * M;
    j.add = nullptr;
    j.M = M;
    j.N = N;
    j.K = rows;
    j.lda = M;
    j.ldb = N;
    j.k_begin = rows < s * chunk ? rows : s * chunk;
    j.k_end = rows < (s + 1) * chunk ? rows : (s + 1) * chunk;
  }
  red.job[nred++] = ReduceJob{part, dw, db, M, N};
  return true;
}

// Host side: launches the dW jobs (grid over the largest M, N) and then the
// reduction of their partials.
template <typename T>
cudaError_t launch_wgrads(const DwJobs& jobs, int njobs, const ReduceJobs& red, int nred,
                          int max_m, int max_n, int splits, cudaStream_t stream) {
  if (njobs == 0) return cudaSuccess;
  dw_kernel<T><<<dim3((max_n + kBN - 1) / kBN, (max_m + kBM - 1) / kBM, njobs), kGemmThreads,
                 0, stream>>>(jobs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_reduce_kernel<<<dim3(64, nred), 256, 0, stream>>>(red, splits);
  return cudaGetLastError();
}

// Host side: one dx job, C (rows, N) = sum_p dy_p (rows, K) . W_p (K, N).
template <int NP>
inline GemmJob<NP> dx_job(const float* const* dys, const void* const* ws, int npairs, void* c,
                          const float* add, int rows, int K, int N) {
  GemmJob<NP> j{};
  j.npairs = npairs;
  for (int p = 0; p < npairs; ++p) {
    j.a[p] = dys[p];
    j.b[p] = ws[p];
  }
  j.c = c;
  j.csum = nullptr;
  j.add = add;
  j.M = rows;
  j.N = N;
  j.K = K;
  j.lda = K;
  j.ldb = N;
  j.k_begin = 0;
  j.k_end = K;
  return j;
}

template <typename T, int NP>
cudaError_t launch_dx(const DxJobs<NP>& jobs, int njobs, int max_rows, int N,
                      cudaStream_t stream) {
  dx_kernel<T, NP><<<dim3((N + kBN - 1) / kBN, (max_rows + kBM - 1) / kBM, njobs),
                     kGemmThreads, 0, stream>>>(jobs);
  return cudaGetLastError();
}

}  // namespace segmm
