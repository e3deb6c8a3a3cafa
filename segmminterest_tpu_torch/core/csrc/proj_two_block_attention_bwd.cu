// K2b: projection-fused two-block attention, backward (and K7b, its first
// pass alone).
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _fp_bwd_kernel
// (:808), launched by _fp_call_bwd (:943) from the custom VJP of
// fused_proj_two_block_attention v1 (:1007-1051), and, through its first
// pass alone, _fp3_bwd_kernel (:1568, K7b, behind SEGMM_ATTN_V3_BWD=1).
// Three passes, all written here:
//  (a) qkv pass, one thread block per (head, batch row): recompute the six
//      projections with _proj's rounding (projection.cuh), then the joint
//      softmax backward of joint_attention.cuh (probabilities recomputed in
//      fp32, the dropout mask from the seed), and write dq1, dq2, dk1, dk2,
//      dv1, dv2 as fp32 (B, L, d) to a workspace (~1 GB at B=1024,
//      (100, 40, 100)). On the TPU they stayed in VMEM; here the batch rows
//      run in parallel, so the sums over the batch below need them all.
//  (b) dx, as :858-868 computes it: dxq = dq1.Wq1 + dq2.Wq2,
//      dx1 = dk1.Wk1 + dv1.Wv1, dx2 = dk2.Wk2 + dv2.Wv2 (W in nn.Linear
//      layout (out, in)), fp32 products, one output cast to x's dtype.
//  (c) dW = dy^T x and db = sum dy over the whole batch in fp32 (:870-894).
//      The TPU carried the sums across its sequential grid; here each
//      128x128 tile of each dW is summed by K2_DW_SPLITS blocks over
//      consecutive row chunks, and a last pass adds the chunks in order: no
//      atomics, so repeated steps give the same bits.
// (b) and (c) are one tiled fp32 product kernel (128x128 tiles, 8x8 outputs
// per thread, operands through double-buffered shared memory).
//
// What bounds it on an H100: operations. At B=1024, (40, 40, 100), d=512:
// the projection recompute is 193 GFLOP on the bf16 tensor cores (0.2 ms),
// dx and dW are 2 x 193 GFLOP with fp32 operands (5.8 ms at 67 TFLOP/s),
// the attention core 29 GFLOP. This first version runs dx and dW on the
// CUDA cores well below that rate; bf16 dx/dW with wgmma are the way on.
#include "projection.cuh"

namespace segmm {

// ---------------------------------------------------------------------------
// (a) the qkv pass

template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kK2Threads)
proj_two_block_qkv_bwd_kernel(const T* __restrict__ xq, const T* __restrict__ x1,
                              const T* __restrict__ x2, const T* __restrict__ wq1,
                              const T* __restrict__ bq1, const T* __restrict__ wq2,
                              const T* __restrict__ bq2, const T* __restrict__ wk1,
                              const T* __restrict__ bk1, const T* __restrict__ wk2,
                              const T* __restrict__ bk2, const T* __restrict__ wv1,
                              const T* __restrict__ bv1, const T* __restrict__ wv2,
                              const T* __restrict__ bv2, const int* __restrict__ mq,
                              const int* __restrict__ mk1, const int* __restrict__ mk2,
                              const T* __restrict__ g, float* __restrict__ dq1,
                              float* __restrict__ dq2, float* __restrict__ dk1,
                              float* __restrict__ dk2, float* __restrict__ dv1,
                              float* __restrict__ dv2, int Lq, int L1, int L2, int dm,
                              float scale, float rate, float keep_div, unsigned seed) {
  constexpr int DS = tile_stride(DH);
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value;
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = dm / DH;
  const int Lmax = max(Lq, max(L1, L2));
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stage = smem;
  float* sq1 = reinterpret_cast<float*>(smem + k2_stage_bytes(kTc, Lmax, DH));
  float* sq2 = sq1 + Lq * DS;
  float* sg = sq2 + Lq * DS;
  float* sk1 = sg + Lq * DS;
  float* sv1 = sk1 + L1 * DS;
  float* sk2 = sv1 + L1 * DS;
  float* sv2 = sk2 + L2 * DS;
  int* smq = reinterpret_cast<int*>(sv2 + L2 * DS);
  int* smk1 = smq + Lq;
  int* smk2 = smk1 + L1;
  float* P = reinterpret_cast<float*>(smq + pad4(Lq + L1 + L2));

  project_pair<T, DH>(xq + (long)b * Lq * dm, Lq, dm, wq1, bq1, wq2, bq2, h, stage, sq1, sq2);
  project_pair<T, DH>(x1 + (long)b * L1 * dm, L1, dm, wk1, bk1, wv1, bv1, h, stage, sk1, sv1);
  project_pair<T, DH>(x2 + (long)b * L2 * dm, L2, dm, wk2, bk2, wv2, bv2, h, stage, sk2, sv2);
  load_head_rows<T>(g, sg, b, Lq, H, h, DH, DS);
  load_masks(mq, mk1, mk2, b, Lq, L1, L2, smq, smk1, smk2);
  __syncthreads();

  const Dropout dr = make_dropout(rate, keep_div, seed, b, gridDim.y);
  const long oq = (long)b * Lq * dm + h * DH;
  const long o1 = (long)b * L1 * dm + h * DH;
  const long o2 = (long)b * L2 * dm + h * DH;
  joint_attention_bwd<float, kDrop>(sq1, sq2, sg, sk1, sv1, sk2, sv2, DS, DH, smq, smk1, smk2,
                                    Lq, L1, L2, scale, dr, h, P, dq1 + oq, dq2 + oq, dk1 + o1,
                                    dk2 + o2, dv1 + o1, dv2 + o2, (long)dm);
}

inline size_t k2b_smem_bytes(bool tensor_cores, int Lq, int L1, int L2, int DH) {
  const int Lmax = Lq > L1 ? (Lq > L2 ? Lq : L2) : (L1 > L2 ? L1 : L2);
  return k2_stage_bytes(tensor_cores, Lmax, DH) + bwd_core_bytes(Lq, L1, L2, DH);
}

template <typename T, int DH>
cudaError_t launch_qkv_bwd(const void* const* p, const int* mq, const int* mk1, const int* mk2,
                           const void* g, float* const* o, int B, int Lq, int L1, int L2,
                           int dm, float scale, float rate, float keep_div, unsigned seed,
                           cudaStream_t stream) {
  const size_t smem = k2b_smem_bytes(std::is_same<T, __nv_bfloat16>::value, Lq, L1, L2, DH);
  auto kernel = rate > 0.f ? proj_two_block_qkv_bwd_kernel<T, DH, true>
                            : proj_two_block_qkv_bwd_kernel<T, DH, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const T* const* a = reinterpret_cast<const T* const*>(p);
  kernel<<<dim3(dm / DH, B), kK2Threads, smem, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], a[10], a[11], a[12], a[13],
      a[14], mq, mk1, mk2, static_cast<const T*>(g), o[0], o[1], o[2], o[3], o[4], o[5], Lq,
      L1, L2, dm, scale, rate, keep_div, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_qkv_bwd(int DH, const void* const* p, const int* mq, const int* mk1,
                             const int* mk2, const void* g, float* const* o, int B, int Lq,
                             int L1, int L2, int dm, float scale, float rate, float keep_div,
                             unsigned seed, cudaStream_t s) {
#define SEGMM_QKV(DH_)                                                                    \
  launch_qkv_bwd<T, DH_>(p, mq, mk1, mk2, g, o, B, Lq, L1, L2, dm, scale, rate, keep_div, \
                         seed, s)
  switch (DH) {
    case 16: return SEGMM_QKV(16);
    case 32: return SEGMM_QKV(32);
    case 64: return SEGMM_QKV(64);
    default: return cudaErrorInvalidValue;
  }
#undef SEGMM_QKV
}

// ---------------------------------------------------------------------------
// (b), (c) the tiled fp32 product: C[m][n] = sum_k A(m, k) B(k, n), A fp32,
// B of type TB (x or W in the compute dtype, widened to fp32).
//   A_COL = false: A(m, k) = a[m * lda + k]   (dx: a = dy, (M, K) rows)
//   A_COL = true:  A(m, k) = a[k * lda + m]   (dW: a = dy, A = dy^T)
//   B(k, n) = b[k * ldb + n]                  (dx: W (out, in); dW: x)

constexpr int kBM = 128, kBN = 128, kBK = 8, kGemmThreads = 256;
constexpr int kAsLd = kBM + 4;  // conflict-free transposed stores of A

struct GemmJob {
  const float* a[2];  // one or two (A, B) pairs summed into one output
  const void* b[2];
  int npairs;
  void* c;            // C (M, N) row-major, row stride N
  float* csum;        // A_COL only: sum over the block's k of A(m, k), or null
  int M, N, K;        // K rows of each A/B pair
  int lda, ldb;
  int k_begin, k_end; // the block's k range
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// One 128x128 tile of C. Each thread owns 8x8 outputs (rows ty*4 + {0..3}
// and 64 + ty*4 + {0..3}, the same for columns), read four at a time from
// shared memory. The k-tiles (8 deep) are double-buffered: the next tile's
// global loads (one 16-byte A load and one 4-value B load per thread) are
// in flight while the current one is multiplied, one barrier per tile.
// Needs N, lda, ldb and the vector axis of A (m when A_COL, else k) in
// multiples of 4, with 16-byte aligned rows: d % 4 == 0 gives all of them.
template <typename TB, typename TC, bool A_COL>
__device__ void gemm_tile(const GemmJob& job, int m0, int n0) {
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
      if (n < job.N) C[(long)m * job.N + n] = from_f<TC>(acc[i][j]);
    }
  }
  if (A_COL && job.csum != nullptr && tid < kBM && m0 + tid < job.M) job.csum[m0 + tid] = colsum;
}

// (b) dx: blockIdx.z picks dxq / dx1 / dx2; M = B * L rows
struct DxJobs {
  GemmJob job[3];
};

template <typename T>
__global__ void __launch_bounds__(kGemmThreads) dx_kernel(DxJobs jobs) {
  const GemmJob& job = jobs.job[blockIdx.z];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (m0 >= job.M) return;
  gemm_tile<T, T, false>(job, m0, n0);
}

// (c) dW partials: blockIdx.z = weight * splits + split; the blocks of the
// first column tile also sum dy for db
constexpr int kMaxSplits = 4;
struct DwJobs {
  GemmJob job[6 * kMaxSplits];
};

template <typename T>
__global__ void __launch_bounds__(kGemmThreads) dw_kernel(DwJobs jobs) {
  GemmJob job = jobs.job[blockIdx.z];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (blockIdx.x != 0) job.csum = nullptr;
  gemm_tile<T, float, true>(job, m0, n0);
}

// dW[w] = sum_s partial[w][s] and db[w] = sum_s partial_db[w][s], in split
// order
struct DwOut {
  float* dw[6];
  float* db[6];
};

__global__ void dw_reduce_kernel(const float* __restrict__ part, const float* __restrict__ pdb,
                                 DwOut out, int d, int splits) {
  const long dd = (long)d * d;
  const long n = 6 * dd + 6L * d;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < n;
       e += (long)gridDim.x * blockDim.x) {
    if (e < 6 * dd) {
      const int w = (int)(e / dd);
      const long i = e - w * dd;
      float s = 0.f;
      for (int k = 0; k < splits; ++k) s += part[((long)w * splits + k) * dd + i];
      out.dw[w][i] = s;
    } else {
      const long f = e - 6 * dd;
      const int w = (int)(f / d);
      const int i = (int)(f - (long)w * d);
      float s = 0.f;
      for (int k = 0; k < splits; ++k) s += pdb[((long)w * splits + k) * d + i];
      out.db[w][i] = s;
    }
  }
}

template <typename T>
cudaError_t launch_chain(const void* const* in, float* const* dys, void* const* dx,
                         float* const* dwdb, float* scratch, int B, int Lq, int L1, int L2,
                         int d, int splits, cudaStream_t stream) {
  if (splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
  const int L[3] = {Lq, L1, L2};
  // (b) dx = dy_a . W_a + dy_b . W_b
  DxJobs xj{};
  const int pair_dy[3][2] = {{0, 1}, {2, 4}, {3, 5}};  // dq1 dq2 | dk1 dv1 | dk2 dv2
  const int pair_w[3][2] = {{3, 5}, {7, 11}, {9, 13}};  // Wq1 Wq2 | Wk1 Wv1 | Wk2 Wv2
  int max_mt = 0;
  for (int s = 0; s < 3; ++s) {
    GemmJob& j = xj.job[s];
    j.npairs = 2;
    for (int p = 0; p < 2; ++p) {
      j.a[p] = dys[pair_dy[s][p]];
      j.b[p] = in[pair_w[s][p]];
    }
    j.c = dx[s];
    j.csum = nullptr;
    j.M = B * L[s];
    j.N = d;
    j.K = d;
    j.lda = d;
    j.ldb = d;
    j.k_begin = 0;
    j.k_end = d;
    max_mt = max(max_mt, (j.M + kBM - 1) / kBM);
  }
  dx_kernel<T><<<dim3((d + kBN - 1) / kBN, max_mt, 3), kGemmThreads, 0, stream>>>(xj);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // (c) dW_w = dy_w^T x_w in row chunks; w = q1 q2 k1 k2 v1 v2
  const int w_dy[6] = {0, 1, 2, 3, 4, 5};
  const int w_x[6] = {0, 0, 1, 2, 1, 2};     // xq xq x1 x2 x1 x2
  const int w_len[6] = {Lq, Lq, L1, L2, L1, L2};
  float* part = scratch;                                   // 6 * splits * d * d
  float* pdb = scratch + 6L * splits * (long)d * d;        // 6 * splits * d
  DwJobs wj{};
  for (int w = 0; w < 6; ++w) {
    const int K = B * w_len[w];
    const int chunk = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
    for (int s = 0; s < splits; ++s) {
      GemmJob& j = wj.job[w * splits + s];
      j.npairs = 1;
      j.a[0] = dys[w_dy[w]];
      j.b[0] = in[w_x[w]];
      j.c = part + ((long)w * splits + s) * d * d;
      j.csum = pdb + ((long)w * splits + s) * d;
      j.M = d;
      j.N = d;
      j.K = K;
      j.lda = d;
      j.ldb = d;
      j.k_begin = min(K, s * chunk);
      j.k_end = min(K, (s + 1) * chunk);
    }
  }
  const int tiles = (d + kBM - 1) / kBM;
  dw_kernel<T><<<dim3(tiles, tiles, 6 * splits), kGemmThreads, 0, stream>>>(wj);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  DwOut o;
  for (int w = 0; w < 6; ++w) {
    o.dw[w] = dwdb[w];
    o.db[w] = dwdb[6 + w];
  }
  dw_reduce_kernel<<<264, 256, 0, stream>>>(part, pdb, o, d, splits);
  return cudaGetLastError();
}

}  // namespace segmm

// dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t segmm_proj_two_block_attention_bwd_smem_bytes(int dtype, int Lq, int L1, int L2,
                                                                int DH) {
  return segmm::k2b_smem_bytes(dtype == 1, Lq, L1, L2, DH);
}

// Pass (a) (K7b alone). ptrs: xq, x1, x2, wq1, bq1, wq2, bq2, wk1, bk1, wk2,
// bk2, wv1, bv1, wv2, bv2 (16-byte aligned); g (B, Lq, d); out: fp32
// dq1, dq2, dk1, dk2, dv1, dv2, each (B, L, d). DH in {16, 32, 64},
// d % 32 == 0, every length <= 128. Returns a cudaError_t (0 = launched).
extern "C" int segmm_proj_two_block_attention_qkv_bwd(
    int dtype, const void* const* ptrs, const int* mq, const int* mk1, const int* mk2,
    const void* g, float* const* out, int B, int Lq, int L1, int L2, int dm, int H, float scale,
    float rate, float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DH = dm / H;
  if (dtype == 0)
    return (int)segmm::dispatch_qkv_bwd<float>(DH, ptrs, mq, mk1, mk2, g, out, B, Lq, L1, L2,
                                               dm, scale, rate, keep_div, seed, s);
  if (dtype == 1)
    return (int)segmm::dispatch_qkv_bwd<__nv_bfloat16>(DH, ptrs, mq, mk1, mk2, g, out, B, Lq,
                                                       L1, L2, dm, scale, rate, keep_div, seed,
                                                       s);
  return (int)cudaErrorInvalidValue;
}

// Passes (b) and (c). ptrs as above; dys: the six fp32 outputs of pass (a);
// dx: dxq, dx1, dx2 (x's dtype); dwdb: fp32 dWq1 dWq2 dWk1 dWk2 dWv1 dWv2
// ((d, d), nn.Linear layout) then the six db (d); scratch: fp32,
// 6 * splits * (d * d + d). 1 <= splits <= 4. Returns a cudaError_t.
extern "C" int segmm_proj_two_block_attention_chain_bwd(
    int dtype, const void* const* ptrs, float* const* dys, void* const* dx, float* const* dwdb,
    float* scratch, int B, int Lq, int L1, int L2, int dm, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)segmm::launch_chain<float>(ptrs, dys, dx, dwdb, scratch, B, Lq, L1, L2, dm,
                                           splits, s);
  if (dtype == 1)
    return (int)segmm::launch_chain<__nv_bfloat16>(ptrs, dys, dx, dwdb, scratch, B, Lq, L1, L2,
                                                   dm, splits, s);
  return (int)cudaErrorInvalidValue;
}
