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
// fp32 (tf32_attention.cuh, one key block): every product on the TF32
// tensor cores in 3xTF32, the structure of the bf16 body with fp32 tiles of
// row stride D + 4 over the lengths rounded up to 8, p and dl kept in fp32
// and split into TF32 big and small halves where the bf16 body splits them
// into bf16 hi and lo. One fp32 [query][key] buffer holds p, then dl.
// Shared memory per block at D = 32 (tf32_bwd_smem_bytes), with the blocks
// an H100 SM holds (ptxas, CUDA 12.8: 147 registers without dropout and
// 153 with it at Lk > 64, 123 / 126 at Lk <= 64, no spill; D = 16 and 64,
// the 128-key tile only: 152 / 158 and 186 / 190):
//   (40, 100)   q/g 11.5 + k/v 30.0 + masks/keep bits 1.3 + P 17.3
//               = 60.1 KB: 3 blocks
//   (100, 40)   30.0 + 11.5 + 1.5 + 18.3 = 61.2 KB: 3 blocks
//   (128, 128)  144.4 KB (D = 64: 209.9 KB): 1 block, of 8 warps
#include "joint_attention.cuh"
#include "masked_attention_mma.cuh"
#include "tf32_attention.cuh"

namespace segmm {
// The fp32 body at head dims 16, 64, 96 and 128 is instantiated in
// masked_attention_bwd.d16.cu, .d64.cu, .d96.cu and .d128.cu, compiled beside this file
// (core/build.py), so that its longest compiles run side by side.
extern template cudaError_t launch_tf32_bwd_nt<1, 16>(const Tf32BwdArgs<1>&, int,
                                                          cudaStream_t);
extern template cudaError_t launch_tf32_bwd_nt<1, 64>(const Tf32BwdArgs<1>&, int,
                                                          cudaStream_t);
extern template cudaError_t launch_tf32_bwd_nt<1, 96>(const Tf32BwdArgs<1>&, int,
                                                          cudaStream_t);
extern template cudaError_t launch_tf32_bwd_nt<1, 128>(const Tf32BwdArgs<1>&, int,
                                                           cudaStream_t);
}  // namespace segmm

namespace segmm {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

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

// Shared memory of one block at a shape: dtype 0, the fp32 body's query
// window (all Lq where it fits); 1, the bf16 body's.
extern "C" size_t segmm_masked_attention_bwd_smem_bytes(int dtype, int Lq, int Lk, int D) {
  if (dtype == 1) return segmm::k3b_split_bytes(Lq, Lk) + segmm::k3_stage_bytes(Lq, Lk, D, true);
  const int L[1] = {Lk};
  const int w = segmm::tf32_bwd_window(1, Lq, L, D);
  return segmm::tf32_bwd_smem_bytes(1, w ? w : Lq, L, D);
}

// The fp32 body's query windows at a shape (0: none fits).
extern "C" int segmm_masked_attention_bwd_windows(int Lq, int Lk, int D) {
  const int L[1] = {Lk};
  return segmm::tf32_windows(Lq, segmm::tf32_bwd_window(1, Lq, L, D));
}

// dtype: 0 = float32 (3xTF32), 1 = bfloat16 (bf16 tensor cores). Inputs q, k,
// v, the masks and g; outputs dq, dk, dv (same shapes and dtype as q, k,
// v). bf16: the shapes its body takes (k3_takes "mma"); fp32 any lengths.
// D in {16, 32, 48, 64, 96, 128} (fp32: D % 4 == 0, D <= 128; part:
// scratch of (windows - 1) part slots where the one-chunk body runs in
// several windows, else null); bf16 pointers 16-byte aligned (the
// wrapper checks). Returns a cudaError_t (0 = launched).
extern "C" int segmm_masked_attention_bwd(int dtype, const void* q, const void* k,
                                          const void* v, const int* mq, const int* mk,
                                          const void* g, void* dq, void* dk, void* dv, int B,
                                          int Lq, int Lk, int H, int D, float scale, float rate,
                                          float keep_div, unsigned seed, float* part,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using f = float;
    const segmm::Tf32BwdArgs<1> args{
        {static_cast<const f*>(q)}, {static_cast<const f*>(k)}, {static_cast<const f*>(v)},
        static_cast<const f*>(g), mq, {mk}, {static_cast<f*>(dq)}, {static_cast<f*>(dk)},
        {static_cast<f*>(dv)}, Lq, {Lk}, H, D, scale, rate, keep_div, seed, 0, part};
    return (int)segmm::launch_tf32_attention_bwd<1>(args, B, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  auto launch = D == 16    ? segmm::launch_k3b_mma_d<16>
                : D == 32  ? segmm::launch_k3b_mma_d<32>
                : D == 48  ? segmm::launch_k3b_mma_d<48>
                : D == 64  ? segmm::launch_k3b_mma_d<64>
                : D == 96  ? segmm::launch_k3b_mma_d<96>
                : D == 128 ? segmm::launch_k3b_mma_d<128>
                           : nullptr;
  if (!launch) return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, mq, mk, g, dq, dk, dv, B, Lq, Lk, H, scale, rate, keep_div, seed,
                     s);
}
