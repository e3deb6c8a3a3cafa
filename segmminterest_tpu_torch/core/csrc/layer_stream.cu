// K4f: one whole SegFormerX encoder-layer stream, forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/layer_kernel.py
// _fl_fwd_kernel (:140), launched by _fl_call_fwd (:332) behind
// fused_layer_stream:
//   att = K2's projection-fused two-block attention
//   h   = att . W_ff^T + b_ff ; dropout (salt 2H)
//   y1  = LN1(xq + h)
//   u   = y1 . W_m1^T + b_m1 ; g = gelu(u) ; dropout (salt 2H + 1)
//   m   = g . W_m2^T + b_m2 ; dropout (salt 2H + 2)
//   out = LN2(y1 + m)
// Each Dense rounds as _proj does (fp32 dot, cast, bias added in the
// compute dtype); the residual sums round to the compute dtype before the
// fp32 LayerNorm (fast variance, eps 1e-12, fp32 scale and bias); a dropped
// value divides by 1 - rate in the compute dtype (layer_kernel.py:109-137).
//
// bf16, three launches on the tensor cores: (1) K2f's projection GEMM
// (proj_gemm.cuh) into a transient bf16 workspace, (2) K2f's two-block
// core (two_block_mma.cuh) writes att (B, Lq, d) in bf16, as the TPU
// kernel's `satt` scratch holds it (:358-364), (3) the epilogue
// (layer_mma.cuh): a block of 16 warps per 64 rows of (B * Lq) (32 rows
// where d or ff passes 512, up to 768) runs the
// three Dense layers on mma.sync with full rows in its registers, y1 and g
// through device memory; past 768, the row-tile kernel below in bf16.
// fp32: att comes from the wrapper (K2f's fp32 route: the projections and
// K1f's 3xTF32 core, core/attention.py); here a row-tile epilogue kernel,
// one block of 256 threads per
// 32 rows (8, then 2, where a wider layer's full rows would not fit), the
// rows kept in shared memory through the three Dense layers
// and both LayerNorms, the weights streamed through shared memory in
// 128 x 32 chunks, fp32 FMAs on the CUDA cores (layer_epilogue.cuh).
// The wrapper picks the body by dtype.
//
// What bounds it on an H100: operations. Per row the epilogue is
// 2 (d^2 + 2 d ff) FLOP against ~3d input and output values; the attention
// is K2f's. Each bf16 epilogue block reads the three weights from L2 once
// (B * Lq / 64 times in all); wgmma with TMA and weights shared across a
// cluster are the ways on.
#include "layer_epilogue.cuh"
#include "layer_mma.cuh"
#include "two_block_mma.cuh"

// K2's core forward (launch_k2_core<false>) is compiled once, in
// k2_core_fwd.cu (core/build.py's COMMON), and linked into each library
// that runs it.
namespace segmm {
extern template cudaError_t launch_k2_core<false, false, kBlockKeys, float>(const K2CoreArgs&,
                                                                            int, int,
                                                                            cudaStream_t);
}  // namespace segmm

namespace segmm {

// shared-memory layout of the forward epilogue over rt rows: the A tile
// (att, then y1), the GELU tile g, the fp32 product tile, the weight stage,
// the row stats
template <typename T>
struct EpFwdLayout {
  size_t a, g, c, stage, stats, total;
  __host__ __device__ EpFwdLayout(int d, int ff, int rt = kEpFwdRows) {
    const int w = d > ff ? d : ff;
    a = 0;
    g = a + align128(sizeof(T) * rt * tile_ld<T>(w));
    c = g + align128(sizeof(T) * rt * tile_ld<T>(ff));
    stage = c + align128(sizeof(float) * rt * (w + 4));
    stats = stage + align128(ep_stage_bytes());
    total = stats + 2 * sizeof(float) * rt;
  }
};

// The forward row-tile epilogue's rows a block at widths d, ff: the most
// of kEpFwdRows, kEpNarrowRows and kEpNarrowestRows whose layout fits one
// block (0: none does).
template <typename T> inline int ep_fwd_rows(int d, int ff) {
  const int rts[3] = {kEpFwdRows, kEpNarrowRows, kEpNarrowestRows};
  for (int rt : rts)
    if (EpFwdLayout<T>(d, ff, rt).total <= kK2MaxBlockSmem) return rt;
  return 0;
}

template <typename T, bool kDrop, int RT>
__global__ void __launch_bounds__(kEpThreads)
layer_epilogue_fwd_kernel(const T* __restrict__ att, const T* __restrict__ xq, EpParams<T> ep,
                          T* __restrict__ out, int rows, int Lq, int B, int d, int ff, int H,
                          float rate, float epi_div, unsigned seed) {
  extern __shared__ __align__(128) unsigned char smem[];
  const EpFwdLayout<T> lay(d, ff, RT);
  const int w = d > ff ? d : ff, lda = tile_ld<T>(w), ldg = tile_ld<T>(ff), ldc = w + 4;
  T* sA = reinterpret_cast<T*>(smem + lay.a);
  T* sG = reinterpret_cast<T*>(smem + lay.g);
  float* sC = reinterpret_cast<float*>(smem + lay.c);
  unsigned char* stage = smem + lay.stage;
  float* mu = reinterpret_cast<float*>(smem + lay.stats);
  float* inv = mu + RT;
  const int r0 = blockIdx.x * RT, tid = threadIdx.x;
  const int nrows = min(RT, rows - r0);
  const unsigned salt0 = kEpSalt * H;

  for (int i = tid; i < RT * d; i += kEpThreads) {
    const int r = i / d, c = i - r * d;
    sA[r * lda + c] = r < nrows ? att[(long)(r0 + r) * d + c] : from_f<T>(0.f);
  }
  __syncthreads();
  // h, its dropout, the residual r1 = xq + h (rounded to T)
  tile_gemm_tn<RT, T>(sA, lda, d, ep.wff, d, sC, ldc, stage);
  for (int i = tid; i < RT * d; i += kEpThreads) {
    const int r = i / d, c = i - r * d;
    float v = 0.f;
    if (r < nrows) {
      float h = proj_epilogue<T>(sC[r * ldc + c], to_f<T>(ep.bff[c]));
      if (kDrop)
        h = ep_keep(rate, seed, r0 + r, Lq, B, c, salt0) ? round_to<T>(h / epi_div) : 0.f;
      v = round_to<T>(to_f<T>(xq[(long)(r0 + r) * d + c]) + h);
    }
    sC[r * ldc + c] = v;
  }
  __syncthreads();
  // y1 = LN1(r1) into the A tile
  ln_stats<RT>(sC, ldc, d, mu, inv);
  for (int i = tid; i < RT * d; i += kEpThreads) {
    const int r = i / d, c = i - r * d;
    sA[r * lda + c] = from_f<T>((sC[r * ldc + c] - mu[r]) * inv[r] * ep.ln1s[c] + ep.ln1b[c]);
  }
  __syncthreads();
  // g = gelu(y1 . W_m1^T + b_m1), its dropout
  tile_gemm_tn<RT, T>(sA, lda, d, ep.wm1, ff, sC, ldc, stage);
  for (int i = tid; i < RT * ff; i += kEpThreads) {
    const int r = i / ff, c = i - r * ff;
    const float u = proj_epilogue<T>(sC[r * ldc + c], to_f<T>(ep.bm1[c]));
    float g = round_to<T>(gelu_f32(u));
    if (kDrop && r < nrows)
      g = ep_keep(rate, seed, r0 + r, Lq, B, c, salt0 + 1) ? round_to<T>(g / epi_div) : 0.f;
    sG[r * ldg + c] = from_f<T>(g);
  }
  __syncthreads();
  // m = g . W_m2^T + b_m2, its dropout, r2 = y1 + m (rounded to T)
  tile_gemm_tn<RT, T>(sG, ldg, ff, ep.wm2, d, sC, ldc, stage);
  for (int i = tid; i < RT * d; i += kEpThreads) {
    const int r = i / d, c = i - r * d;
    float m = proj_epilogue<T>(sC[r * ldc + c], to_f<T>(ep.bm2[c]));
    if (kDrop && r < nrows)
      m = ep_keep(rate, seed, r0 + r, Lq, B, c, salt0 + 2) ? round_to<T>(m / epi_div) : 0.f;
    sC[r * ldc + c] = round_to<T>(to_f<T>(sA[r * lda + c]) + m);
  }
  __syncthreads();
  // out = LN2(r2)
  ln_stats<RT>(sC, ldc, d, mu, inv);
  for (int i = tid; i < nrows * d; i += kEpThreads) {
    const int r = i / d, c = i - r * d;
    out[(long)(r0 + r) * d + c] =
        from_f<T>((sC[r * ldc + c] - mu[r]) * inv[r] * ep.ln2s[c] + ep.ln2b[c]);
  }
}

template <typename T, int RT>
cudaError_t launch_k4f_epilogue_rt(const void* const* p, const void* att, void* out, int B,
                                   int Lq, int dm, int H, int ff, float rate, float epi_div,
                                   unsigned seed, cudaStream_t s) {
  const size_t smem = EpFwdLayout<T>(dm, ff, RT).total;
  auto kernel = rate > 0.f ? layer_epilogue_fwd_kernel<T, true, RT>
                           : layer_epilogue_fwd_kernel<T, false, RT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = B * Lq;
  if (rows > 0)
    kernel<<<(rows + RT - 1) / RT, kEpThreads, smem, s>>>(
        static_cast<const T*>(att), static_cast<const T*>(p[0]), ep_params<T>(p + 15),
        static_cast<T*>(out), rows, Lq, B, dm, ff, H, rate, epi_div, seed);
  return cudaGetLastError();
}

// The row-tile epilogue on att: fp32 K4f's (att the wrapper's), and bf16
// K4f's at widths past the tensor-core epilogue's (lm_takes).
template <typename T>
cudaError_t launch_k4f_epilogue(const void* const* p, const void* att, void* out, int B, int Lq,
                                int dm, int H, int ff, float rate, float epi_div, unsigned seed,
                                cudaStream_t s) {
  switch (ep_fwd_rows<T>(dm, ff)) {
    case kEpFwdRows:
      return launch_k4f_epilogue_rt<T, kEpFwdRows>(p, att, out, B, Lq, dm, H, ff, rate, epi_div,
                                                   seed, s);
    case kEpNarrowRows:
      return launch_k4f_epilogue_rt<T, kEpNarrowRows>(p, att, out, B, Lq, dm, H, ff, rate,
                                                      epi_div, seed, s);
    case kEpNarrowestRows:
      return launch_k4f_epilogue_rt<T, kEpNarrowestRows>(p, att, out, B, Lq, dm, H, ff, rate,
                                                         epi_div, seed, s);
    default: return cudaErrorInvalidValue;
  }
}

inline cudaError_t launch_layer_epilogue_fwd_mma(const LmFwdArgs& a, cudaStream_t s) {
  if (!lm_takes(a.d, a.ff)) return cudaErrorInvalidValue;
  auto kernel = lm_fwd_kernel(a.d, a.ff, a.rate > 0.f);
  const size_t smem = lm_fwd_smem_bytes(a.d, a.ff);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.rows > 0) kernel<<<lm_blocks(a.rows, a.d, a.ff), kLmThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// bf16: work = att, y1 (B, Lq, d), gact (B, Lq, ff), then K2's projection
// workspace (three (B, L, 2d) tensors).
inline cudaError_t launch_k4f_mma(const void* const* p, const int* mq, const int* m1,
                                  const int* m2, void* const* work, void* out, int B, int Lq,
                                  int L1, int L2, int dm, int H, int ff, float scale, float rate,
                                  float keep_div, float epi_div, unsigned seed, cudaStream_t s) {
  cudaError_t err = launch_k2_projections(p, work + 3, B, Lq, L1, L2, dm, s);
  if (err != cudaSuccess) return err;
  K2CoreArgs a = k2_core_args(work + 3, dm, mq, m1, m2, Lq, L1, L2, H, scale, rate, keep_div, seed);
  a.out = static_cast<bf16*>(work[0]);
  err = launch_k2_core<false>(a, dm / H, B, s);
  if (err != cudaSuccess) return err;
  // past the tensor-core epilogue's widths, the row-tile one in bf16
  if (!lm_takes(dm, ff))
    return launch_k4f_epilogue<bf16>(p, work[0], out, B, Lq, dm, H, ff, rate, epi_div, seed, s);
  const LmFwdArgs e{static_cast<const bf16*>(work[0]), static_cast<const bf16*>(p[0]),
                    static_cast<bf16*>(work[1]), static_cast<bf16*>(work[2]),
                    static_cast<bf16*>(out), ep_params<bf16>(p + 15), B * Lq, Lq, B, dm, ff, H,
                    rate, epi_div, seed};
  return launch_layer_epilogue_fwd_mma(e, s);
}

}  // namespace segmm

// ptrs: xq, x1, x2, the twelve projection parameters (as K2's), then the
// ten epilogue parameters (w_ff (d, d), b_ff, ln1_s, ln1_b, w_m1 (ff, d),
// b_m1, w_m2 (d, ff), b_m2, ln2_s, ln2_b; nn.Linear layout, the LayerNorm
// ones fp32). work: fp32, att (B, Lq, d), computed by the wrapper, which
// the epilogue alone reads; bf16, att, y1 (B, Lq, d), gact (B, Lq, ff) and
// the projections' (B, Lq, 2d), (B, L1, 2d), (B, L2, 2d). out (B, Lq, d).
// DH = d / H in {16, 32, 48, 64, 96, 128}, d % 32 == 0, ff % 32 == 0, any
// lengths, widths whose 2-row epilogue block fits one block's shared
// memory (ep_fwd_rows). keep_div = 1 - rate in fp32
// (attention), epi_div = 1 - rate in x's dtype (epilogue). Returns a
// cudaError_t (0 = launched).
extern "C" int segmm_layer_stream_fwd(int dtype, const void* const* ptrs, const int* mq,
                                      const int* m1, const int* m2, void* const* work, void* out,
                                      int B, int Lq, int L1, int L2, int dm, int H, int ff,
                                      float scale, float rate, float keep_div, float epi_div,
                                      unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)segmm::launch_k4f_epilogue<float>(ptrs, work[0], out, B, Lq, dm, H, ff, rate,
                                                  epi_div, seed, s);
  if (dtype == 1)
    return (int)segmm::launch_k4f_mma(ptrs, mq, m1, m2, work, out, B, Lq, L1, L2, dm, H, ff,
                                      scale, rate, keep_div, epi_div, seed, s);
  return (int)cudaErrorInvalidValue;
}
