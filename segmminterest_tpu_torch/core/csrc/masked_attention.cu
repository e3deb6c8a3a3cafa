// K3f: single-block masked attention, forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _fwd_kernel
// (:126), launched by _call_fwd (:212, pallas_call :238) behind
// fused_masked_attention (:324): the attention of the CrossAtt and SelfAtt
// ablations, one query set over one key block.
//   l = q.k^T in fp32; fill -10000 where mq x mk is 0; in training
//   keep ? l / (1 - rate) : 0 (joint_attention.cuh's hash mask, salt h);
//   x scale; fp32 softmax; p rounded to v's type; out = p.v in fp32, cast.
// Inputs (B, L, H, D) contiguous, fp32 or bf16, Dqk = Dv = D; masks int32
// (B, L). A fully padded query row keeps its -10000 logits and becomes the
// uniform softmax of a constant, as on the TPU.
//
// What bounds it on an H100: device memory. q, k and v are read once and
// the output written once (0.30 GB in bf16 at B=1024, (Lq, Lk) = (40, 100),
// 16 heads of 32: 0.088 ms at 3.35 TB/s; 0.59 GB, 0.175 ms in fp32) against
// 4 Lq Lk D FLOP per (row, head) (8.4 GFLOP: 0.008 ms on the bf16 tensor
// cores, 0.051 ms at a third of the TF32 peak).
//
// bf16 (masked_fwd_mma_kernel): the products on the tensor cores.
//   * One block per (head, batch row), one warp per 16-row query tile (at
//     most four warps; fewer where Lq has fewer tiles, so that Lq = 1 runs
//     one warp and no warp idles). The block stages its head's q, k and v
//     rows and the masks by cp.async, 16 bytes a thread, as bf16 (22 KB at
//     (40, 100), D=32). The register file (96-105 a thread at Lk > 64),
//     not shared memory, caps the blocks per SM: seven at (40, 100).
//     Staging the next batch row while this one is computed (two stages,
//     four rows a block) measured no faster (k3_ab.py, H100 80GB HBM3 at
//     700 W, B=1024: 0.180 against 0.184 ms at (40, 100), 0.163 against
//     0.154 at (100, 40)), so a block takes one row.
//   * S = q.k^T with mma.sync m16n8k16 (fp32 accumulators) from ldmatrix
//     fragments; the whole 16 x pad16(Lk) logit block stays in registers
//     (at most 64 a thread: Lk <= 128, so no online softmax). The fill, the
//     dropout hash and the scale act on each accumulator at its fragment's
//     (query i, key j); the row max and sum come from the four lanes that
//     share a row, and p = e x (1 / sum), within an fp32 ulp of e / sum.
//   * p rounded to bf16 in registers is PV's A operand as it stands (two n8
//     C tiles are one k16 A tile), V's fragments come from ldmatrix.trans:
//     the JAX kernel's probs.astype(v.dtype) rounding, fp32 accumulation.
//   * The output goes through the warp's own q rows in shared memory and
//     out in 16-byte stores.
//   Templates: D in {16, 32, 48, 64, 96, 128}; NT, the n8 key tiles kept in
//   registers (2, 4, 8 or 16 by Lk), so that short key rows do not pay 64
//   registers. At D = 128 and (100, 100) the backward's block takes
//   230,272 of its 232,448 bytes; (128, 128) exceeds them. Lengths past
//   128, and shapes past this body's shared memory, run on the bf16
//   two-block core's key-chunk path over one key block instead
//   (segmm_two_block_core_fwd / _bwd, proj_two_block_attention*.cu; the
//   wrapper's rule k3_takes names it "core").
//
// fp32 (masked_fwd_tf32_kernel, tf32_attention.cuh with one key block): on
// the TF32 tensor cores in 3xTF32, K1f's fp32 body over one key block: a
// warp per 16-row query tile, fp32 tiles of row stride D + 4 over the
// lengths rounded up to 8 staged by cp.async, S and the softmax in
// registers, out = p v with p's C tiles as the A operand. Shared memory at
// D = 32 (tf32_fwd_smem_bytes): 36.3 KB at (40, 100), 27.1 KB at (100, 40),
// 56.3 KB at (128, 128) (105.5 KB at D = 64). It takes lengths up to 128
// (at most 16 key tiles), past D = 64 in query windows, and longer ones on
// its key-chunk path (tf32_chunked.cu), so every length.
#include "masked_attention_mma.cuh"
#include "tf32_attention.cuh"

namespace segmm {
// The fp32 body at head dims past 64 is instantiated in masked_attention.d96.cu and
// .d128.cu, compiled beside this file (core/build.py), so that its longest
// compiles run side by side.
extern template cudaError_t launch_tf32_fwd_nt<1, 96>(const Tf32FwdArgs<1>&, int,
                                                          cudaStream_t);
extern template cudaError_t launch_tf32_fwd_nt<1, 128>(const Tf32FwdArgs<1>&, int,
                                                           cudaStream_t);
}  // namespace segmm

namespace segmm {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

template <int D, int NT, bool kDrop>
__global__ void __launch_bounds__(kK3MmaThreads)
masked_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ mq,
                      const int* __restrict__ mk, __nv_bfloat16* __restrict__ out, int Lq,
                      int Lk, int H, float scale, float rate, float keep_div, unsigned seed) {
  constexpr int LD = D + 8;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nk16 = pad16(Lk) / 16;
  const int g = lane >> 2, t = lane & 3;
  extern __shared__ __align__(16) unsigned char k3f_smem[];
  const K3Stage st = k3_stage_at(k3f_smem, Lq, Lk, D, false);
  k3_load<D>(st, q, nullptr, k, v, mq, mk, b, Lq, Lk, H, h);
  __syncthreads();

  const Dropout dr = make_dropout(rate, keep_div, seed, b, gridDim.y);
  for (int q0 = warp * 16; q0 < Lq; q0 += nwarps * 16) {
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    k3_rows_times_rowsT<D, NT>(st.q, q0, st.k, nk16, s);
    k3_probs<NT, kDrop>(s, st.mq, st.mk, q0, Lk, nk16, scale, dr, (unsigned)h);
    float o[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
    k3_regs_times_rows<D, NT, false>(s, nk16, st.v, o);
    // the tile's q rows, read by this warp alone, hold its output on the
    // way out
    __syncwarp();
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<unsigned*>(st.q + (q0 + g) * LD + dn * 8 + 2 * t) =
          pack_bf16(o[dn][0], o[dn][1]);
      *reinterpret_cast<unsigned*>(st.q + (q0 + g + 8) * LD + dn * 8 + 2 * t) =
          pack_bf16(o[dn][2], o[dn][3]);
    }
    __syncwarp();
    for (int c = lane; c < 16 * (D / 8); c += 32) {
      const int r = c / (D / 8), kc = c - r * (D / 8);
      const int i = q0 + r;
      if (i < Lq)
        *reinterpret_cast<uint4*>(out + (((long)b * Lq + i) * H + h) * D + kc * 8) =
            *reinterpret_cast<const uint4*>(st.q + i * LD + kc * 8);
    }
  }
}

template <int D, int NT>
cudaError_t launch_k3_mma(const void* q, const void* k, const void* v, const int* mq,
                          const int* mk, void* out, int B, int Lq, int Lk, int H, float scale,
                          float rate, float keep_div, unsigned seed, cudaStream_t stream) {
  auto kern = rate > 0.f ? masked_fwd_mma_kernel<D, NT, true> : masked_fwd_mma_kernel<D, NT, false>;
  const size_t smem = k3_stage_bytes(Lq, Lk, D, false);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = pad16(Lq) / 16;  // a warp per query tile, at most four
  const int warps = tiles < kK3MmaWarps ? tiles : kK3MmaWarps;
  kern<<<dim3(H, B), 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mq, mk, static_cast<__nv_bfloat16*>(out), Lq, Lk, H,
      scale, rate, keep_div, seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_k3_mma_d(const void* q, const void* k, const void* v, const int* mq,
                            const int* mk, void* out, int B, int Lq, int Lk, int H, float scale,
                            float rate, float keep_div, unsigned seed, cudaStream_t stream) {
  auto launch = Lk <= 16   ? launch_k3_mma<D, 2>
                : Lk <= 32 ? launch_k3_mma<D, 4>
                : Lk <= 64 ? launch_k3_mma<D, 8>
                           : launch_k3_mma<D, 16>;
  return launch(q, k, v, mq, mk, out, B, Lq, Lk, H, scale, rate, keep_div, seed, stream);
}

}  // namespace segmm

// Shared memory of one block at a shape: dtype 0, the fp32 body's query
// window (all Lq where it fits); 1, the bf16 body's.
extern "C" size_t segmm_masked_attention_smem_bytes(int dtype, int Lq, int Lk, int D) {
  if (dtype == 1) return segmm::k3_stage_bytes(Lq, Lk, D, false);
  const int L[1] = {Lk};
  const int w = segmm::tf32_fwd_window(1, Lq, L, D);
  return segmm::tf32_fwd_smem_bytes(1, w ? w : Lq, L, D);
}

// dtype: 0 = float32 (3xTF32), 1 = bfloat16 (bf16 tensor cores). rate > 0
// applies the dropout mask of `seed` (keep_div = 1 - rate in fp32). bf16:
// the shapes its body takes (k3_takes "mma"); fp32 any lengths. D in {16,
// 32, 48, 64, 96, 128} (fp32: D % 4 == 0, D <= 128);
// bf16 pointers 16-byte aligned (the wrapper
// checks). Returns a cudaError_t (0 = launched).
extern "C" int segmm_masked_attention_fwd(int dtype, const void* q, const void* k,
                                          const void* v, const int* mq, const int* mk, void* out,
                                          int B, int Lq, int Lk, int H, int D, float scale,
                                          float rate, float keep_div, unsigned seed,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using f = const float*;
    const segmm::Tf32FwdArgs<1> args{{static_cast<f>(q)}, {static_cast<f>(k)},
                                     {static_cast<f>(v)}, mq, {mk}, static_cast<float*>(out),
                                     Lq, {Lk}, H, D, scale, rate, keep_div, seed};
    return (int)segmm::launch_tf32_attention_fwd<1>(args, B, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  auto launch = D == 16    ? segmm::launch_k3_mma_d<16>
                : D == 32  ? segmm::launch_k3_mma_d<32>
                : D == 48  ? segmm::launch_k3_mma_d<48>
                : D == 64  ? segmm::launch_k3_mma_d<64>
                : D == 96  ? segmm::launch_k3_mma_d<96>
                : D == 128 ? segmm::launch_k3_mma_d<128>
                           : nullptr;
  if (!launch) return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, mq, mk, out, B, Lq, Lk, H, scale, rate, keep_div, seed, s);
}
