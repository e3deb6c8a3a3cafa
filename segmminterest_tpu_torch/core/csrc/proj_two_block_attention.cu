// K2: projection-fused two-block attention, forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _fp_fwd_kernel
// (:776), launched by _fp_call_fwd (:897) behind
// fused_proj_two_block_attention v1 (:1054), with its head loop
// _attn_group_fwd (:399). It is K1 with the six q/k/v projections:
//   q1 = xq.Wq1 + bq1, q2 = xq.Wq2 + bq2   (query source xq, (B, Lq, d))
//   k1 = x1.Wk1 + bk1, v1 = x1.Wv1 + bv1   (key block 1, (B, L1, d))
//   k2 = x2.Wk2 + bk2, v2 = x2.Wv2 + bv2   (key block 2, (B, L2, d))
// then the joint softmax core; out (B, Lq, d). Weights arrive in nn.Linear
// layout (out, in), biases (d,). Rounding as on the TPU (_proj, :769-773):
// the fp32 dot is cast to the input type and the bias is then added in that
// type.
//
// What bounds it on an H100: operations. The projections are 193 GFLOP at
// B=1024, (40, 40, 100), d = 512, against ~0.57 GB that they must move
// (0.2 ms on the bf16 tensor cores); the attention core adds 29 GFLOP.
//
// bf16: two launches on the tensor cores.
//  (1) qkv_gemm_kernel (proj_gemm.cuh): the six projections as one grouped
//      GEMM, x_s . [Wa_s; Wb_s]^T for each source, with _proj's rounding,
//      into a transient bf16 workspace (B, L, 2d) per source (~0.38 GB at
//      (40, 40, 100)): each x and W tile is read once per 128 x 128 output
//      tile, where the per-(head, batch row) body re-read a batch row's x for every head and a
//      head's weights for every batch row from L2 (~6 GB a launch).
//  (2) proj_two_block_core_fwd_kernel (two_block_mma.cuh): one block per
//      (head, batch row) stages its head's q1, q2, k, v rows by cp.async
//      and runs S, the softmax and p v on mma.sync m16n8k16, both key
//      blocks on one axis.
// fp32 runs no body of this file: the wrapper computes the projections
// (segmm_project_pairs_f32) and K1f's 3xTF32 core over them
// (core/attention.py, k2_body), which beat the first per-(head, batch row)
// CUDA-core body at every head dim and stream shape.
#include "proj_gemm.cuh"
#include "two_block_mma.cuh"

// K2's core forward (launch_k2_core<false>) is compiled once, in
// k2_core_fwd.cu (core/build.py's COMMON), and linked into each library
// that runs it.
namespace segmm {
extern template cudaError_t launch_k2_core<false, false, kBlockKeys, float>(const K2CoreArgs&,
                                                                            int, int,
                                                                            cudaStream_t);
}  // namespace segmm

// dtype: 1 = bfloat16 (the core's block; the projection GEMM's is fixed,
// qkv_gemm_smem_bytes); any other dtype has no block here (0 bytes).
extern "C" size_t segmm_proj_two_block_attention_smem_bytes(int dtype, int Lq, int L1, int L2,
                                                            int DH) {
  return dtype == 1 ? segmm::k2_core_smem_bytes(Lq, L1, L2, DH, false) : 0;
}

// ptrs: xq, x1, x2, wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2
// (device pointers, 16-byte aligned). dtype: 1 = bfloat16 (any other is
// refused). ws: the projections' outputs, (B, Lq, 2d), (B, L1, 2d),
// (B, L2, 2d) bf16. DH in SEGMM_K2_HEAD_DIMS, d % 32 == 0, any lengths
// (past the core's one-chunk shapes its key-chunk path).
// rate > 0 applies the dropout mask of `seed` (keep_div = 1 - rate in
// fp32). Returns a cudaError_t (0 = launched).
extern "C" int segmm_proj_two_block_attention_fwd(
    int dtype, const void* const* ptrs, const int* mq, const int* mk1, const int* mk2,
    void* out, void* const* ws, int B, int Lq, int L1, int L2, int dm, int H, float scale,
    float rate, float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DH = dm / H;
  if (dtype == 1) {
    cudaError_t err = segmm::launch_k2_projections(ptrs, ws, B, Lq, L1, L2, dm, s);
    if (err != cudaSuccess) return (int)err;
    segmm::K2CoreArgs a = segmm::k2_core_args(ws, dm, mq, mk1, mk2, Lq, L1, L2, H, scale, rate,
                                              keep_div, seed);
    a.out = static_cast<__nv_bfloat16*>(out);
    return (int)segmm::launch_k2_core<false>(a, DH, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 K1f, and bf16 K3f at the shapes its own body does not take, on this
// core: q1, q2 (B, Lq, H, D), k1, v1 (B, L1, H, D), k2, v2 (B, L2, H, D)
// bf16 (16-byte aligned), masks int32, out (B, Lq, H, D) bf16; D in
// SEGMM_K2_HEAD_DIMS, any lengths. K1 (k3 = 0): the core as K2 runs it
// (kBlockKeys). K3 (k3 = 1): one key block (L2 = 0, k2, v2 and mk2
// unused, q2 = q1), its dropout salt h and key index j (kConcatKeys over
// one block), on the key-chunk path, as its rule (core/attention.py
// k3_takes) names it. Returns a cudaError_t (0 = launched).
extern "C" int segmm_two_block_core_fwd(const void* q1, const void* q2, const void* k1,
                                        const void* k2, const void* v1, const void* v2,
                                        const int* mq, const int* mk1, const int* mk2, void* out,
                                        int B, int Lq, int L1, int L2, int H, int D, float scale,
                                        float rate, float keep_div, unsigned seed, int k3,
                                        void* stream) {
  using bf = const __nv_bfloat16*;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  segmm::K2CoreArgs a{};
  a.q1 = static_cast<bf>(q1);
  a.q2 = static_cast<bf>(q2);
  a.k1 = static_cast<bf>(k1);
  a.v1 = static_cast<bf>(v1);
  a.k2 = static_cast<bf>(k2);
  a.v2 = static_cast<bf>(v2);
  a.rs = (long)H * D;
  a.mq = mq;
  a.mk1 = mk1;
  a.mk2 = mk2;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.Lq = Lq;
  a.L1 = L1;
  a.L2 = k3 ? 0 : L2;
  a.H = H;
  a.scale = scale;
  a.rate = rate;
  a.keep_div = keep_div;
  a.seed = seed;
  if (k3) {
    a.concat = 1;
    return (int)segmm::launch_k2_chunked(a, D, false, B, s);
  }
  return (int)segmm::launch_k2_core<false>(a, D, B, s);
}
