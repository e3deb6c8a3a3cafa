// K2: projection-fused two-block attention, forward.
//
// Replaces the TPU kernel segmminterest_tpu/core/attention.py _fp_fwd_kernel
// (:776), launched by _fp_call_fwd (:897) behind
// fused_proj_two_block_attention v1 (:1054), with its head loop
// _attn_group_fwd (:399). It is K1 with the six q/k/v projections computed
// inside the kernel:
//   q1 = xq.Wq1 + bq1, q2 = xq.Wq2 + bq2   (query source xq, (B, Lq, d))
//   k1 = x1.Wk1 + bk1, v1 = x1.Wv1 + bv1   (key block 1, (B, L1, d))
//   k2 = x2.Wk2 + bk2, v2 = x2.Wv2 + bv2   (key block 2, (B, L2, d))
// then the joint softmax core of joint_attention.cuh; out (B, Lq, d).
// Weights arrive in nn.Linear layout (out, in), biases (d,). Rounding as on
// the TPU (_proj, :769-773): the fp32 dot is cast to the input type and the
// bias is then added in that type.
//
// Design: one thread block (256 threads, 8 warps) per (head, batch row).
// For its head the block computes the DH columns of each projection, two
// projections that share a source at a time, walking d in tiles staged in
// shared memory (projection.cuh: wmma tensor cores in bf16, CUDA cores in
// fp32). The projected tiles stay in shared memory as fp32 for the
// attention core; q, k and v never reach device memory. In training the
// core applies the dropout mask of joint_attention.cuh.
//
// What bounds it on an H100: operations. Per (row, head) the projections
// are 2*(2Lq + 2L1 + 2L2)*d*DH FLOP against ~(Lq + L1 + L2)*d input values,
// well above the card's bytes-to-FLOP balance, so the floor is the bf16
// tensor-core rate. This design is held back by what it re-reads instead:
// every head re-reads its batch row's x, and every batch row re-reads the
// head's weight slice, from L2 (about 6 GB of L2 reads per launch at
// B=1024, Lq=40, L1=40, L2=100), and the attention core runs as fp32 FMAs
// whose operands all come from shared memory. Several heads or batch rows
// per block, wgmma with TMA, and tensor-core logits and AV products are the
// ways past that.
// The block body (proj_fwd_block) lives in proj_attention.cuh, shared with
// K5 and K4.
#include "proj_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t segmm_proj_two_block_attention_smem_bytes(int dtype, int Lq, int L1, int L2,
                                                            int DH) {
  return segmm::k2_smem_bytes(dtype == 1, Lq, L1, L2, DH);
}

// ptrs: xq, x1, x2, wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2
// (device pointers, 16-byte aligned). dtype: 0 = float32, 1 = bfloat16.
// DH in {16, 32, 64}, d % 32 == 0, every length <= 128. rate > 0 applies
// the dropout mask of `seed` (keep_div = 1 - rate in fp32). Returns a
// cudaError_t (0 = launched).
extern "C" int segmm_proj_two_block_attention_fwd(
    int dtype, const void* const* ptrs, const int* mq, const int* mk1, const int* mk2,
    void* out, int B, int Lq, int L1, int L2, int dm, int H, float scale, float rate,
    float keep_div, unsigned seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DH = dm / H;
  if (dtype == 0)
    return (int)segmm::dispatch_proj_fwd<float>(DH, ptrs, mq, mk1, mk2, out, B, Lq, L1, L2, dm,
                                                scale, rate, keep_div, seed, s);
  if (dtype == 1)
    return (int)segmm::dispatch_proj_fwd<__nv_bfloat16>(DH, ptrs, mq, mk1, mk2, out, B, Lq, L1,
                                                        L2, dm, scale, rate, keep_div, seed, s);
  return (int)cudaErrorInvalidValue;
}
