// bf16 K1b's backward core, its gradients stored in bf16 (launch_k2_core
// with TY = __nv_bfloat16, two_block_mma.cuh): a part of the library of
// proj_two_block_attention_bwd.cu, compiled beside it (core/build.py).
#include "two_block_mma.cuh"

namespace segmm {
template cudaError_t launch_k2_core<true, false, kBlockKeys, __nv_bfloat16>(const K2CoreArgs&,
                                                                           int, int,
                                                                           cudaStream_t);
}  // namespace segmm
