// K1b's fp32 body (tf32_attention.cuh) at head dims from 36 to 64, its largest
// register tile only, with dropout (launch_tf32_bwd_drop): a part of the
// library of two_block_attention_bwd.cu, compiled beside it (core/build.py).
#include "tf32_attention.cuh"

namespace segmm {
template cudaError_t launch_tf32_bwd_drop<2, 64, true>(const Tf32BwdArgs<2>&, int,
                                                         cudaStream_t);
}  // namespace segmm
