// K1b's fp32 body (tf32_attention.cuh) at head dims up to 16, its largest
// register tile only, with and without dropout (launch_tf32_bwd_drop): a part
// of the library of two_block_attention_bwd.cu, compiled beside it
// (core/build.py).
#include "tf32_attention.cuh"

namespace segmm {
template cudaError_t launch_tf32_bwd_drop<2, 16, false>(const Tf32BwdArgs<2>&, int,
                                                         cudaStream_t);
template cudaError_t launch_tf32_bwd_drop<2, 16, true>(const Tf32BwdArgs<2>&, int,
                                                        cudaStream_t);
}  // namespace segmm
