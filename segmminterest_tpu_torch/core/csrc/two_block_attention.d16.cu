// K1f's fp32 body (tf32_attention.cuh) at head dims up to 16, its largest
// register tile only (launch_tf32_fwd_nt): a part of the library of
// two_block_attention.cu, compiled beside it (core/build.py).
#include "tf32_attention.cuh"

namespace segmm {
template cudaError_t launch_tf32_fwd_nt<2, 16>(const Tf32FwdArgs<2>&, int, cudaStream_t);
}  // namespace segmm
