// K3b's fp32 body (tf32_attention.cuh) at head dims up to 16, its largest
// register tile only (launch_tf32_bwd_nt): a part
// of the library of masked_attention_bwd.cu, compiled beside it (core/build.py).
#include "tf32_attention.cuh"

namespace segmm {
template cudaError_t launch_tf32_bwd_nt<1, 16>(const Tf32BwdArgs<1>&, int, cudaStream_t);
}  // namespace segmm
