// K3f's fp32 body (tf32_attention.cuh) at head dims from 100 to 128, in
// query windows where one block's tiles exceed its shared memory, its
// largest register tile only (launch_tf32_fwd_nt): a part of the
// library of masked_attention.cu, compiled beside it (core/build.py).
#include "tf32_attention.cuh"

namespace segmm {
template cudaError_t launch_tf32_fwd_nt<1, 128>(const Tf32FwdArgs<1>&, int, cudaStream_t);
}  // namespace segmm
