// K3b's fp32 body (tf32_attention.cuh) at head dims from 68 to 96, in
// query windows where one block's tiles exceed its shared memory, its
// largest register tile only (launch_tf32_bwd_nt): a part of the
// library of masked_attention_bwd.cu, compiled beside it (core/build.py).
#include "tf32_attention.cuh"

namespace segmm {
template cudaError_t launch_tf32_bwd_nt<1, 96>(const Tf32BwdArgs<1>&, int, cudaStream_t);
}  // namespace segmm
