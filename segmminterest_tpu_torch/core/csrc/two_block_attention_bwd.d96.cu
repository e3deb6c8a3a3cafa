// K1b's fp32 body (tf32_attention.cuh) at head dims from 68 to 96, in query
// windows where one block's tiles exceed its shared memory, its register tile
// of 18 n8 tiles, with and without dropout (launch_tf32_bwd_drop): a part of
// the library of two_block_attention_bwd.cu, compiled beside it
// (core/build.py).
#include "tf32_attention.cuh"

namespace segmm {
template cudaError_t launch_tf32_bwd_drop<2, 96, false>(const Tf32BwdArgs<2>&, int,
                                                         cudaStream_t);
template cudaError_t launch_tf32_bwd_drop<2, 96, true>(const Tf32BwdArgs<2>&, int,
                                                        cudaStream_t);
}  // namespace segmm
