// K2's core backward on an fp32 g (two_block_mma.cuh, kG32), which bf16
// K4b runs on d_att's two bf16 halves: a part of the library of
// layer_stream_bwd.cu, compiled beside it (core/build.py).
#include "two_block_mma.cuh"

namespace segmm {
template cudaError_t launch_k2_core<true, true, kBlockKeys, float>(const K2CoreArgs&, int, int,
                                                                   cudaStream_t);
}  // namespace segmm
