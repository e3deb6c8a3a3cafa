// K2's core forward (two_block_mma.cuh, launch_k2_core<false>: bf16 K2f,
// K4f's and K4b's recompute of att, bf16 K1f on the two-block core),
// compiled once and linked into the libraries that run it (core/build.py's
// COMMON), where each declares it extern.
#include "two_block_mma.cuh"

namespace segmm {
template cudaError_t launch_k2_core<false, false, kBlockKeys, float>(const K2CoreArgs&, int, int,
                                                                     cudaStream_t);
}  // namespace segmm
