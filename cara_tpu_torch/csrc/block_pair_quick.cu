// The quick_gelu instances of row 19 (cara_block_pair's act 1), in a
// source file of their own so that they compile beside block_pair.cu's
// GELU instances: CLIP ViT-L/14's activation y sigma(1.702 y) in the fc1
// epilogue, at every head width and rank class.  They replace the
// act="quick_gelu" mode of _pair_kernel (cara_tpu/ops/pallas/
// block_pair.py); block_pair.cuh has the design and the bound, which the
// activation does not change (one expf a hidden value).

#include "block_pair.cuh"

namespace block_pair {

int launch_quick(const Ptrs& g, const Args& a, int B, int dh, int r,
                 int ldu, cudaStream_t stream) {
  return launch_act<ACT_QUICK_GELU>(g, a, B, dh, r, ldu, stream);
}

}  // namespace block_pair
