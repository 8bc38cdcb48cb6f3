// The quick_gelu instances of the forward CaRA site (cp_site.cu's act 3
// and 4), in a source file of their own so that they compile beside
// cp_site.cu's GELU instances: the activation y sigma(1.702 y) of CLIP
// ViT-L/14's fc1 site, with and without its bf16 pre-activation output,
// and its dact mode g * (sigma + 1.702 y sigma (1 - sigma)), at every
// rank class and block width.  They replace the act="quick_gelu" mode of
// _cp_dense_kernel / _cp_dense_dact_kernel (cara_tpu/ops/pallas/
// cp_dense.py, row 13) and of _mlp_fwd_kernel and its save-pre form
// (cp_mlp.py, row 9); cp_site.cu's head comment has the design and the
// bound, which the activation does not change (one expf an output in the
// epilogue, the same tiles and bytes).

#include "cp_site.cuh"

namespace sm90gemm {

int launch_site_quick(bool dact, bool pre, const GemmMaps& maps,
                      const GemmArgs& p, int r, cudaStream_t stream) {
  if (dact) return launch_rank<EPI_SITE_DACT, ACT_QUICK_GELU>(maps, p, r,
                                                             stream);
  return pre ? launch_rank<EPI_SITE_GELU_PRE, ACT_QUICK_GELU>(maps, p, r,
                                                             stream)
             : launch_rank<EPI_SITE_GELU, ACT_QUICK_GELU>(maps, p, r,
                                                         stream);
}

}  // namespace sm90gemm
