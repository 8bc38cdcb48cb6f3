// The forward CaRA site's GELU (and no-activation) instances past rank 64
// (cp_site.cu's act 0, 1 and 2 past rank 64, with or without the residual),
// in a source file of their own so that they compile beside cp_site.cu's
// instances: the rank step as ceil(r / 64) k-tiles of 64 read from
// memory (sm90_gemm.cuh, RK_LOOP), at both block widths.  They replace
// the same TPU kernels as cp_site.cu (_cp_dense_kernel /
// _cp_dense_dact_kernel, cara_tpu/ops/pallas/cp_dense.py, row 13;
// _mlp_fwd_kernel, cp_mlp.py, row 9; _attn_block_fwd_kernel,
// cp_attn_block.py, rows 5 and 7; block_pair.py's qkv site, row 19) past
// rank 64; cp_site.cu's head comment has the design and the bound.

#include "cp_site.cuh"

namespace sm90gemm {

int launch_site_chunks(int epi, const GemmMaps& maps, const GemmArgs& p,
                       cudaStream_t stream) {
  switch (epi) {
    case EPI_SITE:
      return launch_site<EPI_SITE, RK_LOOP, 0, ACT_GELU>(maps, p, stream);
    case EPI_SITE_GELU:
      return launch_site<EPI_SITE_GELU, RK_LOOP, 0, ACT_GELU>(maps, p,
                                                             stream);
    case EPI_SITE_GELU_PRE:
      return launch_site<EPI_SITE_GELU_PRE, RK_LOOP, 0, ACT_GELU>(maps, p,
                                                                 stream);
    case EPI_SITE_DACT:
      return launch_site<EPI_SITE_DACT, RK_LOOP, 0, ACT_GELU>(maps, p,
                                                             stream);
    case EPI_SITE_RES:
      return launch_site<EPI_SITE_RES, RK_LOOP, 0, ACT_GELU>(maps, p,
                                                            stream);
    case EPI_SITE_GELU_RES:
      return launch_site<EPI_SITE_GELU_RES, RK_LOOP, 0, ACT_GELU>(maps, p,
                                                                 stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace sm90gemm
