// The forward CaRA site's launch on the wgmma + TMA core (sm90_gemm.cuh),
// shared by cp_site.cu (the entry points and the GELU instances) and
// cp_site_quick.cu (the quick_gelu instances): the two files compile side
// by side, each with its own template instances.

#pragma once

#include "sm90_gemm.cuh"

namespace {

// The site's block width, RK / ZN (no rank step at r = 0; z folded 16
// wide up to rank 16, 64 up to 64; past 64 z read from memory in
// ceil(r / 64) k-tiles, RK_LOOP), epilogue and activation, as template
// arguments.
template <int E, int RK, int ZN, int ACT>
int launch_site(const GemmMaps& maps, const GemmArgs& p, cudaStream_t s) {
  if (p.M >= 256 && p.N >= 256)
    return launch<NN, E, 256, RK, ZN, ACT>(maps, p, 1, s);
  return launch<NN, E, 128, RK, ZN, ACT>(maps, p, 1, s);
}

}  // namespace

namespace sm90gemm {

// The GELU (or no activation) instances past rank 64, built in a source
// file of their own (cp_site_chunks.cu) so that they compile beside
// cp_site.cu's: launch_site<epi, RK_LOOP, 0, ACT_GELU>.
int launch_site_chunks(int epi, const GemmMaps& maps, const GemmArgs& p,
                       cudaStream_t stream);

}  // namespace sm90gemm

namespace {

template <int E, int ACT = ACT_GELU>
int launch_rank(const GemmMaps& maps, const GemmArgs& p, int r,
                cudaStream_t s) {
  if (r == 0) return launch_site<E, 0, 0, ACT>(maps, p, s);
  if (r <= 16) return launch_site<E, 1, 16, ACT>(maps, p, s);
  if (r <= BK) return launch_site<E, 4, 64, ACT>(maps, p, s);
  if constexpr (ACT == ACT_GELU)
    return sm90gemm::launch_site_chunks(E, maps, p, s);
  else
    return launch_site<E, RK_LOOP, 0, ACT>(maps, p, s);
}

}  // namespace

namespace sm90gemm {

// The quick_gelu site (cp_site_quick.cu): its dact mode (dact), or the
// activation with (pre) or without its pre-activation output.
int launch_site_quick(bool dact, bool pre, const GemmMaps& maps,
                      const GemmArgs& p, int r, cudaStream_t stream);

}  // namespace sm90gemm
