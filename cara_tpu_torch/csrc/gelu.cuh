// The hidden activations and their derivatives in fp32, shared by the
// epilogues of cp_site.cu (the site's activation and its dact mode),
// grad_gemm.cu (PRE_GELU, DGELU, DGELU_H: activation and derivative from
// one erf or one exponential) and block_pair.cu (the fc1 chunks):
//
//   ACT_GELU        the exact-erf GELU, y cdf(y).  The TPU kernels use an
//                   A&S erf (|err| <= 1.5e-7, cara_tpu/ops/pallas/
//                   cp_dense.py _erf); erff is exact to fp32.
//   ACT_QUICK_GELU  CLIP's y sigma(1.702 y), derivative sigma + 1.702 y
//                   sigma (1 - sigma) (cp_dense.py _apply_act /
//                   _act_grad, act="quick_gelu"), sigma(t) = 1 / (1 +
//                   expf(-t)) as jax.nn.sigmoid computes it, the
//                   reciprocal by __fdividef (2 ulp): IEEE division's
//                   slow-path branch on every output made the quick site
//                   epilogue 24 % slower than the GELU's on one H100 80GB
//                   HBM3 (700 W), at ViT-B's fc1; past 2^126 it gives 0,
//                   sigma's limit there.
//
// The epilogues take the activation as a template parameter, never as a
// run-time flag: a branch in the epilogue changes how ptxas schedules
// the unrolled loop around it (on one H100 80GB HBM3 at 700 W a run-time
// flag slowed the GELU site at ViT-B's fc1 from 0.18-0.19 to 0.31 ms at
// the same registers).

#pragma once

enum { ACT_GELU = 0, ACT_QUICK_GELU = 1 };

__device__ __forceinline__ float gelu(float y) {
  return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float y) {
  const float cdf = 0.5f * (1.f + erff(y * 0.70710678118654752f));
  const float pdf = expf(-0.5f * y * y) * 0.3989422804014327f;
  return cdf + y * pdf;
}

// gelu'(y), with gelu(y) = y cdf(y) into h from the same erf.
__device__ __forceinline__ float gelu_and_grad(float y, float& h) {
  const float cdf = 0.5f * (1.f + erff(y * 0.70710678118654752f));
  const float pdf = expf(-0.5f * y * y) * 0.3989422804014327f;
  h = y * cdf;
  return cdf + y * pdf;
}

__device__ __forceinline__ float quick_sigmoid(float y) {
  return __fdividef(1.f, 1.f + expf(-1.702f * y));
}

__device__ __forceinline__ float quick_gelu(float y) {
  return y * quick_sigmoid(y);
}

__device__ __forceinline__ float quick_gelu_grad(float y) {
  const float sig = quick_sigmoid(y);
  return sig + 1.702f * y * sig * (1.f - sig);
}

// quick_gelu'(y), with quick_gelu(y) into h from the same exponential.
__device__ __forceinline__ float quick_gelu_and_grad(float y, float& h) {
  const float sig = quick_sigmoid(y);
  h = y * sig;
  return sig + 1.702f * y * sig * (1.f - sig);
}

template <int ACT>
__device__ __forceinline__ float act_fwd(float y) {
  if constexpr (ACT == ACT_QUICK_GELU) return quick_gelu(y);
  else return gelu(y);
}

template <int ACT>
__device__ __forceinline__ float act_grad(float y) {
  if constexpr (ACT == ACT_QUICK_GELU) return quick_gelu_grad(y);
  else return gelu_grad(y);
}

template <int ACT>
__device__ __forceinline__ float act_and_grad(float y, float& h) {
  if constexpr (ACT == ACT_QUICK_GELU) return quick_gelu_and_grad(y, h);
  else return gelu_and_grad(y, h);
}
