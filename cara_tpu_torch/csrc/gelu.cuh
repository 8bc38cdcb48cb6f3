// The exact-erf GELU and its derivative in fp32, shared by the epilogues
// of cp_site.cu (the site's GELU and its dact mode) and grad_gemm.cu
// (PRE_GELU, DGELU, DGELU_H: both from one erf).  The TPU kernels use an A&S erf (|err| <= 1.5e-7,
// cara_tpu/ops/pallas/cp_dense.py _erf); erff is exact to fp32.

#pragma once

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
