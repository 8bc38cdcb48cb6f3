// The element-wise weight-dropout mask shared by the fold and the factor
// gradients: element (k, n) of a site's dense (K, N) delta is kept iff
// mix(k, n, seed) >= thr, with thr = min(int(rate * 2^32), 2^32 - 1)
// computed on the host.  Bit for bit the hash of the TPU kernels
// (cara_tpu/ops/pallas/cp_dense.py hash_keep): uint32 arithmetic on
// absolute coordinates, the int32 seed reinterpreted as uint32, then the
// xorshift-multiply finalizer.  Any blocking of the (K, N) plane sees the
// same mask, so the forward fold and the backward finish agree.

#pragma once

#include <stdint.h>

__device__ __forceinline__ bool wd_keep(uint32_t k, uint32_t n, uint32_t seed,
                                        uint32_t thr) {
  uint32_t h = k * 0x9E3779B1u + n * 0x85EBCA77u;
  h ^= seed;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h >= thr;
}
