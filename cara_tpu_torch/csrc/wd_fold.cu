// Folded masked weight for exact element-wise weight dropout (sm_90a):
//
//   W' = bf16( W + where(keep(k, n, seed), (U V)[k, n] * inv, 0) )
//
// with inv = s / (1 - rate) and keep the coordinate hash of wd_hash.cuh.
// W (K, N), U (K, r), V (r, N) bf16; the rank-r dot is summed in fp32 from
// the bf16 factors and W + delta is rounded once, as the TPU kernel's
// _masked_delta / _build_wd_kernel do.  Where the mask drops an element
// the output is W itself (W + 0).
//
// Replaces cara_tpu/ops/pallas/cp_dense.py _build_wd_weight (body
// _build_wd_kernel, mask hash_keep).  The TPU kernel folds one
// (512, 1024) tile per grid step; here a block folds 32 rows x 256
// columns: its V columns (bf16) and U rows (fp32) sit in shared memory,
// each thread owns 4 rows x 8 contiguous columns (one 16-byte load of W
// and one store of W' per row).  At ViT-B (K x N up to 768 x 3072, r = 8)
// the call moves ~9.4 MB and does ~38 MFMA: it is bound by the bytes of W
// and W' (~3 us at 3.35 TB/s), and the hash costs a few integer ops per
// element.  It runs once per site per step; the forward and backward
// GEMMs then read W' like any dense weight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wd_hash.cuh"

namespace {

constexpr int kRows = 32;      // rows per block
constexpr int kCols = 256;     // columns per block
constexpr int kThreads = 256;  // 32 column groups of 8 x 8 row groups of 4
constexpr int kRMax = 64;

__global__ void __launch_bounds__(kThreads)
wd_fold_kernel(const __nv_bfloat16* __restrict__ w,
               const __nv_bfloat16* __restrict__ u,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ seed, __nv_bfloat16* __restrict__ out,
               int K, int N, int r, float inv, uint32_t thr) {
  __shared__ __align__(16) __nv_bfloat16 vs[kRMax][kCols];
  __shared__ float us[kRows][kRMax];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int n0 = blockIdx.x * kCols;
  // V rows j < r, columns n0 .. n0+255 (zero past N; N % 8 == 0).
  for (int idx = tid; idx < r * (kCols / 8); idx += kThreads) {
    const int j = idx / (kCols / 8);
    const int c = (idx % (kCols / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n0 + c < N)
      val = *reinterpret_cast<const uint4*>(v + (size_t)j * N + n0 + c);
    *reinterpret_cast<uint4*>(&vs[j][c]) = val;
  }
  for (int idx = tid; idx < kRows * r; idx += kThreads) {
    const int row = idx / r;
    const int j = idx % r;
    us[row][j] = k0 + row < K
                     ? __bfloat162float(u[(size_t)(k0 + row) * r + j])
                     : 0.f;
  }
  __syncthreads();

  const int cg = tid % (kCols / 8);  // column group: 8 columns
  const int rg = tid / (kCols / 8);  // row group: 4 rows
  const int c0 = cg * 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  for (int j = 0; j < r; ++j) {
    const uint4 raw = *reinterpret_cast<const uint4*>(&vs[j][c0]);
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&raw);
    float vv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) vv[c] = __bfloat162float(ve[c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float uk = us[rg * 4 + i][j];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(uk, vv[c], acc[i][c]);
    }
  }

  const uint32_t sd = static_cast<uint32_t>(*seed);
  const int n = n0 + c0;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + rg * 4 + i;
    if (k >= K) break;
    const size_t off = (size_t)k * N + n;
    const uint4 wraw = *reinterpret_cast<const uint4*>(w + off);
    const __nv_bfloat16* we = reinterpret_cast<const __nv_bfloat16*>(&wraw);
    uint4 packed;
    __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float d = wd_keep(k, n + c, sd, thr) ? acc[i][c] * inv : 0.f;
      pe[c] = __float2bfloat16(__bfloat162float(we[c]) + d);
    }
    *reinterpret_cast<uint4*>(out + off) = packed;
  }
}

}  // namespace

// W (K, N), U (K, r), V (r, N) bf16, seed one int32 on the device ->
// out (K, N) bf16.  Needs N % 8 == 0, 1 <= r <= 64 and 16-byte aligned
// pointers (the wrapper checks).  Returns cudaGetLastError().
extern "C" int cara_wd_fold(const void* w, const void* u, const void* v,
                            const void* seed, void* out, int K, int N, int r,
                            float inv, unsigned thr, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (r < 1 || r > kRMax || N % 8) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + kCols - 1) / kCols, (K + kRows - 1) / kRows);
  wd_fold_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(u),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seed),
      static_cast<__nv_bfloat16*>(out), K, N, r, inv, thr);
  return static_cast<int>(cudaGetLastError());
}
