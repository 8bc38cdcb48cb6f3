// Masked factor gradients of one element-dropout site (sm_90a):
//
//   dtc = bf16( where(keep(k, n, seed), dT[k, n] * inv, 0) )
//   dU  = dtc V^T   (K, r)      dV = U^T dtc   (r, N)      both fp32
//
// dT (K, N) is the site's dense cotangent x^T g in fp32 (grad_gemm.cu's
// TN product, its contraction splits summed in a fixed order there); inv
// = s / (1 - rate); keep is the hash of wd_hash.cuh, so the mask is the
// one the fold applied in the forward.
//
// Replaces the finish step masked_site_grads
// (cara_tpu/ops/pallas/cp_dense.py), which the TPU backward kernels
// _attn_block_bwd_wd_kernel and _mlp_bwd_wd_kernel run chunk-wise on the
// dT they accumulated in VMEM.  Here a block takes 8 rows of the plane
// and walks N in 256-column chunks: each thread regenerates the mask of
// its column, rounds dtc to bf16 into shared memory and accumulates that
// column's dV partial over the block's rows in registers; then each warp
// reduces its row's dU over the chunk with shuffles.  Where K / 8 blocks
// would leave SMs idle the columns are split across blocks as well.
// Every element of dT is read once a rank chunk.  Past rank 64 the rank
// goes in chunks of 64 on a third grid axis (blockIdx.z): a block keeps
// the dV partials of its chunk's columns in registers (64 at most: more
// would spill) and regenerates the mask and dtc for it, so dT is read
// ceil(r / 64) times (from L2 where it fits: 7 MB for ViT-B's qkv plane).
// At 33..64 rank columns a block (RMAX 64, every chunk past rank 64) its
// dU goes lane by rank column: the chunk's 64 rows of V staged in shared
// memory (rows padded to 129 words, so that the 32 lanes' rows fall in
// 32 banks), lane l summing columns l and l + 32 over the 256 dtc values
// of its warp's row.  A reduction across the warp for each rank column
// (as below 33) made 64 dependent shuffle chains a chunk, ~35 ms of a
// ViT-B step at rank 128 on one H100 80GB HBM3 at 700 W (the profiler's
// device time in chip_smoke.py's ranks phase).
// The dV partials (one
// per row block) and dU partials (one per column split) are summed by a
// second kernel in a fixed order: no atomics, so runs repeat bit for
// bit.  At ViT-B (K x N up to 3072 x 768, r = 8) the call reads 9-17 MB
// and does ~40 MFMA: bound by the bytes of dT.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wd_hash.cuh"

namespace {

constexpr int kRows = 8;       // one warp per row
constexpr int kThreads = 256;  // one thread per column of a chunk
constexpr int kChunk = 256;
constexpr int kSlots = 264;    // blocks that fill the card (132 SMs x 2)

// Block (x, y, c): rows [8x, 8x + 8) of the plane, columns [y * cols,
// ...), rank columns [64 c, 64 c + 64) of U and rows of V.  RMAX is the
// rank (or the chunk's part of it) rounded up to 8, 16, 32 or 64
// (per-thread dV accumulators in registers).
template <int RMAX>
__global__ void __launch_bounds__(kThreads)
wd_factor_grads_kernel(const float* __restrict__ dt,
                       const __nv_bfloat16* __restrict__ u,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ seed,
                       float* __restrict__ du_part,
                       float* __restrict__ dv_part, int K, int N, int r,
                       int cols, float inv, uint32_t thr) {
  constexpr bool LANES = RMAX == 64;  // dU a rank column a lane
  constexpr int kVld = kChunk + 2;    // V's staged rows: 129 words
  __shared__ float us[kRows][RMAX];
  __shared__ float dus[kRows][RMAX];
  __shared__ float dtc[kRows][kChunk];
  __shared__ __align__(16) __nv_bfloat16 vs[LANES ? RMAX : 1][kVld];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * kRows;
  const int c_begin = blockIdx.y * cols;
  const int c_end = min(N, c_begin + cols);
  const int j0 = blockIdx.z * 64;  // this block's rank columns
  const int rc = min(RMAX, r - j0);
  for (int idx = tid; idx < kRows * RMAX; idx += kThreads) {
    const int row = idx / RMAX;
    const int j = idx % RMAX;
    const int k = k0 + row;
    us[row][j] = (k < K && j < rc)
                     ? __bfloat162float(u[(size_t)k * r + j0 + j])
                     : 0.f;
    dus[row][j] = 0.f;
  }
  __syncthreads();
  const uint32_t sd = static_cast<uint32_t>(*seed);

  for (int n0 = c_begin; n0 < c_end; n0 += kChunk) {
    const int n = n0 + tid;
    if constexpr (LANES) {
      // V's rows j0 .. j0 + 63, columns n0 .. n0 + 255 (zeros past the
      // rank and past c_end), two values a load.
      for (int idx = tid; idx < RMAX * kChunk / 2; idx += kThreads) {
        const int j = idx / (kChunk / 2);
        const int c = 2 * (idx % (kChunk / 2));
        __nv_bfloat162 pair = __floats2bfloat162_rn(0.f, 0.f);
        if (j < rc && n0 + c < c_end)
          pair = *reinterpret_cast<const __nv_bfloat162*>(
              v + (size_t)(j0 + j) * N + n0 + c);
        *reinterpret_cast<__nv_bfloat162*>(&vs[j][c]) = pair;
      }
    }
    float dva[RMAX];
#pragma unroll
    for (int j = 0; j < RMAX; ++j) dva[j] = 0.f;
    for (int row = 0; row < kRows; ++row) {
      const int k = k0 + row;
      float c = 0.f;
      if (k < K && n < c_end && wd_keep(k, n, sd, thr))
        c = __bfloat162float(__float2bfloat16(dt[(size_t)k * N + n] * inv));
      dtc[row][tid] = c;
#pragma unroll
      for (int j = 0; j < RMAX; ++j) dva[j] = fmaf(us[row][j], c, dva[j]);
    }
    if (n < c_end) {
      float* dst = dv_part + ((size_t)blockIdx.x * r + j0) * N + n;
#pragma unroll
      for (int j = 0; j < RMAX; ++j)
        if (j < rc) dst[(size_t)j * N] = dva[j];
    }
    __syncthreads();
    // dU of row `warp` over this chunk: sum_n dtc[n] * V[j, n].
    if constexpr (LANES) {
      const __nv_bfloat162* v0 =
          reinterpret_cast<const __nv_bfloat162*>(&vs[lane][0]);
      const __nv_bfloat162* v1 =
          reinterpret_cast<const __nv_bfloat162*>(&vs[lane + 32][0]);
      const float2* d2 = reinterpret_cast<const float2*>(&dtc[warp][0]);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int q = 0; q < kChunk / 2; ++q) {
        const float2 d = d2[q];
        const float2 x0 = __bfloat1622float2(v0[q]);
        const float2 x1 = __bfloat1622float2(v1[q]);
        a0 = fmaf(d.y, x0.y, fmaf(d.x, x0.x, a0));
        a1 = fmaf(d.y, x1.y, fmaf(d.x, x1.x, a1));
      }
      dus[warp][lane] += a0;
      dus[warp][lane + 32] += a1;
    } else
    for (int j = 0; j < rc; ++j) {
      float part = 0.f;
      for (int c = lane; c < kChunk; c += 32) {
        const int nn = n0 + c;
        if (nn < c_end)
          part = fmaf(dtc[warp][c],
                      __bfloat162float(v[(size_t)(j0 + j) * N + nn]), part);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) dus[warp][j] += part;
    }
    __syncthreads();
  }
  const int k = k0 + warp;
  if (k < K)
    for (int j = lane; j < rc; j += 32)
      du_part[((size_t)blockIdx.y * K + k) * r + j0 + j] = dus[warp][j];
}

// out[i] = sum over p (in order) of parts[p * len + i].
__global__ void sum_parts_kernel(const float* __restrict__ parts,
                                 float* __restrict__ out, int nparts,
                                 int len) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= len) return;
  float sum = 0.f;
  for (int p = 0; p < nparts; ++p) sum += parts[(size_t)p * len + idx];
  out[idx] = sum;
}

template <int RMAX>
void launch(dim3 grid, const float* dt, const __nv_bfloat16* u,
            const __nv_bfloat16* v, const int* seed, float* du_part,
            float* dv_part, int K, int N, int r, int cols, float inv,
            uint32_t thr, cudaStream_t stream) {
  wd_factor_grads_kernel<RMAX><<<grid, kThreads, 0, stream>>>(
      dt, u, v, seed, du_part, dv_part, K, N, r, cols, inv, thr);
}

}  // namespace

// dt: fp32 (K, N); u (K, r), v (r, N) bf16;
// seed one int32 on the device -> du (K, r), dv (r, N) fp32.  Scratch:
// dv_part fp32 of ceil(K / 8) * r * N, du_part fp32 of ceil(N / 256) * K
// * r.  Needs r >= 1.  Returns cudaGetLastError().
extern "C" int cara_wd_factor_grads(const void* dt, const void* u,
                                    const void* v, const void* seed, void* du,
                                    void* dv, void* dv_part, void* du_part,
                                    int K, int N, int r, float inv,
                                    unsigned thr, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // Rows alone give K / 8 blocks; split the columns too until about two
  // blocks a SM run (each split adds one dU partial).
  const int kblocks = (K + kRows - 1) / kRows;
  const int chunks = (N + kChunk - 1) / kChunk;
  const int want = max(1, min(chunks, (kSlots + kblocks - 1) / kblocks));
  const int cols = (chunks + want - 1) / want * kChunk;
  const int splits = (N + cols - 1) / cols;
  const dim3 grid(kblocks, splits, (r + 63) / 64);
  const float* d = static_cast<const float*>(dt);
  const __nv_bfloat16* uu = static_cast<const __nv_bfloat16*>(u);
  const __nv_bfloat16* vv = static_cast<const __nv_bfloat16*>(v);
  const int* sd = static_cast<const int*>(seed);
  float* dup = static_cast<float*>(du_part);
  float* dvp = static_cast<float*>(dv_part);
  if (r <= 8)
    launch<8>(grid, d, uu, vv, sd, dup, dvp, K, N, r, cols, inv, thr, stream);
  else if (r <= 16)
    launch<16>(grid, d, uu, vv, sd, dup, dvp, K, N, r, cols, inv, thr, stream);
  else if (r <= 32)
    launch<32>(grid, d, uu, vv, sd, dup, dvp, K, N, r, cols, inv, thr, stream);
  else  // 64, and past rank 64 a chunk of 64 a block
    launch<64>(grid, d, uu, vv, sd, dup, dvp, K, N, r, cols, inv, thr, stream);
  const int rn = r * N;
  sum_parts_kernel<<<(rn + 255) / 256, 256, 0, stream>>>(
      dvp, static_cast<float*>(dv), kblocks, rn);
  const int kr = K * r;
  sum_parts_kernel<<<(kr + 255) / 256, 256, 0, stream>>>(
      dup, static_cast<float*>(du), splits, kr);
  return static_cast<int>(cudaGetLastError());
}
