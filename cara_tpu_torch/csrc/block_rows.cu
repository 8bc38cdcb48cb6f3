// Row and column passes around the GEMMs of the block kernels (sm_90a).
//
// The TPU kernels (cara_tpu/ops/pallas/cp_dense.py _cp_dense_kernel,
// cp_attn_block.py, cp_mlp.py, forward and backward) do these steps on
// resident VMEM tiles between their products; on Hopper they are separate
// memory-bound passes around the products of sm90_gemm.cuh (grad_gemm.cu,
// cp_site.cu):
//
//   ln_rows          xa = bf16(LN(x))                (_ln_rows: a forward
//                    site's LayerNorm prologue, and the normalized row the
//                    backward's dT1 = xa^T dqkv / xa^T dpre reads)
//   gate_rows        g2 = bf16(g * dpm[row])         (the drop-path gate)
//   ln_bwd_residual  dx = bf16(g + LN'(x) . dxa)     (_ln_input_bwd + the
//                    residual path of the cotangent; g null: no residual,
//                    the LayerNorm input-backward of _cp_dense_dx_kernel)
//   colsum           fp32 column sums (bias cotangents), two passes in a
//                    fixed order, no atomics
//   gate_colsum      g2 = bf16(g * gate[row / per]) and the fp32 column
//                    sums of g2 (the fc2 / proj bias cotangent) in one
//                    launch: the saved-residual backwards' gate and sum
//
// One warp per row for the LayerNorm passes (E = 768 at ViT-B: ln_rows
// holds the row in registers and reads it once, ln_bwd_residual reads it
// three or four times from L1); 16-byte vectors for the gate.  Each pass
// is bound by its bytes (12608 rows of 768 at ViT-B: a few MB, a few
// microseconds).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mean and 1/sqrt(var + eps) of one row in fp32, two passes (as _ln_rows
// computes mean(square(x - mu))); every lane gets both.
__device__ __forceinline__ void row_moments(const __nv_bfloat16* xr, int K,
                                            float eps, int lane, float& mu,
                                            float& rs) {
  float sum = 0.f;
  for (int k = lane; k < K; k += 32) sum += bf(xr[k]);
  mu = warp_sum(sum) / K;
  float sq = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = bf(xr[k]) - mu;
    sq += d * d;
  }
  rs = rsqrtf(warp_sum(sq) / K + eps);
}

// One warp per row, the row held in registers: VPL 16-byte vectors a lane
// (K <= 256 VPL, K % 8 == 0), read once; mean and 1/sqrt(var + eps) in
// fp32, two passes over the registers (as _ln_rows computes
// mean(square(x - mu))), then the scale and bias, rounded to bf16 and
// stored 16 bytes a lane.  Bound by its bytes: 2 M K read and written.
template <int VPL>
__global__ void ln_rows_kernel(const __nv_bfloat16* __restrict__ x,
                               const __nv_bfloat16* __restrict__ ls,
                               const __nv_bfloat16* __restrict__ lb,
                               __nv_bfloat16* __restrict__ out, int M, int K,
                               float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  const int vecs = K / 8;
  uint4 raw[VPL];
  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int c = lane + 32 * v;
    raw[v] = c < vecs ? xr[c] : make_uint4(0, 0, 0, 0);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw[v]);
#pragma unroll
    for (int q = 0; q < 8; ++q) sum += bf(e[q]);
  }
  const float mu = warp_sum(sum) / K;
  float sq = 0.f;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    if (lane + 32 * v >= vecs) continue;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw[v]);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float d = bf(e[q]) - mu;
      sq += d * d;
    }
  }
  const float rs = rsqrtf(warp_sum(sq) / K + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * K);
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int c = lane + 32 * v;
    if (c >= vecs) continue;
    const uint4 sv = reinterpret_cast<const uint4*>(ls)[c];
    const uint4 bv = reinterpret_cast<const uint4*>(lb)[c];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw[v]);
    const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(&sv);
    const __nv_bfloat16* bi = reinterpret_cast<const __nv_bfloat16*>(&bv);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      e[q] = __float2bfloat16((bf(e[q]) - mu) * rs * bf(sc[q]) + bf(bi[q]));
    orow[c] = raw[v];
  }
}

__global__ void gate_rows_kernel(const __nv_bfloat16* __restrict__ g,
                                 const float* __restrict__ dpm,
                                 __nv_bfloat16* __restrict__ out, int M,
                                 int N) {
  const size_t vec = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_row = N / 8;
  if (vec >= (size_t)M * per_row) return;
  const float gate = dpm[vec / per_row];
  uint4 raw = reinterpret_cast<const uint4*>(g)[vec];
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int t = 0; t < 8; ++t) e[t] = __float2bfloat16(bf(e[t]) * gate);
  reinterpret_cast<uint4*>(out)[vec] = raw;
}

// dx = bf16(g + rstd * (dyg - mean(dyg) - xn * mean(dyg * xn))), with
// dyg = dxa * ln_scale and xn the normalized row of x (frozen scale and
// bias: the TPU kernels return zero cotangents for them).
__global__ void ln_bwd_residual_kernel(const __nv_bfloat16* __restrict__ x,
                                       const float* __restrict__ dxa,
                                       const __nv_bfloat16* __restrict__ ls,
                                       const __nv_bfloat16* __restrict__ g,
                                       __nv_bfloat16* __restrict__ out, int M,
                                       int K, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t off = (size_t)row * K;
  const __nv_bfloat16* xr = x + off;
  const float* dr = dxa + off;
  float mu, rs;
  row_moments(xr, K, eps, lane, mu, rs);
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float dyg = dr[k] * bf(ls[k]);
    s1 += dyg;
    s2 += dyg * ((bf(xr[k]) - mu) * rs);
  }
  const float m1 = warp_sum(s1) / K;
  const float m2 = warp_sum(s2) / K;
  for (int k = lane; k < K; k += 32) {
    const float xn = (bf(xr[k]) - mu) * rs;
    const float dyg = dr[k] * bf(ls[k]);
    const float res = g ? bf(g[off + k]) : 0.f;
    out[off + k] = __float2bfloat16(res + rs * (dyg - m1 - xn * m2));
  }
}

// out[y, n] = sum of in[m, n] over rows m in [y * R, (y + 1) * R).
template <typename T>
__global__ void colsum_kernel(const T* __restrict__ in,
                              float* __restrict__ out, int M, int N, int R) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int m0 = blockIdx.y * R;
  const int m1 = min(M, m0 + R);
  float sum = 0.f;
  for (int m = m0; m < m1; ++m) {
    if constexpr (sizeof(T) == 4)
      sum += in[(size_t)m * N + n];
    else
      sum += bf(in[(size_t)m * N + n]);
  }
  out[(size_t)blockIdx.y * N + n] = sum;
}

constexpr int kRowsPerBlock = 8;  // warps per block of the row passes
constexpr int kColRows = 128;     // rows per block of the first colsum pass

// gate_colsum: a block takes kGateRows rows of a stripe of kGateVecs
// 8-column vectors; its kGateLanes row lanes each walk every kGateLanes-th
// row of them.  Each block writes its column sums (the lanes' added in
// lane order) to partial[blockIdx.y]; the last block of a stripe to
// finish (a counter a stripe, set back to 0 after) adds the stripe's
// partials in order of blockIdx.y.  Every sum has a fixed order: two
// calls agree bit for bit.
constexpr int kGateVecs = 32;
constexpr int kGateLanes = 8;
constexpr int kGateRows = 128;

__global__ void __launch_bounds__(kGateVecs * kGateLanes)
gate_colsum_kernel(const __nv_bfloat16* __restrict__ g,
                   const __nv_bfloat16* __restrict__ gate, int per,
                   __nv_bfloat16* __restrict__ out, float* partial,
                   float* __restrict__ ds, int* count, int M, int N) {
  __shared__ float red[kGateLanes][kGateVecs * 8];
  __shared__ bool last;
  const int vl = threadIdx.x % kGateVecs;
  const int lane = threadIdx.x / kGateVecs;
  const int v = blockIdx.x * kGateVecs + vl;  // 8-column vector
  const int vecs = N / 8;
  const int m0 = blockIdx.y * kGateRows;
  const int m1 = min(M, m0 + kGateRows);
  float sum[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) sum[t] = 0.f;
  if (v < vecs) {
#pragma unroll 4
    for (int m = m0 + lane; m < m1; m += kGateLanes) {
      const float gt = bf(gate[m / per]);
      uint4 raw = reinterpret_cast<const uint4*>(g + (size_t)m * N)[v];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        e[t] = __float2bfloat16(bf(e[t]) * gt);
        sum[t] += bf(e[t]);
      }
      reinterpret_cast<uint4*>(out + (size_t)m * N)[v] = raw;
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) red[lane][vl * 8 + t] = sum[t];
  __syncthreads();
  if (lane == 0 && v < vecs) {
    float* dst = partial + (size_t)blockIdx.y * N + 8 * v;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kGateLanes; ++q) acc += red[q][vl * 8 + t];
      dst[t] = acc;
    }
  }
  // The partial is in memory before the counter moves.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&count[blockIdx.x], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int t = 0; t < 8; ++t) sum[t] = 0.f;
  if (v < vecs) {
#pragma unroll 4
    for (int y = lane; y < (int)gridDim.y; y += kGateLanes) {
      const float* src = partial + (size_t)y * N + 8 * v;
#pragma unroll
      for (int t = 0; t < 8; ++t) sum[t] += __ldcg(src + t);
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) red[lane][vl * 8 + t] = sum[t];
  __syncthreads();
  if (lane == 0 && v < vecs) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kGateLanes; ++q) acc += red[q][vl * 8 + t];
      ds[8 * v + t] = acc;
    }
  }
  if (threadIdx.x == 0) count[blockIdx.x] = 0;
}

}  // namespace

// xa (M, K) bf16 = LN(x) with bf16 scale and bias: the forward sites'
// LayerNorm prologue (cp_site.cu's A operand) and the backward's xa.
// Needs K % 8 == 0, K <= 4096 and 16-byte aligned pointers.
extern "C" int cara_ln_rows(const void* x, const void* ls, const void* lb,
                            void* out, int M, int K, float eps,
                            void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (K % 8 || K > 4096) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  const int threads = kRowsPerBlock * 32;
  const auto* xx = static_cast<const __nv_bfloat16*>(x);
  const auto* ss = static_cast<const __nv_bfloat16*>(ls);
  const auto* bb = static_cast<const __nv_bfloat16*>(lb);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  const int vpl = (K / 8 + 31) / 32;  // 16-byte vectors a lane
  if (vpl <= 1)
    ln_rows_kernel<1><<<grid, threads, 0, stream>>>(xx, ss, bb, oo, M, K, eps);
  else if (vpl <= 2)
    ln_rows_kernel<2><<<grid, threads, 0, stream>>>(xx, ss, bb, oo, M, K, eps);
  else if (vpl <= 3)
    ln_rows_kernel<3><<<grid, threads, 0, stream>>>(xx, ss, bb, oo, M, K, eps);
  else if (vpl <= 4)
    ln_rows_kernel<4><<<grid, threads, 0, stream>>>(xx, ss, bb, oo, M, K, eps);
  else if (vpl <= 8)
    ln_rows_kernel<8><<<grid, threads, 0, stream>>>(xx, ss, bb, oo, M, K, eps);
  else
    ln_rows_kernel<16><<<grid, threads, 0, stream>>>(xx, ss, bb, oo, M, K,
                                                     eps);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) bf16 = g * dpm[row] (dpm fp32 (M,)); N % 8 == 0.
extern "C" int cara_gate_rows(const void* g, const void* dpm, void* out,
                              int M, int N, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (N % 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t vecs = (size_t)M * (N / 8);
  gate_rows_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(dpm),
      static_cast<__nv_bfloat16*>(out), M, N);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) bf16 = g * gate[row / per] (gate bf16, one value for each
// `per` rows) and ds (N,) fp32 = the column sums of out.  partial is fp32
// scratch of ceil(M / 128) * N, count int32 zeros, one for each stripe of
// 256 columns (ceil(N / 256)), zero again when the launch ends.  N % 8 ==
// 0, 16-byte aligned g and out.
extern "C" int cara_gate_colsum(const void* g, const void* gate, int per,
                                void* out, void* partial, void* ds,
                                void* count, int M, int N,
                                void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (N % 8 || per < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N / 8 + kGateVecs - 1) / kGateVecs,
                  (M + kGateRows - 1) / kGateRows);
  gate_colsum_kernel<<<grid, kGateVecs * kGateLanes, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(gate), per,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial),
      static_cast<float*>(ds), static_cast<int*>(count), M, N);
  return static_cast<int>(cudaGetLastError());
}

// dx (M, K) bf16 from x (M, K) bf16, dxa (M, K) fp32, ln_scale (K,) bf16
// and the residual cotangent g (M, K) bf16 (null: none).
extern "C" int cara_ln_bwd_residual(const void* x, const void* dxa,
                                    const void* ls, const void* g, void* out,
                                    int M, int K, float eps,
                                    void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  ln_bwd_residual_kernel<<<(M + kRowsPerBlock - 1) / kRowsPerBlock,
                           kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dxa),
      static_cast<const __nv_bfloat16*>(ls),
      static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(out), M, K, eps);
  return static_cast<int>(cudaGetLastError());
}

// Column sums of in (M, N), bf16 (is_f32 = 0) or fp32, into out (N,)
// fp32.  partial is fp32 scratch of ceil(M / 128) * N.
extern "C" int cara_colsum(const void* in, int is_f32, void* out,
                           void* partial, int M, int N, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int chunks = (M + kColRows - 1) / kColRows;
  float* first = chunks > 1 ? static_cast<float*>(partial)
                            : static_cast<float*>(out);
  dim3 grid((N + 255) / 256, chunks);
  if (is_f32)
    colsum_kernel<float><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(in), first, M, N, kColRows);
  else
    colsum_kernel<__nv_bfloat16><<<grid, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(in), first, M, N, kColRows);
  if (chunks > 1)
    colsum_kernel<float><<<dim3((N + 255) / 256, 1), 256, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<float*>(out),
        chunks, N, chunks);
  return static_cast<int>(cudaGetLastError());
}
