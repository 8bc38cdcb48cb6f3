// Key-tiled (online-softmax) attention for Hopper (sm_90a), backward.
//
// From the qkv activation (B, N, 3E), the forward's output o (B, N, E) and
// log-sum-exp lse (B, N, H) (blockwise_attention.cu) and the output
// cotangent do (B, N, E), writes dqkv (B, N, 3E) bf16 in the qkv layout
// (out-flat (3, H, Dh) columns): no transposes on either side.
//
// Replaces cara_tpu/ops/pallas/blockwise_attention.py _dq_kernel and
// _dkv_kernel (the two pallas_calls of _bwd_rule), TPU row 16, with the
// same two-kernel split, plus the row pass D = rowsum(do * o) that JAX
// computes in XLA between them:
//
//   delta  D (B, N, H) fp32, one thread per (row, head);
//   dq     one block per (image, head, 64-query tile), key tiles
//          streamed: s, p = exp(s - lse), dp = do v^T, ds, dq += ds k;
//   dk/dv  one block per (image, head, 64-key tile), query tiles
//          streamed: s^T = k q^T, p^T, dp^T = v do^T, dv += bf16(p^T) do,
//          dk += ds^T q.
//
// Each output row has one writer, so there are no atomics.  As in the
// forward, four warps of 16 rows, a two-slot cp.async ring for the
// streamed tiles (the query tiles' lse and D ride along), and bf16
// mma.sync.m16n8k16 with fragments in registers: the fp32 accumulator
// tiles of s and dp are turned into p and ds in place and packed to bf16
// as the A fragment of the next product, so no score tile touches shared
// memory.
//
// What bounds it: at B = 64, N = 577, H = 12, Dh = 64 the function needs
// five N^2 Dh products per (image, head) (s, dp, dq, dk, dv), 10 B N^2 E
// = 164 GFLOP, against ~460 MB: ~0.165 ms on the tensor cores, so
// operations.  This first version does seven: it recomputes s and dp in
// both kernels, as the TPU does; wgmma and TMA are later work.
//
// Math, as _dq_kernel / _dkv_kernel: s = (q . k) * scale in fp32 from bf16
// q and k, keys >= n_real give p = exp(-1e30 - lse) = 0; p = exp(s - lse);
// ds = bf16(p * (dp - D)); dq = (ds k) * scale; dk = (ds^T q) * scale;
// dv = bf16(p)^T do; each rounded to bf16 once.  Query rows past N are
// zero-filled and give p = 0; key rows in [n_real, N) get zero dk, dv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // H100: 227 KB per block (opt-in)
constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // rows per block and per streamed tile
constexpr int kPad = 8;

__host__ __device__ inline size_t dq_smem(int dh) {
  return (size_t)6 * kTile * (dh + kPad) * 2;  // q, do, two slots of k, v
}

__host__ __device__ inline size_t dkv_smem(int dh) {
  // k, v, two slots of q and do, two slots of the tile's lse and D
  return (size_t)6 * kTile * (dh + kPad) * 2 + (size_t)4 * kTile * 4;
}

// Stage kTile rows (row0 ..) of one head's DH columns at `src` (row
// stride `rs`) into `dst` (row stride LD); rows >= N zero-filled.
template <int DH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t rs, int row0, int N,
                                          int tid) {
  constexpr int VPR = DH / 8;
  for (int idx = tid; idx < kTile * VPR; idx += 32 * kWarps) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 8;
    const bool ok = row0 + r < N;
    cp_async16(dst + r * (DH + kPad) + c,
               src + (size_t)(ok ? row0 + r : 0) * rs + c, ok);
  }
}

// acc (16 x 64) = A (16 x DH, fragments in registers) . B^T, where B is
// kTile rows of DH in shared memory ([n][k]: the B operand's col layout).
template <int DH>
__device__ __forceinline__ void product_abt(float (&acc)[kTile / 8][4],
                                            const unsigned (&af)[DH / 16][4],
                                            const __nv_bfloat16* bs,
                                            int lane) {
  constexpr int LD = DH + kPad;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int jj = 0; jj < kTile / 16; ++jj) {
      unsigned t[4];
      ldmatrix_x4(t, bs + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma_16816(acc[2 * jj], af[kk], t);
      mma_16816(acc[2 * jj + 1], af[kk], t + 2);
    }
}

// acc (16 x DH) += bf16(T) (16 x 64, fp32 accumulator tiles in registers)
// . B, where B is kTile rows of DH in shared memory ([k][n]).
template <int DH>
__device__ __forceinline__ void product_tb(float (&acc)[DH / 8][4],
                                           const float (&t)[kTile / 8][4],
                                           const __nv_bfloat16* bs,
                                           int lane) {
  constexpr int LD = DH + kPad;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const unsigned a[4] = {pack_bf16(t[2 * kk][0], t[2 * kk][1]),
                           pack_bf16(t[2 * kk][2], t[2 * kk][3]),
                           pack_bf16(t[2 * kk + 1][0], t[2 * kk + 1][1]),
                           pack_bf16(t[2 * kk + 1][2], t[2 * kk + 1][3])};
#pragma unroll
    for (int jj = 0; jj < DH / 16; ++jj) {
      unsigned f[4];
      ldmatrix_x4_trans(
          f, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                 jj * 16 + (lane >> 4) * 8);
      mma_16816(acc[2 * jj], a, f);
      mma_16816(acc[2 * jj + 1], a, f + 2);
    }
  }
}

// The A fragments (16 rows of the warp x DH) of kTile rows in smem.
template <int DH>
__device__ __forceinline__ void load_a(unsigned (&af)[DH / 16][4],
                                       const __nv_bfloat16* rows, int warp,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldmatrix_x4(af[kk], rows + (warp * 16 + (lane & 15)) * (DH + kPad) +
                            kk * 16 + (lane >> 4) * 8);
}

// Rows g and g + 8 of the warp's 16 (row0 = the first), times `mul`, as
// bf16 at column block `dst` of dqkv; rows >= N are skipped.
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 8][4],
                                           __nv_bfloat16* dst, size_t rs,
                                           int row0, int N, float mul,
                                           int lane) {
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + half * 8;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<unsigned*>(dst + (size_t)row * rs + j * 8 + t2) =
          pack_bf16(acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
  }
}

template <int DH>
__global__ void blockwise_delta_kernel(const __nv_bfloat16* __restrict__ dout,
                                       const __nv_bfloat16* __restrict__ o,
                                       float* __restrict__ dd, int rows,
                                       int heads) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * heads) return;
  const size_t off = (size_t)(idx / heads) * heads * DH + (idx % heads) * DH;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DH; c += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(dout + off + c);
    const uint4 b = *reinterpret_cast<const uint4*>(o + off + c);
    const __nv_bfloat16* ae = reinterpret_cast<const __nv_bfloat16*>(&a);
    const __nv_bfloat16* be = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      acc += __bfloat162float(ae[t]) * __bfloat162float(be[t]);
  }
  dd[idx] = acc;
}

template <int DH>
__global__ void __launch_bounds__(32 * kWarps)
blockwise_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dqkv, int N, int heads,
                    int n_real, float scale) {
  constexpr int LD = DH + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Os = Qs + kTile * LD;      // the do rows
  __nv_bfloat16* Ks = Os + kTile * LD;      // two slots
  __nv_bfloat16* Vs = Ks + 2 * kTile * LD;  // two slots

  const int e = heads * DH;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t rs = 3 * (size_t)e;
  const __nv_bfloat16* base = qkv + (size_t)b * N * rs + h * DH;
  const int ntiles = (n_real + kTile - 1) / kTile;

  load_rows<DH>(Qs, base, rs, q0, N, tid);
  load_rows<DH>(Os, dout + (size_t)b * N * e + h * DH, e, q0, N, tid);
  load_rows<DH>(Ks, base + e, rs, 0, N, tid);
  load_rows<DH>(Vs, base + 2 * e, rs, 0, N, tid);
  cp_async_commit();

  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  float lr[2], dr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + half * 8;
    const size_t st = ((size_t)b * N + row) * heads + h;
    lr[half] = row < N ? lse[st] : 0.f;
    dr[half] = row < N ? dd[st] : 0.f;
  }
  unsigned qf[DH / 16][4], of[DH / 16][4];
  float dq[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[j][c] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) {
      const int slot = (kt + 1) & 1;
      load_rows<DH>(Ks + slot * kTile * LD, base + e, rs, (kt + 1) * kTile,
                    N, tid);
      load_rows<DH>(Vs + slot * kTile * LD, base + 2 * e, rs,
                    (kt + 1) * kTile, N, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) {
      load_a<DH>(qf, Qs, warp, lane);
      load_a<DH>(of, Os, warp, lane);
    }
    const __nv_bfloat16* ks = Ks + (kt & 1) * kTile * LD;
    const __nv_bfloat16* vs = Vs + (kt & 1) * kTile * LD;
    float s[kTile / 8][4], dp[kTile / 8][4];
    product_abt<DH>(s, qf, ks, lane);
    product_abt<DH>(dp, of, vs, lane);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = kt * kTile + j * 8 + t2 + (c & 1);
        const float p =
            col < n_real ? expf(s[j][c] * scale - lr[c >> 1]) : 0.f;
        s[j][c] = p * (dp[j][c] - dr[c >> 1]);  // ds, rounded when packed
      }
    product_tb<DH>(dq, s, ks, lane);
    __syncthreads();  // the slot just read is refilled next iteration
  }
  store_rows<DH>(dq, dqkv + (size_t)b * N * rs + h * DH, rs,
                 q0 + warp * 16, N, scale, lane);
}

template <int DH>
__global__ void __launch_bounds__(32 * kWarps)
blockwise_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd,
                     __nv_bfloat16* __restrict__ dqkv, int N, int heads,
                     int n_real, float scale) {
  constexpr int LD = DH + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTile * LD;
  __nv_bfloat16* Qs = Vs + kTile * LD;      // two slots
  __nv_bfloat16* Os = Qs + 2 * kTile * LD;  // two slots of do
  float* Ls = reinterpret_cast<float*>(Os + 2 * kTile * LD);  // two slots
  float* Ds = Ls + 2 * kTile;                                 // two slots

  const int e = heads * DH;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t rs = 3 * (size_t)e;
  const __nv_bfloat16* base = qkv + (size_t)b * N * rs + h * DH;
  const __nv_bfloat16* obase = dout + (size_t)b * N * e + h * DH;
  __nv_bfloat16* dbase = dqkv + (size_t)b * N * rs + h * DH;

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[j][c] = dv[j][c] = 0.f;
  if (k0 >= n_real) {  // every key of the tile masked: zero dk, dv
    store_rows<DH>(dk, dbase + e, rs, k0 + warp * 16, N, 1.f, lane);
    store_rows<DH>(dv, dbase + 2 * e, rs, k0 + warp * 16, N, 1.f, lane);
    return;
  }
  const int ntiles = (N + kTile - 1) / kTile;
  auto load_q = [&](int slot, int qt) {
    const int r0 = qt * kTile;
    load_rows<DH>(Qs + slot * kTile * LD, base, rs, r0, N, tid);
    load_rows<DH>(Os + slot * kTile * LD, obase, e, r0, N, tid);
    if (tid < kTile) {  // read by every warp only after a barrier
      const int row = r0 + tid;
      const size_t st = ((size_t)b * N + row) * heads + h;
      Ls[slot * kTile + tid] = row < N ? lse[st] : 0.f;
      Ds[slot * kTile + tid] = row < N ? dd[st] : 0.f;
    }
  };
  load_rows<DH>(Ks, base + e, rs, k0, N, tid);
  load_rows<DH>(Vs, base + 2 * e, rs, k0, N, tid);
  load_q(0, 0);
  cp_async_commit();

  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  bool kvalid[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    kvalid[half] = k0 + warp * 16 + g + half * 8 < n_real;
  unsigned kf[DH / 16][4], vf[DH / 16][4];

  for (int qt = 0; qt < ntiles; ++qt) {
    if (qt + 1 < ntiles) load_q((qt + 1) & 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (qt == 0) {
      load_a<DH>(kf, Ks, warp, lane);
      load_a<DH>(vf, Vs, warp, lane);
    }
    const int slot = qt & 1;
    const __nv_bfloat16* qs = Qs + slot * kTile * LD;
    const __nv_bfloat16* os = Os + slot * kTile * LD;
    const float* ls = Ls + slot * kTile;
    const float* ds = Ds + slot * kTile;
    float s[kTile / 8][4], dp[kTile / 8][4];
    product_abt<DH>(s, kf, qs, lane);  // s^T: keys x queries
    product_abt<DH>(dp, vf, os, lane);  // dp^T
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = j * 8 + t2 + (c & 1);
        const float p = kvalid[c >> 1] && qt * kTile + qi < N
                            ? expf(s[j][c] * scale - ls[qi])
                            : 0.f;
        s[j][c] = p;  // rounded to bf16 when packed for dv
        dp[j][c] = p * (dp[j][c] - ds[qi]);  // ds, from the fp32 p
      }
    product_tb<DH>(dv, s, os, lane);
    product_tb<DH>(dk, dp, qs, lane);
    __syncthreads();  // the slot just read is refilled next iteration
  }
  store_rows<DH>(dk, dbase + e, rs, k0 + warp * 16, N, scale, lane);
  store_rows<DH>(dv, dbase + 2 * e, rs, k0 + warp * 16, N, 1.f, lane);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DH>
int launch(const __nv_bfloat16* qkv, const __nv_bfloat16* o,
           const __nv_bfloat16* dout, const float* lse, float* dd,
           __nv_bfloat16* dqkv, int B, int N, int heads, int n_real,
           float scale, cudaStream_t stream) {
  static const cudaError_t attr_dq =
      allow_smem(blockwise_dq_kernel<DH>, dq_smem(DH));
  static const cudaError_t attr_dkv =
      allow_smem(blockwise_dkv_kernel<DH>, dkv_smem(DH));
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
  const int rows = B * N;
  blockwise_delta_kernel<DH><<<(rows * heads + 255) / 256, 256, 0, stream>>>(
      dout, o, dd, rows, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kTile - 1) / kTile, heads, B);
  blockwise_dq_kernel<DH><<<grid, 32 * kWarps, dq_smem(DH), stream>>>(
      qkv, dout, lse, dd, dqkv, N, heads, n_real, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  blockwise_dkv_kernel<DH><<<grid, 32 * kWarps, dkv_smem(DH), stream>>>(
      qkv, dout, lse, dd, dqkv, N, heads, n_real, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (B, N, 3E), o and do (B, N, E) bf16, lse (B, N, heads) fp32 ->
// dqkv (B, N, 3E) bf16; dd (B, N, heads) fp32 is scratch for D.  Keys >=
// n_real (1 <= n_real <= N) masked; dh must be 16, 32 or 64.  Returns
// cudaGetLastError() of the first launch that failed.
extern "C" int cara_blockwise_attention_bwd(const void* qkv, const void* o,
                                            const void* dout, const void* lse,
                                            void* dd, void* dqkv, int B,
                                            int N, int heads, int dh,
                                            int n_real, float scale,
                                            void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(o);
  const __nv_bfloat16* go = static_cast<const __nv_bfloat16*>(dout);
  const float* ls = static_cast<const float*>(lse);
  float* d = static_cast<float*>(dd);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dqkv);
  if (n_real < 1 || n_real > N || dkv_smem(dh) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16:
      return launch<16>(q, ob, go, ls, d, out, B, N, heads, n_real, scale,
                        stream);
    case 32:
      return launch<32>(q, ob, go, ls, d, out, B, N, heads, n_real, scale,
                        stream);
    case 64:
      return launch<64>(q, ob, go, ls, d, out, B, N, heads, n_real, scale,
                        stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
