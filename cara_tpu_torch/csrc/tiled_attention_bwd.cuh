// Key-tiled (online-softmax) attention for Hopper (sm_90a), backward: the
// kernels that blockwise_attention_bwd.cu (TPU row 16) and
// flash_attention_bwd.cu (TPU row 17) both launch.
//
// From q, k, v, the forward's output o and log-sum-exp lse (B, N, H)
// (tiled_attention_fwd.cuh) and the output cotangent do, writes dq, dk
// and dv in bf16.  Every (B, H, N, Dh) operand is a base pointer and its
// (batch, head, row) strides (tiled_attention_fwd.cuh's Rows), so the
// gradients land in whatever layout the caller holds (the qkv layout of
// row 16, or three (B, N, E) buffers).  Three kernels, as the TPU's split
// (the D row pass is XLA's there):
//
//   delta  D (B, N, H) fp32 = rowsum(do * o), one thread per (row, head);
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
// memory.  The function needs five N^2 Dh products per (image, head) (s,
// dp, dq, dk, dv); these kernels do seven (s and dp in both).
//
// Math: s = (q . k) * scale in fp32 from bf16 q and k, keys >= n_real give
// p = exp(-1e30 - lse) = 0; p = exp(s - lse); ds = bf16(p * (dp - D));
// dq = (ds k) * scale; dk = (ds^T q) * scale; dv = bf16(p)^T do; each
// rounded to bf16 once.  Query rows past N are zero-filled and give p = 0;
// key rows in [n_real, N) get zero dk, dv.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "tiled_attention_fwd.cuh"

namespace tiled_attention {
namespace {

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
                                          long long rs, int row0, int N,
                                          int tid) {
  constexpr int VPR = DH / 8;
  for (int idx = tid; idx < kTile * VPR; idx += 32 * kWarps) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 8;
    const bool ok = row0 + r < N;
    cp_async16(dst + r * (DH + kPad) + c,
               src + (long long)(ok ? row0 + r : 0) * rs + c, ok);
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
// bf16 at `dst` (row stride rs); rows >= N are skipped.
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 8][4],
                                           __nv_bfloat16* dst, long long rs,
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
      *reinterpret_cast<unsigned*>(dst + row * rs + j * 8 + t2) =
          pack_bf16(acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
  }
}

template <int DH>
__global__ void attention_delta_kernel(const __nv_bfloat16* __restrict__ dout,
                                       Rows sdo,
                                       const __nv_bfloat16* __restrict__ o,
                                       Rows so, float* __restrict__ dd,
                                       int B, int N, int heads) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * N * heads) return;
  const int h = idx % heads;
  const long long row = idx / heads;
  const int b = row / N;
  const int n = row % N;
  const __nv_bfloat16* dr = head_rows(dout, sdo, b, h) + n * sdo.sr;
  const __nv_bfloat16* orow = head_rows(o, so, b, h) + n * so.sr;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DH; c += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(dr + c);
    const uint4 bv = *reinterpret_cast<const uint4*>(orow + c);
    const __nv_bfloat16* ae = reinterpret_cast<const __nv_bfloat16*>(&a);
    const __nv_bfloat16* be = reinterpret_cast<const __nv_bfloat16*>(&bv);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      acc += __bfloat162float(ae[t]) * __bfloat162float(be[t]);
  }
  dd[idx] = acc;
}

// The operands of one backward call.
struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  Rows sq, sk, sv, sdo;
  const float *lse, *dd;
  __nv_bfloat16 *dq, *dk, *dv;
  Rows sdq, sdk, sdv;
  int N, heads, n_real;
  float scale;
};

template <int DH>
__global__ void __launch_bounds__(32 * kWarps)
attention_dq_kernel(const BwdArgs a) {
  constexpr int LD = DH + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Os = Qs + kTile * LD;      // the do rows
  __nv_bfloat16* Ks = Os + kTile * LD;      // two slots
  __nv_bfloat16* Vs = Ks + 2 * kTile * LD;  // two slots

  const int N = a.N;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const __nv_bfloat16* kb = head_rows(a.k, a.sk, b, h);
  const __nv_bfloat16* vb = head_rows(a.v, a.sv, b, h);
  const int ntiles = (a.n_real + kTile - 1) / kTile;

  load_rows<DH>(Qs, head_rows(a.q, a.sq, b, h), a.sq.sr, q0, N, tid);
  load_rows<DH>(Os, head_rows(a.dout, a.sdo, b, h), a.sdo.sr, q0, N, tid);
  load_rows<DH>(Ks, kb, a.sk.sr, 0, N, tid);
  load_rows<DH>(Vs, vb, a.sv.sr, 0, N, tid);
  cp_async_commit();

  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  float lr[2], dr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + half * 8;
    const size_t st = ((size_t)b * N + row) * a.heads + h;
    lr[half] = row < N ? a.lse[st] : 0.f;
    dr[half] = row < N ? a.dd[st] : 0.f;
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
      load_rows<DH>(Ks + slot * kTile * LD, kb, a.sk.sr, (kt + 1) * kTile,
                    N, tid);
      load_rows<DH>(Vs + slot * kTile * LD, vb, a.sv.sr, (kt + 1) * kTile,
                    N, tid);
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
            col < a.n_real ? expf(s[j][c] * a.scale - lr[c >> 1]) : 0.f;
        s[j][c] = p * (dp[j][c] - dr[c >> 1]);  // ds, rounded when packed
      }
    product_tb<DH>(dq, s, ks, lane);
    __syncthreads();  // the slot just read is refilled next iteration
  }
  store_rows<DH>(dq, head_rows(a.dq, a.sdq, b, h), a.sdq.sr, q0 + warp * 16,
                 N, a.scale, lane);
}

template <int DH>
__global__ void __launch_bounds__(32 * kWarps)
attention_dkv_kernel(const BwdArgs a) {
  constexpr int LD = DH + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTile * LD;
  __nv_bfloat16* Qs = Vs + kTile * LD;      // two slots
  __nv_bfloat16* Os = Qs + 2 * kTile * LD;  // two slots of do
  float* Ls = reinterpret_cast<float*>(Os + 2 * kTile * LD);  // two slots
  float* Ds = Ls + 2 * kTile;                                 // two slots

  const int N = a.N;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const __nv_bfloat16* qb = head_rows(a.q, a.sq, b, h);
  const __nv_bfloat16* ob = head_rows(a.dout, a.sdo, b, h);
  __nv_bfloat16* dkb = head_rows(a.dk, a.sdk, b, h);
  __nv_bfloat16* dvb = head_rows(a.dv, a.sdv, b, h);

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[j][c] = dv[j][c] = 0.f;
  if (k0 >= a.n_real) {  // every key of the tile masked: zero dk, dv
    store_rows<DH>(dk, dkb, a.sdk.sr, k0 + warp * 16, N, 1.f, lane);
    store_rows<DH>(dv, dvb, a.sdv.sr, k0 + warp * 16, N, 1.f, lane);
    return;
  }
  const int ntiles = (N + kTile - 1) / kTile;
  auto load_q = [&](int slot, int qt) {
    const int r0 = qt * kTile;
    load_rows<DH>(Qs + slot * kTile * LD, qb, a.sq.sr, r0, N, tid);
    load_rows<DH>(Os + slot * kTile * LD, ob, a.sdo.sr, r0, N, tid);
    if (tid < kTile) {  // read by every warp only after a barrier
      const int row = r0 + tid;
      const size_t st = ((size_t)b * N + row) * a.heads + h;
      Ls[slot * kTile + tid] = row < N ? a.lse[st] : 0.f;
      Ds[slot * kTile + tid] = row < N ? a.dd[st] : 0.f;
    }
  };
  load_rows<DH>(Ks, head_rows(a.k, a.sk, b, h), a.sk.sr, k0, N, tid);
  load_rows<DH>(Vs, head_rows(a.v, a.sv, b, h), a.sv.sr, k0, N, tid);
  load_q(0, 0);
  cp_async_commit();

  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  bool kvalid[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    kvalid[half] = k0 + warp * 16 + g + half * 8 < a.n_real;
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
                            ? expf(s[j][c] * a.scale - ls[qi])
                            : 0.f;
        s[j][c] = p;  // rounded to bf16 when packed for dv
        dp[j][c] = p * (dp[j][c] - ds[qi]);  // ds, from the fp32 p
      }
    product_tb<DH>(dv, s, os, lane);
    product_tb<DH>(dk, dp, qs, lane);
    __syncthreads();  // the slot just read is refilled next iteration
  }
  store_rows<DH>(dk, dkb, a.sdk.sr, k0 + warp * 16, N, a.scale, lane);
  store_rows<DH>(dv, dvb, a.sdv.sr, k0 + warp * 16, N, 1.f, lane);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DH>
int launch_bwd(const BwdArgs& a, const __nv_bfloat16* o, Rows so, float* dd,
               int B, cudaStream_t stream) {
  static const cudaError_t attr_dq =
      allow_smem(attention_dq_kernel<DH>, dq_smem(DH));
  static const cudaError_t attr_dkv =
      allow_smem(attention_dkv_kernel<DH>, dkv_smem(DH));
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
  const long long threads = (long long)B * a.N * a.heads;
  attention_delta_kernel<DH><<<(unsigned)((threads + 255) / 256), 256, 0,
                               stream>>>(a.dout, a.sdo, o, so, dd, B, a.N,
                                         a.heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.N + kTile - 1) / kTile, a.heads, B);
  attention_dq_kernel<DH><<<grid, 32 * kWarps, dq_smem(DH), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_dkv_kernel<DH><<<grid, 32 * kWarps, dkv_smem(DH), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tiled_attention
