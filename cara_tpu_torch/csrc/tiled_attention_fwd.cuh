// Key-tiled (online-softmax) attention for Hopper (sm_90a), forward: the
// tile loop that blockwise_attention.cu (TPU row 16, the qkv layout) and
// flash_attention.cu (TPU row 17, separate q, k, v) both launch.
//
// Every operand is one (B, H, N, Dh) tensor given by a base pointer and
// its (batch, head, row) strides in elements, the head dimension
// contiguous, so the callers pass the views they hold as they lie: the
// (B, N, 3E) qkv GEMM output (row stride 3E, head stride Dh; k and v at
// column offsets E and 2E), transposed (B, H, N, Dh) views of it, or a
// (B, N, E) output buffer (row stride E).  Rows must start on 16 bytes:
// every stride a multiple of 8 elements, every base pointer 16-byte
// aligned.  The per-row log-sum-exp that the backward
// (tiled_attention_bwd.cuh) reads is (B, N, H) fp32, contiguous.
//
// One block serves one (image, head, 64-query tile): four warps of 16
// query rows, the key axis streamed in 64-key tiles of K and V through
// shared memory by a two-slot cp.async ring (the next tile loads while
// this one is multiplied).  Every product runs on bf16 mma.sync.m16n8k16
// with its fragments in registers: S = Q K^T stays in the accumulator
// registers, the online-softmax update (running max, rescale, row sums)
// runs on them in fp32, and P is packed to bf16 straight into the A
// fragment of P V (the accumulator layout of two 16x8 tiles is the A
// layout of one 16x16 tile), so no score tile touches shared memory.
// 46 KB of shared memory a block at Dh = 64.
//
// Math: fp32 scores s = (q . k) * scale from bf16 q and k (q is not
// pre-scaled in bf16); keys >= n_real set to -1e30; per key tile
// m' = max(m, rowmax s), p = exp(s - m'), l = l * exp(m - m') + rowsum p,
// acc = acc * exp(m - m') + bf16(p) . v; out = bf16(acc / l) (l = 0 read
// as 1), lse = m + log(max(l, 1e-30)).  Key tiles wholly past n_real are
// skipped (their p is 0 and their rescale 1, exactly); rows and keys past
// N are zero-filled and never written, so N needs no padding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

// Internal linkage: each source that includes this header gets its own
// copy of the kernels (no template symbols shared across objects).
namespace tiled_attention {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // H100: 227 KB per block (opt-in)
constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // query rows per block, keys per tile
constexpr int kPad = 8;  // smem row pad (bf16), against bank conflicts

// One (B, H, N, Dh) operand: row n of head h of image b starts at
// ptr + b * sb + h * sh + n * sr.
struct Rows {
  long long sb, sh, sr;
};

template <typename T>
__device__ __forceinline__ T* head_rows(T* ptr, const Rows& s, int b,
                                        int h) {
  return ptr + b * s.sb + h * s.sh;
}

__host__ __device__ inline size_t fwd_smem(int dh) {
  return (size_t)(kTile + 4 * kTile) * (dh + kPad) * 2;
}

template <int DH>
__global__ void __launch_bounds__(32 * kWarps)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, Rows sq,
                     const __nv_bfloat16* __restrict__ k, Rows sk,
                     const __nv_bfloat16* __restrict__ v, Rows sv,
                     __nv_bfloat16* __restrict__ out, Rows so,
                     float* __restrict__ lse, int N, int heads, int n_real,
                     float scale) {
  constexpr int LD = DH + kPad;
  constexpr int VPR = DH / 8;  // 16-byte vectors per head row
  constexpr int NT = kTile / 8;  // 16x8 score tiles per warp and key tile
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kTile * LD;      // two slots of kTile rows
  __nv_bfloat16* Vs = Ks + 2 * kTile * LD;  // two slots of kTile rows

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const __nv_bfloat16* qb = head_rows(q, sq, b, h);
  const __nv_bfloat16* kb = head_rows(k, sk, b, h);
  const __nv_bfloat16* vb = head_rows(v, sv, b, h);
  const int ntiles = (n_real + kTile - 1) / kTile;

  auto load_kv = [&](int slot, int kt) {
    __nv_bfloat16* ks = Ks + slot * kTile * LD;
    __nv_bfloat16* vs = Vs + slot * kTile * LD;
    for (int idx = tid; idx < kTile * VPR; idx += 32 * kWarps) {
      const int r = idx / VPR;
      const int c = (idx % VPR) * 8;
      const int key = kt * kTile + r;
      const bool ok = key < N;
      const long long row = ok ? key : 0;
      cp_async16(ks + r * LD + c, kb + row * sk.sr + c, ok);
      cp_async16(vs + r * LD + c, vb + row * sv.sr + c, ok);
    }
  };
  for (int idx = tid; idx < kTile * VPR; idx += 32 * kWarps) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 8;
    const bool ok = q0 + r < N;
    const long long row = ok ? q0 + r : 0;
    cp_async16(Qs + r * LD + c, qb + row * sq.sr + c, ok);
  }
  load_kv(0, 0);
  cp_async_commit();

  // Thread (g, t) of a warp holds rows g and g + 8 of its 16, columns
  // 2t and 2t + 1 of every 16x8 accumulator tile.
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  unsigned qf[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) load_kv((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
    }
    const __nv_bfloat16* ks = Ks + (kt & 1) * kTile * LD;
    const __nv_bfloat16* vs = Vs + (kt & 1) * kTile * LD;

    // S = Q K^T: K lies [key][d], the B operand's col layout.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        unsigned t[4];
        ldmatrix_x4(t, ks + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_16816(s[2 * jj], qf[kk], t);
        mma_16816(s[2 * jj + 1], qf[kk], t + 2);
      }

    // Online softmax in fp32 on the accumulators.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = kt * kTile + j * 8 + t2 + (c & 1);
        const float val = col < n_real ? s[j][c] * scale : kNegInf;
        s[j][c] = val;
        mx[c >> 1] = fmaxf(mx[c >> 1], val);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[j][c] - m[c >> 1]);
        s[j][c] = p;
        l[c >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[j][c] *= corr[c >> 1];

    // O += bf16(P) V: P from the registers, V [key][d] as [k][n].
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < DH / 16; ++jj) {
        unsigned t[4];
        ldmatrix_x4_trans(
            t, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                   jj * 16 + (lane >> 4) * 8);
        mma_16816(o[2 * jj], a, t);
        mma_16816(o[2 * jj + 1], a, t + 2);
      }
    }
    __syncthreads();  // the slot just read is refilled next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = head_rows(out, so, b, h);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + half * 8;
    if (row >= N) continue;
    const float lt = l[half] == 0.f ? 1.f : l[half];
    __nv_bfloat16* orow = ob + row * so.sr;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<unsigned*>(orow + j * 8 + t2) =
          pack_bf16(o[j][2 * half] / lt, o[j][2 * half + 1] / lt);
    if ((lane & 3) == 0)
      lse[((size_t)b * N + row) * heads + h] =
          m[half] + logf(fmaxf(l[half], 1e-30f));
  }
}

template <int DH>
int launch_fwd(const __nv_bfloat16* q, Rows sq, const __nv_bfloat16* k,
               Rows sk, const __nv_bfloat16* v, Rows sv, __nv_bfloat16* out,
               Rows so, float* lse, int B, int N, int heads, int n_real,
               float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem(DH);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((N + kTile - 1) / kTile, heads, B);
  attention_fwd_kernel<DH><<<grid, 32 * kWarps, smem, stream>>>(
      q, sq, k, sk, v, sv, out, so, lse, N, heads, n_real, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tiled_attention
