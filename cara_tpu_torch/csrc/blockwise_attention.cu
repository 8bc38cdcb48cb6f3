// Key-tiled (online-softmax) attention for Hopper (sm_90a), forward.
//
// Reads the fused qkv GEMM output (B, N, 3E) as it lies — out-flat
// (3, H, Dh) columns, so head h's q, k and v start at columns h*Dh,
// E + h*Dh and 2E + h*Dh — and writes the attention output (B, N, E) bf16
// and the per-row log-sum-exp (B, N, H) fp32 that the backward
// (blockwise_attention_bwd.cu) reads.
//
// Replaces cara_tpu/ops/pallas/blockwise_attention.py _fwd_kernel (the
// pallas_call in _fwd), TPU row 16: the attention the TPU takes once the
// padded token count passes the full-score kernel's 512 (ViT-B/16 at
// 384 px, 577 tokens).  The TPU kernel walks (bq, bk) = up to 512-wide
// tiles over a sequential key grid axis with m, l and the output
// accumulator in VMEM scratch.  Here one block serves one (image, head,
// 64-query tile): four warps of 16 query rows, the key axis streamed in
// 64-key tiles of K and V through shared memory by a two-slot cp.async
// ring (the next tile loads while this one is multiplied).  Every
// product runs on bf16 mma.sync.m16n8k16 with its fragments in registers:
// S = Q K^T stays in the accumulator registers, the online-softmax update
// (running max, rescale, row sums) runs on them in fp32, and P is packed
// to bf16 straight into the A fragment of P V (the accumulator layout of
// two 16x8 tiles is the A layout of one 16x16 tile), so no score tile
// touches shared memory.
//
// What bounds it: at B = 64, N = 577, H = 12, Dh = 64 the call does
// 4 B N^2 E = 65.5 GFLOP against ~230 MB, ~0.066 ms on the tensor cores
// and ~0.069 ms on HBM, so both about equally.  This first version is
// mma.sync at 46 KB of shared memory a block; wgmma, TMA and a wider
// query tile per block are later work.
//
// Math, as _fwd_kernel: fp32 scores s = (q . k) * scale from bf16 q and k
// (q is not pre-scaled in bf16, unlike fused_qkv_attention); keys >=
// n_real set to -1e30; per key tile m' = max(m, rowmax s), p = exp(s - m'),
// l = l * exp(m - m') + rowsum p, acc = acc * exp(m - m') + bf16(p) . v;
// out = bf16(acc / l) (l = 0 read as 1), lse = m + log(max(l, 1e-30)).
// Key tiles wholly past n_real are skipped (their p is 0 and their
// rescale 1, exactly); rows and keys past N are zero-filled and never
// written, so N needs no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // H100: 227 KB per block (opt-in)
constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kKeys = 64;           // keys per streamed tile
constexpr int kPad = 8;             // smem row pad (bf16), against bank conflicts

__host__ __device__ inline size_t smem_bytes(int dh) {
  return (size_t)(kRows + 4 * kKeys) * (dh + kPad) * 2;
}

template <int DH>
__global__ void __launch_bounds__(32 * kWarps)
blockwise_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int N, int heads,
                           int n_real, float scale) {
  constexpr int LD = DH + kPad;
  constexpr int VPR = DH / 8;  // 16-byte vectors per head row
  constexpr int NT = kKeys / 8;  // 16x8 score tiles per warp and key tile
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kRows * LD;       // two slots of kKeys rows
  __nv_bfloat16* Vs = Ks + 2 * kKeys * LD;   // two slots of kKeys rows

  const int e = heads * DH;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t rs = 3 * (size_t)e;
  const __nv_bfloat16* base = qkv + (size_t)b * N * rs + h * DH;
  const int ntiles = (n_real + kKeys - 1) / kKeys;

  auto load_kv = [&](int slot, int kt) {
    __nv_bfloat16* ks = Ks + slot * kKeys * LD;
    __nv_bfloat16* vs = Vs + slot * kKeys * LD;
    for (int idx = tid; idx < kKeys * VPR; idx += 32 * kWarps) {
      const int r = idx / VPR;
      const int c = (idx % VPR) * 8;
      const int key = kt * kKeys + r;
      const bool ok = key < N;
      const __nv_bfloat16* src = base + (size_t)(ok ? key : 0) * rs + c;
      cp_async16(ks + r * LD + c, src + e, ok);
      cp_async16(vs + r * LD + c, src + 2 * e, ok);
    }
  };
  for (int idx = tid; idx < kRows * VPR; idx += 32 * kWarps) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 8;
    const bool ok = q0 + r < N;
    cp_async16(Qs + r * LD + c, base + (size_t)(ok ? q0 + r : 0) * rs + c,
               ok);
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
    const __nv_bfloat16* ks = Ks + (kt & 1) * kKeys * LD;
    const __nv_bfloat16* vs = Vs + (kt & 1) * kKeys * LD;

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
        const int col = kt * kKeys + j * 8 + t2 + (c & 1);
        const float v = col < n_real ? s[j][c] * scale : kNegInf;
        s[j][c] = v;
        mx[c >> 1] = fmaxf(mx[c >> 1], v);
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
    for (int kk = 0; kk < kKeys / 16; ++kk) {
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
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + half * 8;
    if (row >= N) continue;
    const float lt = l[half] == 0.f ? 1.f : l[half];
    __nv_bfloat16* orow = out + ((size_t)b * N + row) * e + h * DH;
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
int launch(const __nv_bfloat16* qkv, __nv_bfloat16* out, float* lse, int B,
           int N, int heads, int n_real, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(DH);
  static const cudaError_t attr = cudaFuncSetAttribute(
      blockwise_attention_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((N + kRows - 1) / kRows, heads, B);
  blockwise_attention_kernel<DH><<<grid, 32 * kWarps, smem, stream>>>(
      qkv, out, lse, N, heads, n_real, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (B, N, 3E) bf16 -> out (B, N, E) bf16 and lse (B, N, heads) fp32;
// keys >= n_real (1 <= n_real <= N) masked.  dh must be 16, 32 or 64.
// Returns cudaGetLastError() (or the shared-memory attribute's error).
extern "C" int cara_blockwise_attention(const void* qkv, void* out, void* lse,
                                        int B, int N, int heads, int dh,
                                        int n_real, float scale,
                                        void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* ls = static_cast<float*>(lse);
  if (n_real < 1 || n_real > N || smem_bytes(dh) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16: return launch<16>(in, o, ls, B, N, heads, n_real, scale, stream);
    case 32: return launch<32>(in, o, ls, B, N, heads, n_real, scale, stream);
    case 64: return launch<64>(in, o, ls, B, N, heads, n_real, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
