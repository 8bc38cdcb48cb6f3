// Attention + projection + CaRA delta in one kernel, for Hopper (sm_90a):
//
//   y = o @ W + b + s * ((o @ U) @ V + cb),   o = attention(qkv)
//
// qkv (B, N, 3E) bf16 out-flat (3, H, Dh) as the qkv site writes it,
// W (E, E), b (E,), U (E, r) given r8 columns wide (zero past r), V
// (r, E), cb (E,), y (B, N, E) bf16; fp32 accumulation.
//
// Replaces cara_tpu/ops/pallas/fused_qkv_attention.py row 3
// (fused_qkv_attention_proj: _fwd_proj, _fwd_proj_kernel), whose point is
// that the attention output never goes to device memory: on the TPU the
// (bb, NP, E) output stays in VMEM for the projection GEMM.  Here one
// block takes one image and one 64-query tile (four warps of 16 rows):
//
// 1. for each of the H heads, that head's K and V (all keys, zero past N)
//    and the block's scaled q rows go to shared memory, each warp runs
//    the per-warp softmax of qkv_attention.cu (attention_warp.cuh) and
//    writes bf16(o) into a 64 x E shared-memory tile, at the head's
//    columns.  The attention output exists only in that tile;
// 2. z = bf16(o @ U) (64 x r) from the tile, as the TPU kernel rounds it;
// 3. the projection: for each 128-column slice of y, o @ W over E in
//    64-deep steps (a three-stage cp.async ring of W tiles in the space
//    K and V used), one more step z @ V on the same accumulators, then b
//    and s * cb added in the epilogue from the mma.sync registers, as
//    cp_site.cu's epilogue does.
//
// Shared memory at ViT-B (E 768, Dh 64, N 197): the o tile 97 KB, K and
// V (then the W ring) 59 KB, q (then z) 9 KB, the softmax scratch 6 KB:
// 171 KB, one block per SM.  What bounds it: the function moves ~79 MB
// and does ~23 GFLOP (bound ~0.024 ms, by bytes); this first version is
// bound by latency instead: one block of four warps per SM walks the
// heads one after another with no overlap between a head's K / V loads
// and its softmax, and the attention of a 64-row tile re-reads the
// image's K and V (from L2) once per query tile.  Double-buffered head
// loads, more warps per block and wgmma for the projection are later
// work.  The kernel masks its own ragged edge: q rows past N are zero,
// their outputs never written; keys >= n_real are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_warp.cuh"
#include "mma_common.cuh"

namespace {

using attn_warp::kPad;

constexpr int kMaxSmem = 232448;  // H100: 227 KB per block (opt-in)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int QT = 16 * kWarps;   // query rows per block
constexpr int BN = 128;           // output columns per projection pass
constexpr int BK = 64;            // k depth of a ring stage
constexpr int B_LD = BN + 8;      // padded smem strides (multiples of 8)
constexpr int STAGES = 3;
constexpr size_t B_STAGE = (size_t)BK * B_LD;  // bf16 elements
constexpr int ZW = 64;            // the rank k-step: r <= 64
constexpr int Z_LD = ZW + 8;
constexpr int WM = 32;            // warp tile 32 x 64: 2 x 2 warps
constexpr int WN = 64;
constexpr int MI = WM / 16;
constexpr int NJ = WN / 8;

__host__ __device__ inline size_t align128(size_t v) {
  return (v + 127) & ~size_t(127);
}

__host__ __device__ inline size_t larger(size_t a, size_t b) {
  return a > b ? a : b;
}

struct Layout {
  size_t o, k, v, q, s, p, total;
  int ldo;
};

// o tile (QT x (E + kPad)); K and V of one head (npp x (dh + kPad)
// each), which the W ring reuses; the scaled q rows, which the z tile
// reuses; per warp a 16x16 fp32 score tile and a 16x16 bf16 P tile.
__host__ __device__ inline Layout make_layout(int npp, int dh, int e) {
  Layout L;
  L.ldo = e + kPad;
  const size_t ld = dh + kPad;
  const size_t kv = align128((size_t)npp * ld * 2);
  L.o = 0;
  L.k = L.o + align128((size_t)QT * L.ldo * 2);
  L.v = L.k + kv;
  L.q = L.k + align128(larger(2 * kv, STAGES * B_STAGE * 2));
  L.s = L.q + align128(larger((size_t)QT * ld * 2, (size_t)QT * Z_LD * 2));
  L.p = L.s + align128((size_t)kWarps * 256 * 4);
  L.total = L.p + align128((size_t)kWarps * 256 * 2);
  return L;
}

struct ProjArgs {
  const __nv_bfloat16* qkv;
  const __nv_bfloat16* w;
  const __nv_bfloat16* b;
  const __nv_bfloat16* u;  // (E, ldu), zero past r
  const __nv_bfloat16* v;  // (r, E)
  const __nv_bfloat16* cb;
  __nv_bfloat16* out;
  int N, heads, n_real, r, ldu;
  float scale, s;
};

// One 64-deep step of the warp's 32x64 tile: A (row-major, lda) from
// shared memory by ldmatrix, B from the row-major (k, n) ring tile by
// ldmatrix.trans, then MI x NJ mma.sync.m16n8k16.  `kmax` skips k16
// halves that are all zero (the rank step).
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int wr,
                                         int wc, int lane, int kmax) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    if (kk >= kmax) break;
    unsigned af[MI][4], bfr[NJ][2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      ldmatrix_x4(af[i], a + (wr * WM + i * 16 + (lane & 15)) * lda + kk +
                             (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      unsigned t[4];
      ldmatrix_x4_trans(t, b + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   B_LD +
                               wc * WN + jj * 16 + (lane >> 4) * 8);
      bfr[2 * jj][0] = t[0];
      bfr[2 * jj][1] = t[1];
      bfr[2 * jj + 1][0] = t[2];
      bfr[2 * jj + 1][1] = t[3];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_16816(acc[i][j], af[i], bfr[j]);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_proj_kernel(const ProjArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int npp = (p.N + 15) & ~15;
  const int e = p.heads * DH;
  const Layout L = make_layout(npp, DH, e);
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(smem + L.o);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* Bs = Ks;  // the W ring, once the heads are done
  __nv_bfloat16* Zs = Qs;  // z, once the heads are done

  const int img = blockIdx.y;
  const int q0 = blockIdx.x * QT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_stride = 3 * (size_t)e;
  const __nv_bfloat16* qkv = p.qkv + (size_t)img * p.N * row_stride;
  constexpr int VPR = DH / 8;  // 16-byte vectors per head row
  constexpr int LD = DH + kPad;
  float* S = reinterpret_cast<float*>(smem + L.s) + warp * 256;
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(smem + L.p) +
                     warp * 256;
  const int qw = q0 + warp * 16;

  // A warp wholly past N computes no attention: its o rows are zero.
  if (qw >= p.N)
    for (int row = 0; row < 16; ++row)
      for (int c = lane * 8; c < e; c += 256)
        *reinterpret_cast<uint4*>(Os + (warp * 16 + row) * L.ldo + c) =
            make_uint4(0, 0, 0, 0);

  // 1. The heads, one after another, into the o tile.
  for (int h = 0; h < p.heads; ++h) {
    const __nv_bfloat16* base = qkv + h * DH;
    for (int idx = tid; idx < npp * VPR; idx += kThreads) {
      const int key = idx / VPR;
      const int c = (idx % VPR) * 8;
      const bool ok = key < p.N;
      const __nv_bfloat16* r = base + (ok ? key : 0) * row_stride + c;
      cp_async16(Ks + key * LD + c, r + e, ok);
      cp_async16(Vs + key * LD + c, r + 2 * e, ok);
    }
    cp_async_commit();
    for (int idx = tid; idx < QT * VPR; idx += kThreads) {
      const int row = idx / VPR;
      const int c = (idx % VPR) * 8;
      const int q = q0 + row;
      uint4 qv = make_uint4(0, 0, 0, 0);
      if (q < p.N) {
        qv = *reinterpret_cast<const uint4*>(base + q * row_stride + c);
        __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(&qv);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          el[t] = __float2bfloat16(__bfloat162float(el[t]) * p.scale);
      }
      *reinterpret_cast<uint4*>(Qs + row * LD + c) = qv;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (qw < p.N) {  // warp-uniform
      attn_warp::AccFrag o[DH / 16];
      const float inv_l = attn_warp::warp_attention<DH>(
          o, Qs + warp * 16 * LD, Ks, Vs, npp, p.n_real, S, P, lane);
      attn_warp::store_rows<DH>(
          o, inv_l, S, Os + (warp * 16 + (lane >> 1)) * L.ldo + h * DH,
          true, lane);
    }
    __syncthreads();  // the next head overwrites K, V and q
  }

  // The projection passes: C (64 x 128) = o @ src[:, n0:n0+128] over E
  // in 64-deep ring steps, then (with `delta`) z @ V[:, n0:] as one more
  // step; src is (E, ld) with columns >= ncols zero-filled.
  const int wr = warp >> 1;
  const int wc = warp & 1;
  const int KT = e / BK;
  auto load_stage = [&](int st, const __nv_bfloat16* src, int ld,
                        int k0, int krows, int n0, int ncols) {
#pragma unroll
    for (int it = 0; it < BK * BN / 8 / kThreads; ++it) {
      const int vec = tid + it * kThreads;
      const int row = vec / (BN / 8);
      const int col = (vec % (BN / 8)) * 8;
      const int gn = n0 + col;
      const bool ok = row < krows && gn < ncols;
      cp_async16(Bs + st * B_STAGE + row * B_LD + col,
                 ok ? src + (size_t)(k0 + row) * ld + gn : src, ok);
    }
  };
  auto gemm = [&](float (&acc)[MI][NJ][4], const __nv_bfloat16* src,
                  int ld, int n0, int ncols, bool delta) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    const int total = KT + (delta ? 1 : 0);
    auto issue = [&](int t) {
      if (t < KT)
        load_stage(t % STAGES, src, ld, t * BK, BK, n0, ncols);
      else
        load_stage(t % STAGES, p.v, e, 0, p.r, n0, e);
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < total) issue(st);
      cp_async_commit();
    }
    for (int t = 0; t < total; ++t) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      // Refill the slot consumed in the previous step: every thread is
      // past that step's products (barrier above).
      if (t + STAGES - 1 < total) issue(t + STAGES - 1);
      cp_async_commit();
      const __nv_bfloat16* bt = Bs + (t % STAGES) * B_STAGE;
      if (t < KT) {
        warp_mma(acc, Os + t * BK, L.ldo, bt, wr, wc, lane, BK);
      } else {
        // acc += s * (z @ V): scale out before the delta step, back after.
        const float inv = p.s != 1.f ? 1.f / p.s : 1.f;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] *= inv;
        warp_mma(acc, Zs, Z_LD, bt, wr, wc, lane, p.r);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] *= p.s;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next pass
  };

  // Thread (g, t) of an mma tile holds rows g and g + 8, columns 2t and
  // 2t + 1 of every 16x8 accumulator tile.
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  float acc[MI][NJ][4];

  // 2. z = bf16(o @ U) into the (now free) q space, zero past r.
  if (p.r > 0) {
    gemm(acc, p.u, p.ldu, 0, p.ldu, false);
    if (wc == 0) {  // columns 0 .. 63
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int row = wr * WM + i * 16 + g + half * 8;
            *reinterpret_cast<__nv_bfloat162*>(Zs + row * Z_LD + j * 8 +
                                               t2) =
                __floats2bfloat162_rn(acc[i][j][half * 2],
                                      acc[i][j][half * 2 + 1]);
          }
    }
  }

  // 3. y = o @ W + b + s * (z @ V + cb), 128 columns a pass.
  for (int n0 = 0; n0 < e; n0 += BN) {
    gemm(acc, p.w, e, n0, e, p.r > 0);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = q0 + wr * WM + i * 16 + g + half * 8;
        if (q >= p.N) continue;
        __nv_bfloat16* orow = p.out + ((size_t)img * p.N + q) * e;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int gn = n0 + wc * WN + j * 8 + t2;
          if (gn >= e) continue;
          const float2 bb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.b + gn));
          const float2 cc = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.cb + gn));
          const float y0 = acc[i][j][half * 2] + bb.x + p.s * cc.x;
          const float y1 = acc[i][j][half * 2 + 1] + bb.y + p.s * cc.y;
          *reinterpret_cast<__nv_bfloat162*>(orow + gn) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

size_t smem_bytes(int N, int e, int dh) {
  return make_layout((N + 15) & ~15, dh, e).total;
}

template <int DH>
int launch(const ProjArgs& p, int B, cudaStream_t stream) {
  const int e = p.heads * DH;
  const size_t smem = smem_bytes(p.N, e, DH);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // Opt in once per process to the largest block this kernel can use.
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_proj_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((p.N + QT - 1) / QT, B);
  attn_proj_kernel<DH><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block needs (0 when it does not fit), so that
// the wrapper can refuse a shape before launching.
extern "C" int cara_attn_proj_smem(int N, int e, int dh) {
  const size_t smem = smem_bytes(N, e, dh);
  return smem > kMaxSmem ? 0 : static_cast<int>(smem);
}

// y (B, N, E) = attention(qkv) @ w + b + s * ((attention(qkv) @ u) @ v +
// cb), keys >= n_real masked.  dh must be 16, 32 or 64, E = heads * dh a
// multiple of 64, 0 <= r <= ldu <= 64 with ldu a multiple of 8 (u is
// (E, ldu), zero past r).  Pointers 16-byte aligned; the
// Python wrapper checks.  Returns cudaGetLastError() (or the error of the
// shared-memory attribute call).
extern "C" int cara_attn_proj(const void* qkv, const void* w, const void* b,
                              const void* u, const void* v, const void* cb,
                              void* out, int B, int N, int heads, int dh,
                              int n_real, int r, int ldu, float scale,
                              float s, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if ((heads * dh) % BK || r < 0 || r > ldu || ldu > ZW || ldu % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  ProjArgs p;
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.u = static_cast<const __nv_bfloat16*>(u);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.cb = static_cast<const __nv_bfloat16*>(cb);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.N = N;
  p.heads = heads;
  p.n_real = n_real;
  p.r = r;
  p.ldu = ldu;
  p.scale = scale;
  p.s = s;
  switch (dh) {
    case 16: return launch<16>(p, B, stream);
    case 32: return launch<32>(p, B, stream);
    case 64: return launch<64>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
