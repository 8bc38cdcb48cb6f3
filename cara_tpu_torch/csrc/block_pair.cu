// The rest of one transformer block's eval forward after the qkv site,
// in one kernel, for Hopper (sm_90a):
//
//   o   = attention(qkv)                                  (keys >= n_real
//   xm  = bf16(x + o Wp + bp + s ((o U2) V2 + cb2))        masked)
//   xa2 = LN2(xm)
//   h   = bf16(act(xa2 W1 + b1 + s ((xa2 U1) V1 + cb1)))
//   y   = bf16(xm + h W2 + b2 + s ((h U2') V2' + cb2'))
//
// qkv (B, N, 3E) bf16 out-flat (3, H, Dh) as the qkv site writes it, x
// (B, N, E) the block's input (the first residual), y (B, N, E); the
// rank-r products z = bf16(. @ U) are rounded before @ V, everything else
// accumulates in fp32 (the TPU kernel's rounding points).
//
// Replaces cara_tpu/ops/pallas/block_pair.py (block_pair_fwd,
// _pair_kernel), the whole-block eval megakernel, whose point is that the
// mid residual x_mid never goes to device memory.  The TPU kernel holds
// one image's whole block in VMEM; a Hopper block has 227 KB of shared
// memory and one image's qkv alone is 0.9 MB at ViT-B, so the port is two
// launches: csrc/cp_site.cu with the LN1 prologue writes qkv (as row 5's
// port does), then this kernel, one block per (image, 32-query-row tile),
// runs everything after it without leaving the chip:
//
// 1. attention, two heads at a time: both heads' K and V (all keys, zero
//    past N) and the tile's scaled q rows in shared memory, four warps
//    (two 16-row groups x two heads) each running the per-warp softmax of
//    qkv_attention.cu (attention_warp.cuh) into a 32 x E bf16 o tile;
// 2. z2 = bf16(o U2), then the projection in 128-column passes over a
//    three-stage cp.async ring of weight tiles (in the space K and V
//    used), the rank step z2 V2 on the same accumulators, bp, s cb2 and
//    the residual x in the epilogue: x_mid (32 x E bf16) in shared memory;
// 3. LN2 of x_mid (fp32 statistics, one warp per four rows) into the o
//    tile's space, then z1 = bf16(xa2 U1);
// 4. the hidden dimension in 128-wide chunks: fc1 (+ the rank step, b1,
//    s cb1, the activation) into a 32 x 128 bf16 h chunk in shared
//    memory, then fc2 on that chunk accumulated into registers across the
//    chunks (32 x E fp32: 96 a thread at E 768), with h U2' as one more
//    128-column slice of the same accumulators, so that z2' is rounded
//    only once the whole h row has been summed;
// 5. z2' V2', b2, s cb2' and the residual x_mid in the epilogue.
//
// Neither x_mid nor h ever goes to device memory.  Why 32-row tiles:
// the fc2 accumulator of a 64-row tile (64 x 768 fp32) does not fit the
// registers of eight warps, and 32 rows leave room for x_mid, the o /
// xa2 tile, two heads' K and V and the ring: 187 KB at ViT-B (N 197), one
// block of eight warps per SM.  Eight warps are needed for the
// accumulator; only four of them find work in the attention.
//
// What bounds it on the H100: the whole block does ~186 GFLOP at ViT-B
// batch 64 (0.19 ms at the bf16 peak), the operations.  This first
// version re-reads every weight from L2 for each of its 448 tiles (~12 MB
// a tile), runs 16-row warp tiles with a barrier every 64-deep step and
// leaves half the warps idle in the attention, so it is bound by L2
// traffic and latency instead.  Larger tiles across a cluster (weights
// multicast by TMA), wgmma and a warp-specialised ring are later work.
// The kernel masks its own ragged edge: q rows past N are zero, their
// outputs never written; keys >= n_real are masked.
//
// act is the exact-erf GELU or CLIP's quick_gelu, y sigma(1.702 y) (the
// TPU kernel's act argument), a template parameter of the kernel
// (gelu.cuh): the fc1 epilogue is the only place it differs, one expf an
// hidden value in place of erff, far below the block's operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_warp.cuh"
#include "gelu.cuh"
#include "mma_common.cuh"

namespace {

using attn_warp::kPad;

constexpr int kMaxSmem = 232448;  // H100: 227 KB per block (opt-in)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int QT = 32;            // query rows per block
constexpr int BN = 128;           // output columns per pass / slice
constexpr int BK = 64;            // k depth of a ring stage
constexpr int B_LD = BN + 8;      // padded smem strides (multiples of 8)
constexpr int STAGES = 3;
constexpr size_t B_STAGE = (size_t)BK * B_LD;  // bf16 elements
constexpr int ZW = 64;            // the rank k-step: r <= 64
constexpr int Z_LD = ZW + 8;
constexpr int HC = 128;           // hidden chunk
constexpr int H_LD = HC + 8;
constexpr int KS = HC / BK;       // ring steps of one chunk's fc2 slice
constexpr int MAXSL = 6;          // E <= 768: at most six 128-col slices
constexpr int WN = 32;            // warp tile 16 x 32: 2 x 4 warps
constexpr int NJ = WN / 8;

__host__ __device__ inline size_t align128(size_t v) {
  return (v + 127) & ~size_t(127);
}

__host__ __device__ inline size_t larger(size_t a, size_t b) {
  return a > b ? a : b;
}

struct Layout {
  size_t o, r, kv, xm, h, q, s, p, total;
  int ldo;
};

// The o tile (QT x (E + kPad)), which xa2 reuses; region r: two heads'
// K and V (npp x (dh + kPad) each) during the attention, then the weight
// ring, x_mid (QT x (E + kPad)) and the h chunk (QT x H_LD); the two
// heads' q rows, which the z tile reuses; per warp a 16x16 fp32 score
// tile and a 16x16 bf16 P tile.
__host__ __device__ inline Layout make_layout(int npp, int dh, int e) {
  Layout L;
  L.ldo = e + kPad;
  const size_t ld = dh + kPad;
  const size_t tile = align128((size_t)QT * L.ldo * 2);
  L.kv = align128((size_t)npp * ld * 2);
  L.o = 0;
  L.r = tile;
  L.xm = L.r + STAGES * B_STAGE * 2;
  L.h = L.xm + tile;
  const size_t rsize = larger(4 * L.kv, L.h - L.r +
                                            align128((size_t)QT * H_LD * 2));
  L.q = L.r + align128(rsize);
  L.s = L.q + align128(larger(2 * (size_t)QT * ld * 2,
                              (size_t)QT * Z_LD * 2));
  L.p = L.s + align128((size_t)kWarps * 256 * 4);
  L.total = L.p + align128((size_t)kWarps * 256 * 2);
  return L;
}

struct PairArgs {
  const __nv_bfloat16* qkv;
  const __nv_bfloat16* x;
  const __nv_bfloat16* wp;   // (E, E)
  const __nv_bfloat16* bp;
  const __nv_bfloat16* u2;   // (E, ldu), zero past r
  const __nv_bfloat16* v2;   // (r, E)
  const __nv_bfloat16* cb2;
  const __nv_bfloat16* ls2;
  const __nv_bfloat16* lb2;
  const __nv_bfloat16* w1;   // (E, hidden)
  const __nv_bfloat16* b1;
  const __nv_bfloat16* mu1;  // (E, ldu)
  const __nv_bfloat16* mv1;  // (r, hidden)
  const __nv_bfloat16* mcb1;
  const __nv_bfloat16* w2;   // (hidden, E)
  const __nv_bfloat16* b2;
  const __nv_bfloat16* mu2;  // (hidden, ldu)
  const __nv_bfloat16* mv2;  // (r, E)
  const __nv_bfloat16* mcb2;
  __nv_bfloat16* out;
  int N, heads, hidden, n_real, r, ldu;
  float scale, s, ln_eps;
};

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
}

__device__ __forceinline__ void scale_acc(float (&acc)[NJ][4], float f) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] *= f;
}

// One 64-deep step of the warp's 16x32 tile: A (row-major, lda) from
// shared memory by ldmatrix, B from the row-major (k, n) ring tile by
// ldmatrix.trans, then NJ mma.sync.m16n8k16.  `kmax` skips k16 halves
// that are all zero (the rank step).
__device__ __forceinline__ void warp_mma(float (&acc)[NJ][4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int wr,
                                         int wc, int lane, int kmax) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    if (kk >= kmax) break;
    unsigned af[4], bfr[NJ][2];
    ldmatrix_x4(af, a + (wr * 16 + (lane & 15)) * lda + kk +
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
    for (int j = 0; j < NJ; ++j) mma_16816(acc[j], af, bfr[j]);
  }
}

template <int DH, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
block_pair_kernel(const PairArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int npp = (p.N + 15) & ~15;
  const int e = p.heads * DH;
  const Layout L = make_layout(npp, DH, e);
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(smem + L.o);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + L.r);
  __nv_bfloat16* XMs = reinterpret_cast<__nv_bfloat16*>(smem + L.xm);
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem + L.h);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* Zs = Qs;  // z, once the heads are done

  const int img = blockIdx.y;
  const int q0 = blockIdx.x * QT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ldo = L.ldo;
  const size_t row_stride = 3 * (size_t)e;
  const __nv_bfloat16* qkv = p.qkv + (size_t)img * p.N * row_stride;
  constexpr int VPR = DH / 8;  // 16-byte vectors per head row
  constexpr int LD = DH + kPad;

  // ---- 1. attention, two heads at a time, into the o tile ----
  // A 16-row group wholly past N computes nothing: its o rows are zero.
  for (int idx = tid; idx < QT * (e / 8); idx += kThreads) {
    const int row = idx / (e / 8);
    if (q0 + (row & ~15) >= p.N)
      *reinterpret_cast<uint4*>(Os + row * ldo + (idx % (e / 8)) * 8) =
          make_uint4(0, 0, 0, 0);
  }
  {
    float* S = reinterpret_cast<float*>(smem + L.s) + warp * 256;
    __nv_bfloat16* P =
        reinterpret_cast<__nv_bfloat16*>(smem + L.p) + warp * 256;
    const int rg = warp & 1;   // the warp's 16-row group ...
    const int hh = warp >> 1;  // ... and head of the pair (warps 0-3)
    const int qw = q0 + rg * 16;
    for (int h0 = 0; h0 < p.heads; h0 += 2) {
      const int nh = p.heads - h0 < 2 ? p.heads - h0 : 2;
      for (int idx = tid; idx < nh * npp * VPR; idx += kThreads) {
        const int j = idx / (npp * VPR);
        const int rem = idx % (npp * VPR);
        const int key = rem / VPR;
        const int c = (rem % VPR) * 8;
        const bool ok = key < p.N;
        const __nv_bfloat16* src =
            qkv + (ok ? key : 0) * row_stride + (h0 + j) * DH + c;
        __nv_bfloat16* kd = reinterpret_cast<__nv_bfloat16*>(
            smem + L.r + 2 * j * L.kv);
        __nv_bfloat16* vd = reinterpret_cast<__nv_bfloat16*>(
            smem + L.r + (2 * j + 1) * L.kv);
        cp_async16(kd + key * LD + c, src + e, ok);
        cp_async16(vd + key * LD + c, src + 2 * e, ok);
      }
      cp_async_commit();
      for (int idx = tid; idx < nh * QT * VPR; idx += kThreads) {
        const int j = idx / (QT * VPR);
        const int rem = idx % (QT * VPR);
        const int row = rem / VPR;
        const int c = (rem % VPR) * 8;
        const int q = q0 + row;
        uint4 qv = make_uint4(0, 0, 0, 0);
        if (q < p.N) {
          qv = *reinterpret_cast<const uint4*>(qkv + q * row_stride +
                                               (h0 + j) * DH + c);
          __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(&qv);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            el[t] = __float2bfloat16(bf(el[t]) * p.scale);
        }
        *reinterpret_cast<uint4*>(Qs + (j * QT + row) * LD + c) = qv;
      }
      cp_async_wait<0>();
      __syncthreads();
      if (warp < 4 && hh < nh && qw < p.N) {  // warp-uniform
        const __nv_bfloat16* kd =
            reinterpret_cast<const __nv_bfloat16*>(smem + L.r +
                                                   2 * hh * L.kv);
        const __nv_bfloat16* vd = reinterpret_cast<const __nv_bfloat16*>(
            smem + L.r + (2 * hh + 1) * L.kv);
        attn_warp::AccFrag o[DH / 16];
        const float inv_l = attn_warp::warp_attention<DH>(
            o, Qs + (hh * QT + rg * 16) * LD, kd, vd, npp, p.n_real, S, P,
            lane);
        attn_warp::store_rows<DH>(
            o, inv_l, S,
            Os + (rg * 16 + (lane >> 1)) * ldo + (h0 + hh) * DH, true,
            lane);
      }
      __syncthreads();  // the next pair overwrites K, V and q
    }
  }

  // ---- the ring GEMMs: C (32 x 128) over 64-deep weight tiles ----
  const int wr = warp >> 2;  // 0..1: rows wr*16 ..
  const int wc = warp & 3;   // 0..3: cols wc*32 ..
  const int g = lane >> 2;   // mma fragment: rows g, g + 8 ...
  const int t2 = (lane & 3) * 2;  // ... columns t2, t2 + 1 of each n8
  const float inv_s = p.s != 1.f ? 1.f / p.s : 1.f;

  // Ring tile st = src rows k0 .. k0+63 (rows >= krows zero), columns
  // n0 .. n0+127 (columns >= ncols zero); src is row-major with ld.
  auto load_tile = [&](int st, const __nv_bfloat16* src, int ld, int k0,
                       int krows, int n0, int ncols) {
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
  // acc = A (QT x 64*ktn in smem, lda) @ src[:, n0:n0+128], then, with
  // dv, one more step Zs @ dv[0:r, n0:] scaled by s.
  auto gemm = [&](float (&acc)[NJ][4], const __nv_bfloat16* A, int lda,
                  const __nv_bfloat16* src, int ld, int n0, int ncols,
                  int ktn, const __nv_bfloat16* dv, int dvld) {
    zero(acc);
    const int total = ktn + (dv ? 1 : 0);
    auto issue = [&](int t) {
      if (t < ktn)
        load_tile(t % STAGES, src, ld, t * BK, BK, n0, ncols);
      else
        load_tile(t % STAGES, dv, dvld, 0, p.r, n0, dvld);
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
      if (t < ktn) {
        warp_mma(acc, A + t * BK, lda, bt, wr, wc, lane, BK);
      } else {  // acc += s * (z @ V): scale out, the step, back
        scale_acc(acc, inv_s);
        warp_mma(acc, Zs, Z_LD, bt, wr, wc, lane, p.r);
        scale_acc(acc, p.s);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next GEMM
  };
  // z = bf16(A @ U) into Zs (columns 0 .. 63, zero past r).
  auto rank_z = [&](const __nv_bfloat16* A, const __nv_bfloat16* u) {
    float acc[NJ][4];
    gemm(acc, A, ldo, u, p.ldu, 0, p.ldu, e / BK, nullptr, 0);
    if (wc < ZW / WN) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int row = wr * 16 + g + half * 8;
          *reinterpret_cast<__nv_bfloat162*>(Zs + row * Z_LD + wc * WN +
                                             j * 8 + t2) =
              __floats2bfloat162_rn(acc[j][half * 2], acc[j][half * 2 + 1]);
        }
    }
    __syncthreads();
  };

  // ---- 2. the projection and the first residual: x_mid ----
  rank_z(Os, p.u2);
  const __nv_bfloat16* xin = p.x + (size_t)img * p.N * e;
  for (int n0 = 0; n0 < e; n0 += BN) {
    float acc[NJ][4];
    gemm(acc, Os, ldo, p.wp, e, n0, e, e / BK, p.v2, e);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wr * 16 + g + half * 8;
      const int q = q0 + row;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + wc * WN + j * 8 + t2;
        float2 xm = make_float2(0.f, 0.f);
        if (q < p.N) {
          const float2 bb = bf2(p.bp + col);
          const float2 cc = bf2(p.cb2 + col);
          const float2 xr = bf2(xin + (size_t)q * e + col);
          xm.x = xr.x + (acc[j][half * 2] + bb.x + p.s * cc.x);
          xm.y = xr.y + (acc[j][half * 2 + 1] + bb.y + p.s * cc.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(XMs + row * ldo + col) =
            __floats2bfloat162_rn(xm.x, xm.y);
      }
    }
  }
  __syncthreads();  // x_mid is whole; the o tile is free

  // ---- 3. LN2(x_mid) into the o tile's space, then z1 ----
  for (int rr = 0; rr < QT / kWarps; ++rr) {
    const int row = warp * (QT / kWarps) + rr;
    const __nv_bfloat16* xr = XMs + row * ldo;
    float sum = 0.f;
    for (int c = lane; c < e; c += 32) sum += bf(xr[c]);
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum / e;
    float sq = 0.f;
    for (int c = lane; c < e; c += 32) {
      const float d = bf(xr[c]) - mu;
      sq += d * d;
    }
    for (int o = 16; o > 0; o >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rs = rsqrtf(sq / e + p.ln_eps);
    for (int c = lane; c < e; c += 32)
      Os[row * ldo + c] = __float2bfloat16((bf(xr[c]) - mu) * rs *
                                               bf(p.ls2[c]) +
                                           bf(p.lb2[c]));
  }
  __syncthreads();
  rank_z(Os, p.mu1);

  // ---- 4. the MLP over 128-wide hidden chunks ----
  // acc2[0]: h @ U2' (columns 0 .. 63 used); acc2[1 + j]: h @ W2[:, j*128:].
  const int esl = e / BN;
  float acc2[MAXSL + 1][NJ][4];
#pragma unroll
  for (int j = 0; j <= MAXSL; ++j) zero(acc2[j]);
  for (int c0 = 0; c0 < p.hidden; c0 += HC) {
    {  // fc1 + its rank step, b1, s cb1, GELU -> the h chunk
      float acc[NJ][4];
      gemm(acc, Os, ldo, p.w1, p.hidden, c0, p.hidden, e / BK, p.mv1,
           p.hidden);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wr * 16 + g + half * 8;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = wc * WN + j * 8 + t2;
          const float2 bb = bf2(p.b1 + c0 + col);
          const float2 cc = bf2(p.mcb1 + c0 + col);
          *reinterpret_cast<__nv_bfloat162*>(Hs + row * H_LD + col) =
              __floats2bfloat162_rn(
                  act_fwd<ACT>(acc[j][half * 2] + bb.x + p.s * cc.x),
                  act_fwd<ACT>(acc[j][half * 2 + 1] + bb.y + p.s * cc.y));
        }
      }
      __syncthreads();  // the h chunk is whole
    }
    // fc2 on the chunk: slices 0 (U2') .. esl (W2), KS steps each, one
    // ring stream; the slice loop is unrolled so that acc2 stays in
    // registers.
    const int total = (esl + 1) * KS;
    auto issue = [&](int t) {
      const int sl = t / KS;
      const int k0 = c0 + (t % KS) * BK;
      if (sl == 0)
        load_tile(t % STAGES, p.mu2, p.ldu, k0, BK, 0, p.ldu);
      else
        load_tile(t % STAGES, p.w2, e, k0, BK, (sl - 1) * BN, e);
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      issue(st);  // total >= 2 * KS > STAGES - 1
      cp_async_commit();
    }
#pragma unroll
    for (int sl = 0; sl <= MAXSL; ++sl) {
      if (sl <= esl) {  // block-uniform
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int t = sl * KS + kk;
          cp_async_wait<STAGES - 2>();
          __syncthreads();
          if (t + STAGES - 1 < total) issue(t + STAGES - 1);
          cp_async_commit();
          warp_mma(acc2[sl], Hs + kk * BK, H_LD,
                   Bs + (t % STAGES) * B_STAGE, wr, wc, lane, BK);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the h chunk are free
  }

  // ---- 5. z2' V2', b2, s cb2' and the second residual ----
  if (wc < ZW / WN) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int row = wr * 16 + g + half * 8;
        *reinterpret_cast<__nv_bfloat162*>(Zs + row * Z_LD + wc * WN +
                                           j * 8 + t2) =
            __floats2bfloat162_rn(acc2[0][j][half * 2],
                                  acc2[0][j][half * 2 + 1]);
      }
  }
  // The rank step, one V2' tile per slice (rows < r) on one ring stream.
  load_tile(0, p.mv2, e, 0, p.r, 0, e);
  cp_async_commit();
  if (esl > 1) load_tile(1, p.mv2, e, 0, p.r, BN, e);
  cp_async_commit();
#pragma unroll
  for (int sl = 1; sl <= MAXSL; ++sl) {
    if (sl <= esl) {
      const int t = sl - 1;
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // also: z2' is whole
      if (t + STAGES - 1 < esl)
        load_tile((t + STAGES - 1) % STAGES, p.mv2, e, 0, p.r,
                  (t + STAGES - 1) * BN, e);
      cp_async_commit();
      scale_acc(acc2[sl], inv_s);
      warp_mma(acc2[sl], Zs, Z_LD, Bs + (t % STAGES) * B_STAGE, wr, wc,
               lane, p.r);
      scale_acc(acc2[sl], p.s);
    }
  }
  cp_async_wait<0>();
  __nv_bfloat16* yout = p.out + (size_t)img * p.N * e;
#pragma unroll
  for (int sl = 1; sl <= MAXSL; ++sl) {
    if (sl > esl) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wr * 16 + g + half * 8;
      const int q = q0 + row;
      if (q >= p.N) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = (sl - 1) * BN + wc * WN + j * 8 + t2;
        const float2 bb = bf2(p.b2 + col);
        const float2 cc = bf2(p.mcb2 + col);
        const float2 xm = bf2(XMs + row * ldo + col);
        *reinterpret_cast<__nv_bfloat162*>(yout + (size_t)q * e + col) =
            __floats2bfloat162_rn(
                xm.x + (acc2[sl][j][half * 2] + bb.x + p.s * cc.x),
                xm.y + (acc2[sl][j][half * 2 + 1] + bb.y + p.s * cc.y));
      }
    }
  }
}

size_t smem_bytes(int N, int e, int dh) {
  return make_layout((N + 15) & ~15, dh, e).total;
}

template <int DH, int ACT>
int launch(const PairArgs& p, int B, cudaStream_t stream) {
  const int e = p.heads * DH;
  const size_t smem = smem_bytes(p.N, e, DH);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // Opt in once per process to the largest block this kernel can use.
  static const cudaError_t attr = cudaFuncSetAttribute(
      block_pair_kernel<DH, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((p.N + QT - 1) / QT, B);
  block_pair_kernel<DH, ACT><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block needs (0 when it does not fit), so that
// the wrapper can refuse a shape before launching.
extern "C" int cara_block_pair_smem(int N, int e, int dh) {
  const size_t smem = smem_bytes(N, e, dh);
  return smem > kMaxSmem ? 0 : static_cast<int>(smem);
}

// y (B, N, E) from qkv (B, N, 3E) and x (B, N, E): see the head comment.
// dh must be 16, 32 or 64, E = heads * dh a multiple of 128 and at most
// 768, hidden a multiple of 128, 1 <= r <= ldu <= 64 with ldu a multiple
// of 8 (u2, mu1 (E, ldu) and mu2 (hidden, ldu) zero past r); act 0 the
// exact-erf GELU, 1 quick_gelu.  Pointers 16-byte aligned; the Python
// wrapper checks.  Returns cudaGetLastError() (or the error of the
// shared-memory attribute call).
extern "C" int cara_block_pair(
    const void* qkv, const void* x, const void* wp, const void* bp,
    const void* u2, const void* v2, const void* cb2, const void* ls2,
    const void* lb2, const void* w1, const void* b1, const void* mu1,
    const void* mv1, const void* mcb1, const void* w2, const void* b2,
    const void* mu2, const void* mv2, const void* mcb2, void* out, int B,
    int N, int heads, int dh, int hidden, int n_real, int r, int ldu,
    int act, float scale, float s, float ln_eps, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int e = heads * dh;
  if (e % BN || e > MAXSL * BN || hidden % HC || r < 1 || r > ldu ||
      ldu > ZW || ldu % 8 || act < 0 || act > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto bfp = [](const void* v) {
    return static_cast<const __nv_bfloat16*>(v);
  };
  PairArgs p;
  p.qkv = bfp(qkv);
  p.x = bfp(x);
  p.wp = bfp(wp);
  p.bp = bfp(bp);
  p.u2 = bfp(u2);
  p.v2 = bfp(v2);
  p.cb2 = bfp(cb2);
  p.ls2 = bfp(ls2);
  p.lb2 = bfp(lb2);
  p.w1 = bfp(w1);
  p.b1 = bfp(b1);
  p.mu1 = bfp(mu1);
  p.mv1 = bfp(mv1);
  p.mcb1 = bfp(mcb1);
  p.w2 = bfp(w2);
  p.b2 = bfp(b2);
  p.mu2 = bfp(mu2);
  p.mv2 = bfp(mv2);
  p.mcb2 = bfp(mcb2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.N = N;
  p.heads = heads;
  p.hidden = hidden;
  p.n_real = n_real;
  p.r = r;
  p.ldu = ldu;
  p.scale = scale;
  p.s = s;
  p.ln_eps = ln_eps;
  switch (dh) {
    case 16:
      return act ? launch<16, ACT_QUICK_GELU>(p, B, stream)
                 : launch<16, ACT_GELU>(p, B, stream);
    case 32:
      return act ? launch<32, ACT_QUICK_GELU>(p, B, stream)
                 : launch<32, ACT_GELU>(p, B, stream);
    case 64:
      return act ? launch<64, ACT_QUICK_GELU>(p, B, stream)
                 : launch<64, ACT_GELU>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
