// Key-tiled (online-softmax) attention for Hopper (sm_90a), backward: the
// kernels that blockwise_attention_bwd.cu (TPU row 16) and
// flash_attention_bwd.cu (TPU row 17) both launch, and whose main kernel
// and dq pass qkv_attention_bwd.cu (TPU row 2) launches after its own
// statistics pass (launch_bwd_tiles: row 2 has no forward output or lse,
// so its (lse, D) rows come from tiled_attention_fwd.cuh's statistics
// mode instead of the rows pass below).
//
// From q, k, v, the forward's output o and log-sum-exp lse (B, N, H)
// (tiled_attention_fwd.cuh) and the output cotangent do, writes dq, dk
// and dv in bf16.  Every (B, H, N, Dh) operand is a base pointer and its
// (batch, head, row) strides (tiled_attention_fwd.cuh's Rows), so the
// gradients land in whatever layout the caller holds (the qkv layout of
// row 16, or three (B, N, H, Dh) buffers).
//
// What bounds it on the H100: at B = 64, N = 577, H = 12, Dh = 64 the
// function needs five N^2 Dh products per (image, head) (s, dp, dq, dk,
// dv), 10 B H N^2 Dh = 163.6 GFLOP against ~460 MB: 0.1655 ms on the
// tensor cores, so operations.  The previous design (three launches, seven
// products: s and dp recomputed by a dq kernel over query tiles and a
// dk / dv kernel over key tiles, mma.sync on 16-row warp tiles, every B
// fragment ldmatrix'ed by all four warps, a block barrier per 64-row tile,
// a strided one-thread-per-(row, head) D pass) took 1.89 ms, 8.7 % of the
// bound, 2.3x SDPA's backward.  This design:
//
//   rows     one warp per token row, all heads, coalesced: D = rowsum(do *
//            o) and the row's lse into (B, H, 2, NP) fp32 (NP = N rounded up
//            to 64; rows past N get lse = 1e30, D = 0, so their p is 0);
//   main     one block per (image, head): two consumer warpgroups of 64
//            keys, one producer warp and one dq writer warp, walking the
//            128-key tiles in order.  For each key tile the producer
//            loads K and V by TMA (two slots, so the next tile's land
//            while this one is used), then streams the 64-query tiles
//            (q, do by TMA; their lse and D rows by bulk copy) through a
//            three-stage mbarrier ring.  Per query tile each warpgroup
//            runs five wgmma products: s^T = k q^T and dp^T = v do^T (all
//            operands in shared memory), p^T and ds^T in registers from
//            the fp32 accumulators, dv += bf16(p^T) do and dk += ds^T q
//            (A from registers, q and do read MN-major), and dq = ds k
//            over the warpgroup's 64 keys, its ds^T staged once in shared
//            memory and read MN-major.  Each warpgroup stages its fp32
//            dq partial (the accumulator's own order) in one of two
//            buffers; the writer warp sums the two warpgroups' partials
//            (warpgroup 0's plus warpgroup 1's, elementwise) and adds the
//            sum into an fp32 scratch (B, H, NP, Dh) by
//            cp.reduce.async.bulk (add); dk and dv stay in registers to
//            the end of their key tile;
//   dq       scale, round to bf16 and write into the caller's layout.
//
// The scratch is zeroed by the wrapper (torch.zeros): 126 MB at B = 64,
// N = 577 (NP = 640), H = 12, Dh = 64.  dq is bitwise deterministic: one
// block owns all of an (image, head)'s dq, its writer adds a query
// tile's parts in key-tile order, and an add completes in memory before
// the next add to the same tile is issued (cp.async.bulk.wait_group, not
// only its read of shared memory).  So dq = (((0 + t0) + t1) + ...) *
// scale, t_kt = warpgroup 0's partial + warpgroup 1's of key tile kt,
// each sum in fp32 (dk and dv have one writer a row).  FA3's
// deterministic backward keeps a block per key tile and orders their adds
// by a semaphore; tried here first, the blocks of the later key tiles
// waited out each earlier tile's add round trip: at N = 577, 26-32 %
// slower than the unordered adds (tools/compare_parent.py, one H100 80GB
// HBM3 at 700 W).  With one block an (image, head), B = 64 and H = 12
// give 768 blocks, 5.8 waves of one block an SM.
//
// Measured on one H100 80GB HBM3 at 700 W (tools/compare_parent.py, one
// run in turns with the previous design), B = 64, H = 12: 0.8776 / 0.8856
// ms at N = 577 through row 16, 18.7-18.9 % of the bound, 1.09-1.13x
// SDPA's backward in the same turns; 0.2737 / 0.2980 ms at N = 197
// through row 17.  What holds it there: each warpgroup runs its five
// products and the elementwise work between them in sequence, with one
// barrier and three waits a query tile, and a block (two warpgroups, one
// an SM for the registers) overlaps only two such chains; the row pass,
// the zeroing and the dq pass move another ~420 MB.
//
// At Dh 80 (ViT-H/14) the tiles hold a 64-column and a 16-column part
// (sm90_common.cuh, HeadTile): s^T and dp^T reduce over four k-steps on
// the first part and one on the second; dv, dk and dq are one wgmma a
// part.  Two dq staging buffers would put the block at 260,720 bytes, so
// it keeps one (dq_bufs), and the registers come from setmaxnreg (above
// bwd_threads).  dq's order is the same.
//
// Math: s = (q . k) * scale in fp32 from bf16 q and k, keys >= n_real give
// p = 0; p = exp(s - lse); ds = bf16(p * (dp - D)); dq = (ds k) * scale;
// dk = (ds^T q) * scale; dv = bf16(p)^T do; each rounded to bf16 once.
// Query rows past N arrive as zeros and give p = 0; key rows in [n_real,
// N) get zero dk, dv.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"
#include "tiled_attention_fwd.cuh"

namespace tiled_attention {
namespace {

constexpr int kKeys = 128;       // keys per key tile
constexpr int kStages = 3;       // query-tile ring (of kQRows rows)
// Two consumer warpgroups, a producer warp and a dq writer warp: 320
// threads, at most 168 registers each (ptxas's count for one block an
// SM), which at Dh 80 spill 64 bytes: dk, dv and dq (40 fp32 each) beside
// s^T and dp^T (32 each).  Past Dh 64 the two service warps and two idle
// ones make a third warpgroup, which lowers its registers to kServiceRegs
// while the consumers raise theirs to kConsumerRegs (setmaxnreg, as FA3
// does; 2 x 128 x 232 + 128 x 40 = 64512, the block's 384 x 168): ptxas
// then spills 8 bytes.  It honours the split only where the lowered warps
// can reach no consumer code (the service branch below returns), and
// failed to allocate the consumers at 216.  Measured against the 320-thread
// form (tools/compare_parent.py; PERF.md): 3-6 % faster.
__host__ __device__ constexpr int bwd_threads(int dh) {
  return dh > 64 ? 384 : 320;
}
constexpr int kServiceRegs = 40;
constexpr int kConsumerRegs = 232;

// Buffers of the fp32 dq partials (each holds both warpgroups' 64 x Dh):
// two up to Dh 64, so that a warpgroup stages one while the writer adds the
// other; one at Dh 80, where two would put the block at 260,720 bytes,
// past the 232,448 it may have (two query-tile stages in place of three
// would still need 239,712).
__host__ __device__ constexpr int dq_bufs(int dh) { return dh > 64 ? 1 : 2; }

// Shared memory of the main kernel, in bytes from a 1024-aligned base.
struct BwdSmem {
  int k, v, q, dout, ds, stage, lse, dd, bars, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int dh) {
  const int rb = dh * 2;
  BwdSmem s;
  s.k = 0;                      // two key tiles (K and V double-buffered)
  s.v = s.k + 2 * kKeys * rb;
  s.q = s.v + 2 * kKeys * rb;
  s.dout = s.q + kStages * kQRows * rb;
  s.ds = s.dout + kStages * kQRows * rb;     // 2 x 2 tiles 64 x 64 bf16
  s.stage = s.ds + 2 * kKeys * kQRows * 2;  // [buffers][2] 64 x dh fp32
  s.lse = s.stage + dq_bufs(dh) * 2 * kQRows * dh * 4;
  s.dd = s.lse + kStages * kQRows * 4;
  s.bars = s.dd + kStages * kQRows * 4;
  s.total = s.bars + 8 * (2 * 2 + 2 * kStages + 4) + 1024;  // + alignment
  return s;
}

// The operands of one backward call.
struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  Rows sq, sk, sv, sdo;
  const float* lse;  // (B, N, H)
  float* rows;       // (B, H, 2, NP): lse, then D
  float* dq_acc;     // (B, H, NP, Dh), zeroed
  __nv_bfloat16 *dq, *dk, *dv;
  Rows sdq, sdk, sdv;
  int N, heads, n_real;
  float scale;
};

// TMA maps of q, k, v and do: (Dh, N, H, B), boxes of 64 rows, one a
// part of the head.
template <int DH>
struct BwdMaps {
  static constexpr int P = sm90::HeadTile<DH>::PARTS;
  CUtensorMap q[P], k[P], v[P], dout[P];
};

template <int DH>
__global__ void __launch_bounds__(256)
attention_rows_kernel(const __nv_bfloat16* __restrict__ dout, Rows sdo,
                      const __nv_bfloat16* __restrict__ o, Rows so,
                      const float* __restrict__ lse, float* __restrict__ rows,
                      int B, int N, int heads) {
  constexpr int VPR = DH / 8;  // 16-byte pieces a head row
  // lanes a head row: VPR rounded up to a power of two (Dh 80: 10 of 16
  // lanes read), so that the xor shuffles sum within a head
  constexpr int LPH = VPR <= 1 ? 1 : VPR <= 2 ? 2 : VPR <= 4 ? 4
                    : VPR <= 8 ? 8 : 16;
  const int np = padded_rows(N);
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= (long long)B * np) return;
  const int lane = threadIdx.x & 31;
  const int b = row / np;
  const int n = row % np;
  float* base = rows + (size_t)b * heads * 2 * np + n;
  if (n >= N) {
    for (int h = lane; h < heads; h += 32) {
      base[(size_t)h * 2 * np] = kPadLse;
      base[(size_t)h * 2 * np + np] = 0.f;
    }
    return;
  }
  for (int c0 = 0; c0 < heads * LPH; c0 += 32) {
    const int c = c0 + lane;
    const bool ok = c < heads * LPH;
    const int h = ok ? c / LPH : 0;
    const int col = (c % LPH) * 8;
    float acc = 0.f;
    if (ok && c % LPH < VPR) {
      const uint4 a = *reinterpret_cast<const uint4*>(
          head_rows(dout, sdo, b, h) + n * sdo.sr + col);
      const uint4 bv = *reinterpret_cast<const uint4*>(
          head_rows(o, so, b, h) + n * so.sr + col);
      const __nv_bfloat16* ae = reinterpret_cast<const __nv_bfloat16*>(&a);
      const __nv_bfloat16* be = reinterpret_cast<const __nv_bfloat16*>(&bv);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        acc += __bfloat162float(ae[t]) * __bfloat162float(be[t]);
    }
#pragma unroll
    for (int off = 1; off < LPH; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (ok && c % LPH == 0) base[(size_t)h * 2 * np + np] = acc;
  }
  for (int h = lane; h < heads; h += 32)
    base[(size_t)h * 2 * np] = lse[((size_t)b * N + n) * heads + h];
}

template <int DH>
__global__ void __launch_bounds__(bwd_threads(DH), 1)
attention_bwd_kernel(const __grid_constant__ BwdMaps<DH> maps,
                     const BwdArgs a) {
  using namespace sm90;
  constexpr int RB = DH * 2;
  constexpr int NBUF = dq_bufs(DH);
  constexpr int THREADS = bwd_threads(DH);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const BwdSmem L = bwd_smem(DH);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(smem + L.dout);
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(smem + L.ds);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* Ls = reinterpret_cast<float*>(smem + L.lse);
  float* DDs = reinterpret_cast<float*>(smem + L.dd);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L.bars);  // [2]
  uint64_t* kv_empty = kv_full + 2;     // [2]: the key tile's products done
  uint64_t* full = kv_empty + 2;
  uint64_t* empty = full + kStages;
  uint64_t* dq_full = empty + kStages;  // [NBUF]: both warpgroups staged
  uint64_t* dq_empty = dq_full + 2;     // [NBUF]: the writer's add read it

  const int tid = threadIdx.x;
  const int N = a.N;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int np = padded_rows(N);
  const int nq = np / kQRows;
  const int nkt = (a.n_real + kKeys - 1) / kKeys;  // key tiles with a key

  // Keys past the last tile with a valid key: zero dk, dv.
  for (int idx = tid; idx < (N - min(N, nkt * kKeys)) * (DH / 8);
       idx += THREADS) {
    const int r = nkt * kKeys + idx / (DH / 8);
    const int c = (idx % (DH / 8)) * 8;
    const uint4 z = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(head_rows(a.dk, a.sdk, b, h) + r * a.sdk.sr +
                              c) = z;
    *reinterpret_cast<uint4*>(head_rows(a.dv, a.sdv, b, h) + r * a.sdv.sr +
                              c) = z;
  }

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 256);
    }
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(&dq_full[s], 256);
      mbar_init(&dq_empty[s], 1);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Iteration it = kt * nq + qt walks the key tiles in order and, for
  // each, the query tiles; ring slots, dq buffers and their phases count
  // it.  The service warps (and the idle ones) take only the branch below,
  // so that their lowered register count covers all they run.
  if (tid >= 256) {
    if constexpr (THREADS > 320) setmaxnreg_dec<kServiceRegs>();
    if (tid >= 288) {  // the dq writer warp
      if (tid >= 320) return;  // the idle warps
      // Per iteration: the two warpgroups' partials summed into buffer half
      // 0 (warpgroup 0's plus warpgroup 1's), then one bulk add into the
      // scratch.  Adds to one query tile come nq iterations apart, in
      // key-tile order, each complete before the next is issued (with nq
      // >= 2 it is enough that all but the newest add have completed).
      const int lane = tid & 31;
      float* acc_base = a.dq_acc + ((size_t)b * a.heads + h) * np * DH;
      for (int it = 0; it < nkt * nq; ++it) {
        const int buf = it % NBUF;
        const int qt = it % nq;
        mbar_wait(&dq_full[buf], (it / NBUF) & 1);
        float4* s0 = reinterpret_cast<float4*>(stage + buf * 2 * kQRows * DH);
        const float4* s1 = s0 + kQRows * DH / 4;
        for (int i = lane; i < kQRows * DH / 4; i += 32) {
          float4 x = s0[i];
          const float4 y = s1[i];
          x.x += y.x;
          x.y += y.y;
          x.z += y.z;
          x.w += y.w;
          s0[i] = x;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          if constexpr (NBUF == 2) {
            if (nq == 1) bulk_wait();
            bulk_reduce_add_f32(acc_base + (size_t)qt * kQRows * DH,
                                reinterpret_cast<const float*>(s0),
                                kQRows * DH * 4);
            bulk_wait_1();  // every add but this one complete and read
            if (it > 0) mbar_arrive(&dq_empty[buf ^ 1]);
          } else {
            // The add of it - nq (<= it - 2, or it - 1 when nq = 1) complete,
            // then this one issued; the buffer is free once it is read.
            if (nq == 1) {
              bulk_wait();
            } else {
              bulk_wait_1();
            }
            bulk_reduce_add_f32(acc_base + (size_t)qt * kQRows * DH,
                                reinterpret_cast<const float*>(s0),
                                kQRows * DH * 4);
            bulk_wait_read();
            mbar_arrive(&dq_empty[0]);
          }
        }
        __syncwarp();
      }
      if (lane == 0) bulk_wait();
      return;
    }
    // The producer warp.
    if (tid == 256) {
      const float* rows = a.rows + ((size_t)b * a.heads + h) * 2 * np;
      for (int kt = 0; kt < nkt; ++kt) {
        const int kv = kt & 1;
        if (kt >= 2) mbar_wait(&kv_empty[kv], ((kt >> 1) - 1) & 1);
        mbar_expect_tx(&kv_full[kv], 4 * kQRows * RB);
        for (int s = 0; s < 2; ++s) {
          tma_load_head_4d<DH, kQRows>(Ks + (kv * 2 + s) * kQRows * DH, 0,
                                       maps.k, &kv_full[kv], 0,
                                       kt * kKeys + s * kQRows, h, b);
          tma_load_head_4d<DH, kQRows>(Vs + (kv * 2 + s) * kQRows * DH, 0,
                                       maps.v, &kv_full[kv], 0,
                                       kt * kKeys + s * kQRows, h, b);
        }
        for (int qt = 0; qt < nq; ++qt) {
          const int it = kt * nq + qt;
          const int st = it % kStages;
          if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
          mbar_expect_tx(&full[st], 2 * kQRows * RB + 2 * kQRows * 4);
          tma_load_head_4d<DH, kQRows>(Qs + st * kQRows * DH, 0, maps.q,
                                       &full[st], 0, qt * kQRows, h, b);
          tma_load_head_4d<DH, kQRows>(Os + st * kQRows * DH, 0, maps.dout,
                                       &full[st], 0, qt * kQRows, h, b);
          bulk_load(Ls + st * kQRows, rows + qt * kQRows, kQRows * 4,
                    &full[st]);
          bulk_load(DDs + st * kQRows, rows + np + qt * kQRows, kQRows * 4,
                    &full[st]);
        }
      }
    }
    return;
  }
  if constexpr (THREADS > 320) setmaxnreg_inc<kConsumerRegs>();

  // Consumers: warpgroup w owns keys kt * 128 + 64 w .. + 63 of each key
  // tile.
  const int w = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int kt = 0; kt < nkt; ++kt) {
    const int kv = kt & 1;
    const int k0 = kt * kKeys;
    bool kvalid[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      kvalid[r] = k0 + w * 64 + warp * 16 + g + 8 * r < a.n_real;
    const __nv_bfloat16* Kw = Ks + (kv * 2 + w) * kQRows * DH;
    const __nv_bfloat16* Vw = Vs + (kv * 2 + w) * kQRows * DH;
    float dk[DH / 2], dv[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(&kv_full[kv], (kt >> 1) & 1);

    for (int qt = 0; qt < nq; ++qt) {
      const int it = kt * nq + qt;
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      const __nv_bfloat16* qs = Qs + st * kQRows * DH;
      const __nv_bfloat16* os = Os + st * kQRows * DH;
      const float* ls = Ls + st * kQRows;
      const float* dds = DDs + st * kQRows;

      // s^T = k q^T, dp^T = v do^T: keys x queries; p^T is taken while
      // dp^T is still in the tensor cores.  The query of s[i] is 8 (i / 4)
      // + 2 t + (i & 1); p = exp(s scale - lse) by the full-precision
      // expf, as the plain twin takes it.
      float s[32], dp[32];
      {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          wgmma_ss<64, 0, 0>(s, head_kdesc<DH, kQRows>(Kw, kk),
                             head_kdesc<DH, kQRows>(qs, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          wgmma_ss<64, 0, 0>(dp, head_kdesc<DH, kQRows>(Vw, kk),
                             head_kdesc<DH, kQRows>(os, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lv =
            *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * j + c;
          const float p = expf(s[i] * a.scale - ((c & 1) ? lv.y : lv.x));
          s[i] = kvalid[c >> 1] ? p : 0.f;
        }
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], s, kk);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dv2 =
            *reinterpret_cast<const float2*>(dds + 8 * j + 2 * t);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * j + c;
          dp[i] = s[i] * (dp[i] - ((c & 1) ? dv2.y : dv2.x));
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], dp, kk);
      // ds^T (bf16, the values of da) into this warpgroup's dq operand:
      // row = key (128 B of 64 queries, 128-byte swizzle), two buffers by
      // iteration.
      unsigned char* dsb = reinterpret_cast<unsigned char*>(Ds) +
                           ((it & 1) * 2 + w) * 64 * kQRows * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = warp * 16 + g + 8 * r;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(
              dsb + swizzle<128>(key * 128 + (8 * j + 2 * t) * 2)) =
              da[j >> 1][(j & 1) * 2 + r];
      }
      fence_proxy_async();
      // dv += bf16(p^T) do, dk += ds^T q (do and q read MN-major).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_head<DH, kQRows>(dv, pa[kk], os, kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_head<DH, kQRows>(dk, da[kk], qs, kk, 1);
      wgmma_commit();
      // ds^T stored by the four warps.
      named_barrier(1 + w, 128);
      // dq partial (64 queries x Dh) over this warpgroup's 64 keys = ds
      // (A: ds^T read MN-major) . k (B: the key rows read MN-major).
      float dq[DH / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_head<DH, kQRows, 1>(dq, desc<128>(dsb + kk * 16 * 128), Kw,
                                     kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(dq);
      mbar_arrive(&empty[st]);
      // The fp32 partial, in accumulator order, to the writer warp (its
      // buffer free once the add of iteration it - NBUF has read it).
      const int buf = it % NBUF;
      if (it >= NBUF) mbar_wait(&dq_empty[buf], (it / NBUF - 1) & 1);
      float* stage_w = stage + (buf * 2 + w) * kQRows * DH;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) stage_w[i * 128 + wtid] = dq[i];
      mbar_arrive(&dq_full[buf]);
    }
    // Every product of this key tile is done: its K / V slot goes back.
    mbar_arrive(&kv_empty[kv]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + w * 64 + warp * 16 + g + 8 * r;
      if (key >= N) continue;
      __nv_bfloat16* dkr = head_rows(a.dk, a.sdk, b, h) + key * a.sdk.sr;
      __nv_bfloat16* dvr = head_rows(a.dv, a.sdv, b, h) + key * a.sdv.sr;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int col = 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dkr + col) = sm90::pack_bf16(
            dk[4 * j + 2 * r] * a.scale, dk[4 * j + 2 * r + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvr + col) =
            sm90::pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dq = bf16(scratch * scale) into the caller's layout: one thread per
// (image, head, query tile, consumer thread of a warpgroup), reading the
// accumulator order both warpgroups of the main kernel added into.
template <int DH>
__global__ void __launch_bounds__(256)
attention_dq_kernel(const float* __restrict__ acc, __nv_bfloat16* dq,
                    Rows sdq, int B, int N, int heads, float scale) {
  const int np = padded_rows(N);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nq = np / kQRows;
  if (idx >= (long long)B * heads * nq * 128) return;
  const int wtid = idx & 127;
  const long long tile = idx >> 7;  // (b, h, qt)
  const int qt = tile % nq;
  const int h = (tile / nq) % heads;
  const int b = tile / ((long long)nq * heads);
  const float* src = acc + tile * kQRows * DH + wtid;
  const int warp = wtid >> 5;
  const int g = (wtid & 31) >> 2;
  const int t = wtid & 3;
  __nv_bfloat16* base = head_rows(dq, sdq, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qt * kQRows + warp * 16 + g + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float x0 = src[(4 * j + 2 * r) * 128];
      const float x1 = src[(4 * j + 2 * r + 1) * 128];
      *reinterpret_cast<uint32_t*>(base + row * sdq.sr + 8 * j + 2 * t) =
          sm90::pack_bf16(x0 * scale, x1 * scale);
    }
  }
}

// The main kernel and the dq pass on `stream`, from the (lse, D) rows in
// a.rows; returns the first error (cudaGetLastError() after each launch,
// or of the encoding).
template <int DH>
int launch_bwd_tiles(const BwdArgs& a, int B, cudaStream_t stream) {
  const int smem = bwd_smem(DH).total;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  BwdMaps<DH> maps;
  int err = operand_maps<DH>(maps.q, a.q, a.sq, a.N, a.heads, B);
  if (!err) err = operand_maps<DH>(maps.k, a.k, a.sk, a.N, a.heads, B);
  if (!err) err = operand_maps<DH>(maps.v, a.v, a.sv, a.N, a.heads, B);
  if (!err) err = operand_maps<DH>(maps.dout, a.dout, a.sdo, a.N, a.heads, B);
  if (err) return err;
  const int np = padded_rows(a.N);
  dim3 grid(1, a.heads, B);
  attention_bwd_kernel<DH><<<grid, bwd_threads(DH), smem, stream>>>(maps,
                                                                    a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long threads = (long long)B * a.heads * (np / kQRows) * 128;
  attention_dq_kernel<DH><<<(unsigned)((threads + 255) / 256), 256, 0,
                            stream>>>(a.dq_acc, a.dq, a.sdq, B, a.N, a.heads,
                                      a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The rows pass (D from the output o and the forward's lse), then the
// main kernel and the dq pass: rows 16 and 17.
template <int DH>
int launch_bwd(const BwdArgs& a, const __nv_bfloat16* o, Rows so, int B,
               cudaStream_t stream) {
  const long long rows = (long long)B * padded_rows(a.N);
  attention_rows_kernel<DH><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      a.dout, a.sdo, o, so, a.lse, a.rows, B, a.N, a.heads);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_bwd_tiles<DH>(a, B, stream);
}

}  // namespace
}  // namespace tiled_attention
