// The wgmma + TMA GEMM core for Hopper (sm_90a) that every dense product
// of the port runs on: the block backwards' products (grad_gemm.cu) and
// the forward CaRA sites (cp_site.cu).
//
//   NN   C (M, N) = A (M, K)   . B (K, N)
//   NT   C (M, N) = A (M, K)   . B (N, K)^T
//   TN   C (M, N) = A (K, M)^T . B (K, N)
//
// bf16 in, fp32 accumulation.  One producer warp keeps a ring of 64-deep A
// and B tiles filled by TMA (128-byte swizzle, completion on mbarriers),
// and two consumer warpgroups each run wgmma.m64nNk16 from shared memory
// on 64 of the rows, one group of k-steps in flight while the next tile
// lands.  A block is 128 x 256 (one an SM, four slots) or 128 x 128 (two
// an SM, three slots).  The layouts are descriptor choices: A K-major (NN,
// NT) or MN-major (TN: its tile is two 64-column boxes of A^T), B K-major
// (NT) or MN-major (NN, TN: 64-column boxes, one swizzle atom each, the
// descriptor's leading offset stepping between them).  TMA zero-fills past
// the matrix edges (a ragged M, N or K, the rank's unused rows and
// columns).  The epilogue stages the tile in the ring in the layout of
// 128-byte TMA boxes and stores it by TMA, which skips what lies past the
// edges; an epilogue that reads an (M, N) input (DGELU's fp32
// pre-activation, a site's residual or cotangent) brings its tile in the
// same way first.
//
// The rank step (RK != 0): more k-tiles on the same accumulators, acc +=
// A2 . B2, A2 the rank operand (zero past the rank r) and B2 the other
// rank factor.  Up to rank 64 it is one k-tile of RK k-steps of 16 (RK 1
// or 4).  NN reads A2 (M, 64) from memory, or (ZN > 0) folds it in: z = A U
// accumulated in fp32 over the same k-tiles as the main product (one more
// small wgmma on the A tile the block already holds, U (K, r8) loaded
// MN-major beside B), rounded to bf16 once, staged in shared memory as A2
// and written out (M, 64) by the blocks of column 0 where the caller asks
// for it; B2 = V (r, N).  NT folds gv = A V^T the same way, V (r, K)
// loaded K-major, B2 = U (N, r8).  No pre-pass, no second read of A.
// Past rank 64 (RK == RK_LOOP) a folded z would hold R / 2 more fp32
// registers a thread beside the accumulators (R = 64 ceil(r / 64)), so A2
// (M, R) comes from memory, written by a pre-pass (cara_rank_z, one read
// of A), and the rank step is p.rc = R / 64 more k-tiles of 64 through
// the same ring: A2's columns 64 c .. 64 c + 63 and B2's rank rows (NN:
// V (r, N)) or columns (NT: U (N, R)) 64 c .. + 63, zero past r.  Every
// tile is four k-steps, so the loop over them is uniform: its trip count
// is a run-time value like the main loop's, its depth a constant.
//
// Epilogues:
//   F32       C32 = acc                                 (dxa, dT partials)
//   BF16      C16 = bf16(acc [+ bias1])                 (qkv, do)
//   PRE_GELU  C32 = pre = acc + bias1 + bias2,  C16 = bf16(act(pre))
//   DGELU     dpre = acc * act'(AUX),  C16 = bf16(dpre),  plus per-block
//             fp32 column sums of dpre (the fc1 bias cotangent)
//   DGELU_H   DGELU on the saved bf16 pre-activation AUX, and C16B =
//             bf16(act(AUX)): the h of the saved-pre backward, from the
//             erf (or exponential) the derivative already evaluates
//   SITE_*    the forward CaRA site: y = acc + b + s (z V + cb), the
//             delta scale s applied in fp32 (acc is scaled by 1 / s before
//             the rank step and back after it), then
//             SITE           C16 = bf16(y)
//             SITE_GELU      C16 = bf16(act(y))
//             SITE_GELU_PRE  C16 = bf16(act(y)), C16B = bf16(y): the
//                            pre-activation kept for the backward
//             SITE_DACT      C16 = bf16(G * act'(y)), G (M, N) bf16
//             SITE_RES       C16 = bf16(RES + dpm[row] * y)
//             SITE_GELU_RES  C16 = bf16(RES + dpm[row] * act(y))
//
// act is the template parameter ACT (gelu.cuh): the exact-erf GELU
// (ACT_GELU, the default) or CLIP's quick_gelu (ACT_QUICK_GELU), the
// same epilogue code at compile time, so that neither form pays a branch.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "sm90_common.cuh"

// The arguments and the TMA maps of one product: outside the anonymous
// namespace below, so that a launcher in another source file (the
// site's quick_gelu instances, cp_site_quick.cu) takes the same types.
namespace sm90gemm {

struct GemmArgs {
  float* c32;
  __nv_bfloat16* c16;
  const __nv_bfloat16* bias1;  // the bias b of a site
  const __nv_bfloat16* bias2;  // a site's cb (may be null)
  const void* aux;   // DGELU: the fp32 pre-activation (M, N); DGELU_H bf16
  float* colpart;    // DGELU*: (gridDim.y, N) column sums of dpre
  __nv_bfloat16* gv;  // folded rank step: z out, (M, 64) (may be null: NN)
  const float* dpm;   // SITE_*RES: the per-row gate (M,)
  int* turn;  // TN split over blockIdx.z: one zeroed counter per tile
  int M, N, K;
  int k_split;  // contraction rows per blockIdx.z
  int rc;       // RK_LOOP: the rank step's k-tiles of 64, ceil(r / 64)
  float s;      // SITE_*: the delta scale
};

// TMA maps: A and B by layout; A2 (M, 64, or R past rank 64) and B2 for
// a rank step from memory; the folded operand (NT: V (r, K); NN: U (K,
// r8)); the fp32 output C32, the bf16 outputs C16 and C16B and the
// epilogue's (M, N) input (DGELU's fp32 AUX, DGELU_H's bf16 one; a site's
// bf16 residual or G), in boxes of 128 rows and 128 bytes.
struct GemmMaps {
  CUtensorMap a, b, a2, b2, v, c32, c16, c16b, aux;
};

}  // namespace sm90gemm

namespace {

using sm90gemm::GemmArgs;
using sm90gemm::GemmMaps;

constexpr int BM = 128;
constexpr int BK = 64;
constexpr int THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int ATOM = 64 * BK * 2;  // one 64 x 64 bf16 box: 8 KB

enum { NN = 0, NT = 1, TN = 2 };
// RK of the rank step past rank 64: p.rc k-tiles of 64 from memory.
constexpr int RK_LOOP = -1;
enum {
  EPI_F32 = 0,
  EPI_BF16 = 1,
  EPI_PRE_GELU = 2,
  EPI_DGELU = 3,
  EPI_SITE = 4,
  EPI_SITE_GELU = 5,
  EPI_SITE_DACT = 6,
  EPI_SITE_RES = 7,
  EPI_SITE_GELU_RES = 8,
  EPI_DGELU_H = 9,
  EPI_SITE_GELU_PRE = 10,
};

__host__ __device__ constexpr bool epi_site(int e) {
  return (e >= EPI_SITE && e <= EPI_SITE_GELU_RES) || e == EPI_SITE_GELU_PRE;
}
// The epilogues that sum dpre's columns.
__host__ __device__ constexpr bool epi_dgelu(int e) {
  return e == EPI_DGELU || e == EPI_DGELU_H;
}
__host__ __device__ constexpr bool epi_gelu(int e) {
  return e == EPI_SITE_GELU || e == EPI_SITE_GELU_RES ||
         e == EPI_SITE_GELU_PRE;
}
// The epilogues with a second bf16 output, C16B.
__host__ __device__ constexpr bool epi_c16b(int e) {
  return e == EPI_DGELU_H || e == EPI_SITE_GELU_PRE;
}
__host__ __device__ constexpr bool epi_res(int e) {
  return e == EPI_SITE_RES || e == EPI_SITE_GELU_RES;
}
// The site epilogues that read a bf16 (M, N) tile: the residual or G.
__host__ __device__ constexpr bool epi_aux16(int e) {
  return epi_res(e) || e == EPI_SITE_DACT;
}

// One ring slot: the A tile (two 64-row halves, one per consumer
// warpgroup: 64 rows of 128 bytes K-major, or one 64 x 64 box of A^T),
// the B tile (BN rows or columns), and (folded rank step) the tile of the
// folded operand: 64 k-rows of ZN columns (NN) or ZN rows of 64 k (NT),
// 2 or 8 KB.  Every part starts on a 1024-byte boundary, as the 128-byte
// swizzle wants.  A 128-wide block runs two to an SM with three slots
// each, a 256-wide one alone with four.  After the products the ring
// holds the output tile on its way out (fp32 and / or bf16, in 128-row
// chunks of 128 bytes, 128-byte swizzle; DGELU's fp32 AUX tile beside its
// bf16 output: 96 KB at most for a 128-wide block, 128 KB for a 256-wide
// one; a site's bf16 input tile in the place of its output; the second
// bf16 tile, C16B's, after the first, where DGELU_H's AUX lands and its h
// leaves); behind the barriers, DGELU's per-warp column sums.
template <int BN, int ZN>
struct Ring {
  static constexpr int STAGES = BN == 128 ? 3 : 4;
  static constexpr int BLOCKS = BN == 128 ? 2 : 1;  // per SM
  static constexpr int A = BM * BK * 2;
  static constexpr int B = BN * BK * 2;
  static constexpr int V = ZN * BK * 2;
  static constexpr int SLOT = A + B + V;
  static constexpr int BARS = STAGES * SLOT;
  static constexpr int RED = BARS + (2 * STAGES + 1) * 8;
  static constexpr int SMEM = RED + 1024;  // + alignment
  static constexpr int SMEM_DGELU = SMEM + 8 * BN * 4;
  static_assert(BARS >= BM * BN * (BN == 128 ? 6 : 4), "epilogue tile");
};

template <int L, int E, int BN, int RK, int ZN, int ACT = ACT_GELU>
__global__ void __launch_bounds__(THREADS, (Ring<BN, ZN>::BLOCKS))
gemm_kernel(const __grid_constant__ GemmMaps maps, const GemmArgs p) {
  using namespace sm90;
  using R = Ring<BN, ZN>;
  constexpr int STAGES = R::STAGES;
  constexpr int TA = L == TN;
  constexpr int TB = L != NT;
  constexpr bool SITE = epi_site(E);
  constexpr bool RANK = RK != 0;
  static_assert(!SITE || (L == NN && (RK == 0 || ZN > 0 || RK == RK_LOOP)),
                "a site is NN with its rank step folded in, from memory "
                "past rank 64, or none");
  static_assert(RK != RK_LOOP || ZN == 0, "past rank 64 A2 is read");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* epi_full = empty + STAGES;  // the epilogue's input tile landed
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.k_split;
  const int kend = min(p.K, kbeg + p.k_split);
  const int KT = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  // The rank step's k-tiles after the KT of the contraction.
  const int RT = RK == RK_LOOP ? p.rc : RANK ? 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(epi_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp
    if (tid == 256) {
      // Tiles 0 .. KT - 1 of the contraction, then the rank step's RT
      // tiles (rank columns 64 (kt - KT) ..): B2, and A2 unless the
      // consumers stage it.
      for (int kt = 0; kt < KT + RT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        unsigned char* as = smem + s * R::SLOT;
        unsigned char* bs = as + R::A;
        const bool rank = kt >= KT;
        const CUtensorMap* mb = rank ? &maps.b2 : &maps.b;
        const int k = rank ? BK * (kt - KT) : kbeg + kt * BK;
        mbar_expect_tx(&full[s], rank ? (ZN ? 0 : R::A) + R::B : R::SLOT);
        if (rank) {
          if (!ZN) tma_load_2d(as, &maps.a2, &full[s], k, m0);
        } else if (L == TN) {
          tma_load_2d(as, &maps.a, &full[s], m0, k);
          tma_load_2d(as + ATOM, &maps.a, &full[s], m0 + 64, k);
        } else {
          tma_load_2d(as, &maps.a, &full[s], k, m0);
        }
        if (L == NT) {
          tma_load_2d(bs, mb, &full[s], k, n0);
        } else {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(bs + c * ATOM, mb, &full[s], n0 + 64 * c, k);
        }
        if (ZN && !rank) {
          if (L == NT)
            tma_load_2d(bs + R::B, &maps.v, &full[s], k, 0);
          else  // U's rows k .. k + 63, ZN columns
            tma_load_2d(bs + R::B, &maps.v, &full[s], 0, k);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup w owns rows m0 + 64 w .. + 63.  Every wgmma sits
  // on a path that is uniform over the warpgroup and fixed at compile time
  // (the rank step's depth RK too): ptxas serializes wgmma on a branch it
  // cannot prove uniform.
  const int w = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float z[ZN ? ZN / 2 : 1];
#pragma unroll
  for (int i = 0; i < (ZN ? ZN / 2 : 1); ++i) z[i] = 0.f;

  // Tile kt's products, one commit group: the main product and (ZN > 0)
  // the folded z beside it.
  auto issue = [&](int kt) {
    const int s = kt % STAGES;
    unsigned char* as = smem + s * R::SLOT + w * ATOM;
    unsigned char* bs = smem + s * R::SLOT + R::A;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint64_t da = desc<128>(as);
    const uint64_t db = TB ? desc_mn(bs, ATOM) : desc<128>(bs);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<BN, TA, TB>(acc, da + (TA ? 128 : 2) * kk,
                           db + (TB ? 128 : 2) * kk, 1);
    if constexpr (ZN > 0 && L == NT) {
      const uint64_t dv = desc<128>(bs + R::B);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<ZN, 0, 0>(z, da + 2 * kk, dv + 2 * kk, 1);
    } else if constexpr (ZN > 0) {
      // U's tile MN-major: rows of ZN columns (2 ZN bytes, that swizzle);
      // a k-step is 16 rows further on.
      const uint64_t du = desc<2 * ZN>(bs + R::B);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<ZN, 0, 1>(z, da + 2 * kk, du + 2 * ZN * kk, 1);
    }
    wgmma_commit();
  };
  // One group in flight while the next tile's lands; each completed
  // tile's slot goes back to the producer.  With a folded z the last tile
  // is issued after the loop and waited for in full (KT >= 1 there): a
  // group still in flight at the loop's exit makes ptxas serialize every
  // wgmma of the kernel (C7515).
  constexpr int PEEL = ZN > 0 ? 1 : 0;
  for (int kt = 0; kt < KT - PEEL; ++kt) {
    issue(kt);
    wgmma_wait<1>();
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  if constexpr (PEEL) {
    issue(KT - 1);
    wgmma_wait<0>();
    if (KT > 1) mbar_arrive(&empty[(KT - 2) % STAGES]);
  }
  if constexpr (RK > 0) {
    // The rank step: RK k-steps of A2 (zero past the rank) . B2.
    const int s = KT % STAGES;
    unsigned char* as = smem + s * R::SLOT + w * ATOM;
    unsigned char* bs = smem + s * R::SLOT + R::A;
    if constexpr (ZN > 0) {
      // z is complete: rounded to bf16 into this warpgroup's A2 rows of
      // the slot (K-major, 128-byte swizzle; ZN = 16 RK columns, zero past
      // the rank as the folded operand's rows or columns past it arrive as
      // zeros), rows no TMA writes in this step.
      static_assert(ZN == 16 * RK, "the folded z is the rank step's A2");
      fence_regs(z);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = warp * 16 + g + 8 * half;
#pragma unroll
        for (int j = 0; j < ZN / 8; ++j)
          *reinterpret_cast<uint32_t*>(
              as + swizzle<128>(row * 128 + (8 * j + t2) * 2)) =
              pack_bf16(z[4 * j + 2 * half], z[4 * j + 2 * half + 1]);
      }
      fence_proxy_async();
      named_barrier(1 + w, 128);
    }
    if constexpr (SITE) {
      // acc / s + z V, so that the epilogue's s (acc / s + z V + cb) + b
      // applies the delta scale in fp32.
      fence_regs(acc);
      const float inv = 1.f / p.s;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] *= inv;
    }
    mbar_wait(&full[s], (KT / STAGES) & 1);
    const uint64_t da = desc<128>(as);
    const uint64_t db = TB ? desc_mn(bs, ATOM) : desc<128>(bs);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RK; ++kk)
      wgmma_ss<BN, 0, TB>(acc, da + 2 * kk, db + (TB ? 128 : 2) * kk, 1);
    wgmma_commit();
  }
  if constexpr (RK == RK_LOOP) {
    // Past rank 64: the rank step's p.rc tiles, each four k-steps of A2
    // (from memory) . B2, one group in flight as in the main loop; each
    // tile releases the one before it (first the contraction's last).
    // The contraction's last group is waited for first: a group pending
    // into the second loop made ptxas serialize the DGELU instances'
    // wgmma (C7515).
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (SITE) {
      // acc / s + z V (see above), once the contraction is complete.
      const float inv = 1.f / p.s;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] *= inv;
    }
    for (int c = 0; c < p.rc; ++c) {
      const int kt = KT + c;
      const int s = kt % STAGES;
      unsigned char* as = smem + s * R::SLOT + w * ATOM;
      unsigned char* bs = smem + s * R::SLOT + R::A;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint64_t da = desc<128>(as);
      const uint64_t db = TB ? desc_mn(bs, ATOM) : desc<128>(bs);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<BN, 0, TB>(acc, da + 2 * kk, db + (TB ? 128 : 2) * kk, 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue: thread (g, t) of warp `warp` holds rows warp * 16 + g (+ 8)
  // of its warpgroup's 64 and columns 8 j + 2 t (+ 1) of the BN.  Once
  // both warpgroups are done with the ring, the results go into it in
  // the layout of 128-row boxes of 128 bytes (128-byte swizzle, which
  // spreads a warp's writes over the banks) and leave by TMA stores,
  // which skip rows and columns past M and N.  DGELU first brings its
  // fp32 AUX tile in by TMA (zeros past the edges), DGELU_H its bf16 one
  // into C16B's tile, a site its bf16 residual or G tile, in the place of
  // its output.
  named_barrier(3, 256);
  unsigned char* t32 = smem;  // fp32 tile: BN / 32 chunks of 16 KB
  unsigned char* t16 =        // bf16 tile: BN / 64 chunks of 16 KB
      smem + (E == EPI_PRE_GELU || E == EPI_DGELU ? BM * BN * 4 : 0);
  unsigned char* t16b = t16 + BM * BN * 2;  // the second bf16 tile
  if constexpr (E == EPI_DGELU || E == EPI_DGELU_H || epi_aux16(E)) {
    if (tid == 0) {
      if constexpr (E == EPI_DGELU) {
        mbar_expect_tx(epi_full, BM * BN * 4);
#pragma unroll
        for (int c = 0; c < BN / 32; ++c)
          tma_load_2d(t32 + c * BM * 128, &maps.aux, epi_full, n0 + 32 * c,
                      m0);
      } else {
        unsigned char* in = E == EPI_DGELU_H ? t16b : t16;
        mbar_expect_tx(epi_full, BM * BN * 2);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(in + c * BM * 128, &maps.aux, epi_full, n0 + 64 * c,
                      m0);
      }
    }
    mbar_wait(epi_full, 0);
  }
  float* red = reinterpret_cast<float*>(smem + R::RED);  // [8 warps][BN]
  const int rbase = w * 64 + warp * 16 + g;  // row within the tile
  float gate[2] = {0.f, 0.f};
  if constexpr (epi_res(E)) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + rbase + 8 * half;
      gate[half] = gm < p.M ? p.dpm[gm] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + t2;
    const int gn = n0 + col;
    float2 b1 = make_float2(0.f, 0.f), b2 = b1;
    if ((E == EPI_BF16 || E == EPI_PRE_GELU || SITE) && p.bias1 && gn < p.N)
      b1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.bias1 + gn));
    if ((E == EPI_PRE_GELU || SITE) && p.bias2 && gn < p.N)
      b2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.bias2 + gn));
    float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = rbase + 8 * half;
      float2* o32 = reinterpret_cast<float2*>(
          t32 + (col / 32) * BM * 128 +
          swizzle<128>(row * 128 + (col % 32) * 4));
      uint32_t* o16 = reinterpret_cast<uint32_t*>(
          t16 + (col / 64) * BM * 128 +
          swizzle<128>(row * 128 + (col % 64) * 2));
      uint32_t* o16b = reinterpret_cast<uint32_t*>(
          reinterpret_cast<unsigned char*>(o16) + BM * BN * 2);
      const float a0 = acc[4 * j + 2 * half];
      const float a1 = acc[4 * j + 2 * half + 1];
      if constexpr (SITE) {
        // y = acc + b + s (z V + cb): with a rank step acc holds
        // acc / s + z V (see above).
        float y0, y1;
        if constexpr (RANK) {
          y0 = fmaf(p.s, a0 + b2.x, b1.x);
          y1 = fmaf(p.s, a1 + b2.y, b1.y);
        } else {
          y0 = a0 + b1.x + p.s * b2.x;
          y1 = a1 + b1.y + p.s * b2.y;
        }
        if constexpr (E == EPI_SITE_GELU_PRE) *o16b = pack_bf16(y0, y1);
        if constexpr (epi_gelu(E)) {
          y0 = act_fwd<ACT>(y0);
          y1 = act_fwd<ACT>(y1);
        }
        if constexpr (epi_aux16(E)) {
          const uint32_t raw = *o16;
          const float2 in = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw));
          if constexpr (E == EPI_SITE_DACT) {
            y0 = in.x * act_grad<ACT>(y0);
            y1 = in.y * act_grad<ACT>(y1);
          } else {
            y0 = in.x + gate[half] * y0;
            y1 = in.y + gate[half] * y1;
          }
        }
        *o16 = pack_bf16(y0, y1);
        continue;
      }
      float y0 = a0 + b1.x + b2.x;
      float y1 = a1 + b1.y + b2.y;
      if (E == EPI_F32) {
        *o32 = make_float2(y0, y1);
      } else if (E == EPI_BF16) {
        *o16 = pack_bf16(y0, y1);
      } else if (E == EPI_PRE_GELU) {
        *o32 = make_float2(y0, y1);
        *o16 = pack_bf16(act_fwd<ACT>(y0), act_fwd<ACT>(y1));
      } else if (E == EPI_DGELU) {  // rows, columns past the edges are 0
        const float2 pre = *o32;
        y0 *= act_grad<ACT>(pre.x);
        y1 *= act_grad<ACT>(pre.y);
        *o16 = pack_bf16(y0, y1);
        cs0 += y0;
        cs1 += y1;
      } else {  // EPI_DGELU_H: h replaces the pre-activation in its tile
        const uint32_t raw = *o16b;
        const float2 pre = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw));
        float h0, h1;
        y0 *= act_and_grad<ACT>(pre.x, h0);
        y1 *= act_and_grad<ACT>(pre.y, h1);
        *o16 = pack_bf16(y0, y1);
        *o16b = pack_bf16(h0, h1);
        cs0 += y0;
        cs1 += y1;
      }
    }
    if (epi_dgelu(E)) {
      // This warp's column sums, in a fixed order: the thread's two rows,
      // then across the 8 lanes of a column (shuffles).
      cs0 += __shfl_xor_sync(0xffffffffu, cs0, 4);
      cs1 += __shfl_xor_sync(0xffffffffu, cs1, 4);
      cs0 += __shfl_xor_sync(0xffffffffu, cs0, 8);
      cs1 += __shfl_xor_sync(0xffffffffu, cs1, 8);
      cs0 += __shfl_xor_sync(0xffffffffu, cs0, 16);
      cs1 += __shfl_xor_sync(0xffffffffu, cs1, 16);
      if (g == 0) {
        red[(w * 4 + warp) * BN + col] = cs0;
        red[(w * 4 + warp) * BN + col + 1] = cs1;
      }
    }
  }
  fence_proxy_async();
  named_barrier(3, 256);
  if (tid == 0) {
    if (L == TN && gridDim.z > 1) {
      // The split contraction summed in order of blockIdx.z: split 0
      // stores its tile, split z adds its own once the tile's counter
      // reads z (its add complete in memory before the counter moves
      // on); the last split sets the counter back to 0 for the next
      // launch.  blockIdx.z is the slowest grid index, so a block's
      // predecessors have lower linear indices: the hardware dispatches
      // blocks in that order, so they are running or done when it waits.
      int* turn = p.turn + blockIdx.y * gridDim.x + blockIdx.x;
      if (blockIdx.z > 0) wait_turn(turn, blockIdx.z);
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        if (blockIdx.z == 0)
          tma_store_2d(&maps.c32, t32 + c * BM * 128, n0 + 32 * c, m0);
        else
          tma_reduce_add_2d(&maps.c32, t32 + c * BM * 128, n0 + 32 * c, m0);
      }
      bulk_wait();
      if (blockIdx.z + 1 < gridDim.z)
        pass_turn(turn);
      else
        *turn = 0;
    } else if (E == EPI_F32 || E == EPI_PRE_GELU) {
#pragma unroll
      for (int c = 0; c < BN / 32; ++c)
        tma_store_2d(&maps.c32, t32 + c * BM * 128, n0 + 32 * c, m0);
    }
    if (E != EPI_F32) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        tma_store_2d(&maps.c16, t16 + c * BM * 128, n0 + 64 * c, m0);
    }
    if (epi_c16b(E)) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        tma_store_2d(&maps.c16b, t16b + c * BM * 128, n0 + 64 * c, m0);
    }
  }
  if (epi_dgelu(E) && tid < BN && n0 + tid < p.N) {
    // The block's 128 rows: the eight warps' sums in a fixed order.
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) v += red[q * BN + tid];
    p.colpart[(size_t)blockIdx.y * p.N + n0 + tid] = v;
  }
  if constexpr (ZN > 0) if (blockIdx.x == 0 && p.gv != nullptr) {
    // z = bf16 (M, 64), zero past ZN: the blocks of column 0.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + rbase + 8 * half;
      if (gm >= p.M) continue;
      uint32_t* row = reinterpret_cast<uint32_t*>(p.gv + (size_t)gm * 64);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t v = 0u;
        if (j < ZN / 8)
          v = pack_bf16(z[4 * j + 2 * half], z[4 * j + 2 * half + 1]);
        row[(8 * j + t2) / 2] = v;
      }
    }
  }
  // The stores have read the tile before the block's memory goes.
  if (tid == 0) bulk_wait_read();
}

// A 2-D map over the row-major (rows, inner) matrix at `base` whose rows
// are `ld` elements apart, box (box_inner elements of a row, box_rows)
// with the swizzle of a box row's bytes (by default 128 bytes); bf16, or
// fp32 with `elem_bytes` 4.
int map2d(CUtensorMap* map, const void* base, int inner, int rows, int ld,
          int box_rows, int elem_bytes = 2, int box_inner = 0) {
  const uint64_t dims[2] = {(uint64_t)inner, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)ld * elem_bytes};
  const uint32_t box[2] = {
      (uint32_t)(box_inner ? box_inner : 128 / elem_bytes),
      (uint32_t)box_rows};
  return sm90::encode_map(map, base, 2, dims, strides, box, elem_bytes);
}

template <int L, int E, int BN, int RK, int ZN, int ACT = ACT_GELU>
int launch(const GemmMaps& maps, const GemmArgs& p, int splits,
           cudaStream_t stream) {
  using R = Ring<BN, ZN>;
  constexpr int smem = epi_dgelu(E) ? R::SMEM_DGELU : R::SMEM;
  // Set once: the attribute is per process (one device per process).
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<L, E, BN, RK, ZN, ACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  gemm_kernel<L, E, BN, RK, ZN, ACT><<<grid, THREADS, smem, stream>>>(maps,
                                                                   p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
