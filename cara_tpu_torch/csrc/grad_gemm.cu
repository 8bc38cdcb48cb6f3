// The GEMMs of the block backward kernels for Hopper (sm_90a):
//
//   NN   C (M, N) = A (M, K)   . B (K, N)      forward recompute
//   NT   C (M, N) = A (M, K)   . B (N, K)^T    dx products g W'^T
//   TN   C (M, N) = A (K, M)^T . B (K, N)      dense cotangents dT = x^T g
//
// bf16 in, fp32 accumulation, with the epilogues the TPU kernels apply to
// each product before anything leaves VMEM:
//
//   F32       C32 = acc                                 (dxa, dT partials)
//   BF16      C16 = bf16(acc [+ bias1])                 (qkv, do)
//   PRE_GELU  C32 = pre = acc + bias1 + bias2,  C16 = bf16(gelu(pre))
//   DGELU     dpre = acc * gelu'(AUX),  C16 = bf16(dpre),  plus per-block
//             fp32 column sums of dpre (the fc1 bias cotangent)
//
// NN and NT take an optional rank step: one more k-tile (16 or 64 deep)
// on the same accumulators, acc += A2 . B2, where A2 is the rank operand
// (bf16(x U) or bf16(g V^T), zero past the rank r) and B2 the other rank
// factor, the delta scale folded in by the caller (NN: V (r, N); NT: U
// (N, r8), r8 = r rounded up to 8).  That is the TPU kernels' rank-space
// delta: _cp_dense_dx_kernel's g W^T + s (g V^T) U^T (cp_dense.py, row 12)
// and _mlp_bwd_kernel's fc1 recompute, dh and dxa (cp_mlp.py, row 10).
// The delta is never folded into a dense W + s U V, which would round it
// at W's scale.  NN reads A2 (M, 64) from memory (the rank pre-pass of
// cp_site.cu).  NT folds it in, as _cp_dense_dx_kernel does: z = A V^T
// accumulated in fp32 over the same k-tiles as the main product (one
// more small wgmma on the A tile the block already holds, V (r, K)
// loaded beside B), rounded to bf16 once, staged in shared memory as the
// rank step's A2, and written out as gv (M, 64) by the blocks of column
// 0; no pre-pass, no second read of A.
//
// Replaces the products inside cara_tpu/ops/pallas/cp_attn_block.py
// _attn_block_bwd_wd_kernel (qkv recompute, g wp'^T, dqkv wq'^T, o^T g,
// xa^T dqkv), cara_tpu/ops/pallas/cp_mlp.py _mlp_bwd_wd_kernel (row 11:
// pre recompute, g w2'^T with gelu', dpre w1'^T, xa^T dpre, h^T g) and
// cara_tpu/ops/pallas/cp_dense.py _cp_dense_dx_kernel (row 12's dx).  The
// TPU kernels keep every intermediate of a 256-row tile in VMEM and
// accumulate dT over the sequential grid; on Hopper the grid is parallel,
// so the dT products reduce over the M = B * N token rows inside each
// block, optionally split over blockIdx.z, the splits' tiles added into
// the output one after another in split order (an ordering counter a
// tile, TMA reduce-add): no unordered atomics, runs repeat bit for bit.
//
// What bounds it: at ViT-B every product is 15-60 GFLOP against 20-80 MB,
// far above the H100's ~295 FLOP/byte ridge, so the tensor cores; the
// PRE_GELU and DGELU epilogues move 6 bytes an output (232 MB at M =
// 12608, hidden 3072), which puts their bound on bytes.  The previous
// design (mma.sync on 64 x 32 warp tiles, a cp.async ring, ldmatrix)
// reached 145-220 TFLOP/s.  This one is the Hopper GEMM shape: one
// producer warp keeps a ring of 64-deep A and B tiles filled by TMA
// (128-byte swizzle, completion on mbarriers), and two consumer
// warpgroups each run wgmma.m64nNk16 from shared memory on 64 of the
// rows, one group of k-steps in flight while the next tile lands.  A
// block is 128 x 256 (one an SM, four slots) where the output allows and
// 128 x 128 (two an SM, three slots) for narrow outputs and the 6-byte
// epilogues, where one block's products run while the other stores
// (pick_bn).  The layouts are descriptor choices: A K-major (NN, NT) or
// MN-major (TN: its tile is two 64-column boxes of A^T), B K-major (NT)
// or MN-major (NN, TN: 64-column boxes, one swizzle atom each, the
// descriptor's leading offset stepping between them).  TMA zero-fills
// past the matrix edges (a ragged M, N or K, the rank's unused rows and
// columns).  The epilogue stages the tile in the ring in the layout of
// 128-byte TMA boxes and stores it by TMA, which skips what lies past
// the edges; DGELU brings its fp32 pre-activation tile in the same way.
// Measured on one H100 80GB HBM3 at 700 W (tools/compare_parent.py, in
// turns with the previous design), row 11's products at M 12608, E 768,
// hidden 3072, ms a call by events: NN PRE_GELU 0.216-0.228 (previous
// 0.325-0.334), NT DGELU 0.215-0.242 (0.386-0.408), NT dxa 0.131-0.150
// (0.270-0.275), TN dT 0.133-0.163 (0.357-0.365), torch.matmul on the
// same shapes 0.092-0.121.  The folded variants at a 128-wide block spill
// (96 registers for two blocks an SM) and ptxas serializes their wgmma.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BK = 64;
constexpr int THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int ATOM = 64 * BK * 2;  // one 64 x 64 bf16 box: 8 KB

enum { NN = 0, NT = 1, TN = 2 };
enum { EPI_F32 = 0, EPI_BF16 = 1, EPI_PRE_GELU = 2, EPI_DGELU = 3 };

struct GemmArgs {
  float* c32;
  __nv_bfloat16* c16;
  const __nv_bfloat16* bias1;
  const __nv_bfloat16* bias2;
  const float* aux;  // DGELU: the fp32 pre-activation (M, N)
  float* colpart;    // DGELU: (gridDim.y, N) column sums of dpre
  __nv_bfloat16* gv;  // folded rank step: z = bf16(A V^T) out, (M, 64)
  int* turn;  // TN split over blockIdx.z: one zeroed counter per tile
  int M, N, K;
  int k_split;  // contraction rows per blockIdx.z
};

// TMA maps: A and B by layout; A2 (M, 64) and B2 for a rank step from
// memory; V (r, K) for the folded one; the fp32 output C32, the bf16
// output C16 and DGELU's fp32 AUX, in boxes of 128 rows and 128 bytes.
struct GemmMaps {
  CUtensorMap a, b, a2, b2, v, c32, c16, aux;
};

// One ring slot: the A tile (two 64-row halves, one per consumer
// warpgroup: 64 rows of 128 bytes K-major, or one 64 x 64 box of A^T),
// the B tile (BN rows or columns), and (folded rank step) the ZN x 64
// tile of V.  Every part starts on a 1024-byte boundary, as the 128-byte
// swizzle wants.  A 128-wide block runs two to an SM with three slots
// each, a 256-wide one alone with four.  After the products the ring
// holds the output tile on its way out (fp32 and / or bf16, in 128-row
// chunks of 128 bytes, 128-byte swizzle; DGELU's fp32 AUX tile beside
// its bf16 output: 96 KB at most for a 128-wide block, 128 KB for a
// 256-wide one); behind the barriers, DGELU's per-warp column sums.
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

template <int L, int E, int BN, int RK, int ZN>
__global__ void __launch_bounds__(THREADS, (Ring<BN, ZN>::BLOCKS))
grad_gemm_kernel(const __grid_constant__ GemmMaps maps, const GemmArgs p) {
  using namespace sm90;
  using R = Ring<BN, ZN>;
  constexpr int STAGES = R::STAGES;
  constexpr int TA = L == TN;
  constexpr int TB = L != NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* epi_full = empty + STAGES;  // DGELU: the AUX tile landed
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.k_split;
  const int kend = min(p.K, kbeg + p.k_split);
  const int KT = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

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
      // Tiles 0 .. KT - 1 of the contraction, then (RK > 0) the rank step
      // in slot KT % STAGES: B2, and A2 unless the consumers stage it.
      for (int kt = 0; kt < KT + (RK > 0); ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        unsigned char* as = smem + s * R::SLOT;
        unsigned char* bs = as + R::A;
        const bool rank = kt == KT;
        const CUtensorMap* mb = rank ? &maps.b2 : &maps.b;
        const int k = rank ? 0 : kbeg + kt * BK;
        mbar_expect_tx(&full[s], rank ? (ZN ? 0 : R::A) + R::B : R::SLOT);
        if (rank) {
          if (!ZN) tma_load_2d(as, &maps.a2, &full[s], 0, m0);
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
        if (ZN && !rank) tma_load_2d(bs + R::B, &maps.v, &full[s], k, 0);
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

  for (int kt = 0; kt < KT; ++kt) {
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
    if constexpr (ZN > 0) {
      const uint64_t dv = desc<128>(bs + R::B);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<ZN, 0, 0>(z, da + 2 * kk, dv + 2 * kk, 1);
    }
    wgmma_commit();
    // The previous tile's products are done: its slot goes back.
    wgmma_wait<1>();
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  if constexpr (RK > 0) {
    // The rank step: RK k-steps of A2 (zero past the rank) . B2.
    const int s = KT % STAGES;
    unsigned char* as = smem + s * R::SLOT + w * ATOM;
    unsigned char* bs = smem + s * R::SLOT + R::A;
    if constexpr (ZN > 0) {
      // z is complete: rounded to bf16 into this warpgroup's A2 rows of
      // the slot (K-major, 128-byte swizzle; ZN = 16 RK columns, zero past
      // the rank as V's rows past it arrive as zeros), rows no TMA writes
      // in this step.
      static_assert(ZN == 16 * RK, "the folded z is the rank step's A2");
      wgmma_wait<0>();
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
    mbar_wait(&full[s], (KT / STAGES) & 1);
    const uint64_t da = desc<128>(as);
    const uint64_t db = TB ? desc_mn(bs, ATOM) : desc<128>(bs);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RK; ++kk)
      wgmma_ss<BN, 0, TB>(acc, da + 2 * kk, db + (TB ? 128 : 2) * kk, 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue: thread (g, t) of warp `warp` holds rows warp * 16 + g (+ 8)
  // of its warpgroup's 64 and columns 8 j + 2 t (+ 1) of the BN.  Once
  // both warpgroups are done with the ring, the results go into it in
  // the layout of 128-row boxes of 128 bytes (128-byte swizzle, which
  // spreads a warp's writes over the banks) and leave by TMA stores,
  // which skip rows and columns past M and N.  DGELU first brings its
  // fp32 AUX tile in by TMA (zeros past the edges).
  named_barrier(3, 256);
  unsigned char* t32 = smem;  // fp32 tile: BN / 32 chunks of 16 KB
  unsigned char* t16 =        // bf16 tile: BN / 64 chunks of 16 KB
      smem + (E == EPI_PRE_GELU || E == EPI_DGELU ? BM * BN * 4 : 0);
  if constexpr (E == EPI_DGELU) {
    if (tid == 0) {
      mbar_expect_tx(epi_full, BM * BN * 4);
#pragma unroll
      for (int c = 0; c < BN / 32; ++c)
        tma_load_2d(t32 + c * BM * 128, &maps.aux, epi_full, n0 + 32 * c,
                    m0);
    }
    mbar_wait(epi_full, 0);
  }
  float* red = reinterpret_cast<float*>(smem + R::RED);  // [8 warps][BN]
  const int rbase = w * 64 + warp * 16 + g;  // row within the tile
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + t2;
    const int gn = n0 + col;
    float2 b1 = make_float2(0.f, 0.f), b2 = b1;
    if ((E == EPI_BF16 || E == EPI_PRE_GELU) && p.bias1 && gn < p.N)
      b1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.bias1 + gn));
    if (E == EPI_PRE_GELU && gn < p.N)
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
      float y0 = acc[4 * j + 2 * half] + b1.x + b2.x;
      float y1 = acc[4 * j + 2 * half + 1] + b1.y + b2.y;
      if (E == EPI_F32) {
        *o32 = make_float2(y0, y1);
      } else if (E == EPI_BF16) {
        *o16 = pack_bf16(y0, y1);
      } else if (E == EPI_PRE_GELU) {
        *o32 = make_float2(y0, y1);
        *o16 = pack_bf16(gelu(y0), gelu(y1));
      } else {  // EPI_DGELU: rows and columns past the edges are 0 here
        const float2 pre = *o32;
        y0 *= gelu_grad(pre.x);
        y1 *= gelu_grad(pre.y);
        *o16 = pack_bf16(y0, y1);
        cs0 += y0;
        cs1 += y1;
      }
    }
    if (E == EPI_DGELU) {
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
  }
  if (E == EPI_DGELU && tid < BN && n0 + tid < p.N) {
    // The block's 128 rows: the eight warps' sums in a fixed order.
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) v += red[q * BN + tid];
    p.colpart[(size_t)blockIdx.y * p.N + n0 + tid] = v;
  }
  if constexpr (ZN > 0) if (blockIdx.x == 0) {
    // gv = bf16(z) (M, 64), zero past ZN: the blocks of column 0.
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
// are `ld` elements apart, box (128 bytes of a row, box_rows); bf16, or
// fp32 with `elem_bytes` 4.
int map2d(CUtensorMap* map, const void* base, int inner, int rows, int ld,
          int box_rows, int elem_bytes = 2) {
  const uint64_t dims[2] = {(uint64_t)inner, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)ld * elem_bytes};
  const uint32_t box[2] = {(uint32_t)(128 / elem_bytes), (uint32_t)box_rows};
  return sm90::encode_map(map, base, 2, dims, strides, box, elem_bytes);
}

template <int L, int E, int BN, int RK, int ZN>
int launch(const GemmMaps& maps, const GemmArgs& p, int splits,
           cudaStream_t stream) {
  using R = Ring<BN, ZN>;
  constexpr int smem = E == EPI_DGELU ? R::SMEM_DGELU : R::SMEM;
  // Set once: the attribute is per process (one device per process).
  static const cudaError_t attr = cudaFuncSetAttribute(
      grad_gemm_kernel<L, E, BN, RK, ZN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  grad_gemm_kernel<L, E, BN, RK, ZN>
      <<<grid, THREADS, smem, stream>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

// The block width: 128 or 256 columns (pick_bn); the epilogues that move
// 6 bytes an output always take 128.
template <int L, int E, int RK, int ZN>
int launch_bn(const GemmMaps& maps, const GemmArgs& p, int splits, int bn,
              cudaStream_t stream) {
  if constexpr (E == EPI_F32 || E == EPI_BF16)
    if (bn == 256) return launch<L, E, 256, RK, ZN>(maps, p, splits, stream);
  return launch<L, E, 128, RK, ZN>(maps, p, splits, stream);
}

// NN: no rank step, or A2 from memory 16 or 64 deep (rk 1 or 4).
template <int E>
int launch_nn(const GemmMaps& maps, const GemmArgs& p, int rk, int bn,
              cudaStream_t stream) {
  if (rk == 1) return launch_bn<NN, E, 1, 0>(maps, p, 1, bn, stream);
  if (rk == 4) return launch_bn<NN, E, 4, 0>(maps, p, 1, bn, stream);
  return launch_bn<NN, E, 0, 0>(maps, p, 1, bn, stream);
}

// NT: no rank step, or the folded one with z 16 or 64 wide.
template <int E>
int launch_nt(const GemmMaps& maps, const GemmArgs& p, int rk, int bn,
              cudaStream_t stream) {
  if (rk == 1) return launch_bn<NT, E, 1, 16>(maps, p, 1, bn, stream);
  if (rk == 4) return launch_bn<NT, E, 4, 64>(maps, p, 1, bn, stream);
  return launch_bn<NT, E, 0, 0>(maps, p, 1, bn, stream);
}

// The block width (measured at ViT-B's shapes on one H100): 256 columns,
// one block an SM, where the output allows; 128, two blocks an SM, for M
// or N < 256 and for the epilogues that move 6 bytes an output
// (PRE_GELU's fp32 pre and bf16 h; DGELU's fp32 pre read and bf16 dpre
// written), where the second block's products run while one block
// stores.  _bwd.dt_splits assumes the same rule.
int pick_bn(int epi, int M, int N) {
  return (M < 256 || N < 256 || epi == EPI_PRE_GELU || epi == EPI_DGELU)
             ? 128
             : 256;
}

}  // namespace

// C = op(A) . op(B) [+ A2 . B2] with the given layout (0 NN, 1 NT,
// 2 TN) and epilogue (0 F32, 1 BF16, 2 PRE_GELU, 3 DGELU); see the head
// comment for the operand shapes.  `splits` > 1 (TN, F32 only) splits the
// contraction over that many blocks a tile, summed into C in order; turn
// then holds one zeroed int32 a 128 x 128 output tile, zero again when
// the product ends (one launch at a time may use it: a stream's).  NN: a2 (M, 64) and b2 (r2, N), r2 <= 64, add the rank
// step (null a2: none).  NT: vfold (rfold, K), rfold <= 64, folds the
// rank operand in: z = bf16(A vfold^T), written to gv (M, 64), is A2 for
// B2 = b2 (N, ldb2) of depth r2 (rfold rounded up to 8); null vfold: no
// rank step.  Needs M (TN), N and K (NN, NT) multiples of 8 and 16-byte
// aligned pointers; the wrapper checks.  Returns cudaGetLastError() or
// the tensor-map encoding's error.
extern "C" int cara_grad_gemm(int layout, int epi, const void* a,
                              const void* b, void* c32, void* c16,
                              const void* bias1, const void* bias2,
                              const void* aux, void* colpart, const void* a2,
                              const void* b2, const void* vfold, void* gv,
                              void* turn, int M, int N, int K, int splits,
                              int r2, int ldb2, int rfold,
                              void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  GemmArgs p;
  p.c32 = static_cast<float*>(c32);
  p.c16 = static_cast<__nv_bfloat16*>(c16);
  p.bias1 = static_cast<const __nv_bfloat16*>(bias1);
  p.bias2 = static_cast<const __nv_bfloat16*>(bias2);
  p.aux = static_cast<const float*>(aux);
  p.colpart = static_cast<float*>(colpart);
  p.gv = static_cast<__nv_bfloat16*>(gv);
  p.turn = static_cast<int*>(turn);
  p.M = M;
  p.N = N;
  p.K = K;
  if (splits < 1 ||
      (splits > 1 && !(layout == TN && epi == EPI_F32 && turn != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int rk = 0;  // the rank step's k-steps of 16
  if (layout == NN && a2 != nullptr) {
    if (b2 == nullptr || r2 < 1 || r2 > BK)
      return static_cast<int>(cudaErrorInvalidValue);
    rk = r2 <= 16 ? 1 : 4;
  } else if (layout == NT && vfold != nullptr) {
    rk = rfold <= 16 ? 1 : 4;
    if (b2 == nullptr || gv == nullptr || rfold < 1 || rfold > BK ||
        r2 != (rfold + 7) / 8 * 8 || ldb2 < r2 || ldb2 % 8)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (a2 != nullptr || vfold != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = (K + splits - 1) / splits;
  p.k_split = splits > 1 ? (per + BK - 1) / BK * BK : K;

  const int bn = pick_bn(epi, M, N);
  GemmMaps maps;
  int err = layout == TN ? map2d(&maps.a, a, M, K, M, 64)
                         : map2d(&maps.a, a, K, M, K, BM);
  if (!err)
    err = layout == NT ? map2d(&maps.b, b, K, N, K, bn)
                       : map2d(&maps.b, b, N, K, N, 64);
  if (!err && rk && layout == NN) {
    err = map2d(&maps.a2, a2, BK, M, BK, BM);
    if (!err) err = map2d(&maps.b2, b2, N, r2, N, 64);
  }
  if (!err && rk && layout == NT) {
    err = map2d(&maps.b2, b2, r2, N, ldb2, bn);
    if (!err) err = map2d(&maps.v, vfold, K, rfold, K, 16 * rk);
  }
  if (!err && (epi == EPI_F32 || epi == EPI_PRE_GELU))
    err = map2d(&maps.c32, c32, N, M, N, BM, 4);
  if (!err && epi != EPI_F32) err = map2d(&maps.c16, c16, N, M, N, BM);
  if (!err && epi == EPI_DGELU) err = map2d(&maps.aux, aux, N, M, N, BM, 4);
  if (err) return err;

  if (layout == NN && epi == EPI_BF16)
    return launch_nn<EPI_BF16>(maps, p, rk, bn, stream);
  if (layout == NN && epi == EPI_PRE_GELU)
    return launch_nn<EPI_PRE_GELU>(maps, p, rk, bn, stream);
  if (layout == NT && epi == EPI_BF16)
    return launch_nt<EPI_BF16>(maps, p, rk, bn, stream);
  if (layout == NT && epi == EPI_F32)
    return launch_nt<EPI_F32>(maps, p, rk, bn, stream);
  if (layout == NT && epi == EPI_DGELU)
    return launch_nt<EPI_DGELU>(maps, p, rk, bn, stream);
  if (layout == TN && epi == EPI_F32)
    return launch_bn<TN, EPI_F32, 0, 0>(maps, p, splits, bn, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
