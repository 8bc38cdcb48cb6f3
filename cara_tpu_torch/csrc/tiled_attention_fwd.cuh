// Key-tiled (online-softmax) attention for Hopper (sm_90a), forward: the
// kernel that blockwise_attention.cu (TPU row 16, the qkv layout) and
// flash_attention.cu (TPU row 17, separate q, k, v) both launch, and, in
// its statistics mode, the first pass of qkv_attention_bwd.cu (TPU row
// 2's backward).
//
// Every operand is one (B, H, N, Dh) tensor given by a base pointer and
// its (batch, head, row) strides in elements, the head dimension
// contiguous, so the callers pass the views they hold as they lie: the
// (B, N, 3E) qkv GEMM output (row stride 3E, head stride Dh; k and v at
// column offsets E and 2E), transposed (B, H, N, Dh) views of it, or a
// (B, N, E) output buffer (row stride E).  Each is read (or written) by a
// TMA tensor map of its own strides: every stride a multiple of 8
// elements, every base pointer 16-byte aligned.  The per-row log-sum-exp
// that the backward (tiled_attention_bwd.cuh) reads is (B, N, H) fp32,
// contiguous.
//
// What bounds it on the H100: at B = 64, N = 577, H = 12, Dh = 64 the
// call does 4 B N^2 E = 65.5 GFLOP against ~229 MB: 0.066 ms on the
// tensor cores and 0.068 ms on HBM, both about equally; at N = 197 bytes
// (77.5 MB, 0.023 ms).  The previous design (one block per 64-query tile,
// four warps of mma.sync with every B fragment ldmatrix'ed from padded
// shared memory, K and V streamed by a two-slot cp.async ring and read
// again by each of a head's ten query tiles, 46 KB a block) ran at ~128
// TFLOP/s: 0.5102 ms at N = 577 through row 16, 0.5603 through row 17,
// 0.1811 at N = 197, about 2.1x SDPA (H100 80GB HBM3, 700 W).  This
// design:
//   - persistent blocks, two an SM (one past Dh 64), walk over the (image,
//     head, 128-query tile) items, a head's query tiles one after the
//     other, so its K and V come from L2 after the first tile;
//   - a producer warp loads each item's 128 query rows by TMA (boxes of
//     64 rows x Dh with the swizzle of a Dh * 2-byte row, one a part of
//     the head past Dh 64; rows past N arrive as zeros) into one of two
//     slots, and streams K and V in
//     64-key tiles through a three-stage mbarrier ring, the next item's
//     rows and tiles loading while this one is computed;
//   - two consumer warpgroups own 64 query rows each: S = Q K^T is one
//     wgmma.m64n64k16 chain kept in registers (32 fp32 a thread), the
//     online softmax runs on the accumulators in fp32, bf16(P) is wgmma's
//     register A operand of O += P V with V read MN-major, and O is
//     normalized at the end, written over the warpgroup's Q rows and
//     stored by one TMA store into the caller's layout (rows past N are
//     dropped by the store); lse goes from the registers.  A warpgroup
//     whose rows all lie past N only passes the tiles on, and the 8-key
//     groups past n_real take no exp.
// The 64-key tile keeps a thread's registers under the 112 that let two
// blocks (four warpgroups) share an SM; one block an SM with 128-key
// tiles was slower at N = 577.  What holds it back: each warpgroup runs
// S, the softmax and P V in sequence with a wait on the tensor cores after
// each product, and the softmax's full-precision expf (several
// instructions an element, as the plain twins take it, where the SFU's
// 2^x alone is one) is issued by the same warps; the other warpgroups on
// the SM hide only part of that.  Measured on one H100 80GB HBM3 at 700 W
// (tools/compare_parent.py, two rounds in turns with the previous design;
// 20 calls back to back): 0.366 ms at N = 577 through row 16 (previous
// 0.483-0.487), 0.361-0.366 through row 17 (0.479-0.490), 18 % of the
// bound, 1.6x SDPA's forward in the same turns; 0.072-0.094 ms at N = 197
// through row 17 (0.089-0.091).
//
// Math (forward): fp32 scores s = (q . k) * scale from bf16 q and k (q is
// not pre-scaled in bf16); keys >= n_real set to -1e30; per key tile
// m' = max(m, rowmax s), p = exp(s - m'), l = l * exp(m - m') + rowsum p,
// acc = acc * exp(m - m') + bf16(p) . v; out = bf16(acc / l) (l = 0 read
// as 1), lse = m + log(max(l, 1e-30)).  Key tiles wholly past n_real are
// skipped (their p is 0 and their rescale 1, exactly).  exp is the
// full-precision expf, as the plain twins take it.
//
// At Dh 80 (ViT-H/14) every 64-row tile of a head holds a 64-column and a
// 16-column part (sm90_common.cuh, HeadTile): Q K^T takes four k-steps on
// the first and one on the second, P V one wgmma a part (n64 and n16),
// TMA one box a part; one block an SM (fwd_blocks).
//
// Statistics mode (STATS; row 2's backward, whose only residual is qkv):
// the same loop, one block an SM and 128-key tiles, with do as a second
// query operand and the products S = Q K^T and dP = dO V^T on wgmma; per
// row m = max s, l = sum exp(s - m) and sum exp(s - m) dp, both rescaled
// as m moves, give lse = m + log l and D = sum p dp with p = exp(s - lse),
// in fp32 throughout (attn_bwd_tile takes D from the fp32 p and dp),
// written into the (B, H, 2, NP) rows that tiled_attention_bwd.cuh's main
// kernel reads (NP = N rounded up to 64; rows in [N, NP) get lse = 1e30
// and D = 0, so their p is 0).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

// Internal linkage: each source that includes this header gets its own
// copy of the kernels (no template symbols shared across objects).
namespace tiled_attention {
namespace {

constexpr float kNegInf = -1e30f;
constexpr float kPadLse = 1e30f;
constexpr int kQRows = 64;        // rows of a TMA box and a warpgroup tile
constexpr int kFwdGroups = 2;     // consumer warpgroups: 64 query rows each
constexpr int kFwdRows = kFwdGroups * kQRows;  // query rows of an item
constexpr int kFwdStages = 3;     // K / V ring
constexpr int kFwdThreads = 128 * kFwdGroups + 32;  // + a producer warp

// Blocks an SM: two for the forward up to Dh 64 (96 registers a thread);
// one in statistics mode and past Dh 64, where two would spill 148 bytes
// (Dh 80's 40-float output accumulator) and ran 6-14 % slower than one
// (tools/compare_parent.py; PERF.md).
__host__ __device__ constexpr int fwd_blocks(int dh, bool stats) {
  return stats || dh > 64 ? 1 : 2;
}

// Keys of a streamed tile: 64 in the forward, whose registers then let two
// blocks share an SM; 128 in statistics mode (one block an SM).
__host__ __device__ constexpr int fwd_keys(bool stats) {
  return stats ? 128 : 64;
}

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

__host__ __device__ inline int padded_rows(int N) {
  return (N + kQRows - 1) / kQRows * kQRows;
}

// The (Dh, N, H, B) maps of one operand, one a part of the head
// (sm90::HeadTile), boxes of 64 rows; the stride of a dimension of size 1
// is never used and is given as a dense layout's, which TMA accepts.
template <int DH>
inline int operand_maps(CUtensorMap* maps, const __nv_bfloat16* p, Rows s,
                        int N, int heads, int B) {
  const uint64_t dims[4] = {(uint64_t)DH, (uint64_t)N, (uint64_t)heads,
                            (uint64_t)B};
  const uint64_t row = (uint64_t)DH * 2;
  const uint64_t strides[3] = {
      N > 1 ? (uint64_t)s.sr * 2 : row,
      heads > 1 ? (uint64_t)s.sh * 2 : row * N,
      B > 1 ? (uint64_t)s.sb * 2 : row * N * heads};
  const uint32_t box[4] = {(uint32_t)DH, kQRows, 1, 1};
  return sm90::encode_head_maps<DH>(maps, p, 4, dims, strides, box);
}

// Shared memory of the forward kernel, in bytes from a 1024-aligned base:
// two slots of an item's query rows (and, in statistics mode, its do
// rows), then the K / V ring, then the barriers.
struct FwdSmem {
  int q, kv, bars, total;
};

__host__ __device__ inline FwdSmem fwd_smem(int dh, bool stats) {
  const int rb = dh * 2;
  FwdSmem s;
  s.q = 0;
  s.kv = s.q + 2 * (stats ? 2 : 1) * kFwdRows * rb;
  s.bars = s.kv + kFwdStages * 2 * fwd_keys(stats) * rb;
  s.total = s.bars + 8 * (4 + 2 * kFwdStages) + 1024;  // + alignment slack
  return s;
}

// The scalars of one forward (or statistics) call.
struct FwdArgs {
  float* lse;   // forward: (B, N, H)
  float* rows;  // statistics: (B, H, 2, NP), lse then D
  int B, N, heads, n_real;
  float scale;
};

// TMA maps of q, k, v and x: the output (forward) or do (statistics),
// one a part of the head.
template <int DH>
struct FwdMaps {
  static constexpr int P = sm90::HeadTile<DH>::PARTS;
  CUtensorMap q[P], k[P], v[P], x[P];
};

// Keys >= n_real of the KEYS-key tile whose first key is col0 set to
// -1e30; only the 8-column groups that reach n_real are visited.
template <int KEYS>
__device__ __forceinline__ void mask_tile(float (&s)[KEYS / 2], int col0,
                                          int n_real, int t) {
  if (col0 + KEYS <= n_real) return;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    if (col0 + 8 * j + 8 <= n_real) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col0 + 8 * j + 2 * t + (c & 1) >= n_real) s[4 * j + c] = kNegInf;
  }
}

// The new running max m'[r] (scaled) of rows g and g + 8 from the raw
// scores of a tile, and the rescale exp(m - m') of what came before.
template <int KEYS>
__device__ __forceinline__ void tile_max(const float (&s)[KEYS / 2],
                                         float scale, float (&m)[2],
                                         float (&corr)[2]) {
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[r][u] = kNegInf;
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3],
                                           s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[r], v * scale);
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
}

// S = Q K^T (raw scores) of one tile, issued and committed, not waited.
template <int DH, int KEYS>
__device__ __forceinline__ void issue_scores(float (&s)[KEYS / 2],
                                             const __nv_bfloat16* qw,
                                             const __nv_bfloat16* ks) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    sm90::wgmma_ss<KEYS, 0, 0>(s, sm90::head_kdesc<DH, kQRows>(qw, kk),
                               sm90::head_kdesc<DH, KEYS>(ks, kk), kk > 0);
  sm90::wgmma_commit();
}

// o += P V of one tile (P from the registers pa, V read MN-major), issued
// and committed, not waited.
template <int DH, int KEYS>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const uint32_t (&pa)[KEYS / 16][4],
                                         const __nv_bfloat16* vs) {
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk)
    sm90::wgmma_rs_head<DH, KEYS>(o, pa[kk], vs, kk, 1);
  sm90::wgmma_commit();
}

// p = exp(s scale - m) in place (the full-precision expf, as the plain
// twins take it) and this thread's share of the row sums, for the tile
// whose first key is col0; the 8-column groups wholly at or past n_real
// are set to 0 without an exp (a uniform branch).
template <int KEYS>
__device__ __forceinline__ void exp_tile(float (&s)[KEYS / 2], float scale,
                                         const float (&m)[2], int col0,
                                         int n_real, float (&ls)[2]) {
  float part[2][2] = {};
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    if (col0 + 8 * j >= n_real) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[4 * j + c] = 0.f;
      continue;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1;
      s[4 * j + c] = expf(fmaf(s[4 * j + c], scale, -m[r]));
      part[r][j & 1] += s[4 * j + c];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) ls[r] = part[r][0] + part[r][1];
}

template <int DH, bool STATS>
__global__ void __launch_bounds__(kFwdThreads, fwd_blocks(DH, STATS))
attention_fwd_kernel(const __grid_constant__ FwdMaps<DH> maps,
                     const FwdArgs a) {
  using namespace sm90;
  constexpr int RB = DH * 2;
  constexpr int KEYS = fwd_keys(STATS);
  constexpr int KB = KEYS / kQRows;             // TMA boxes of a K, V tile
  constexpr int CONSUMERS = 128 * kFwdGroups;
  constexpr int QOPS = STATS ? 2 : 1;           // q (and do)
  constexpr int kSlot = QOPS * kFwdRows * DH;   // elements of a query slot
  constexpr int kStage = 2 * KEYS * DH;         // elements of a K, V stage
  constexpr uint32_t kBox = kQRows * RB;        // bytes of a TMA box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const FwdSmem L = fwd_smem(DH, STATS);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* KVs = reinterpret_cast<__nv_bfloat16*>(smem + L.kv);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* qempty = qfull + 2;
  uint64_t* kvfull = qempty + 2;
  uint64_t* kvempty = kvfull + kFwdStages;

  const int N = a.N;
  const int nqt = (N + kFwdRows - 1) / kFwdRows;
  const int items = a.B * a.heads * nqt;
  const int ntiles = (a.n_real + KEYS - 1) / KEYS;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], kFwdGroups);
    }
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&kvfull[s], 1);
      mbar_init(&kvempty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp
    if (tid == CONSUMERS) {
      int kv = 0, local = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++local) {
        const int qt = it % nqt;
        const int h = (it / nqt) % a.heads;
        const int b = it / (nqt * a.heads);
        const int slot = local & 1;
        if (local >= 2) mbar_wait(&qempty[slot], ((local >> 1) - 1) & 1);
        __nv_bfloat16* qd = Qs + slot * kSlot;
        mbar_expect_tx(&qfull[slot], QOPS * kFwdGroups * kBox);
        for (int r = 0; r < kFwdGroups; ++r) {
          const int row = qt * kFwdRows + r * kQRows;
          tma_load_head_4d<DH, kQRows>(qd + r * kQRows * DH, 0, maps.q,
                                       &qfull[slot], 0, row, h, b);
          if (STATS)
            tma_load_head_4d<DH, kQRows>(qd + (kFwdGroups + r) * kQRows * DH,
                                         0, maps.x, &qfull[slot], 0, row, h,
                                         b);
        }
        for (int kt = 0; kt < ntiles; ++kt, ++kv) {
          const int st = kv % kFwdStages;
          if (kv >= kFwdStages)
            mbar_wait(&kvempty[st], (kv / kFwdStages - 1) & 1);
          __nv_bfloat16* kd = KVs + st * kStage;
          mbar_expect_tx(&kvfull[st], 2 * KB * kBox);
          for (int r = 0; r < KB; ++r) {
            const int row = kt * KEYS + r * kQRows;
            tma_load_head_4d<DH, KEYS>(kd, r * kQRows, maps.k, &kvfull[st],
                                       0, row, h, b);
            tma_load_head_4d<DH, KEYS>(kd + KEYS * DH, r * kQRows, maps.v,
                                       &kvfull[st], 0, row, h, b);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup w owns query rows 64 w .. 64 w + 63 of an item;
  // thread (warp, g, t) holds rows warp * 16 + g and + 8 of them.  A
  // warpgroup whose rows all lie past N only passes the key tiles on.
  const int w = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float scale = a.scale;
  int kv = 0, local = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++local) {
    const int qt = it % nqt;
    const int h = (it / nqt) % a.heads;
    const int b = it / (nqt * a.heads);
    const int slot = local & 1;
    const int q0 = qt * kFwdRows + w * kQRows;  // this warpgroup's rows
    __nv_bfloat16* qw = Qs + slot * kSlot + w * kQRows * DH;
    const __nv_bfloat16* dw = qw + kFwdRows * DH;  // do (statistics)
    mbar_wait(&qfull[slot], (local >> 1) & 1);

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[STATS ? 2 : DH / 2];  // o, or sum exp(s - m) dp a row
#pragma unroll
    for (int i = 0; i < (STATS ? 2 : DH / 2); ++i) acc[i] = 0.f;

    for (int kt = 0; kt < ntiles; ++kt, ++kv) {
      const int st = kv % kFwdStages;
      mbar_wait(&kvfull[st], (kv / kFwdStages) & 1);
      if (q0 >= N) {
        mbar_arrive(&kvempty[st]);
        continue;
      }
      const __nv_bfloat16* ks = KVs + st * kStage;
      const __nv_bfloat16* vs = ks + KEYS * DH;
      float s[KEYS / 2], corr[2];
      if constexpr (STATS) {
        float dp[KEYS / 2];
        wgmma_fence();
        issue_scores<DH, KEYS>(s, qw, ks);
        issue_scores<DH, KEYS>(dp, dw, vs);  // dP = dO V^T
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        mbar_arrive(&kvempty[st]);  // K and V are read
        mask_tile<KEYS>(s, kt * KEYS, a.n_real, t);
        tile_max<KEYS>(s, scale, m, corr);
        float ls[2][2] = {}, sd[2][2] = {};
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) {
          const int r = (i >> 1) & 1;
          const float e = expf(fmaf(s[i], scale, -m[r]));
          ls[r][(i >> 2) & 1] += e;
          sd[r][(i >> 2) & 1] = fmaf(e, dp[i], sd[r][(i >> 2) & 1]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * corr[r] + (ls[r][0] + ls[r][1]);
          acc[r] = acc[r] * corr[r] + (sd[r][0] + sd[r][1]);
        }
      } else {
        wgmma_fence();
        issue_scores<DH, KEYS>(s, qw, ks);
        wgmma_wait<0>();
        fence_regs(s);
        mask_tile<KEYS>(s, kt * KEYS, a.n_real, t);
        tile_max<KEYS>(s, scale, m, corr);
        float ls[2];
        exp_tile<KEYS>(s, scale, m, kt * KEYS, a.n_real, ls);
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        uint32_t pa[KEYS / 16][4];
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk) acc_to_a(pa[kk], s, kk);
        wgmma_fence();
        issue_pv<DH, KEYS>(acc, pa, vs);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&kvempty[st]);  // V is read
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if constexpr (STATS) {
      const int np = padded_rows(N);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
      }
      float* base = a.rows + ((size_t)b * a.heads + h) * 2 * np;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        if (t != 0 || row >= np) continue;
        const bool real = row < N;
        base[row] = real ? m[r] + logf(fmaxf(l[r], 1e-30f)) : kPadLse;
        base[np + row] = real ? acc[r] / l[r] : 0.f;
      }
      named_barrier(1 + w, 128);  // every read of the slot is done
      if (wtid == 0) mbar_arrive(&qempty[slot]);
    } else {
      // bf16(acc / l) over this warpgroup's Q rows (no longer read), then
      // one TMA store of the 64 x Dh tile into the caller's layout.
      if (q0 < N) {
        unsigned char* ot = reinterpret_cast<unsigned char*>(qw);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float lt = l[r] == 0.f ? 1.f : l[r];
          const uint32_t row = warp * 16 + g + 8 * r;
#pragma unroll
          for (int j = 0; j < DH / 8; ++j)
            *reinterpret_cast<uint32_t*>(
                ot + head_byte<DH, kQRows>(row, 8 * j + 2 * t)) =
                pack_bf16(acc[4 * j + 2 * r] / lt,
                          acc[4 * j + 2 * r + 1] / lt);
          const int n = q0 + row;
          if (t == 0 && n < N)
            a.lse[((size_t)b * N + n) * a.heads + h] =
                m[r] + logf(fmaxf(l[r], 1e-30f));
        }
        fence_proxy_async();
      }
      named_barrier(1 + w, 128);
      if (wtid == 0) {
        if (q0 < N) tma_store_head_4d<DH>(maps.x, qw, 0, q0, h, b);
        bulk_wait_read();  // the store has read the rows: free the slot
        mbar_arrive(&qempty[slot]);
      }
    }
  }
  if (!STATS && wtid == 0) bulk_wait();
}

// One persistent block per SM (or per item, if fewer) over the items of
// a forward (STATS = false: x is the output) or statistics pass (x is
// do); returns cudaGetLastError() or the error of the attribute call or
// of a tensor-map encoding.
template <int DH, bool STATS>
int launch_fwd_kernel(const __nv_bfloat16* q, Rows sq,
                      const __nv_bfloat16* k, Rows sk,
                      const __nv_bfloat16* v, Rows sv,
                      const __nv_bfloat16* x, Rows sx, const FwdArgs& a,
                      cudaStream_t stream) {
  const int smem = fwd_smem(DH, STATS).total;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_kernel<DH, STATS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  FwdMaps<DH> maps;
  int err = operand_maps<DH>(maps.q, q, sq, a.N, a.heads, a.B);
  if (!err) err = operand_maps<DH>(maps.k, k, sk, a.N, a.heads, a.B);
  if (!err) err = operand_maps<DH>(maps.v, v, sv, a.N, a.heads, a.B);
  if (!err) err = operand_maps<DH>(maps.x, x, sx, a.N, a.heads, a.B);
  if (err) return err;
  const long long items =
      (long long)a.B * a.heads * ((a.N + kFwdRows - 1) / kFwdRows);
  const int slots = sm90::sm_count() * fwd_blocks(DH, STATS);
  const int grid = items < slots ? (int)items : slots;
  attention_fwd_kernel<DH, STATS>
      <<<grid, kFwdThreads, smem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

// The forward: out (any (B, H, N, Dh) strides) and lse (B, N, H) fp32.
template <int DH>
int launch_fwd(const __nv_bfloat16* q, Rows sq, const __nv_bfloat16* k,
               Rows sk, const __nv_bfloat16* v, Rows sv, __nv_bfloat16* out,
               Rows so, float* lse, int B, int N, int heads, int n_real,
               float scale, cudaStream_t stream) {
  const FwdArgs a{lse, nullptr, B, N, heads, n_real, scale};
  return launch_fwd_kernel<DH, false>(q, sq, k, sk, v, sv, out, so, a,
                                      stream);
}

}  // namespace
}  // namespace tiled_attention
