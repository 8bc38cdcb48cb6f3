// Attention + projection + CaRA delta in one kernel, for Hopper (sm_90a):
// wgmma and TMA.
//
//   y = o @ W + b + s * ((o @ U) @ V + cb),   o = attention(qkv)
//
// qkv (B, N, 3E) bf16 out-flat (3, H, Dh) as the qkv site writes it,
// W (E, E), b (E,), U (E, r) given r8 columns wide (zero past r), V
// (r, E), cb (E,), y (B, N, E) bf16; fp32 accumulation.  Head widths 16,
// 32, 64 and 80 (sm90_common.cuh, HeadTile), E = H * Dh up to 1280, N up
// to 512 with keys >= n_real masked, any rank.
//
// Replaces cara_tpu/ops/pallas/fused_qkv_attention.py row 3
// (fused_qkv_attention_proj: _fwd_proj, _fwd_proj_kernel), whose point is
// that the attention output never goes to device memory: on the TPU the
// (bb, NP, E) output stays in VMEM for the projection GEMM.  Here it
// stays in shared memory.  One block takes one image and one 64-query
// tile; two consumer warpgroups share the block's 64 rows, each with a
// producer warp of its own that feeds its ring of shared-memory slots by
// TMA (completion on mbarriers).
//
// Shared memory (one block an SM; the plan in make_plan):
//   - the o tile: 64 rows x E (rounded up to 64 columns) bf16 as 64-column
//     atoms of 128-byte rows with the 128-byte swizzle, the K-major layout
//     wgmma reads as its A operand; no padding (163,840 bytes at E 1280,
//     98,304 at E 768).  TMA first loads the block's q rows into it (q
//     columns, zero past N and past E), so that head h's q sits at the
//     columns its o will take;
//   - two rings, one a warpgroup, in what is left (32 KB each at E 1280,
//     64 KB at E 768): 64-key K or V tiles of one head during the
//     attention, then 8 KB slots of W (32 k-rows x 128
//     columns), U (64 k-rows) and V tiles for the projection.  A producer
//     starts the projection's loads once its warpgroup has released every
//     attention slot.
//
// 1. Attention (attn_tile.cuh, shared with block_pair.cu): warpgroup w
//    takes heads w, w + 2, ...  (The q tile is
//    first rounded to bf16(q * scale) in place where the scale is not a
//    power of two.)  Per head, a max pass streams the K tiles (S = Q K^T
//    by wgmma, Q read from the o tile's columns of the head, keys >=
//    n_real masked) for each row's final max; then a second pass streams
//    K and V again: S, p = exp((s - max) * scale) in fp32 by the
//    full-precision expf, l += p, bf16(p) as wgmma's register A operand
//    of O += P V.  P is rounded against the final max, as
//    _attn_heads and row 1 (qkv_attention.cu) round it, so o agrees with
//    the row-1 recompute that the backward (row 4) reads.  bf16(O / l) is
//    written over the head's q columns, each column pair at its swizzled
//    address (Dh 80's heads straddle the atoms).
// 2. z = bf16(o U) (64 x 16 or 64: the rank depth is a template
//    parameter), each warpgroup over the whole o tile, kept in registers
//    as a wgmma A operand.  Past rank 64 (RK_LOOP) z would not fit beside
//    the accumulators, and at E 1280 the 64 x E o tile leaves no shared
//    memory for it, so each pass of step 3 forms z in chunks of 64 rank
//    columns after its o W: z_c = bf16(o U_c) from U's tiles through the
//    ring, then z_c V_c by register-A wgmma, then the next chunk.  The
//    registers and slots stay at rank 64's; each pass recomputes its z
//    chunks (64 x 64 x E a chunk, half a pass's o W), the price of that.
// 3. The projection, in passes of 256 columns, warpgroup w taking
//    columns 128 w .. + 127 of each: acc = o W over E in 32-deep tiles,
//    one group of wgmma in flight while the next tile lands (the last
//    tile issued after the loop, so that no group is pending at its
//    exit: C7515); then acc / s + z V by register-A wgmma (b and cb load
//    meanwhile), and y = s (acc / s + z V + cb) + b in fp32 (the delta
//    scale applied in fp32 as in the forward sites, cp_site.cu), stored
//    as bf16 pairs.
//
// What bounds it: at ViT-H/14 (B 64, N 257, E 1280) the function does 21.6
// GFLOP of attention and 53.9 of projection against ~172 MB (bound ~0.077
// ms, by operations); at ViT-B (N 197, E 768) ~23 GFLOP against 79 MB
// (~0.024 ms, bytes).  What holds this design back (SM clocks by phase,
// PERF.md): the attention takes ~60 % of a block, its max pass a third of
// that (every key tile is scored twice) and the exponentials with their
// waits the rest; each 64-row block re-reads all of W (3.3 MB at E 1280)
// from L2, and its image's K and V; the last query tile of an image may
// hold one real row (N 257) but costs a full block.  Halving the W bytes a
// tile moved nothing, so the projection is not fed too slowly from L2.
// Tried and dropped: 64-deep W tiles (fewer slots at E 1280, slower);
// the next key tile's scores issued before this tile's max or
// exponentials, with q's atoms waited and scaled head by head (slower by
// a fifth at ViT-H); the next head's max pass beside this head's
// exponentials (ptxas serialized it, C7515); the epilogue's bias loads
// inside the main loop (C7511).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "sm90_common.cuh"

namespace {

using namespace sm90;
using namespace attn_tile;

constexpr int kMaxSmem = 232448;  // H100: 227 KB per block (opt-in)
constexpr int kGroups = 2;        // consumer warpgroups
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 32 * kGroups;  // + a producer warp each
constexpr int kWk = 32;           // k-rows of a W or V tile
constexpr int kUk = 64;           // k-rows of a U tile
constexpr int kBN = 128;          // columns of a warpgroup's pass
constexpr int kWBox = kWk * 128;  // one 64-column TMA box of a W tile
constexpr int kWTile = 2 * kWBox;   // a projection slot: 8 KB
constexpr int kMaxSlots = 8;
constexpr int kMaxE = 1280;
constexpr int RK_LOOP = -1;  // past rank 64: z in chunks of 64, each pass
constexpr int kRankTile = 64;

// The byte plan of one block's shared memory from a 1024-aligned base:
// the o tile, the two rings, the barriers.
struct Plan {
  int atoms;   // 64-column atoms of the o tile
  int ring;    // bytes of one warpgroup's ring
  int na, np;  // its attention and projection slots
  int bars, total;
};

__host__ __device__ inline Plan make_plan(int e, int dh) {
  Plan p;
  p.atoms = (e + 63) / 64;
  const int ot = p.atoms * kAtom;
  // 1024 bytes of alignment slack and 1024 for the barriers.
  const int room = kMaxSmem - 2048 - ot;
  p.ring = room > 0 ? room / kGroups / 1024 * 1024 : 0;
  const int na = p.ring / (kKeys * dh * 2);
  const int np = p.ring / kWTile;
  p.na = na < kMaxSlots ? na : kMaxSlots;
  p.np = np < kMaxSlots ? np : kMaxSlots;
  p.bars = ot + kGroups * p.ring;
  p.total = p.bars + 2048;
  return p;
}

// The barriers: the q tile's, then per warpgroup its attention slots'
// full / empty and its projection slots' full / empty.
struct Bars {
  uint64_t *afull, *aempty, *pfull, *pempty;
};

__device__ __forceinline__ Bars group_bars(uint64_t* base, int g) {
  uint64_t* b = base + 1 + g * 4 * kMaxSlots;
  return {b, b + kMaxSlots, b + 2 * kMaxSlots, b + 3 * kMaxSlots};
}

template <int DH>
struct Maps {
  static constexpr int P = HeadTile<DH>::PARTS;
  CUtensorMap q;      // (E, N, B) over qkv's q columns: 64 x 64 boxes
  CUtensorMap kv[P];  // (3E, N, B): 64-row head boxes, one a part
  CUtensorMap w;      // (E, E): 64-column x 32-row boxes
  CUtensorMap u;      // (r8, E): ZN-column x 32-row boxes
  CUtensorMap v;      // (E, r): 64-column x 32-row boxes
};

struct Args {
  const __nv_bfloat16* b;
  const __nv_bfloat16* cb;
  __nv_bfloat16* out;
  int N, heads, n_real, e, prescale;
  int rc;  // RK_LOOP: rank chunks of 64
  float scale, s;
};

template <int DH, int RK>
__global__ void __launch_bounds__(kThreads, 1)
attn_proj_kernel(const __grid_constant__ Maps<DH> maps, const Args a) {
  constexpr bool LOOP = RK == RK_LOOP;
  // k-steps of a z (chunk); 1 at r = 0, where no z is formed.
  constexpr int RKT = LOOP ? 4 : RK > 0 ? RK : 1;
  constexpr int ZN = 16 * RKT;                // z columns
  constexpr int VT = (16 * RKT + kWk - 1) / kWk;  // V tiles of a rank step
  constexpr int SK = kKeys * DH * 2;          // bytes of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Plan pl = make_plan(a.e, DH);
  unsigned char* ot = smem;
  uint64_t* bar_base = reinterpret_cast<uint64_t*>(smem + pl.bars);
  uint64_t* qfull = bar_base;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kRows;
  const int img = blockIdx.y;
  const int nkt = (a.n_real + kKeys - 1) / kKeys;  // key tiles
  const int KT = (a.e + kWk - 1) / kWk;            // projection k-tiles
  const int KU = (a.e + kUk - 1) / kUk;            // z's k-tiles

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int g = 0; g < kGroups; ++g) {
      const Bars bb = group_bars(bar_base, g);
      for (int s = 0; s < kMaxSlots; ++s) {
        mbar_init(&bb.afull[s], 1);
        mbar_init(&bb.aempty[s], 128);
        mbar_init(&bb.pfull[s], 1);
        mbar_init(&bb.pempty[s], 128);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warps, one a warpgroup
    const int g = (tid - kConsumers) >> 5;
    if ((tid & 31) != 0) return;
    unsigned char* ring = smem + pl.atoms * kAtom + g * pl.ring;
    const Bars bb = group_bars(bar_base, g);
    if (g == 0) {  // the block's q rows into the o tile
      mbar_expect_tx(qfull, pl.atoms * kAtom);
      for (int at = 0; at < pl.atoms; ++at)
        tma_load_3d(ot + at * kAtom, &maps.q, qfull, 64 * at, q0, img);
    }
    // The attention: per head the K tiles (the max pass), then K and V
    // tile by tile.
    int ia = 0;
    auto load_kv = [&](int which, int h, int j) {
      const int s = ia % pl.na;
      if (ia >= pl.na) mbar_wait(&bb.aempty[s], (ia / pl.na - 1) & 1);
      mbar_expect_tx(&bb.afull[s], SK);
      tma_load_head_3d<DH, kKeys>(
          reinterpret_cast<__nv_bfloat16*>(ring + s * SK), 0, maps.kv,
          &bb.afull[s], which * a.e + h * DH, j * kKeys, img);
      ++ia;
    };
    for (int h = g; h < a.heads; h += kGroups) {
      for (int j = 0; j < nkt; ++j) load_kv(1, h, j);
      for (int j = 0; j < nkt; ++j) {
        load_kv(1, h, j);
        load_kv(2, h, j);
      }
    }
    // Every attention slot released before the projection's tiles land
    // in the same bytes.
    for (int i = ia > pl.na ? ia - pl.na : 0; i < ia; ++i)
      mbar_wait(&bb.aempty[i % pl.na], (i / pl.na) & 1);
    int ip = 0;
    auto slot = [&](uint32_t bytes) {
      const int s = ip % pl.np;
      if (ip >= pl.np) mbar_wait(&bb.pempty[s], (ip / pl.np - 1) & 1);
      mbar_expect_tx(&bb.pfull[s], bytes);
      ++ip;
      return s;
    };
    if (RK > 0)
      for (int t = 0; t < KU; ++t) {
        const int s = slot(kUk * ZN * 2);
        tma_load_2d(ring + s * kWTile, &maps.u, &bb.pfull[s], 0, kUk * t);
      }
    auto load_w = [&](const CUtensorMap* m, int c0, int k) {
      const int s = slot(kWTile);
      tma_load_2d(ring + s * kWTile, m, &bb.pfull[s], c0, k);
      tma_load_2d(ring + s * kWTile + kWBox, m, &bb.pfull[s], c0 + 64, k);
    };
    for (int c0 = kBN * g; c0 < a.e; c0 += kBN * kGroups) {
      for (int t = 0; t < KT + (RK > 0 ? VT : 0); ++t) {
        const bool rank = t >= KT;
        load_w(rank ? &maps.v : &maps.w, c0, kWk * (rank ? t - KT : t));
      }
      if constexpr (LOOP)  // each chunk's U tiles, then its V tiles
        for (int c = 0; c < a.rc; ++c) {
          for (int t = 0; t < KU; ++t) {
            const int s = slot(kUk * ZN * 2);
            tma_load_2d(ring + s * kWTile, &maps.u, &bb.pfull[s], ZN * c,
                        kUk * t);
          }
          for (int t = 0; t < VT; ++t)
            load_w(&maps.v, c0, ZN * c + kWk * t);
        }
    }
    return;
  }

  // Consumers: warpgroup w; thread (warp, g, t) holds rows warp * 16 + g
  // and + 8 of the block's 64.
  const int w = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const Bars bb = group_bars(bar_base, w);
  unsigned char* ring = smem + pl.atoms * kAtom + w * pl.ring;

  mbar_wait(qfull, 0);
  if (a.prescale) {
    // q = bf16(q * scale) in place over the whole tile (the swizzle moves
    // whole 16-byte pieces, so every element is scaled wherever it lies;
    // the zeros past N and E stay zero).
    uint4* p = reinterpret_cast<uint4*>(ot);
    for (int i = tid; i < pl.atoms * kAtom / 16; i += kConsumers) {
      uint4 x = p[i];
      __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(&x);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        el[u] = __float2bfloat16(__bfloat162float(el[u]) * a.scale);
      p[i] = x;
    }
    fence_proxy_async();
    named_barrier(1, kConsumers);
  }
  const float sc = a.prescale ? 1.f : a.scale;
  auto aslot = [&](int i) {  // attention entry i, once it has landed
    mbar_wait(&bb.afull[i % pl.na], (i / pl.na) & 1);
    return reinterpret_cast<const __nv_bfloat16*>(ring + (i % pl.na) * SK);
  };
  auto arelease = [&](int i) { mbar_arrive(&bb.aempty[i % pl.na]); };

  // 1. The attention of this warpgroup's heads into the o tile.
  int ia = 0;
  for (int h = w; h < a.heads; h += kGroups) {
    const int c_h = h * DH;
    float o[DH / 2], inv[2];
    head_attention<DH>(o, inv, ot, c_h, nkt, a.n_real, sc, t, ia, aslot,
                       arelease);
    // bf16(o / l) over the head's q columns (no longer read).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + gq + 8 * r;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
        *reinterpret_cast<uint32_t*>(ot + ot_byte(row, c_h + 8 * c + 2 * t)) =
            pack_bf16(o[4 * c + 2 * r] * inv[r],
                      o[4 * c + 2 * r + 1] * inv[r]);
    }
  }
  fence_proxy_async();
  named_barrier(1, kConsumers);  // every head's o is in the tile

  // The projection's slots: entry i in slot i % np.
  int ip = 0;
  auto pwait = [&](int i) {
    mbar_wait(&bb.pfull[i % pl.np], (i / pl.np) & 1);
    return ring + (i % pl.np) * kWTile;
  };
  auto prelease = [&](int i) { mbar_arrive(&bb.pempty[i % pl.np]); };

  // 2. z = bf16(o U), zero past the rank, as register A fragments: from
  // the next KU ring entries (U's tiles; past rank 64 a chunk's).
  uint32_t zf[RKT][4];
  auto form_z = [&]() {
    float z[ZN / 2];
#pragma unroll
    for (int i = 0; i < ZN / 2; ++i) z[i] = 0.f;
    auto issue = [&](int i) {
      const unsigned char* us = pwait(ip + i);
      const uint64_t du = desc<2 * ZN>(us);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kUk / 16; ++kk)
        wgmma_ss<ZN, 0, 1>(z, ot_desc(ot, kUk * i + 16 * kk),
                           du + 2 * ZN * kk, 1);
      wgmma_commit();
    };
    for (int i = 0; i < KU - 1; ++i) {
      issue(i);
      wgmma_wait<1>();
      if (i > 0) prelease(ip + i - 1);
    }
    issue(KU - 1);
    wgmma_wait<0>();
    fence_regs(z);
    if (KU > 1) prelease(ip + KU - 2);
    prelease(ip + KU - 1);
    ip += KU;
#pragma unroll
    for (int kk = 0; kk < RKT; ++kk) acc_to_a(zf[kk], z, kk);
  };
  // acc += z V for the next VT ring entries (V's tiles; the rank step).
  auto rank_v = [&](float (&acc)[kBN / 2]) {
#pragma unroll
    for (int vt = 0; vt < VT; ++vt) {
      const unsigned char* vs = pwait(ip);
      const uint64_t dv = desc_mn(vs, kWBox);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWk / 16; ++kk)
        if (vt * (kWk / 16) + kk < RKT)
          wgmma_rs<kBN, 1>(acc, zf[vt * (kWk / 16) + kk], dv + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      prelease(ip);
      ++ip;
    }
  };
  if constexpr (RK > 0) form_z();

  // 3. y = o W + b + s (z V + cb), this warpgroup's 128 columns of each
  // 256-column pass.
  for (int c0 = kBN * w; c0 < a.e; c0 += kBN * kGroups) {
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    auto issue = [&](int i) {
      const unsigned char* ws = pwait(ip + i);
      const uint64_t dw = desc_mn(ws, kWBox);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWk / 16; ++kk)
        wgmma_ss<kBN, 0, 1>(acc, ot_desc(ot, kWk * i + 16 * kk),
                            dw + 128 * kk, 1);
      wgmma_commit();
    };
    for (int i = 0; i < KT - 1; ++i) {
      issue(i);
      wgmma_wait<1>();
      if (i > 0) prelease(ip + i - 1);
    }
    issue(KT - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    if (KT > 1) prelease(ip + KT - 2);
    prelease(ip + KT - 1);
    ip += KT;
    // The epilogue's biases, loaded while the rank step runs.
    uint32_t bw[kBN / 8], cw[kBN / 8];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      const bool in = col < a.e;
      bw[j] = in ? *reinterpret_cast<const uint32_t*>(a.b + col) : 0u;
      cw[j] = in ? *reinterpret_cast<const uint32_t*>(a.cb + col) : 0u;
    }
    if constexpr (RK != 0) {
      // acc / s + z V, so that the epilogue's s (acc / s + z V + cb) + b
      // applies the delta scale in fp32.
      const float inv = 1.f / a.s;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] *= inv;
      if constexpr (LOOP) {
        for (int c = 0; c < a.rc; ++c) {
          form_z();
          rank_v(acc);
        }
      } else {
        rank_v(acc);
      }
    }
    // Epilogue: thread (warp, g, t) holds rows warp * 16 + g (+ 8) and
    // columns 8 j + 2 t (+ 1) of the 128; rows past N are not written.
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (col >= a.e) continue;
      const float2 b1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&bw[j]));
      const float2 b2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&cw[j]));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + gq + 8 * r;
        if (row >= a.N) continue;
        const float a0 = acc[4 * j + 2 * r], a1 = acc[4 * j + 2 * r + 1];
        float y0, y1;
        if constexpr (RK != 0) {
          y0 = fmaf(a.s, a0 + b2.x, b1.x);
          y1 = fmaf(a.s, a1 + b2.y, b1.y);
        } else {
          y0 = a0 + b1.x + a.s * b2.x;
          y1 = a1 + b1.y + a.s * b2.y;
        }
        *reinterpret_cast<uint32_t*>(
            a.out + ((size_t)img * a.N + row) * a.e + col) = pack_bf16(y0, y1);
      }
    }
  }
}

template <int DH, int RK>
int launch(const __nv_bfloat16* qkv, const __nv_bfloat16* w,
           const __nv_bfloat16* u, const __nv_bfloat16* v, const Args& a,
           int B, int r, int ldu, cudaStream_t stream) {
  const Plan pl = make_plan(a.e, DH);
  if (pl.na < 1 || pl.np < 2) return static_cast<int>(cudaErrorInvalidValue);
  // Opt in once per process to the largest block this kernel can use.
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_proj_kernel<DH, RK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const uint64_t e = a.e, n = a.N;
  Maps<DH> maps;
  const uint64_t row = 3 * e * 2;
  const uint64_t strides[2] = {row, row * n};
  const uint64_t qdims[3] = {e, n, (uint64_t)B};
  const uint32_t qbox[3] = {64, kRows, 1};
  int err = encode_map(&maps.q, qkv, 3, qdims, strides, qbox);
  const uint64_t kvdims[3] = {3 * e, n, (uint64_t)B};
  const uint32_t kvbox[3] = {DH, kKeys, 1};
  if (!err) err = encode_head_maps<DH>(maps.kv, qkv, 3, kvdims, strides,
                                       kvbox);
  const uint32_t box64[2] = {64, kWk};
  const uint64_t wdims[2] = {e, e}, wstride[1] = {e * 2};
  if (!err) err = encode_map(&maps.w, w, 2, wdims, wstride, box64);
  if (RK != 0) {
    const uint64_t udims[2] = {(uint64_t)ldu, e}, ustride[1] = {
        (uint64_t)ldu * 2};
    const uint32_t ubox[2] = {RK == RK_LOOP ? 64u : 16u * RK, kUk};
    if (!err) err = encode_map(&maps.u, u, 2, udims, ustride, ubox);
    const uint64_t vdims[2] = {e, (uint64_t)r};
    if (!err) err = encode_map(&maps.v, v, 2, vdims, wstride, box64);
  }
  if (err) return err;
  dim3 grid((a.N + kRows - 1) / kRows, B);
  attn_proj_kernel<DH, RK><<<grid, kThreads, pl.total, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const __nv_bfloat16* qkv, const __nv_bfloat16* w,
              const __nv_bfloat16* u, const __nv_bfloat16* v, const Args& a,
              int B, int r, int ldu, cudaStream_t stream) {
  if (r == 0) return launch<DH, 0>(qkv, w, u, v, a, B, r, ldu, stream);
  if (r <= 16) return launch<DH, 1>(qkv, w, u, v, a, B, r, ldu, stream);
  if (r <= kRankTile)
    return launch<DH, 4>(qkv, w, u, v, a, B, r, ldu, stream);
  return launch<DH, RK_LOOP>(qkv, w, u, v, a, B, r, ldu, stream);
}

}  // namespace

// y (B, N, E) = attention(qkv) @ w + b + s * ((attention(qkv) @ u) @ v +
// cb), keys >= n_real masked.  dh must be 16, 32, 64 or 80, E = heads * dh
// at most 1280, 1 <= n_real <= N <= 512, 0 <= r <= ldu with ldu a
// multiple of 8 up to 64, or past rank 64 r rounded up to 64 (u is (E,
// ldu), zero past r).  Pointers 16-byte aligned;
// the Python wrapper checks.  Returns cudaGetLastError() (or the error of
// the shared-memory attribute call or of a tensor-map encoding).
extern "C" int cara_attn_proj(const void* qkv, const void* w, const void* b,
                              const void* u, const void* v, const void* cb,
                              void* out, int B, int N, int heads, int dh,
                              int n_real, int r, int ldu, float scale,
                              float s, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int e = heads * dh;
  if (e > kMaxE || e % 16 || N < 1 || N > 512 || n_real < 1 ||
      n_real > N || r < 0 || r > ldu || ldu % 8 || B < 1 ||
      (r <= kRankTile && ldu > kRankTile) ||
      (r > kRankTile &&
       ldu != (r + kRankTile - 1) / kRankTile * kRankTile))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.b = static_cast<const __nv_bfloat16*>(b);
  a.cb = static_cast<const __nv_bfloat16*>(cb);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.N = N;
  a.heads = heads;
  a.n_real = n_real;
  a.e = e;
  int ex;
  a.prescale = frexpf(scale, &ex) != 0.5f;  // not a power of two
  a.scale = scale;
  a.s = s;
  a.rc = ldu / kRankTile;
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(qkv);
  const __nv_bfloat16* ww = static_cast<const __nv_bfloat16*>(w);
  const __nv_bfloat16* uu = static_cast<const __nv_bfloat16*>(u);
  const __nv_bfloat16* vv = static_cast<const __nv_bfloat16*>(v);
  switch (dh) {
    case 16: return launch_dh<16>(in, ww, uu, vv, a, B, r, ldu, stream);
    case 32: return launch_dh<32>(in, ww, uu, vv, a, B, r, ldu, stream);
    case 64: return launch_dh<64>(in, ww, uu, vv, a, B, r, ldu, stream);
    case 80: return launch_dh<80>(in, ww, uu, vv, a, B, r, ldu, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
