// The rest of one transformer block's eval forward after the qkv site,
// in one kernel, for Hopper (sm_90a): wgmma, TMA and thread block
// clusters.
//
//   o   = attention(qkv)                                  (keys >= n_real
//   xm  = bf16(x + o Wp + bp + s ((o U2) V2 + cb2))        masked)
//   xa2 = bf16(LN2(xm))                                   (fp32 statistics)
//   h   = bf16(act(xa2 W1 + b1 + s ((xa2 U1) V1 + cb1)))
//   y   = bf16(xm + h W2 + b2 + s ((h U2') V2' + cb2'))
//
// qkv (B, N, 3E) bf16 out-flat (3, H, Dh) as the qkv site writes it, x
// (B, N, E) the block's input (the first residual), y (B, N, E); the
// rank-r products z = bf16(. @ U) are rounded before @ V, z2' only once
// the whole hidden row has been summed; everything else accumulates in
// fp32 (the TPU kernel's rounding points).  Head widths 16, 32, 64 and 80
// (HeadTile), E = H Dh up to 1280, hidden a multiple of 128, N up to 512
// with keys >= n_real masked, any rank (the depth of z, 16 or 64, or
// chunks of 64 past rank 64, and the activation, the exact-erf GELU or
// quick_gelu, are template parameters: no wgmma sits behind a branch
// ptxas cannot prove uniform).
//
// Past rank 64 (RK_LOOP) the three z go in chunks of 64 rank columns, so
// that the registers stay at rank 64's: z2 = bf16(o U2) chunk by chunk
// after o Wp (o stays in the A tile), each chunk's V2 step right after
// it; z1 = bf16(xa2 U1) and z2' (h U2', summed over the whole hidden) are
// needed at every step of the MLP and have no room in shared memory (at
// E 1280 a warpgroup's phase-B ring is two 4 KB slots), so each consumer
// thread parks its own fragments of them, 48 words a chunk, in a device
// scratch buffer that only it reads back (L1 / L2; no fence, no other
// reader): z1's A fragments once, z2''s fp32 sums around each step's
// products.  Per step the fc1 rank step takes the chunks one after
// another, and z2' += h U2' runs chunk by chunk over the step's k hidden
// chunks after their fc2.
//
// Replaces cara_tpu/ops/pallas/block_pair.py (block_pair_fwd,
// _pair_kernel), the whole-block eval megakernel, whose point is that the
// mid residual x_mid never goes to device memory: the TPU kernel holds an
// image's whole block in VMEM.  On Hopper the qkv site (cp_site.cu with
// the LN1 prologue) writes qkv first, since one image's qkv (0.9 MB at
// ViT-B, 2 MB at ViT-H) fits no block; this kernel does the rest.  Neither
// x_mid nor h is ever written to device memory.
//
// The plan: a cluster of k = ceil(E / 256) blocks takes one 64-query tile
// of one image (wgmma's 64 rows).  A 64 x E tile does not fit one block:
// at E 1280 the fc2 accumulator alone is 64 x 1280 fp32 = 320 KB, more
// than an SM's register file.  So the cluster splits E:
//   - block c owns columns 256 c .. 256 c + 255 of the projection, x_mid
//     and fc2 (its two consumer warpgroups 128 each: a 64 x 128 fp32
//     accumulator, 64 registers a thread, which carries the projection,
//     then x_mid, then x_mid + h W2);
//   - every block holds the whole 64 x E A tile (128-byte-swizzled
//     64-column atoms, the K-major layout of wgmma's A operand, E rounded
//     up to 128 columns): q, then o, then xa2.  Block c runs the heads h
//     = c (mod k) and stores each head's o into the A tile of every block
//     (distributed shared memory, st.shared::cluster); after LN2 it
//     writes xa2's own columns into its tile and sends those four atoms
//     to every other block by bulk copies;
//   - LN2's row statistics are reduced across the cluster: each
//     warpgroup sends the mean and the sum of squared deviations of its
//     columns to every block, which merges the 2k partials in one fixed
//     order (Chan et al.'s update), so that every block has the same fp32
//     statistics;
//   - the hidden in 64-wide chunks: in step s block c computes chunk
//     s k + c (fc1 + its rank step, b1, s cb1, the activation; each
//     warpgroup 32 of the 64 columns) into its slot c and sends the 8 KB
//     slot to every other block by a bulk copy; every block runs fc2 on
//     the k chunks of the step, into its own columns, and z2' += h U2'
//     over the whole hidden (each warpgroup keeps the 64 x r sum in
//     registers, rounded once at the end).  fc1 of step s + 1 runs while
//     the copies of step s fly, before fc2 of step s.
// The blocks meet in two ways.  Events (q loaded: a peer's o must not
// land under the q TMA; o whole; the LN2 partials; with one set of h
// slots, the set free again) are an mbarrier of every block that each
// consumer warp of every block arrives at remotely (release, cluster
// scope) after its stores; the waits acquire; two barriers alternate, so
// an arrival for event e + 2 cannot land before event e has completed.
// The bulk copies (xa2, h) land on a barrier of the receiving block armed
// with the bytes it expects (async proxy, as TMA).  Element stores to
// another block are slow (four bytes each: h's took 6k SM clocks a step
// at ViT-B, its bulk copy under 1k); o keeps them, as a head's columns
// share atoms with other blocks' heads.  Where a block has room for two
// sets of h slots (E <= 768), a block sends the h of step s only after
// it has every block's h of step s - 1, which each sent after its fc2 of
// step s - 2: no event a step.
//
// Shared memory (one block an SM; make_plan), from a 1024-aligned base:
//   the A tile (atoms x 8 KB) | warpgroup 0's phase-B ring | the h slots
//   (1 or 2 sets of k x 8 KB) | warpgroup 1's phase-B ring | the LN2
//   partials | barriers.
// Each warpgroup has a producer warp and a ring of its own; a slot is
// released once by each of the group's warps.  Phase A (attention,
// projection) uses the ring plus its half of the h slots: 64-key K / V
// tiles of its heads (as row 3, attn_tile.cuh), then 4 KB slots of U2 (z2
// = bf16(o U2)), Wp (16 k-rows x 128 columns) and V2; phase B (the MLP)
// only the ring: U1, then the W1 tiles (64 k-rows x the warpgroup's 32
// chunk columns, 64-byte swizzle) and the V1 tile of step s + 1 before
// the four W2 tiles (16 hidden rows x 128 columns) and the U2' tiles of
// each chunk of step s; last the V2' tiles.  A producer starts a phase
// once its warpgroup has released every slot of the phase before.  Every
// product runs whole tiles of a compile-time depth (ptxas serialized
// every wgmma of the kernel, C7519 / C7520, while a tile's depth was a
// run-time count or a k-step sat behind a run-time test).
// Byte budget (A tile + h slots + partials + barriers; a warpgroup's
// phase-B / phase-A ring):
//   E  768 (k 3):  96 + 48 (2 sets) + 3 + 2 KB; 36 / 60 KB (9 / 15 slots)
//   E 1024 (k 4): 128 + 32 + 4 + 2 KB;          28 / 44 KB (7 / 11 slots)
//   E 1280 (k 5): 160 + 40 + 5 + 2 KB;           8 / 28 KB (2 / 7 slots;
//                 two 10 KB K / V slots at Dh 80)
// Registers of a consumer thread: the 64-register accumulator, z2' (8 or
// 32; past rank 64 one chunk's 32 at a time), z1 as A fragments (4 or 16;
// one chunk's), fc1's 16, h's 8 pairs, besides the addresses; the service
// warpgroup hands its registers to the consumers (setmaxnreg: 232 each;
// no spills).
//
// What bounds it on the H100: the whole block with the qkv site does
// 188.6 GFLOP at ViT-B (B 64, N 197: 0.19 ms at the bf16 peak) and 674
// at ViT-H (0.68 ms), the operations.  Each 64-row tile reads every
// weight of the block once from L2 (10.6 MB at ViT-B, 29.5 MB at ViT-H:
// 2.7 and 9.4 GB a call), and the MLP's weight slots wait on those reads:
// SM clocks by phase (tools/block_pair_phases.py, PERF.md) put fc1 at
// ~40 % of a block at ViT-B, ~700 clocks a 4 KB W1 slot against ~64 of
// tensor work; at E 1280 the phase-B ring holds two slots a warpgroup
// and every slot waits a full L2 latency.  The 64-row tile of N 197 or
// 257 is a quarter empty on its last tile.  The blocks of a cluster read
// disjoint weight columns, so a TMA multicast has nothing to share
// inside it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "gelu.cuh"
#include "sm90_common.cuh"

namespace block_pair {

using namespace sm90;
using namespace attn_tile;

constexpr int kMaxSmem = 232448;  // H100: 227 KB per block (opt-in)
constexpr int kGroups = 2;        // consumer warpgroups
constexpr int kConsumers = 128 * kGroups;
// + a third warpgroup: a producer warp for each consumer warpgroup and two
// idle warps.  It lowers its registers to kServiceRegs while the
// consumers raise theirs to kConsumerRegs (setmaxnreg; 2 x 128 x 232 +
// 128 x 40 = 64512, the block's 384 x 168): at ptxas's 168 for 320
// threads the rank-64 instances spilled 784 bytes.
constexpr int kThreads = kConsumers + 128;
constexpr int kServiceRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kCW = 256;          // columns a block owns
constexpr int kBN = 128;          // columns of a warpgroup
constexpr int kHC = 64;           // hidden columns of a chunk
constexpr int kHSlot = kRows * kHC * 2;  // one chunk of h: 8 KB
constexpr int kSlot = 4096;       // a weight slot
constexpr int kWk = 16;           // k-rows of a Wp, V2, W2 or V2' tile
constexpr int kWBox = kWk * 128;  // one 64-column box of such a tile
constexpr int kW1k = 64;          // k-rows of a W1 tile (32 columns)
constexpr int kMaxSlots = 16;
constexpr int kMaxE = 1280;
constexpr int kMaxCluster = (kMaxE + kCW - 1) / kCW;
constexpr int kBarBytes = 2048;
constexpr int RK_LOOP = -1;  // past rank 64: z in chunks of 64
constexpr int kRankTile = 64;
// Scratch words of a consumer thread a rank chunk (RK_LOOP): z1's A
// fragments (16), then z2''s fp32 sums (32).
constexpr int kZWords = 48;

// The byte plan of one block's shared memory from its 1024-aligned base.
struct Plan {
  int atoms, k;  // 64-column atoms of the A tile; blocks of the cluster
  int nbuf;      // sets of k h slots: 2 where the rings keep 6 slots
  int rb, ra;    // bytes of a warpgroup's phase-B and phase-A ring
  int na, npa, nb;           // K / V slots, phase-A and phase-B slots
  int hs, hb1, stats, bars, total;  // offsets (hb1: warpgroup 1's
                                    // phase-B ring), the bytes to ask for
};

__host__ __device__ inline int cap_slots(int n) {
  return n < kMaxSlots ? n : kMaxSlots;
}

// The A tile spans E rounded up to 128 columns (an even number of atoms),
// so that no k-tile of a product (at most 128 deep, aligned) reads past
// it: the columns past E hold zeros (q's TMA fills them), and every
// product runs whole tiles of a compile-time depth, no wgmma behind a
// run-time test (ptxas serializes every wgmma of the kernel otherwise:
// C7519 / C7520).
__host__ __device__ inline Plan make_plan(int e, int dh) {
  Plan p;
  p.atoms = 2 * ((e + 127) / 128);
  p.k = (e + kCW - 1) / kCW;
  const int a = p.atoms * kAtom;
  const int st = 2 * 2 * p.k * kRows * 4;  // 2k (mean, M2) partials a row
  // 1024 bytes of alignment slack.
  int h = 0, room = 0;
  for (p.nbuf = 2; p.nbuf >= 1; --p.nbuf) {
    h = p.nbuf * p.k * kHSlot;
    room = kMaxSmem - 1024 - a - h - st - kBarBytes;
    if (p.nbuf == 1 || room / 2 / kSlot >= 6) break;
  }
  p.rb = room > 0 ? room / 2 / kSlot * kSlot : 0;
  p.ra = p.rb + h / 2;
  p.na = cap_slots(p.ra / (kKeys * dh * 2));
  p.npa = cap_slots(p.ra / kSlot);
  p.nb = cap_slots(p.rb / kSlot);
  p.hs = a + p.rb;
  p.hb1 = p.hs + h;
  p.stats = a + 2 * p.rb + h;
  p.bars = p.stats + st;
  p.total = p.bars + kBarBytes + 1024;
  return p;
}

// The barriers: the q tile's, the two cluster events', the two h sets'
// and xa2's (bulk copies from the other blocks land on them), then per
// warpgroup its K / V, phase-A and phase-B slots' full / empty.
struct Bars {
  uint64_t *afull, *aempty, *pfull, *pempty, *bfull, *bempty;
};

__device__ __forceinline__ Bars group_bars(uint64_t* base, int g) {
  uint64_t* b = base + 6 + g * 6 * kMaxSlots;
  return {b, b + kMaxSlots, b + 2 * kMaxSlots, b + 3 * kMaxSlots,
          b + 4 * kMaxSlots, b + 5 * kMaxSlots};
}

// A ring of slots: entry i lives in slot i % n, `bytes` apart.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int n, bytes;
};

// Producer: the slot of entry i once free, `tx` bytes expected on it.
__device__ __forceinline__ unsigned char* ring_acquire(const Ring& r, int i,
                                                       uint32_t tx,
                                                       uint64_t** bar) {
  const int s = i % r.n;
  if (i >= r.n) mbar_wait(&r.empty[s], (i / r.n - 1) & 1);
  mbar_expect_tx(&r.full[s], tx);
  *bar = &r.full[s];
  return r.base + s * r.bytes;
}
// Producer: wait until entries 0 .. count - 1 have all been released.
__device__ __forceinline__ void ring_drain(const Ring& r, int count) {
  for (int i = count > r.n ? count - r.n : 0; i < count; ++i)
    mbar_wait(&r.empty[i % r.n], (i / r.n) & 1);
}
// Consumer: entry i once it has landed.
__device__ __forceinline__ unsigned char* ring_wait(const Ring& r, int i) {
  mbar_wait(&r.full[i % r.n], (i / r.n) & 1);
  return r.base + (i % r.n) * r.bytes;
}
// Consumer: entry i released, once by each warp of the warpgroup (a
// slot's empty barrier counts the group's four warps, not its 128
// threads: one arrival a warp after its lanes are done with the slot).
__device__ __forceinline__ void ring_release(const Ring& r, int i) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[i % r.n]);
}

// Clusters and distributed shared memory.
// Every thread of every block of the cluster (barrier.cluster).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The shared::cluster address of `p` (this block's shared memory) in the
// block of rank `rank`.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(smem_u32(p)), "r"(rank));
  return d;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}
__device__ __forceinline__ void arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}
__device__ __forceinline__ void wait_cluster(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  asm volatile(
      "{\n.reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}
// Generic-proxy writes to shared memory anywhere in the cluster made
// visible to the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}
// `bytes` (a multiple of 16) of this block's shared memory from src to
// dst in another block (a shared::cluster address), counted on that
// block's barrier bar (a shared::cluster address): a bulk copy of the
// async proxy.  The issuing thread commits the bulk group.
__device__ __forceinline__ void copy_to_peer(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int DH>
struct Maps {
  static constexpr int P = HeadTile<DH>::PARTS;
  CUtensorMap q;      // (E, N, B) over qkv's q columns: 64 x 64 boxes
  CUtensorMap kv[P];  // (3E, N, B): 64-row head boxes, one a part
  CUtensorMap wp;     // (E, E): 64-column x 16-row boxes
  CUtensorMap v2;     // (E, r): the same
  CUtensorMap u2;     // (ldu, E): ZN-column x KU-row boxes
  CUtensorMap u1;     // (ldu, E): the same
  CUtensorMap w1;     // (hidden, E): 32-column x 64-row boxes
  CUtensorMap v1;     // (hidden, r): 32-column x ZN-row boxes
  CUtensorMap w2;     // (E, hidden): 64-column x 16-row boxes
  CUtensorMap vh;     // (E, r): V2', the same
  CUtensorMap uh;     // (ldu, hidden): U2', ZN-column x KUH-row boxes
};

struct Args {
  const __nv_bfloat16 *x, *bp, *cb2, *ls2, *lb2, *b1, *cb1, *b2, *cbh;
  __nv_bfloat16* out;
  float* scratch;  // RK_LOOP: kZWords x 256 words a block and rank chunk
  int N, heads, n_real, e, hidden, prescale;
  int rc;          // RK_LOOP: rank chunks of 64
  float scale, s, eps;
};

__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// z = bf16(A U) (64 x 16 RK) over the A tile's first nu KU columns, U
// in tiles of KU k-rows from ring entries i0 .. i0 + nu - 1, as register
// A fragments.
template <int RK>
__device__ __forceinline__ void tile_z(uint32_t (&zf)[RK][4],
                                       const unsigned char* ot,
                                       const Ring& r, int i0, int nu) {
  constexpr int ZN = 16 * RK;
  constexpr int KU = kSlot / (2 * ZN);
  float z[ZN / 2];
#pragma unroll
  for (int i = 0; i < ZN / 2; ++i) z[i] = 0.f;
  for (int i = 0; i < nu; ++i) {
    const uint64_t du = desc<2 * ZN>(ring_wait(r, i0 + i));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KU / 16; ++kk)
      wgmma_ss<ZN, 0, 1>(z, ot_desc(ot, KU * i + 16 * kk), du + 2 * ZN * kk,
                         1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(z);
    ring_release(r, i0 + i);
  }
#pragma unroll
  for (int kk = 0; kk < RK; ++kk) acc_to_a(zf[kk], z, kk);
}

// acc (64 x 128) += A V for the register A fragments zf (the rank step)
// and V in RK tiles of 16 k-rows (two 64-column boxes) from ring entries
// i0 .. i0 + RK - 1.
template <int RK>
__device__ __forceinline__ void rank_step(float (&acc)[kBN / 2],
                                          const uint32_t (&zf)[RK][4],
                                          const Ring& r, int i0) {
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const uint64_t dv = desc_mn(ring_wait(r, i0 + i), kWBox);
    wgmma_fence();
    wgmma_rs<kBN, 1>(acc, zf[i], dv, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    ring_release(r, i0 + i);
  }
}

template <int DH, int RK, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
block_pair_kernel(const __grid_constant__ Maps<DH> maps, const Args a) {
  constexpr bool LOOP = RK == RK_LOOP;
  constexpr int RKT = LOOP ? 4 : RK;          // k-steps of a z (chunk)
  constexpr int ZN = 16 * RKT;                // z columns
  constexpr int KU = kSlot / (2 * ZN);      // k-rows of a U tile
  constexpr int KUH = KU < kHC ? KU : kHC;    // ... of a U2' tile
  constexpr int SK = kKeys * DH * 2;          // bytes of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Plan pl = make_plan(a.e, DH);
  unsigned char* ot = smem;
  uint64_t* bar_base = reinterpret_cast<uint64_t*>(smem + pl.bars);
  uint64_t* qfull = bar_base;
  uint64_t* cbar = bar_base + 1;
  uint64_t* hbar = bar_base + 3;  // [2]
  uint64_t* xbar = bar_base + 5;
  const int tid = threadIdx.x;
  const int k = pl.k;
  const int c = blockIdx.x;  // the cluster's rank: clusters are (k, 1, 1)
  const int q0 = blockIdx.y * kRows;
  const int img = blockIdx.z;
  const int nkt = (a.n_real + kKeys - 1) / kKeys;  // key tiles
  const int nch = a.hidden / kHC;                  // hidden chunks
  const int nsteps = (nch + k - 1) / k;
  const int KT = a.e / kWk;                        // Wp k-tiles
  const int KT1 = (a.e + kW1k - 1) / kW1k;         // W1 k-tiles
  const int NU = (a.e + KU - 1) / KU;              // U tiles over E
  const int a_end = pl.atoms * kAtom;

  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(&cbar[0], k * kConsumers / 32);
    mbar_init(&cbar[1], k * kConsumers / 32);
    mbar_init(&hbar[0], 1);
    mbar_init(&hbar[1], 1);
    mbar_init(xbar, 1);
    for (int g = 0; g < kGroups; ++g) {
      const Bars bb = group_bars(bar_base, g);
      for (int s = 0; s < kMaxSlots; ++s) {
        mbar_init(&bb.afull[s], 1);
        mbar_init(&bb.aempty[s], 4);
        mbar_init(&bb.pfull[s], 1);
        mbar_init(&bb.pempty[s], 4);
        mbar_init(&bb.bfull[s], 1);
        mbar_init(&bb.bempty[s], 4);
      }
    }
    mbar_init_fence();
  }
  // Every block's barriers are initialised before any remote arrive.
  cluster_sync();

  // The service warpgroup takes only the branch below, so that its
  // lowered register count covers all it runs.
  if (tid >= kConsumers) {  // the producer warps, one a warpgroup
    setmaxnreg_dec<kServiceRegs>();
    const int g = (tid - kConsumers) >> 5;
    if (g >= kGroups || (tid & 31) != 0) return;
    const Bars bb = group_bars(bar_base, g);
    const Ring ar{smem + a_end + g * pl.ra, bb.afull, bb.aempty, pl.na, SK};
    const Ring pr{ar.base, bb.pfull, bb.pempty, pl.npa, kSlot};
    const Ring br{smem + (g == 0 ? a_end : pl.hb1), bb.bfull, bb.bempty,
                  pl.nb, kSlot};
    const int c0 = kCW * c + kBN * g;
    const bool has = c0 < a.e;
    uint64_t* bar;
    int i = 0;
    // One box of m at (x, y) into the next entry of ring r.
    auto load = [&](const Ring& r, uint32_t tx, const CUtensorMap* m, int x,
                    int y) {
      unsigned char* dst = ring_acquire(r, i++, tx, &bar);
      tma_load_2d(dst, m, bar, x, y);
    };
    // A 16-row tile of this warpgroup's 128 columns: two 64-column boxes.
    auto load_w = [&](const Ring& r, const CUtensorMap* m, int y) {
      unsigned char* dst = ring_acquire(r, i++, kSlot, &bar);
      tma_load_2d(dst, m, bar, c0, y);
      tma_load_2d(dst + kWBox, m, bar, c0 + 64, y);
    };
    if (g == 0) {  // the tile's q rows into the A tile
      mbar_expect_tx(qfull, a_end);
      for (int at = 0; at < pl.atoms; ++at)
        tma_load_3d(ot + at * kAtom, &maps.q, qfull, 64 * at, q0, img);
    }
    // Phase A: per head the K tiles (the max pass), then K and V tile by
    // tile.
    for (int h = c + k * g; h < a.heads; h += 2 * k) {
      for (int pass = 0; pass < 2; ++pass)
        for (int j = 0; j < nkt; ++j)
          for (int which = 1; which <= 1 + pass; ++which) {
            unsigned char* dst = ring_acquire(ar, i++, SK, &bar);
            tma_load_head_3d<DH, kKeys>(
                reinterpret_cast<__nv_bfloat16*>(dst), 0, maps.kv, bar,
                which * a.e + h * DH, j * kKeys, img);
          }
    }
    ring_drain(ar, i);
    // z2's U2 tiles, Wp's, V2's.
    i = 0;
    if (has) {
      if (!LOOP)
        for (int t = 0; t < NU; ++t) load(pr, kSlot, &maps.u2, 0, KU * t);
      for (int t = 0; t < KT; ++t) load_w(pr, &maps.wp, kWk * t);
      if (!LOOP)
        for (int t = 0; t < RK; ++t) load_w(pr, &maps.v2, kWk * t);
      else  // per rank chunk: its U2 tiles, then its V2 tiles
        for (int q = 0; q < a.rc; ++q) {
          for (int t = 0; t < NU; ++t)
            load(pr, kSlot, &maps.u2, ZN * q, KU * t);
          for (int t = 0; t < RKT; ++t)
            load_w(pr, &maps.v2, ZN * q + kWk * t);
        }
    }
    ring_drain(pr, i);
    // Phase B: U1 and the first step's W1 and V1 tiles; then per step s
    // the next step's W1 and V1 tiles (the consumers run fc1 of step s + 1
    // before fc2 of step s), then per chunk of step s W2's and U2''s; V2'.
    i = 0;
    for (int q = 0; q < (LOOP ? a.rc : 1); ++q)
      for (int t = 0; t < NU; ++t)
        load(br, kSlot, &maps.u1, ZN * q, KU * t);
    auto load_fc1 = [&](int s) {
      const int j = s * k + c;
      if (s >= nsteps || j >= nch) return;
      for (int t = 0; t < KT1; ++t)
        load(br, kSlot, &maps.w1, kHC * j + 32 * g, kW1k * t);
      for (int q = 0; q < (LOOP ? a.rc : 1); ++q)
        load(br, 32 * ZN * 2, &maps.v1, kHC * j + 32 * g, ZN * q);
    };
    load_fc1(0);
    for (int s = 0; s < nsteps; ++s) {
      load_fc1(s + 1);
      if (!has) continue;
      for (int cc = 0; cc < k && s * k + cc < nch; ++cc) {
        const int jj = s * k + cc;
        for (int t = 0; t < kHC / kWk; ++t)
          load_w(br, &maps.w2, kHC * jj + kWk * t);
        if (!LOOP)
          for (int t = 0; t < kHC / KUH; ++t)
            load(br, KUH * ZN * 2, &maps.uh, 0, kHC * jj + KUH * t);
      }
      if (LOOP)  // per rank chunk, the U2' tiles of the step's chunks
        for (int q = 0; q < a.rc; ++q)
          for (int cc = 0; cc < k && s * k + cc < nch; ++cc)
            for (int t = 0; t < kHC / KUH; ++t)
              load(br, KUH * ZN * 2, &maps.uh, ZN * q,
                   kHC * (s * k + cc) + KUH * t);
    }
    if (has)
      for (int q = 0; q < (LOOP ? a.rc : 1); ++q)
        for (int t = 0; t < RKT; ++t)
          load_w(br, &maps.vh, ZN * q + kWk * t);
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();

  // Consumers: warpgroup w; thread (warp, g, t) holds rows warp * 16 + g
  // and + 8 of the tile's 64.
  const int w = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const Bars bb = group_bars(bar_base, w);
  const Ring ar{smem + a_end + w * pl.ra, bb.afull, bb.aempty, pl.na, SK};
  const Ring pr{ar.base, bb.pfull, bb.pempty, pl.npa, kSlot};
  const Ring br{smem + (w == 0 ? a_end : pl.hb1), bb.bfull, bb.bempty,
                pl.nb, kSlot};
  const int c0 = kCW * c + kBN * w;
  const bool has = c0 < a.e;
  const float inv_s = 1.f / a.s;
  // RK_LOOP: this thread's scratch words of rank chunk q (kZWords each,
  // 256 threads apart, so that a warp's accesses are coalesced).
  float* zs = nullptr;
  if constexpr (LOOP)
    zs = a.scratch +
         (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
          blockIdx.x) * a.rc * kZWords * kConsumers + tid;
  auto zword = [&](int q, int word) -> float& {
    return zs[((size_t)q * kZWords + word) * kConsumers];
  };
  // Every block's shared memory in the cluster's window.
  uint32_t peer[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) peer[r] = r < k ? map_rank(smem, r) : 0;
  auto peer_of = [&](int p) {  // peer[p], p < k, by a run-time index
    uint32_t v = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r == p) v = peer[r];
    return v;
  };
  auto put = [&](uint32_t off, uint32_t v) {  // to every block
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < k) st_cluster(peer[r] + off, v);
  };
  const uint32_t cbar_off = smem_u32(cbar) - smem_u32(smem);
  // The cluster's events: this warp's writes are done (signal; with
  // `fence` its stores to other blocks are made visible to their async
  // proxy, for wgmma), every warp of every block has signalled event e
  // (wait_event).
  auto signal = [&](int e, bool fence) {
    if (fence) fence_proxy_async_cluster();
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < k) arrive_cluster(peer[r] + cbar_off + 8 * (e & 1));
    }
  };
  auto wait_event = [&](int e) {
    wait_cluster(&cbar[e & 1], (e >> 1) & 1);
    fence_proxy_async();
  };

  mbar_wait(qfull, 0);
  if (a.prescale) {
    // q = bf16(q * scale) in place over the whole tile (the swizzle moves
    // whole 16-byte pieces, so every element is scaled wherever it lies;
    // the zeros past N and E stay zero).
    uint4* p = reinterpret_cast<uint4*>(ot);
    for (int i = tid; i < a_end / 16; i += kConsumers) {
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
  signal(0, false);  // event 0: this block's q is in place
  wait_event(0);

  // 1. The attention of this block's heads into every block's A tile.
  const float sc = a.prescale ? 1.f : a.scale;
  auto aslot = [&](int i) {
    return reinterpret_cast<const __nv_bfloat16*>(ring_wait(ar, i));
  };
  auto arelease = [&](int i) { ring_release(ar, i); };
  int ia = 0;
  for (int h = c + k * w; h < a.heads; h += 2 * k) {
    const int c_h = h * DH;
    float o[DH / 2], inv[2];
    head_attention<DH>(o, inv, ot, c_h, nkt, a.n_real, sc, t, ia, aslot,
                       arelease);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + gq + 8 * r;
#pragma unroll
      for (int cc = 0; cc < DH / 8; ++cc)
        put(ot_byte(row, c_h + 8 * cc + 2 * t),
            pack_bf16(o[4 * cc + 2 * r] * inv[r],
                      o[4 * cc + 2 * r + 1] * inv[r]));
    }
  }
  signal(1, true);  // event 1: every head's o is in every A tile
  wait_event(1);

  // 2. x_mid = bf16(x + o Wp + bp + s (z2 V2 + cb2)) on this warpgroup's
  // 128 columns, z2 = bf16(o U2); acc then holds x_mid in fp32 (0 past E).
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  if (has) {
    int ip = 0;
    uint32_t zf[RKT][4];
    if constexpr (!LOOP) {
      tile_z<RK>(zf, ot, pr, ip, NU);
      ip += NU;
    }
    auto issue = [&](int i) {
      const uint64_t dw = desc_mn(ring_wait(pr, ip + i), kWBox);
      wgmma_fence();
      wgmma_ss<kBN, 0, 1>(acc, ot_desc(ot, kWk * i), dw, 1);
      wgmma_commit();
    };
    for (int i = 0; i < KT - 1; ++i) {
      issue(i);
      wgmma_wait<1>();
      if (i > 0) ring_release(pr, ip + i - 1);
    }
    issue(KT - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    if (KT > 1) ring_release(pr, ip + KT - 2);
    ring_release(pr, ip + KT - 1);
    ip += KT;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] *= inv_s;
    if constexpr (LOOP) {
      // z2 a chunk at a time from o (still in the A tile), then its V2.
      for (int q = 0; q < a.rc; ++q) {
        tile_z<RKT>(zf, ot, pr, ip, NU);
        ip += NU;
        rank_step<RKT>(acc, zf, pr, ip);
        ip += RKT;
      }
    } else {
      rank_step<RK>(acc, zf, pr, ip);
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (col >= a.e) {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[4 * j + u] = 0.f;
        continue;
      }
      const float2 b = bf2(a.bp + col), cb = bf2(a.cb2 + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + warp * 16 + gq + 8 * r;
        const float2 xr = q < a.N
            ? bf2(a.x + ((size_t)img * a.N + q) * a.e + col)
            : make_float2(0.f, 0.f);
        const float2 xm = __bfloat1622float2(__floats2bfloat162_rn(
            xr.x + fmaf(a.s, acc[4 * j + 2 * r] + cb.x, b.x),
            xr.y + fmaf(a.s, acc[4 * j + 2 * r + 1] + cb.y, b.y)));
        acc[4 * j + 2 * r] = xm.x;
        acc[4 * j + 2 * r + 1] = xm.y;
      }
    }
  }

  // 3. LN2 of x_mid: fp32 row statistics over the cluster.  Each
  // warpgroup sends the mean and the sum of squared deviations of its
  // columns to every block, which merges the 2k partials in one order
  // (Chan et al.'s pairwise update), so that every block has the same
  // statistics; then xa2's own columns into every block's A tile (o is no
  // longer read: every block passed its projection before event 2).
  float* stat = reinterpret_cast<float*>(smem + pl.stats);
  const uint32_t stat_off = pl.stats;
  // Valid columns of partial i (warpgroup i % 2 of block i / 2).
  auto cols_of = [&](int i) {
    const int n = a.e - kCW * (i >> 1) - kBN * (i & 1);
    return n < 0 ? 0 : n > kBN ? kBN : n;
  };
  float mu[2], rs[2];
  {
    const int nw = cols_of(2 * c + w);
    float sum[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (c0 + 8 * j + 2 * t >= a.e) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) sum[u >> 1] += acc[4 * j + u];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      sum[r] = nw ? sum[r] / nw : 0.f;  // this warpgroup's mean
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (c0 + 8 * j + 2 * t >= a.e) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float d = acc[4 * j + u] - sum[u >> 1];
        m2[u >> 1] += d * d;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m2[r] += __shfl_xor_sync(0xffffffffu, m2[r], 1);
      m2[r] += __shfl_xor_sync(0xffffffffu, m2[r], 2);
      if (t == 0) {
        const int row = warp * 16 + gq + 8 * r;
        const uint32_t off =
            stat_off + 8 * ((2 * c + w) * kRows + row);
#pragma unroll
        for (int p = 0; p < kMaxCluster; ++p)
          if (p < k) {
            st_cluster_f32(peer[p] + off, sum[r]);
            st_cluster_f32(peer[p] + off + 4, m2[r]);
          }
      }
    }
    signal(2, false);  // event 2: the partials
    wait_event(2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + gq + 8 * r;
      float n = 0.f, mean = 0.f, ssd = 0.f;
      for (int i = 0; i < 2 * k; ++i) {
        const float ni = cols_of(i);
        if (ni == 0.f) continue;
        const float mi = stat[2 * (i * kRows + row)];
        const float d = mi - mean;
        const float nn = n + ni;
        mean += d * (ni / nn);
        ssd += stat[2 * (i * kRows + row) + 1] + d * d * (n * ni / nn);
        n = nn;
      }
      mu[r] = mean;
      rs[r] = rsqrtf(ssd / a.e + a.eps);
    }
  }
  if (has) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (col >= a.e) continue;
      const float2 ls = bf2(a.ls2 + col), lb = bf2(a.lb2 + col);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(ot + ot_byte(warp * 16 + gq + 8 * r,
                                                  col)) =
            pack_bf16(
                fmaf((acc[4 * j + 2 * r] - mu[r]) * rs[r], ls.x, lb.x),
                fmaf((acc[4 * j + 2 * r + 1] - mu[r]) * rs[r], ls.y, lb.y));
    }
  }
  // xa2's own atoms (4 c .. 4 c + 3, zeros past E) to every other block
  // by bulk copies, which land on its xa2 barrier.
  const uint32_t xbar_off = smem_u32(xbar) - smem_u32(smem);
  auto own_atoms = [&](int p) {
    const int n = pl.atoms - 4 * p;
    return n < 4 ? n : 4;
  };
  fence_proxy_async();
  named_barrier(1, kConsumers);
  if (tid == 0) {
    uint32_t expect = 0;
    for (int p = 0; p < k; ++p) {
      if (p == c) continue;
      copy_to_peer(peer_of(p) + 4 * c * kAtom, ot + 4 * c * kAtom,
                   own_atoms(c) * kAtom, peer_of(p) + xbar_off);
      expect += own_atoms(p) * kAtom;
    }
    bulk_commit();
    mbar_expect_tx(xbar, expect);
  }
  mbar_wait(xbar, 0);

  // 4. The MLP.  z1 = bf16(xa2 U1); per step this block's chunk of h
  // (fc1, its rank step, b1, s cb1, the activation) into slot c of every
  // block, then fc2 and z2' on the step's k chunks.  fc1 of step s + 1
  // runs while the other blocks write the h of step s, before fc2 of
  // step s: its W1 tiles come through the ring ahead of W2's.
  int ib = 0;
  uint32_t zf1[RKT][4];
  float zh[ZN / 2];
#pragma unroll
  for (int i = 0; i < ZN / 2; ++i) zh[i] = 0.f;
  if constexpr (LOOP) {
    // z1's chunks into this thread's scratch, z2''s sums there zeroed.
    for (int q = 0; q < a.rc; ++q) {
      tile_z<RKT>(zf1, ot, br, ib, NU);
      ib += NU;
#pragma unroll
      for (int kk = 0; kk < RKT; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          zword(q, 4 * kk + u) = __uint_as_float(zf1[kk][u]);
#pragma unroll
      for (int i = 0; i < ZN / 2; ++i) zword(q, 16 + i) = 0.f;
    }
  } else {
    tile_z<RK>(zf1, ot, br, ib, NU);
    ib += NU;
  }
  const unsigned char* hs = smem + pl.hs;
  uint32_t hv[8];  // this thread's h pairs of the chunk
  auto fc1 = [&](int s) {
    const int j = s * k + c;
    if (s >= nsteps || j >= nch) return;
    float a1[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) a1[i] = 0.f;
    auto issue = [&](int i) {
      const unsigned char* ws = ring_wait(br, ib + i);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kW1k / 16; ++kk)
        wgmma_ss<32, 0, 1>(a1, ot_desc(ot, kW1k * i + 16 * kk),
                           desc<64>(ws + 1024 * kk), 1);
      wgmma_commit();
    };
    for (int i = 0; i < KT1 - 1; ++i) {
      issue(i);
      wgmma_wait<1>();
      if (i > 0) ring_release(br, ib + i - 1);
    }
    issue(KT1 - 1);
    wgmma_wait<0>();
    fence_regs(a1);
    if (KT1 > 1) ring_release(br, ib + KT1 - 2);
    ring_release(br, ib + KT1 - 1);
    ib += KT1;
#pragma unroll
    for (int i = 0; i < 16; ++i) a1[i] *= inv_s;
    for (int q = 0; q < (LOOP ? a.rc : 1); ++q) {
      if constexpr (LOOP)  // chunk q of z1 back from the scratch
#pragma unroll
        for (int kk = 0; kk < RKT; ++kk)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            zf1[kk][u] = __float_as_uint(zword(q, 4 * kk + u));
      const unsigned char* vs = ring_wait(br, ib);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < RKT; ++kk)
        wgmma_rs<32, 1>(a1, zf1[kk], desc<64>(vs + 1024 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(a1);
      ring_release(br, ib);
      ++ib;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = kHC * j + 32 * w + 8 * jj + 2 * t;
      const float2 b = bf2(a.b1 + col), cb = bf2(a.cb1 + col);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        hv[2 * jj + r] = pack_bf16(
            act_fwd<ACT>(fmaf(a.s, a1[4 * jj + 2 * r] + cb.x, b.x)),
            act_fwd<ACT>(fmaf(a.s, a1[4 * jj + 2 * r + 1] + cb.y, b.y)));
    }
  };
  // Per step s: this block's chunk into its slot c of set s % nbuf, then
  // bulk copies of the slot to every other block, which land on its
  // barrier of the set.  With two sets, a block copies the h of step s
  // only after it has seen every block's h of step s - 1, which each sent
  // after its fc2 of step s - 2 (the set's last reader); with one set,
  // event 3 + s says that a block is done with the set (fc2 of step s).
  const int nbuf = pl.nbuf;
  const uint32_t hbar_off = smem_u32(hbar) - smem_u32(smem);
  fc1(0);
  for (int s = 0; s < nsteps; ++s) {
    const int set = s % nbuf;
    const uint32_t slot = pl.hs + (set * k + c) * kHSlot;
    if (nbuf == 1 && s > 0) wait_event(2 + s);  // the set is free
    if (tid == 0) bulk_wait_read();  // the slot's last copies have left
    named_barrier(1, kConsumers);
    if (s * k + c < nch) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(
              smem + slot + swizzle<128>((warp * 16 + gq + 8 * r) * 128 +
                                         (32 * w + 8 * jj + 2 * t) * 2)) =
              hv[2 * jj + r];
    }
    fence_proxy_async();
    named_barrier(1, kConsumers);
    if (tid == 0) {
      uint32_t expect = 0;
      for (int p = 0; p < k; ++p) {
        if (p == c) continue;
        if (s * k + c < nch)
          copy_to_peer(peer_of(p) + slot, smem + slot, kHSlot,
                       peer_of(p) + hbar_off + 8 * set);
        if (s * k + p < nch) expect += kHSlot;
      }
      bulk_commit();
      mbar_expect_tx(&hbar[set], expect);
    }
    fc1(s + 1);
    mbar_wait(&hbar[set], (s / nbuf) & 1);
    if (has) {
      for (int cc = 0; cc < k && s * k + cc < nch; ++cc) {
        const uint64_t dh = desc<128>(hs + (set * k + cc) * kHSlot);
#pragma unroll
        for (int i = 0; i < kHC / kWk; ++i) {
          const uint64_t dw = desc_mn(ring_wait(br, ib + i), kWBox);
          wgmma_fence();
          wgmma_ss<kBN, 0, 1>(acc, dh + 2 * i, dw, 1);
          wgmma_commit();
          if (i > 0) {
            wgmma_wait<1>();
            ring_release(br, ib + i - 1);
          }
        }
        ib += kHC / kWk;
        if constexpr (!LOOP) {
#pragma unroll
          for (int i = 0; i < kHC / KUH; ++i) {
            const uint64_t du = desc<2 * ZN>(ring_wait(br, ib + i));
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KUH / 16; ++kk)
              wgmma_ss<ZN, 0, 1>(zh, dh + 2 * (KUH / 16 * i + kk),
                                 du + 2 * ZN * kk, 1);
            wgmma_commit();
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(zh);
        ring_release(br, ib - 1);
        if constexpr (!LOOP) {
#pragma unroll
          for (int i = 0; i < kHC / KUH; ++i) ring_release(br, ib + i);
          ib += kHC / KUH;
        }
      }
      if constexpr (LOOP) {
        // z2' += h U2' a rank chunk at a time over the step's chunks, its
        // sums from and back to this thread's scratch.
        for (int q = 0; q < a.rc; ++q) {
#pragma unroll
          for (int i = 0; i < ZN / 2; ++i) zh[i] = zword(q, 16 + i);
          for (int cc = 0; cc < k && s * k + cc < nch; ++cc) {
            const uint64_t dh = desc<128>(hs + (set * k + cc) * kHSlot);
#pragma unroll
            for (int i = 0; i < kHC / KUH; ++i) {
              const uint64_t du = desc<2 * ZN>(ring_wait(br, ib + i));
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < KUH / 16; ++kk)
                wgmma_ss<ZN, 0, 1>(zh, dh + 2 * (KUH / 16 * i + kk),
                                   du + 2 * ZN * kk, 1);
              wgmma_commit();
            }
            wgmma_wait<0>();
            fence_regs(zh);
#pragma unroll
            for (int i = 0; i < kHC / KUH; ++i) ring_release(br, ib + i);
            ib += kHC / KUH;
          }
#pragma unroll
          for (int i = 0; i < ZN / 2; ++i) zword(q, 16 + i) = zh[i];
        }
      }
    }
    if (nbuf == 1 && s + 1 < nsteps) signal(3 + s, false);  // set done
  }

  // 5. y = bf16(x_mid + h W2 + b2 + s (z2' V2' + cb2')), z2' = bf16(h U2').
  if (!has) return;
  uint32_t zf2[RKT][4];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] *= inv_s;
  for (int q = 0; q < (LOOP ? a.rc : 1); ++q) {
    if constexpr (LOOP)
#pragma unroll
      for (int i = 0; i < ZN / 2; ++i) zh[i] = zword(q, 16 + i);
#pragma unroll
    for (int kk = 0; kk < RKT; ++kk) acc_to_a(zf2[kk], zh, kk);
    rank_step<RKT>(acc, zf2, br, ib);
    ib += RKT;
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    if (col >= a.e) continue;
    const float2 b = bf2(a.b2 + col), cb = bf2(a.cbh + col);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + warp * 16 + gq + 8 * r;
      if (q >= a.N) continue;
      *reinterpret_cast<uint32_t*>(a.out + ((size_t)img * a.N + q) * a.e +
                                   col) =
          pack_bf16(fmaf(a.s, acc[4 * j + 2 * r] + cb.x, b.x),
                    fmaf(a.s, acc[4 * j + 2 * r + 1] + cb.y, b.y));
    }
  }
}

// The device pointers of one call.
struct Ptrs {
  const __nv_bfloat16 *qkv, *wp, *u2, *v2, *w1, *mu1, *mv1, *w2, *mu2, *mv2;
};

template <int DH, int RK, int ACT>
int launch(const Ptrs& g, const Args& a, int B, int r, int ldu,
           cudaStream_t stream) {
  constexpr int ZN = RK == RK_LOOP ? 64 : 16 * RK;
  constexpr int KU = kSlot / (2 * ZN);
  constexpr int KUH = KU < kHC ? KU : kHC;
  const Plan pl = make_plan(a.e, DH);
  if (pl.na < 1 || pl.npa < 2 || pl.nb < 2 || pl.k > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  // Opt in once per process to the largest block this kernel can use.
  static const cudaError_t attr = cudaFuncSetAttribute(
      block_pair_kernel<DH, RK, ACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const uint64_t e = a.e, n = a.N, hid = a.hidden, rr = r, lu = ldu;
  Maps<DH> maps;
  const uint64_t row = 3 * e * 2;
  const uint64_t strides[2] = {row, row * n};
  const uint64_t qdims[3] = {e, n, (uint64_t)B};
  const uint32_t qbox[3] = {64, kRows, 1};
  int err = encode_map(&maps.q, g.qkv, 3, qdims, strides, qbox);
  const uint64_t kvdims[3] = {3 * e, n, (uint64_t)B};
  const uint32_t kvbox[3] = {DH, kKeys, 1};
  if (!err)
    err = encode_head_maps<DH>(maps.kv, g.qkv, 3, kvdims, strides, kvbox);
  auto map2 = [&](CUtensorMap* m, const void* base, uint64_t cols,
                  uint64_t rows, uint32_t bc, uint32_t br) {
    if (err) return;
    const uint64_t dims[2] = {cols, rows}, stride[1] = {cols * 2};
    const uint32_t box[2] = {bc, br};
    err = encode_map(m, base, 2, dims, stride, box);
  };
  map2(&maps.wp, g.wp, e, e, 64, kWk);
  map2(&maps.v2, g.v2, e, rr, 64, kWk);
  map2(&maps.u2, g.u2, lu, e, ZN, KU);
  map2(&maps.u1, g.mu1, lu, e, ZN, KU);
  map2(&maps.w1, g.w1, hid, e, 32, kW1k);
  map2(&maps.v1, g.mv1, hid, rr, 32, ZN);
  map2(&maps.w2, g.w2, e, hid, 64, kWk);
  map2(&maps.vh, g.mv2, e, rr, 64, kWk);
  map2(&maps.uh, g.mu2, lu, hid, ZN, KUH);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.k, (a.N + kRows - 1) / kRows, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = pl.total;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = pl.k;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t launched =
      cudaLaunchKernelEx(&cfg, block_pair_kernel<DH, RK, ACT>, maps, a);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// The instances of one activation: the head width and the rank class.
template <int ACT>
int launch_act(const Ptrs& g, const Args& a, int B, int dh, int r, int ldu,
               cudaStream_t stream) {
  const int rk = r <= 16 ? 1 : r <= kRankTile ? 4 : RK_LOOP;
  switch (dh) {
    case 16:
      return rk == 1   ? launch<16, 1, ACT>(g, a, B, r, ldu, stream)
             : rk == 4 ? launch<16, 4, ACT>(g, a, B, r, ldu, stream)
                       : launch<16, RK_LOOP, ACT>(g, a, B, r, ldu, stream);
    case 32:
      return rk == 1   ? launch<32, 1, ACT>(g, a, B, r, ldu, stream)
             : rk == 4 ? launch<32, 4, ACT>(g, a, B, r, ldu, stream)
                       : launch<32, RK_LOOP, ACT>(g, a, B, r, ldu, stream);
    case 64:
      return rk == 1   ? launch<64, 1, ACT>(g, a, B, r, ldu, stream)
             : rk == 4 ? launch<64, 4, ACT>(g, a, B, r, ldu, stream)
                       : launch<64, RK_LOOP, ACT>(g, a, B, r, ldu, stream);
    case 80:
      return rk == 1   ? launch<80, 1, ACT>(g, a, B, r, ldu, stream)
             : rk == 4 ? launch<80, 4, ACT>(g, a, B, r, ldu, stream)
                       : launch<80, RK_LOOP, ACT>(g, a, B, r, ldu, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The quick_gelu instances (block_pair_quick.cu).
int launch_quick(const Ptrs& g, const Args& a, int B, int dh, int r,
                 int ldu, cudaStream_t stream);

}  // namespace block_pair
