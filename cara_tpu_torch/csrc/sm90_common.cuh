// The Hopper (sm_90a) building blocks the wgmma kernels share
// (qkv_attention.cu, tiled_attention_fwd.cuh, tiled_attention_bwd.cuh,
// grad_gemm.cu):
// shared-memory matrix descriptors for wgmma and its fence / commit /
// wait, mbarrier init, expect-tx, arrive and wait, the TMA tile load and
// store and the bulk copies (a plain load and an fp32 add-reduce into
// global memory), named barriers, the acquire load and release add of an
// ordering counter in global memory, and on the host the encoding of a TMA
// tensor map.  The wgmma instructions themselves are in sm90_wgmma.cuh.
//
// Swizzle: a tile whose rows are W = 32, 64 or 128 bytes (16, 32 or 64
// bf16) is loaded by TMA with the swizzle of the same width, and wgmma
// reads it with the matching layout type.  Its base must be aligned to 8
// rows (256, 512 or 1024 bytes).  A head wider than 64 columns (Dh 80) is
// one such tile a part (HeadTile below).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "sm90_wgmma.cuh"

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma layout type of a swizzled tile whose rows are `row_bytes` wide.
__host__ __device__ constexpr int swizzle_mode(int row_bytes) {
  return row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
}

// Descriptor of a bf16 tile at `p` with rows of ROW_BYTES (the swizzle
// width), 8-row groups one after the other.  K-major (the reduction axis
// along the row): each 16-deep k-step starts 32 bytes further into the
// row.  MN-major (the output axis along the row, TA / TB = 1): rows are
// the reduction axis, and a k-step starts 16 rows further on.  Either way
// the stride between 8-row groups is 8 rows.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(8 * ROW_BYTES >> 4) << 32) |
         ((uint64_t)swizzle_mode(ROW_BYTES) << 62);
}

// Descriptor of an MN-major bf16 operand whose output axis spans several
// 64-element (128-byte) swizzle atoms: each atom is its own 128-byte-row
// tile (8-row groups 1024 bytes apart), `atom_bytes` after the previous
// one (the leading byte offset; PTX's canonical MN-major layout with the
// 128-byte swizzle).  A k-step of 16 rows starts 2048 bytes further on.
__device__ __forceinline__ uint64_t desc_mn(const void* p,
                                            uint32_t atom_bytes) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(atom_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// A head's Dh columns as swizzle parts, for the attention kernels: part 0
// is min(Dh, 64) columns (Dh 16, 32 and 64 are one part, the swizzle of a
// Dh * 2-byte row), part 1 the rest, 16 or 32 columns (Dh 80 = 64 + 16: a
// 160-byte row has no swizzle mode, and the 128-byte swizzle caps a TMA
// box row at 128 bytes).  A stack of ROWS rows of a head (ROWS a multiple
// of 64: a tile, a key chunk) keeps its parts one after the other, part 0
// (ROWS x W0) then part 1 (ROWS x W1), each with the swizzle of its own
// row width, so that within a part 8-row groups are a constant stride
// apart (a wgmma operand of up to ROWS rows) and a 1024-aligned stack puts
// part 1 on a 256-byte boundary.  Single-part widths lay out exactly as a
// dense ROWS x Dh tile.
//   - a product that reduces over Dh (s = q k^T, dp = do v^T) takes its
//     16-column k-steps in order, W0 / 16 on part 0 then W1 / 16 on part 1,
//     each with its part's K-major descriptor (head_kdesc);
//   - a product whose output is Dh wide (P V, dv, dk, dq) is one wgmma a
//     part, n = W0 and n = W1, each into its slice of the accumulator
//     (wgmma_rs_head, wgmma_ss_head): the slices together hold the
//     accumulator of one n = Dh product (d[4j + c] at column 8j + ...);
//   - TMA moves a 64-row box a part (maps[p], box width W_p, at column
//     c0 + col(p)), counted on one barrier (tma_load_head_*,
//     tma_store_head_*).
// No padding: every product does Dh columns of work.
template <int DH>
struct HeadTile {
  static constexpr int W0 = DH > 64 ? 64 : DH;
  static constexpr int W1 = DH - W0;
  static constexpr int PARTS = W1 > 0 ? 2 : 1;
  static_assert(W0 == 16 || W0 == 32 || W0 == 64, "part 0: 16, 32 or 64");
  static_assert(W1 == 0 || W1 == 16 || W1 == 32, "part 1: 16 or 32");
  __host__ __device__ static constexpr int width(int p) { return p ? W1 : W0; }
  __host__ __device__ static constexpr int col(int p) { return p ? W0 : 0; }
  // Elements from a ROWS-row stack's start to its part p.
  template <int ROWS>
  __host__ __device__ static constexpr int off(int p) {
    return p ? ROWS * W0 : 0;
  }
};

// K-major descriptor of k-step kk (Dh columns 16 kk .. 16 kk + 15) of the
// ROWS-row head stack at t.
template <int DH, int ROWS>
__device__ __forceinline__ uint64_t head_kdesc(const __nv_bfloat16* t,
                                               int kk) {
  using H = HeadTile<DH>;
  if constexpr (H::PARTS == 2) {
    if (kk >= H::W0 / 16)
      return desc<2 * H::W1>(t + H::template off<ROWS>(1)) +
             2 * (kk - H::W0 / 16);
  }
  return desc<2 * H::W0>(t) + 2 * kk;
}

// MN-major descriptor of part P of k-step kk (stack rows 16 kk .. 16 kk +
// 15, the reduction axis) of the ROWS-row head stack at t.
template <int DH, int ROWS, int P>
__device__ __forceinline__ uint64_t head_mndesc(const __nv_bfloat16* t,
                                                int kk) {
  using H = HeadTile<DH>;
  constexpr int W = H::width(P);
  return desc<2 * W>(t + H::template off<ROWS>(P) + kk * 16 * W);
}

// The slice of part P in an accumulator of one n = Dh product.
template <int DH, int P>
__device__ __forceinline__ float (&acc_part(float (&d)[DH / 2]))
    [HeadTile<DH>::width(P) / 2] {
  return *reinterpret_cast<float(*)[HeadTile<DH>::width(P) / 2]>(
      d + (P ? HeadTile<DH>::W0 / 2 : 0));
}

// d (64 x Dh) (+)= A . B for B the 16-row k-step kk of the ROWS-row head
// stack at t read MN-major, A from registers: one wgmma a part.
template <int DH, int ROWS>
__device__ __forceinline__ void wgmma_rs_head(float (&d)[DH / 2],
                                              const uint32_t (&a)[4],
                                              const __nv_bfloat16* t, int kk,
                                              int scale_d) {
  using H = HeadTile<DH>;
  wgmma_rs<H::W0, 1>(acc_part<DH, 0>(d), a, head_mndesc<DH, ROWS, 0>(t, kk),
                     scale_d);
  if constexpr (H::PARTS == 2)
    wgmma_rs<H::W1, 1>(acc_part<DH, 1>(d), a,
                       head_mndesc<DH, ROWS, 1>(t, kk), scale_d);
}

// The same with A in shared memory by descriptor (TA = 1: MN-major).
template <int DH, int ROWS, int TA>
__device__ __forceinline__ void wgmma_ss_head(float (&d)[DH / 2],
                                              uint64_t da,
                                              const __nv_bfloat16* t, int kk,
                                              int scale_d) {
  using H = HeadTile<DH>;
  wgmma_ss<H::W0, TA, 1>(acc_part<DH, 0>(d), da,
                         head_mndesc<DH, ROWS, 0>(t, kk), scale_d);
  if constexpr (H::PARTS == 2)
    wgmma_ss<H::W1, TA, 1>(acc_part<DH, 1>(d), da,
                           head_mndesc<DH, ROWS, 1>(t, kk), scale_d);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma: called on every register of an accumulator after
// the wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory writes of the generic proxy made visible to TMA and wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Registers of each thread of the calling warpgroup raised (inc) or
// lowered (dec) to N: a warpgroup that only issues copies hands its
// registers to the consumer warpgroups (every warp of the warpgroup
// executes it, before any divergence).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` (1..15) over `count` threads (a multiple of 32).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  asm volatile(
      "{\n.reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}

// TMA: one box of `map` at coordinates (c0, c1[, c2[, c3]]) into `dst`,
// completion counted in bytes on `bar`.  Out-of-range rows arrive as 0.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: the box of `map` at (c0, c1[, c2[, c3]]) written from `src`; rows
// out of range are not written.  Commits the bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// TMA: the box of `map` at (c0, c1) added (fp32 add, in the memory
// system) from `src`; out-of-range elements skipped.  Commits the group.
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, counted on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// dst[i] += src[i] in fp32 for `bytes` (a multiple of 16) of shared memory,
// performed by the memory system; then commit the bulk group.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst,
                                                    const float* src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until the committed bulk groups have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... every committed bulk group but the newest N.
template <int N>
__device__ __forceinline__ void bulk_wait_read_n() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Wait until every committed bulk group but the newest has completed.
__device__ __forceinline__ void bulk_wait_1() {
  asm volatile("cp.async.bulk.wait_group 1;\n" ::: "memory");
}

// An ordering counter in global memory, for sums taken in a fixed order
// across blocks: wait_turn spins (acquire loads) until the counter reads
// `turn`, pass_turn adds 1 (release).  The fences between the generic and
// the async proxy order a bulk reduce issued after wait_turn, or
// completed before pass_turn, with the counter.  A wait that outlasts
// some seconds traps rather than hang the card.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void wait_turn(const int* p, int turn) {
  for (long long spin = 0; ld_acquire(p) != turn; ++spin) {
    if (spin > (1ll << 27)) __trap();
    __nanosleep(64);
  }
  fence_proxy_async_global();
}
__device__ __forceinline__ void pass_turn(int* p) {
  fence_proxy_async_global();
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(p)
               : "memory");
}

// Byte offset `a` within a tile of ROW_BYTES-wide rows (1024-aligned base)
// moved as TMA's swizzle of that width moves it.
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzle(uint32_t a) {
  return a ^ ((a >> 3) & ((ROW_BYTES / 16 - 1) << 4));
}

// Byte offset of the element pair (row, col), (row, col + 1) (col even) in
// the ROWS-row head stack, swizzled as its part's TMA box lays it out.
template <int DH, int ROWS>
__device__ __forceinline__ uint32_t head_byte(int row, int col) {
  using H = HeadTile<DH>;
  if constexpr (H::PARTS == 2) {
    if (col >= H::W0)
      return 2 * H::template off<ROWS>(1) +
             swizzle<2 * H::W1>(row * 2 * H::W1 + (col - H::W0) * 2);
  }
  return swizzle<2 * H::W0>(row * 2 * H::W0 + col * 2);
}

// TMA: rows r0 .. r0 + 63 of the ROWS-row head stack at `stack` from the
// box of each part's map at (c0, c1[, c2, c3]); c0 the head's first column.
template <int DH, int ROWS>
__device__ __forceinline__ void tma_load_head_3d(__nv_bfloat16* stack, int r0,
                                                 const CUtensorMap* maps,
                                                 uint64_t* bar, int c0,
                                                 int c1, int c2) {
  using H = HeadTile<DH>;
#pragma unroll
  for (int p = 0; p < H::PARTS; ++p)
    tma_load_3d(stack + H::template off<ROWS>(p) + r0 * H::width(p),
                &maps[p], bar, c0 + H::col(p), c1, c2);
}
template <int DH, int ROWS>
__device__ __forceinline__ void tma_load_head_4d(__nv_bfloat16* stack, int r0,
                                                 const CUtensorMap* maps,
                                                 uint64_t* bar, int c0,
                                                 int c1, int c2, int c3) {
  using H = HeadTile<DH>;
#pragma unroll
  for (int p = 0; p < H::PARTS; ++p)
    tma_load_4d(stack + H::template off<ROWS>(p) + r0 * H::width(p),
                &maps[p], bar, c0 + H::col(p), c1, c2, c3);
}
// TMA: a 64-row head tile written by one store a part (each commits its
// bulk group: HeadTile<DH>::PARTS groups).
template <int DH>
__device__ __forceinline__ void tma_store_head_3d(const CUtensorMap* maps,
                                                  const __nv_bfloat16* tile,
                                                  int c0, int c1, int c2) {
  using H = HeadTile<DH>;
#pragma unroll
  for (int p = 0; p < H::PARTS; ++p)
    tma_store_3d(&maps[p], tile + H::template off<64>(p), c0 + H::col(p), c1,
                 c2);
}
template <int DH>
__device__ __forceinline__ void tma_store_head_4d(const CUtensorMap* maps,
                                                  const __nv_bfloat16* tile,
                                                  int c0, int c1, int c2,
                                                  int c3) {
  using H = HeadTile<DH>;
#pragma unroll
  for (int p = 0; p < H::PARTS; ++p)
    tma_store_4d(&maps[p], tile + H::template off<64>(p), c0 + H::col(p), c1,
                 c2, c3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The wgmma register A fragment of k-step kk from an accumulator d (the
// same rows; columns 16 kk .. 16 kk + 15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* d,
                                         int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Host: a bf16 (`elem_bytes` 2) or fp32 (4) tensor map of `rank`
// dimensions (innermost first) over `base`, strides in bytes of
// dimensions 1.., box `box` with the swizzle of a box row (box[0] *
// elem_bytes bytes: 32, 64 or 128).  cuTensorMapEncodeTiled
// is looked up through the CUDA runtime's entry-point query, so nothing
// links libcuda.  The encoding depends on its arguments alone (not on the
// memory at `base`), and a training step allocates its tensors at the
// same addresses as the step before, so encoded maps are kept in a table
// keyed by every argument: a GEMM's few maps cost a lookup, not an
// encoding each.  A ViT-B training step's products (the forward sites
// and the block backwards of 12 layers) use several hundred maps, so the
// table has 4096 slots (1 MB).  Returns 0 or a CUresult / cudaError_t
// code.
struct MapKey {
  const void* base;
  int rank, elem_bytes;
  uint64_t dims[5], strides[4];
  uint32_t box[5];
};

inline int encode_map(CUtensorMap* map, const void* base, int rank,
                      const uint64_t* dims, const uint64_t* strides,
                      const uint32_t* box, int elem_bytes = 2) {
  constexpr int kSlots = 4096;
  static MapKey keys[kSlots];
  static CUtensorMap maps[kSlots];
  static bool used[kSlots];
  static std::mutex mu;
  MapKey key;
  memset(&key, 0, sizeof(key));
  key.base = base;
  key.rank = rank;
  key.elem_bytes = elem_bytes;
  uint64_t h = (reinterpret_cast<uint64_t>(base) + elem_bytes) *
               0x9E3779B97F4A7C15ull;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    h = (h ^ dims[i] ^ ((uint64_t)box[i] << 40)) * 0x100000001B3ull;
    if (i + 1 < rank) {
      key.strides[i] = strides[i];
      h = (h ^ strides[i]) * 0x100000001B3ull;
    }
  }
  const int slot = static_cast<int>((h >> 32) % kSlots);
  std::lock_guard<std::mutex> lock(mu);
  if (used[slot] && memcmp(&keys[slot], &key, sizeof(key)) == 0) {
    *map = maps[slot];
    return 0;
  }
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t found;
#if CUDART_VERSION >= 12050
    found = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                             12000, cudaEnableDefault, &q);
#else
    found = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                    cudaEnableDefault, &q);
#endif
    if (found != cudaSuccess) return static_cast<int>(found);
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<Encode>(fn);
  }
  // The encoder wants a current context.  A thread that has made no
  // runtime call yet has none (autograd's device thread, when a backward
  // kernel of this library is its first CUDA work); setting the device
  // binds the runtime's primary context to the thread.
  int device = 0;
  cudaGetDevice(&device);
  cudaSetDevice(device);
  const int row_bytes = static_cast<int>(box[0]) * elem_bytes;
  const CUtensorMapSwizzle sw =
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map,
      elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      rank, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) {
    keys[slot] = key;
    maps[slot] = *map;
    used[slot] = true;
  }
  return static_cast<int>(r);
}

// Host: one bf16 map a part of a head (HeadTile<DH>) over the same
// tensor: `dims`, `strides` and `box` as encode_map's, box[0] (the head
// columns) replaced by the part's width, hence its swizzle.
template <int DH>
inline int encode_head_maps(CUtensorMap* maps, const void* base, int rank,
                            const uint64_t* dims, const uint64_t* strides,
                            const uint32_t* box) {
  using H = HeadTile<DH>;
  for (int p = 0; p < H::PARTS; ++p) {
    uint32_t b[5];
    for (int i = 0; i < rank; ++i) b[i] = box[i];
    b[0] = H::width(p);
    const int err = encode_map(&maps[p], base, rank, dims, strides, b);
    if (err) return err;
  }
  return 0;
}

// Host: the number of SMs of the current device (cached).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

}  // namespace sm90
