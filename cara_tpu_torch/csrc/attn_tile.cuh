// The attention of one 64-query tile against streamed 64-key K / V tiles,
// on wgmma, shared by the kernels that keep the attention output on chip
// for the product after it: attn_proj.cu (row 3: attention + projection)
// and block_pair.cu (row 19: the whole eval block).
//
// The caller's tile `ot` is 64 rows x E (rounded up to 64 columns) bf16
// as 64-column atoms of 128-byte rows with the 128-byte swizzle (the
// K-major layout wgmma reads as its A operand), q loaded at its columns;
// the K and V tiles of a head arrive one by one in slots of a ring
// (aslot(i) waits for entry i and returns it, arelease(i) frees it): per
// head the nkt K tiles of the max pass, then K and V tile by tile.
// head_attention leaves o (64 x Dh, the wgmma accumulator layout) and
// 1 / l of the warp's two rows; the caller rounds bf16(o / l) and writes
// it where it wants (its own tile, or the tiles of a whole cluster).
//
// P is rounded against each row's final max, as _attn_heads and row 1
// (qkv_attention.cu) round it: a max pass over the key tiles, then the
// exp / P V pass.  Keys >= n_real are masked.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace attn_tile {

using namespace sm90;

constexpr int kRows = 64;           // query rows of a tile: one wgmma M
constexpr int kKeys = 64;           // keys of a streamed K or V tile
constexpr int kAtom = kRows * 128;  // one 64-column atom of the tile
constexpr float kNegInf = -1e30f;

// K-major descriptor of the 16 tile columns from `col` (a multiple of 16)
// on: its atom's descriptor, 32 bytes a k-step further into the row.
__device__ __forceinline__ uint64_t ot_desc(const unsigned char* ot,
                                            int col) {
  return desc<128>(ot + (col >> 6) * kAtom) + ((col & 63) >> 3);
}

// Byte offset of the element pair (row, col), (row, col + 1) (col even)
// in the tile: its atom, then the 128-byte swizzle.
__device__ __forceinline__ uint32_t ot_byte(int row, int col) {
  return (col >> 6) * kAtom + swizzle<128>(row * 128 + (col & 63) * 2);
}

// S (64 x 64) = Q_h . K tile^T, raw fp32 scores, waited for.
template <int DH>
__device__ __forceinline__ void head_scores(float (&s)[kKeys / 2],
                                            const unsigned char* ot, int c_h,
                                            const __nv_bfloat16* ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<kKeys, 0, 0>(s, ot_desc(ot, c_h + 16 * kk),
                          head_kdesc<DH, kKeys>(ks, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// Keys >= n_real of the tile whose first key is col0 set to -1e30; only
// the 8-column groups that reach n_real are visited (a uniform branch).
__device__ __forceinline__ void mask_keys(float (&s)[kKeys / 2], int col0,
                                          int n_real, int t) {
  if (col0 + kKeys <= n_real) return;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    if (col0 + 8 * j + 8 <= n_real) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col0 + 8 * j + 2 * t + (c & 1) >= n_real) s[4 * j + c] = kNegInf;
  }
}

// The running row max m[r] (rows g and g + 8 of the warp's 16) of the raw
// scores, reduced over the quad that holds a row.
__device__ __forceinline__ void row_max(const float (&s)[kKeys / 2],
                                        float (&m)[2]) {
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[r][u] = m[r];
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] =
        fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
}

// p = exp((s - m) sc) in place (sc the scale still to apply to the raw
// scores, 1 after a pre-scaled q; masked keys give 0) and this thread's
// share of the row sums added to l; the 8-column groups wholly at or past
// n_real take no exp (a uniform branch).
__device__ __forceinline__ void exp_tile(float (&s)[kKeys / 2],
                                         const float (&m)[2], float sc,
                                         int col0, int n_real,
                                         float (&l)[2]) {
  float ls[2][2] = {};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    if (col0 + 8 * j >= n_real) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[4 * j + c] = 0.f;
      continue;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[4 * j + c] = expf((s[4 * j + c] - m[c >> 1]) * sc);
      ls[c >> 1][j & 1] += s[4 * j + c];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] += ls[r][0] + ls[r][1];
}

// One head of the tile (its q at columns c_h .. c_h + Dh - 1 of ot): the
// max pass over ring entries ia .. ia + nkt - 1 (K tiles), then the exp /
// P V pass (K tile j at entry ia + 2 j, V tile j at + 1); ia advances
// past the head's 3 nkt entries.  o (64 x Dh) unnormalised, inv = 1 / l
// of rows g and g + 8 of the warp's 16.
template <int DH, class Slot, class Release>
__device__ __forceinline__ void head_attention(float (&o)[DH / 2],
                                               float (&inv)[2],
                                               const unsigned char* ot,
                                               int c_h, int nkt, int n_real,
                                               float sc, int t, int& ia,
                                               Slot aslot,
                                               Release arelease) {
  float s[kKeys / 2];
  float m[2] = {kNegInf, kNegInf};
  for (int j = 0; j < nkt; ++j, ++ia) {
    head_scores<DH>(s, ot, c_h, aslot(ia));
    arelease(ia);
    mask_keys(s, j * kKeys, n_real, t);
    row_max(s, m);
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  for (int j = 0; j < nkt; ++j, ia += 2) {
    head_scores<DH>(s, ot, c_h, aslot(ia));
    arelease(ia);
    mask_keys(s, j * kKeys, n_real, t);
    exp_tile(s, m, sc, j * kKeys, n_real, l);
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) acc_to_a(pa[kk], s, kk);
    const __nv_bfloat16* vs = aslot(ia + 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs_head<DH, kKeys>(o, pa[kk], vs, kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    arelease(ia + 1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
}

}  // namespace attn_tile
