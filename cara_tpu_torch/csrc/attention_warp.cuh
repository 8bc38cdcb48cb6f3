// One warp's share of the full-score softmax attention, shared by
// qkv_attention.cu (the attention alone) and attn_proj.cu (the attention
// feeding the projection in the same block).
//
// A warp owns 16 query rows of one head.  K and V of that head lie in
// shared memory (npp rows, a multiple of 16, zero past N, row stride
// DH + kPad); the warp walks the keys in 16-wide tiles twice: first for
// the row max, then for exp(s - max), the row sum and P@V.  No score row
// is stored: each pass goes through a 16x16 fp32 scratch tile S and a
// 16x16 bf16 tile P of the warp's own.
//
// Math, as the TPU's _attn_heads (cara_tpu/ops/pallas/
// fused_qkv_attention.py): q arrives pre-scaled and rounded to bf16; fp32
// scores; keys >= n_real masked to -1e30; exp and the row sum in fp32; P
// rounded to bf16 for P@V; 1/l applied after the product.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace attn_warp {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;
constexpr int kPad = 8;  // row pad (bf16) against bank conflicts

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Row lane/2, columns (lane&1)*8 .. +8 of a row-major 16x16 fp32 tile
// are the eight floats at lane*8: two 16-byte reads.
__device__ __forceinline__ void load8(float* v, const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <int DH>
__device__ __forceinline__ void score_tile(AccFrag& acc,
                                           const __nv_bfloat16* qw,
                                           const __nv_bfloat16* ks, int kt) {
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int dc = 0; dc < DH / 16; ++dc) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::col_major> fb;
    wmma::load_matrix_sync(fa, qw + dc * 16, DH + kPad);
    wmma::load_matrix_sync(fb, ks + kt * 16 * (DH + kPad) + dc * 16,
                           DH + kPad);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// The warp's 16 rows (q at qw, row stride DH + kPad) against keys
// 0 .. npp-1: o = bf16(exp(s - m)) @ V in fp32 fragments; returns 1/l of
// the lane's row (lane >> 1).
template <int DH>
__device__ __forceinline__ float warp_attention(
    AccFrag (&o)[DH / 16], const __nv_bfloat16* qw,
    const __nv_bfloat16* ks, const __nv_bfloat16* vs, int npp, int n_real,
    float* S, __nv_bfloat16* P, int lane) {
  constexpr int LD = DH + kPad;
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
  const int ntiles = npp / 16;
  AccFrag acc;

  // Pass 1: the row max over every valid key.
  float m = kNegInf;
  for (int kt = 0; kt < ntiles; ++kt) {
    score_tile<DH>(acc, qw, ks, kt);
    wmma::store_matrix_sync(S, acc, 16, wmma::mem_row_major);
    __syncwarp();
    float sv[8];
    load8(sv, S + lane * 8);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      m = fmaxf(m, kt * 16 + ec + t < n_real ? sv[t] : kNegInf);
    __syncwarp();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // Pass 2: P = exp(s - m) in fp32, its row sum, and O = bf16(P) @ V.
#pragma unroll
  for (int dc = 0; dc < DH / 16; ++dc) wmma::fill_fragment(o[dc], 0.f);
  float l = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    score_tile<DH>(acc, qw, ks, kt);
    wmma::store_matrix_sync(S, acc, 16, wmma::mem_row_major);
    __syncwarp();
    float sv[8];
    load8(sv, S + lane * 8);
    uint4 packed;
    __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float ex =
          expf((kt * 16 + ec + t < n_real ? sv[t] : kNegInf) - m);
      l += ex;
      pe[t] = __float2bfloat16(ex);
    }
    *reinterpret_cast<uint4*>(P + er * 16 + ec) = packed;
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fp;
    wmma::load_matrix_sync(fp, P, 16);
#pragma unroll
    for (int dc = 0; dc < DH / 16; ++dc) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fv;
      wmma::load_matrix_sync(fv, vs + kt * 16 * LD + dc * 16, LD);
      wmma::mma_sync(o[dc], fp, fv, o[dc]);
    }
    __syncwarp();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  return 1.f / l;
}

// bf16(o * inv_l) into the lane's row: columns dc*16 + (lane&1)*8 .. +8
// of dst (the row's first head column, global or shared memory), one
// 16x16 fragment at a time through S; nothing written unless `valid`.
template <int DH>
__device__ __forceinline__ void store_rows(AccFrag (&o)[DH / 16],
                                           float inv_l, float* S,
                                           __nv_bfloat16* dst, bool valid,
                                           int lane) {
  const int ec = (lane & 1) * 8;
#pragma unroll
  for (int dc = 0; dc < DH / 16; ++dc) {
    wmma::store_matrix_sync(S, o[dc], 16, wmma::mem_row_major);
    __syncwarp();
    if (valid) {
      float ov[8];
      load8(ov, S + lane * 8);
      uint4 packed;
      __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int t = 0; t < 8; ++t) pe[t] = __float2bfloat16(ov[t] * inv_l);
      *reinterpret_cast<uint4*>(dst + dc * 16 + ec) = packed;
    }
    __syncwarp();
  }
}

}  // namespace attn_warp
