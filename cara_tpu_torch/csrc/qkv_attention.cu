// Layout-native softmax attention for Hopper (sm_90a): wgmma and TMA.
//
// Reads the fused qkv GEMM output (B, N, 3E) as it lies — out-flat
// (3, H, Dh), so head h's q, k and v start at columns h*Dh, E + h*Dh and
// 2E + h*Dh — and writes the attention output (B, N, E) in the layout the
// projection consumes.  No transposes on either side.
//
// Replaces cara_tpu/ops/pallas/fused_qkv_attention.py (_fwd and its
// per-head math _attn_heads), which the attention-block megakernel
// cara_tpu/ops/pallas/cp_attn_block.py also runs.  The TPU kernel holds
// (bb, NP, 3E) tiles and full (NP, NP) score tiles in VMEM.
//
// What bounds it on the H100: at B = 64, N = 197, H = 12, Dh = 64 the call
// reads 58 MB and writes 19 MB (77.5 MB, 0.0231 ms at 3.35 TB/s) and does
// 2 x 2 B H N^2 Dh = 15.3 GFLOP (0.0155 ms): bytes, barely.  The previous
// design (one block per 64-query tile with mma.sync, every 16x16 score
// tile through a shared fp32 scratch, QK^T computed twice, a head's K and V
// reloaded by each of its four query tiles) was bound by latency and by
// shared-memory round trips: 0.1867-0.1880 ms, 3x SDPA.  This design:
//   - one persistent block per SM walks over the (image, head) items; Q,
//     K and V of an item arrive once by TMA (a 3-D tensor map over qkv,
//     boxes of 64 rows x Dh with the swizzle of a Dh * 2-byte row; rows past
//     N arrive as zeros) into one of two slots, completion on an mbarrier,
//     so the next item loads while this one is computed (one slot when an
//     item does not fit twice, N > 256 at Dh 64);
//   - two consumer warpgroups take the item's 64-query tiles in turn; per
//     tile S = Q K^T is one wgmma.m64nNk16 chain (N = 64, 128, 200 or 256,
//     the key count rounded up; 100 fp32 registers a thread at N = 197),
//     the full-row max comes from quad shuffles, P = exp(s - max) is
//     rounded to bf16 in registers as wgmma's register A operand, and
//     O = P V is wgmma with V read through the descriptor's MN-major
//     (transposed) mode.  QK^T is computed once, and no score touches
//     shared memory.  O goes back by one TMA store a tile, from the q
//     tile's place;
//   - above 256 keys (ViT-L/14, ViT-H/14: 257 tokens) the keys go in two
//     256-wide chunks with the same code: pass 1 takes the row max, pass 2
//     the exponentials, the sum and P V;
//   - at Dh 80 (ViT-H/14) a head is a 64-column and a 16-column part
//     (sm90_common.cuh, HeadTile): two TMA boxes and descriptors a tile,
//     the score k-steps four on the first part and one on the second,
//     P V and the output store one a part.  Q, K and V of an item would
//     not fit one block past ~300 tokens (247,808 bytes at 512), so K and
//     V alone make the item's slot (163,840 bytes at 512; two slots up to
//     256 tokens) and each warpgroup streams its query tiles through a
//     ring of three (kRing), loading the next while it computes one.
// Measured on one H100 80GB HBM3 at 700 W (tools/compare_parent.py, one
// run in turns with the previous design): 0.0735 / 0.0787 ms, 29-31 % of
// the bound, 1.1-1.2x SDPA's 0.0614 / 0.0695 in the same turns.  What
// holds it there: per tile the softmax's fp32 work on 100 scores a thread
// between two waits on the tensor cores, with only two warpgroups a block
// (one block an SM, for the registers) to overlap them.
//
// Math, as _attn_heads: q is pre-scaled and rounded to bf16 (in shared
// memory, before the first product; a power-of-two scale is exact in
// bf16 and is applied to the fp32 scores instead); fp32 scores; keys >=
// n_real masked to -1e30; the full-row max, then exp and sum in fp32; P
// rounded to bf16 for P@V; 1/l applied after the product.  P columns past
// the key count are zero and V rows past N arrive as zeros, so K is padded
// to the 16-deep k-step exactly.  Rows past N are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kMaxSmem = 232448;  // H100: 227 KB per block (opt-in)
constexpr int kThreads = 256;     // two consumer warpgroups
constexpr int kSlab = 64;         // rows of one TMA box (and query tile)
constexpr int kRing = 3;          // query tiles of a warpgroup's ring
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int slabs(int rows) {
  return (rows + kSlab - 1) / kSlab;
}

// Whether the query tiles stream through a ring (Dh 80: Q resident as well
// as K and V would not fit one block past ~300 tokens) rather than arrive
// with the item.
__host__ __device__ constexpr bool q_ring(int dh) { return dh > 64; }

// Rows of one item's slot in shared memory: Q (the query tiles, none when
// they stream through the ring), then K and V (each `nch` chunks of the
// chunk width rounded up to 16, in 64-row slabs).
struct Plan {
  int nch, q_slabs, kv_slabs;  // kv_slabs: per chunk
  __host__ __device__ int rows() const {
    return (q_slabs + 2 * nch * kv_slabs) * kSlab;
  }
};

__host__ __device__ inline Plan make_plan(int N, int nk, bool ring) {
  Plan p;
  p.nch = N > nk ? 2 : 1;
  p.q_slabs = ring ? 0 : slabs(N);
  p.kv_slabs = slabs((nk + 15) & ~15);
  return p;
}

// The TMA maps of the qkv input and the output, one a part of the head.
template <int DH>
struct Maps {
  static constexpr int P = HeadTile<DH>::PARTS;
  CUtensorMap in[P], out[P];
};

__host__ __device__ inline int chunk_width(int N) {
  return N <= 64 ? 64 : N <= 128 ? 128 : N <= 200 ? 200 : 256;
}

// Rows of a K or V chunk in shared memory (a head stack, HeadTile).
__host__ __device__ constexpr int chunk_rows(int nk) {
  return slabs((nk + 15) & ~15) * kSlab;
}

// S (64 x NK) = Q tile . K chunk^T, fp32 in the accumulator layout.
template <int DH, int NK>
__device__ __forceinline__ void scores(float (&s)[NK / 2],
                                       const __nv_bfloat16* qt,
                                       const __nv_bfloat16* kc) {
  constexpr int KR = chunk_rows(NK);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<NK, 0, 0>(s, head_kdesc<DH, kSlab>(qt, kk),
                       head_kdesc<DH, KR>(kc, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// Keys >= n_real of the chunk whose first key is col0 set to -1e30; only
// the 8-column groups that reach n_real are visited (a uniform branch).
template <int NK>
__device__ __forceinline__ void mask_keys(float (&s)[NK / 2], int col0,
                                          int n_real, int t) {
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    if (col0 + 8 * j + 8 <= n_real) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col0 + 8 * j + 2 * t + (c & 1) >= n_real) s[4 * j + c] = kNegInf;
  }
}

// Running row max m[r] (rows g and g + 8 of the warp's 16) of the raw
// scores, four partial maxima a row for a short dependency chain.
template <int NK>
__device__ __forceinline__ void row_max(const float (&s)[NK / 2],
                                        float (&m)[2]) {
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[r][u] = m[r];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] =
        fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
}

// p = exp(sc (s - m)) (sc the scale still to apply to the raw scores, 1
// when q was pre-scaled; masked keys give 0) by the full-precision expf,
// as the plain twin takes it: the SFU's 2^x approximation moves the bf16
// rounding of P on more keys, which the CP factors' gradients amplify.
// l += the fp32 row sums (this thread's share), o += bf16(p) . V chunk.
template <int DH, int NK>
__device__ __forceinline__ void softmax_pv(float (&s)[NK / 2],
                                           const float (&m)[2], float sc,
                                           float (&l)[2], float (&o)[DH / 2],
                                           const __nv_bfloat16* vc) {
  constexpr int KSTEPS = (NK + 15) / 16;
  float ls[2][4] = {};
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) {
    const float p = expf((s[i] - m[(i >> 1) & 1]) * sc);
    ls[(i >> 1) & 1][(i >> 2) & 3] += p;
    s[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] += (ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]);
  uint32_t pa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r;  // columns past NK are zero P
      pa[kk][r] = i < NK / 2 ? pack_bf16(s[i], s[i + 1]) : 0u;
    }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    wgmma_rs_head<DH, chunk_rows(NK)>(o, pa[kk], vc, kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// Q, K and V of item (b, h) into one slot: q_slabs boxes of Q (each its
// own 64-row stack), then per chunk kv_slabs boxes of K and of V (a chunk
// one stack of chunk_rows(NK) rows), all counted on `bar`.
template <int DH, int NK>
__device__ __forceinline__ void load_item(const CUtensorMap* maps,
                                          uint64_t* bar, __nv_bfloat16* dst,
                                          const Plan& pl, int b, int h,
                                          int heads) {
  constexpr int KR = chunk_rows(NK);
  const int e = heads * DH;
  mbar_expect_tx(bar, (uint32_t)pl.rows() * DH * 2);
  __nv_bfloat16* p = dst;
  for (int s = 0; s < pl.q_slabs; ++s, p += kSlab * DH)
    tma_load_head_3d<DH, kSlab>(p, 0, maps, bar, h * DH, s * kSlab, b);
  for (int part = 1; part <= 2; ++part)  // K, then V
    for (int c = 0; c < pl.nch; ++c, p += KR * DH)
      for (int s = 0; s < pl.kv_slabs; ++s)
        tma_load_head_3d<DH, KR>(p, s * kSlab, maps, bar,
                                 part * e + h * DH, c * NK + s * kSlab, b);
}

// Query tile qt of item `it` into a ring slot of one warpgroup.
template <int DH>
__device__ __forceinline__ void load_query(const CUtensorMap* maps,
                                           uint64_t* bar, __nv_bfloat16* dst,
                                           int it, int qt, int heads) {
  mbar_expect_tx(bar, kSlab * DH * 2);
  tma_load_head_3d<DH, kSlab>(dst, 0, maps, bar, (it % heads) * DH,
                              qt * kSlab, it / heads);
}

template <int DH, int NK>
__global__ void __launch_bounds__(kThreads, 1)
qkv_attention_kernel(const __grid_constant__ Maps<DH> maps, int B, int N,
                     int heads, int n_real, float scale, int prescale,
                     int slots) {
  constexpr bool RING = q_ring(DH);
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles want 1024-byte alignment; the barriers sit in front.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* qfull = full + 2;  // [warpgroup][kRing] (RING)
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem + 1024);

  const Plan pl = make_plan(N, NK, RING);
  const int slot_elems = pl.rows() * DH;
  // RING: warpgroup wg's query tiles stream through its kRing slots after
  // the item slots.
  __nv_bfloat16* ring = tiles + slots * slot_elems;
  const int items = B * heads;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ntq = slabs(N);  // query tiles of an item
  // The scale still to apply to the scores: none after the pre-scaled q.
  const float sc = prescale ? 1.f : scale;

  if (tid == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(&full[s], 1);
    if (RING)
      for (int s = 0; s < 2 * kRing; ++s) mbar_init(&qfull[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < slots; ++s) {
      const int it = blockIdx.x + s * gridDim.x;
      if (it < items)
        load_item<DH, NK>(maps.in, &full[s], tiles + s * slot_elems, pl,
                          it / heads, it % heads, heads);
    }
  // RING: the warpgroup's first query tile (qt = wg of the first item).
  if (RING && wtid == 0 && blockIdx.x < items && wg < ntq)
    load_query<DH>(maps.in, &qfull[wg * kRing], ring + wg * kRing * kSlab * DH,
                   blockIdx.x, wg, heads);

  int k = 0, j = 0;  // j: the warpgroup's query tiles so far (RING)
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++k) {
    const int slot = k % slots;
    const int b = it / heads;
    const int h = it % heads;
    mbar_wait(&full[slot], (k / slots) & 1);
    __nv_bfloat16* qs = tiles + slot * slot_elems;
    const __nv_bfloat16* ks = qs + pl.q_slabs * kSlab * DH;
    const __nv_bfloat16* vs = ks + pl.nch * pl.kv_slabs * kSlab * DH;
    const int kc_elems = pl.kv_slabs * kSlab * DH;

    for (int qt = wg; qt < ntq; qt += 2, ++j) {
      __nv_bfloat16* qtile = qs + qt * kSlab * DH;
      if constexpr (RING) {
        // Tile j in ring slot j % kRing; tile j + 1 (the next of this item,
        // or the first of the next) loads into the slot of tile j - 2,
        // whose store has read it once all but the newest store (tile
        // j - 1's PARTS groups) have.
        __nv_bfloat16* wring = ring + wg * kRing * kSlab * DH;
        qtile = wring + (j % kRing) * kSlab * DH;
        if (wtid == 0) {
          const bool same = qt + 2 < ntq;
          const int nit = same ? it : it + gridDim.x;
          if (nit < items) {
            const int ns = (j + 1) % kRing;
            bulk_wait_read_n<HeadTile<DH>::PARTS>();
            load_query<DH>(maps.in, &qfull[wg * kRing + ns],
                           wring + ns * kSlab * DH, nit, same ? qt + 2 : wg,
                           heads);
          }
        }
        mbar_wait(&qfull[wg * kRing + j % kRing], (j / kRing) & 1);
      }
      if (prescale) {
        // q = bf16(q * scale) in place (the swizzle moves whole 16-byte
        // pieces, so every element is scaled wherever it lies).  A scale
        // that is a power of two is exact in bf16 and is applied to the
        // fp32 scores instead.
#pragma unroll
        for (int v = 0; v < DH / 16; ++v) {
          uint4* p = reinterpret_cast<uint4*>(qtile) + wtid + v * 128;
          uint4 x = *p;
          __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(&x);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            el[u] = __float2bfloat16(__bfloat162float(el[u]) * scale);
          *p = x;
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
      }

      float s[NK / 2];
      float o[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      if (pl.nch == 1) {
        scores<DH, NK>(s, qtile, ks);
        mask_keys<NK>(s, 0, n_real, t);
        row_max<NK>(s, m);
        softmax_pv<DH, NK>(s, m, sc, l, o, vs);
      } else {
        for (int c = 0; c < 2; ++c) {
          scores<DH, NK>(s, qtile, ks + c * kc_elems);
          mask_keys<NK>(s, c * NK, n_real, t);
          row_max<NK>(s, m);
        }
        for (int c = 0; c < 2; ++c) {
          scores<DH, NK>(s, qtile, ks + c * kc_elems);
          mask_keys<NK>(s, c * NK, n_real, t);
          softmax_pv<DH, NK>(s, m, sc, l, o, vs + c * kc_elems);
        }
      }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / l[r];
      }
      // bf16(o / l) into the q tile's place (q is no longer read), then one
      // TMA store of the 64 x Dh tile into (B, N, E); rows past N are
      // dropped by the store.
      unsigned char* ot = reinterpret_cast<unsigned char*>(qtile);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t row = warp * 16 + g + 8 * r;
#pragma unroll
        for (int c = 0; c < DH / 8; ++c)
          *reinterpret_cast<uint32_t*>(
              ot + head_byte<DH, kSlab>(row, 8 * c + 2 * t)) =
              pack_bf16(o[4 * c + 2 * r] * inv[r],
                        o[4 * c + 2 * r + 1] * inv[r]);
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (wtid == 0) tma_store_head_3d<DH>(maps.out, qtile, h * DH,
                                           qt * kSlab, b);
    }
    // The stores have read their tiles (RING: they read the ring, not the
    // slot).
    if (!RING && wtid == 0) bulk_wait_read();
    __syncthreads();  // every read of this slot is done: refill it
    if (tid == 0) {
      const int next = it + slots * gridDim.x;
      if (next < items)
        load_item<DH, NK>(maps.in, &full[slot], qs, pl, next / heads,
                          next % heads, heads);
    }
  }
  if (wtid == 0) bulk_wait();
}

// Shared-memory bytes of one block with `slots` slots at (N, dh).
size_t smem_bytes(int N, int dh, int slots) {
  const bool ring = q_ring(dh);
  const Plan pl = make_plan(N, chunk_width(N), ring);
  // 1024 bytes of alignment slack and 1024 for the barriers; the query
  // ring of both warpgroups.
  return 2048 + (size_t)slots * pl.rows() * dh * 2 +
         (ring ? (size_t)2 * kRing * kSlab * dh * 2 : 0);
}

template <int DH, int NK>
int launch(const __nv_bfloat16* qkv, __nv_bfloat16* out, int B, int N,
           int heads, int n_real, float scale, cudaStream_t stream) {
  const int slots = smem_bytes(N, DH, 2) <= kMaxSmem ? 2 : 1;
  const size_t smem = smem_bytes(N, DH, slots);
  static const cudaError_t attr = cudaFuncSetAttribute(
      qkv_attention_kernel<DH, NK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const uint64_t e = (uint64_t)heads * DH;
  Maps<DH> maps;
  const uint64_t dims[3] = {3 * e, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {3 * e * 2, 3 * e * 2 * N};
  const uint64_t odims[3] = {e, (uint64_t)N, (uint64_t)B};
  const uint64_t ostrides[2] = {e * 2, e * 2 * N};
  const uint32_t box[3] = {DH, kSlab, 1};
  int enc = encode_head_maps<DH>(maps.in, qkv, 3, dims, strides, box);
  if (enc == 0)
    enc = encode_head_maps<DH>(maps.out, out, 3, odims, ostrides, box);
  if (enc != 0) return enc;
  int ex;
  const int prescale = frexpf(scale, &ex) != 0.5f;  // not a power of two
  const int items = B * heads;
  const int grid = items < sm_count() ? items : sm_count();
  qkv_attention_kernel<DH, NK><<<grid, kThreads, smem, stream>>>(
      maps, B, N, heads, n_real, scale, prescale, slots);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const __nv_bfloat16* qkv, __nv_bfloat16* out, int B, int N,
              int heads, int n_real, float scale, cudaStream_t stream) {
  switch (chunk_width(N)) {
    case 64: return launch<DH, 64>(qkv, out, B, N, heads, n_real, scale,
                                   stream);
    case 128: return launch<DH, 128>(qkv, out, B, N, heads, n_real, scale,
                                     stream);
    case 200: return launch<DH, 200>(qkv, out, B, N, heads, n_real, scale,
                                     stream);
    default: return launch<DH, 256>(qkv, out, B, N, heads, n_real, scale,
                                    stream);
  }
}

}  // namespace

// Shared-memory bytes one block needs (0 when the shape is not taken:
// N above 512, or an item that does not fit one block's shared memory),
// so that the wrapper can refuse a shape before launching.
extern "C" int cara_qkv_attention_smem(int N, int dh) {
  if (N < 1 || N > 512) return 0;
  const size_t smem = smem_bytes(N, dh, 1);
  return smem > kMaxSmem ? 0 : static_cast<int>(smem);
}

// qkv (B, N, 3E) bf16 -> out (B, N, E) bf16, keys >= n_real masked.
// dh must be 16, 32, 64 or 80, N at most 512; qkv 16-byte aligned.  Returns
// cudaGetLastError() (or the error of the shared-memory attribute call or
// of the tensor-map encoding).
extern "C" int cara_qkv_attention(const void* qkv, void* out, int B, int N,
                                  int heads, int dh, int n_real, float scale,
                                  void* stream_ptr) {
  if (cara_qkv_attention_smem(N, dh) == 0 || n_real < 1 || n_real > N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  switch (dh) {
    case 16: return launch_dh<16>(in, o, B, N, heads, n_real, scale, stream);
    case 32: return launch_dh<32>(in, o, B, N, heads, n_real, scale, stream);
    case 64: return launch_dh<64>(in, o, B, N, heads, n_real, scale, stream);
    case 80: return launch_dh<80>(in, o, B, N, heads, n_real, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
