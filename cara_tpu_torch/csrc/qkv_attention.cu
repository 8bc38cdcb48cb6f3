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
//     the exponentials, the sum and P V.
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
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int slabs(int rows) {
  return (rows + kSlab - 1) / kSlab;
}

// Rows of one item in shared memory: Q (the query tiles), then K and V
// (each `nch` chunks of the chunk width rounded up to 16, in 64-row slabs).
struct Plan {
  int nch, q_slabs, kv_slabs;  // kv_slabs: per chunk
  __host__ __device__ int rows() const {
    return (q_slabs + 2 * nch * kv_slabs) * kSlab;
  }
};

__host__ __device__ inline Plan make_plan(int N, int nk) {
  Plan p;
  p.nch = N > nk ? 2 : 1;
  p.q_slabs = slabs(N);
  p.kv_slabs = slabs((nk + 15) & ~15);
  return p;
}

__host__ __device__ inline int chunk_width(int N) {
  return N <= 64 ? 64 : N <= 128 ? 128 : N <= 200 ? 200 : 256;
}

// S (64 x NK) = Q tile . K chunk^T, fp32 in the accumulator layout.
template <int DH, int NK>
__device__ __forceinline__ void scores(float (&s)[NK / 2],
                                       const __nv_bfloat16* qt,
                                       const __nv_bfloat16* kc) {
  constexpr int RB = DH * 2;
  const uint64_t dq = desc<RB>(qt), dk = desc<RB>(kc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<NK, 0, 0>(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
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
  constexpr int RB = DH * 2;
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
    wgmma_rs<DH, 1>(o, pa[kk], desc<RB>(vc + kk * 16 * DH), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// Q, K and V of item (b, h) into one slot: q_slabs boxes of Q, then per
// chunk kv_slabs boxes of K and of V, all counted on `bar`.
template <int DH>
__device__ __forceinline__ void load_item(const CUtensorMap* map,
                                          uint64_t* bar, __nv_bfloat16* dst,
                                          const Plan& pl, int nk, int b,
                                          int h, int heads) {
  const int e = heads * DH;
  mbar_expect_tx(bar, (uint32_t)pl.rows() * DH * 2);
  __nv_bfloat16* p = dst;
  for (int s = 0; s < pl.q_slabs; ++s, p += kSlab * DH)
    tma_load_3d(p, map, bar, h * DH, s * kSlab, b);
  for (int part = 1; part <= 2; ++part)  // K, then V
    for (int c = 0; c < pl.nch; ++c)
      for (int s = 0; s < pl.kv_slabs; ++s, p += kSlab * DH)
        tma_load_3d(p, map, bar, part * e + h * DH, c * nk + s * kSlab, b);
}

template <int DH, int NK>
__global__ void __launch_bounds__(kThreads, 1)
qkv_attention_kernel(const __grid_constant__ CUtensorMap map,
                     const __grid_constant__ CUtensorMap omap, int B, int N,
                     int heads, int n_real, float scale, int prescale,
                     int slots) {
  constexpr int RB = DH * 2;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles want 1024-byte alignment; the barriers sit in front.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem + 1024);

  const Plan pl = make_plan(N, NK);
  const int slot_elems = pl.rows() * DH;
  const int items = B * heads;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ntq = pl.q_slabs;
  // The scale still to apply to the scores: none after the pre-scaled q.
  const float sc = prescale ? 1.f : scale;

  if (tid == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < slots; ++s) {
      const int it = blockIdx.x + s * gridDim.x;
      if (it < items)
        load_item<DH>(&map, &full[s], tiles + s * slot_elems, pl, NK,
                      it / heads, it % heads, heads);
    }

  int k = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++k) {
    const int slot = k % slots;
    const int b = it / heads;
    const int h = it % heads;
    mbar_wait(&full[slot], (k / slots) & 1);
    __nv_bfloat16* qs = tiles + slot * slot_elems;
    const __nv_bfloat16* ks = qs + pl.q_slabs * kSlab * DH;
    const __nv_bfloat16* vs = ks + pl.nch * pl.kv_slabs * kSlab * DH;
    const int kc_elems = pl.kv_slabs * kSlab * DH;

    for (int qt = wg; qt < ntq; qt += 2) {
      __nv_bfloat16* qtile = qs + qt * kSlab * DH;
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
          for (int j = 0; j < 8; ++j)
            el[j] = __float2bfloat16(__bfloat162float(el[j]) * scale);
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
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<uint32_t*>(
              ot + swizzle<RB>(row * RB + (8 * j + 2 * t) * 2)) =
              pack_bf16(o[4 * j + 2 * r] * inv[r],
                        o[4 * j + 2 * r + 1] * inv[r]);
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (wtid == 0) tma_store_3d(&omap, qtile, h * DH, qt * kSlab, b);
    }
    if (wtid == 0) bulk_wait_read();  // the stores have read their tiles
    __syncthreads();  // every read of this slot is done: refill it
    if (tid == 0) {
      const int next = it + slots * gridDim.x;
      if (next < items)
        load_item<DH>(&map, &full[slot], qs, pl, NK, next / heads,
                      next % heads, heads);
    }
  }
  if (wtid == 0) bulk_wait();
}

// Shared-memory bytes of one block with `slots` slots at (N, dh).
size_t smem_bytes(int N, int dh, int slots) {
  const Plan pl = make_plan(N, chunk_width(N));
  // 1024 bytes of alignment slack and 1024 for the barriers.
  return 2048 + (size_t)slots * pl.rows() * dh * 2;
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
  CUtensorMap map, omap;
  const uint64_t dims[3] = {3 * e, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {3 * e * 2, 3 * e * 2 * N};
  const uint64_t odims[3] = {e, (uint64_t)N, (uint64_t)B};
  const uint64_t ostrides[2] = {e * 2, e * 2 * N};
  const uint32_t box[3] = {DH, kSlab, 1};
  int enc = encode_map(&map, qkv, 3, dims, strides, box);
  if (enc == 0) enc = encode_map(&omap, out, 3, odims, ostrides, box);
  if (enc != 0) return enc;
  int ex;
  const int prescale = frexpf(scale, &ex) != 0.5f;  // not a power of two
  const int items = B * heads;
  const int grid = items < sm_count() ? items : sm_count();
  qkv_attention_kernel<DH, NK><<<grid, kThreads, smem, stream>>>(
      map, omap, B, N, heads, n_real, scale, prescale, slots);
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
// dh must be 16, 32 or 64, N at most 512; qkv 16-byte aligned.  Returns
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
