// Layout-native softmax-attention backward for Hopper (sm_90a).
//
// Reads the qkv activation (B, N, 3E) and the output cotangent do
// (B, N, E) as they lie (out-flat (3, H, Dh) columns, as
// qkv_attention.cu's forward) and writes dqkv (B, N, 3E) in the same
// layout: no transposes on either side.
//
// Replaces the per-head math attn_bwd_tile
// (cara_tpu/ops/pallas/fused_qkv_attention.py), which the attention-block
// backward _attn_block_bwd_wd_kernel (cp_attn_block.py) runs on its
// resident (bb, NP, 3E) tile.  Rounding points kept: qs = bf16(q * scale);
// fp32 scores, keys >= n_real masked; p normalized in fp32 (full-row max,
// then exp and sum); pb = bf16(p); dv = pb^T do; dp = do v^T in fp32;
// ds = bf16(p * (dp - rowsum(dp * p))); dq = (ds k) * scale; dk = ds^T qs;
// each of dq, dk, dv rounded to bf16.
//
// One block per (image, head): that head's qs, k, v and do rows sit in
// shared memory (4 x 208 x 72 x 2 B = 117 KB at ViT-B; row pads against
// bank conflicts) and no (N, N) tile is ever stored.  Phase A, query tiles
// of 16 rows per warp: the row max, then exp / sum / sum(ex * dp) for the
// row statistics (kept in shared memory), then ds tiles and dq = ds k on
// the tensor cores.  Phase B, key tiles per warp: the transposed tiles
// s^T = k qs^T and dp^T = v do^T give pb^T and ds^T from the stored
// statistics, and dv = pb^T do, dk = ds^T qs accumulate in registers, so
// no reduction crosses warps or blocks.  At ViT-B the call moves ~155 MB
// and does ~30 GFLOP of 16x16 wmma products: it is bound by latency (the
// fp32 passes through per-warp scratch tiles), like the forward kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // H100: 227 KB per block (opt-in)
constexpr int kWarps = 8;
constexpr int kPad = 8;
constexpr int kScratch = 3072;    // per warp: 2 fp32 and 2 bf16 16x16 tiles

__host__ __device__ inline size_t align128(size_t v) {
  return (v + 127) & ~size_t(127);
}

struct Layout {
  size_t q, k, v, o, stats, scratch, total;
};

__host__ __device__ inline Layout make_layout(int npp, int dh) {
  const size_t mat = align128((size_t)npp * (dh + kPad) * 2);
  Layout L;
  L.q = 0;
  L.k = mat;
  L.v = 2 * mat;
  L.o = 3 * mat;
  L.stats = 4 * mat;
  L.scratch = L.stats + align128((size_t)3 * npp * 4);
  L.total = L.scratch + (size_t)kWarps * kScratch;
  return L;
}

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc = A (16 rows of a, DH wide) . B^T (16 rows of b): a score-like tile.
template <int DH>
__device__ __forceinline__ void tile_abt(FragAcc& acc, const __nv_bfloat16* a,
                                         const __nv_bfloat16* b) {
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int dc = 0; dc < DH / 16; ++dc) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::col_major> fb;
    wmma::load_matrix_sync(fa, a + dc * 16, DH + kPad);
    wmma::load_matrix_sync(fb, b + dc * 16, DH + kPad);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// acc[dc] += T (16x16 bf16 tile, ld 16) . rows (16 rows of b, DH wide).
template <int DH>
__device__ __forceinline__ void tile_acc(FragAcc (&acc)[DH / 16],
                                         const __nv_bfloat16* t,
                                         const __nv_bfloat16* rows) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fa;
  wmma::load_matrix_sync(fa, t, 16);
#pragma unroll
  for (int dc = 0; dc < DH / 16; ++dc) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fb;
    wmma::load_matrix_sync(fb, rows + dc * 16, DH + kPad);
    wmma::mma_sync(acc[dc], fa, fb, acc[dc]);
  }
}

// Row lane/2, columns (lane&1)*8 .. +8 of a row-major 16x16 fp32 tile.
__device__ __forceinline__ void load8(float* v, const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Write a 16 x DH accumulator (times `mul`) as bf16 rows row0.. of column
// block `col` of dqkv; rows >= N are skipped.
template <int DH>
__device__ __forceinline__ void store_rows(FragAcc (&acc)[DH / 16], float* s,
                                           __nv_bfloat16* dst, int row0,
                                           int N, size_t row_stride,
                                           float mul, int lane) {
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
#pragma unroll
  for (int dc = 0; dc < DH / 16; ++dc) {
    wmma::store_matrix_sync(s, acc[dc], 16, wmma::mem_row_major);
    __syncwarp();
    if (row0 + er < N) {
      float v[8];
      load8(v, s + lane * 8);
      uint4 packed;
      __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int t = 0; t < 8; ++t) pe[t] = __float2bfloat16(v[t] * mul);
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + er) * row_stride +
                                dc * 16 + ec) = packed;
    }
    __syncwarp();
  }
}

template <int DH>
__global__ void __launch_bounds__(32 * kWarps)
qkv_attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ dout,
                         __nv_bfloat16* __restrict__ dqkv, int N, int heads,
                         int n_real, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int npp = (N + 15) & ~15;
  const Layout lay = make_layout(npp, DH);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + lay.k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + lay.v);
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(smem + lay.o);
  float* m_s = reinterpret_cast<float*>(smem + lay.stats);
  float* il_s = m_s + npp;
  float* d_s = il_s + npp;

  const int e = heads * DH;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t rs3 = 3 * (size_t)e;
  const __nv_bfloat16* base = qkv + (size_t)b * N * rs3 + h * DH;
  const __nv_bfloat16* obase = dout + (size_t)b * N * e + h * DH;
  __nv_bfloat16* dbase = dqkv + (size_t)b * N * rs3 + h * DH;
  constexpr int VPR = DH / 8;
  constexpr int LD = DH + kPad;

  for (int idx = tid; idx < npp * VPR; idx += blockDim.x) {
    const int row = idx / VPR;
    const int c = (idx % VPR) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (row < N) {
      const __nv_bfloat16* r = base + row * rs3 + c;
      const unsigned sk = static_cast<unsigned>(
          __cvta_generic_to_shared(Ks + row * LD + c));
      const unsigned sv = static_cast<unsigned>(
          __cvta_generic_to_shared(Vs + row * LD + c));
      const unsigned so = static_cast<unsigned>(
          __cvta_generic_to_shared(Os + row * LD + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sk),
                   "l"(r + e));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sv),
                   "l"(r + 2 * e));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(so),
                   "l"(obase + (size_t)row * e + c));
      qv = *reinterpret_cast<const uint4*>(r);
      __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(&qv);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        el[t] = __float2bfloat16(__bfloat162float(el[t]) * scale);
    } else {
      const uint4 z = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(Ks + row * LD + c) = z;
      *reinterpret_cast<uint4*>(Vs + row * LD + c) = z;
      *reinterpret_cast<uint4*>(Os + row * LD + c) = z;
    }
    *reinterpret_cast<uint4*>(Qs + row * LD + c) = qv;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
  const int ntiles = npp / 16;
  float* S = reinterpret_cast<float*>(smem + lay.scratch + warp * kScratch);
  float* DP = S + 256;
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(DP + 256);
  __nv_bfloat16* DS = P + 256;
  FragAcc acc, acc2;

  // Phase A: query tiles.  Row statistics, then dq.
  for (int qt = warp; qt < ntiles; qt += kWarps) {
    const __nv_bfloat16* Qw = Qs + qt * 16 * LD;
    const __nv_bfloat16* Ow = Os + qt * 16 * LD;
    float m = kNegInf;
    for (int kt = 0; kt < ntiles; ++kt) {
      tile_abt<DH>(acc, Qw, Ks + kt * 16 * LD);
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
    float l = 0.f, sd = 0.f;
    for (int kt = 0; kt < ntiles; ++kt) {
      tile_abt<DH>(acc, Qw, Ks + kt * 16 * LD);
      tile_abt<DH>(acc2, Ow, Vs + kt * 16 * LD);
      wmma::store_matrix_sync(S, acc, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(DP, acc2, 16, wmma::mem_row_major);
      __syncwarp();
      float sv[8], dv[8];
      load8(sv, S + lane * 8);
      load8(dv, DP + lane * 8);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float ex =
            kt * 16 + ec + t < n_real ? expf(sv[t] - m) : 0.f;
        l += ex;
        sd += ex * dv[t];
      }
      __syncwarp();
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    sd += __shfl_xor_sync(0xffffffffu, sd, 1);
    const float il = 1.f / l;
    const float D = sd * il;  // rowsum(dp * p)
    if ((lane & 1) == 0) {
      const int q = qt * 16 + er;
      m_s[q] = m;
      il_s[q] = il;
      d_s[q] = D;
    }
    FragAcc dq[DH / 16];
#pragma unroll
    for (int dc = 0; dc < DH / 16; ++dc) wmma::fill_fragment(dq[dc], 0.f);
    for (int kt = 0; kt < ntiles; ++kt) {
      tile_abt<DH>(acc, Qw, Ks + kt * 16 * LD);
      tile_abt<DH>(acc2, Ow, Vs + kt * 16 * LD);
      wmma::store_matrix_sync(S, acc, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(DP, acc2, 16, wmma::mem_row_major);
      __syncwarp();
      float sv[8], dv[8];
      load8(sv, S + lane * 8);
      load8(dv, DP + lane * 8);
      uint4 packed;
      __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float p =
            kt * 16 + ec + t < n_real ? expf(sv[t] - m) * il : 0.f;
        pe[t] = __float2bfloat16(p * (dv[t] - D));
      }
      *reinterpret_cast<uint4*>(DS + er * 16 + ec) = packed;
      __syncwarp();
      tile_acc<DH>(dq, DS, Ks + kt * 16 * LD);
      __syncwarp();
    }
    store_rows<DH>(dq, S, dbase, qt * 16, N, rs3, scale, lane);
  }
  __syncthreads();  // row statistics of every query are in shared memory

  // Phase B: key tiles.  dv = pb^T do and dk = ds^T qs.
  for (int kt = warp; kt < ntiles; kt += kWarps) {
    const __nv_bfloat16* Kw = Ks + kt * 16 * LD;
    const __nv_bfloat16* Vw = Vs + kt * 16 * LD;
    const bool kvalid = kt * 16 + er < n_real;
    FragAcc dk[DH / 16], dv[DH / 16];
#pragma unroll
    for (int dc = 0; dc < DH / 16; ++dc) {
      wmma::fill_fragment(dk[dc], 0.f);
      wmma::fill_fragment(dv[dc], 0.f);
    }
    for (int qt = 0; qt < ntiles; ++qt) {
      tile_abt<DH>(acc, Kw, Qs + qt * 16 * LD);
      tile_abt<DH>(acc2, Vw, Os + qt * 16 * LD);
      wmma::store_matrix_sync(S, acc, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(DP, acc2, 16, wmma::mem_row_major);
      __syncwarp();
      float sv[8], dpv[8];
      load8(sv, S + lane * 8);
      load8(dpv, DP + lane * 8);
      uint4 pp, dd;
      __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&pp);
      __nv_bfloat16* de = reinterpret_cast<__nv_bfloat16*>(&dd);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int q = qt * 16 + ec + t;
        const float p =
            kvalid && q < N ? expf(sv[t] - m_s[q]) * il_s[q] : 0.f;
        pe[t] = __float2bfloat16(p);
        de[t] = __float2bfloat16(p * (dpv[t] - d_s[q]));
      }
      *reinterpret_cast<uint4*>(P + er * 16 + ec) = pp;
      *reinterpret_cast<uint4*>(DS + er * 16 + ec) = dd;
      __syncwarp();
      tile_acc<DH>(dv, P, Os + qt * 16 * LD);
      tile_acc<DH>(dk, DS, Qs + qt * 16 * LD);
      __syncwarp();
    }
    store_rows<DH>(dk, S, dbase + e, kt * 16, N, rs3, 1.f, lane);
    store_rows<DH>(dv, S, dbase + 2 * e, kt * 16, N, rs3, 1.f, lane);
  }
}

template <int DH>
int launch(const __nv_bfloat16* qkv, const __nv_bfloat16* dout,
           __nv_bfloat16* dqkv, int B, int N, int heads, int n_real,
           float scale, cudaStream_t stream) {
  const size_t smem = make_layout((N + 15) & ~15, DH).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      qkv_attention_bwd_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(heads, B);
  qkv_attention_bwd_kernel<DH><<<grid, 32 * kWarps, smem, stream>>>(
      qkv, dout, dqkv, N, heads, n_real, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block needs (0 when it does not fit).
extern "C" int cara_qkv_attention_bwd_smem(int N, int dh) {
  const size_t smem = make_layout((N + 15) & ~15, dh).total;
  return smem > kMaxSmem ? 0 : static_cast<int>(smem);
}

// qkv (B, N, 3E), do (B, N, E) bf16 -> dqkv (B, N, 3E) bf16, keys >=
// n_real masked.  dh must be 16, 32 or 64.  Returns cudaGetLastError().
extern "C" int cara_qkv_attention_bwd(const void* qkv, const void* dout,
                                      void* dqkv, int B, int N, int heads,
                                      int dh, int n_real, float scale,
                                      void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(qkv);
  const __nv_bfloat16* go = static_cast<const __nv_bfloat16*>(dout);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dqkv);
  switch (dh) {
    case 16: return launch<16>(in, go, out, B, N, heads, n_real, scale, stream);
    case 32: return launch<32>(in, go, out, B, N, heads, n_real, scale, stream);
    case 64: return launch<64>(in, go, out, B, N, heads, n_real, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
