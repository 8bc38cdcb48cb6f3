// Dense CaRA site for Hopper (sm_90a):
//
//   out = epi( pro(x) @ W + b + s * ((pro(x) @ U) @ V + cb) )
//
// x (M, K), W (K, N), U (K, r), V (r, N), out (M, N); bf16 in and out,
// fp32 accumulation.  pro is an optional LayerNorm (row statistics from a
// small pass, applied while A tiles are loaded; the normalized row is
// rounded to bf16 as the TPU kernel's _ln_rows does).  epi is an optional
// exact-erf GELU and an optional residual  x_res + dpm[row] * y.
//
// Replaces the dense parts of the TPU megakernels
// cara_tpu/ops/pallas/cp_attn_block.py (_attn_block_fwd_kernel, the qkv
// and proj sites) and cara_tpu/ops/pallas/cp_mlp.py (_mlp_fwd_kernel, the
// fc1 and fc2 sites).  Those hold a whole image (or 256 rows) plus every
// weight in up to 100 MB of VMEM; a Hopper block has 227 KB of shared
// memory, so here each site is a tiled GEMM of its own and the qkv tensor
// and the (M, 4E) hidden make a round trip through device memory.  At
// ViT-B (M = 64*197, K = 768, N = 2304 or 3072) every site is bound by the
// tensor cores, not by bytes (~300 FLOP per byte), so the first version
// puts its effort in the GEMM: 128x128x64 block tiles, eight warps of
// 64x32 each, ldmatrix + mma.sync.m16n8k16 (bf16 in, fp32 accumulate), a
// three-stage cp.async ring so that loads overlap the products, two blocks
// per SM.  Still to come: TMA, wgmma, and fusing the sites back together.
//
// The rank-r product z = pro(x) @ U comes from a pre-pass (a skinny
// tensor-core GEMM) and is rounded to bf16 before @V, as the TPU kernel does
// (cp_attn_block.py:98-100, cp_mlp.py:91-93); the GEMM then adds z @ V
// as one more tensor-core step on its accumulators.  The rank is the true
// rank (zero-padded to the 64-deep k step inside the block): the TPU's
// padding of r to 128 lanes is not ported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int A_LD = BK + 8;   // padded smem strides (multiples of 8)
constexpr int B_LD = BN + 8;
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (cols)
constexpr int WM = 64;         // warp tile 64 x 32
constexpr int WN = 32;

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One warp per row: mean and 1/sqrt(var + eps) in fp32 (two passes over
// the row, as _ln_rows computes mean(square(x - mu))).
__global__ void row_stats_kernel(const __nv_bfloat16* __restrict__ x,
                                 float* __restrict__ mean,
                                 float* __restrict__ rstd, int M, int K,
                                 float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const __nv_bfloat16* xr = x + (size_t)row * K;
  float sum = 0.f;
  for (int k = lane; k < K; k += 32) sum += bf(xr[k]);
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mu = sum / K;
  float sq = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = bf(xr[k]) - mu;
    sq += d * d;
  }
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rsqrtf(sq / K + eps);
  }
}

// LayerNorm of eight bf16 values in place: normalize in fp32 with the
// row's statistics, apply the scale and bias (eight each, 16-byte loaded
// by the caller), round to bf16 like the TPU kernel's xa.
__device__ __forceinline__ void ln8(uint4& raw, float mu, float rs,
                                    const uint4& lsv, const uint4& lbv) {
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
  const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(&lsv);
  const __nv_bfloat16* bi = reinterpret_cast<const __nv_bfloat16*>(&lbv);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    e[q] = __float2bfloat16((bf(e[q]) - mu) * rs * bf(sc[q]) + bf(bi[q]));
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

struct SiteArgs {
  const __nv_bfloat16* x;
  const float* mean;
  const float* rstd;
  const __nv_bfloat16* ls;
  const __nv_bfloat16* lb;
  const __nv_bfloat16* w;
  const __nv_bfloat16* b;
  const __nv_bfloat16* z;
  const __nv_bfloat16* v;
  const __nv_bfloat16* cb;
  const __nv_bfloat16* res;
  const float* dpm;
  __nv_bfloat16* out;
  int M, K, N, r;
  int has_ln, act, has_res;
  float s;
};

// z = bf16( pro(x) @ U ): a skinny GEMM (N = r) on the tensor cores.
// Each block takes ZBM rows and walks K in ZBK-wide chunks; each of its
// two warps owns 16 rows and RP/16 accumulator fragments (RP = r rounded
// up to 16; the padding columns of U are zero in shared memory).  It
// reads x once, so it is bound by that read.
constexpr int ZBM = 32;
constexpr int ZW = 64;  // width of the z buffer = the GEMM's k step
constexpr int ZBK = 128;
constexpr int ZA_LD = ZBK + 8;
constexpr int ZTHREADS = 64;

template <int RP>
__global__ void __launch_bounds__(ZTHREADS)
site_z_kernel(const SiteArgs p, const __nv_bfloat16* __restrict__ u,
              __nv_bfloat16* __restrict__ z) {
  constexpr int ULD = RP + 8;
  __shared__ __align__(128) __nv_bfloat16 As[ZBM * ZA_LD];
  __shared__ __align__(128) __nv_bfloat16 Us[ZBK * ULD];
  __shared__ __align__(128) float Zs[ZTHREADS / 32][256];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * ZBM;
  constexpr int VA = ZBM * ZBK / 8 / ZTHREADS;  // 16-byte vectors a thread

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RP / 16];
#pragma unroll
  for (int f = 0; f < RP / 16; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int idx = tid; idx < ZBK * RP; idx += ZTHREADS)
    Us[(idx / RP) * ULD + idx % RP] = __float2bfloat16(0.f);
  __syncthreads();  // the zeros land before any thread scatters U

  for (int k0 = 0; k0 < p.K; k0 += ZBK) {
    const int kw = min(ZBK, p.K - k0);  // K % 64 == 0
    uint4 raw[VA];
#pragma unroll
    for (int it = 0; it < VA; ++it) {
      const int vec = tid + it * ZTHREADS;
      const int row = vec / (ZBK / 8);
      const int col = (vec % (ZBK / 8)) * 8;
      const int gm = m0 + row;
      raw[it] = make_uint4(0, 0, 0, 0);
      if (gm < p.M && col < kw)
        raw[it] = *reinterpret_cast<const uint4*>(p.x + (size_t)gm * p.K +
                                                  k0 + col);
    }
    // Every vector of this thread has the same columns (ZTHREADS is a
    // multiple of ZBK / 8): one 16-byte load each of LN scale and bias.
    const int zcol = (tid % (ZBK / 8)) * 8;
    uint4 lsv = make_uint4(0, 0, 0, 0), lbv = lsv;
    if (p.has_ln && zcol < kw) {
      lsv = load16(p.ls + k0 + zcol);
      lbv = load16(p.lb + k0 + zcol);
    }
#pragma unroll
    for (int it = 0; it < VA; ++it) {
      const int row = (tid + it * ZTHREADS) / (ZBK / 8);
      const int gm = m0 + row;
      if (p.has_ln && gm < p.M && zcol < kw)
        ln8(raw[it], p.mean[gm], p.rstd[gm], lsv, lbv);
      *reinterpret_cast<uint4*>(&As[row * ZA_LD + zcol]) = raw[it];
    }
    // U rows k0 .. k0+kw are kw*r contiguous values (a multiple of 8):
    // 16-byte loads, scattered into the (kk, j) layout; the padding
    // columns j >= r were zeroed before the loop.
    for (int v = tid; v < kw * p.r / 8; v += ZTHREADS) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          u + (size_t)k0 * p.r + v * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int flat = v * 8 + q;
        Us[(flat / p.r) * ULD + flat % p.r] = e[q];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < ZBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + warp * 16 * ZA_LD + kk, ZA_LD);
#pragma unroll
      for (int f = 0; f < RP / 16; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Us + kk * ULD + f * 16, ULD);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
    __syncthreads();
  }
  // z is written ZW columns wide (zeros past r), so the GEMM loads its
  // delta k-tile like any other A tile.
  float* zs = Zs[warp];
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
  const int gm = m0 + warp * 16 + er;
  __nv_bfloat16* zrow = z + (size_t)gm * ZW;
#pragma unroll
  for (int f = 0; f < RP / 16; ++f) {
    wmma::store_matrix_sync(zs, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    if (gm < p.M) {
      uint4 packed;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        e[t] = __float2bfloat16(zs[er * 16 + ec + t]);
      *reinterpret_cast<uint4*>(zrow + f * 16 + ec) = packed;
    }
    __syncwarp();
  }
  if (gm < p.M)
    for (int c = RP + ec; c < ZW; c += 16)
      *reinterpret_cast<uint4*>(zrow + c) = make_uint4(0, 0, 0, 0);
}

constexpr int STAGES = 3;
constexpr size_t A_STAGE = (size_t)BM * A_LD;  // bf16 elements
constexpr size_t B_STAGE = (size_t)BK * B_LD;
constexpr size_t GEMM_SMEM = STAGES * (A_STAGE + B_STAGE) * 2;
static_assert(THREADS % (BK / 8) == 0 && ZTHREADS % (ZBK / 8) == 0,
              "a thread's A vectors must share their columns");
static_assert(ZW == BK, "the delta k-tile reads z as one A tile");

// 16-byte cp.async; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// D = A (16x16, row) * B (16x8, col) + D; bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float* c, const unsigned* a,
                                          const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int MI = WM / 16;  // m16 tiles per warp
constexpr int NJ = WN / 8;   // n8 tiles per warp

// One BK-deep step of the warp's 64x32 tile: A fragments by ldmatrix,
// B fragments by ldmatrix.trans from the row-major (k, n) tile, then
// MI x NJ mma.sync.m16n8k16.  `kmax` skips k16 halves that are all zero.
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][4],
                                         const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int wr,
                                         int wc, int lane, int kmax) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    if (kk >= kmax) break;
    unsigned af[MI][4], bfr[NJ][2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      ldmatrix_x4(af[i], a + (wr * WM + i * 16 + (lane & 15)) * A_LD + kk +
                             (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      unsigned t[4];
      ldmatrix_x4_trans(t, b + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   B_LD +
                               wc * WN + jj * 16 + (lane >> 4) * 8);
      bfr[2 * jj][0] = t[0];
      bfr[2 * jj][1] = t[1];
      bfr[2 * jj + 1][0] = t[2];
      bfr[2 * jj + 1][1] = t[3];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_16816(acc[i][j], af[i], bfr[j]);
  }
}

// Main loop: a STAGES-deep ring of (A, B) tiles filled by cp.async, so the
// loads of the next STAGES-1 tiles overlap the products on this one.  For
// an LN site the raw A tile is normalized in shared memory when it lands (the
// row statistics come from row_stats_kernel), then rounded to bf16.  The
// rank-r delta z @ V is one more k-tile of the same ring and the same
// accumulators (z and V zero-padded to BK), so the epilogue adds only b,
// cb, GELU and the residual, straight from the mma registers.
__global__ void __launch_bounds__(THREADS, 2)
site_gemm_kernel(const SiteArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp >> 2;  // 0..1
  const int wc = warp & 3;   // 0..3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KT = p.K / BK;

  // Tile kt < KT: A = x[:, kt*BK:], B = W[kt*BK:, :].  Tile KT (when
  // r > 0) is the rank-r delta: A = z (ZW = BK columns, zero past r),
  // B = V rows, zero-filled past r.  All loads are 16-byte cp.async
  // (zero-filled past M and N; N is a multiple of 8).
  constexpr int VA = BM * BK / 8 / THREADS;
  constexpr int VB = BK * BN / 8 / THREADS;
  auto load_stage = [&](int st, int kt) {
    const bool delta = kt == KT;
    const __nv_bfloat16* asrc = delta ? p.z : p.x;
    const size_t lda = delta ? ZW : p.K;
    const int k0 = delta ? 0 : kt * BK;
#pragma unroll
    for (int it = 0; it < VA; ++it) {
      const int vec = tid + it * THREADS;
      const int row = vec / (BK / 8);
      const int col = (vec % (BK / 8)) * 8;
      const int gm = m0 + row;
      const bool ok = gm < p.M;
      cp_async16(As + st * A_STAGE + row * A_LD + col,
                 ok ? asrc + gm * lda + k0 + col : asrc, ok);
    }
#pragma unroll
    for (int it = 0; it < VB; ++it) {
      const int vec = tid + it * THREADS;
      const int row = vec / (BN / 8);
      const int col = (vec % (BN / 8)) * 8;
      const int gn = n0 + col;
      const bool ok = gn < p.N && (!delta || row < p.r);
      const __nv_bfloat16* bsrc =
          delta ? p.v + (size_t)row * p.N + gn
                : p.w + (size_t)(k0 + row) * p.N + gn;
      cp_async16(Bs + st * B_STAGE + row * B_LD + col, ok ? bsrc : p.w, ok);
    }
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // LN sites: this thread's A vectors share one column range (THREADS is
  // a multiple of BK / 8); their rows' statistics are loaded once.
  const int acol = (tid % (BK / 8)) * 8;
  float row_mu[VA], row_rs[VA];
#pragma unroll
  for (int it = 0; it < VA; ++it) {
    const int gm = m0 + (tid + it * THREADS) / (BK / 8);
    const bool ok = p.has_ln && gm < p.M;
    row_mu[it] = ok ? p.mean[gm] : 0.f;
    row_rs[it] = ok ? p.rstd[gm] : 0.f;
  }

  const int KT_ALL = KT + (p.r > 0 ? 1 : 0);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT_ALL) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT_ALL; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int st = kt % STAGES;
    __nv_bfloat16* a = As + st * A_STAGE;
    if (p.has_ln && kt < KT) {
      const uint4 lsv = load16(p.ls + kt * BK + acol);
      const uint4 lbv = load16(p.lb + kt * BK + acol);
#pragma unroll
      for (int it = 0; it < VA; ++it) {
        const int row = (tid + it * THREADS) / (BK / 8);
        if (m0 + row < p.M) {
          uint4* slot = reinterpret_cast<uint4*>(a + row * A_LD + acol);
          uint4 raw = *slot;
          ln8(raw, row_mu[it], row_rs[it], lsv, lbv);
          *slot = raw;
        }
      }
      __syncthreads();
    }
    // Refill the slot consumed in the previous iteration: every thread
    // is past that iteration's products (barrier above).
    const int nk = kt + STAGES - 1;
    if (nk < KT_ALL) load_stage(nk % STAGES, nk);
    cp_async_commit();
    if (kt == KT && p.s != 1.f) {
      // acc += s * (z @ V): scale out before the delta tile, back after.
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] *= 1.f / p.s;
    }
    warp_mma(acc, a, Bs + st * B_STAGE, wr, wc, lane, kt < KT ? BK : p.r);
  }
  cp_async_wait<0>();
  if (p.r > 0 && p.s != 1.f) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= p.s;
  }

  // Epilogue from the registers: thread (g, t) holds rows g and g + 8,
  // columns 2t and 2t + 1 of every 16x8 accumulator tile.
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wr * WM + i * 16 + g + half * 8;
      if (gm >= p.M) continue;
      const float gate = p.has_res ? p.dpm[gm] : 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int gn = n0 + wc * WN + j * 8 + t2;
        if (gn >= p.N) continue;
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.b + gn));
        float y0 = acc[i][j][half * 2] + bb.x;
        float y1 = acc[i][j][half * 2 + 1] + bb.y;
        if (p.cb) {
          const float2 cc = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.cb + gn));
          y0 += p.s * cc.x;
          y1 += p.s * cc.y;
        }
        if (p.act == 1) {
          y0 = 0.5f * y0 * (1.f + erff(y0 * 0.70710678118654752f));
          y1 = 0.5f * y1 * (1.f + erff(y1 * 0.70710678118654752f));
        }
        if (p.has_res) {
          const float2 rr = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  p.res + (size_t)gm * p.N + gn));
          y0 = rr.x + gate * y0;
          y1 = rr.y + gate * y1;
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)gm * p.N + gn) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

template <int RP>
void launch_z(const SiteArgs& p, const __nv_bfloat16* u, __nv_bfloat16* z,
              cudaStream_t stream) {
  site_z_kernel<RP><<<(p.M + ZBM - 1) / ZBM, ZTHREADS, 0, stream>>>(p, u,
                                                                    z);
}

}  // namespace

// One dense site: row statistics (when has_ln), the rank-r pre-pass
// (when r > 0) and the GEMM with its epilogue, all on `stream`.
// mean/rstd are fp32 (M,) scratch, z is bf16 (M, 64) scratch.  Needs
// K % 64 == 0, N % 8 == 0, r <= 64 and 16-byte aligned pointers; the Python
// wrapper checks them.  Returns cudaGetLastError().
extern "C" int cara_cp_site(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w,
    const void* b, const void* u, const void* v, const void* cb,
    const void* res, const void* dpm, void* mean, void* rstd, void* z,
    void* out, int M, int K, int N, int r, int has_ln, int act, int has_res,
    float s, float ln_eps, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  SiteArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.ls = static_cast<const __nv_bfloat16*>(ln_scale);
  p.lb = static_cast<const __nv_bfloat16*>(ln_bias);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.z = static_cast<const __nv_bfloat16*>(z);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.cb = static_cast<const __nv_bfloat16*>(cb);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.dpm = static_cast<const float*>(dpm);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.r = r;
  p.has_ln = has_ln;
  p.act = act;
  p.has_res = has_res;
  p.s = s;
  if (has_ln) {
    const int rows_per_block = 8;
    row_stats_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                       rows_per_block * 32, 0, stream>>>(
        p.x, static_cast<float*>(mean), static_cast<float*>(rstd), M, K,
        ln_eps);
  }
  if (r > 0) {
    const __nv_bfloat16* uu = static_cast<const __nv_bfloat16*>(u);
    __nv_bfloat16* zz = static_cast<__nv_bfloat16*>(z);
    if (r <= 16) launch_z<16>(p, uu, zz, stream);
    else if (r <= 32) launch_z<32>(p, uu, zz, stream);
    else launch_z<64>(p, uu, zz, stream);
  }
  // Set once: the attribute is per process (one device per process).
  static const cudaError_t attr = cudaFuncSetAttribute(
      site_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(GEMM_SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  site_gemm_kernel<<<grid, THREADS, GEMM_SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
