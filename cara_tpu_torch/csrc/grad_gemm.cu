// The GEMMs of the block backward kernels (sm_90a):
//
//   NN   C (M, N) = A (M, K)   . B (K, N)      forward recompute
//   NT   C (M, N) = A (M, K)   . B (N, K)^T    dx products g W'^T
//   TN   C (M, N) = A (K, M)^T . B (K, N)      dense cotangents dT = x^T g
//
// bf16 in, fp32 accumulation, with the epilogues the TPU kernels apply to
// each product before anything leaves VMEM:
//
//   F32       C32 = acc                                 (dxa, dT partials)
//   BF16      C16 = bf16(acc [+ bias1])                 (qkv, do)
//   PRE_GELU  C32 = pre = acc + bias1 + bias2,  C16 = bf16(gelu(pre))
//   DGELU     dpre = acc * gelu'(AUX),  C16 = bf16(dpre),  plus per-block
//             fp32 column sums of dpre (the fc1 bias cotangent)
//
// NN and NT take an optional rank step: one more BK-deep k-tile on the
// same accumulators, acc += A2 . B2, where A2 (M, 64) is the rank
// pre-pass output (bf16(x U) or bf16(g V^T), zero past the rank r) and B2
// the other rank factor, the delta scale folded in by the caller (NN:
// V (r, N); NT: U (N, r8), r8 = r rounded up to 8).  That is the TPU
// kernels' rank-space delta: _cp_dense_dx_kernel's
// g W^T + s (g V^T) U^T (cp_dense.py, row 12) and _mlp_bwd_kernel's fc1
// recompute, dh and dxa (cp_mlp.py, row 10).  The delta is never folded
// into a dense W + s U V, which would round it at W's scale.
//
// Replaces the products inside cara_tpu/ops/pallas/cp_attn_block.py
// _attn_block_bwd_wd_kernel (qkv recompute, g wp'^T, dqkv wq'^T, o^T g,
// xa^T dqkv) and cara_tpu/ops/pallas/cp_mlp.py _mlp_bwd_wd_kernel (pre
// recompute, g w2'^T with gelu', dpre w1'^T, xa^T dpre, h^T g).  The TPU
// kernels keep every intermediate of a 256-row tile in VMEM and
// accumulate dT over the sequential grid; on Hopper the grid is parallel,
// so the dT products reduce over the M = B * N token rows inside each
// block, optionally split over blockIdx.z into partial planes that the
// masked finish (wd_factor_grads.cu) sums in a fixed order: no atomics,
// runs repeat bit for bit.
//
// What bounds it: at ViT-B every product is 15-60 GFLOP against 20-80 MB,
// far above the H100's ~295 FLOP/byte ridge, so the tensor cores.  The
// design is the one of cp_site.cu: 128 x 128 x 64 block tiles, eight
// warps of 64 x 32, a three-stage cp.async ring, ldmatrix (.trans where
// the operand lies transposed in memory) and mma.sync.m16n8k16.  wgmma and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "mma_common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int PAD = 8;         // smem row pad (bf16), against bank conflicts
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (cols)
constexpr int WM = 64;
constexpr int WN = 32;
constexpr int MI = WM / 16;
constexpr int NJ = WN / 8;
constexpr int STAGES = 3;
// Every tile orientation fits BM x (BK + PAD) bf16 elements.
constexpr int TILE = BM * (BK + PAD);
static_assert(BK * (BM + PAD) <= TILE && BK * (BN + PAD) <= TILE &&
                  BN * (BK + PAD) <= TILE,
              "tile orientations must fit one stage slot");
constexpr size_t SMEM = (size_t)STAGES * 2 * TILE * 2;

enum { NN = 0, NT = 1, TN = 2 };
enum { EPI_F32 = 0, EPI_BF16 = 1, EPI_PRE_GELU = 2, EPI_DGELU = 3 };

struct GemmArgs {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  float* c32;
  __nv_bfloat16* c16;
  const __nv_bfloat16* bias1;
  const __nv_bfloat16* bias2;
  const float* aux;  // DGELU: the fp32 pre-activation (M, N)
  float* colpart;    // DGELU: (gridDim.y, N) column sums of dpre
  const __nv_bfloat16* a2;  // rank step (NN, NT): A2 (M, BK), or null
  const __nv_bfloat16* b2;  // NN: (r2, N); NT: (N, ldb2), r2 % 8 == 0
  int M, N, K;
  int k_split;       // contraction rows per blockIdx.z
  int r2, ldb2;      // depth of the rank step, NT row stride of B2
};

// Stage one contraction step [k0, k0 + BK) of A and B into shared memory.
// Smem orientation follows memory: A as [m][k] (NN, NT) or [k][m] (TN);
// B as [k][n] (NN, TN) or [n][k] (NT).  16-byte cp.async, zero-filled
// past the matrix edges and past kend (dimensions are multiples of 8).
template <int L>
__device__ __forceinline__ void load_stage(const GemmArgs& p,
                                           __nv_bfloat16* as,
                                           __nv_bfloat16* bs, int m0, int n0,
                                           int k0, int kend, int tid) {
  constexpr int V = BM * BK / 8 / THREADS;  // vectors per operand a thread
#pragma unroll
  for (int it = 0; it < V; ++it) {
    const int vec = tid + it * THREADS;
    if (L == TN) {
      const int row = vec / (BM / 8);
      const int col = (vec % (BM / 8)) * 8;
      const int gk = k0 + row;
      const int gm = m0 + col;
      const bool ok = gk < kend && gm < p.M;
      cp_async16(as + row * (BM + PAD) + col,
                 ok ? p.a + (size_t)gk * p.M + gm : p.a, ok);
    } else {
      const int row = vec / (BK / 8);
      const int col = (vec % (BK / 8)) * 8;
      const int gm = m0 + row;
      const int gk = k0 + col;
      const bool ok = gm < p.M && gk < kend;
      cp_async16(as + row * (BK + PAD) + col,
                 ok ? p.a + (size_t)gm * p.K + gk : p.a, ok);
    }
    if (L == NT) {
      const int row = vec / (BK / 8);
      const int col = (vec % (BK / 8)) * 8;
      const int gn = n0 + row;
      const int gk = k0 + col;
      const bool ok = gn < p.N && gk < kend;
      cp_async16(bs + row * (BK + PAD) + col,
                 ok ? p.b + (size_t)gn * p.K + gk : p.b, ok);
    } else {
      const int row = vec / (BN / 8);
      const int col = (vec % (BN / 8)) * 8;
      const int gk = k0 + row;
      const int gn = n0 + col;
      const bool ok = gk < kend && gn < p.N;
      cp_async16(bs + row * (BN + PAD) + col,
                 ok ? p.b + (size_t)gk * p.N + gn : p.b, ok);
    }
  }
}

// Stage the rank step's tiles: A2 as [m][k] (BK wide, zero past the rank
// already), B2 as [k][n] (NN, rows >= r2 zero-filled) or [n][k] (NT,
// columns >= r2 zero-filled).
template <int L>
__device__ __forceinline__ void load_rank_stage(const GemmArgs& p,
                                                __nv_bfloat16* as,
                                                __nv_bfloat16* bs, int m0,
                                                int n0, int tid) {
  constexpr int V = BM * BK / 8 / THREADS;
#pragma unroll
  for (int it = 0; it < V; ++it) {
    const int vec = tid + it * THREADS;
    {
      const int row = vec / (BK / 8);
      const int col = (vec % (BK / 8)) * 8;
      const int gm = m0 + row;
      const bool ok = gm < p.M;
      cp_async16(as + row * (BK + PAD) + col,
                 ok ? p.a2 + (size_t)gm * BK + col : p.a2, ok);
    }
    if (L == NT) {
      const int row = vec / (BK / 8);
      const int col = (vec % (BK / 8)) * 8;
      const int gn = n0 + row;
      const bool ok = gn < p.N && col < p.r2;
      cp_async16(bs + row * (BK + PAD) + col,
                 ok ? p.b2 + (size_t)gn * p.ldb2 + col : p.b2, ok);
    } else {
      const int row = vec / (BN / 8);
      const int col = (vec % (BN / 8)) * 8;
      const int gn = n0 + col;
      const bool ok = row < p.r2 && gn < p.N;
      cp_async16(bs + row * (BN + PAD) + col,
                 ok ? p.b2 + (size_t)row * p.N + gn : p.b2, ok);
    }
  }
}

// One BK-deep step of the warp's 64 x 32 tile.  The mma's A fragment is
// (m16 x k16, row): ldmatrix from [m][k], ldmatrix.trans from [k][m].  Its
// B fragment is (k16 x n8, col): ldmatrix.trans from [k][n], ldmatrix from
// [n][k].
template <int L>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][4],
                                         const __nv_bfloat16* as,
                                         const __nv_bfloat16* bs, int wr,
                                         int wc, int lane, int kmax) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    if (kk >= kmax) break;  // the rank step's all-zero k16 slices
    unsigned af[MI][4], bfr[NJ][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (L == TN)
        ldmatrix_x4_trans(
            af[i], as + (kk + (lane & 7) + (lane >> 4) * 8) * (BM + PAD) +
                       wr * WM + i * 16 + ((lane >> 3) & 1) * 8);
      else
        ldmatrix_x4(af[i], as + (wr * WM + i * 16 + (lane & 15)) * (BK + PAD) +
                               kk + (lane >> 4) * 8);
    }
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      unsigned t[4];
      if (L == NT)
        ldmatrix_x4(t, bs + (wc * WN + jj * 16 + (lane & 7) + (lane >> 4) * 8) *
                                (BK + PAD) +
                            kk + ((lane >> 3) & 1) * 8);
      else
        ldmatrix_x4_trans(
            t, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * (BN + PAD) +
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

template <int L, int E>
__global__ void __launch_bounds__(THREADS, 2)
grad_gemm_kernel(const GemmArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp >> 2;
  const int wc = warp & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.k_split;
  const int kend = min(p.K, kbeg + p.k_split);
  const int KT = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // Tile KT (when a2 is set) is the rank step.
  const bool rank = L != TN && p.a2 != nullptr;
  const int KT_ALL = KT + (rank ? 1 : 0);
  auto stage = [&](int slot, int kt) {
    __nv_bfloat16* as = sm + (2 * slot) * TILE;
    __nv_bfloat16* bs = sm + (2 * slot + 1) * TILE;
    if (kt == KT)
      load_rank_stage<L>(p, as, bs, m0, n0, tid);
    else
      load_stage<L>(p, as, bs, m0, n0, kbeg + kt * BK, kend, tid);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT_ALL) stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT_ALL; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // Refill the slot consumed in the previous iteration: every warp is
    // past that iteration's products (barrier above).
    const int nk = kt + STAGES - 1;
    if (nk < KT_ALL) stage(nk % STAGES, nk);
    cp_async_commit();
    const int st = kt % STAGES;
    warp_mma<L>(acc, sm + (2 * st) * TILE, sm + (2 * st + 1) * TILE, wr, wc,
                lane, kt < KT ? BK : p.r2);
  }
  cp_async_wait<0>();

  // Epilogue from the registers: thread (g, t) holds rows g and g + 8,
  // columns 2t and 2t + 1 of every 16x8 accumulator tile.
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  float* c32 = p.c32;
  if (E == EPI_F32) c32 += (size_t)blockIdx.z * p.M * p.N;
  float colp[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) colp[j][0] = colp[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wr * WM + i * 16 + g + half * 8;
      if (gm >= p.M) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int gn = n0 + wc * WN + j * 8 + t2;
        if (gn >= p.N) continue;
        const size_t off = (size_t)gm * p.N + gn;
        float y0 = acc[i][j][half * 2];
        float y1 = acc[i][j][half * 2 + 1];
        if (E == EPI_F32) {
          *reinterpret_cast<float2*>(c32 + off) = make_float2(y0, y1);
        } else if (E == EPI_BF16) {
          if (p.bias1) {
            const float2 bb = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p.bias1 + gn));
            y0 += bb.x;
            y1 += bb.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(p.c16 + off) =
              __floats2bfloat162_rn(y0, y1);
        } else if (E == EPI_PRE_GELU) {
          const float2 b1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.bias1 + gn));
          const float2 b2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.bias2 + gn));
          y0 = y0 + b1.x + b2.x;
          y1 = y1 + b1.y + b2.y;
          *reinterpret_cast<float2*>(p.c32 + off) = make_float2(y0, y1);
          *reinterpret_cast<__nv_bfloat162*>(p.c16 + off) =
              __floats2bfloat162_rn(gelu(y0), gelu(y1));
        } else {  // EPI_DGELU
          const float2 pre = *reinterpret_cast<const float2*>(p.aux + off);
          y0 *= gelu_grad(pre.x);
          y1 *= gelu_grad(pre.y);
          *reinterpret_cast<__nv_bfloat162*>(p.c16 + off) =
              __floats2bfloat162_rn(y0, y1);
          colp[j][0] += y0;
          colp[j][1] += y1;
        }
      }
    }
  }
  if (E == EPI_DGELU) {
    // Column sums of this block's dpre rows, in a fixed order: over the
    // thread's rows, across the 8 lanes of a column (shuffles), then the
    // two warp rows through shared memory.
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = colp[j][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        colp[j][c] = v;
      }
    __syncthreads();  // every warp is done with the ring's shared memory
    float* red = reinterpret_cast<float*>(smem);  // [2][BN]
    if (g == 0)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          red[wr * BN + wc * WN + j * 8 + t2 + c] = colp[j][c];
    __syncthreads();
    if (tid < BN && n0 + tid < p.N)
      p.colpart[(size_t)blockIdx.y * p.N + n0 + tid] = red[tid] + red[BN + tid];
  }
}

template <int L, int E>
int launch(const GemmArgs& p, int splits, cudaStream_t stream) {
  // Set once: the attribute is per process (one device per process).
  static const cudaError_t attr = cudaFuncSetAttribute(
      grad_gemm_kernel<L, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  grad_gemm_kernel<L, E><<<grid, THREADS, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C = op(A) . op(B) [+ A2 . B2] with the given layout (0 NN, 1 NT,
// 2 TN) and epilogue (0 F32, 1 BF16, 2 PRE_GELU, 3 DGELU); see the head
// comment for the operand shapes.  `splits` > 1 (TN, F32 only) writes
// `splits` partial (M, N) planes, each over a contiguous range of the
// contraction.  a2 (NN, NT only, null for none) adds the rank step of
// depth r2 <= 64 (a multiple of 8 for NT, with B2's row stride ldb2).
// Needs M (TN), N and K (NN, NT) multiples of 8 and 16-byte aligned
// pointers; the wrapper checks.  Returns cudaGetLastError().
extern "C" int cara_grad_gemm(int layout, int epi, const void* a,
                              const void* b, void* c32, void* c16,
                              const void* bias1, const void* bias2,
                              const void* aux, void* colpart, const void* a2,
                              const void* b2, int M, int N, int K,
                              int splits, int r2, int ldb2,
                              void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  GemmArgs p;
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.c32 = static_cast<float*>(c32);
  p.c16 = static_cast<__nv_bfloat16*>(c16);
  p.bias1 = static_cast<const __nv_bfloat16*>(bias1);
  p.bias2 = static_cast<const __nv_bfloat16*>(bias2);
  p.aux = static_cast<const float*>(aux);
  p.colpart = static_cast<float*>(colpart);
  p.a2 = static_cast<const __nv_bfloat16*>(a2);
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.M = M;
  p.N = N;
  p.K = K;
  p.r2 = r2;
  p.ldb2 = ldb2;
  if (splits < 1 || (splits > 1 && !(layout == TN && epi == EPI_F32)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a2 != nullptr &&
      (layout == TN || b2 == nullptr || r2 < 1 || r2 > BK ||
       (layout == NT && (r2 % 8 || ldb2 < r2 || ldb2 % 8))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (K + splits - 1) / splits;
  p.k_split = splits > 1 ? (per + BK - 1) / BK * BK : K;
  if (layout == NN && epi == EPI_BF16) return launch<NN, EPI_BF16>(p, 1, stream);
  if (layout == NN && epi == EPI_PRE_GELU)
    return launch<NN, EPI_PRE_GELU>(p, 1, stream);
  if (layout == NT && epi == EPI_BF16) return launch<NT, EPI_BF16>(p, 1, stream);
  if (layout == NT && epi == EPI_F32) return launch<NT, EPI_F32>(p, 1, stream);
  if (layout == NT && epi == EPI_DGELU)
    return launch<NT, EPI_DGELU>(p, 1, stream);
  if (layout == TN && epi == EPI_F32)
    return launch<TN, EPI_F32>(p, splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
