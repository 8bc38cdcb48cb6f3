// Dequant-fused int8 GEMM for Hopper (sm_90a):
//
//   y = (x @ Wq) * scale + b
//
// x (M, K) bf16, Wq (K, N) int8 (per-output-channel symmetric codes of
// models/quant.py), scale (N,) and b (N,) bf16, y (M, N) bf16; fp32
// accumulation.  Inference only.
//
// Replaces cara_tpu/ops/pallas/int8_dense.py (int8_dense,
// _int8_dense_kernel), whose point is that the weight leaves device
// memory as int8, half the bytes of bf16, and is converted to the compute
// dtype only inside the kernel, right before the product.  Here the same:
// each (64, 128) int8 weight tile streams into shared memory by cp.async
// (8 KB a stage where bf16 would take 16 KB), one pass of the block's
// threads converts it to a bf16 tile (exact: the codes are -127..127), and
// the warps read that tile with ldmatrix.trans (which takes 16-bit
// elements only, hence the pass) into bf16 mma.sync.m16n8k16 products.
// The activations stay bf16: the int8 tensor cores would need int8
// activations, which is the w8a8 route (torch._int_mm in models/vit.py),
// not this one.  The epilogue applies acc * scale[n] + b[n] in fp32 from
// the accumulator registers and rounds once.
//
// Tiling as csrc/cp_site.cu: 128x128x64 block tiles, eight warps of 64x32,
// a three-stage cp.async ring (x tiles bf16, weight tiles int8), two
// blocks per SM (95 KB of shared memory each).  M (197 rows an image) is
// ragged: rows past M load as zeros and are never written.  K and N must
// be multiples of 128 (what models.vit.matk sends; the wrapper checks).
//
// What bounds it on the H100: at ViT-B batch 64 (M 12608, K 768, N 2304)
// the products, 44.6 GFLOP, ~0.045 ms at the bf16 tensor-core peak, so a
// tensor-core GEMM; at batch 1 (M 197) the bytes, ~3 MB, ~0.001 ms, where
// reading the weight as int8 is the whole gain.  This first version is an
// mma.sync GEMM with a second barrier a k-step for the convert pass;
// wgmma with the convert done in registers is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int A_LD = BK + 8;   // padded smem strides (multiples of 8)
constexpr int B_LD = BN + 8;
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (cols)
constexpr int WM = 64;         // warp tile 64 x 32
constexpr int WN = 32;
constexpr int MI = WM / 16;    // m16 tiles per warp
constexpr int NJ = WN / 8;     // n8 tiles per warp
constexpr int STAGES = 3;
constexpr size_t A_STAGE = (size_t)BM * A_LD;  // bf16 elements
constexpr size_t Q_STAGE = (size_t)BK * BN;    // int8 bytes
constexpr size_t A_BYTES = STAGES * A_STAGE * 2;
constexpr size_t Q_BYTES = STAGES * Q_STAGE;
constexpr size_t SMEM = A_BYTES + Q_BYTES + (size_t)BK * B_LD * 2;
static_assert(A_BYTES % 128 == 0 && Q_BYTES % 128 == 0,
              "shared-memory regions start 128-byte aligned");

// One BK-deep step of the warp's 64x32 tile: A fragments by ldmatrix from
// the x stage, B fragments by ldmatrix.trans from the converted bf16
// (k, n) tile, then MI x NJ mma.sync.m16n8k16.
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][4],
                                         const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int wr,
                                         int wc, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
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

__global__ void __launch_bounds__(THREADS, 2)
int8_dense_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ wq,
                  const __nv_bfloat16* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* Qs = reinterpret_cast<int8_t*>(smem + A_BYTES);
  __nv_bfloat16* Bs =
      reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES + Q_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp >> 2;  // 0..1
  const int wc = warp & 3;   // 0..3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KT = K / BK;

  // Stage kt: x[m0:, kt*BK:] (bf16, rows past M zero-filled) and
  // Wq[kt*BK:, n0:] (int8; N % BN == 0, so no column is ragged).
  constexpr int VA = BM * BK / 8 / THREADS;   // 16-byte x vectors a thread
  constexpr int VQ = BK * BN / 16 / THREADS;  // 16-byte int8 vectors
  auto load_stage = [&](int st, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int it = 0; it < VA; ++it) {
      const int vec = tid + it * THREADS;
      const int row = vec / (BK / 8);
      const int col = (vec % (BK / 8)) * 8;
      const int gm = m0 + row;
      const bool ok = gm < M;
      cp_async16(As + st * A_STAGE + row * A_LD + col,
                 ok ? x + (size_t)gm * K + k0 + col : x, ok);
    }
#pragma unroll
    for (int it = 0; it < VQ; ++it) {
      const int vec = tid + it * THREADS;
      const int row = vec / (BN / 16);
      const int col = (vec % (BN / 16)) * 16;
      cp_async16(Qs + st * Q_STAGE + row * BN + col,
                 wq + (size_t)(k0 + row) * N + n0 + col, true);
    }
  };

  // The int8 stage -> the bf16 tile: each thread 16 codes at a time (one
  // 16-byte read, two 16-byte writes).
  auto convert = [&](int st) {
#pragma unroll
    for (int it = 0; it < VQ; ++it) {
      const int vec = tid + it * THREADS;
      const int row = vec / (BN / 16);
      const int col = (vec % (BN / 16)) * 16;
      const int4 raw =
          *reinterpret_cast<const int4*>(Qs + st * Q_STAGE + row * BN + col);
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
      unsigned w[8];
#pragma unroll
      for (int p = 0; p < 8; ++p)
        w[p] = pack_bf16(static_cast<float>(e[2 * p]),
                         static_cast<float>(e[2 * p + 1]));
      uint4* dst = reinterpret_cast<uint4*>(Bs + row * B_LD + col);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is past step kt-1
    const int st = kt % STAGES;
    convert(st);
    // Refill the slot consumed in the previous step (its x tile was read
    // by that step's products, its int8 tile by that step's convert).
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();
    __syncthreads();  // the bf16 tile is whole
    warp_mma(acc, As + st * A_STAGE, Bs, wr, wc, lane);
  }
  cp_async_wait<0>();

  // Epilogue from the registers: thread (g, t) holds rows g and g + 8,
  // columns 2t and 2t + 1 of every 16x8 accumulator tile.
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int gn = n0 + wc * WN + j * 8 + t2;
    const float2 sc = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(scale + gn));
    const float2 bb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + gn));
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gm = m0 + wr * WM + i * 16 + g + half * 8;
        if (gm >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)gm * N + gn) =
            __floats2bfloat162_rn(acc[i][j][half * 2] * sc.x + bb.x,
                                  acc[i][j][half * 2 + 1] * sc.y + bb.y);
      }
    }
  }
}

}  // namespace

// y (M, N) bf16 = (x (M, K) bf16 @ wq (K, N) int8) * scale (N,) + b (N,),
// on `stream`.  Needs K % 64 == 0, N % 128 == 0 and 16-byte aligned
// pointers; the Python wrapper checks (and asks for K % 128 too, as
// matk's dims are).  Returns cudaGetLastError() (or the error of the
// shared-memory attribute call).
extern "C" int cara_int8_dense(const void* x, const void* wq,
                               const void* scale, const void* bias,
                               void* out, int M, int K, int N,
                               void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (M < 1 || K < BK || K % BK || N < BN || N % BN)
    return static_cast<int>(cudaErrorInvalidValue);
  // Set once: the attribute is per process (one device per process).
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(N / BN, (M + BM - 1) / BM);
  int8_dense_kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
