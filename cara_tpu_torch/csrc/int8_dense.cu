// Dequant-fused int8 GEMM for Hopper (sm_90a):
//
//   y = (x @ Wq) * scale + b
//
// x (M, K) bf16, Wq (K, N) int8 (per-output-channel symmetric codes of
// models/quant.py, row-major as it writes them), scale (N,) and b (N,)
// bf16, y (M, N) bf16; fp32 accumulation, scale and bias applied in fp32
// from the accumulators, one rounding.  Inference only.
//
// Replaces cara_tpu/ops/pallas/int8_dense.py (int8_dense,
// _int8_dense_kernel), whose point is that the weight leaves device
// memory as int8, half the bytes of bf16, and is converted to the compute
// dtype only on chip, right before the product.  The same here, on the
// wgmma + TMA shape of sm90_gemm.cuh (its descriptors, swizzle and
// epilogue layout):
//
//   - one producer warp keeps a four-slot ring filled by TMA: a 128 x 64
//     bf16 x tile (128-byte swizzle) and the 64 x BN int8 weight tile
//     (BN / 128 boxes of 64 rows x 128 codes, 128-byte swizzle: the int8
//     matrix is mapped as a bf16 one of N / 2 columns, TMA moves bytes);
//   - two consumer warpgroups run wgmma.m64nBNk16 (64 rows each) from the
//     x slot and a converted bf16 slot (BN / 64 boxes of 64 rows x 128
//     bytes, the MN-major B layout of sm90_gemm.cuh's NN products; three
//     slots), and while tile kt's products run asynchronously on the
//     tensor cores they convert the landed int8 tile kt + 1 into the
//     next converted slot, half its rows each, then meet at a barrier.
//     The convert is exact (codes -127..127): two codes become one bf16x2
//     word by a byte permute, two ANDs and one bf16x2 subtraction (no
//     I2F; pair_to_bf16).
//
// Why the consumers convert, and not a warpgroup of its own or CUTLASS's
// mixed-input scheme: a transform warpgroup of three warps beside the
// producer (the first version of this kernel) did not keep up with the
// products, and a fourth warpgroup leaves 128 registers a thread, fewer
// than ptxas needs for a 256-wide wgmma's accumulators; the consumers
// are idle while their wgmma runs, and 256 threads share the work.
// CUTLASS's scheme (the weight as the register-sourced A operand of y^T =
// Wq^T x^T, converted in registers) wants K-contiguous codes, and the
// codes here are (K, N) row-major as models/quant.py writes them and matk
// passes them; a second copy of every weight, or a transpose each call,
// would spend the bytes the kernel exists to save.  The convert's
// shared-memory traffic (the int8 tile read, the bf16 tile written: 48
// KB a 128 x 256 x 64 tile) shares the SM's 128 bytes a clock with the
// TMA writes (32 KB) and wgmma's operand reads (80 KB).
//
// What bounds it on the H100, and what the design does:
//   - large M (batch 64: M 12608 at ViT-B, 16448 at ViT-H): the tensor
//     cores (ViT-B qkv: 44.6 GFLOP, 0.045 ms).  128 x 256 tiles (128 x 128
//     where N is not a multiple of 256 or the 256-wide grid would leave
//     SMs idle), one block an SM, the producer three tiles ahead, the
//     convert under the products.  What holds it back is the tiles'
//     stream from L2 (32 KB a 128 x 256 x 64 step on every SM) and each
//     block's pipeline fill and epilogue, which no persistent loop
//     overlaps (tools/int8_dense_variants.py times the kernel without its
//     products, without its convert and without both);
//   - small M (batch 1: M 197 or 257): the weight's bytes (ViT-B qkv ~3 MB,
//     0.0009 ms), and a grid of N / 128 x ceil(M / 128) tiles fills few of
//     the 132 SMs.  So the contraction is split (splits > 1, picked by the
//     wrapper from M, K and N to make about one wave): split z of a tile
//     walks k_split contraction rows and stores its fp32 partial into its
//     own plane of a workspace (S, Mp, N) by TMA; a second kernel sums
//     the S partials of each output in the order z = 0 .. S - 1, applies
//     scale and bias once and rounds.  No atomics: two calls give the same
//     bits.
// M is ragged (rows past M load as zeros and are not stored).  K and N
// must be multiples of 128 (what models.vit.matk sends; the wrapper
// checks).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;
constexpr int BK = 64;
constexpr int THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int CONSUMERS = 256;
constexpr int ATOM = 64 * BK * 2;  // one 64 x 64 bf16 box: 8 KB

// The load ring (x tile + int8 tile a slot) and the bf16 ring (converted
// tiles), each part 1024-byte aligned for the 128-byte swizzle; after the
// products the rings hold the output tile on its way out (bf16 a direct
// call, fp32 a split's partial).
template <int BN>
struct Ring {
  static constexpr int LS = 4;  // load slots
  static constexpr int BS = 3;  // converted slots
  static constexpr int A = BM * BK * 2;
  static constexpr int Q = BK * BN;
  static constexpr int LSLOT = A + Q;
  static constexpr int B = BK * BN * 2;
  static constexpr int BOFF = LS * LSLOT;
  static constexpr int BARS = BOFF + BS * B;
  static constexpr int SMEM = BARS + 2 * LS * 8 + 1024;
  static_assert(BARS >= BM * BN * 4, "the fp32 epilogue tile");
  static_assert(SMEM <= 232448, "shared memory");
};

struct Maps {
  CUtensorMap x, q, c16, c32;
};

struct Args {
  const __nv_bfloat16* scale;
  const __nv_bfloat16* bias;
  int M, N, Mp, k_split;
};

// Two int8 codes of the word w (bytes picked by sel) -> one bf16x2 word,
// exactly.  For a code byte b, the bf16 0x43 | (b & 0x7f) is 128 + (b &
// 0x7f) and 0x43 | (b & 0x80) is 128 or 256 (b's sign bit): their
// difference is the code, exact in bf16 (8 significant bits).  One byte
// permute builds both halves' 0x43 b bytes, two ANDs split them, one
// bf16x2 subtraction.
__device__ __forceinline__ uint32_t pair_to_bf16(uint32_t w, uint32_t sel) {
  const uint32_t t = __byte_perm(w, 0x4343u, sel);
  const uint32_t v = t & 0xFF7FFF7Fu, c = t & 0xFF80FF80u;
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Four int8 codes (one word) -> two bf16x2 words, exactly.
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo,
                                              uint32_t& hi) {
  lo = pair_to_bf16(w, 0x5140);  // bytes b0 0x43 b1 0x43
  hi = pair_to_bf16(w, 0x5342);  // bytes b2 0x43 b3 0x43
}

// SPLIT = false: y = bf16(acc * scale + b) into the output.  SPLIT = true:
// the fp32 partial of contraction rows blockIdx.z * k_split .. into plane
// blockIdx.z of the workspace.
template <int BN, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
int8_dense_kernel(const __grid_constant__ Maps maps, const Args p) {
  using R = Ring<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BARS);
  uint64_t* empty = full + R::LS;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.k_split;
  const int KT = p.k_split / BK;

  // A slot is free once a thread of each consumer warpgroup has arrived.
  if (tid == 0) {
    for (int s = 0; s < R::LS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      // The producer: x (K-major, one box) and the int8 tile.
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % R::LS;
        if (kt >= R::LS) mbar_wait(&empty[s], (kt / R::LS - 1) & 1);
        unsigned char* as = smem + s * R::LSLOT;
        const int k = kbeg + kt * BK;
        mbar_expect_tx(&full[s], R::LSLOT);
        tma_load_2d(as, &maps.x, &full[s], k, m0);
#pragma unroll
        for (int c = 0; c < BN / 128; ++c)
          tma_load_2d(as + R::A + c * ATOM, &maps.q, &full[s],
                      n0 / 2 + 64 * c, k);
      }
    }
    return;
  }

  // Consumers: warpgroup w owns rows m0 + 64 w .. + 63 of the products and
  // converts rows 32 w .. 32 w + 31 of each int8 tile.
  const int w = tid >> 7;
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // The convert of tile kt into converted slot kt % BS: 8 codes an item,
  // (row k, columns c .. c + 7).  A warp-step takes 256 consecutive codes,
  // 256 / BN rows (conflict-free reads; a quarter warp's stores are one
  // 128-byte row of a box); a thread's column is fixed and its rows step
  // by 4 warps' worth.  The 128-byte swizzle moves bits 4-6 of a box row's
  // byte offset by the row's low three bits, which take two values over
  // a thread's rows (r0 + 4 j RPW): the offsets are two per-thread bases
  // plus constants.  Every load is issued before the first store.
  constexpr int RPW = 256 / BN;
  constexpr int PER = BK / 2 / (4 * RPW);  // items a thread
  const int col = (lane % (BN / 8)) * 8;
  const int r0 = 32 * w + warp * RPW + lane / (BN / 8);
  const int src_col = (col / 128) * ATOM + col % 128;
  const int dst_col = (col / 64) * ATOM + (col % 64) * 2;
  int src[2], dst[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sw = ((r0 + 4 * h) & 7) << 4;
    src[h] = r0 * 128 + (src_col ^ sw);
    dst[h] = r0 * 128 + (dst_col ^ sw);
  }
  auto convert = [&](int kt) {
    const unsigned char* qs = smem + (kt % R::LS) * R::LSLOT + R::A;
    unsigned char* bs = smem + R::BOFF + (kt % R::BS) * R::B;
    mbar_wait(&full[kt % R::LS], (kt / R::LS) & 1);
    uint2 raw[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j)
      raw[j] = *reinterpret_cast<const uint2*>(
          qs + src[(j * RPW) & 1] + j * 4 * RPW * 128);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      uint4 o;
      codes_to_bf16(raw[j].x, o.x, o.y);
      codes_to_bf16(raw[j].y, o.z, o.w);
      *reinterpret_cast<uint4*>(bs + dst[(j * RPW) & 1] +
                                j * 4 * RPW * 128) = o;
    }
    // the converted tile, written by both warpgroups, visible to wgmma
    fence_proxy_async();
    named_barrier(1, CONSUMERS);
  };

  // Tile kt + 1 is converted while tile kt's products run.  Its slot was
  // last read by the products of tile kt - 2: this warpgroup's completed
  // (wait<1> below), the other's before it reached the barrier that ended
  // the convert of tile kt.
  convert(0);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % R::LS;
    const uint64_t da = desc<128>(smem + s * R::LSLOT + w * ATOM);
    const uint64_t db = desc_mn(smem + R::BOFF + (kt % R::BS) * R::B, ATOM);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<BN, 0, 1>(acc, da + 2 * kk, db + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait<1>();
    // Slot kt - 1 is done with: its int8 tile was converted before the
    // barrier of the previous step, and this warpgroup's products of it
    // have completed.
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(&empty[(kt - 1) % R::LS]);
    if (kt + 1 < KT) convert(kt + 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue: thread (g, t) of warp `warp` holds rows warp * 16 + g (+ 8)
  // of its warpgroup's 64 and columns 8 j + 2 t (+ 1).  Once both
  // warpgroups are past their products the rings are free: the tile goes
  // there in the layout of 128-row boxes of 128 bytes (128-byte swizzle)
  // and leaves by TMA stores, which skip rows past M.
  named_barrier(1, CONSUMERS);
  const int rbase = w * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + t2;
    float2 sc = make_float2(0.f, 0.f), bb = sc;
    if constexpr (!SPLIT) {
      sc = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.scale + n0 + col));
      if (p.bias)
        bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.bias + n0 + col));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = rbase + 8 * half;
      const float a0 = acc[4 * j + 2 * half];
      const float a1 = acc[4 * j + 2 * half + 1];
      if constexpr (SPLIT) {
        *reinterpret_cast<float2*>(
            smem + (col / 32) * BM * 128 +
            swizzle<128>(row * 128 + (col % 32) * 4)) = make_float2(a0, a1);
      } else {
        *reinterpret_cast<uint32_t*>(
            smem + (col / 64) * BM * 128 +
            swizzle<128>(row * 128 + (col % 64) * 2)) =
            pack_bf16(fmaf(a0, sc.x, bb.x), fmaf(a1, sc.y, bb.y));
      }
    }
  }
  fence_proxy_async();
  named_barrier(1, CONSUMERS);
  if (tid == 0) {
    if constexpr (SPLIT) {
#pragma unroll
      for (int c = 0; c < BN / 32; ++c)
        tma_store_2d(&maps.c32, smem + c * BM * 128, n0 + 32 * c,
                     blockIdx.z * p.Mp + m0);
    } else {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        tma_store_2d(&maps.c16, smem + c * BM * 128, n0 + 64 * c, m0);
    }
    bulk_wait_read();  // the stores have read the tile
  }
}

// The split partials of each output summed in split order, then scale and
// bias in fp32, one rounding: 8 columns a thread.
__global__ void int8_reduce_kernel(const float* __restrict__ ws,
                                   const __nv_bfloat16* __restrict__ scale,
                                   const __nv_bfloat16* __restrict__ bias,
                                   __nv_bfloat16* __restrict__ out, int M,
                                   int N, int Mp, int splits) {
  const int per_row = N / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * per_row) return;
  const int m = static_cast<int>(idx / per_row);
  const int c = static_cast<int>(idx % per_row) * 8;
  float a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float4* src = reinterpret_cast<const float4*>(
        ws + ((size_t)z * Mp + m) * N + c);
    const float4 v0 = src[0], v1 = src[1];
    a[0] += v0.x; a[1] += v0.y; a[2] += v0.z; a[3] += v0.w;
    a[4] += v1.x; a[5] += v1.y; a[6] += v1.z; a[7] += v1.w;
  }
  const uint4 sraw = *reinterpret_cast<const uint4*>(scale + c);
  const uint4 braw = bias ? *reinterpret_cast<const uint4*>(bias + c)
                          : make_uint4(0, 0, 0, 0);
  const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sraw);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&braw);
  uint4 o;
  uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 sc = __bfloat1622float2(s2[i]);
    const float2 bb = __bfloat1622float2(b2[i]);
    ow[i] = pack_bf16(fmaf(a[2 * i], sc.x, bb.x),
                      fmaf(a[2 * i + 1], sc.y, bb.y));
  }
  *reinterpret_cast<uint4*>(out + (size_t)m * N + c) = o;
}

// A 2-D map over the row-major (rows, inner) matrix at `base`, box (128
// bytes of a row, box_rows), 128-byte swizzle; bf16 or fp32.
int map2d(CUtensorMap* map, const void* base, int inner, int rows,
          int box_rows, int elem_bytes = 2) {
  const uint64_t dims[2] = {(uint64_t)inner, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)inner * elem_bytes};
  const uint32_t box[2] = {(uint32_t)(128 / elem_bytes), (uint32_t)box_rows};
  return encode_map(map, base, 2, dims, strides, box, elem_bytes);
}

template <int BN, bool SPLIT>
int launch(const Maps& maps, const Args& p, int splits,
           cudaStream_t stream) {
  constexpr int smem = Ring<BN>::SMEM;
  // Set once: the attribute is per process (one device per process).
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_dense_kernel<BN, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(p.N / BN, (p.M + BM - 1) / BM, splits);
  int8_dense_kernel<BN, SPLIT><<<grid, THREADS, smem, stream>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (M, N) bf16 = (x (M, K) bf16 @ wq (K, N) int8) * scale (N,) + b (N,)
// (b null: no bias), on `stream`, in blocks `bn` (128 or 256) columns
// wide.  splits == 1: one kernel.  splits > 1: split z takes contraction
// rows z * k_split .. (k_split a multiple of 64, splits * k_split == K)
// into plane z of `ws`, fp32 (splits, ceil(M / 128) * 128, N), then the
// ordered sum.  Needs K
// and N multiples of 128 (N of bn) and 16-byte aligned pointers; the
// Python wrapper checks and picks bn and the split.  Returns 0, a
// CUresult of a map's encoding, or cudaGetLastError().
extern "C" int cara_int8_dense(const void* x, const void* wq,
                               const void* scale, const void* bias,
                               void* out, void* ws, int M, int K, int N,
                               int bn, int splits, int k_split,
                               void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (M < 1 || K < 128 || K % 128 || (bn != 128 && bn != 256) || N < bn ||
      N % bn || splits < 1 || k_split < BK || k_split % BK ||
      (long long)splits * k_split != K || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mp = (M + BM - 1) / BM * BM;
  Maps maps;
  int err = map2d(&maps.x, x, K, M, BM);
  if (!err) err = map2d(&maps.q, wq, N / 2, K, BK);
  if (!err && splits == 1) err = map2d(&maps.c16, out, N, M, BM);
  if (!err && splits > 1) err = map2d(&maps.c32, ws, N, splits * mp, BM, 4);
  if (err) return err;
  const Args p{static_cast<const __nv_bfloat16*>(scale),
               static_cast<const __nv_bfloat16*>(bias), M, N, mp, k_split};
  if (splits == 1)
    return bn == 256 ? launch<256, false>(maps, p, 1, stream)
                     : launch<128, false>(maps, p, 1, stream);
  err = bn == 256 ? launch<256, true>(maps, p, splits, stream)
                  : launch<128, true>(maps, p, splits, stream);
  if (err) return err;
  const long long items = (long long)M * (N / 8);
  int8_reduce_kernel<<<static_cast<unsigned>((items + 255) / 256), 256, 0,
                       stream>>>(
      static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, mp, splits);
  return static_cast<int>(cudaGetLastError());
}
