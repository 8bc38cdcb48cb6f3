// Folded masked weights for exact element-wise weight dropout (sm_90a),
// every weight of a block call in one launch:
//
//   W'_i = bf16(W_i + where(keep(k, n, seed_i), (U_i V_i)[k, n] * inv, 0))
//
// with inv = s / (1 - rate) and keep the coordinate hash of wd_hash.cuh.
// W (K, N), U (K, r), V (r, N) bf16; the rank-r dot is summed in fp32 from
// the bf16 factors in the order j = 0 .. r - 1 and W + delta is rounded
// once, as the TPU kernel's _masked_delta / _build_wd_kernel do.  Where
// the mask drops an element the output is W itself (W + 0).
//
// Replaces cara_tpu/ops/pallas/cp_dense.py _build_wd_weight (body
// _build_wd_kernel, mask hash_keep), which folds one weight a call, a
// (512, 1024) tile a grid step.  On the H100 a fold moves the bytes of W
// and W' (a ViT-B attention pair, 768 x 2304 + 768 x 768, 9.4 MB: 2.8 us
// at 3.35 TB/s; ViT-H's attention pair 26.2 MB, 7.8 us, its MLP pair
// 52.4 MB, 15.6 us), and its arithmetic takes about as long: r FMA, the
// hash's ~12 integer operations (the INT32 pipe issues at half the FP32
// rate) and the conversions, ~30 instructions an element at r = 8.  A
// launch a weight made the block call a string of host launches.  So:
//   - one launch folds up to four weights (a block call's two): the grid
//     is one flat list of tiles over all of them, each block finds its
//     weight from the descriptors' first tiles;
//   - the grid is persistent, four blocks an SM, each walking the flat
//     list of 16 x 256 tiles; a thread owns 2 rows x 8 columns of a tile
//     and issues its 16-byte loads of the next tile's W before it
//     computes this tile's rank product and hash, so that the memory
//     stream runs under the arithmetic; V's 16-byte rows and U's
//     elements come through L1 (the 32 lanes of a warp share its rows),
//     no shared memory and no barrier;
//   - the smallest pair (ViT-B's attention weights) is 576 tiles, so
//     every block has work.
// An element's arithmetic does not depend on the tiling, so neither does
// the output.  The rank loop reads U's and V's elements as it goes (no
// tile of them is staged), so any rank runs in the same registers: a
// thread's 2 x 8 fp32 sums, j = 0 .. r - 1 in order (at r 128 the rank
// FMA, 128 an element, take the place of the hash as the larger part).
// The keep pattern does not depend on r.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wd_hash.cuh"

namespace {

constexpr int kRT = 2;         // rows a thread
constexpr int kRows = 8 * kRT;  // rows a tile
constexpr int kCols = 256;     // columns a tile
constexpr int kThreads = 256;  // 32 column groups of 8 x 8 row groups
constexpr int kBlocksPerSM = 4;
constexpr int kMaxFolds = 4;

struct Fold {
  const __nv_bfloat16* w;
  const __nv_bfloat16* u;
  const __nv_bfloat16* v;
  const int* seed;
  __nv_bfloat16* out;
  int K, N, r;
  int tiles_n;  // column tiles
  int first;    // its first tile in the flat list
};

struct Folds {
  Fold f[kMaxFolds];
  int count;
  float inv;
  uint32_t thr;
};

// A thread's place in a tile: its fold, rows k0 .. k0 + rows - 1 and
// columns n .. n + 7 (rows <= 0: nothing in this tile).
struct Pos {
  int fi, k0, n, rows;
};

__device__ __forceinline__ Pos locate(const Folds& fs, int t, int tid) {
  Pos p;
  p.fi = 0;
#pragma unroll
  for (int j = 1; j < kMaxFolds; ++j)
    if (j < fs.count && t >= fs.f[j].first) p.fi = j;
  const Fold& f = fs.f[p.fi];
  const int lt = t - f.first;
  p.k0 = (lt / f.tiles_n) * kRows + (tid / (kCols / 8)) * kRT;
  p.n = (lt % f.tiles_n) * kCols + (tid % (kCols / 8)) * 8;
  p.rows = p.n < f.N ? min(kRT, f.K - p.k0) : 0;
  return p;
}

// W's rows of a tile, 16 bytes each, read once (evict first).
__device__ __forceinline__ void load_w(const Folds& fs, const Pos& p,
                                       uint4 (&w)[kRT]) {
  const Fold& f = fs.f[p.fi];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
    if (i < p.rows)
      w[i] = __ldcs(reinterpret_cast<const uint4*>(
          f.w + (size_t)(p.k0 + i) * f.N + p.n));
}

// The rank product, the mask and W + delta for a tile whose W is in `w`.
__device__ __forceinline__ void fold_tile(const Folds& fs, const Pos& p,
                                          const uint4 (&w)[kRT]) {
  const Fold& f = fs.f[p.fi];
  float acc[kRT][8];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  for (int j = 0; j < f.r; ++j) {
    const uint4 vraw =
        __ldg(reinterpret_cast<const uint4*>(f.v + (size_t)j * f.N + p.n));
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vraw);
    float vv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) vv[c] = __bfloat162float(ve[c]);
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const float uk =
          i < p.rows ? __bfloat162float(f.u[(size_t)(p.k0 + i) * f.r + j])
                     : 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(uk, vv[c], acc[i][c]);
    }
  }
  const uint32_t sd = static_cast<uint32_t>(__ldg(f.seed));
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    if (i >= p.rows) break;
    const int k = p.k0 + i;
    const __nv_bfloat16* we = reinterpret_cast<const __nv_bfloat16*>(&w[i]);
    uint4 packed;
    __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float d =
          wd_keep(k, p.n + c, sd, fs.thr) ? acc[i][c] * fs.inv : 0.f;
      pe[c] = __float2bfloat16(__bfloat162float(we[c]) + d);
    }
    *reinterpret_cast<uint4*>(f.out + (size_t)k * f.N + p.n) = packed;
  }
}

// Persistent: block b takes tiles b, b + gridDim.x, ...; the next tile's
// W loads are issued before this tile's rank product and hash, so the
// memory stream does not stop while a block computes.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
wd_fold_kernel(const __grid_constant__ Folds fs, int tiles) {
  const int tid = threadIdx.x;
  int t = blockIdx.x;
  Pos cur = locate(fs, t, tid);
  uint4 w[kRT];
  load_w(fs, cur, w);
  while (true) {
    const int tn = t + gridDim.x;
    Pos nxt;
    uint4 wn[kRT];
    if (tn < tiles) {
      nxt = locate(fs, tn, tid);
      load_w(fs, nxt, wn);
    }
    if (cur.rows > 0) fold_tile(fs, cur, w);
    if (tn >= tiles) break;
    t = tn;
    cur = nxt;
#pragma unroll
    for (int i = 0; i < kRT; ++i) w[i] = wn[i];
  }
}

// The card's SM count (cached; one device per process).
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

}  // namespace

// `count` (1..4) folds in one launch: desc holds 8 values a fold, the
// device addresses of W (K, N), U (K, r), V (r, N) (bf16), the seed (one
// int32) and the output W' (K, N) (bf16), then K, N and r.  inv = s / (1 -
// rate), thr the keep threshold.  Needs N % 8 == 0, r >= 1 and 16-byte
// aligned W, V and W' (the wrapper checks).  Returns
// cudaGetLastError().
extern "C" int cara_wd_fold(int count, const long long* desc, float inv,
                            unsigned thr, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (count < 1 || count > kMaxFolds)
    return static_cast<int>(cudaErrorInvalidValue);
  Folds fs = {};
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + 8 * i;
    Fold& f = fs.f[i];
    f.w = reinterpret_cast<const __nv_bfloat16*>(d[0]);
    f.u = reinterpret_cast<const __nv_bfloat16*>(d[1]);
    f.v = reinterpret_cast<const __nv_bfloat16*>(d[2]);
    f.seed = reinterpret_cast<const int*>(d[3]);
    f.out = reinterpret_cast<__nv_bfloat16*>(d[4]);
    f.K = static_cast<int>(d[5]);
    f.N = static_cast<int>(d[6]);
    f.r = static_cast<int>(d[7]);
    if (f.K < 1 || f.N < 8 || f.N % 8 || f.r < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    f.tiles_n = (f.N + kCols - 1) / kCols;
    f.first = tiles;
    tiles += f.tiles_n * ((f.K + kRows - 1) / kRows);
  }
  fs.count = count;
  fs.inv = inv;
  fs.thr = thr;
  const int grid = std::min(tiles, kBlocksPerSM * sm_count());
  wd_fold_kernel<<<grid, kThreads, 0, stream>>>(fs, tiles);
  return static_cast<int>(cudaGetLastError());
}
