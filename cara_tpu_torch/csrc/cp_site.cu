// Dense CaRA site for Hopper (sm_90a):
//
//   out = epi( xa @ W + b + s * ((xa @ U) @ V + cb) )
//
// xa (M, K), W (K, N), U (K, r), V (r, N), out (M, N); bf16 in and out,
// fp32 accumulation.  xa is x, or on a LayerNorm site bf16(LN(x)), written
// by block_rows.cu's row pass before this product (the caller launches
// it).  epi is an optional activation (the exact-erf GELU or CLIP's
// quick_gelu, y sigma(1.702 y): a template parameter of the epilogue,
// gelu.cuh) and an optional residual x_res + dpm[row] * y, or, in the
// dact mode, dpre = g * act'(y) with g (M, N) the cotangent of the
// activation's output: the backward helper _cp_dense_dact_kernel
// (cara_tpu/ops/pallas/cp_dense.py, row 13), which recomputes the fp32
// pre-activation y on the tile and never writes it.  The activation site
// can also write y rounded to bf16 beside its output, staged and stored
// by TMA like it: the saved pre-activation of the MLP block's save-pre
// mode (_mlp_fwd_save_pre_kernel, cp_mlp.py, row 9), which the backwards
// of rows 10 and 11 read in place of recomputing fc1.
//
// Replaces the dense parts of the TPU kernels _cp_dense_kernel /
// _cp_dense_dact_kernel (cara_tpu/ops/pallas/cp_dense.py, row 13),
// _mlp_fwd_kernel (cp_mlp.py, row 9: the fc1 and fc2 sites),
// _attn_block_fwd_kernel (cp_attn_block.py, rows 5 and 7: the qkv and
// proj sites) and the LN1 / qkv site of block_pair.py (row 19).  The TPU
// kernels hold a row tile and every weight in VMEM, normalize x there
// (the normalized x never reaches HBM) and keep z = xa U in a scratch
// accumulator over the k grid; on Hopper each site is one product of the
// wgmma + TMA core (sm90_gemm.cuh, NN with a site epilogue) and the LN
// row pass writes xa once (19 MB at M 12608, K 768: a few microseconds)
// so that the product's A operand is a plain TMA load, instead of each of
// the 9-24 column blocks normalizing the same rows again.  That is a
// traffic choice; the rounding point is the TPU's (xa = bf16(_ln_rows)).
//
// The rank delta stays in rank space, as on the TPU: z = xa U is
// accumulated in fp32 beside the main product over the same k-tiles (a
// 16- or 64-wide wgmma on the A tile the block holds, U loaded MN-major
// beside W), rounded to bf16 once, and multiplied by V as one more 16- or
// 64-deep k-step on the main accumulators.  The delta scale s multiplies
// (z V + cb) in fp32 (the accumulators are scaled by 1 / s before that
// k-step and by s after it), never folded into a bf16 V.  The blocks of
// column 0 write z (M, 64), zero past the rank, where the caller keeps it
// for the backward's factor gradients.  Rank 0 (the element route's W'
// form) has no rank step.
//
// What bounds it: at ViT-B (M = 64 * 197 = 12608) the sites are 15-60
// GFLOP against 25-80 MB, above the H100's ~295 FLOP/byte ridge: the
// tensor cores.  Block width: 256 columns, one block an SM, where M and N
// allow (every site of ViT-B), else 128, two blocks an SM.  The folded
// z's registers beside a 128-wide block's accumulators spill (the two
// blocks an SM leave 112 registers a thread) and ptxas serializes its
// wgmma; a 256-wide block's fit, and its residual and dact epilogues
// (bf16 read and written, 4 bytes an output) stay on the operations
// side of the ridge.
//
// quick_gelu (act 3, its dact 4) replaces the act="quick_gelu" mode of
// the same TPU kernels (_cp_dense_kernel / _cp_dense_dact_kernel,
// _mlp_fwd_kernel and its save-pre form: CLIP ViT-L/14's fc1).  Its
// epilogue costs one expf an output where the GELU's costs erff and expf,
// on the same tile and the same bytes, so the same bound holds (at CLIP's
// fc1, M 16448, K 1024, N 4096: 138 GFLOP against ~180 MB, the tensor
// cores).  Its instances are those the paths launch: the activation site
// with and without its pre output and the dact mode, at every rank class
// and block width; the residual epilogue takes the GELU or none (no site
// of either package has an activation and a residual).  They are built
// in a source file of their own, cp_site_quick.cu, so that the two files
// compile side by side.
//
// cara_rank_z is the rank product alone, z = bf16(xa U) (M, 64) zero past
// r, for the backward wrappers that recompute it (_bwd.rank_z): a skinny
// tensor-core GEMM that reads xa once.  Past rank 64 it writes z (M, R),
// R = 64 ceil(r / 64), a 64-column chunk a block (the chunk the fastest
// grid index, so that a row block's chunks run together and share its
// rows in L2), from U given (K, R) zero past r.
//
// Past rank 64 a folded z would hold R / 2 fp32 registers a thread beside
// the accumulators (spills, and ptxas serializes the wgmma), so the site
// runs that pre-pass first (one more read of xa: 19 MB at ViT-B's qkv
// site, ~6 us at 3.35 TB/s) and its rank step reads z from memory as
// ceil(r / 64) k-tiles of 64 through the same ring (sm90_gemm.cuh,
// RK_LOOP; the GELU instances built in cp_site_chunks.cu, so that they
// compile beside these).  The rounding points do not move: z is summed
// in fp32 and rounded to bf16 once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "cp_site.cuh"

using namespace nvcuda;

namespace {

// z = bf16(x @ U): a skinny GEMM (N = r) on the tensor cores.  Each block
// takes ZBM rows and walks K in ZBK-wide chunks; each of its two warps
// owns 16 rows and RP/16 accumulator fragments (RP = r rounded up to 16;
// the padding columns of U are zero in shared memory).  It reads x once,
// so it is bound by that read.
constexpr int ZBM = 32;
constexpr int ZW = 64;  // width of the z buffer = the rank step's depth
constexpr int ZBK = 128;
constexpr int ZA_LD = ZBK + 8;
constexpr int ZTHREADS = 64;

// CHUNK (RP 64, past rank 64): block (c, y) writes z's columns 64 c ..
// 64 c + 63 of rows 32 y .., U (K, ldz) and z (M, ldz) zero-padded to ldz
// = R columns.  Otherwise one chunk: U (K, r), z (M, 64).
template <int RP, bool CHUNK = false>
__global__ void __launch_bounds__(ZTHREADS)
rank_z_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ u,
              __nv_bfloat16* __restrict__ z, int M, int K, int r, int ldz) {
  static_assert(!CHUNK || RP == ZW, "a chunk is 64 columns");
  constexpr int ULD = RP + 8;
  __shared__ __align__(128) __nv_bfloat16 As[ZBM * ZA_LD];
  __shared__ __align__(128) __nv_bfloat16 Us[ZBK * ULD];
  __shared__ __align__(128) float Zs[ZTHREADS / 32][256];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = (CHUNK ? blockIdx.y : blockIdx.x) * ZBM;
  const int c0 = CHUNK ? blockIdx.x * ZW : 0;
  constexpr int VA = ZBM * ZBK / 8 / ZTHREADS;  // 16-byte vectors a thread

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RP / 16];
#pragma unroll
  for (int f = 0; f < RP / 16; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int idx = tid; idx < ZBK * RP; idx += ZTHREADS)
    Us[(idx / RP) * ULD + idx % RP] = __float2bfloat16(0.f);
  __syncthreads();  // the zeros land before any thread scatters U

  for (int k0 = 0; k0 < K; k0 += ZBK) {
    const int kw = min(ZBK, K - k0);  // K % 8 == 0
#pragma unroll
    for (int it = 0; it < VA; ++it) {
      const int vec = tid + it * ZTHREADS;
      const int row = vec / (ZBK / 8);
      const int col = (vec % (ZBK / 8)) * 8;
      const int gm = m0 + row;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (gm < M && col < kw)
        raw = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + k0 + col);
      *reinterpret_cast<uint4*>(&As[row * ZA_LD + col]) = raw;
    }
    // U rows k0 .. k0+kw are kw*r contiguous values (a multiple of 8):
    // 16-byte loads, scattered into the (kk, j) layout; the padding
    // columns j >= r were zeroed before the loop.  A chunk reads its 64
    // columns of the padded U's rows, 16 bytes at a time.
    if constexpr (CHUNK) {
      for (int v = tid; v < kw * (ZW / 8); v += ZTHREADS) {
        const int row = v / (ZW / 8);
        const int col = (v % (ZW / 8)) * 8;
        *reinterpret_cast<uint4*>(&Us[row * ULD + col]) =
            *reinterpret_cast<const uint4*>(u + (size_t)(k0 + row) * ldz +
                                            c0 + col);
      }
    } else
    for (int v = tid; v < kw * r / 8; v += ZTHREADS) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(u + (size_t)k0 * r + v * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int flat = v * 8 + q;
        Us[(flat / r) * ULD + flat % r] = e[q];
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
  // z is written ldz columns wide (zeros past r), the rank step's A2.
  float* zs = Zs[warp];
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
  const int gm = m0 + warp * 16 + er;
  __nv_bfloat16* zrow = z + (size_t)gm * ldz + c0;
#pragma unroll
  for (int f = 0; f < RP / 16; ++f) {
    wmma::store_matrix_sync(zs, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    if (gm < M) {
      uint4 packed;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        e[t] = __float2bfloat16(zs[er * 16 + ec + t]);
      *reinterpret_cast<uint4*>(zrow + f * 16 + ec) = packed;
    }
    __syncwarp();
  }
  if (gm < M)
    for (int c = RP + ec; c < ZW; c += 16)
      *reinterpret_cast<uint4*>(zrow + c) = make_uint4(0, 0, 0, 0);
}

template <int RP>
void launch_z(const __nv_bfloat16* x, const __nv_bfloat16* u,
              __nv_bfloat16* z, int M, int K, int r, cudaStream_t stream) {
  rank_z_kernel<RP><<<(M + ZBM - 1) / ZBM, ZTHREADS, 0, stream>>>(
      x, u, z, M, K, r, ZW);
}

// Past rank 64: z (M, R) from U (K, R), both zero past r.
void launch_z_chunks(const __nv_bfloat16* x, const __nv_bfloat16* u,
                     __nv_bfloat16* z, int M, int K, int r,
                     cudaStream_t stream) {
  const int ldz = (r + ZW - 1) / ZW * ZW;
  const dim3 grid(ldz / ZW, (M + ZBM - 1) / ZBM);
  rank_z_kernel<ZW, true><<<grid, ZTHREADS, 0, stream>>>(x, u, z, M, K, r,
                                                         ldz);
}

}  // namespace

// One dense site on `stream`: out (M, N) bf16 from xa (M, K) (already
// normalized on an LN site), W (K, N), b (N,), U (K, r8) with r8 = r
// rounded up to 8 (past rank 64: R = r rounded up to 64; zero columns
// past r), V (r, N), cb (N,) or null.  act: 0 none, 1 GELU, 2 GELU dact
// (reads g (M, N), writes g * gelu'(pre)), 3 quick_gelu, 4 quick_gelu
// dact; has_res: out = res + dpm[row] * y with res (M, N) bf16 and dpm
// (M,) fp32 (act 0 or 1 only).  z (M, 64) or null: where given (r > 0),
// bf16(xa U), zero past r, is written there; past rank 64 z (M, R) is
// required (the rank pre-pass writes it and the product reads it).  pre
// (M, N) or null: where given (act 1 or 3, no residual), the
// pre-activation bf16(y) is written there.  Needs K and N multiples of 8
// and 16-byte aligned pointers; the Python wrapper checks them.  Returns
// cudaGetLastError() or the tensor-map encoding's error.
extern "C" int cara_cp_site(const void* xa, const void* w, const void* b,
                            const void* u, const void* v, const void* cb,
                            const void* res, const void* dpm, const void* g,
                            void* z, void* out, void* pre, int M, int K,
                            int N, int r, int act, int has_res, float s,
                            void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const bool dact = act == 2 || act == 4;
  if (r < 0 || act < 0 || act > 4 || (has_res && act > 1) ||
      (pre != nullptr && ((act != 1 && act != 3) || has_res)) || M < 1 ||
      K < 8 || K % 8 || N % 8 || (r > BK && z == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs p{};
  p.c16 = static_cast<__nv_bfloat16*>(out);
  p.bias1 = static_cast<const __nv_bfloat16*>(b);
  p.bias2 = static_cast<const __nv_bfloat16*>(cb);
  p.gv = r > 0 ? static_cast<__nv_bfloat16*>(z) : nullptr;
  p.dpm = static_cast<const float*>(dpm);
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_split = K;
  p.s = s;
  const int zn = r == 0 ? 0 : r <= 16 ? 16 : 64;
  const int r8 = (r + 7) / 8 * 8;
  const int rw = (r + BK - 1) / BK * BK;  // past rank 64: z's width R
  GemmMaps maps;
  int err = map2d(&maps.a, xa, K, M, K, BM);
  if (!err) err = map2d(&maps.b, w, N, K, N, 64);
  if (!err && r > BK) {
    p.rc = rw / BK;
    err = map2d(&maps.a2, z, rw, M, rw, BM);
    if (!err) err = map2d(&maps.b2, v, N, r, N, 64);
  } else if (!err && r > 0) {
    err = map2d(&maps.v, u, r8, K, r8, BK, 2, zn);
    if (!err) err = map2d(&maps.b2, v, N, r, N, 64);
  }
  if (!err) err = map2d(&maps.c16, out, N, M, N, BM);
  if (!err && pre != nullptr) err = map2d(&maps.c16b, pre, N, M, N, BM);
  if (!err && (dact || has_res))
    err = map2d(&maps.aux, dact ? g : res, N, M, N, BM);
  if (err) return err;
  if (r > BK) {
    // z (M, R) first: the rank step reads it.
    launch_z_chunks(static_cast<const __nv_bfloat16*>(xa),
                    static_cast<const __nv_bfloat16*>(u),
                    static_cast<__nv_bfloat16*>(z), M, K, r, stream);
    p.gv = nullptr;
  }
  if (has_res)
    return act ? launch_rank<EPI_SITE_GELU_RES>(maps, p, r, stream)
               : launch_rank<EPI_SITE_RES>(maps, p, r, stream);
  switch (act) {
    case 1:
      return pre ? launch_rank<EPI_SITE_GELU_PRE>(maps, p, r, stream)
                 : launch_rank<EPI_SITE_GELU>(maps, p, r, stream);
    case 2: return launch_rank<EPI_SITE_DACT>(maps, p, r, stream);
    case 3:
    case 4:  // the quick_gelu instances, built in cp_site_quick.cu
      return sm90gemm::launch_site_quick(dact, pre != nullptr, maps, p, r,
                                         stream);
    default: return launch_rank<EPI_SITE>(maps, p, r, stream);
  }
}

// The rank product alone: z (M, 64) bf16 = bf16(x @ U), zero past r, for
// x (M, K) bf16 and U (K, r); past rank 64 z (M, R) from U (K, R), R = r
// rounded up to 64, U zero past r.  Needs K % 8 == 0, r >= 1 and 16-byte
// aligned pointers; the Python wrapper checks.  Returns cudaGetLastError().
extern "C" int cara_rank_z(const void* x, const void* u, void* z, int M,
                           int K, int r, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (r < 1 || K < 8 || K % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* xx = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* uu = static_cast<const __nv_bfloat16*>(u);
  __nv_bfloat16* zz = static_cast<__nv_bfloat16*>(z);
  if (r > ZW) launch_z_chunks(xx, uu, zz, M, K, r, stream);
  else if (r <= 16) launch_z<16>(xx, uu, zz, M, K, r, stream);
  else if (r <= 32) launch_z<32>(xx, uu, zz, M, K, r, stream);
  else launch_z<64>(xx, uu, zz, M, K, r, stream);
  return static_cast<int>(cudaGetLastError());
}
