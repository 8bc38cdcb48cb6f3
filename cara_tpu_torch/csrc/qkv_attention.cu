// Layout-native softmax attention for Hopper (sm_90a).
//
// Reads the fused qkv GEMM output (B, N, 3E) as it lies — out-flat
// (3, H, Dh), so head h's q, k and v start at columns h*Dh, E + h*Dh and
// 2E + h*Dh — and writes the attention output (B, N, E) in the layout the
// projection consumes.  No transposes on either side.
//
// Replaces cara_tpu/ops/pallas/fused_qkv_attention.py (_fwd and its
// per-head math _attn_heads), which the attention-block megakernel
// cara_tpu/ops/pallas/cp_attn_block.py also runs.  The TPU kernel holds
// (bb, NP, 3E) tiles and full (NP, NP) score tiles in VMEM.  Here one
// block serves one (image, head, 64-query tile): four warps of 16 query
// rows, with that head's whole K and V in shared memory (197 x 64 x 2 x
// 2 B = 50 KB at ViT-B, above the 48 KB default, hence the opt-in
// attribute).  No score row is ever stored: each warp walks the keys in
// 16-wide tiles twice, first for the row max, then for exp(s - max), the
// row sum and P@V, so the block needs ~74 KB and three blocks fit on an
// SM.  At ViT-B the whole call moves ~80 MB and does ~8 GFLOP, far below
// both roofs; what bounds it is latency (K/V loads, the fp32 softmax
// passes through a 1 KB per-warp scratch), which the three resident
// blocks and cp.async loads of K and V hide.  Register-resident mma.sync
// fragments and a K/V tile shared across query tiles are later work.
//
// Math, as _attn_heads: q is pre-scaled and rounded to bf16; fp32 scores;
// keys >= n_real masked to -1e30; the full-row max, then exp and sum in
// fp32; P rounded to bf16 for P@V; 1/l applied after the product.  The
// kernel masks its own ragged edge (rows past N are zero-filled in shared
// memory and never written), so the TPU's 128-multiple token padding is
// not ported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_warp.cuh"

namespace {

using attn_warp::kPad;

constexpr int kMaxSmem = 232448;  // H100: 227 KB per block (opt-in)
constexpr int kWarps = 4;         // 64 query rows per block

__host__ __device__ inline size_t align128(size_t v) {
  return (v + 127) & ~size_t(127);
}

struct Layout {
  size_t k, v, q, s, p, total;
};

// Shared memory: K and V (npp x (dh + kPad) bf16 each), the block's
// scaled q rows, and per warp a 16x16 fp32 score tile and a 16x16 bf16 P
// tile.  The pad keeps the 16 rows of a fragment load off a single set
// of banks.
__host__ __device__ inline Layout make_layout(int npp, int dh) {
  const size_t ld = dh + kPad;
  Layout o;
  o.k = 0;
  o.v = o.k + align128((size_t)npp * ld * 2);
  o.q = o.v + align128((size_t)npp * ld * 2);
  o.s = o.q + align128((size_t)16 * kWarps * ld * 2);
  o.p = o.s + align128((size_t)kWarps * 256 * 4);
  o.total = o.p + align128((size_t)kWarps * 256 * 2);
  return o;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <int DH>
__global__ void __launch_bounds__(32 * kWarps)
qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out, int N, int heads,
                     int n_real, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int npp = (N + 15) & ~15;
  const Layout lay = make_layout(npp, DH);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + lay.k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + lay.v);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);

  const int e = heads * DH;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * 16 * kWarps;
  const int tid = threadIdx.x;
  const size_t row_stride = 3 * (size_t)e;
  const __nv_bfloat16* base = qkv + (size_t)b * N * row_stride + h * DH;
  constexpr int VPR = DH / 8;  // 16-byte vectors per head row
  constexpr int LD = DH + kPad;

  for (int idx = tid; idx < npp * VPR; idx += blockDim.x) {
    const int key = idx / VPR;
    const int c = (idx % VPR) * 8;
    if (key < N) {
      const __nv_bfloat16* r = base + key * row_stride + c;
      cp_async16(Ks + key * LD + c, r + e);
      cp_async16(Vs + key * LD + c, r + 2 * e);
    } else {
      *reinterpret_cast<uint4*>(Ks + key * LD + c) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(Vs + key * LD + c) = make_uint4(0, 0, 0, 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int idx = tid; idx < 16 * kWarps * VPR; idx += blockDim.x) {
    const int row = idx / VPR;
    const int c = (idx % VPR) * 8;
    const int q = q0 + row;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (q < N) {
      qv = *reinterpret_cast<const uint4*>(base + q * row_stride + c);
      __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(&qv);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        el[t] = __float2bfloat16(__bfloat162float(el[t]) * scale);
    }
    *reinterpret_cast<uint4*>(Qs + row * LD + c) = qv;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qw = q0 + warp * 16;
  if (qw >= N) return;  // no barrier follows
  float* S = reinterpret_cast<float*>(smem + lay.s) + warp * 256;
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(smem + lay.p) +
                     warp * 256;
  attn_warp::AccFrag o[DH / 16];
  const float inv_l = attn_warp::warp_attention<DH>(
      o, Qs + warp * 16 * LD, Ks, Vs, npp, n_real, S, P, lane);

  // out = bf16(o * (1/l)), one 16x16 output tile at a time.
  const int q = qw + (lane >> 1);
  attn_warp::store_rows<DH>(o, inv_l, S,
                            out + ((size_t)b * N + q) * e + h * DH, q < N,
                            lane);
}

template <int DH>
int launch(const __nv_bfloat16* qkv, __nv_bfloat16* out, int B, int N,
           int heads, int n_real, float scale, cudaStream_t stream) {
  const size_t smem = make_layout((N + 15) & ~15, DH).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // Opt in once per process to the largest block this kernel can use.
  static const cudaError_t attr = cudaFuncSetAttribute(
      qkv_attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int qt = 16 * kWarps;
  dim3 grid((N + qt - 1) / qt, heads, B);
  qkv_attention_kernel<DH><<<grid, 32 * kWarps, smem, stream>>>(
      qkv, out, N, heads, n_real, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block needs (0 when it does not fit), so that
// the wrapper can refuse a shape before launching.
extern "C" int cara_qkv_attention_smem(int N, int dh) {
  const size_t smem = make_layout((N + 15) & ~15, dh).total;
  return smem > kMaxSmem ? 0 : static_cast<int>(smem);
}

// qkv (B, N, 3E) bf16 -> out (B, N, E) bf16, keys >= n_real masked.
// dh must be 16, 32 or 64.  Returns cudaGetLastError() (or the error of
// the shared-memory attribute call).
extern "C" int cara_qkv_attention(const void* qkv, void* out, int B, int N,
                                  int heads, int dh, int n_real, float scale,
                                  void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  switch (dh) {
    case 16: return launch<16>(in, o, B, N, heads, n_real, scale, stream);
    case 32: return launch<32>(in, o, B, N, heads, n_real, scale, stream);
    case 64: return launch<64>(in, o, B, N, heads, n_real, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
