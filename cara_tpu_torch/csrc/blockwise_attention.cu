// Key-tiled (online-softmax) attention for Hopper (sm_90a), forward, on
// the fused qkv GEMM output: TPU row 16.
//
// Reads qkv (B, N, 3E) as it lies -- out-flat (3, H, Dh) columns, so head
// h's q, k and v start at columns h*Dh, E + h*Dh and 2E + h*Dh -- and
// writes the attention output (B, N, E) bf16 and the per-row log-sum-exp
// (B, N, H) fp32 that the backward (blockwise_attention_bwd.cu) reads.
// The tile loop is tiled_attention_fwd.cuh's, which flash_attention.cu
// (row 17) launches on separate q, k, v; here its operands are strided
// views of qkv (row stride 3E) and of the (B, N, E) output (row stride E).
//
// Replaces cara_tpu/ops/pallas/blockwise_attention.py _fwd_kernel (the
// pallas_call in _fwd), TPU row 16: the attention the TPU takes once the
// padded token count passes the full-score kernel's 512 (ViT-B/16 at
// 384 px, 577 tokens).  The TPU kernel walks (bq, bk) = up to 512-wide
// tiles over a sequential key grid axis with m, l and the output
// accumulator in VMEM scratch.  Here persistent blocks, two an SM, walk
// over (image, head, 128-query tile) items: a producer warp loads the
// query rows once and streams K and V in 64-key tiles by TMA through an
// mbarrier ring, and two wgmma warpgroups of 64 query rows keep the score
// tile in registers (tiled_attention_fwd.cuh).
//
// What bounds it: at B = 64, N = 577, H = 12, Dh = 64 the call does
// 4 B N^2 E = 65.5 GFLOP against ~230 MB, ~0.066 ms on the tensor cores
// and ~0.068 ms on HBM, so both about equally; what the design does about
// it, and its times, in tiled_attention_fwd.cuh.

#include "tiled_attention_fwd.cuh"

namespace {

using tiled_attention::Rows;

// The forward at head width dh (16, 32, 64 or 80); keys >= n_real
// (1 <= n_real <= N) masked.  Returns cudaGetLastError() (or the
// shared-memory attribute's error, or cudaErrorInvalidValue).
int attention_fwd(const __nv_bfloat16* q, Rows sq, const __nv_bfloat16* k,
                  Rows sk, const __nv_bfloat16* v, Rows sv,
                  __nv_bfloat16* out, Rows so, float* lse, int B, int N,
                  int heads, int dh, int n_real, float scale,
                  cudaStream_t stream) {
  using tiled_attention::launch_fwd;
  if (n_real < 1 || n_real > N)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16:
      return launch_fwd<16>(q, sq, k, sk, v, sv, out, so, lse, B, N, heads,
                            n_real, scale, stream);
    case 32:
      return launch_fwd<32>(q, sq, k, sk, v, sv, out, so, lse, B, N, heads,
                            n_real, scale, stream);
    case 64:
      return launch_fwd<64>(q, sq, k, sk, v, sv, out, so, lse, B, N, heads,
                            n_real, scale, stream);
    case 80:
      return launch_fwd<80>(q, sq, k, sk, v, sv, out, so, lse, B, N, heads,
                            n_real, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// qkv (B, N, 3E) bf16 -> out (B, N, E) bf16 and lse (B, N, heads) fp32;
// keys >= n_real (1 <= n_real <= N) masked.  dh must be 16, 32, 64 or 80.
// Returns cudaGetLastError() (or the shared-memory attribute's or a
// tensor-map encoding's error).
extern "C" int cara_blockwise_attention(const void* qkv, void* out, void* lse,
                                        int B, int N, int heads, int dh,
                                        int n_real, float scale,
                                        void* stream_ptr) {
  const long long e = (long long)heads * dh;
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(qkv);
  const Rows sqkv{N * 3 * e, dh, 3 * e};
  const Rows so{N * e, dh, e};
  return attention_fwd(in, sqkv, in + e, sqkv, in + 2 * e, sqkv,
                       static_cast<__nv_bfloat16*>(out), so,
                       static_cast<float*>(lse), B, N, heads, dh, n_real,
                       scale, reinterpret_cast<cudaStream_t>(stream_ptr));
}
