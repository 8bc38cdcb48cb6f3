// Key-tiled (online-softmax) attention for Hopper (sm_90a), backward, on
// the fused qkv GEMM output: TPU row 16.
//
// From the qkv activation (B, N, 3E), the forward's output o (B, N, E) and
// log-sum-exp lse (B, N, H) (blockwise_attention.cu) and the output
// cotangent do (B, N, E), writes dqkv (B, N, 3E) bf16 in the qkv layout
// (out-flat (3, H, Dh) columns): no transposes on either side.  The
// kernels are tiled_attention_bwd.cuh's (the coalesced row pass for D,
// one wgmma kernel of five products per (image, head, 128-key tile), the
// dq pass), which flash_attention_bwd.cu (row 17) launches on separate q,
// k, v; here every operand is a strided view of qkv, dqkv (row stride 3E)
// or a (B, N, E) tensor (row stride E), each read by its own TMA map.
//
// Replaces cara_tpu/ops/pallas/blockwise_attention.py _dq_kernel and
// _dkv_kernel (the two pallas_calls of _bwd_rule), TPU row 16, plus the
// row pass D = rowsum(do * o) that JAX computes in XLA between them.  What
// bounds it and what the design does about it: tiled_attention_bwd.cuh.
// dq is summed over the key tiles through an fp32 scratch in key-tile
// order, so it is bitwise deterministic.

#include "tiled_attention_bwd.cuh"

namespace {

using tiled_attention::BwdArgs;
using tiled_attention::Rows;

// The row pass, dq, dk and dv at head width dh (16, 32, 64 or 80).  Keys >=
// a.n_real (1 <= n_real <= N) masked.  Returns cudaGetLastError() of the
// first launch that failed (or cudaErrorInvalidValue).
int attention_bwd(const BwdArgs& a, const __nv_bfloat16* o, Rows so, int B,
                  int dh, cudaStream_t stream) {
  using tiled_attention::launch_bwd;
  if (a.n_real < 1 || a.n_real > a.N)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16: return launch_bwd<16>(a, o, so, B, stream);
    case 32: return launch_bwd<32>(a, o, so, B, stream);
    case 64: return launch_bwd<64>(a, o, so, B, stream);
    case 80: return launch_bwd<80>(a, o, so, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// qkv (B, N, 3E), o and do (B, N, E) bf16, lse (B, N, heads) fp32 ->
// dqkv (B, N, 3E) bf16.  Scratch: rows (B, heads, 2, NP) fp32 and dq_acc
// (B, heads, NP, dh) fp32 zeroed, NP = N rounded up to 64.  Keys >= n_real
// (1 <= n_real <= N) masked; dh must be 16, 32, 64 or 80.  Returns
// cudaGetLastError() of the first launch that failed.
extern "C" int cara_blockwise_attention_bwd(const void* qkv, const void* o,
                                            const void* dout, const void* lse,
                                            void* rows, void* dq_acc,
                                            void* dqkv, int B, int N,
                                            int heads, int dh, int n_real,
                                            float scale, void* stream_ptr) {
  const long long e = (long long)heads * dh;
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* d = static_cast<__nv_bfloat16*>(dqkv);
  const Rows sqkv{N * 3 * e, dh, 3 * e};
  const Rows se{N * e, dh, e};
  BwdArgs a{in, in + e, in + 2 * e, static_cast<const __nv_bfloat16*>(dout),
            sqkv, sqkv, sqkv, se, static_cast<const float*>(lse),
            static_cast<float*>(rows), static_cast<float*>(dq_acc), d, d + e,
            d + 2 * e, sqkv, sqkv, sqkv, N, heads, n_real, scale};
  return attention_bwd(a, static_cast<const __nv_bfloat16*>(o), se, B, dh,
                       reinterpret_cast<cudaStream_t>(stream_ptr));
}
