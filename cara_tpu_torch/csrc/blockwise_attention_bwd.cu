// Key-tiled (online-softmax) attention for Hopper (sm_90a), backward, on
// the fused qkv GEMM output: TPU row 16.
//
// From the qkv activation (B, N, 3E), the forward's output o (B, N, E) and
// log-sum-exp lse (B, N, H) (blockwise_attention.cu) and the output
// cotangent do (B, N, E), writes dqkv (B, N, 3E) bf16 in the qkv layout
// (out-flat (3, H, Dh) columns): no transposes on either side.  The
// kernels are tiled_attention_bwd.cuh's (the D row pass, dq by query
// tiles, dk / dv by key tiles), which flash_attention_bwd.cu (row 17)
// launches on separate q, k, v; here every operand is a strided view of
// qkv, dqkv (row stride 3E) or a (B, N, E) tensor (row stride E).
//
// Replaces cara_tpu/ops/pallas/blockwise_attention.py _dq_kernel and
// _dkv_kernel (the two pallas_calls of _bwd_rule), TPU row 16, with the
// same two-kernel split, plus the row pass D = rowsum(do * o) that JAX
// computes in XLA between them.  Each output row has one writer, so there
// are no atomics.
//
// What bounds it: at B = 64, N = 577, H = 12, Dh = 64 the function needs
// five N^2 Dh products per (image, head) (s, dp, dq, dk, dv), 10 B N^2 E
// = 164 GFLOP, against ~460 MB: ~0.165 ms on the tensor cores, so
// operations.  This first version does seven: it recomputes s and dp in
// both kernels, as the TPU does; wgmma and TMA are later work.

#include "tiled_attention_bwd.cuh"

namespace {

using tiled_attention::BwdArgs;
using tiled_attention::Rows;

// D = rowsum(do * o) into dd (B, N, H) fp32, then dq, dk and dv at head
// width dh (16, 32 or 64); a.dd must be dd.  Keys >= a.n_real
// (1 <= n_real <= N) masked.  Returns cudaGetLastError() of the first
// launch that failed (or cudaErrorInvalidValue).
int attention_bwd(const BwdArgs& a, const __nv_bfloat16* o, Rows so,
                  float* dd, int B, int dh, cudaStream_t stream) {
  using tiled_attention::launch_bwd;
  if (a.n_real < 1 || a.n_real > a.N ||
      tiled_attention::dkv_smem(dh) > tiled_attention::kMaxSmem ||
      a.dd != dd)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16: return launch_bwd<16>(a, o, so, dd, B, stream);
    case 32: return launch_bwd<32>(a, o, so, dd, B, stream);
    case 64: return launch_bwd<64>(a, o, so, dd, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// qkv (B, N, 3E), o and do (B, N, E) bf16, lse (B, N, heads) fp32 ->
// dqkv (B, N, 3E) bf16; dd (B, N, heads) fp32 is scratch for D.  Keys >=
// n_real (1 <= n_real <= N) masked; dh must be 16, 32 or 64.  Returns
// cudaGetLastError() of the first launch that failed.
extern "C" int cara_blockwise_attention_bwd(const void* qkv, const void* o,
                                            const void* dout, const void* lse,
                                            void* dd, void* dqkv, int B,
                                            int N, int heads, int dh,
                                            int n_real, float scale,
                                            void* stream_ptr) {
  const long long e = (long long)heads * dh;
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* d = static_cast<__nv_bfloat16*>(dqkv);
  const Rows sqkv{N * 3 * e, dh, 3 * e};
  const Rows se{N * e, dh, e};
  BwdArgs a{in, in + e, in + 2 * e, static_cast<const __nv_bfloat16*>(dout),
            sqkv, sqkv, sqkv, se, static_cast<const float*>(lse),
            static_cast<const float*>(dd), d, d + e, d + 2 * e, sqkv, sqkv,
            sqkv, N, heads, n_real, scale};
  return attention_bwd(a, static_cast<const __nv_bfloat16*>(o), se,
                       static_cast<float*>(dd), B, dh,
                       reinterpret_cast<cudaStream_t>(stream_ptr));
}
