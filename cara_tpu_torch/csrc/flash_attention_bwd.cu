// Flash attention for Hopper (sm_90a), backward, on separate q, k and v:
// TPU row 17.
//
// From q, k, v, the forward's output o and log-sum-exp lse (B, N, H)
// (flash_attention.cu) and the output cotangent do, writes dq, dk and dv
// (B, H, N, Dh) bf16; every operand is a base pointer and its (batch,
// head, row) strides, the head dimension contiguous, so the cotangent of
// the model's (B, N, E) view arrives without a copy (each operand gets a
// TMA map of its own strides).  The kernels are tiled_attention_bwd.cuh's,
// shared with row 16 (blockwise_attention_bwd.cu): the coalesced row pass
// for D = rowsum(do * o), one wgmma kernel of five products per (image,
// head, 128-key tile), the dq pass.
//
// Replaces cara_tpu/ops/pallas/flash_attention.py _attn_bwd_kernel (the
// pallas_call in _bwd_rule), TPU row 17.  The TPU kernel recomputes the
// whole (g, N, N) score tile in VMEM from q and k, normalizes it, and
// takes D = rowsum(dp * p) from the fp32 p and dp; here p = exp(s - lse)
// is rebuilt tile by tile from the forward's log-sum-exp, and D comes
// from rowsum(do * o) on the bf16 output (the same sum in exact
// arithmetic; a bf16-level difference).  ds is rounded to bf16 before the
// dq and dk products, as on the TPU.  dq is summed over the key tiles
// through an fp32 scratch in key-tile order, so it is bitwise
// deterministic.
//
// What bounds it: at B = 64, N = 197, H = 12, Dh = 64 the function needs
// five N^2 Dh products (s, dp, dq, dk, dv), 38.2 GFLOP, against ~136 MB:
// ~0.041 ms on HBM, so bytes; at N = 577, 164 GFLOP, ~0.166 ms on the
// tensor cores.  What the design does about it: tiled_attention_bwd.cuh.

#include "tiled_attention_bwd.cuh"

// q, k, v, o, do (bf16) and lse (B, N, heads) fp32 -> dq, dk, dv (bf16).
// Scratch: rows (B, heads, 2, NP) fp32 and dq_acc (B, heads, NP, dh) fp32
// zeroed, NP = N rounded up to 64.  `strides` holds the (batch, head, row)
// strides of q, k, v, o, do, dq, dk, dv in that order.  Head width dh 16,
// 32, 64 or 80.  Returns cudaGetLastError() of the first launch that failed
// (or cudaErrorInvalidValue).
extern "C" int cara_flash_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* rows, void* dq_acc, void* dq,
                                        void* dk, void* dv,
                                        const long long* strides,
                                        int B, int N, int heads, int dh,
                                        float scale, void* stream_ptr) {
  using namespace tiled_attention;
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Rows* s = reinterpret_cast<const Rows*>(strides);
  BwdArgs a{static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v),
            static_cast<const __nv_bfloat16*>(dout),
            s[0], s[1], s[2], s[4],
            static_cast<const float*>(lse), static_cast<float*>(rows),
            static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dq),
            static_cast<__nv_bfloat16*>(dk),
            static_cast<__nv_bfloat16*>(dv), s[5], s[6], s[7],
            N, heads, N, scale};
  const auto* ov = static_cast<const __nv_bfloat16*>(o);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream_ptr);
  switch (dh) {
    case 16: return launch_bwd<16>(a, ov, s[3], B, st);
    case 32: return launch_bwd<32>(a, ov, s[3], B, st);
    case 64: return launch_bwd<64>(a, ov, s[3], B, st);
    case 80: return launch_bwd<80>(a, ov, s[3], B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
