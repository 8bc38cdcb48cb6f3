// Flash attention for Hopper (sm_90a), forward, on separate q, k and v:
// TPU row 17.
//
// q, k, v (B, H, N, Dh) bf16, each given by a base pointer and its
// (batch, head, row) strides with the head dimension contiguous, so the
// views the model holds -- qkv.reshape(B, N, 3, H, Dh) split and
// transposed to (B, H, N, Dh) -- are read as they lie, with no copy.  The
// output goes to any such layout too (the wrapper hands a (B, N, H, Dh)
// buffer, so the model's transpose back to (B, N, E) is free), with the
// per-row log-sum-exp (B, N, H) fp32 that flash_attention_bwd.cu reads.
// The tile loop is tiled_attention_fwd.cuh's, shared with row 16
// (blockwise_attention.cu): persistent blocks, two an SM, over (image,
// head, 128-query tile) items, K and V streamed in 64-key tiles by TMA
// through an mbarrier ring, two wgmma warpgroups of 64 query rows with the
// score tile in registers and an online softmax in fp32; N is taken as it
// is (rows past N zero-filled by TMA, never written).
//
// Replaces cara_tpu/ops/pallas/flash_attention.py _attn_fwd_kernel (the
// pallas_call in _fwd), TPU row 17: the attention of full fine-tuning,
// whose gradients must reach q, k and v as the model's separate views.
// The TPU kernel holds each (g, N, N) score tile whole in VMEM, N padded
// to a multiple of 128 and the padded key columns masked at -1e30; a
// Hopper block has 227 KB, so the N x N tile does not fit at 577 tokens,
// and the key axis is streamed instead.  The TPU normalizes P before its
// bf16 cast; the online softmax rounds P against the running max and
// divides by the row sum at the end: a bf16-level difference.
//
// What bounds it: at B = 64, N = 197, H = 12, Dh = 64 the call needs
// 4 B N^2 E = 15.3 GFLOP against 77.5 MB (q, k, v read once, o written),
// ~0.015 ms on the tensor cores and ~0.023 ms on HBM, so bytes; at N = 577
// both about equally (~0.068 ms).  What the design does about it, and its
// times, in tiled_attention_fwd.cuh.

#include "tiled_attention_fwd.cuh"

namespace {

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, const tiled_attention::Rows* s, int B, int N,
           int heads, float scale, cudaStream_t stream) {
  return tiled_attention::launch_fwd<DH>(
      static_cast<const __nv_bfloat16*>(q), s[0],
      static_cast<const __nv_bfloat16*>(k), s[1],
      static_cast<const __nv_bfloat16*>(v), s[2],
      static_cast<__nv_bfloat16*>(out), s[3], static_cast<float*>(lse), B, N,
      heads, N, scale, stream);
}

}  // namespace

// q, k, v -> out (bf16, any (B, H, N, Dh) strides in `strides`: q, k, v,
// out, each (batch, head, row)) and lse (B, N, heads) fp32 contiguous.
// Head width dh 16, 32, 64 or 80 (the instances rows 2 and 16 build too).
// Returns cudaGetLastError() (or the shared-memory attribute's or a
// tensor-map encoding's error, or cudaErrorInvalidValue).
extern "C" int cara_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    const long long* strides, int B, int N,
                                    int heads, int dh, float scale,
                                    void* stream_ptr) {
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = reinterpret_cast<const tiled_attention::Rows*>(strides);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream_ptr);
  switch (dh) {
    case 16: return launch<16>(q, k, v, out, lse, s, B, N, heads, scale, st);
    case 32: return launch<32>(q, k, v, out, lse, s, B, N, heads, scale, st);
    case 64: return launch<64>(q, k, v, out, lse, s, B, N, heads, scale, st);
    case 80: return launch<80>(q, k, v, out, lse, s, B, N, heads, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
