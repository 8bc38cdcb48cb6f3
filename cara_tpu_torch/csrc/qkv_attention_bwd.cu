// Layout-native softmax-attention backward for Hopper (sm_90a): TPU row 2.
//
// Reads the qkv activation (B, N, 3E) and the output cotangent do
// (B, N, E) as they lie (out-flat (3, H, Dh) columns, as
// qkv_attention.cu's forward) and writes dqkv (B, N, 3E) in the same
// layout: no transposes on either side.  Every operand is a strided view
// read (or written) by a TMA map of its own strides.
//
// Replaces cara_tpu/ops/pallas/fused_qkv_attention.py _bwd_rule's
// pallas_call (_bwd_kernel, per-head math attn_bwd_tile), which the
// attention-block backward _attn_block_bwd_wd_kernel (cp_attn_block.py)
// also runs on its resident tile.  JAX's residual is qkv alone, so the row
// statistics are computed here.
//
// What bounds it on the H100: at B = 64, N = 197, H = 12, Dh = 64 the
// function needs five N^2 Dh products (s, dp, dq, dk, dv; 38.2 GFLOP)
// against 135.6 MB (qkv and do read, dqkv written): 0.0405 ms on HBM, so
// bytes.  The previous design (one block per (image, head) holding that
// head's q, k, v and do whole in shared memory, 16x16 wmma tiles with every
// fp32 score tile through a per-warp scratch tile, s formed four times and
// dp three: ten N^2 Dh products) ran at 2-2.5x SDPA's backward and
// refused N > 352 (4 x 72 x 2 B a row past 227 KB).  This design puts the
// function on the key-tile loop of rows 16 and 17's backward
// (tiled_attention_bwd.cuh), keys streamed, so every N that row 1's
// forward takes (up to 512) trains:
//   stats  tiled_attention_fwd.cuh's kernel in statistics mode: one
//          persistent block per SM over (image, head, 128-query tile)
//          items, s = q k^T and dp = do v^T on wgmma per 128-key tile,
//          lse = m + log l and D = sum p dp in fp32 with l and the sum
//          rescaled online, into the (B, H, 2, NP) rows;
//   main   one block per (image, head, 128-key tile), five wgmma products
//          per 64-query tile (s^T, dp^T, dv += bf16(p^T) do, dk += ds^T q,
//          dq = ds k), dq partials added into a zeroed fp32 scratch by
//          cp.reduce.async.bulk;
//   dq     scale, round to bf16 and write dq into the qkv layout.
// Measured on one H100 80GB HBM3 at 700 W (tools/compare_parent.py, two
// rounds in turns with the previous design; 20 calls back to back):
// 0.264 ms at B = 64, N = 197 (previous 0.583-0.588), 15 % of the bound,
// about SDPA's backward in the same turns; 0.789-0.795 ms at N = 512,
// which the previous design refused.  What holds it there: the main
// kernel's per-tile chain (tiled_attention_bwd.cuh), and around it the
// statistics pass, the zeroed dq scratch and the dq pass, which read q,
// k, v and do once more and move the fp32 dq sum twice.
//
// Rounding points against attn_bwd_tile: p = exp(s - lse) normalized in
// fp32 before its bf16 cast for dv; D = sum p dp from the fp32 p and dp;
// ds = bf16(p (dp - D)); dq = (ds k) * scale; each of dq, dk, dv rounded
// once.  The scores are s = (q . k) * scale in fp32 and dk = (ds^T q) *
// scale, where attn_bwd_tile takes qs = bf16(q * scale), s = qs . k and
// dk = ds^T qs: the same at a power-of-two scale (Dh 16, 64), a bf16-level
// difference at Dh 32 and 80.  dq's fp32 sum over the key tiles is taken
// in key-tile order (tiled_attention_bwd.cuh), so dq, dk and dv are
// bitwise deterministic from call to call.

#include "tiled_attention_bwd.cuh"

namespace {

using tiled_attention::BwdArgs;
using tiled_attention::FwdArgs;
using tiled_attention::Rows;

template <int DH>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  using namespace tiled_attention;
  const FwdArgs f{nullptr, a.rows, B, a.N, a.heads, a.n_real, a.scale};
  const int err = launch_fwd_kernel<DH, true>(a.q, a.sq, a.k, a.sk, a.v,
                                              a.sv, a.dout, a.sdo, f, stream);
  if (err) return err;
  return launch_bwd_tiles<DH>(a, B, stream);
}

}  // namespace

// qkv (B, N, 3E), do (B, N, E) bf16 -> dqkv (B, N, 3E) bf16, keys >=
// n_real (1 <= n_real <= N) masked.  Scratch: rows (B, heads, 2, NP) fp32
// and dq_acc (B, heads, NP, dh) fp32 zeroed, NP = N rounded up to 64.  dh
// must be 16, 32, 64 or 80.  Returns cudaGetLastError() of the first launch
// that failed (or cudaErrorInvalidValue, or a tensor-map encoding error).
extern "C" int cara_qkv_attention_bwd(const void* qkv, const void* dout,
                                      void* rows, void* dq_acc, void* dqkv,
                                      int B, int N, int heads, int dh,
                                      int n_real, float scale,
                                      void* stream_ptr) {
  if (n_real < 1 || n_real > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long e = (long long)heads * dh;
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* d = static_cast<__nv_bfloat16*>(dqkv);
  const Rows sqkv{N * 3 * e, dh, 3 * e};
  const Rows se{N * e, dh, e};
  const BwdArgs a{in, in + e, in + 2 * e,
                  static_cast<const __nv_bfloat16*>(dout), sqkv, sqkv, sqkv,
                  se, nullptr, static_cast<float*>(rows),
                  static_cast<float*>(dq_acc), d, d + e, d + 2 * e, sqkv,
                  sqkv, sqkv, N, heads, n_real, scale};
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  switch (dh) {
    case 16: return launch<16>(a, B, stream);
    case 32: return launch<32>(a, B, stream);
    case 64: return launch<64>(a, B, stream);
    case 80: return launch<80>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
