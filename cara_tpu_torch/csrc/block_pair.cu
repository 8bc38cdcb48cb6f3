// Row 19, the whole-block eval forward after the qkv site: the entry
// point and the GELU instances.  The kernel, its plan and what bounds it
// are in block_pair.cuh; the quick_gelu instances compile beside these in
// block_pair_quick.cu.

#include "block_pair.cuh"

// y (B, N, E) from qkv (B, N, 3E) and x (B, N, E): see block_pair.cuh.
// dh must be 16, 32, 64 or 80, E = heads * dh at most 1280, hidden a
// multiple of 128, 1 <= n_real <= N <= 512, 1 <= r <= ldu with ldu a
// multiple of 8 up to 64, or past rank 64 r rounded up to 64 (u2, mu1 (E,
// ldu) and mu2 (hidden, ldu) zero past r), s != 0; act 0 the exact-erf
// GELU, 1 quick_gelu.  Past rank 64 scratch holds B ceil(N / 64)
// ceil(E / 256) (ldu / 64) 48 256 fp32 words (block_pair.cuh, RK_LOOP);
// else it may be null.  Pointers 16-byte
// aligned; the Python wrapper checks.  Returns cudaGetLastError() (or the
// error of the shared-memory attribute call, of a tensor-map encoding or
// of the cluster launch).
extern "C" int cara_block_pair(
    const void* qkv, const void* x, const void* wp, const void* bp,
    const void* u2, const void* v2, const void* cb2, const void* ls2,
    const void* lb2, const void* w1, const void* b1, const void* mu1,
    const void* mv1, const void* mcb1, const void* w2, const void* b2,
    const void* mu2, const void* mv2, const void* mcb2, void* out,
    void* scratch, int B,
    int N, int heads, int dh, int hidden, int n_real, int r, int ldu,
    int act, float scale, float s, float ln_eps, void* stream_ptr) {
  using namespace block_pair;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int e = heads * dh;
  if (heads < 1 || e > kMaxE || e % 16 || hidden < 128 || hidden % 128 ||
      N < 1 || N > 512 || n_real < 1 || n_real > N || r < 1 || r > ldu ||
      ldu % 8 || (r <= kRankTile && ldu > kRankTile) ||
      (r > kRankTile &&
       (ldu != (r + kRankTile - 1) / kRankTile * kRankTile ||
        scratch == nullptr)) ||
      act < 0 || act > 1 || B < 1 || s == 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  auto bfp = [](const void* v) {
    return static_cast<const __nv_bfloat16*>(v);
  };
  Ptrs g;
  g.qkv = bfp(qkv);
  g.wp = bfp(wp);
  g.u2 = bfp(u2);
  g.v2 = bfp(v2);
  g.w1 = bfp(w1);
  g.mu1 = bfp(mu1);
  g.mv1 = bfp(mv1);
  g.w2 = bfp(w2);
  g.mu2 = bfp(mu2);
  g.mv2 = bfp(mv2);
  Args a;
  a.x = bfp(x);
  a.bp = bfp(bp);
  a.cb2 = bfp(cb2);
  a.ls2 = bfp(ls2);
  a.lb2 = bfp(lb2);
  a.b1 = bfp(b1);
  a.cb1 = bfp(mcb1);
  a.b2 = bfp(b2);
  a.cbh = bfp(mcb2);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.scratch = static_cast<float*>(scratch);
  a.rc = ldu / kRankTile;
  a.N = N;
  a.heads = heads;
  a.n_real = n_real;
  a.e = e;
  a.hidden = hidden;
  int ex;
  a.prescale = frexpf(scale, &ex) != 0.5f;  // not a power of two
  a.scale = scale;
  a.s = s;
  a.eps = ln_eps;
  if (act) return launch_quick(g, a, B, dh, r, ldu, stream);
  return launch_act<ACT_GELU>(g, a, B, dh, r, ldu, stream);
}
