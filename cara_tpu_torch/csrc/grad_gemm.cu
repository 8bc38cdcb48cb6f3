// The GEMMs of the block backward kernels for Hopper (sm_90a), on the
// wgmma + TMA core of sm90_gemm.cuh (its head comment has the layouts,
// the epilogues and the rank step):
//
//   NN   forward recompute (qkv, pre = xa W1 + b1 + s cb1 with PRE_GELU)
//   NT   dx products g W'^T (BF16, F32; DGELU with gelu'(pre), DGELU_H
//        with gelu'(pre) and h = gelu(pre) from the saved bf16 pre)
//   TN   dense cotangents dT = x^T g (F32)
//
// NN and NT take an optional rank step, the delta scale folded into B2 by
// the caller: NN reads A2 = bf16(x U) (M, 64) from memory (cara_rank_z of
// cp_site.cu), B2 = V (r, N); NT folds gv = bf16(g V^T) in, as
// _cp_dense_dx_kernel does, B2 = U (N, r8), r8 = r rounded up to 8.  Past
// rank 64 both read A2 (M, R) from memory, R = r rounded up to 64 (NT: gv
// written by cara_rank_z first, B2 = U (N, R)), in R / 64 k-tiles of 64
// (sm90_gemm.cuh, RK_LOOP): a folded gv would hold R / 2 more fp32
// registers a thread beside the accumulators.  That
// is the TPU kernels' rank-space delta: _cp_dense_dx_kernel's g W^T + s
// (g V^T) U^T (cp_dense.py, row 12) and _mlp_bwd_kernel's fc1 recompute,
// dh and dxa (cp_mlp.py, row 10).  The delta is never folded into a dense
// W + s U V, which would round it at W's scale.
//
// Replaces the products inside cara_tpu/ops/pallas/cp_attn_block.py
// _attn_block_bwd_wd_kernel (qkv recompute, g wp'^T, dqkv wq'^T, o^T g,
// xa^T dqkv), cara_tpu/ops/pallas/cp_mlp.py _mlp_bwd_wd_kernel (row 11:
// pre recompute, g w2'^T with gelu', dpre w1'^T, xa^T dpre, h^T g) and
// cara_tpu/ops/pallas/cp_dense.py _cp_dense_dx_kernel (row 12's dx).  In
// the save-pre mode (_mlp_bwd_kernel(saved_pre=True),
// _mlp_bwd_wd_pre_kernel) the pre recompute goes: DGELU_H reads the bf16
// pre the forward site wrote (2 bytes an output against DGELU's 4) and
// writes h = bf16(gelu(pre)) beside dpre, the h those kernels take from
// the saved pre.  The
// TPU kernels keep every intermediate of a 256-row tile in VMEM and
// accumulate dT over the sequential grid; on Hopper the grid is parallel,
// so the dT products reduce over the M = B * N token rows inside each
// block, optionally split over blockIdx.z, the splits' tiles added into
// the output one after another in split order (an ordering counter a
// tile, TMA reduce-add): no unordered atomics, runs repeat bit for bit.
//
// What bounds it: at ViT-B every product is 15-60 GFLOP against 20-80 MB,
// far above the H100's ~295 FLOP/byte ridge, so the tensor cores; the
// PRE_GELU and DGELU epilogues move 6 bytes an output (232 MB at M =
// 12608, hidden 3072), which puts their bound on bytes.  A block is 128 x
// 256 where the output allows and 128 x 128 for narrow outputs and the
// 6-byte epilogues, where one block's products run while the other stores
// (pick_bn).  Measured on one H100 80GB HBM3 at 700 W
// (tools/compare_parent.py, in turns with the previous mma.sync design),
// row 11's products at M 12608, E 768, hidden 3072, ms a call by events:
// NN PRE_GELU 0.216-0.228 (previous 0.325-0.334), NT DGELU 0.215-0.242
// (0.386-0.408), NT dxa 0.131-0.150 (0.270-0.275), TN dT 0.133-0.163
// (0.357-0.365), torch.matmul on the same shapes 0.092-0.121.  The folded
// variants at a 128-wide block spill (96 registers for two blocks an SM)
// and ptxas serializes their wgmma.
//
// The activation of PRE_GELU, DGELU and DGELU_H is a template parameter
// (gelu.cuh): the exact-erf GELU, or CLIP's quick_gelu for the
// act="quick_gelu" mode of the same TPU kernels (_mlp_bwd_kernel,
// _mlp_bwd_wd_kernel and their saved-pre forms: CLIP ViT-L/14's MLP
// blocks), y sigma(1.702 y) and sigma + 1.702 y sigma (1 - sigma) from
// one expf.  The same tiles and bytes, so the same bound and the same
// 128-wide blocks for these 6-byte epilogues; only those three
// epilogues have quick instances (NN and NT, each rank step).

#include "sm90_gemm.cuh"

namespace {

// The block width: 128 or 256 columns (pick_bn); the epilogues that move
// 6 bytes an output always take 128.
template <int L, int E, int RK, int ZN, int ACT = ACT_GELU>
int launch_bn(const GemmMaps& maps, const GemmArgs& p, int splits, int bn,
              cudaStream_t stream) {
  if constexpr (E == EPI_F32 || E == EPI_BF16)
    if (bn == 256) return launch<L, E, 256, RK, ZN>(maps, p, splits, stream);
  return launch<L, E, 128, RK, ZN, ACT>(maps, p, splits, stream);
}

// NN: no rank step, or A2 from memory 16 or 64 deep (rk 1 or 4), or p.rc
// tiles of 64 (RK_LOOP).
template <int E, int ACT = ACT_GELU>
int launch_nn(const GemmMaps& maps, const GemmArgs& p, int rk, int bn,
              cudaStream_t stream) {
  if (rk == 1) return launch_bn<NN, E, 1, 0, ACT>(maps, p, 1, bn, stream);
  if (rk == 4) return launch_bn<NN, E, 4, 0, ACT>(maps, p, 1, bn, stream);
  if (rk == RK_LOOP)
    return launch_bn<NN, E, RK_LOOP, 0, ACT>(maps, p, 1, bn, stream);
  return launch_bn<NN, E, 0, 0, ACT>(maps, p, 1, bn, stream);
}

// NT: no rank step, the folded one with z 16 or 64 wide, or past rank 64
// gv from memory in p.rc tiles of 64 (RK_LOOP).
template <int E, int ACT = ACT_GELU>
int launch_nt(const GemmMaps& maps, const GemmArgs& p, int rk, int bn,
              cudaStream_t stream) {
  if (rk == 1) return launch_bn<NT, E, 1, 16, ACT>(maps, p, 1, bn, stream);
  if (rk == 4) return launch_bn<NT, E, 4, 64, ACT>(maps, p, 1, bn, stream);
  if (rk == RK_LOOP)
    return launch_bn<NT, E, RK_LOOP, 0, ACT>(maps, p, 1, bn, stream);
  return launch_bn<NT, E, 0, 0, ACT>(maps, p, 1, bn, stream);
}

// The block width (measured at ViT-B's shapes on one H100): 256 columns,
// one block an SM, where the output allows; 128, two blocks an SM, for M
// or N < 256 and for the epilogues that move 6 bytes an output
// (PRE_GELU's fp32 pre and bf16 h; DGELU's fp32 pre read and bf16 dpre
// written; DGELU_H's bf16 pre read, dpre and h written), where the second
// block's products run while one block stores.  _bwd.dt_splits assumes
// the same rule.
int pick_bn(int epi, int M, int N) {
  return (M < 256 || N < 256 || epi == EPI_PRE_GELU || epi_dgelu(epi))
             ? 128
             : 256;
}

}  // namespace

// C = op(A) . op(B) [+ A2 . B2] with the given layout (0 NN, 1 NT,
// 2 TN) and epilogue (0 F32, 1 BF16, 2 PRE_GELU, 3 DGELU, 9 DGELU_H: aux
// the bf16 pre-activation, h written to c16b); act picks the activation
// of PRE_GELU, DGELU and DGELU_H (0 the exact-erf GELU, 1 quick_gelu;
// 0 for the other epilogues); see the head comment for the operand
// shapes.  `splits` > 1 (TN, F32 only) splits the
// contraction over that many blocks a tile, summed into C in order; turn
// then holds one zeroed int32 a 128 x 128 output tile, zero again when
// the product ends (one launch at a time may use it: a stream's).  NN:
// a2 (M, 64) and b2 (r2, N), r2 <= 64, add the rank step (null a2:
// none); past rank 64 a2 is (M, R), R = r2 rounded up to 64.  NT: vfold
// (rfold, K), rfold <= 64, folds the rank operand in: z = bf16(A
// vfold^T), written to gv (M, 64), is A2 for B2 = b2 (N, ldb2) of depth
// r2 (rfold rounded up to 8); or, past rank 64, a2 (M, R) from memory
// (null vfold) with b2 (N, ldb2 = R) zero past the rank r2; null vfold
// and a2: no rank step.  Needs M (TN), N and K (NN, NT) multiples of 8
// and 16-byte aligned pointers; the wrapper checks.  Returns
// cudaGetLastError() or the tensor-map encoding's error.
extern "C" int cara_grad_gemm(int layout, int epi, int act, const void* a,
                              const void* b, void* c32, void* c16,
                              void* c16b, const void* bias1, const void* bias2,
                              const void* aux, void* colpart, const void* a2,
                              const void* b2, const void* vfold, void* gv,
                              void* turn, int M, int N, int K, int splits,
                              int r2, int ldb2, int rfold,
                              void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  GemmArgs p{};
  p.c32 = static_cast<float*>(c32);
  p.c16 = static_cast<__nv_bfloat16*>(c16);
  p.bias1 = static_cast<const __nv_bfloat16*>(bias1);
  p.bias2 = static_cast<const __nv_bfloat16*>(bias2);
  p.aux = aux;
  p.colpart = static_cast<float*>(colpart);
  p.gv = static_cast<__nv_bfloat16*>(gv);
  p.turn = static_cast<int*>(turn);
  p.M = M;
  p.N = N;
  p.K = K;
  const bool act_epi = epi == EPI_PRE_GELU || epi_dgelu(epi);
  if (splits < 1 || act < 0 || act > 1 || (act && !act_epi) ||
      (splits > 1 && !(layout == TN && epi == EPI_F32 && turn != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int rk = 0;  // the rank step's k-steps of 16, or RK_LOOP
  const int rw = (r2 + BK - 1) / BK * BK;  // A2's width past rank 64
  if (layout == NN && a2 != nullptr) {
    if (b2 == nullptr || r2 < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    rk = r2 <= 16 ? 1 : r2 <= BK ? 4 : RK_LOOP;
  } else if (layout == NT && vfold != nullptr) {
    rk = rfold <= 16 ? 1 : 4;
    if (b2 == nullptr || gv == nullptr || rfold < 1 || rfold > BK ||
        K < 1 || r2 != (rfold + 7) / 8 * 8 || ldb2 < r2 || ldb2 % 8 ||
        a2 != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (layout == NT && a2 != nullptr) {
    rk = RK_LOOP;
    if (b2 == nullptr || r2 <= BK || ldb2 != rw)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (a2 != nullptr || vfold != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rk == RK_LOOP) p.rc = rw / BK;
  const int per = (K + splits - 1) / splits;
  p.k_split = splits > 1 ? (per + BK - 1) / BK * BK : K;

  const int bn = pick_bn(epi, M, N);
  GemmMaps maps;
  int err = layout == TN ? map2d(&maps.a, a, M, K, M, 64)
                         : map2d(&maps.a, a, K, M, K, BM);
  if (!err)
    err = layout == NT ? map2d(&maps.b, b, K, N, K, bn)
                       : map2d(&maps.b, b, N, K, N, 64);
  const int lda2 = rk == RK_LOOP ? rw : BK;
  if (!err && rk && layout == NN) {
    err = map2d(&maps.a2, a2, lda2, M, lda2, BM);
    if (!err) err = map2d(&maps.b2, b2, N, r2, N, 64);
  }
  if (!err && rk && layout == NT) {
    err = map2d(&maps.b2, b2, r2, N, ldb2, bn);
    if (!err && rk == RK_LOOP)
      err = map2d(&maps.a2, a2, lda2, M, lda2, BM);
    else if (!err)
      err = map2d(&maps.v, vfold, K, rfold, K, 16 * rk);
  }
  if (!err && (epi == EPI_F32 || epi == EPI_PRE_GELU))
    err = map2d(&maps.c32, c32, N, M, N, BM, 4);
  if (!err && epi != EPI_F32) err = map2d(&maps.c16, c16, N, M, N, BM);
  if (!err && epi == EPI_DGELU) err = map2d(&maps.aux, aux, N, M, N, BM, 4);
  if (!err && epi == EPI_DGELU_H) {
    err = map2d(&maps.aux, aux, N, M, N, BM);
    if (!err) err = map2d(&maps.c16b, c16b, N, M, N, BM);
  }
  if (err) return err;

  if (layout == NN && epi == EPI_BF16)
    return launch_nn<EPI_BF16>(maps, p, rk, bn, stream);
  if (layout == NN && epi == EPI_PRE_GELU)
    return act ? launch_nn<EPI_PRE_GELU, ACT_QUICK_GELU>(maps, p, rk, bn,
                                                        stream)
               : launch_nn<EPI_PRE_GELU>(maps, p, rk, bn, stream);
  if (layout == NT && epi == EPI_BF16)
    return launch_nt<EPI_BF16>(maps, p, rk, bn, stream);
  if (layout == NT && epi == EPI_F32)
    return launch_nt<EPI_F32>(maps, p, rk, bn, stream);
  if (layout == NT && epi == EPI_DGELU)
    return act ? launch_nt<EPI_DGELU, ACT_QUICK_GELU>(maps, p, rk, bn,
                                                     stream)
               : launch_nt<EPI_DGELU>(maps, p, rk, bn, stream);
  if (layout == NT && epi == EPI_DGELU_H)
    return act ? launch_nt<EPI_DGELU_H, ACT_QUICK_GELU>(maps, p, rk, bn,
                                                       stream)
               : launch_nt<EPI_DGELU_H>(maps, p, rk, bn, stream);
  if (layout == TN && epi == EPI_F32)
    return launch_bn<TN, EPI_F32, 0, 0>(maps, p, splits, bn, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
