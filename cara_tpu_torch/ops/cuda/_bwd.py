"""Launchers of the kernels the backward wrappers compose
(``csrc/grad_gemm.cu``, ``csrc/block_rows.cu`` and the rank pre-pass of
``csrc/cp_site.cu``), and the plain LayerNorm input backward they mirror.

These are the products and row passes inside the TPU kernels
``_attn_block_bwd_wd_kernel``, ``_mlp_bwd_wd_kernel``, ``_mlp_bwd_kernel``
and ``_cp_dense_dx_kernel``; they carry no launch counters of their own
(the wrappers count).  Every launcher takes bf16 CUDA tensors (fp32 where
it says so), checks them and raises on what the kernel does not take.
"""

from __future__ import annotations

import torch

from cara_tpu_torch.ops.cuda import _build

NN, NT, TN = 0, 1, 2
EPI_F32, EPI_BF16, EPI_PRE_GELU, EPI_DGELU = 0, 1, 2, 3
_GEMM_BM = 128
# Blocks that fill the card: 132 SMs, two GEMM blocks each.
_SLOTS = 264
#: Width of the rank pre-pass output: the GEMMs' 64-deep rank k-step.
RANK_W = 64


def ln_input_bwd_plain(x, dxa, ls, eps: float):
    """d(x) of LayerNorm given d(LN(x)), frozen scale and bias, fp32
    (``cp_mlp._ln_input_bwd``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xn = (xf - mu) * rstd
    dyg = dxa * ls.float()
    return rstd * (dyg - dyg.mean(-1, keepdim=True)
                   - xn * (dyg * xn).mean(-1, keepdim=True))


def _f32(name, key, t, dev):
    if (t.device != dev or t.dtype != torch.float32
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {key} must be a contiguous fp32 tensor "
                         f"on {dev}")


def gemm(layout: int, epi: int, a, b, *, bias1=None, bias2=None, aux=None,
         splits: int = 1, a2=None, b2=None):
    """One ``grad_gemm.cu`` product; returns the epilogue's outputs.

    NN: a (M, K), b (K, N).  NT: a (M, K), b (N, K).  TN: a (K, M),
    b (K, N) -> (splits, M, N) fp32 partial planes.  F32 -> c32;
    BF16 -> c16; PRE_GELU -> (pre fp32, gelu bf16), pre = acc + bias1 +
    bias2; DGELU (``aux`` the fp32 pre-activation) -> (dpre bf16,
    column partial sums (M/128, N) fp32).

    ``a2`` (M, 64) with ``b2`` adds the rank step ``a2 @ b2`` to the
    accumulators (NN, NT): NN b2 = V (r, N); NT b2 = U (N, r8) with r8 a
    multiple of 8 (:func:`pad_cols8`); a delta scale rides ``b2``
    (:func:`scaled`)."""
    dev = a.device
    _build.check_cuda_inputs("grad_gemm", dev, a=a, b=b, bias1=bias1,
                             bias2=bias2, a2=a2, b2=b2)
    if layout == TN:
        k, m = a.shape
        n = b.shape[1]
        ok = b.shape[0] == k
    else:
        m, k = a.shape
        n = b.shape[1] if layout == NN else b.shape[0]
        ok = b.shape[0 if layout == NN else 1] == k
    if not ok:
        raise ValueError(f"grad_gemm: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} do not chain (layout {layout})")
    # 16-byte loads run along the contiguous axis of each operand.
    if n % 8 or (m if layout == TN else k) % 8:
        raise ValueError(f"grad_gemm needs N and the contiguous axis of A "
                         f"to be multiples of 8, got M={m} N={n} K={k} "
                         f"(layout {layout})")
    for key, t in (("bias1", bias1), ("bias2", bias2)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"grad_gemm: {key} must be ({n},)")
    r2 = ldb2 = 0
    if a2 is not None:
        r2 = b2.shape[0] if layout == NN else b2.shape[1]
        ldb2 = b2.shape[1]
        ok = (layout != TN and a2.shape == (m, RANK_W) and 1 <= r2 <= RANK_W
              and (b2.shape == (r2, n) if layout == NN
                   else b2.shape[0] == n and r2 % 8 == 0))
        if not ok:
            raise ValueError(f"grad_gemm rank step: a2 {tuple(a2.shape)} b2 "
                             f"{tuple(b2.shape)} (layout {layout})")
    c32 = c16 = colpart = None
    if epi == EPI_F32:
        c32 = torch.empty((splits, m, n) if layout == TN else (m, n),
                          device=dev, dtype=torch.float32)
    if epi in (EPI_BF16, EPI_PRE_GELU, EPI_DGELU):
        c16 = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
    if epi == EPI_PRE_GELU:
        c32 = torch.empty((m, n), device=dev, dtype=torch.float32)
    if epi == EPI_DGELU:
        _f32("grad_gemm", "aux", aux, dev)
        if aux.shape != (m, n):
            raise ValueError("grad_gemm: aux must be the (M, N) "
                             "pre-activation")
        colpart = torch.empty(((m + _GEMM_BM - 1) // _GEMM_BM, n),
                              device=dev, dtype=torch.float32)
    code = _build.lib().cara_grad_gemm(
        layout, epi, a.data_ptr(), b.data_ptr(), _build.ptr(c32),
        _build.ptr(c16), _build.ptr(bias1), _build.ptr(bias2),
        _build.ptr(aux), _build.ptr(colpart), _build.ptr(a2),
        _build.ptr(b2), m, n, k, splits, r2, ldb2, _build.stream_ptr(dev))
    _build.check(code, "grad_gemm")
    if epi == EPI_F32:
        return c32
    if epi == EPI_BF16:
        return c16
    if epi == EPI_PRE_GELU:
        return c32, c16
    return c16, colpart


def dt_splits(m: int, n: int, k: int) -> int:
    """Contraction splits of a TN product (output (m, n), contraction k)
    so that about two blocks per SM run: more splits for small planes
    (up to 32 for a rank-space product, whose few output tiles must still
    fill the card while each block streams its slice of the rows)."""
    tiles = -(-m // _GEMM_BM) * -(-n // _GEMM_BM)
    return max(1, min(32, _SLOTS // tiles, k // 64))


def rank_z(x2, u, trans: bool = False):
    """z = bf16(x2 @ U) (M, 64), zero past the rank, for x2 (M, K): U is
    (K, r), or (r, K) with ``trans`` (then z = bf16(x2 @ U^T), the ``g
    V^T`` of the backward).  The pre-pass of ``csrc/cp_site.cu``."""
    m, k = x2.shape
    dev = x2.device
    _build.check_cuda_inputs("rank_z", dev, x=x2, u=u)
    r = u.shape[0] if trans else u.shape[1]
    if (u.shape != ((r, k) if trans else (k, r)) or not 1 <= r <= RANK_W
            or k % 64):
        raise ValueError(f"rank_z needs K % 64 == 0 and rank 1..64: x "
                         f"{tuple(x2.shape)} u {tuple(u.shape)} "
                         f"(trans={trans})")
    z = torch.empty((m, RANK_W), device=dev, dtype=torch.bfloat16)
    code = _build.lib().cara_rank_z(x2.data_ptr(), u.data_ptr(),
                                    z.data_ptr(), m, k, r, int(trans),
                                    _build.stream_ptr(dev))
    _build.check(code, "rank_z")
    return z


def scaled(t, s: float):
    """``s * t`` in t's dtype: the kernels take no delta scale, the
    callers fold it into a rank factor or bias (identity at s = 1)."""
    return t if s == 1.0 else (t * s).contiguous()


def pad_cols8(u):
    """U (K, r) -> (K, r rounded up to 8), zero columns past r: the NT
    rank step's B operand (16-byte rows)."""
    k, r = u.shape
    r8 = -(-r // 8) * 8
    if r8 == r:
        return u
    out = u.new_zeros((k, r8))
    out[:, :r] = u
    return out


def factor_grad(a, b):
    """fp32 ``a^T b`` over the M token rows for a (M, P), b (M, Q), one of
    them 64 wide: a TN product split over M into partial planes, summed
    in a fixed order (no atomics).  Reads each operand once."""
    mrows, p = a.shape
    q = b.shape[1]
    splits = dt_splits(p, q, mrows)
    parts = gemm(TN, EPI_F32, a, b, splits=splits)
    if splits == 1:
        return parts[0]
    return colsum(parts.reshape(splits, -1)).reshape(p, q)


def ln_rows(x2, ls, lb, eps: float):
    """xa = bf16(LN(x2)) for x2 (M, K)."""
    m, k = x2.shape
    dev = x2.device
    _build.check_cuda_inputs("ln_rows", dev, x=x2, ln_scale=ls, ln_bias=lb)
    out = torch.empty_like(x2)
    code = _build.lib().cara_ln_rows(
        x2.data_ptr(), ls.data_ptr(), lb.data_ptr(), out.data_ptr(), m, k,
        float(eps), _build.stream_ptr(dev))
    _build.check(code, "ln_rows")
    return out


def gate_rows(g2, dpm_rows):
    """bf16(g2 * dpm_rows[:, None]) for g2 (M, N), dpm_rows (M,) fp32."""
    m, n = g2.shape
    dev = g2.device
    _build.check_cuda_inputs("gate_rows", dev, g=g2)
    _f32("gate_rows", "dpm", dpm_rows, dev)
    if dpm_rows.shape != (m,) or n % 8:
        raise ValueError("gate_rows wants dpm (M,) and N % 8 == 0")
    out = torch.empty_like(g2)
    code = _build.lib().cara_gate_rows(
        g2.data_ptr(), dpm_rows.data_ptr(), out.data_ptr(), m, n,
        _build.stream_ptr(dev))
    _build.check(code, "gate_rows")
    return out


def ln_bwd_residual(x2, dxa, ls, g2, eps: float):
    """bf16(g2 + LN'(x2) . dxa): the block's dx (x2, g2 (M, K) bf16, dxa
    (M, K) fp32); ``g2`` None drops the residual term."""
    m, k = x2.shape
    dev = x2.device
    _build.check_cuda_inputs("ln_bwd_residual", dev, x=x2, ln_scale=ls,
                             g=g2)
    _f32("ln_bwd_residual", "dxa", dxa, dev)
    if dxa.shape != (m, k) or (g2 is not None and g2.shape != (m, k)):
        raise ValueError("ln_bwd_residual: x, dxa and g must agree")
    out = torch.empty_like(x2)
    code = _build.lib().cara_ln_bwd_residual(
        x2.data_ptr(), dxa.data_ptr(), ls.data_ptr(), _build.ptr(g2),
        out.data_ptr(), m, k, float(eps), _build.stream_ptr(dev))
    _build.check(code, "ln_bwd_residual")
    return out


def colsum(t):
    """fp32 column sums of a (M, N) bf16 or fp32 tensor, fixed order."""
    m, n = t.shape
    dev = t.device
    if t.dtype == torch.float32:
        _f32("colsum", "input", t, dev)
    else:
        _build.check_cuda_inputs("colsum", dev, input=t)
    out = torch.empty((n,), device=dev, dtype=torch.float32)
    partial = torch.empty(((m + 127) // 128, n), device=dev,
                          dtype=torch.float32)
    code = _build.lib().cara_colsum(
        t.data_ptr(), int(t.dtype == torch.float32), out.data_ptr(),
        partial.data_ptr(), m, n, _build.stream_ptr(dev))
    _build.check(code, "colsum")
    return out
