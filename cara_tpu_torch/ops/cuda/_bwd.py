"""Launchers of the kernels the block backward wrappers compose
(``csrc/grad_gemm.cu``, ``csrc/block_rows.cu``), and the plain LayerNorm
input backward they mirror.

These are the products and row passes inside the TPU kernels
``_attn_block_bwd_wd_kernel`` and ``_mlp_bwd_wd_kernel``; they carry no
launch counters of their own (the block wrappers count).  Every launcher
takes bf16 CUDA tensors (fp32 where it says so), checks them and raises
on what the kernel does not take.
"""

from __future__ import annotations

import torch

from cara_tpu_torch.ops.cuda import _build

NN, NT, TN = 0, 1, 2
EPI_F32, EPI_BF16, EPI_PRE_GELU, EPI_DGELU = 0, 1, 2, 3
_GEMM_BM = 128
# Blocks that fill the card: 132 SMs, two GEMM blocks each.
_SLOTS = 264


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
         splits: int = 1):
    """One ``grad_gemm.cu`` product; returns the epilogue's outputs.

    NN: a (M, K), b (K, N).  NT: a (M, K), b (N, K).  TN: a (K, M),
    b (K, N) -> (splits, M, N) fp32 partial planes.  F32 -> c32;
    BF16 -> c16; PRE_GELU -> (pre fp32, gelu bf16); DGELU (``aux`` the fp32
    pre-activation) -> (dpre bf16, column partial sums (M/128, N) fp32)."""
    dev = a.device
    _build.check_cuda_inputs("grad_gemm", dev, a=a, b=b, bias1=bias1,
                             bias2=bias2)
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
        _build.ptr(aux), _build.ptr(colpart), m, n, k, splits,
        _build.stream_ptr(dev))
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
    so that about two blocks per SM run: more splits for small planes."""
    tiles = -(-m // _GEMM_BM) * -(-n // _GEMM_BM)
    return max(1, min(8, _SLOTS // tiles, k // 64))


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
    (M, K) fp32)."""
    m, k = x2.shape
    dev = x2.device
    _build.check_cuda_inputs("ln_bwd_residual", dev, x=x2, ln_scale=ls,
                             g=g2)
    _f32("ln_bwd_residual", "dxa", dxa, dev)
    if dxa.shape != (m, k) or g2.shape != (m, k):
        raise ValueError("ln_bwd_residual: x, dxa and g must agree")
    out = torch.empty_like(x2)
    code = _build.lib().cara_ln_bwd_residual(
        x2.data_ptr(), dxa.data_ptr(), ls.data_ptr(), g2.data_ptr(),
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
