"""The dense CaRA site shared by the two block kernels: its plain PyTorch
math and its launcher for ``csrc/cp_site.cu``.

``out = epi(pro(x) @ W + b + s * ((pro(x) @ U) @ V + cb))`` with ``pro``
an optional LayerNorm and ``epi`` an optional GELU and residual
``x_res + dpm * y``.  Rounding points follow the TPU kernels: the
normalized row and ``z = pro(x) @ U`` are rounded to the input dtype,
everything else accumulates in fp32 and is rounded once at the end.
"""

from __future__ import annotations

from typing import Optional

import torch

from cara_tpu_torch.ops.cuda import _build


def site_plain(xa, w, b, u, v, cb: Optional[torch.Tensor], s: float):
    """fp32 ``xa @ W + b + s * ((xa @ U) @ V + cb)`` with z rounded to
    ``xa.dtype``; ``xa`` is already ``pro(x)``.  Returns fp32."""
    z = (xa.float() @ u.float()).to(xa.dtype)
    d = z.float() @ v.float()
    if cb is not None:
        d = d + cb.float()
    return xa.float() @ w.float() + b.float() + s * d


def site_cuda(x2, w, b, u, v, cb, s, *, ln=None, gelu=False, res=None,
              dpm_rows=None):
    """Launch the site kernel on 2-D bf16 ``x2`` (M, K) -> (M, N).

    ``ln`` = (scale, bias, eps) or None; ``res`` (M, N) and ``dpm_rows``
    (M,) fp32 together select the residual epilogue."""
    m, k = x2.shape
    n = w.shape[1]
    r = u.shape[1]
    dev = x2.device
    ls, lb, eps = ln if ln is not None else (None, None, 0.0)
    _build.check_cuda_inputs("cp_site", dev, x=x2, w=w, b=b, u=u, v=v,
                             cb=cb, res=res, ln_scale=ls, ln_bias=lb)
    if k % 64 or n % 8:
        raise ValueError(f"cp_site needs K % 64 == 0 and N % 8 == 0, got "
                         f"K={k} N={n}")
    if r > 64:
        raise ValueError(f"cp_site supports rank <= 64, got {r}")
    if w.shape != (k, n) or b.shape != (n,) or u.shape != (k, r) \
            or v.shape != (r, n) or (cb is not None and cb.shape != (n,)):
        raise ValueError(
            f"cp_site shapes: x {tuple(x2.shape)} w {tuple(w.shape)} b "
            f"{tuple(b.shape)} u {tuple(u.shape)} v {tuple(v.shape)}")
    if res is not None:
        if res.shape != (m, n) or dpm_rows is None \
                or dpm_rows.shape != (m,) or dpm_rows.dtype != torch.float32 \
                or not dpm_rows.is_contiguous() or dpm_rows.device != dev:
            raise ValueError("cp_site residual needs res (M, N) and fp32 "
                             "contiguous dpm (M,) on the same device")
    out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
    stats = torch.empty((2, m), device=dev, dtype=torch.float32)
    # z = pro(x) @ U, written zero-padded to the GEMM's 64-deep k step.
    z = torch.empty((m, 64), device=dev, dtype=torch.bfloat16)
    code = _build.lib().cara_cp_site(
        _build.ptr(x2), _build.ptr(ls), _build.ptr(lb), _build.ptr(w),
        _build.ptr(b), _build.ptr(u), _build.ptr(v), _build.ptr(cb),
        _build.ptr(res), _build.ptr(dpm_rows), stats[0].data_ptr(),
        stats[1].data_ptr(), z.data_ptr(), out.data_ptr(),
        m, k, n, r, int(ln is not None), int(gelu), int(res is not None),
        float(s), float(eps), _build.stream_ptr(dev))
    _build.check(code, "cp_site")
    return out
