"""The dense CaRA site shared by the block kernels, ``cp_dense`` and the
whole-block eval: its plain PyTorch math and its launcher for
``csrc/cp_site.cu``.

``out = epi(pro(x) @ W + b + s * ((pro(x) @ U) @ V + cb))`` with ``pro``
an optional LayerNorm and ``epi`` an optional activation ``act`` (the
exact-erf ``"gelu"`` or CLIP's ``"quick_gelu"``) and residual ``x_res +
dpm * y``, or ``g * act'(y)`` (the dact mode).  Rounding points follow
the TPU kernels: the
normalized row and ``z = pro(x) @ U`` are rounded to the input dtype,
everything else accumulates in fp32 and is rounded once at the end.

On the card a site is ``csrc/block_rows.cu``'s LayerNorm row pass (LN
sites only: it writes ``xa = bf16(LN(x))``) and one ``cp_site.cu``
product on the ``wgmma`` + TMA core, z folded into it.  The launches of
that product are counted by epilogue and activation: ``LAUNCHES_BF16``
(no activation or residual: qkv, the split route's projection),
``LAUNCHES_GELU`` (fc1), ``LAUNCHES_RES`` (the residual with or without
the GELU: the block kernels' projection and fc2) and ``LAUNCHES_DACT``
(the dact mode); of the GELU launches, ``LAUNCHES_GELU_PRE`` also wrote
the pre-activation (the MLP block's save-pre mode).  The quick_gelu
forms count apart: ``LAUNCHES_QUICK_GELU``, ``LAUNCHES_QUICK_GELU_PRE``
and ``LAUNCHES_QUICK_DACT``.  The residual epilogue takes the GELU or no
activation: no site of either package has an activation and a residual.
"""

from __future__ import annotations

from typing import Optional

import torch

from cara_tpu_torch.ops.cuda import _build, _bwd
from cara_tpu_torch.ops.layers import activation, activation_grad, layer_norm

LAUNCHES_BF16 = 0
LAUNCHES_GELU = 0
LAUNCHES_RES = 0
LAUNCHES_DACT = 0
LAUNCHES_GELU_PRE = 0
LAUNCHES_QUICK_GELU = 0
LAUNCHES_QUICK_GELU_PRE = 0
LAUNCHES_QUICK_DACT = 0
#: The activations of a site, and their codes in ``cara_cp_site``'s
#: ``act`` (the dact mode of each is its code plus one).
ACTS = {None: 0, "gelu": 1, "quick_gelu": 3}


def _count(name: str) -> None:
    globals()[name] += 1


def site_plain(xa, w, b, u, v, cb: Optional[torch.Tensor], s: float):
    """fp32 ``xa @ W + b + s * ((xa @ U) @ V + cb)`` with z rounded to
    ``xa.dtype``; ``xa`` is already ``pro(x)``.  Returns fp32."""
    z = (xa.float() @ u.float()).to(xa.dtype)
    d = z.float() @ v.float()
    if cb is not None:
        d = d + cb.float()
    return xa.float() @ w.float() + b.float() + s * d


def site_forward_plain(x2, w, b, u, v, cb, s, *, ln=None, act=None,
                       res=None, dpm_rows=None, dact_g=None):
    """Plain twin of :func:`site_cuda` (its output; z is
    ``site_plain``'s): LN(x) rounded to ``x2.dtype``, the activation,
    the residual ``res + dpm_rows * y`` or the dact ``g * act'(y)`` on
    the fp32 ``y``, the result rounded to ``x2.dtype``."""
    xa = x2 if ln is None else layer_norm(x2, *ln)
    y = site_plain(xa, w, b, u, v, cb, s)
    if dact_g is not None:
        return (dact_g.float() * activation_grad(y, act)).to(x2.dtype)
    if act is not None:
        y = activation(y, act)
    if res is not None:
        y = res.float() + dpm_rows.float()[:, None] * y
    return y.to(x2.dtype)


def site_cuda(x2, w, b, u, v, cb, s, *, ln=None, act=None, res=None,
              dpm_rows=None, dact_g=None, return_z=False, return_pre=False):
    """Launch the site on 2-D bf16 ``x2`` (M, K) -> (M, N), and with
    ``return_z`` its rank operand z = bf16(pro(x) U) (M,
    ``_bwd.rank_width(r)``), zero past the rank (the backward's factor
    gradients read it), then with
    ``return_pre`` (an activation without residual) the pre-activation
    rounded to bf16 (M, N), written beside the output by the same launch.

    ``ln`` = (scale, bias, eps) or None; ``act`` None, "gelu" or
    "quick_gelu"; ``res`` (M, N) and ``dpm_rows`` (M,) fp32 together
    select the residual epilogue (with the GELU or no activation);
    ``dact_g`` (M, N) selects the dact epilogue, ``bf16(g * act'(pre))``
    from the fp32 pre-activation, in place of the output."""
    m, k = x2.shape
    n = w.shape[1]
    r = u.shape[1]
    dev = x2.device
    ls, lb, eps = ln if ln is not None else (None, None, 0.0)
    _build.check_cuda_inputs("cp_site", dev, x=x2, w=w, b=b, u=u, v=v,
                             cb=cb, res=res, ln_scale=ls, ln_bias=lb,
                             g=dact_g)
    if k % 8 or n % 8:
        raise ValueError(f"cp_site needs K % 8 == 0 and N % 8 == 0, got "
                         f"K={k} N={n}")
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
    if act not in ACTS:
        raise ValueError(f"cp_site: act must be one of {tuple(ACTS)}, got "
                         f"{act!r}")
    if res is not None and act not in (None, "gelu"):
        raise ValueError(f"cp_site's residual epilogue takes the GELU or no "
                         f"activation, got act={act!r}")
    if dact_g is not None and (dact_g.shape != (m, n) or act is None
                               or res is not None):
        raise ValueError("cp_site dact needs g (M, N), an activation and "
                         "no residual epilogue")
    if return_pre and (act is None or res is not None):
        raise ValueError("cp_site writes the pre-activation on an "
                         "activation site without the residual only")
    xa = x2 if ln is None else _bwd.ln_rows(x2, ls, lb, eps)
    # U is read by TMA as (K, r8): rows of 16 bytes, zero columns past r;
    # past rank 64 the rank pre-pass reads it (K, R), R the width of z,
    # and the product reads that z (M, R) from memory.
    u8 = _bwd.pad_rank(u) if r else u
    out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
    pre = torch.empty_like(out) if return_pre else None
    z = None
    if return_z or r > _bwd.RANK_W:
        z = (torch.empty if r else torch.zeros)(
            (m, _bwd.rank_width(r)), device=dev, dtype=torch.bfloat16)
    code = _build.lib().cara_cp_site(
        xa.data_ptr(), w.data_ptr(), b.data_ptr(), _build.ptr(u8),
        _build.ptr(v), _build.ptr(cb), _build.ptr(res),
        _build.ptr(dpm_rows), _build.ptr(dact_g), _build.ptr(z),
        out.data_ptr(), _build.ptr(pre), m, k, n, r,
        ACTS[act] + (dact_g is not None), int(res is not None), float(s),
        _build.stream_ptr(dev))
    _build.check(code, "cp_site")
    quick = "QUICK_" if act == "quick_gelu" else ""
    if dact_g is not None:
        _count(f"LAUNCHES_{quick}DACT")
    elif res is not None:
        _count("LAUNCHES_RES")
    elif act is not None:
        _count(f"LAUNCHES_{quick}GELU")
        if return_pre:
            _count(f"LAUNCHES_{quick}GELU_PRE")
    else:
        _count("LAUNCHES_BF16")
    outs = (out,) + ((z,) if return_z else ()) + ((pre,) if return_pre
                                                   else ())
    return outs if len(outs) > 1 else out
