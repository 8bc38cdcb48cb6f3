"""One dense CaRA site of the split path, forward and backward:
``cp_dense(x) = act(x W + b + s ((x U) V + cb))`` and ``cp_dense_ln``,
the same on ``LN(x)``, with ``act`` None, ``"gelu"`` or ``"quick_gelu"``.

Replaces ``cara_tpu/ops/pallas/cp_dense.py`` (the qkv and projection
sites of the split training route with ``act=None``; the MLP's fc1 site,
GELU fused, and fc2 site once activation dropout turns the MLP
megakernel off):

* forward, TPU row 13 (``_cp_dense_raw`` / ``_cp_dense_kernel``): the
  site through ``_site.site_cuda``, ``csrc/block_rows.cu``'s LayerNorm
  row pass first for ``cp_dense_ln``, then ``csrc/cp_site.cu``'s product
  on the ``wgmma`` + TMA core with z = pro(x) U accumulated beside it and
  rounded to bf16 before V, the activation in the epilogue: the
  exact-erf GELU for ``act="gelu"``, CLIP's ``y sigmoid(1.702 y)`` for
  ``act="quick_gelu"`` (a template form of the same epilogue);
* the activation's backward, TPU row 13's helper
  (``_cp_dense_dact_kernel``): the same site kernel in its dact mode
  recomputes the fp32 pre-activation tile and writes ``dpre = bf16(g *
  act'(pre))``; the pre-activation never reaches memory.  The backward
  below then runs with ``g := dpre``;
* dx, TPU row 12 (``_cp_dense_dx_raw`` / ``_cp_dense_dx_kernel``):
  ``dx = g W^T + s bf16(g V^T) U^T``, also emitting ``gv = bf16(g V^T)``,
  with the LayerNorm input backward over the full row for
  ``cp_dense_ln``.  Launches: ``csrc/grad_gemm.cu``'s NT product with
  its folded rank step, as the TPU kernel does it: gv accumulated in fp32
  over the same k-tiles as g W^T, rounded to bf16 and written 64 wide,
  then one more 64-deep k-step (A = gv, B = U) on the same accumulators
  (past rank 64: gv (M, r rounded up to 64) from the rank product first,
  then read by the NT product as that many k-tiles of 64),
  gives dx (bf16) or, for the LN site, the fp32 d(LN(x)) that
  ``csrc/block_rows.cu``'s LayerNorm pass without residual turns into dx.
  The rank term stays in rank space: folding it into a dense ``W + s U
  V`` would round a 1e-3 delta at W's 3e-2 scale.  What bounds it: at
  ViT-B the NT product is 15-45 GFLOP against 50-80 MB, so the tensor
  cores (``grad_gemm.cu``'s ``wgmma`` + TMA core).

The factor and bias gradients (``du = s xa^T gv``, ``z = xa U``,
``dv = s z^T g``, ``db``) sit outside the Pallas kernels in JAX (XLA
dot_generals); here they are ``grad_gemm.cu``'s TN product split over
the token rows (``_bwd.factor_grad``) and column sums, z the one the
forward's site kernel computed (kept for the backward).  The backbone W,
b and the LayerNorm are frozen (no gradient), as in ``_bwd_rule`` /
``_bwd_ln_rule``; the LN input is recomputed in the backward.

:func:`cp_dense_wd` and :func:`cp_dense_ln_wd` are the same sites with
exact element-wise weight dropout on the delta (``cp_dense_wd`` /
``cp_dense_ln_wd``, ``_fwd_wd`` / ``_bwd_wd_rule`` and their LN twins):
the split element route the TPU takes when the attention megakernel is
off (N > 512).  Forward: the fold W' = W + s/(1-p) (U V) (.) keep (row
14, ``wd_fold.build_wd_weight``), then row 13 on W' with rank 0; W' is
kept for the backward, as the TPU rule keeps it.  Backward:
``dx = g W'^T`` (``grad_gemm.cu``'s NT product, no rank step; the fp32
d(LN(x)) then ``block_rows.cu``'s LayerNorm backward for the LN site),
the masked factor gradients on x or LN(x) (row 15,
``wd_fold.cp_wd_factor_grads``) and ``db`` by column sums, ``dcb = s
db``.

With an activation the element sites fuse it as the plain ones do: the
activation epilogue on W' with rank 0, and the dact helper on W' with
rank 0 (the rank delta already sits in W'), as ``_bwd_wd_rule`` does.

A CUDA tensor launches the kernels (or raises); a CPU tensor, or
``impl="plain"``, takes the plain versions, which keep the TPU kernels'
rounding points.  ``LAUNCHES`` counts row 13 without an activation,
``ACT_LAUNCHES`` row 13 with the GELU (any of the four forms),
``DACT_LAUNCHES`` its dact helper, ``QUICK_ACT_LAUNCHES`` and
``QUICK_DACT_LAUNCHES`` the same with quick_gelu, ``DX_LAUNCHES`` row 12,
``WD_LAUNCHES`` and ``WD_BWD_LAUNCHES`` the element-dropout sites'
forwards and backwards.
"""

from __future__ import annotations

from typing import Optional

import torch

from cara_tpu_torch.ops.cuda import _bwd, wd_fold
from cara_tpu_torch.ops.cuda._site import site_cuda, site_plain
from cara_tpu_torch.ops.layers import activation, activation_grad, layer_norm

ACTS = (None, "gelu", "quick_gelu")
#: Forward kernel calls of :func:`cp_dense` / :func:`cp_dense_ln` without
#: an activation (row 13).
LAUNCHES = 0
#: Forward kernel calls with the GELU epilogue, any of the four forms.
ACT_LAUNCHES = 0
#: Calls of the dact helper (the activation's backward) of the GELU.
DACT_LAUNCHES = 0
#: The same two with the quick_gelu epilogue.
QUICK_ACT_LAUNCHES = 0
QUICK_DACT_LAUNCHES = 0
#: dx kernel calls of their backward (row 12).
DX_LAUNCHES = 0
#: Forward calls of :func:`cp_dense_wd` / :func:`cp_dense_ln_wd` (the
#: fold, then row 13 on W').
WD_LAUNCHES = 0
#: Backward calls of them (dx on W', then row 15).
WD_BWD_LAUNCHES = 0


def cp_dense_plain(x2, w, b, u, v, cb: Optional[torch.Tensor], s: float,
                   ln=None, act: Optional[str] = None):
    """Plain twin of the forward on x2 (M, K): ``ln`` = (scale, bias, eps)
    or None; LN(x) and z rounded to ``x2.dtype``, the activation on the
    fp32 pre-activation, the output rounded to ``x2.dtype``."""
    xa = x2 if ln is None else layer_norm(x2, *ln)
    y = site_plain(xa, w, b, u, v, cb, s)
    return (y if act is None else activation(y, act)).to(x2.dtype)


def cp_dense_dact_plain(g2, x2, w, b, u, v, cb: Optional[torch.Tensor],
                        s: float, ln=None, act: str = "gelu"):
    """Plain twin of the dact helper (``_cp_dense_raw(..., g=)``): the
    fp32 pre-activation recomputed as the forward computes it, then
    ``g2 * act'(pre)`` rounded to ``g2.dtype``."""
    xa = x2 if ln is None else layer_norm(x2, *ln)
    pre = site_plain(xa, w, b, u, v, cb, s)
    return (g2.float() * activation_grad(pre, act)).to(g2.dtype)


def _check_act(act) -> None:
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def _count_act(act, gelu: str, quick: str) -> None:
    """One more launch in the counter of ``act``'s form."""
    name = quick if act == "quick_gelu" else gelu
    globals()[name] += 1


def _dact(g2, x2, w, b, u, v, cb, s, ln, act, plain: bool):
    """dpre through the plain twin or the site kernel's dact mode
    (counted in :data:`DACT_LAUNCHES` or :data:`QUICK_DACT_LAUNCHES`)."""
    if plain:
        return cp_dense_dact_plain(g2, x2, w, b, u, v, cb, s, ln, act)
    out = site_cuda(x2, w, b, u, v, cb, s, ln=ln, act=act, dact_g=g2)
    _count_act(act, "DACT_LAUNCHES", "QUICK_DACT_LAUNCHES")
    return out


def cp_dense_dact(g2, x2, w, b, u, v, cb: Optional[torch.Tensor], s: float,
                  ln=None, act: str = "gelu"):
    """The activation's backward of a site on 2-D g2 (M, N) and x2 (M, K):
    ``g2 * act'(pre)`` with ``pre = pro(x2) W + b + s ((pro(x2) U) V +
    cb)`` recomputed, ``ln`` = (scale, bias, eps) or None.  The kernel on
    CUDA, the plain twin on the CPU."""
    plain = x2.device.type == "cpu"
    if not plain and x2.device.type != "cuda":
        raise ValueError(f"no kernel for device {x2.device}")
    _check_act(act)
    if act is None:
        raise ValueError("cp_dense_dact needs an activation")
    _check_site("cp_dense_dact", x2, w.shape[0], w, u, v, not plain)
    return _dact(g2, x2, w, b, u, v, cb, s, ln, act, plain)


def cp_dense_dx_plain(g2, w, u, v, s: float, ln=None, x2=None):
    """Plain twin of row 12: (dx (M, K), gv (M, r)) in ``g2.dtype`` from
    g2 (M, N); ``ln`` = (scale, eps) with the raw input ``x2`` adds the
    LayerNorm input backward (``_cp_dense_dx_kernel``)."""
    dt = g2.dtype
    gv = (g2.float() @ v.float().t()).to(dt)
    dxl = g2.float() @ w.float().t() + s * (gv.float() @ u.float().t())
    if ln is None:
        return dxl.to(dt), gv
    return _bwd.ln_input_bwd_plain(x2, dxl, ln[0], ln[1]).to(dt), gv


def _check_site(name, t, width, w, u, v, kernel: bool):
    """``t`` (..., width) is x (width K) or g (width N); ``kernel``: the
    CUDA kernels will run on it."""
    k, n = w.shape
    r = u.shape[1]
    if t.shape[-1] != width or u.shape != (k, r) or v.shape != (r, n):
        raise ValueError(f"{name} shapes: {tuple(t.shape)} against w "
                         f"{tuple(w.shape)} u {tuple(u.shape)} v "
                         f"{tuple(v.shape)}")
    if kernel and (k % 64 or n % 64):
        raise ValueError(f"{name}: the kernels take K and N multiples of "
                         f"64, got K={k} N={n}")


def cp_dense_dx_cuda(g2, w, u, v, s: float, ln=None, x2=None):
    """Row 12's launches on CUDA tensors: (dx (M, K) bf16, gv (M,
    ``_bwd.rank_width(r)``) bf16, zero past the rank).  gv = bf16(g V^T)
    comes out of the dx product (its folded rank step), as the TPU kernel
    emits it."""
    u8 = _bwd.pad_cols8(_bwd.scaled(u, s))
    if ln is None:
        return _bwd.gemm(_bwd.NT, _bwd.EPI_BF16, g2, w, b2=u8, fold_v=v)
    dxl, gv = _bwd.gemm(_bwd.NT, _bwd.EPI_F32, g2, w, b2=u8, fold_v=v)
    return _bwd.ln_bwd_residual(x2, dxl, ln[0], None, ln[1]), gv


def _dx(g2, w, u, v, s, ln, x2, plain: bool):
    """Row 12 through the plain twin (gv (M, r)) or the kernels (gv
    (M, ``rank_width(r)``), zero past the rank; counted in
    :data:`DX_LAUNCHES`)."""
    global DX_LAUNCHES
    if plain:
        return cp_dense_dx_plain(g2, w, u, v, s, ln, x2)
    out = cp_dense_dx_cuda(g2, w, u, v, s, ln, x2)
    DX_LAUNCHES += 1
    return out


def cp_dense_dx(g2, w, u, v, s: float, ln=None, x2=None):
    """dx = g W^T + s bf16(g V^T) U^T (+ the LayerNorm input backward with
    ``ln`` = (scale, eps) and the raw input ``x2``) -> (dx (M, K),
    gv (M, r)): the kernels on CUDA, the plain twin on the CPU."""
    plain = g2.device.type == "cpu"
    if not plain and g2.device.type != "cuda":
        raise ValueError(f"no kernel for device {g2.device}")
    _check_site("cp_dense_dx", g2, w.shape[1], w, u, v, not plain)
    dx, gv = _dx(g2, w, u, v, s, ln, x2, plain)
    return dx, gv[:, :u.shape[1]]


def _factor_grads_plain(xa, g2, gv, u, s):
    du = s * (xa.float().t() @ gv.float())
    z = (xa.float() @ u.float()).to(xa.dtype)
    dv = s * (z.float().t() @ g2.float())
    return du, dv, g2.float().sum(0)


def _factor_grads_cuda(xa, g2, gv, u, s, z=None):
    """du, dv, db from xa, g2, gv and z = bf16(xa U) (M,
    ``rank_width(r)``), which the rank product computes when the forward
    did not keep it."""
    r = u.shape[1]
    du = _bwd.factor_grad(xa, gv)[:, :r]
    dv = _bwd.factor_grad(_bwd.rank_z(xa, u) if z is None else z, g2)[:r]
    if s != 1.0:
        du, dv = s * du, s * dv
    return du, dv, _bwd.colsum(g2)


class _CpDense(torch.autograd.Function):
    """Gradients for x, u, v and cb; W, b and the LayerNorm are frozen."""

    @staticmethod
    def forward(ctx, x, w, b, u, v, cb, ln_scale, ln_bias, s, ln_eps, act,
                plain):
        global LAUNCHES
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        ln = None if ln_scale is None else (ln_scale, ln_bias, ln_eps)
        z = None
        if plain:
            out = cp_dense_plain(x2, w, b, u, v, cb, s, ln, act)
        else:
            x2 = x2.contiguous()
            out, z = site_cuda(x2, w, b, u, v, cb, s, ln=ln, act=act,
                               return_z=True)
            if act is None:
                LAUNCHES += 1
            else:
                _count_act(act, "ACT_LAUNCHES", "QUICK_ACT_LAUNCHES")
        ctx.save_for_backward(x2, w, b, u, v, cb, ln_scale, ln_bias, z)
        ctx.cfg = (lead, s, ln_eps, act, plain)
        return out.reshape(*lead, w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x2, w, b, u, v, cb, ls, lb, z = ctx.saved_tensors
        lead, s, eps, act, plain = ctx.cfg
        g2 = g.reshape(-1, w.shape[1]).contiguous()
        if act is not None:  # g := dpre, the pre-activation recomputed
            g2 = _dact(g2, x2, w, b, u, v, cb, s,
                       None if ls is None else (ls, lb, eps), act, plain)
        dx, gv = _dx(g2, w, u, v, s, None if ls is None else (ls, eps), x2,
                     plain)
        if plain:
            xa = x2 if ls is None else layer_norm(x2, ls, lb, eps)
            du, dv, db = _factor_grads_plain(xa, g2, gv, u, s)
        else:
            xa = x2 if ls is None else _bwd.ln_rows(x2, ls, lb, eps)
            du, dv, db = _factor_grads_cuda(xa, g2, gv, u, s, z)
        dcb = (s * db).to(g.dtype) if cb is not None else None
        return (dx.reshape(*lead, w.shape[0]), None, None, du.to(u.dtype),
                dv.to(v.dtype), dcb, None, None, None, None, None, None)


def _plain(name, x, w, u, v, impl, act=None) -> bool:
    """Check a site's call; True when it takes the plain versions."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    plain = impl == "plain" or x.device.type == "cpu"
    if not plain and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_act(act)
    _check_site(name, x, w.shape[0], w, u, v, not plain)
    return plain


def _apply(x, w, b, u, v, cb, ls, lb, s, ln_eps, impl, act):
    plain = _plain("cp_dense", x, w, u, v, impl, act)
    return _CpDense.apply(x, w, b, u, v, cb, ls, lb, s, ln_eps, act, plain)


def cp_dense(x, w, b, u, v, cb: Optional[torch.Tensor], s: float = 1.0,
             impl: str = "auto", act: Optional[str] = None):
    """``act(x W + b + s ((x U) V + cb))`` for x (..., K), W (K, N), U
    (K, r), V (r, N); ``cb`` (N,) or None; ``act`` None, "gelu" or
    "quick_gelu".  Differentiable in x, u, v and cb.  ``impl="plain"``
    runs the plain versions on any device."""
    return _apply(x, w, b, u, v, cb, None, None, s, 0.0, impl, act)


def cp_dense_ln(x, w, b, u, v, cb: Optional[torch.Tensor], ln_scale,
                ln_bias, s: float = 1.0, ln_eps: float = 1e-6,
                impl: str = "auto", act: Optional[str] = None):
    """:func:`cp_dense` on ``LN(x)`` (frozen scale and bias), the
    normalized row rounded to ``x.dtype`` as ``_ln_rows`` does."""
    return _apply(x, w, b, u, v, cb, ln_scale, ln_bias, s, ln_eps, impl,
                  act)


def cp_dense_wd_bwd_plain(g2, x2, wp, u, v, seed, s: float, rate: float,
                          ln=None):
    """Plain twin of the element-dropout site's backward: (dx (M, K) in
    ``g2.dtype``, dU, dV, db fp32) from g2 (M, N), the raw input x2 and
    the folded W'; ``ln`` = (scale, bias, eps) or None."""
    dxl = g2.float() @ wp.float().t()
    if ln is None:
        dx, xa = dxl, x2
    else:
        dx = _bwd.ln_input_bwd_plain(x2, dxl, ln[0], ln[2])
        xa = layer_norm(x2, *ln)
    du, dv = wd_fold.cp_wd_factor_grads_plain(xa, g2, u, v, seed, s, rate)
    return dx.to(g2.dtype), du, dv, g2.float().sum(0)


def _wd_bwd_cuda(g2, x2, wp, u, v, seed, s, rate, ln):
    if ln is None:
        dx, xa = _bwd.gemm(_bwd.NT, _bwd.EPI_BF16, g2, wp), x2
    else:
        dxl = _bwd.gemm(_bwd.NT, _bwd.EPI_F32, g2, wp)
        dx = _bwd.ln_bwd_residual(x2, dxl, ln[0], None, ln[2])
        xa = _bwd.ln_rows(x2, *ln)
    du, dv = wd_fold.cp_wd_factor_grads(xa, g2, u, v, seed, s, rate)
    return dx, du, dv, _bwd.colsum(g2)


class _CpDenseWd(torch.autograd.Function):
    """Gradients for x, u, v and cb; W, b, the LayerNorm and the seed are
    constants, as in ``_bwd_wd_rule`` / ``_bwd_ln_wd_rule``."""

    @staticmethod
    def forward(ctx, x, w, b, u, v, cb, seed, ln_scale, ln_bias, s, rate,
                ln_eps, act, plain):
        global WD_LAUNCHES
        lead, k = x.shape[:-1], x.shape[-1]
        n = w.shape[1]
        x2 = x.reshape(-1, k)
        ln = None if ln_scale is None else (ln_scale, ln_bias, ln_eps)
        u0, v0 = wd_fold.zero_rank(x2, k, n)
        if plain:
            wp = wd_fold.build_wd_weight_plain(w, u, v, seed, s, rate)
            out = cp_dense_plain(x2, wp, b, u0, v0, cb, s, ln, act)
        else:
            x2 = x2.contiguous()
            wp = wd_fold.build_wd_weight(w, u, v, seed, s, rate)
            out = site_cuda(x2, wp, b, u0, v0, cb, s, ln=ln, act=act)
            WD_LAUNCHES += 1
            if act is not None:
                _count_act(act, "ACT_LAUNCHES", "QUICK_ACT_LAUNCHES")
        ctx.save_for_backward(x2, wp, b, u, v, cb, seed, ln_scale, ln_bias)
        ctx.cfg = (lead, s, rate, ln_eps, act, plain)
        return out.reshape(*lead, n)

    @staticmethod
    def backward(ctx, g):
        global WD_BWD_LAUNCHES
        x2, wp, b, u, v, cb, seed, ls, lb = ctx.saved_tensors
        lead, s, rate, eps, act, plain = ctx.cfg
        k, n = wp.shape
        g2 = g.reshape(-1, n).contiguous()
        ln = None if ls is None else (ls, lb, eps)
        if act is not None:  # on W' at rank 0: the delta is already in W'
            u0, v0 = wd_fold.zero_rank(x2, k, n)
            g2 = _dact(g2, x2, wp, b, u0, v0, cb, s, ln, act, plain)
        if plain:
            dx, du, dv, db = cp_dense_wd_bwd_plain(g2, x2, wp, u, v, seed,
                                                   s, rate, ln)
        else:
            dx, du, dv, db = _wd_bwd_cuda(g2, x2, wp, u, v, seed, s, rate,
                                          ln)
            WD_BWD_LAUNCHES += 1
        dcb = (s * db).to(g.dtype) if cb is not None else None
        return (dx.reshape(*lead, k), None, None, du.to(u.dtype),
                dv.to(v.dtype), dcb, None, None, None, None, None, None,
                None, None)


def _apply_wd(x, w, b, u, v, cb, seed, ls, lb, s, rate, ln_eps, impl, act):
    plain = _plain("cp_dense_wd", x, w, u, v, impl, act)
    return _CpDenseWd.apply(x, w, b, u, v, cb, seed, ls, lb, s, rate, ln_eps,
                            act, plain)


def cp_dense_wd(x, w, b, u, v, cb: Optional[torch.Tensor], seed,
                s: float, rate: float, impl: str = "auto",
                act: Optional[str] = None):
    """``act(x W + b + s ((x (U V (.) keep)) / (1 - rate) + cb))``:
    :func:`cp_dense` with exact element-wise weight dropout on the delta,
    the keep mask hashed from ``seed`` (one-element int32 tensor on x's
    device).  Differentiable in x, u, v and cb."""
    return _apply_wd(x, w, b, u, v, cb, seed, None, None, s, rate, 0.0,
                     impl, act)


def cp_dense_ln_wd(x, w, b, u, v, cb: Optional[torch.Tensor], ln_scale,
                   ln_bias, seed, s: float, rate: float,
                   ln_eps: float = 1e-6, impl: str = "auto",
                   act: Optional[str] = None):
    """:func:`cp_dense_wd` on ``LN(x)`` (frozen scale and bias)."""
    return _apply_wd(x, w, b, u, v, cb, seed, ln_scale, ln_bias, s, rate,
                     ln_eps, impl, act)
