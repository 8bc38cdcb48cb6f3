"""MLP half-block with CaRA deltas:
``x + dpm * (act(LN2(x) W1 + b1 + (LN2(x) U1) V1 + cb1) W2 + b2
+ (h U2) V2 + cb2)``, ``act`` the exact-erf GELU or CLIP's quick_gelu
``y sigmoid(1.702 y)`` (``act="quick_gelu"``, CLIP ViT-L/14).

Replaces the TPU megakernel ``cara_tpu/ops/pallas/cp_mlp.py``
(``cp_mlp_block``, ``_mlp_fwd_raw`` / ``_mlp_fwd_kernel``), which keeps
each 256-row tile's (rows, 4E) hidden activation in VMEM next to both
weight matrices.  On Hopper the port composes ``csrc/block_rows.cu``'s
LayerNorm row pass (xa = bf16(LN2(x))) and two launches of
``csrc/cp_site.cu``: fc1 on xa with its delta, cb1 and the activation
epilogue, writing ``h`` (rounded to bf16 as the TPU kernel does before
fc2); then fc2 with its delta, cb2 and the residual ``x + dpm * y``.
``h`` (M x 4E bf16, 77 MB at ViT-B batch 64) makes a round trip through
HBM that the TPU kernel avoided; both GEMMs are
tensor-core bound at ViT-B, so the first version accepts that, and fusing
fc1 into fc2 is later work.  The TPU epilogue's A&S erf is replaced by the
exact erf, as the JAX XLA path uses.  Every launch takes the activation
as a template form of its epilogue (``csrc/gelu.cuh``): the quick_gelu
forms of the fc1 site, its saved pre-activation, and the backwards'
``PRE_GELU`` / ``DGELU`` / ``DGELU_H`` products run the same tiles with
one ``expf`` an output in place of ``erff``, so the same bounds hold.

The save-pre mode (``CARA_MLP_SAVE_PRE``, as JAX's ``_save_pre_on``: "1"
or "0" force it, "auto" is on for CUDA tensors, as JAX's is on for the
TPU, and off on the CPU; read at import into :data:`_SAVE_PRE`, decided at
each call): a forward that autograd records (training; never serving or
eval) has its fc1 site also write the pre-activation rounded to x's dtype
(``_mlp_fwd_save_pre_kernel``), and the backwards of both blocks read it
in place of recomputing fc1 (``_mlp_bwd_kernel(saved_pre=True)``,
``_mlp_bwd_wd_pre_kernel``): :func:`_mlp_block_bwd_saved_cuda` and
:func:`_mlp_block_wd_bwd_saved_cuda`.  h is then bf16(act(pre)) from the
saved pre, as in JAX.  The pre-activation is 77.5 MB a layer at ViT-B
batch 64 and 224 px.

:func:`cp_mlp_block_wd` is the training form with exact element-wise
weight dropout (``cp_mlp_block_wd``: ``_mlp_fwd_wd`` and
``_mlp_bwd_wd_rule`` / ``_mlp_bwd_wd_kernel``).  Its forward folds both
masked deltas into the weights in one launch (``ops/cuda/wd_fold.py``
``build_wd_weights``) and runs the two
launches above with rank 0 (counted in :data:`LAUNCHES`: it is the same
kernel, TPU row 9).  Its backward reads the saved pre-activation (or,
with ``CARA_MLP_SAVE_PRE`` off, recomputes it in fp32) and composes
``csrc/block_rows.cu``, ``csrc/grad_gemm.cu`` and
``csrc/wd_factor_grads.cu``; see :func:`_mlp_block_wd_bwd_saved_cuda`
and :func:`_mlp_block_wd_bwd_cuda`.

:func:`cp_mlp_block` is differentiable: its backward replaces
``_mlp_bwd_rule`` / ``_mlp_bwd_raw`` / ``_mlp_bwd_kernel`` (TPU row 10,
the rank / row / no-dropout training route).  The TPU kernel recomputes
LN2 (and, without the save-pre mode, the pre-activation and h) per
256-row tile and accumulates the four rank-space factor gradients over
its sequential grid; here the same steps and the rank-space products are
launches of
``csrc/block_rows.cu``, the rank product of ``csrc/cp_site.cu`` and
``csrc/grad_gemm.cu`` (its rank k-step keeps every delta in rank space,
the two g V^T operands folded into the NT products that read g,
its TN split sums the factor gradients over the token rows in a fixed
order); see :func:`_mlp_block_bwd_cuda` (the recompute form, under
``CARA_MLP_SAVE_PRE=0``) and :func:`_mlp_block_bwd_saved_cuda`.  What
bounds it: two (saved) or three 59.5 GFLOP products at ViT-B, so the
tensor cores.

A CUDA tensor launches the kernels (or raises); a CPU tensor, or
``impl="plain"``, takes the plain versions.  The counters below count the
GELU forms; each has a ``QUICK_`` twin that counts the quick_gelu forms.
"""

from __future__ import annotations

import os

import torch

from cara_tpu_torch.ops.cuda import _build, _bwd, wd_fold
from cara_tpu_torch.ops.cuda._site import site_cuda, site_plain
from cara_tpu_torch.ops.layers import activation, activation_grad, layer_norm

#: Number of (two-launch) kernel calls made by :func:`cp_mlp_block` and
#: the :func:`cp_mlp_block_wd` forward.
LAUNCHES = 0
#: Backward kernel calls of :func:`cp_mlp_block` (TPU row 10).
BWD_LAUNCHES = 0
#: Backward kernel calls of :func:`cp_mlp_block_wd` (TPU row 11).
WD_BWD_LAUNCHES = 0
#: The same two backwards in the save-pre mode.
BWD_SAVED_LAUNCHES = 0
WD_BWD_SAVED_LAUNCHES = 0
#: The five counters above for the quick_gelu forms.
QUICK_LAUNCHES = 0
QUICK_BWD_LAUNCHES = 0
QUICK_WD_BWD_LAUNCHES = 0
QUICK_BWD_SAVED_LAUNCHES = 0
QUICK_WD_BWD_SAVED_LAUNCHES = 0

_SAVE_PRE = os.environ.get("CARA_MLP_SAVE_PRE", "auto")


def _count(name: str, act: str) -> None:
    """One more launch in the counter ``name`` of ``act``'s form."""
    globals()[("QUICK_" if act == "quick_gelu" else "") + name] += 1


def _save_pre_on(x) -> bool:
    """Whether a recorded forward on ``x`` keeps the pre-activation
    (``_save_pre_on``): "1" and "0" force, "auto" is on for CUDA
    tensors."""
    if _SAVE_PRE in ("0", "1"):
        return _SAVE_PRE == "1"
    return x.device.type == "cuda"


def _mlp_block_plain(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2, ln_scale,
                     ln_bias, dpm, s, act, ln_eps):
    """The plain forward -> (out, fp32 pre-activation)."""
    dt = x.dtype
    xa = layer_norm(x, ln_scale, ln_bias, ln_eps)
    pre = site_plain(xa, w1, b1, u1, v1, cb1, s)
    h = activation(pre, act).to(dt)
    y = site_plain(h, w2, b2, u2, v2, cb2, s)
    gate = torch.broadcast_to(dpm, x.shape[:-1] + (1,)).float()
    return (x.float() + gate * y).to(dt), pre


def cp_mlp_block_plain(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2,
                       ln_scale, ln_bias, dpm, s: float = 1.0,
                       act: str = "gelu", ln_eps: float = 1e-6):
    """Plain PyTorch twin of :func:`cp_mlp_block` (LN2(x), z1, h and z2
    rounded to ``x.dtype``, as in ``_mlp_fwd_kernel``)."""
    return _mlp_block_plain(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2,
                            ln_scale, ln_bias, dpm, s, act, ln_eps)[0]


def _dpm_rows(dpm, lead):
    return torch.broadcast_to(dpm, lead + (1,)).float().reshape(-1) \
        .contiguous()


def _mlp_block_cuda(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2, ln_scale,
                    ln_bias, dpm, s, act, ln_eps, save_pre=False):
    """The two launches of the forward on CUDA tensors -> (out, the
    pre-activation (M, 4E) bf16 written by the fc1 site with
    ``save_pre``, else None)."""
    lead, e = x.shape[:-1], x.shape[-1]
    if w2.shape[1] != e:
        raise ValueError(f"residual-fused MLP needs W2 out == E "
                         f"({w2.shape[1]} vs {e})")
    x2 = x.reshape(-1, e)
    fc1 = site_cuda(x2, w1, b1, u1, v1, cb1, s,
                    ln=(ln_scale, ln_bias, ln_eps), act=act,
                    return_pre=save_pre)
    h, pre = fc1 if save_pre else (fc1, None)
    out = site_cuda(h, w2, b2, u2, v2, cb2, s, res=x2,
                    dpm_rows=_dpm_rows(dpm, lead))
    return out.reshape(*lead, e), pre


def cp_mlp_block_bwd_plain(g, x, w1, b1, u1, v1, cb1, w2, u2, v2,
                           ln_scale, ln_bias, dpm, s: float = 1.0,
                           act: str = "gelu", ln_eps: float = 1e-6,
                           pre=None):
    """Plain twin of the backward (``_mlp_bwd_kernel`` with its rounding
    points: g2, xa, z1, h, gv1, gv2, dpre and z2 rounded to ``x.dtype``):
    -> (dx, du1, dv1, dcb1, du2, dv2, dcb2), dx in ``x.dtype``, the rest
    fp32.  ``pre``: the saved pre-activation (save-pre mode,
    ``saved_pre=True``: read in place of the fc1 recompute, h =
    act(pre) rounded), or None."""
    lead, e = x.shape[:-1], x.shape[-1]
    dt = x.dtype
    x2 = x.reshape(-1, e)
    g_res = g.reshape(-1, e)
    g2 = (g_res.float() * _dpm_rows(dpm, lead)[:, None]).to(dt)
    xa = layer_norm(x2, ln_scale, ln_bias, ln_eps)
    z1 = (xa.float() @ u1.float()).to(dt)
    if pre is None:
        pre = (xa.float() @ w1.float() + b1.float()
               + s * (z1.float() @ v1.float() + cb1.float()))
    else:
        pre = pre.reshape(x2.shape[0], -1).float()
    h = activation(pre, act).to(dt)
    gv2 = (g2.float() @ v2.float().t()).to(dt)
    dh = g2.float() @ w2.float().t() + s * (gv2.float() @ u2.float().t())
    dpre = dh * activation_grad(pre, act)
    dprec = dpre.to(dt)
    gv1 = (dprec.float() @ v1.float().t()).to(dt)
    dxa = dprec.float() @ w1.float().t() + s * (gv1.float() @ u1.float().t())
    dx = (g_res.float() + _bwd.ln_input_bwd_plain(x2, dxa, ln_scale, ln_eps)
          ).to(dt)
    z2 = (h.float() @ u2.float()).to(dt)
    du1 = s * (xa.float().t() @ gv1.float())
    dv1 = s * (z1.float().t() @ dprec.float())
    du2 = s * (h.float().t() @ gv2.float())
    dv2 = s * (z2.float().t() @ g2.float())
    return (dx.reshape(x.shape), du1, dv1, s * dpre.sum(0), du2, dv2,
            s * g2.float().sum(0))


def _mlp_block_bwd_cuda(g, x, w1, b1, u1, v1, cb1, w2, u2, v2, ln_scale,
                        ln_bias, dpm, s, act, ln_eps):
    """The backward on CUDA tensors, as launches (M rows; each rank-r
    operand is written ``_bwd.rank_width(r)`` wide, zero past r, for
    the GEMMs' rank step):

    ``ln_rows`` xa = LN2(x); rank product z1 = bf16(xa U1); NN
    ``grad_gemm`` + rank step pre = xa W1 + b1 + s (z1 V1 + cb1) (fp32)
    and h = bf16(act(pre)); ``gate_rows`` g2 = bf16(g dpm); NT + folded
    rank step dpre = (g2 W2^T + s gv2 U2^T) act'(pre), bf16, with its
    column sums and gv2 = bf16(g2 V2^T); ``colsum`` ds1, ds2; NT + folded
    rank step dxa = dpre W1^T + s gv1 U1^T (fp32) and gv1 = bf16(dpre
    V1^T); ``ln_bwd_residual`` dx; rank product z2 = bf16(h U2); the four
    split TN factor products du1 = xa^T gv1, dv1 = z1^T dpre,
    du2 = h^T gv2, dv2 = z2^T g2 (fp32, summed over all M rows)."""
    lead, e = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, e)
    g_res = g.reshape(-1, e)
    r1, r2 = u1.shape[1], u2.shape[1]
    xa = _bwd.ln_rows(x2, ln_scale, ln_bias, ln_eps)
    z1 = _bwd.rank_z(xa, u1)
    pre, h = _bwd.gemm(_bwd.NN, _bwd.EPI_PRE_GELU, xa, w1, bias1=b1,
                       bias2=_bwd.scaled(cb1, s), a2=z1,
                       b2=_bwd.scaled(v1, s), act=act)
    g2 = _bwd.gate_rows(g_res, _dpm_rows(dpm, lead))
    dprec, colpart, gv2 = _bwd.gemm(
        _bwd.NT, _bwd.EPI_DGELU, g2, w2, aux=pre,
        b2=_bwd.pad_cols8(_bwd.scaled(u2, s)), fold_v=v2, act=act)
    del pre
    ds1 = _bwd.colsum(colpart)
    ds2 = _bwd.colsum(g2)
    dxa, gv1 = _bwd.gemm(_bwd.NT, _bwd.EPI_F32, dprec, w1,
                         b2=_bwd.pad_cols8(_bwd.scaled(u1, s)), fold_v=v1)
    dx = _bwd.ln_bwd_residual(x2, dxa, ln_scale, g_res, ln_eps)
    del dxa
    z2 = _bwd.rank_z(h, u2)
    grads = (_bwd.factor_grad(xa, gv1)[:, :r1],
             _bwd.factor_grad(z1, dprec)[:r1],
             _bwd.factor_grad(h, gv2)[:, :r2],
             _bwd.factor_grad(z2, g2)[:r2])
    if s != 1.0:
        grads = tuple(s * t for t in grads)
    du1, dv1, du2, dv2 = grads
    return dx.reshape(x.shape), du1, dv1, s * ds1, du2, dv2, s * ds2


def _mlp_block_bwd_saved_cuda(g, x, w1, b1, u1, v1, cb1, w2, u2, v2,
                              ln_scale, ln_bias, dpm, s, act, ln_eps, pre):
    """The save-pre backward on CUDA tensors (``_mlp_bwd_kernel(
    saved_pre=True)``), as launches (M rows, hidden H; each rank-r operand
    ``rank_width(r)`` wide, zero past r, as in
    :func:`_mlp_block_bwd_cuda`):

    ``ln_rows`` xa = LN2(x); rank product z1 = bf16(xa U1);
    ``gate_colsum`` g2 = bf16(g dpm) and ds2 in one pass; NT DGELU_H +
    folded rank step dpre = (g2 W2^T + s gv2 U2^T) act'(pre), bf16, its
    column sums, gv2 = bf16(g2 V2^T) and h = bf16(act(pre)), all from the
    saved bf16 ``pre`` (no fc1 recompute); ``colsum`` ds1; NT + folded
    rank step dxa = dpre W1^T + s gv1 U1^T (fp32) and gv1;
    ``ln_bwd_residual`` dx; rank product z2 = bf16(h U2); the four split
    TN factor products.  The six small gradients land in one fp32 buffer,
    scaled and cast to x's dtype in one step."""
    lead, e = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, e)
    g_res = g.reshape(-1, e)
    m, hid = x2.shape[0], w1.shape[1]
    r1, r2 = u1.shape[1], u2.shape[1]
    w1w, w2w = _bwd.rank_width(r1), _bwd.rank_width(r2)
    shapes = ((e, w1w), (w1w, hid), (hid, w2w), (w2w, e), (hid,), (e,))
    flat = _bwd.flat_buffer(x.device, shapes)
    du1, dv1, du2, dv2, ds1, ds2 = _bwd.cut(flat, shapes)
    xa = _bwd.ln_rows(x2, ln_scale, ln_bias, ln_eps)
    z1 = _bwd.rank_z(xa, u1)
    g2 = _bwd.gate_colsum(g_res, *_bwd.gate_vector(dpm, lead, x.dtype),
                          ds=ds2)
    dprec, colpart, h, gv2 = _bwd.gemm(
        _bwd.NT, _bwd.EPI_DGELU_H, g2, w2, aux=pre.reshape(m, hid),
        b2=_bwd.pad_cols8(_bwd.scaled(u2, s)), fold_v=v2, act=act)
    _bwd.colsum(colpart, out=ds1)
    dxa, gv1 = _bwd.gemm(_bwd.NT, _bwd.EPI_F32, dprec, w1,
                         b2=_bwd.pad_cols8(_bwd.scaled(u1, s)), fold_v=v1)
    dx = _bwd.ln_bwd_residual(x2, dxa, ln_scale, g_res, ln_eps)
    del dxa
    z2 = _bwd.rank_z(h, u2)
    _bwd.factor_grad(xa, gv1, out=du1)
    _bwd.factor_grad(z1, dprec, out=dv1)
    _bwd.factor_grad(h, gv2, out=du2)
    _bwd.factor_grad(z2, g2, out=dv2)
    du1, dv1, du2, dv2, ds1, ds2 = _bwd.cut(
        _bwd.scaled(flat, s).to(x.dtype), shapes)
    return (dx.reshape(x.shape), du1[:, :r1], dv1[:r1], ds1, du2[:, :r2],
            dv2[:r2], ds2)


class _MlpBlock(torch.autograd.Function):
    """Gradients for x, u1, v1, cb1, u2, v2 and cb2; the backbone (w1, b1,
    w2, b2, LN2) and the gate are constants, as in ``_mlp_bwd_rule``."""

    @staticmethod
    def forward(ctx, x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2, ln_scale,
                ln_bias, dpm, s, act, ln_eps, plain, save):
        args = (x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2, ln_scale,
                ln_bias, dpm, s, act, ln_eps)
        if plain:
            out, pre = _mlp_block_plain(*args)
            pre = pre.to(x.dtype) if save else None
        else:
            out, pre = _mlp_block_cuda(*args, save_pre=save)
            _count("LAUNCHES", act)
        ctx.save_for_backward(x, w1, b1, u1, v1, cb1, w2, u2, v2, ln_scale,
                              ln_bias, dpm, pre)
        ctx.cfg = (s, act, ln_eps, plain)
        ctx.dtypes = tuple(t.dtype for t in (u1, v1, cb1, u2, v2, cb2))
        return out

    @staticmethod
    def backward(ctx, g):
        s, act, ln_eps, plain = ctx.cfg
        *saved, pre = ctx.saved_tensors
        args = (g.contiguous(), *saved, s, act, ln_eps)
        if plain:
            grads = cp_mlp_block_bwd_plain(*args, pre=pre)
        elif pre is not None:
            grads = _mlp_block_bwd_saved_cuda(*args, pre)
            _count("BWD_SAVED_LAUNCHES", act)
        else:
            grads = _mlp_block_bwd_cuda(*args)
            _count("BWD_LAUNCHES", act)
        du1, dv1, dcb1, du2, dv2, dcb2 = (
            t.to(dt) for t, dt in zip(grads[1:], ctx.dtypes))
        return (grads[0], None, None, du1, dv1, dcb1, None, None, du2, dv2,
                dcb2, None, None, None, None, None, None, None, None)


def cp_mlp_block(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2, ln_scale,
                 ln_bias, dpm, s: float = 1.0, act: str = "gelu",
                 ln_eps: float = 1e-6, impl: str = "auto"):
    """The CaRA MLP block including residual and drop-path gate,
    differentiable in x, u1, v1, cb1, u2, v2 and cb2.

    ``x`` (..., E); ``dpm`` broadcastable to ``x.shape[:-1] + (1,)`` (ones
    in eval, the per-image gates in training).  Callers fold the delta
    scale into ``v1``/``cb1``/``v2``/``cb2`` and pass ``s=1.0``.
    ``impl="plain"`` runs the plain versions on any device.  A recorded
    forward keeps the pre-activation where :func:`_save_pre_on` says."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    plain = impl == "plain" or x.device.type == "cpu"
    if not plain and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    save = _save_pre_on(x) and _build.recorded(x, u1, v1, cb1, u2, v2, cb2)
    return _MlpBlock.apply(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2,
                           ln_scale, ln_bias, dpm, s, act, ln_eps, plain,
                           save)


def cp_mlp_block_wd_plain(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2,
                          ln_scale, ln_bias, dpm, seed1, seed2, s: float,
                          rate: float, act: str = "gelu",
                          ln_eps: float = 1e-6):
    """Plain twin of the :func:`cp_mlp_block_wd` forward: fold, then the
    plain block on the folded weights with rank 0."""
    e, hid = w1.shape
    w1p = wd_fold.build_wd_weight_plain(w1, u1, v1, seed1, s, rate)
    w2p = wd_fold.build_wd_weight_plain(w2, u2, v2, seed2, s, rate)
    return cp_mlp_block_plain(
        x, w1p, b1, *wd_fold.zero_rank(x, e, hid), cb1, w2p, b2,
        *wd_fold.zero_rank(x, hid, w2.shape[1]), cb2, ln_scale, ln_bias,
        dpm, s, act, ln_eps)


def cp_mlp_block_wd_bwd_plain(g, x, w1p, b1, cb1, w2p, u1, v1, u2, v2,
                              ln_scale, ln_bias, dpm, seed1, seed2, s: float,
                              rate: float, act: str = "gelu",
                              ln_eps: float = 1e-6, pre=None):
    """Plain twin of the backward (``_mlp_bwd_wd_kernel`` with its
    rounding points; with the saved ``pre``, ``_mlp_bwd_wd_pre_kernel``'s):
    -> (dx, du1, dv1, dcb1, du2, dv2, dcb2), dx in ``x.dtype``, the rest
    fp32."""
    lead, e = x.shape[:-1], x.shape[-1]
    dt = x.dtype
    x2 = x.reshape(-1, e)
    g_res = g.reshape(-1, e)
    g2 = (g_res.float() * _dpm_rows(dpm, lead)[:, None]).to(dt)
    xa = layer_norm(x2, ln_scale, ln_bias, ln_eps)
    if pre is None:
        pre = xa.float() @ w1p.float() + b1.float() + s * cb1.float()
    else:
        pre = pre.reshape(x2.shape[0], -1).float()
    h = activation(pre, act).to(dt)
    dh = g2.float() @ w2p.float().t()
    dpre = dh * activation_grad(pre, act)
    dprec = dpre.to(dt)
    dxa = dprec.float() @ w1p.float().t()
    dx = (g_res.float() + _bwd.ln_input_bwd_plain(x2, dxa, ln_scale, ln_eps)
          ).to(dt)
    dt1 = xa.float().t() @ dprec.float()
    dt2 = h.float().t() @ g2.float()
    du1, dv1 = wd_fold.masked_factor_grads_plain(dt1, u1, v1, seed1, s,
                                                 rate, dt)
    du2, dv2 = wd_fold.masked_factor_grads_plain(dt2, u2, v2, seed2, s,
                                                 rate, dt)
    return (dx.reshape(x.shape), du1, dv1, s * dpre.sum(0), du2, dv2,
            s * g2.float().sum(0))


def _mlp_block_wd_bwd_cuda(g, x, w1p, b1, cb1, w2p, u1, v1, u2, v2,
                           ln_scale, ln_bias, dpm, seed1, seed2, s, rate,
                           act, ln_eps):
    """The backward on CUDA tensors, as launches (M rows, hidden H):

    ``ln_rows`` xa = LN2(x); NN ``grad_gemm`` pre = xa w1' + b1 + cb1
    (fp32) and h = bf16(act(pre)); ``gate_rows`` g2 = bf16(g * dpm); NT
    dpre = (g2 w2'^T) act'(pre), bf16, with its fp32 column sums per
    block; ``colsum`` ds1 and ds2; NT dxa = dpre w1'^T (fp32);
    ``ln_bwd_residual`` dx; TN dT1 = xa^T dpre and dT2 = h^T g2;
    ``wd_factor_grads`` on both."""
    if s != 1.0:
        raise ValueError("the pre-activation epilogue adds cb1 unscaled; "
                         "fold the delta scale into cb1 and pass s=1.0")
    lead, e = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, e)
    g_res = g.reshape(-1, e)
    m, hid = x2.shape[0], w1p.shape[1]
    xa = _bwd.ln_rows(x2, ln_scale, ln_bias, ln_eps)
    pre, h = _bwd.gemm(_bwd.NN, _bwd.EPI_PRE_GELU, xa, w1p, bias1=b1,
                       bias2=cb1, act=act)
    g2 = _bwd.gate_rows(g_res, _dpm_rows(dpm, lead))
    dprec, colpart = _bwd.gemm(_bwd.NT, _bwd.EPI_DGELU, g2, w2p, aux=pre,
                               act=act)
    del pre
    ds1 = _bwd.colsum(colpart)
    ds2 = _bwd.colsum(g2)
    dxa = _bwd.gemm(_bwd.NT, _bwd.EPI_F32, dprec, w1p)
    dx = _bwd.ln_bwd_residual(x2, dxa, ln_scale, g_res, ln_eps)
    dt1 = _bwd.gemm(_bwd.TN, _bwd.EPI_F32, xa, dprec,
                    splits=_bwd.dt_splits(e, hid, m))
    dt2 = _bwd.gemm(_bwd.TN, _bwd.EPI_F32, h, g2,
                    splits=_bwd.dt_splits(hid, e, m))
    du1, dv1 = wd_fold.masked_factor_grads_cuda(dt1, u1, v1, seed1, s, rate)
    du2, dv2 = wd_fold.masked_factor_grads_cuda(dt2, u2, v2, seed2, s, rate)
    return dx.reshape(x.shape), du1, dv1, s * ds1, du2, dv2, s * ds2


def _mlp_block_wd_bwd_saved_cuda(g, x, w1p, b1, cb1, w2p, u1, v1, u2, v2,
                                 ln_scale, ln_bias, dpm, seed1, seed2, s,
                                 rate, act, ln_eps, pre):
    """The save-pre backward on CUDA tensors (``_mlp_bwd_wd_pre_kernel``),
    as launches (M rows, hidden H):

    ``ln_rows`` xa = LN2(x); ``gate_colsum`` g2 = bf16(g * dpm) and ds2;
    NT DGELU_H dpre = (g2 w2'^T) act'(pre), bf16, its column sums and h
    = bf16(act(pre)), from the saved bf16 ``pre`` (no fc1 recompute);
    ``colsum`` ds1; NT dxa = dpre w1'^T (fp32); ``ln_bwd_residual`` dx; TN
    dT1 = xa^T dpre and dT2 = h^T g2; ``wd_factor_grads`` on both.  The
    six small gradients land in one fp32 buffer, cast to x's dtype in one
    step."""
    lead, e = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, e)
    g_res = g.reshape(-1, e)
    m, hid = x2.shape[0], w1p.shape[1]
    r1, r2 = u1.shape[1], u2.shape[1]
    shapes = ((e, r1), (r1, hid), (hid,), (hid, r2), (r2, e), (e,))
    flat = _bwd.flat_buffer(x.device, shapes)
    du1, dv1, ds1, du2, dv2, ds2 = _bwd.cut(flat, shapes)
    xa = _bwd.ln_rows(x2, ln_scale, ln_bias, ln_eps)
    g2 = _bwd.gate_colsum(g_res, *_bwd.gate_vector(dpm, lead, x.dtype),
                          ds=ds2)
    dprec, colpart, h = _bwd.gemm(_bwd.NT, _bwd.EPI_DGELU_H, g2, w2p,
                                  aux=pre.reshape(m, hid), act=act)
    _bwd.colsum(colpart, out=ds1)
    dxa = _bwd.gemm(_bwd.NT, _bwd.EPI_F32, dprec, w1p)
    dx = _bwd.ln_bwd_residual(x2, dxa, ln_scale, g_res, ln_eps)
    del dxa
    dt1 = _bwd.gemm(_bwd.TN, _bwd.EPI_F32, xa, dprec,
                    splits=_bwd.dt_splits(e, hid, m))
    dt2 = _bwd.gemm(_bwd.TN, _bwd.EPI_F32, h, g2,
                    splits=_bwd.dt_splits(hid, e, m))
    wd_fold.masked_factor_grads_cuda(dt1, u1, v1, seed1, s, rate,
                                     out=(du1, dv1))
    wd_fold.masked_factor_grads_cuda(dt2, u2, v2, seed2, s, rate,
                                     out=(du2, dv2))
    if s != 1.0:  # the masked finish scales dU, dV itself
        ds1.mul_(s)
        ds2.mul_(s)
    return (dx.reshape(x.shape), *_bwd.cut(flat.to(x.dtype), shapes))


class _MlpBlockWd(torch.autograd.Function):
    """Gradients for x, u1, v1, cb1, u2, v2 and cb2; the backbone (w1, b1,
    w2, b2, LN2), the gate and the seeds are constants, as in
    ``_mlp_bwd_wd_rule``."""

    @staticmethod
    def forward(ctx, x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2, ln_scale,
                ln_bias, dpm, seed1, seed2, s, rate, act, ln_eps, plain,
                save):
        fold = (wd_fold.build_wd_weights_plain if plain
                else wd_fold.build_wd_weights)
        w1p, w2p = fold([(w1, u1, v1, seed1), (w2, u2, v2, seed2)], s, rate)
        e, hid = w1.shape
        args = (x, w1p, b1, *wd_fold.zero_rank(x, e, hid), cb1, w2p, b2,
                *wd_fold.zero_rank(x, hid, w2.shape[1]), cb2, ln_scale,
                ln_bias, dpm, s, act, ln_eps)
        if plain:
            out, pre = _mlp_block_plain(*args)
            pre = pre.to(x.dtype) if save else None
        else:
            out, pre = _mlp_block_cuda(*args, save_pre=save)
            _count("LAUNCHES", act)
        ctx.save_for_backward(x, w1p, b1, cb1, w2p, u1, v1, u2, v2,
                              ln_scale, ln_bias, dpm, seed1, seed2, pre)
        ctx.cfg = (s, rate, act, ln_eps, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        (x, w1p, b1, cb1, w2p, u1, v1, u2, v2, ls, lb, dpm, seed1,
         seed2, pre) = ctx.saved_tensors
        s, rate, act, ln_eps, plain = ctx.cfg
        args = (g.contiguous(), x, w1p, b1, cb1, w2p, u1, v1, u2, v2, ls,
                lb, dpm, seed1, seed2, s, rate, act, ln_eps)
        if plain:
            grads = cp_mlp_block_wd_bwd_plain(*args, pre=pre)
        elif pre is not None:
            grads = _mlp_block_wd_bwd_saved_cuda(*args, pre)
            _count("WD_BWD_SAVED_LAUNCHES", act)
        else:
            grads = _mlp_block_wd_bwd_cuda(*args)
            _count("WD_BWD_LAUNCHES", act)
        dx, du1, dv1, dcb1, du2, dv2, dcb2 = grads
        return (dx, None, None, du1.to(u1.dtype), dv1.to(v1.dtype),
                dcb1.to(cb1.dtype), None, None, du2.to(u2.dtype),
                dv2.to(v2.dtype), dcb2.to(x.dtype), None, None, None, None,
                None, None, None, None, None, None, None)


def cp_mlp_block_wd(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2, ln_scale,
                    ln_bias, dpm, seed1, seed2, s: float, rate: float,
                    act: str = "gelu", ln_eps: float = 1e-6,
                    impl: str = "auto"):
    """:func:`cp_mlp_block` with exact element-wise weight dropout on both
    dense deltas (``cara.py:81,92``), differentiable in x, u1, v1, cb1,
    u2, v2 and cb2.  ``seed1`` / ``seed2``: one-element int32 tensors on
    x's device (the fc1 and fc2 masks).  ``impl`` as in
    ``cp_attn_block.cp_attn_block_wd``; the pre-activation kept as in
    :func:`cp_mlp_block`."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    plain = impl == "plain" or x.device.type == "cpu"
    if not plain and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    save = _save_pre_on(x) and _build.recorded(x, u1, v1, cb1, u2, v2, cb2)
    return _MlpBlockWd.apply(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2,
                             ln_scale, ln_bias, dpm, seed1, seed2, s, rate,
                             act, ln_eps, plain, save)
