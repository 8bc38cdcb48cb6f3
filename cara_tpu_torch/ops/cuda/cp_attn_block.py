"""Attention half-block with CaRA deltas:
``x + dpm * (attn(LN1(x) Wq + bq + (LN1(x) U1) V1) Wp + bp + (o U2) V2 + cb2)``.

Replaces the TPU megakernel ``cara_tpu/ops/pallas/cp_attn_block.py``
(``cp_attn_block``, ``_ab_fwd`` / ``_attn_block_fwd_kernel``), which runs
the whole half-block on one image's tiles resident in up to 100 MB of
VMEM.  A Hopper block has 227 KB of shared memory, so the port composes
four launches of three hand-written kernels:

1. ``csrc/block_rows.cu``'s LayerNorm row pass, xa = bf16(LN1(x)), then
   ``csrc/cp_site.cu``'s product: qkv = xa Wq + bq + (z1 V1), z1 = xa U1
   accumulated beside it and rounded to bf16 — written to device memory;
2. ``csrc/qkv_attention.cu`` on that qkv — (B, N, E) written back;
3. ``csrc/cp_site.cu`` with the residual epilogue: proj, its delta, cb2
   and ``x + dpm * y``.

The qkv tensor (B*N*3E bf16, 58 MB at ViT-B batch 64) and the attention
output make a round trip through HBM that the TPU kernel avoided; the
sites are tensor-core bound at ViT-B, so this first version accepts the
traffic, and fusing it back is later work.  The TPU's 128-multiple token
padding is not ported (the kernels mask their own ragged edges).

:func:`cp_attn_block` is differentiable: its backward replaces TPU row 6
(``_ab_bwd_rule`` / ``_attn_block_bwd_kernel``), the attention half
without weight dropout.  The qkv the forward wrote to device memory is
kept for it, as the TPU keeps it by default (its save-qkv mode,
``CARA_ATTN_SAVE_QKV`` auto); LN1, z1 and the attention output are
recomputed.  The launches are listed at :func:`_attn_block_bwd_cuda`.

:func:`cp_attn_block_wd` is the training form with exact element-wise
weight dropout (``cp_attn_block_wd``, ``_ab_fwd_wd`` / ``_ab_bwd_wd_rule``
and ``_attn_block_bwd_wd_kernel``): the forward folds both masked deltas
into the weights in one launch (``ops/cuda/wd_fold.py``
``build_wd_weights``) and runs the three launches
above with rank 0; the backward composes ``csrc/block_rows.cu``,
``csrc/grad_gemm.cu``, ``csrc/qkv_attention_bwd.cu`` and
``csrc/wd_factor_grads.cu``.  In the save-qkv mode (``CARA_ATTN_SAVE_QKV``,
as JAX's ``_save_qkv_on``: "1" or "0" force it, "auto" is on for CUDA
tensors, as JAX's is on for the TPU, and off on the CPU; read at import
into :data:`_SAVE_QKV`, decided at each call) a forward that autograd
records keeps the qkv its site wrote (``_attn_block_fwd_save_kernel``) and
the attention output, which is the same ``attention_cuda`` of the same
qkv as the backward's recompute, bit for bit; the backward reads them in
place of recomputing LN1 -> qkv and the attention
(``_attn_block_bwd_wd_kernel(saved_qkv=True)``; LN1 stays, dT1 reads
it): :func:`_attn_block_wd_bwd_saved_cuda`.  Off, it recomputes
both: :func:`_attn_block_wd_bwd_cuda`.  qkv is 58 MB a layer at ViT-B
batch 64, o 19.4 MB.

A CUDA tensor launches the kernels (or raises); a CPU tensor, or
``impl="plain"``, takes the plain versions.
"""

from __future__ import annotations

import os

import torch

from cara_tpu_torch.ops.cuda import _build, _bwd, wd_fold
from cara_tpu_torch.ops.cuda._site import site_cuda, site_plain
from cara_tpu_torch.ops.cuda.cp_dense import (
    _factor_grads_cuda, _factor_grads_plain, cp_dense_dx_cuda,
    cp_dense_dx_plain)
from cara_tpu_torch.ops.cuda.fused_qkv_attention import (
    _check_np, attention_bwd_cuda, attention_bwd_plain, attention_cuda,
    fused_qkv_attention_plain)
from cara_tpu_torch.ops.layers import layer_norm

#: Number of (three-launch) kernel calls made by :func:`cp_attn_block`.
LAUNCHES = 0
#: Backward calls of :func:`cp_attn_block` (TPU row 6).
BWD_LAUNCHES = 0
#: Forward kernel calls of :func:`cp_attn_block_wd` (TPU row 7).
WD_LAUNCHES = 0
#: Backward kernel calls of :func:`cp_attn_block_wd` (TPU row 8).
WD_BWD_LAUNCHES = 0
#: The same in the save-qkv mode.
WD_BWD_SAVED_LAUNCHES = 0

_SAVE_QKV = os.environ.get("CARA_ATTN_SAVE_QKV", "auto")


def _save_qkv_on(x) -> bool:
    """Whether a recorded forward on ``x`` keeps qkv (``_save_qkv_on``):
    "1" and "0" force, "auto" is on for CUDA tensors."""
    if _SAVE_QKV in ("0", "1"):
        return _SAVE_QKV == "1"
    return x.device.type == "cuda"


def _attn_block_plain(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ln_scale,
                      ln_bias, dpm, heads, sm_scale, n_real, s, ln_eps):
    """The plain forward -> (out, qkv (B, N, 3E), attention output)."""
    bsz, n, e = x.shape
    dt = x.dtype
    xa = layer_norm(x, ln_scale, ln_bias, ln_eps)
    qkv = site_plain(xa, wq, bq, u1, v1, None, s).to(dt)
    o = fused_qkv_attention_plain(qkv, heads, sm_scale, n_real)
    y = site_plain(o, wp, bp, u2, v2, cb2, s)
    gate = dpm.float().reshape(bsz, 1, 1)
    return (x.float() + gate * y).to(dt), qkv, o


def cp_attn_block_plain(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ln_scale,
                        ln_bias, dpm, heads: int, sm_scale: float,
                        n_real: int, s: float = 1.0, ln_eps: float = 1e-6):
    """Plain PyTorch twin of :func:`cp_attn_block` (same rounding points
    as ``_attn_block_fwd_kernel``: LN1(x), z1, qkv, the attention output
    and z2 are rounded to ``x.dtype``)."""
    return _attn_block_plain(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2,
                             ln_scale, ln_bias, dpm, heads, sm_scale,
                             n_real, s, ln_eps)[0]


def _check_block(x, dpm, n_real):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, E), got {tuple(x.shape)}")
    bsz, n, _ = x.shape
    _check_np(n)
    if not 1 <= n_real <= n:
        raise ValueError(f"n_real={n_real} outside [1, {n}]")
    if dpm.numel() != bsz:
        raise ValueError(f"dpm must hold one gate per image, got "
                         f"{tuple(dpm.shape)}")


def _dpm_rows(dpm, bsz, n):
    return dpm.reshape(bsz, 1).float().expand(bsz, n).reshape(-1).contiguous()


def _attn_block_cuda(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ln_scale,
                     ln_bias, dpm, heads, sm_scale, n_real, s, ln_eps):
    """The three launches of the forward on CUDA tensors -> (out, qkv
    (B, N, 3E), attention output (B, N, E))."""
    bsz, n, e = x.shape
    x2 = x.reshape(bsz * n, e)
    qkv = site_cuda(x2, wq, bq, u1, v1, None, s,
                    ln=(ln_scale, ln_bias, ln_eps)).reshape(bsz, n, -1)
    o = attention_cuda(qkv, heads, sm_scale, n_real)
    out = site_cuda(o.reshape(bsz * n, -1), wp, bp, u2, v2, cb2, s,
                    res=x2, dpm_rows=_dpm_rows(dpm, bsz, n))
    return out.reshape(bsz, n, e), qkv, o


def cp_attn_block_bwd_plain(g, x, qkv, wq, u1, v1, wp, u2, v2, ln_scale,
                            ln_bias, dpm, heads: int, sm_scale: float,
                            n_real: int, s: float = 1.0,
                            ln_eps: float = 1e-6):
    """Plain twin of the backward (``_attn_block_bwd_kernel`` with its
    rounding points: z1, z2, gv1, gv2, g2 = g * dpm, do and dqkv rounded
    to ``x.dtype``, dxa fp32): -> (dx, dbq, du1, dv1, dbp, du2, dv2), dx
    in ``x.dtype``, the rest fp32."""
    bsz, n, e = x.shape
    dt = x.dtype
    m = bsz * n
    x2 = x.reshape(m, e)
    g_res = g.reshape(m, e)
    xa = layer_norm(x2, ln_scale, ln_bias, ln_eps)
    o2 = fused_qkv_attention_plain(qkv, heads, sm_scale, n_real).reshape(m, e)
    g2 = (g_res.float() * _dpm_rows(dpm, bsz, n)[:, None]).to(dt)
    do, gv2 = cp_dense_dx_plain(g2, wp, u2, v2, s)
    du2, dv2, dbp = _factor_grads_plain(o2, g2, gv2, u2, s)
    dqkv = attention_bwd_plain(qkv, do.reshape(bsz, n, e), heads, sm_scale,
                               n_real).reshape(m, -1)
    gv1 = (dqkv.float() @ v1.float().t()).to(dt)
    dxa = dqkv.float() @ wq.float().t() + s * (gv1.float() @ u1.float().t())
    dx = (g_res.float() + _bwd.ln_input_bwd_plain(x2, dxa, ln_scale, ln_eps)
          ).to(dt)
    du1, dv1, dbq = _factor_grads_plain(xa, dqkv, gv1, u1, s)
    return dx.reshape(bsz, n, e), dbq, du1, dv1, dbp, du2, dv2


def _attn_block_bwd_cuda(g, x, qkv, wq, u1, v1, wp, u2, v2, ln_scale,
                         ln_bias, dpm, heads, sm_scale, n_real, s, ln_eps):
    """The backward on CUDA tensors, as launches (M = B*N rows):

    ``ln_rows`` xa = LN1(x); ``qkv_attention`` o from the kept qkv;
    ``gate_rows`` g2 = bf16(g * dpm); row 12's dx (NT do = bf16(g2 Wp^T
    + s gv2 U2^T) with gv2 = bf16(g2 V2^T) folded in); the factor
    products du2 = s o^T gv2, z2 = bf16(o U2), dv2 = s z2^T g2 and
    ``colsum`` dbp; ``qkv_attention_bwd`` dqkv; NT dxa = dqkv Wq^T + s gv1
    U1^T (fp32) with gv1 = bf16(dqkv V1^T) folded in;
    ``ln_bwd_residual`` dx = bf16(g + LN1'(dxa)); du1 = s xa^T gv1, z1 =
    bf16(xa U1), dv1 = s z1^T dqkv and ``colsum`` dbq."""
    bsz, n, e = x.shape
    m = bsz * n
    x2 = x.reshape(m, e)
    g_res = g.reshape(m, e)
    xa = _bwd.ln_rows(x2, ln_scale, ln_bias, ln_eps)
    o2 = attention_cuda(qkv, heads, sm_scale, n_real).reshape(m, e)
    g2 = _bwd.gate_rows(g_res, _dpm_rows(dpm, bsz, n))
    do, gv2 = cp_dense_dx_cuda(g2, wp, u2, v2, s)
    du2, dv2, dbp = _factor_grads_cuda(o2, g2, gv2, u2, s)
    dqkv = attention_bwd_cuda(qkv, do.reshape(bsz, n, e), heads, sm_scale,
                              n_real).reshape(m, -1)
    dxa, gv1 = _bwd.gemm(_bwd.NT, _bwd.EPI_F32, dqkv, wq,
                         b2=_bwd.pad_cols8(_bwd.scaled(u1, s)), fold_v=v1)
    dx = _bwd.ln_bwd_residual(x2, dxa, ln_scale, g_res, ln_eps)
    du1, dv1, dbq = _factor_grads_cuda(xa, dqkv, gv1, u1, s)
    return dx.reshape(bsz, n, e), dbq, du1, dv1, dbp, du2, dv2


class _AttnBlock(torch.autograd.Function):
    """Gradients for x, bq, u1, v1, bp, u2, v2 and cb2, as
    ``_ab_bwd_rule``; wq, wp, LN1 and the gate get none (JAX's zeros)."""

    @staticmethod
    def forward(ctx, x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ln_scale,
                ln_bias, dpm, heads, sm_scale, n_real, s, ln_eps, plain):
        global LAUNCHES
        args = (x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ln_scale, ln_bias,
                dpm, heads, sm_scale, n_real, s, ln_eps)
        if plain:
            out, qkv, _ = _attn_block_plain(*args)
        else:
            out, qkv, _ = _attn_block_cuda(*args)
            LAUNCHES += 1
        ctx.save_for_backward(x, qkv, wq, u1, v1, wp, u2, v2, ln_scale,
                              ln_bias, dpm)
        ctx.cfg = (heads, sm_scale, n_real, s, ln_eps, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        global BWD_LAUNCHES
        x, qkv, wq, u1, v1, wp, u2, v2, ls, lb, dpm = ctx.saved_tensors
        heads, sm_scale, n_real, s, ln_eps, plain = ctx.cfg
        args = (g.contiguous(), x, qkv, wq, u1, v1, wp, u2, v2, ls, lb, dpm,
                heads, sm_scale, n_real, s, ln_eps)
        if plain:
            dx, dbq, du1, dv1, dbp, du2, dv2 = cp_attn_block_bwd_plain(*args)
        else:
            dx, dbq, du1, dv1, dbp, du2, dv2 = _attn_block_bwd_cuda(*args)
            BWD_LAUNCHES += 1
        dt = g.dtype
        return (dx, None, dbq.to(dt), du1.to(u1.dtype), dv1.to(v1.dtype),
                None, dbp.to(dt), du2.to(u2.dtype), dv2.to(v2.dtype),
                (s * dbp).to(dt), None, None, None, None, None, None, None,
                None, None)


def cp_attn_block(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ln_scale, ln_bias,
                  dpm, heads: int, sm_scale: float, n_real: int,
                  s: float = 1.0, ln_eps: float = 1e-6, impl: str = "auto"):
    """x (B, N, E) raw residual -> LN1 -> qkv + delta -> attention (keys
    >= ``n_real`` masked) -> proj + delta -> ``x + dpm * y``.

    ``u1`` (E, r) / ``v1`` (r, 3E) from ``models.cara.qkv_uv``; ``u2``
    (E, r) / ``v2`` (r, E) from ``rows_out_uv``; ``cb2`` = CP bias1;
    ``dpm`` (B, 1) per-image drop-path gate (ones in eval).  Callers fold
    the delta scale into ``v1``/``v2``/``cb2`` and pass ``s=1.0``.
    Differentiable in x, bq, u1, v1, bp, u2, v2 and cb2;
    ``impl="plain"`` runs the plain versions on any device."""
    _check_block(x, dpm, n_real)
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    plain = impl == "plain" or x.device.type == "cpu"
    if not plain and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _AttnBlock.apply(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2,
                            ln_scale, ln_bias, dpm, heads, sm_scale, n_real,
                            s, ln_eps, plain)


def cp_attn_block_wd_plain(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ln_scale,
                           ln_bias, dpm, seed1, seed2, heads: int,
                           sm_scale: float, n_real: int, s: float,
                           rate: float, ln_eps: float = 1e-6):
    """Plain twin of the :func:`cp_attn_block_wd` forward: fold, then the
    plain block on the folded weights with rank 0."""
    e = x.shape[-1]
    wqp = wd_fold.build_wd_weight_plain(wq, u1, v1, seed1, s, rate)
    wpp = wd_fold.build_wd_weight_plain(wp, u2, v2, seed2, s, rate)
    return cp_attn_block_plain(
        x, wqp, bq, *wd_fold.zero_rank(x, e, wq.shape[1]), wpp, bp,
        *wd_fold.zero_rank(x, e, e), cb2, ln_scale, ln_bias, dpm, heads,
        sm_scale, n_real, s, ln_eps)


def cp_attn_block_wd_bwd_plain(g, x, wqp, bq, wpp, u1, v1, u2, v2, ln_scale,
                               ln_bias, dpm, seed1, seed2, heads: int,
                               sm_scale: float, n_real: int, s: float,
                               rate: float, ln_eps: float = 1e-6, qkv=None,
                               o=None):
    """Plain twin of the backward (``_attn_block_bwd_wd_kernel`` with its
    rounding points): -> (dx, du1, dv1, du2, dv2, dcb2), dx in
    ``x.dtype``, the rest fp32.  ``qkv`` and ``o``: the forward's (the
    save-qkv mode, ``saved_qkv=True``), read in place of their recompute,
    or both None."""
    bsz, n, e = x.shape
    dt = x.dtype
    m = bsz * n
    x2 = x.reshape(m, e)
    g_res = g.reshape(m, e)
    gate = _dpm_rows(dpm, bsz, n)[:, None]
    g2 = (g_res.float() * gate).to(dt)
    xa = layer_norm(x2, ln_scale, ln_bias, ln_eps)
    if qkv is None:
        qkv = (xa.float() @ wqp.float() + bq.float()).to(dt)
        o = fused_qkv_attention_plain(qkv.reshape(bsz, n, -1), heads,
                                      sm_scale, n_real)
    o2 = o.reshape(m, e)
    do = g2.float() @ wpp.float().t()
    dt2 = o2.float().t() @ g2.float()
    dsp = g2.float().sum(0)
    dqkv = attention_bwd_plain(qkv.reshape(bsz, n, -1),
                               do.to(dt).reshape(bsz, n, e), heads, sm_scale,
                               n_real).reshape(m, -1)
    dxa = dqkv.float() @ wqp.float().t()
    dx = (g_res.float() + _bwd.ln_input_bwd_plain(x2, dxa, ln_scale, ln_eps)
          ).to(dt)
    dt1 = xa.float().t() @ dqkv.float()
    du1, dv1 = wd_fold.masked_factor_grads_plain(dt1, u1, v1, seed1, s,
                                                 rate, dt)
    du2, dv2 = wd_fold.masked_factor_grads_plain(dt2, u2, v2, seed2, s,
                                                 rate, dt)
    return dx.reshape(bsz, n, e), du1, dv1, du2, dv2, s * dsp


def _attn_block_wd_bwd_cuda(g, x, wqp, bq, wpp, u1, v1, u2, v2, ln_scale,
                            ln_bias, dpm, seed1, seed2, heads, sm_scale,
                            n_real, s, rate, ln_eps):
    """The backward on CUDA tensors, as launches (M = B*N rows):

    ``ln_rows`` xa = LN1(x); NN ``grad_gemm`` qkv = bf16(xa wq' + bq);
    ``qkv_attention`` o; ``gate_rows`` g2 = bf16(g * dpm); NT do =
    bf16(g2 wp'^T); TN dT2 = o^T g2; ``colsum`` dsp; ``qkv_attention_bwd``
    dqkv; NT dxa = dqkv wq'^T (fp32); ``ln_bwd_residual`` dx; TN dT1 =
    xa^T dqkv; ``wd_factor_grads`` on dT1 and dT2."""
    bsz, n, e = x.shape
    m = bsz * n
    x2 = x.reshape(m, e)
    g_res = g.reshape(m, e)
    xa = _bwd.ln_rows(x2, ln_scale, ln_bias, ln_eps)
    qkv = _bwd.gemm(_bwd.NN, _bwd.EPI_BF16, xa, wqp, bias1=bq)
    o2 = attention_cuda(qkv.reshape(bsz, n, -1), heads, sm_scale,
                        n_real).reshape(m, e)
    g2 = _bwd.gate_rows(g_res, _dpm_rows(dpm, bsz, n))
    do = _bwd.gemm(_bwd.NT, _bwd.EPI_BF16, g2, wpp)
    dt2 = _bwd.gemm(_bwd.TN, _bwd.EPI_F32, o2, g2,
                    splits=_bwd.dt_splits(e, e, m))
    dsp = _bwd.colsum(g2)
    dqkv = attention_bwd_cuda(qkv.reshape(bsz, n, -1),
                              do.reshape(bsz, n, e), heads, sm_scale,
                              n_real).reshape(m, -1)
    dxa = _bwd.gemm(_bwd.NT, _bwd.EPI_F32, dqkv, wqp)
    dx = _bwd.ln_bwd_residual(x2, dxa, ln_scale, g_res, ln_eps)
    dt1 = _bwd.gemm(_bwd.TN, _bwd.EPI_F32, xa, dqkv,
                    splits=_bwd.dt_splits(e, dqkv.shape[1], m))
    du1, dv1 = wd_fold.masked_factor_grads_cuda(dt1, u1, v1, seed1, s, rate)
    du2, dv2 = wd_fold.masked_factor_grads_cuda(dt2, u2, v2, seed2, s, rate)
    return dx.reshape(bsz, n, e), du1, dv1, du2, dv2, s * dsp


def _attn_block_wd_bwd_saved_cuda(g, x, wqp, bq, wpp, u1, v1, u2, v2,
                                  ln_scale, ln_bias, dpm, seed1, seed2,
                                  heads, sm_scale, n_real, s, rate, ln_eps,
                                  qkv, o):
    """The save-qkv backward on CUDA tensors (``_attn_block_bwd_wd_kernel(
    saved_qkv=True)``), as launches (M = B*N rows):

    ``ln_rows`` xa = LN1(x) (dT1 reads it); the forward's ``qkv`` and
    attention output ``o`` in place of the NN recompute and
    ``qkv_attention``; ``gate_colsum`` g2 = bf16(g *
    dpm) and dsp in one pass; NT do = bf16(g2 wp'^T); TN dT2 = o^T g2;
    ``qkv_attention_bwd`` dqkv; NT dxa = dqkv wq'^T (fp32);
    ``ln_bwd_residual`` dx; TN dT1 = xa^T dqkv; ``wd_factor_grads`` on
    dT1 and dT2.  The five small gradients land in one fp32 buffer, cast
    to x's dtype in one step."""
    bsz, n, e = x.shape
    m = bsz * n
    x2 = x.reshape(m, e)
    g_res = g.reshape(m, e)
    e3, r1, r2 = wqp.shape[1], u1.shape[1], u2.shape[1]
    shapes = ((e, r1), (r1, e3), (e, r2), (r2, e), (e,))
    flat = _bwd.flat_buffer(x.device, shapes)
    du1, dv1, du2, dv2, dsp = _bwd.cut(flat, shapes)
    xa = _bwd.ln_rows(x2, ln_scale, ln_bias, ln_eps)
    o2 = o.reshape(m, e)
    g2 = _bwd.gate_colsum(g_res, *_bwd.gate_vector(
        dpm.reshape(bsz, 1, 1), (bsz, n), x.dtype), ds=dsp)
    do = _bwd.gemm(_bwd.NT, _bwd.EPI_BF16, g2, wpp)
    dt2 = _bwd.gemm(_bwd.TN, _bwd.EPI_F32, o2, g2,
                    splits=_bwd.dt_splits(e, e, m))
    dqkv = attention_bwd_cuda(qkv, do.reshape(bsz, n, e), heads, sm_scale,
                              n_real).reshape(m, -1)
    dxa = _bwd.gemm(_bwd.NT, _bwd.EPI_F32, dqkv, wqp)
    dx = _bwd.ln_bwd_residual(x2, dxa, ln_scale, g_res, ln_eps)
    del dxa
    dt1 = _bwd.gemm(_bwd.TN, _bwd.EPI_F32, xa, dqkv,
                    splits=_bwd.dt_splits(e, dqkv.shape[1], m))
    wd_fold.masked_factor_grads_cuda(dt1, u1, v1, seed1, s, rate,
                                     out=(du1, dv1))
    wd_fold.masked_factor_grads_cuda(dt2, u2, v2, seed2, s, rate,
                                     out=(du2, dv2))
    if s != 1.0:  # the masked finish scales dU, dV itself
        dsp.mul_(s)
    return (dx.reshape(bsz, n, e), *_bwd.cut(flat.to(x.dtype), shapes))


class _AttnBlockWd(torch.autograd.Function):
    """Gradients for x, u1, v1, u2, v2 and cb2; the backbone (wq, bq, wp,
    bp, LN1), the gate and the seeds are constants, as in
    ``_ab_bwd_wd_rule``."""

    @staticmethod
    def forward(ctx, x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ln_scale,
                ln_bias, dpm, seed1, seed2, heads, sm_scale, n_real, s,
                rate, ln_eps, plain, save):
        global WD_LAUNCHES
        fold = (wd_fold.build_wd_weights_plain if plain
                else wd_fold.build_wd_weights)
        wqp, wpp = fold([(wq, u1, v1, seed1), (wp, u2, v2, seed2)], s, rate)
        e = x.shape[-1]
        args = (x, wqp, bq, *wd_fold.zero_rank(x, e, wq.shape[1]), wpp,
                bp, *wd_fold.zero_rank(x, e, e), cb2, ln_scale, ln_bias, dpm,
                heads, sm_scale, n_real, s, ln_eps)
        if plain:
            out, qkv, o = _attn_block_plain(*args)
        else:
            out, qkv, o = _attn_block_cuda(*args)
            WD_LAUNCHES += 1
        if not save:
            qkv = o = None
        ctx.save_for_backward(x, wqp, bq, wpp, u1, v1, u2, v2, ln_scale,
                              ln_bias, dpm, seed1, seed2, qkv, o)
        ctx.cfg = (heads, sm_scale, n_real, s, rate, ln_eps, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        global WD_BWD_LAUNCHES, WD_BWD_SAVED_LAUNCHES
        (x, wqp, bq, wpp, u1, v1, u2, v2, ls, lb, dpm, seed1,
         seed2, qkv, o) = ctx.saved_tensors
        heads, sm_scale, n_real, s, rate, ln_eps, plain = ctx.cfg
        args = (g.contiguous(), x, wqp, bq, wpp, u1, v1, u2, v2, ls, lb,
                dpm, seed1, seed2, heads, sm_scale, n_real, s, rate, ln_eps)
        if plain:
            dx, du1, dv1, du2, dv2, dcb2 = cp_attn_block_wd_bwd_plain(
                *args, qkv=qkv, o=o)
        elif qkv is not None:
            dx, du1, dv1, du2, dv2, dcb2 = _attn_block_wd_bwd_saved_cuda(
                *args, qkv, o)
            WD_BWD_SAVED_LAUNCHES += 1
        else:
            dx, du1, dv1, du2, dv2, dcb2 = _attn_block_wd_bwd_cuda(*args)
            WD_BWD_LAUNCHES += 1
        return (dx, None, None, du1.to(u1.dtype), dv1.to(v1.dtype), None,
                None, du2.to(u2.dtype), dv2.to(v2.dtype), dcb2.to(x.dtype),
                None, None, None, None, None, None, None, None, None, None,
                None, None, None)


def cp_attn_block_wd(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ln_scale,
                     ln_bias, dpm, seed1, seed2, heads: int, sm_scale: float,
                     n_real: int, s: float, rate: float,
                     ln_eps: float = 1e-6, impl: str = "auto"):
    """:func:`cp_attn_block` with exact element-wise weight dropout on both
    dense deltas (``cara.py:35,57``), differentiable in x, u1, v1, u2, v2
    and cb2.  ``seed1`` / ``seed2``: one-element int32 tensors on x's
    device (the qkv and proj masks); ``rate`` the drop rate.

    ``impl="auto"`` launches the kernels for CUDA tensors and runs the
    plain versions for CPU tensors; ``impl="plain"`` runs the plain
    versions on any device (the reference the kernels are held to).  A
    recorded forward keeps qkv and o where :func:`_save_qkv_on` says."""
    _check_block(x, dpm, n_real)
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    plain = impl == "plain" or x.device.type == "cpu"
    if not plain and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    save = _save_qkv_on(x) and _build.recorded(x, u1, v1, u2, v2, cb2)
    return _AttnBlockWd.apply(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2,
                              ln_scale, ln_bias, dpm, seed1, seed2, heads,
                              sm_scale, n_real, s, rate, ln_eps, plain, save)
