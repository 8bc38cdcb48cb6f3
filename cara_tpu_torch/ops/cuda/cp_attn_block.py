"""Attention half-block with CaRA deltas:
``x + dpm * (attn(LN1(x) Wq + bq + (LN1(x) U1) V1) Wp + bp + (o U2) V2 + cb2)``.

Replaces the TPU megakernel ``cara_tpu/ops/pallas/cp_attn_block.py``
(``cp_attn_block``, ``_ab_fwd`` / ``_attn_block_fwd_kernel``), which runs
the whole half-block on one image's tiles resident in up to 100 MB of
VMEM.  A Hopper block has 227 KB of shared memory, so the port composes
three launches of two hand-written kernels:

1. ``csrc/cp_site.cu`` with the LayerNorm prologue: qkv = LN1(x) Wq + bq
   + (z1 V1), z1 = LN1(x) U1 rounded to bf16 — written to device memory;
2. ``csrc/qkv_attention.cu`` on that qkv — (B, N, E) written back;
3. ``csrc/cp_site.cu`` with the residual epilogue: proj, its delta, cb2
   and ``x + dpm * y``.

The qkv tensor (B*N*3E bf16, 58 MB at ViT-B batch 64) and the attention
output make a round trip through HBM that the TPU kernel avoided; the
sites are tensor-core bound at ViT-B, so this first version accepts the
traffic, and fusing it back is later work.  The TPU's save-qkv mode and
its 128-multiple token padding are not ported (the kernels mask their own
ragged edges; eval saves nothing).

A CUDA tensor launches the kernels (or raises); a CPU tensor takes
:func:`cp_attn_block_plain`.  Forward only.
"""

from __future__ import annotations

from cara_tpu_torch.ops.cuda import _build
from cara_tpu_torch.ops.cuda._site import site_cuda, site_plain
from cara_tpu_torch.ops.cuda.fused_qkv_attention import (
    _check_np, attention_cuda, fused_qkv_attention_plain)
from cara_tpu_torch.ops.layers import layer_norm

#: Number of (three-launch) kernel calls made by :func:`cp_attn_block`.
LAUNCHES = 0


def cp_attn_block_plain(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ln_scale,
                        ln_bias, dpm, heads: int, sm_scale: float,
                        n_real: int, s: float = 1.0, ln_eps: float = 1e-6):
    """Plain PyTorch twin of :func:`cp_attn_block` (same rounding points
    as ``_attn_block_fwd_kernel``: LN1(x), z1, qkv, the attention output
    and z2 are rounded to ``x.dtype``)."""
    bsz, n, e = x.shape
    dt = x.dtype
    xa = layer_norm(x, ln_scale, ln_bias, ln_eps)
    qkv = site_plain(xa, wq, bq, u1, v1, None, s).to(dt)
    o = fused_qkv_attention_plain(qkv, heads, sm_scale, n_real)
    y = site_plain(o, wp, bp, u2, v2, cb2, s)
    gate = dpm.float().reshape(bsz, 1, 1)
    return (x.float() + gate * y).to(dt)


def cp_attn_block(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ln_scale, ln_bias,
                  dpm, heads: int, sm_scale: float, n_real: int,
                  s: float = 1.0, ln_eps: float = 1e-6):
    """x (B, N, E) raw residual -> LN1 -> qkv + delta -> attention (keys
    >= ``n_real`` masked) -> proj + delta -> ``x + dpm * y``.

    ``u1`` (E, r) / ``v1`` (r, 3E) from ``models.cara.qkv_uv``; ``u2``
    (E, r) / ``v2`` (r, E) from ``rows_out_uv``; ``cb2`` = CP bias1;
    ``dpm`` (B, 1) per-image drop-path gate (ones in eval).  Callers fold
    the delta scale into ``v1``/``v2``/``cb2`` and pass ``s=1.0``."""
    global LAUNCHES
    _build.check_no_grad("cp_attn_block", x, wq, bq, u1, v1, wp, bp, u2, v2,
                         cb2, ln_scale, ln_bias, dpm)
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, E), got {tuple(x.shape)}")
    bsz, n, e = x.shape
    _check_np(n)
    if not 1 <= n_real <= n:
        raise ValueError(f"n_real={n_real} outside [1, {n}]")
    if dpm.numel() != bsz:
        raise ValueError(f"dpm must hold one gate per image, got "
                         f"{tuple(dpm.shape)}")
    if x.device.type == "cpu":
        return cp_attn_block_plain(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2,
                                   ln_scale, ln_bias, dpm, heads, sm_scale,
                                   n_real, s, ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x2 = x.reshape(bsz * n, e)
    qkv = site_cuda(x2, wq, bq, u1, v1, None, s,
                    ln=(ln_scale, ln_bias, ln_eps))
    o = attention_cuda(qkv.reshape(bsz, n, -1), heads, sm_scale, n_real)
    dpm_rows = dpm.reshape(bsz, 1).float().expand(bsz, n).reshape(-1)
    out = site_cuda(o.reshape(bsz * n, -1), wp, bp, u2, v2, cb2, s,
                    res=x2, dpm_rows=dpm_rows.contiguous())
    LAUNCHES += 1
    return out.reshape(bsz, n, e)
