"""MLP half-block with CaRA deltas:
``x + dpm * (gelu(LN2(x) W1 + b1 + (LN2(x) U1) V1 + cb1) W2 + b2
+ (h U2) V2 + cb2)``.

Replaces the TPU megakernel ``cara_tpu/ops/pallas/cp_mlp.py``
(``cp_mlp_block``, ``_mlp_fwd_raw`` / ``_mlp_fwd_kernel``), which keeps
each 256-row tile's (rows, 4E) hidden activation in VMEM next to both
weight matrices.  On Hopper the port composes two launches of
``csrc/cp_site.cu``: fc1 with the LayerNorm prologue, its delta, cb1 and
the exact-erf GELU epilogue, writing ``h`` (rounded to bf16 as the TPU
kernel does before fc2); then fc2 with its delta, cb2 and the residual
``x + dpm * y``.  ``h`` (M x 4E bf16, 77 MB at ViT-B batch 64) makes a
round trip through HBM that the TPU kernel avoided; both GEMMs are
tensor-core bound at ViT-B, so the first version accepts that, and fusing
fc1 into fc2 is later work.  The TPU epilogue's A&S erf is replaced by the
exact erf, as the JAX XLA path uses.  The save-pre mode is not ported
(eval saves nothing).

A CUDA tensor launches the kernels (or raises); a CPU tensor takes
:func:`cp_mlp_block_plain`.  Forward only.
"""

from __future__ import annotations

import torch

from cara_tpu_torch.ops.cuda import _build
from cara_tpu_torch.ops.cuda._site import site_cuda, site_plain
from cara_tpu_torch.ops.layers import activation, layer_norm

#: Number of (two-launch) kernel calls made by :func:`cp_mlp_block`.
LAUNCHES = 0


def cp_mlp_block_plain(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2,
                       ln_scale, ln_bias, dpm, s: float = 1.0,
                       act: str = "gelu", ln_eps: float = 1e-6):
    """Plain PyTorch twin of :func:`cp_mlp_block` (LN2(x), z1, h and z2
    rounded to ``x.dtype``, as in ``_mlp_fwd_kernel``)."""
    dt = x.dtype
    xa = layer_norm(x, ln_scale, ln_bias, ln_eps)
    h = activation(site_plain(xa, w1, b1, u1, v1, cb1, s), act).to(dt)
    y = site_plain(h, w2, b2, u2, v2, cb2, s)
    gate = torch.broadcast_to(dpm, x.shape[:-1] + (1,)).float()
    return (x.float() + gate * y).to(dt)


def cp_mlp_block(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2, cb2, ln_scale,
                 ln_bias, dpm, s: float = 1.0, act: str = "gelu",
                 ln_eps: float = 1e-6):
    """The CaRA MLP block including residual and drop-path gate.

    ``x`` (..., E); ``dpm`` broadcastable to ``x.shape[:-1] + (1,)`` (ones
    in eval).  Callers fold the delta scale into ``v1``/``cb1``/``v2``/
    ``cb2`` and pass ``s=1.0``."""
    global LAUNCHES
    _build.check_no_grad("cp_mlp_block", x, w1, b1, u1, v1, cb1, w2, b2, u2,
                         v2, cb2, ln_scale, ln_bias, dpm)
    lead, e = x.shape[:-1], x.shape[-1]
    if x.device.type == "cpu":
        return cp_mlp_block_plain(x, w1, b1, u1, v1, cb1, w2, b2, u2, v2,
                                  cb2, ln_scale, ln_bias, dpm, s, act,
                                  ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if act != "gelu":
        raise ValueError(f"the cp_site kernel's epilogue has exact GELU "
                         f"only; act={act!r} is not yet ported")
    if w2.shape[1] != e:
        raise ValueError(f"residual-fused MLP needs W2 out == E "
                         f"({w2.shape[1]} vs {e})")
    x2 = x.reshape(-1, e)
    h = site_cuda(x2, w1, b1, u1, v1, cb1, s,
                  ln=(ln_scale, ln_bias, ln_eps), gelu=True)
    dpm_rows = torch.broadcast_to(dpm, lead + (1,)).float().reshape(-1)
    out = site_cuda(h, w2, b2, u2, v2, cb2, s, res=x2,
                    dpm_rows=dpm_rows.contiguous())
    LAUNCHES += 1
    return out.reshape(*lead, e)
