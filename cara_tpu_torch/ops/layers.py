"""Basic functional layers (port of ``cara_tpu/ops/layers.py``, subset).

LayerNorm with fp32 statistics, the exact-erf GELU and its derivative,
inverted dropout and the XLA attention ``mha``.  Drop-path rides the
block kernels as a per-image gate (``models/vit.py``).  Random masks are
drawn by the caller (``jax.random`` and ``torch.Generator`` give other
bits), so these take the keep mask, not a key.
"""

from __future__ import annotations

from typing import Optional

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics and affine math
    for bf16 inputs (PyTorch's fused kernel accumulates in fp32), the
    result in ``x.dtype``, as in the JAX reference."""
    return torch.nn.functional.layer_norm(
        x, x.shape[-1:], scale.to(x.dtype), bias.to(x.dtype), eps)


def linear(x: torch.Tensor, kernel: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """``x @ kernel + bias`` for an (in, out) kernel, bias added in the
    GEMM's epilogue (one kernel instead of a product and an add)."""
    return torch.nn.functional.linear(x, kernel.t(), bias)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU (``jax.nn.gelu(approximate=False)``)."""
    return torch.nn.functional.gelu(x, approximate="none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


def activation(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "gelu":
        return gelu(x)
    if name == "quick_gelu":
        return quick_gelu(x)
    raise ValueError(f"unknown activation {name!r}")


def activation_grad(y: torch.Tensor, name: str) -> torch.Tensor:
    """d(act)/dy at the pre-activation ``y`` (``cp_dense._act_grad``)."""
    if name == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(y * 0.7071067811865476))
        return cdf + y * torch.exp(-0.5 * y * y) * 0.3989422804014327
    if name == "quick_gelu":
        sig = torch.sigmoid(1.702 * y)
        return sig + 1.702 * y * sig * (1.0 - sig)
    raise ValueError(f"unknown activation {name!r}")


def dropout(x: torch.Tensor, rate: float,
            keep: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverted dropout with the boolean ``keep`` mask (x's shape):
    ``where(keep, x / (1 - rate), 0)`` in ``x.dtype``, as the reference
    rounds it; the identity when ``rate <= 0`` or ``keep`` is None
    (eval)."""
    if rate <= 0.0 or keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
        attn_drop_rate: float = 0.0,
        keep: Optional[torch.Tensor] = None,
        key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's attention (``cara_tpu/ops/layers.py`` ``mha``) on
    (B, H, N, Dh) q, k, v -> (B, N, H * Dh), with :func:`dropout` on the
    probabilities (``keep`` (B, H, N, N) boolean, or None).  Rounding
    points as there: scores in the input dtype times the scale, the
    softmax in fp32 and rounded to the input dtype before the dropout and
    the second product.  ``key_bias`` (broadcastable to (B, H, N, N), or
    None) adds to the fp32 scores before the softmax: ToMe's
    proportional attention, ``log(token size)`` (``models/tome.py``).
    JAX leaves it to XLA, not to a Pallas kernel, so plain PyTorch is its
    port."""
    b, h, n, d = q.shape
    attn = torch.einsum("bhnd,bhmd->bhnm", q, k) * scale
    attn = attn.to(torch.promote_types(q.dtype, torch.float32))
    if key_bias is not None:
        attn = attn + key_bias.to(attn.dtype)
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    attn = dropout(attn, attn_drop_rate, keep)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
    return out.transpose(1, 2).reshape(b, n, h * d)
