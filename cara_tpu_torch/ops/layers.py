"""Basic functional layers (port of ``cara_tpu/ops/layers.py``, eval subset).

Only what the serving forward needs: LayerNorm with fp32 statistics and the
exact-erf GELU.  Dropout and drop-path are identities in eval and come with
the training slice.
"""

from __future__ import annotations

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
