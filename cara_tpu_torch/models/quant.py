"""int8 quantization for serving (port of ``cara_tpu/models/quant.py``):
weight-only (w8) and full int8 (w8a8).

Both modes are per-output-channel symmetric on the stacked block kernels
(qkv, proj, fc1, fc2); embed, head, LayerNorm and positional parameters
stay in full precision:

* ``mode="w8"`` (weight-only): the int8 codes dequantize to the
  activation dtype inside each layer's GEMM (``models.vit.matk``), or,
  with ``CARA_INT8_PALLAS=1`` on the card, stream as int8 into the
  dequant-fused GEMM kernel (``ops/cuda/int8_dense.py``, TPU row 18);
* ``mode="w8a8"``: the activations are also quantized per token at run
  time (exact row maxima) and the product runs int8 x int8 -> int32.

The arithmetic is the reference's, in fp32 and in its order (max|w| /
127 clamped at 1e-12, round half to even, clip to +-127), so the codes
and scales equal the JAX package's bit for bit; the scale is cast to the
weight's dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

QUANT_NAMES = ("qkv", "proj", "fc1", "fc2")
MODES = ("w8", "w8a8")


def quantize_kernel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., in, out) float kernel -> {"q": int8, "scale": (..., 1, out)}:
    ``w ~= q * scale``, symmetric per output channel.  Computed in fp32
    whatever ``w``'s dtype, as the reference does."""
    w32 = w.float()
    scale = w32.abs().amax(dim=-2, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(w.dtype)}


def dequantize_kernel(k: Dict[str, torch.Tensor]) -> torch.Tensor:
    q = k["qa"] if "qa" in k else k["q"]
    return q.to(k["scale"].dtype) * k["scale"]


def is_quantized(kernel: Any) -> bool:
    """Whether a block kernel is a quant dict of this module."""
    return isinstance(kernel, dict) and ("q" in kernel or "qa" in kernel)


def column_major_codes(params: Dict[str, Any]) -> Dict[str, Any]:
    """The w8a8 codes of ``quantize_block_weights`` laid out column-major:
    the same (..., in, out) values with the ``in`` axis fastest, so that
    each layer's slice is the second operand ``torch._int_mm`` (cuBLASLt's
    int8 GEMM) runs its fastest kernel on; weight-only codes and every
    other leaf are kept."""
    blocks = dict(params["blocks"])
    for name in QUANT_NAMES:
        k = blocks[name]["kernel"]
        if isinstance(k, dict) and "qa" in k:
            qa = k["qa"].transpose(-1, -2).contiguous().transpose(-1, -2)
            blocks[name] = dict(blocks[name], kernel=dict(k, qa=qa))
    out = dict(params)
    out["blocks"] = blocks
    return out


def quantize_block_weights(params: Dict[str, Any],
                           mode: str = "w8") -> Dict[str, Any]:
    """Quantize the stacked block kernels (qkv / proj / fc1 / fc2) to the
    int8 quant dicts ``models.vit.matk`` reads; everything else is kept.

    ``mode="w8"`` stores the codes under ``"q"``, ``"w8a8"`` under
    ``"qa"`` (the key carries the mode, as in the reference)."""
    if mode not in MODES:
        raise ValueError(f"quantize mode must be 'w8' or 'w8a8', got "
                         f"{mode!r}")
    blocks = dict(params["blocks"])
    for name in QUANT_NAMES:
        lin = blocks[name]
        k = quantize_kernel(lin["kernel"])
        if mode == "w8a8":
            k = {"qa": k["q"], "scale": k["scale"]}
        blocks[name] = {"kernel": k, "bias": lin["bias"]}
    out = dict(params)
    out["blocks"] = blocks
    return out
