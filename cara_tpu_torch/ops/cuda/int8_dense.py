"""Dequant-fused int8 GEMM: ``y = (x @ Wq) * scale + b`` in one kernel.

Kernel: ``csrc/int8_dense.cu``.  It replaces the TPU kernel
``cara_tpu/ops/pallas/int8_dense.py`` (``int8_dense``,
``_int8_dense_kernel``), whose point is that the weight leaves device
memory as int8, half the bytes of bf16, and is converted right before
the product.  Here the int8 (K, N) tiles stream into shared memory by
``cp.async`` and are converted to bf16 there, just before the
``mma.sync`` products; the scale and the bias are applied in the
epilogue from the fp32 accumulators.  What bounds it on the H100 and how
the design answers is in the source's head comment.

``models.vit.matk`` calls it for the weight-only (w8) quant dicts of
``models/quant.py`` when ``CARA_INT8_PALLAS=1`` is set, as the reference
does.  Inference only, as in JAX: the wrapper raises when autograd would
record through it.  A CUDA tensor launches the kernel (or raises); a CPU
tensor takes :func:`int8_dense_plain`.
"""

from __future__ import annotations

import torch

from cara_tpu_torch.ops.cuda import _build

#: Number of kernel launches made by :func:`int8_dense`.
LAUNCHES = 0
#: The dims the kernel takes: K and N multiples of this (``matk`` sends
#: no others).
DIM_MULTIPLE = 128


def int8_dense_plain(x, wq, scale, b):
    """fp32 ``(x @ Wq) * scale + b``, cast to ``x.dtype``."""
    n = wq.shape[1]
    y = (x.float() @ wq.float()) * scale.float().reshape(n) \
        + b.float().reshape(n)
    return y.to(x.dtype)


def int8_dense_cuda(x2, wq, scale, b):
    """Launch ``csrc/int8_dense.cu`` on 2-D bf16 ``x2`` (M, K) (no launch
    count): (M, N) bf16."""
    m, k = x2.shape
    n = wq.shape[1]
    dev = x2.device
    _build.check_cuda_inputs("int8_dense", dev, x=x2, scale=scale, b=b)
    if wq.device != dev or wq.dtype != torch.int8 \
            or not wq.is_contiguous() or wq.data_ptr() % 16:
        raise ValueError("int8_dense: wq must be a contiguous, 16-byte "
                         f"aligned int8 tensor on {dev}")
    if (wq.dim() != 2 or wq.shape[0] != k or k % DIM_MULTIPLE
            or n % DIM_MULTIPLE or scale.numel() != n or b.numel() != n):
        raise ValueError(
            f"int8_dense takes K and N multiples of {DIM_MULTIPLE}: x "
            f"{tuple(x2.shape)}, wq {tuple(wq.shape)}, scale "
            f"{tuple(scale.shape)}, b {tuple(b.shape)}")
    out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
    code = _build.lib().cara_int8_dense(
        x2.data_ptr(), wq.data_ptr(), scale.data_ptr(), b.data_ptr(),
        out.data_ptr(), m, k, n, _build.stream_ptr(dev))
    _build.check(code, "int8_dense")
    return out


def int8_dense(x, wq, scale, b, impl: str = "auto"):
    """``(x @ wq) * scale + b``: x (..., K) float, wq (K, N) int8, scale
    (N,) or (1, N), b (N,) -> (..., N) in ``x.dtype``, fp32 accumulation.
    ``impl="plain"`` runs the plain version on any device."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    _build.refuse_autograd("int8_dense", x, scale, b)
    lead, k = x.shape[:-1], x.shape[-1]
    if wq.dim() != 2 or wq.shape[0] != k:
        raise ValueError(f"int8_dense: x (..., {k}) against wq "
                         f"{tuple(wq.shape)}")
    if impl == "plain" or x.device.type == "cpu":
        return int8_dense_plain(x, wq, scale, b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    global LAUNCHES
    n = wq.shape[1]
    out = int8_dense_cuda(x.reshape(-1, k).contiguous(), wq,
                          scale.reshape(n).contiguous(),
                          b.reshape(n).contiguous())
    LAUNCHES += 1
    return out.reshape(*lead, n)
