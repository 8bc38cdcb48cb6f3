"""Dequant-fused int8 GEMM: ``y = (x @ Wq) * scale + b`` in one kernel.

Kernel: ``csrc/int8_dense.cu``.  It replaces the TPU kernel
``cara_tpu/ops/pallas/int8_dense.py`` (``int8_dense``,
``_int8_dense_kernel``), whose point is that the weight leaves device
memory as int8, half the bytes of bf16, and is converted right before
the product.  Here the int8 (K, N) tiles arrive by TMA, and the two
consumer warpgroups convert each to the bf16 tile that their ``wgmma``
products read from shared memory while the previous tile's products
run; the scale and the bias are applied in the epilogue from the fp32
accumulators.

At large M the products bound it (the tensor cores); at batch 1 (M 197
or 257) the weight's bytes do, and a grid of output tiles alone would
leave most of the 132 SMs idle.  :func:`plan` picks, from M, K and N,
the block width and how many ways to split the contraction: split z
writes an fp32 partial, and a second kernel sums the partials in split
order, then scales and adds the bias (two calls give the same bits).
The source's head comment has the design.

``models.vit.matk`` calls it for the weight-only (w8) quant dicts of
``models/quant.py`` when ``CARA_INT8_PALLAS=1`` is set, as the reference
does.  Inference only, as in JAX: the wrapper raises when autograd would
record through it.  A CUDA tensor launches the kernel (or raises); a CPU
tensor takes :func:`int8_dense_plain`.
"""

from __future__ import annotations

import functools

import torch

from cara_tpu_torch.ops.cuda import _build

#: Number of kernel launches made by :func:`int8_dense`.
LAUNCHES = 0
#: The dims the kernel takes: K and N multiples of this (``matk`` sends
#: no others).
DIM_MULTIPLE = 128
_BM, _BK = 128, 64  # the kernel's block rows and contraction step


@functools.lru_cache(maxsize=256)
def plan(m: int, k: int, n: int, sms: int = 132):
    """(block width, splits) of a call: 256-wide blocks where N allows and
    they fill the ``sms`` SMs, else 128-wide.  Where the 128-wide grid
    fills at most half of them, the contraction's k-steps are split
    ``splits`` ways (a divisor of K / 64), the one with the least
    ``waves * (k-steps a block + 2)`` (2: a block's pipeline fill), ties
    to fewer splits."""
    mt = -(-m // _BM)
    if n % 256 == 0 and mt * (n // 256) >= sms:
        return 256, 1
    tiles = mt * (n // 128)
    if 2 * tiles > sms:
        return 128, 1
    kt = k // _BK

    def cost(d):
        return -(-tiles * d // sms) * (kt // d + 2)

    return 128, min((d for d in range(1, kt + 1) if kt % d == 0),
                    key=lambda d: (cost(d), d))


def sm_count(dev) -> int:
    """The SMs of CUDA device ``dev`` (132, an H100's, for another
    device), the ``sms`` of :func:`plan`."""
    return _cuda_sm_count(dev.index) if dev.type == "cuda" else 132


@functools.lru_cache(maxsize=None)
def _cuda_sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int8_dense_plain(x, wq, scale, b):
    """fp32 ``(x @ Wq) * scale + b``, cast to ``x.dtype`` (``b`` None: no
    bias)."""
    n = wq.shape[1]
    y = (x.float() @ wq.float()) * scale.float().reshape(n)
    if b is not None:
        y = y + b.float().reshape(n)
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
            or n % DIM_MULTIPLE or scale.numel() != n
            or (b is not None and b.numel() != n)):
        raise ValueError(
            f"int8_dense takes K and N multiples of {DIM_MULTIPLE}: x "
            f"{tuple(x2.shape)}, wq {tuple(wq.shape)}, scale "
            f"{tuple(scale.shape)}, b "
            f"{None if b is None else tuple(b.shape)}")
    out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
    bn, splits = plan(m, k, n, sm_count(dev))
    ws = None
    if splits > 1:
        ws = torch.empty((splits * -(-m // _BM) * _BM, n), device=dev,
                         dtype=torch.float32)
    code = _build.lib().cara_int8_dense(
        x2.data_ptr(), wq.data_ptr(), scale.data_ptr(), _build.ptr(b),
        out.data_ptr(), _build.ptr(ws), m, k, n, bn, splits, k // splits,
        _build.stream_ptr(dev))
    _build.check(code, "int8_dense")
    return out


def int8_dense(x, wq, scale, b, impl: str = "auto"):
    """``(x @ wq) * scale + b``: x (..., K) float, wq (K, N) int8, scale
    (N,) or (1, N), b (N,) or None (no bias) -> (..., N) in ``x.dtype``,
    fp32 accumulation.  ``impl="plain"`` runs the plain version on any
    device."""
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
                          None if b is None else b.reshape(n).contiguous())
    LAUNCHES += 1
    return out.reshape(*lead, n)
