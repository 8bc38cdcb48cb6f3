"""Flash attention on separate (B, H, N, Dh) q, k and v, forward and
backward: the attention of full fine-tuning (``attn_impl="flash"``).

Kernels: ``csrc/flash_attention.cu`` (forward, writes the output and the
per-row log-sum-exp) and ``csrc/flash_attention_bwd.cu`` (the row pass
D = rowsum(do * o), one ``wgmma`` kernel of five products per 128-key
tile, and the pass that rounds dq).
They replace the TPU kernels of ``cara_tpu/ops/pallas/flash_attention.py``,
TPU row 17: ``_attn_fwd_kernel`` (the ``pallas_call`` in ``_fwd``) and
``_attn_bwd_kernel`` (the ``pallas_call`` in ``_bwd_rule``).  Their tile
loops are the blockwise attention's (row 16), shared through
``csrc/tiled_attention_fwd.cuh`` / ``tiled_attention_bwd.cuh``; here
they take each operand by base pointer and (batch, head, row) strides.

What bounds it on the H100, and what the design does about it: at
B = 64, N = 197, H = 12, Dh = 64 the forward needs 15.3 GFLOP against
77.5 MB and the backward 38.2 GFLOP against ~136 MB, so both are bound by
bytes (~0.023 / 0.041 ms); at N = 577 by operations (~0.068 / 0.166 ms).
The TPU kernel holds each (g, N, N) score tile whole in VMEM, padded to a
multiple of 128; a Hopper block has 227 KB, which the 577 x 577 tile does
not fit, so the forward streams the key axis in 64-key tiles by TMA
past two ``wgmma`` warpgroups with an online softmax, the score tile
kept in registers, and the backward streams the query axis by TMA
past two ``wgmma`` warpgroups of one 128-key tile (dq's fp32 sum over the
key tiles in key-tile order, so bitwise deterministic); N is taken as
it is (no padding).  The strides
let the model's views pass with no copy: q, k, v split from the qkv GEMM
output and transposed to (B, H, N, Dh), and the output written to a
(B, N, H, Dh) buffer whose transpose back to (B, N, E) is free.

Rounding: the plain twins keep the TPU kernels' rounding points -- fp32
scores, P normalized before its cast to the input dtype, and in the
backward D = rowsum(dp * p) from the fp32 p and dp and ds rounded to the
input dtype.  The kernels round P against the running max and divide by
the row sum at the end, and take D from rowsum(do * o) on the rounded
output: both bf16-level differences, inside the card tolerance
(``chip_smoke.KERNEL_TOL``).

The wrapper is a ``torch.autograd.Function``; the kernels keep q, k, v,
the output and its log-sum-exp, the plain twin q, k and v (as the JAX
rule's residual).  A CUDA tensor launches the kernels (or raises); a CPU
tensor, or ``impl="plain"``, takes the plain twins.  The kernels take
head widths of ``blockwise_attention.HEAD_DIMS`` (16, 32, 64 and 80: the
test model's, ViT-B / ViT-L's and ViT-H/14's, the same instances as rows
2 and 16); another width on the card raises.
"""

from __future__ import annotations

import ctypes

import torch

from cara_tpu_torch.ops.cuda import _build
from cara_tpu_torch.ops.cuda.blockwise_attention import (bwd_scratch,
                                                         check_head_dim)

#: Forward kernel launches of :func:`flash_attention` (row 17).
LAUNCHES = 0
#: Backward calls (the row pass, the main kernel and the dq pass).
BWD_LAUNCHES = 0


def flash_attention_fwd_plain(q, k, v, scale: float) -> torch.Tensor:
    """Plain twin of the forward: (B, H, N, Dh) in ``q.dtype``, with
    ``_attn_fwd_kernel``'s rounding points (fp32 scores and softmax, P
    normalized, then rounded to the input dtype for P V)."""
    dt = q.dtype
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    return (p.float() @ v.float()).to(dt)


def flash_attention_bwd_plain(q, k, v, do, scale: float):
    """Plain twin of the backward: (dq, dk, dv) in ``q.dtype``, with
    ``_attn_bwd_kernel``'s rounding points (P recomputed in fp32,
    D = rowsum(dp * p) in fp32, ds rounded to the input dtype, dv from
    the rounded P)."""
    dt = q.dtype
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    s = (qf @ kf.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = p.to(dt).float().transpose(-1, -2) @ gf
    dp = gf @ vf.transpose(-1, -2)
    row = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - row)).to(dt).float()
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _fits(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t`` as it lies: head dimension
    contiguous, 16-byte aligned rows (every other stride a multiple of 8
    elements where its size is above 1)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s, n in zip(t.stride()[:3], t.shape[:3])
                    if n > 1))


def _layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it lies when the kernels can read it, else a contiguous
    copy (a layout change, not another computation)."""
    return t if _fits(t) else t.clone(memory_format=torch.contiguous_format)


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check(name, **operands):
    """Same (B, H, N, Dh) shape, device and bf16 type for every operand,
    Dh one the kernels take; returns the shape."""
    q = operands["q"]
    b, h, n, dh = q.shape
    check_head_dim(name, dh)
    for key, t in operands.items():
        if t.shape != q.shape:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, q "
                             f"{tuple(q.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {key} must be bfloat16 on CUDA, got "
                            f"{t.dtype}")
    return b, h, n, dh


def _head_buffer(b, h, n, dh, device):
    """A (B, H, N, Dh) bf16 view of a (B, N, H, Dh) buffer."""
    return torch.empty((b, n, h, dh), device=device,
                       dtype=torch.bfloat16).transpose(1, 2)


def attention_fwd_cuda(q, k, v, scale: float):
    """Launch ``csrc/flash_attention.cu``: (out bf16 (B, H, N, Dh), a view
    of a (B, N, H, Dh) buffer; lse (B, N, H) fp32)."""
    b, h, n, dh = _check("flash_attention", q=q, k=k, v=v)
    q, k, v = (_layout(t) for t in (q, k, v))
    out = _head_buffer(b, h, n, dh, q.device)
    lse = torch.empty((b, n, h), device=q.device, dtype=torch.float32)
    code = _build.lib().cara_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _strides(q, k, v, out), b, n, h, dh, float(scale),
        _build.stream_ptr(q.device))
    _build.check(code, "flash_attention")
    return out, lse


def attention_bwd_cuda(q, k, v, out, lse, do, scale: float):
    """Launch ``csrc/flash_attention_bwd.cu``: (dq, dk, dv) bf16, each a
    (B, H, N, Dh) view of a (B, N, H, Dh) buffer."""
    b, h, n, dh = _check("flash_attention_bwd", q=q, k=k, v=v, out=out,
                         do=do)
    if (lse.shape != (b, n, h) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: wants fp32 lse (B, N, H) "
                         f"= {(b, n, h)}, got {tuple(lse.shape)}")
    q, k, v, out, do = (_layout(t) for t in (q, k, v, out, do))
    dq, dk, dv = (_head_buffer(b, h, n, dh, q.device) for _ in range(3))
    rows, dq_acc = bwd_scratch(b, n, h, dh, q.device)
    code = _build.lib().cara_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), rows.data_ptr(), dq_acc.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, out, do, dq, dk, dv), b, n, h, dh, float(scale),
        _build.stream_ptr(q.device))
    _build.check(code, "flash_attention_bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """dq, dk, dv from the kept operands (and, on the card, the output
    and its log-sum-exp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, plain):
        global LAUNCHES
        if plain:
            out = flash_attention_fwd_plain(q, k, v, scale)
            ctx.save_for_backward(q, k, v)
        else:
            out, lse = attention_fwd_cuda(q, k, v, scale)
            LAUNCHES += 1
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (scale, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        global BWD_LAUNCHES
        scale, plain = ctx.cfg
        if plain:
            q, k, v = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, g, scale)
        else:
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = attention_bwd_cuda(q, k, v, out, lse, g, scale)
            BWD_LAUNCHES += 1
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, impl: str = "auto") -> torch.Tensor:
    """(B, H, N, Dh) q, k, v -> (B, H, N, Dh) attention output, as
    ``cara_tpu.ops.pallas.flash_attention.flash_attention``; no key is
    masked.  Differentiable in q, k and v; any strides with the head
    dimension contiguous pass as they lie.  ``impl="plain"`` runs the
    plain twins on any device."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, N, Dh), got {tuple(q.shape)}")
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    plain = impl == "plain" or q.device.type == "cpu"
    if not plain and q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _FlashAttention.apply(q, k, v, scale, plain)
