"""Layout-native fused attention on the (B, N, 3E) qkv GEMM output.

Kernel: ``csrc/qkv_attention.cu``.  It replaces the TPU kernel
``cara_tpu/ops/pallas/fused_qkv_attention.py`` (``fused_qkv_attention``,
``_fwd``; per-head math ``_attn_heads``).  What bounds it on the H100 and
what the design does about it is in the source's head comment: one block
per (image, head, 64-query tile), that head's K and V resident in shared
memory (> 48 KB, opt-in), fp32 softmax, bf16 tensor-core products.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`fused_qkv_attention_plain`.  Forward only.
"""

from __future__ import annotations

import torch

from cara_tpu_torch.ops.cuda import _build

NEG_INF = -1e30
MAX_NP_FULL_SCORES = 512

#: Number of kernel launches made by :func:`fused_qkv_attention`.
LAUNCHES = 0


def _check_np(np_: int) -> None:
    if np_ > MAX_NP_FULL_SCORES:
        raise ValueError(
            f"fused_qkv_attention holds a head's full score rows and is "
            f"capped at N={MAX_NP_FULL_SCORES} (got N={np_}); the "
            "blockwise (online-softmax) attention is not yet ported")


def fused_qkv_attention_plain(qkv: torch.Tensor, heads: int, scale: float,
                              n_real: int) -> torch.Tensor:
    """Plain PyTorch twin: (B, N, 3E) -> (B, N, E) in ``qkv.dtype``.

    Same rounding points as ``_attn_heads``: q is scaled in the input
    dtype, scores and softmax run in fp32, the unnormalized P is rounded
    to the input dtype for P@V and 1/l is applied after the product."""
    b, n, e3 = qkv.shape
    e = e3 // 3
    dh = e // heads
    dt = qkv.dtype

    def head_major(t):
        return t.reshape(b, n, heads, dh).transpose(1, 2).float()

    q = head_major(qkv[..., :e] * scale)
    k = head_major(qkv[..., e:2 * e])
    v = head_major(qkv[..., 2 * e:])
    s = q @ k.transpose(-1, -2)
    if n_real < n:
        valid = torch.arange(n, device=qkv.device) < n_real
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    ex = torch.exp(s - m)
    inv_l = 1.0 / ex.sum(dim=-1, keepdim=True)
    o = (ex.to(dt).float() @ v) * inv_l
    return o.to(dt).transpose(1, 2).reshape(b, n, e)


def attention_cuda(qkv: torch.Tensor, heads: int, scale: float,
                   n_real: int) -> torch.Tensor:
    """Launch ``csrc/qkv_attention.cu`` (no launch count; the block
    kernels call this directly)."""
    bsz, n, e3 = qkv.shape
    e = e3 // 3
    dh = e // heads
    dev = qkv.device
    _build.check_cuda_inputs("qkv_attention", dev, qkv=qkv)
    if e3 != 3 * e or heads * dh != e or dh not in (16, 32, 64):
        raise ValueError(f"qkv_attention: 3E={e3}, heads={heads} gives "
                         f"head dim {dh}; the kernel takes 16, 32 or 64")
    lib = _build.lib()
    if lib.cara_qkv_attention_smem(n, dh) == 0:
        raise ValueError(f"qkv_attention: N={n} does not fit one block's "
                         "shared memory")
    out = torch.empty((bsz, n, e), device=dev, dtype=torch.bfloat16)
    code = lib.cara_qkv_attention(
        qkv.data_ptr(), out.data_ptr(), bsz, n, heads, dh, int(n_real),
        float(scale), _build.stream_ptr(dev))
    _build.check(code, "qkv_attention")
    return out


def fused_qkv_attention(qkv: torch.Tensor, heads: int, scale: float,
                        n_real: int) -> torch.Tensor:
    """qkv (B, N, 3E), out-flat (3, H, Dh) columns -> attention output
    (B, N, E); keys at positions >= ``n_real`` are masked."""
    global LAUNCHES
    _build.check_no_grad("fused_qkv_attention", qkv)
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3E), got {tuple(qkv.shape)}")
    _check_np(qkv.shape[1])
    if not 1 <= n_real <= qkv.shape[1]:
        raise ValueError(f"n_real={n_real} outside [1, {qkv.shape[1]}]")
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, heads, scale, n_real)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    out = attention_cuda(qkv, heads, scale, n_real)
    LAUNCHES += 1
    return out
