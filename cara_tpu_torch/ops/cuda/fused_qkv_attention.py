"""Layout-native fused attention on the (B, N, 3E) qkv GEMM output.

Kernel: ``csrc/qkv_attention.cu``.  It replaces the TPU kernel
``cara_tpu/ops/pallas/fused_qkv_attention.py`` (``fused_qkv_attention``,
``_fwd``; per-head math ``_attn_heads``).  What bounds it on the H100 and
what the design does about it is in the source's head comment: one
persistent block per SM over the (image, head) items, Q, K and V loaded
once by TMA, S = Q K^T and O = P V by ``wgmma`` with the scores and P in
registers (``sm_90a``).

The wrapper is a ``torch.autograd.Function`` that keeps qkv, as the JAX
rule's residual does.  Its backward replaces ``_bwd_rule`` /
``_bwd_kernel`` (per-head math ``attn_bwd_tile``): kernel
``csrc/qkv_attention_bwd.cu`` through :func:`attention_bwd_cuda`, with
:func:`attention_bwd_plain` its twin; the attention-block backwards of
rows 4, 6 and 8 launch the same kernel.  It is the tiled backward of rows
16 and 17 (``csrc/tiled_attention_bwd.cuh``: five ``wgmma`` products per
128-key tile, dq summed in an fp32 scratch in key-tile order, so bitwise
deterministic) after a statistics pass that takes each row's log-sum-exp
and D = rowsum(p dp) from fp32 p and dp, since JAX keeps no forward
output; keys are streamed, so it takes every N the forward takes.  Both
kernels take the head widths of ``blockwise_attention.HEAD_DIMS``.

:func:`fused_qkv_attention_proj` is the attention with the projection
site fused after it, ``y = o W + b + s ((o U) V + cb)`` for ``o`` the
attention output: TPU row 3 (``fused_qkv_attention_proj``, ``_fwd_proj``
/ ``_fwd_proj_kernel``), the kernel ``csrc/attn_proj.cu`` (``wgmma`` +
TMA: keys streamed through a ring, ``o`` kept in shared memory between
the attention and the projection, never in device memory).  It takes
every head width of ``blockwise_attention.HEAD_DIMS``, E up to
:data:`MAX_PROJ_E` and every N up to 512.  Its backward, rows 3 and 4
(``_bwd_proj_rule``), composes the port's kernels: row 12's dx
(``cp_dense.cp_dense_dx_cuda``) for d(o) and gv, row 1's kernel to
recompute ``o`` (the TPU's ``_attn_raw``), the rank-space factor
products and column sums of the split sites, and row 2's kernel for
dqkv (the TPU's ``_attn_bwd_raw``).

A CUDA tensor launches the kernels (or raises); a CPU tensor, or
``impl="plain"``, takes the plain versions.
"""

from __future__ import annotations

import torch

from cara_tpu_torch.ops.cuda import _build, _bwd
from cara_tpu_torch.ops.cuda._site import site_plain
from cara_tpu_torch.ops.cuda.blockwise_attention import (bwd_scratch,
                                                         check_head_dim)
from cara_tpu_torch.ops.cuda.cp_dense import (
    _factor_grads_cuda, _factor_grads_plain, cp_dense_dx_cuda,
    cp_dense_dx_plain)

NEG_INF = -1e30
MAX_NP_FULL_SCORES = 512
#: Widest E row 3's kernel takes (ViT-H/14's): its 64-row o tile (64 x E
#: bf16, 160 KB) leaves two 32 KB rings of one block's shared memory.
MAX_PROJ_E = 1280
_PROJ_WIDE_TODO = "ROADMAP.md queue 2: Row 3 past E 1280"

#: Number of kernel launches made by :func:`fused_qkv_attention`.
LAUNCHES = 0
#: Backward kernel launches of :func:`fused_qkv_attention` (TPU row 2).
BWD_LAUNCHES = 0
#: Kernel launches of :func:`fused_qkv_attention_proj` (TPU row 3).
PROJ_LAUNCHES = 0
#: Backward calls of :func:`fused_qkv_attention_proj` (rows 3 and 4).
PROJ_BWD_LAUNCHES = 0


def _check_np(np_: int) -> None:
    if np_ > MAX_NP_FULL_SCORES:
        raise ValueError(
            f"fused_qkv_attention holds a head's full score rows and is "
            f"capped at N={MAX_NP_FULL_SCORES} (got N={np_}); above it "
            "the blockwise (online-softmax) attention "
            "(ops/cuda/blockwise_attention.py) takes over")


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
    if e3 != 3 * e or heads * dh != e:
        raise ValueError(f"qkv_attention: 3E={e3} is not 3 x {heads} heads")
    check_head_dim("qkv_attention", dh)
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


def attention_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, heads: int,
                        scale: float, n_real: int) -> torch.Tensor:
    """dqkv (B, N, 3E) in ``qkv.dtype`` from qkv and the output cotangent
    do (B, N, E): the math and rounding points of ``attn_bwd_tile``
    (``fused_qkv_attention.py:118``) -- qs rounded after the scale, p
    normalized in fp32 and rounded for dv, ds rounded before dq and dk,
    each of dq, dk, dv rounded."""
    b, n, e3 = qkv.shape
    e = e3 // 3
    dh = e // heads
    dt = qkv.dtype

    def head_major(t):
        return t.reshape(b, n, heads, dh).transpose(1, 2).float()

    qs = head_major(qkv[..., :e] * scale)
    k = head_major(qkv[..., e:2 * e])
    v = head_major(qkv[..., 2 * e:])
    g = head_major(do)
    s = qs @ k.transpose(-1, -2)
    if n_real < n:
        valid = torch.arange(n, device=qkv.device) < n_real
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    ex = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = ex * (1.0 / ex.sum(dim=-1, keepdim=True))
    dv = p.to(dt).float().transpose(-1, -2) @ g
    dp = g @ v.transpose(-1, -2)
    row = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - row)).to(dt).float()
    dq = (ds @ k) * scale
    dk = ds.transpose(-1, -2) @ qs

    def flat(t):
        return t.to(dt).transpose(1, 2).reshape(b, n, e)

    return torch.cat([flat(dq), flat(dk), flat(dv)], dim=-1)


def attention_bwd_cuda(qkv: torch.Tensor, do: torch.Tensor, heads: int,
                       scale: float, n_real: int) -> torch.Tensor:
    """Launch ``csrc/qkv_attention_bwd.cu`` (no launch count; the
    attention-block backwards call this directly)."""
    bsz, n, e3 = qkv.shape
    e = e3 // 3
    dh = e // heads
    dev = qkv.device
    _build.check_cuda_inputs("qkv_attention_bwd", dev, qkv=qkv, do=do)
    if do.shape != (bsz, n, e) or heads * dh != e:
        raise ValueError(f"qkv_attention_bwd: qkv {tuple(qkv.shape)}, do "
                         f"{tuple(do.shape)}, heads={heads}")
    check_head_dim("qkv_attention_bwd", dh)
    rows, dq_acc = bwd_scratch(bsz, n, heads, dh, dev)
    out = torch.empty_like(qkv)
    code = _build.lib().cara_qkv_attention_bwd(
        qkv.data_ptr(), do.data_ptr(), rows.data_ptr(), dq_acc.data_ptr(),
        out.data_ptr(), bsz, n, heads, dh, int(n_real), float(scale),
        _build.stream_ptr(dev))
    _build.check(code, "qkv_attention_bwd")
    return out


class _FusedQkvAttention(torch.autograd.Function):
    """dqkv from the kept qkv and the output cotangent."""

    @staticmethod
    def forward(ctx, qkv, heads, scale, n_real, plain):
        global LAUNCHES
        if plain:
            out = fused_qkv_attention_plain(qkv, heads, scale, n_real)
        else:
            out = attention_cuda(qkv, heads, scale, n_real)
            LAUNCHES += 1
        ctx.save_for_backward(qkv)
        ctx.cfg = (heads, scale, n_real, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        global BWD_LAUNCHES
        (qkv,) = ctx.saved_tensors
        heads, scale, n_real, plain = ctx.cfg
        if plain:
            dqkv = attention_bwd_plain(qkv, g, heads, scale, n_real)
        else:
            dqkv = attention_bwd_cuda(qkv, g.contiguous(), heads, scale,
                                      n_real)
            BWD_LAUNCHES += 1
        return dqkv, None, None, None, None


def fused_qkv_attention(qkv: torch.Tensor, heads: int, scale: float,
                        n_real: int, impl: str = "auto") -> torch.Tensor:
    """qkv (B, N, 3E), out-flat (3, H, Dh) columns -> attention output
    (B, N, E); keys at positions >= ``n_real`` are masked.
    Differentiable in qkv; ``impl="plain"`` runs the plain versions on any
    device."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3E), got {tuple(qkv.shape)}")
    _check_np(qkv.shape[1])
    if not 1 <= n_real <= qkv.shape[1]:
        raise ValueError(f"n_real={n_real} outside [1, {qkv.shape[1]}]")
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    plain = impl == "plain" or qkv.device.type == "cpu"
    if not plain and qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    return _FusedQkvAttention.apply(qkv, heads, scale, n_real, plain)


def fused_qkv_attention_proj_plain(qkv, w, b, u, v, cb, heads: int,
                                   scale: float, n_real: int, s: float):
    """Plain twin of row 3's forward (``_fwd_proj_kernel``'s rounding
    points): the attention output and z = o U rounded to ``qkv.dtype``,
    ``o W + b + s (z V + cb)`` in fp32, rounded once."""
    bsz, n, _ = qkv.shape
    o = fused_qkv_attention_plain(qkv, heads, scale, n_real)
    y = site_plain(o.reshape(bsz * n, -1), w, b, u, v, cb, s)
    return y.to(qkv.dtype).reshape(bsz, n, -1)


def attn_proj_cuda(qkv, w, b, u, v, cb, heads: int, scale: float,
                   n_real: int, s: float):
    """Launch ``csrc/attn_proj.cu`` (no launch count): (B, N, E) bf16."""
    bsz, n, e3 = qkv.shape
    e = e3 // 3
    dh = e // heads
    r = u.shape[1]
    dev = qkv.device
    u8 = _bwd.pad_rank(u)
    _build.check_cuda_inputs("attn_proj", dev, qkv=qkv, w=w, b=b, u=u8, v=v,
                             cb=cb)
    if (e3 != 3 * e or heads * dh != e or e > MAX_PROJ_E
            or w.shape != (e, e) or b.shape != (e,) or u.shape != (e, r)
            or v.shape != (r, e) or cb.shape != (e,)):
        raise ValueError(
            f"attn_proj: qkv {tuple(qkv.shape)}, heads {heads}, w "
            f"{tuple(w.shape)}, u {tuple(u.shape)}, v {tuple(v.shape)}; the "
            f"kernel takes E = heads x Dh up to {MAX_PROJ_E} "
            f"({_PROJ_WIDE_TODO})")
    check_head_dim("attn_proj", dh)
    lib = _build.lib()
    out = torch.empty((bsz, n, e), device=dev, dtype=torch.bfloat16)
    code = lib.cara_attn_proj(
        qkv.data_ptr(), w.data_ptr(), b.data_ptr(), u8.data_ptr(),
        v.data_ptr(), cb.data_ptr(), out.data_ptr(), bsz, n, heads, dh,
        int(n_real), r, u8.shape[1], float(scale), float(s),
        _build.stream_ptr(dev))
    _build.check(code, "attn_proj")
    return out


def fused_qkv_attention_proj_bwd_plain(g, qkv, w, u, v, heads: int,
                                       scale: float, n_real: int, s: float):
    """Plain twin of the backward (``_bwd_proj_rule``'s rounding points):
    g (B, N, E) -> (dqkv in ``qkv.dtype``, du, dv, db fp32)."""
    bsz, n, e = g.shape
    g2 = g.reshape(-1, e)
    dattn, gv = cp_dense_dx_plain(g2, w, u, v, s)
    o2 = fused_qkv_attention_plain(qkv, heads, scale, n_real).reshape(-1, e)
    du, dv, db = _factor_grads_plain(o2, g2, gv, u, s)
    dqkv = attention_bwd_plain(qkv, dattn.reshape(bsz, n, e), heads, scale,
                               n_real)
    return dqkv, du, dv, db


def _attn_proj_bwd_cuda(g, qkv, w, u, v, heads, scale, n_real, s):
    """The backward's launches: row 12's dx (d(o) bf16 and gv), row 1's
    kernel for o, the factor products z = bf16(o U), du = s o^T gv, dv =
    s z^T g and the column sums of g, row 2's kernel for dqkv."""
    bsz, n, e = g.shape
    g2 = g.reshape(-1, e)
    dattn, gv = cp_dense_dx_cuda(g2, w, u, v, s)
    o2 = attention_cuda(qkv, heads, scale, n_real).reshape(-1, e)
    du, dv, db = _factor_grads_cuda(o2, g2, gv, u, s)
    dqkv = attention_bwd_cuda(qkv, dattn.reshape(bsz, n, e), heads, scale,
                              n_real)
    return dqkv, du, dv, db


class _FusedQkvAttentionProj(torch.autograd.Function):
    """Gradients for qkv, b, u, v and cb from the kept qkv (o is
    recomputed); the frozen projection w gets none (JAX's zeros)."""

    @staticmethod
    def forward(ctx, qkv, w, b, u, v, cb, heads, scale, n_real, s, plain):
        global PROJ_LAUNCHES
        args = (qkv, w, b, u, v, cb, heads, scale, n_real, s)
        if plain:
            out = fused_qkv_attention_proj_plain(*args)
        else:
            out = attn_proj_cuda(*args)
            PROJ_LAUNCHES += 1
        ctx.save_for_backward(qkv, w, u, v)
        ctx.cfg = (heads, scale, n_real, s, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        global PROJ_BWD_LAUNCHES
        qkv, w, u, v = ctx.saved_tensors
        heads, scale, n_real, s, plain = ctx.cfg
        args = (g.contiguous(), qkv, w, u, v, heads, scale, n_real, s)
        if plain:
            dqkv, du, dv, db = fused_qkv_attention_proj_bwd_plain(*args)
        else:
            dqkv, du, dv, db = _attn_proj_bwd_cuda(*args)
            PROJ_BWD_LAUNCHES += 1
        dt = g.dtype
        return (dqkv, None, db.to(dt), du.to(u.dtype), dv.to(v.dtype),
                (s * db).to(dt), None, None, None, None, None)


def fused_qkv_attention_proj(qkv, w, b, u, v, cb, heads: int, scale: float,
                             n_real: int, s: float = 1.0,
                             impl: str = "auto"):
    """qkv (B, N, 3E) -> attention (keys >= ``n_real`` masked) -> the
    projection with its CP delta, (B, N, E).  ``w`` (E, E) the frozen
    projection kernel, ``b`` (E,) its bias, ``u`` (E, r) / ``v`` (r, E)
    the collapsed CP factors (``models.cara.rows_out_uv``), ``cb`` (E,)
    the CP bias, ``s`` the delta scale.  Differentiable in qkv,
    b, u, v and cb; ``impl="plain"`` runs the plain versions on any
    device."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3E), got {tuple(qkv.shape)}")
    _check_np(qkv.shape[1])
    if not 1 <= n_real <= qkv.shape[1]:
        raise ValueError(f"n_real={n_real} outside [1, {qkv.shape[1]}]")
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    plain = impl == "plain" or qkv.device.type == "cpu"
    if not plain and qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    return _FusedQkvAttentionProj.apply(qkv, w, b, u, v, cb, heads, scale,
                                        n_real, s, plain)
