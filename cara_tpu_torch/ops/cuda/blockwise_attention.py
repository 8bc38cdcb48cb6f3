"""Key-tiled (online-softmax) attention on the (B, N, 3E) qkv GEMM output,
forward and backward: the attention of token counts past 512.

Kernels: ``csrc/blockwise_attention.cu`` (forward, writes the output and
the per-row log-sum-exp) and ``csrc/blockwise_attention_bwd.cu`` (the
row pass D = rowsum(do * o), one ``wgmma`` kernel of five products per
128-key tile whose dq partials are added into an fp32 scratch, and the
pass that rounds dq).  They replace the TPU kernels of
``cara_tpu/ops/pallas/blockwise_attention.py``, TPU row 16:
``_fwd_kernel`` (``pallas_call`` in ``_fwd``) and ``_dq_kernel`` /
``_dkv_kernel`` (``_bwd_rule``).  ``fused_qkv_attention`` (row 1) holds a
head's whole key axis in one block and is capped at N = 512; ViT-B/16 at
384 px has 577 tokens, so ``models/vit.py`` takes this attention above
512, as ``cara_tpu/models/vit.py`` does once the padded token count
passes ``MAX_NP_FULL_SCORES``.  What bounds it on the H100 and what the
design does about it is in the sources' head comments: the forward
persistent blocks, two an SM, over (image, head, 128-query tile) items,
the key axis streamed in 64-key tiles by TMA through an ``mbarrier`` ring
past two ``wgmma`` warpgroups with the score tiles kept in registers
(``csrc/tiled_attention_fwd.cuh``); the backward one block per (image,
head, 128-key tile), the query tiles streamed by TMA past two ``wgmma``
warpgroups (``csrc/tiled_attention_bwd.cuh``).  dq's fp32 sum over the
key tiles is taken in key-tile order, so it is bitwise deterministic from
call to call.  The kernels take the head widths of :data:`HEAD_DIMS`.

Same interface as ``fused_qkv_attention``: qkv (B, N, 3E) with out-flat
(3, H, Dh) columns -> (B, N, E), keys at or past ``n_real`` masked.  The
port does not pad the token axis, so N = 577 arrives as it is.  The
wrapper is a ``torch.autograd.Function`` that keeps qkv, the output and
the log-sum-exp, as the JAX rule's residual does.

A CUDA tensor launches the kernels (or raises); a CPU tensor, or
``impl="plain"``, takes the plain versions, which keep the TPU kernels'
rounding points.
"""

from __future__ import annotations

import torch

from cara_tpu_torch.ops.cuda import _build

NEG_INF = -1e30
#: Key block of the plain forward: the TPU kernel's at 577 tokens (the
#: padded 640 is cut into 128-wide blocks).
BLOCK_K = 128

#: Head widths the attention kernels take (rows 1, 2, 16 and 17): the
#: registry's, ViT-H/14's 80 as 64 + 16 columns (``sm90::HeadTile``).
HEAD_DIMS = (16, 32, 64, 80)
#: The ROADMAP item of every other width.
HEAD_DIMS_TODO = ("ROADMAP.md queue 2: Attention at head widths other "
                  "than 16, 32, 64 and 80")

#: Forward kernel launches of :func:`blockwise_qkv_attention` (row 16).
LAUNCHES = 0
#: Backward calls (the row pass, the main kernel and the dq pass; row 16).
BWD_LAUNCHES = 0


def _head_major(t, b, n, heads, dh):
    return t.reshape(b, n, heads, dh).transpose(1, 2).float()


def blockwise_attention_fwd_plain(qkv, heads: int, scale: float,
                                  n_real: int):
    """Plain twin of the forward: (out (B, N, E) in ``qkv.dtype``, lse
    (B, N, H) fp32).

    ``_fwd_kernel``'s math and rounding points, key block by key block:
    fp32 scores from the q and k values times ``scale`` (q is not
    pre-scaled in the input dtype), keys >= ``n_real`` at -1e30, a running
    fp32 max and sum, P rounded to the input dtype for P V, 1/l applied
    at the end."""
    b, n, e3 = qkv.shape
    e = e3 // 3
    dh = e // heads
    dt = qkv.dtype
    q = _head_major(qkv[..., :e], b, n, heads, dh)
    k = _head_major(qkv[..., e:2 * e], b, n, heads, dh)
    v = _head_major(qkv[..., 2 * e:], b, n, heads, dh)
    m = torch.full((b, heads, n, 1), NEG_INF, device=qkv.device)
    l = torch.zeros((b, heads, n, 1), device=qkv.device)
    acc = torch.zeros((b, heads, n, dh), device=qkv.device)
    for k0 in range(0, n, BLOCK_K):
        kb, vb = k[:, :, k0:k0 + BLOCK_K], v[:, :, k0:k0 + BLOCK_K]
        s = (q @ kb.transpose(-1, -2)) * scale
        col = torch.arange(k0, k0 + kb.shape[2], device=qkv.device)
        s = torch.where(col < n_real, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * corr + p.to(dt).float() @ vb
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = m + torch.log(l.clamp_min(1e-30))
    return (out.to(dt).transpose(1, 2).reshape(b, n, e),
            lse[..., 0].transpose(1, 2).contiguous())


def blockwise_attention_bwd_plain(qkv, out, lse, do, heads: int,
                                  scale: float, n_real: int):
    """Plain twin of the backward: dqkv (B, N, 3E) in ``qkv.dtype`` from
    qkv, the forward's output and lse, and the cotangent do (B, N, E).

    ``_bwd_rule``'s math: D = rowsum(do * o) in fp32 from the saved
    output; p = exp(s - lse); ds = p (dp - D) rounded to the input dtype;
    dq and dk carry the scale; dv = bf16(p)^T do."""
    b, n, e3 = qkv.shape
    e = e3 // 3
    dh = e // heads
    dt = qkv.dtype
    q = _head_major(qkv[..., :e], b, n, heads, dh)
    k = _head_major(qkv[..., e:2 * e], b, n, heads, dh)
    v = _head_major(qkv[..., 2 * e:], b, n, heads, dh)
    g = _head_major(do, b, n, heads, dh)
    dd = (do.float() * out.float()).reshape(b, n, heads, dh).sum(-1)
    dd = dd.transpose(1, 2)[..., None]
    s = (q @ k.transpose(-1, -2)) * scale
    if n_real < n:
        valid = torch.arange(n, device=qkv.device) < n_real
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = g @ v.transpose(-1, -2)
    ds = (p * (dp - dd)).to(dt).float()
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    dv = p.to(dt).float().transpose(-1, -2) @ g

    def flat(t):
        return t.to(dt).transpose(1, 2).reshape(b, n, e)

    return torch.cat([flat(dq), flat(dk), flat(dv)], dim=-1)


def check_head_dim(name: str, dh: int) -> None:
    """Raise, naming the ROADMAP item, on a head width the attention
    kernels do not take."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh}; the kernels take "
                         f"{', '.join(map(str, HEAD_DIMS))} "
                         f"({HEAD_DIMS_TODO})")


def _check_dh(name, e3, heads):
    e = e3 // 3
    dh = e // heads
    if e3 != 3 * e or heads * dh != e:
        raise ValueError(f"{name}: 3E={e3} is not 3 x {heads} heads")
    check_head_dim(name, dh)
    return e, dh


def attention_fwd_cuda(qkv, heads: int, scale: float, n_real: int):
    """Launch ``csrc/blockwise_attention.cu``: (out bf16, lse fp32)."""
    bsz, n, e3 = qkv.shape
    dev = qkv.device
    _build.check_cuda_inputs("blockwise_attention", dev, qkv=qkv)
    e, dh = _check_dh("blockwise_attention", e3, heads)
    out = torch.empty((bsz, n, e), device=dev, dtype=torch.bfloat16)
    lse = torch.empty((bsz, n, heads), device=dev, dtype=torch.float32)
    code = _build.lib().cara_blockwise_attention(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), bsz, n, heads, dh,
        int(n_real), float(scale), _build.stream_ptr(dev))
    _build.check(code, "blockwise_attention")
    return out, lse


def bwd_scratch(b: int, n: int, heads: int, dh: int, device):
    """The backward kernels' fp32 scratch (``csrc/tiled_attention_bwd.cuh``,
    rows 2, 16 and 17): the (B, H, 2, NP) rows of lse and D, and the
    zeroed (B, H, NP, Dh) dq sum (126 MB at B = 64, N = 577, H = 12, Dh =
    64); NP = N rounded up to 64."""
    np_ = -(-n // 64) * 64
    rows = torch.empty((b, heads, 2, np_), device=device, dtype=torch.float32)
    dq_acc = torch.zeros((b, heads, np_, dh), device=device,
                         dtype=torch.float32)
    return rows, dq_acc


def attention_bwd_cuda(qkv, out, lse, do, heads: int, scale: float,
                       n_real: int):
    """Launch ``csrc/blockwise_attention_bwd.cu``: dqkv bf16."""
    bsz, n, e3 = qkv.shape
    dev = qkv.device
    _build.check_cuda_inputs("blockwise_attention_bwd", dev, qkv=qkv,
                             out=out, do=do)
    e, dh = _check_dh("blockwise_attention_bwd", e3, heads)
    if (out.shape != (bsz, n, e) or do.shape != (bsz, n, e)
            or lse.shape != (bsz, n, heads) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != dev):
        raise ValueError(f"blockwise_attention_bwd: qkv {tuple(qkv.shape)} "
                         f"wants out and do (B, N, E) and fp32 lse "
                         f"(B, N, H), got {tuple(out.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    rows, dq_acc = bwd_scratch(bsz, n, heads, dh, dev)
    dqkv = torch.empty_like(qkv)
    code = _build.lib().cara_blockwise_attention_bwd(
        qkv.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
        rows.data_ptr(), dq_acc.data_ptr(), dqkv.data_ptr(), bsz, n, heads,
        dh, int(n_real), float(scale), _build.stream_ptr(dev))
    _build.check(code, "blockwise_attention_bwd")
    return dqkv


class _BlockwiseAttention(torch.autograd.Function):
    """dqkv from the kept qkv, output and log-sum-exp."""

    @staticmethod
    def forward(ctx, qkv, heads, scale, n_real, plain):
        global LAUNCHES
        if plain:
            out, lse = blockwise_attention_fwd_plain(qkv, heads, scale,
                                                     n_real)
        else:
            out, lse = attention_fwd_cuda(qkv, heads, scale, n_real)
            LAUNCHES += 1
        ctx.save_for_backward(qkv, out, lse)
        ctx.cfg = (heads, scale, n_real, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        global BWD_LAUNCHES
        qkv, out, lse = ctx.saved_tensors
        heads, scale, n_real, plain = ctx.cfg
        if plain:
            dqkv = blockwise_attention_bwd_plain(qkv, out, lse, g, heads,
                                                 scale, n_real)
        else:
            dqkv = attention_bwd_cuda(qkv, out, lse, g.contiguous(), heads,
                                      scale, n_real)
            BWD_LAUNCHES += 1
        return dqkv, None, None, None, None


def blockwise_qkv_attention(qkv: torch.Tensor, heads: int, scale: float,
                            n_real: int, impl: str = "auto") -> torch.Tensor:
    """qkv (B, N, 3E), out-flat (3, H, Dh) columns -> attention output
    (B, N, E) for any N; keys at positions >= ``n_real`` are masked.
    Differentiable in qkv; ``impl="plain"`` runs the plain versions on
    any device."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3E), got {tuple(qkv.shape)}")
    if not 1 <= n_real <= qkv.shape[1]:
        raise ValueError(f"n_real={n_real} outside [1, {qkv.shape[1]}]")
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    plain = impl == "plain" or qkv.device.type == "cpu"
    if not plain and qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    return _BlockwiseAttention.apply(qkv, heads, scale, n_real, plain)
