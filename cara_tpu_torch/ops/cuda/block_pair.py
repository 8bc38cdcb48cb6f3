"""Whole-block eval forward: the attention half and the MLP half of one
transformer block with CaRA deltas, the mid residual kept on chip.

Replaces the TPU kernel ``cara_tpu/ops/pallas/block_pair.py``
(``block_pair_fwd``, ``_pair_kernel``), which holds one image's whole
block in VMEM so that the post-attention residual ``x_mid`` never goes
to device memory.  On Hopper it is three launches:

1. ``csrc/block_rows.cu``'s LayerNorm row pass and ``csrc/cp_site.cu``'s
   product: qkv = LN1(x) Wq + bq + (z1 V1), z1 = LN1(x) U1 rounded to
   bf16 (as row 5's port);
2. ``csrc/block_pair.cu`` (the kernel in ``csrc/block_pair.cuh``, its
   quick_gelu instances in ``csrc/block_pair_quick.cu``): a cluster of
   ceil(E / 256) blocks a (64-query tile, image) on ``wgmma`` and TMA.
   Block c runs the heads h = c (mod k) and stores their output into
   every block's 64 x E tile (distributed shared memory); each block
   owns 256 columns of the projection + delta + residual (x_mid, kept in
   registers), LN2's row statistics are merged across the cluster, and
   each block sends its xa2 columns to every block by bulk copies; then
   the hidden in 64-wide chunks: each block computes one chunk a step
   (fc1 + delta + the activation) and copies it to every block, which
   runs fc2 and the rank sum z2' = h U2' on all of them for its columns.
   Neither x_mid nor the hidden activation leaves the chip.  The
   activation (the exact-erf GELU, or CLIP's quick_gelu for
   ``act="quick_gelu"``) is a template parameter.

The kernel takes head widths 16, 32, 64 and 80 (``blockwise_attention.
HEAD_DIMS``), E = heads x Dh up to 1280 (every model of the registry),
hidden a multiple of 128, N up to 512 and any rank (past rank 64 in
chunks of 64, two kinds of z parked in a device scratch buffer: see
``csrc/block_pair.cuh``).  The reference has
no switch that turns it on in the model (its docstring's
``CARA_BLOCK_PAIR`` is read nowhere), so neither does the port:
``models/vit.py`` keeps the two half-block kernels.  Eval only, as in
JAX: no backward, and the wrapper raises when autograd would record
through it.  The TPU's token padding is not ported: ``x`` is (B, N, E)
unpadded, keys at or past ``n_real`` are masked.  A CUDA tensor
launches the kernels (or raises); a CPU tensor, or ``impl="plain"``,
takes :func:`block_pair_fwd_plain`.
"""

from __future__ import annotations

import torch

from cara_tpu_torch.ops.cuda import _build, _bwd
from cara_tpu_torch.ops.cuda._site import site_cuda
from cara_tpu_torch.ops.cuda.blockwise_attention import check_head_dim
from cara_tpu_torch.ops.cuda.cp_attn_block import cp_attn_block_plain
from cara_tpu_torch.ops.cuda.cp_mlp import cp_mlp_block_plain
from cara_tpu_torch.ops.cuda.fused_qkv_attention import _check_np

#: Number of (two-launch) kernel calls made by :func:`block_pair_fwd`
#: with the GELU, and with quick_gelu.
LAUNCHES = 0
QUICK_LAUNCHES = 0

#: Widest E the kernel takes (ViT-H/14's): a cluster of five blocks, each
#: holding the whole 64 x E tile (160 KB at E 1280) beside five 8 KB
#: chunks of the hidden activation.
MAX_E = 1280
_WIDE_TODO = "ROADMAP.md queue 2: Row 19 past E 1280"


def block_pair_fwd_plain(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ls1, lb1,
                         w1, b1, mu1, mv1, mcb1, w2, b2, mu2, mv2, mcb2,
                         ls2, lb2, heads: int, sm_scale: float, n_real: int,
                         s: float, act: str = "gelu", ln_eps: float = 1e-6):
    """Plain twin with the TPU kernel's rounding points: LN1(x), z1, qkv,
    the attention output and z2 rounded to ``x.dtype``, then ``xm =
    bf16(x + y1)``, LN2(xm), z1', h and z2' rounded, the rest fp32 and
    rounded once: the attention half-block and then the MLP half-block
    with unit drop-path gates."""
    bsz = x.shape[0]
    ones = x.new_ones((bsz, 1))
    xm = cp_attn_block_plain(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ls1,
                             lb1, ones, heads, sm_scale, n_real, s, ln_eps)
    return cp_mlp_block_plain(xm, w1, b1, mu1, mv1, mcb1, w2, b2, mu2, mv2,
                              mcb2, ls2, lb2, ones.reshape(bsz, 1, 1), s,
                              act, ln_eps)


def block_pair_cuda(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ls1, lb1, w1,
                    b1, mu1, mv1, mcb1, w2, b2, mu2, mv2, mcb2, ls2, lb2,
                    heads, sm_scale, n_real, s, ln_eps, act="gelu"):
    """The two launches on CUDA tensors (no launch count)."""
    bsz, n, e = x.shape
    dh = e // heads
    hid = w1.shape[1]
    r = u2.shape[1]
    dev = x.device
    u2p, mu1p, mu2p = (_bwd.pad_rank(t) for t in (u2, mu1, mu2))
    tensors = dict(x=x, wp=wp, bp=bp, u2=u2p, v2=v2, cb2=cb2, ls2=ls2,
                   lb2=lb2, w1=w1, b1=b1, mu1=mu1p, mv1=mv1, mcb1=mcb1,
                   w2=w2, b2=b2, mu2=mu2p, mv2=mv2, mcb2=mcb2)
    _build.check_cuda_inputs("block_pair", dev, **tensors)
    shapes = dict(wp=(e, e), bp=(e,), u2=(e, r), v2=(r, e), cb2=(e,),
                  ls2=(e,), lb2=(e,), w1=(e, hid), b1=(hid,), mu1=(e, r),
                  mv1=(r, hid), mcb1=(hid,), w2=(hid, e), b2=(e,),
                  mu2=(hid, r), mv2=(r, e), mcb2=(e,))
    given = dict(wp=wp, bp=bp, u2=u2, v2=v2, cb2=cb2, ls2=ls2, lb2=lb2,
                 w1=w1, b1=b1, mu1=mu1, mv1=mv1, mcb1=mcb1, w2=w2, b2=b2,
                 mu2=mu2, mv2=mv2, mcb2=mcb2)
    bad = {k: tuple(t.shape) for k, t in given.items()
           if tuple(t.shape) != shapes[k]}
    if act not in _bwd.ACTS:  # cara_block_pair's codes are grad_gemm's
        raise ValueError(f"block_pair: act must be one of "
                         f"{tuple(_bwd.ACTS)}, got {act!r}")
    if bad or heads * dh != e or hid % 128 or r < 1:
        raise ValueError(
            f"block_pair: E={e}, heads={heads}, hidden={hid}, rank {r}, "
            f"mismatched shapes {bad}; the kernel takes hidden a multiple "
            "of 128 and one rank of at least 1 for all three sites")
    if e > MAX_E:
        raise ValueError(f"block_pair: E={e}; the kernel takes E = heads x "
                         f"Dh up to {MAX_E} ({_WIDE_TODO})")
    check_head_dim("block_pair", dh)
    if s == 0:
        raise ValueError("block_pair: the kernel folds the delta scale into "
                         "its accumulators (acc / s + z V) and takes s != 0")
    qkv = site_cuda(x.reshape(bsz * n, e), wq, bq, u1, v1, None, s,
                    ln=(ls1, lb1, ln_eps))
    lib = _build.lib()
    out = torch.empty_like(x)
    scratch = None
    if r > _bwd.RANK_W:  # 48 words a consumer thread, block and chunk
        blocks = bsz * -(-n // 64) * -(-e // 256)
        scratch = torch.empty((blocks * (u2p.shape[1] // 64) * 48 * 256,),
                              device=dev, dtype=torch.float32)
    code = lib.cara_block_pair(
        qkv.data_ptr(), x.data_ptr(), wp.data_ptr(), bp.data_ptr(),
        u2p.data_ptr(), v2.data_ptr(), cb2.data_ptr(), ls2.data_ptr(),
        lb2.data_ptr(), w1.data_ptr(), b1.data_ptr(), mu1p.data_ptr(),
        mv1.data_ptr(), mcb1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        mu2p.data_ptr(), mv2.data_ptr(), mcb2.data_ptr(), out.data_ptr(),
        _build.ptr(scratch), bsz, n, heads, dh, hid, int(n_real), r,
        u2p.shape[1], _bwd.ACTS[act], float(sm_scale), float(s),
        float(ln_eps), _build.stream_ptr(dev))
    _build.check(code, "block_pair")
    return out


def block_pair_fwd(x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ls1, lb1,
                   w1, b1, mu1, mv1, mcb1, w2, b2, mu2, mv2, mcb2,
                   ls2, lb2, heads: int, sm_scale: float, n_real: int,
                   s: float, block_b: int = 2, act: str = "gelu",
                   ln_eps: float = 1e-6, impl: str = "auto"):
    """Eval forward of one full transformer block (JAX's argument list);
    x (B, N, E) unpadded, keys >= ``n_real`` masked.  ``block_b`` (the
    TPU's images per grid step) is accepted and ignored.  No backward:
    eval only.  ``impl="plain"`` runs the plain version on any device."""
    del block_b
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, E), got {tuple(x.shape)}")
    _check_np(x.shape[1])
    if not 1 <= n_real <= x.shape[1]:
        raise ValueError(f"n_real={n_real} outside [1, {x.shape[1]}]")
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    args = (x, wq, bq, u1, v1, wp, bp, u2, v2, cb2, ls1, lb1, w1, b1, mu1,
            mv1, mcb1, w2, b2, mu2, mv2, mcb2, ls2, lb2)
    _build.refuse_autograd("block_pair_fwd", *args)
    if impl == "plain" or x.device.type == "cpu":
        return block_pair_fwd_plain(*args, heads, sm_scale, n_real, s, act,
                                    ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    global LAUNCHES, QUICK_LAUNCHES
    out = block_pair_cuda(*args, heads, sm_scale, n_real, s, ln_eps, act)
    if act == "quick_gelu":
        QUICK_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
