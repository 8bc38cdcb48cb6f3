"""The tile decompositions of the Hopper attention kernels, emulated in
torch on the CPU and held against the JAX package.

- ``csrc/tiled_attention_bwd.cuh`` (rows 16 and 17's backward): one block
  per 128-key tile, two warpgroups of 64 keys each, the 64-query tiles
  streamed past them (rows past N zero, with lse = 1e30 and D = 0); per
  query tile s^T, p^T, dp^T, ds^T, dv += p^T do and dk += ds^T q for the
  warpgroup's keys, and the warpgroup's dq partial added into an fp32 sum.
  :func:`tiled_bwd` does the same with the key tiles and their halves
  visited in a shuffled order (the card adds the partials in no fixed
  order), and is held against ``jax.vjp`` of the Pallas
  ``blockwise_qkv_attention`` (128 x 128 blocks, interpret mode) and
  against the port's plain twin ``blockwise_attention_bwd_plain``.  The
  Pallas kernel takes a token count that is a multiple of 128, so the
  cases pad to it and mask the keys past ``n_real`` (the cotangent is zero
  on those rows), as ``test_torch_port_blockwise.py`` does.
- ``csrc/qkv_attention.cu`` (row 1) above 256 keys: two 256-key chunks, a
  pass for the full row max, then a pass for exp, the row sum and P V.
  :func:`two_chunk_fwd` is held against the JAX ``fused_qkv_attention``.

fp32 throughout, atol = rtol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cara_tpu_torch.ops.cuda import blockwise_attention as t_bwa
from cara_tpu_torch.ops.cuda import fused_qkv_attention as t_fqa
from cara_tpu.ops.pallas import blockwise_attention as j_bwa
from cara_tpu.ops.pallas import fused_qkv_attention as j_fqa

TOL = dict(atol=1e-4, rtol=1e-4)
HEADS = 2
KEY_TILE, HALF, QUERY_TILE = 128, 64, 64
PAD_LSE = 1e30
NEG_INF = -1e30


def _arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {k: s * rng.standard_normal(shape).astype(np.float32)
            for k, (shape, s) in shapes.items()}


def _head_major(t, heads):
    b, n, e = t.shape
    return t.reshape(b, n, heads, e // heads).transpose(1, 2)


def tiled_bwd(qkv, out, lse, do, heads, scale, n_real, rng):
    """dqkv (B, N, 3E) by the main kernel's decomposition, in the input's
    dtype at its rounding points (p and ds rounded for the products)."""
    b, n, e3 = qkv.shape
    e = e3 // 3
    dt = qkv.dtype
    q, k, v = (_head_major(qkv[..., i * e:(i + 1) * e], heads).float()
               for i in range(3))
    g = _head_major(do, heads).float()
    o = _head_major(out, heads).float()
    dh = e // heads
    np_ = -(-n // QUERY_TILE) * QUERY_TILE

    def pad(t):
        return torch.nn.functional.pad(t, (0, 0, 0, np_ - n))

    qp, gp = pad(q), pad(g)
    # The row pass: lse and D = rowsum(do * o), padded rows give p = 0.
    lse_t = torch.full((b, heads, np_), PAD_LSE)
    lse_t[..., :n] = lse.float().transpose(1, 2)
    d_t = torch.zeros((b, heads, np_))
    d_t[..., :n] = (g * o).sum(-1)
    dq_acc = torch.zeros((b, heads, np_, dh))
    dk = torch.zeros((b, heads, n, dh))
    dv = torch.zeros((b, heads, n, dh))
    for kt in rng.permutation(-(-n // KEY_TILE)):
        k0 = kt * KEY_TILE
        if k0 >= n_real:  # every key masked: dk, dv stay zero
            continue
        for half in rng.permutation(2):  # the two warpgroups
            a0 = k0 + half * HALF
            a1 = min(a0 + HALF, n)
            if a0 >= a1:
                continue
            ks, vs = k[:, :, a0:a1], v[:, :, a0:a1]
            valid = (torch.arange(a0, a1) < n_real)[:, None]
            dk_w = torch.zeros((b, heads, a1 - a0, dh))
            dv_w = torch.zeros((b, heads, a1 - a0, dh))
            for q0 in range(0, np_, QUERY_TILE):
                rows = slice(q0, q0 + QUERY_TILE)
                qs, gs = qp[:, :, rows], gp[:, :, rows]
                s_t = ks @ qs.transpose(-1, -2)  # keys x queries
                p_t = torch.where(
                    valid, torch.exp(s_t * scale - lse_t[:, :, None, rows]),
                    torch.zeros(()))
                dp_t = vs @ gs.transpose(-1, -2)
                ds_t = (p_t * (dp_t - d_t[:, :, None, rows])).to(dt).float()
                dv_w += p_t.to(dt).float() @ gs
                dk_w += ds_t @ qs
                dq_acc[:, :, rows] += ds_t.transpose(-1, -2) @ ks
            dk[:, :, a0:a1] = dk_w * scale
            dv[:, :, a0:a1] = dv_w
    dq = dq_acc[:, :, :n] * scale

    def flat(t):
        return t.to(dt).transpose(1, 2).reshape(b, n, e)

    return torch.cat([flat(dq), flat(dk), flat(dv)], dim=-1)


def two_chunk_fwd(qkv, heads, scale, n_real, chunk=256):
    """Row 1 above 256 keys: the row max over every chunk, then per chunk
    exp(s - max), the fp32 row sum and P (rounded) V; 1/l at the end."""
    b, n, e3 = qkv.shape
    e = e3 // 3
    dt = qkv.dtype
    q = _head_major(qkv[..., :e] * scale, heads).float()
    k = _head_major(qkv[..., e:2 * e], heads).float()
    v = _head_major(qkv[..., 2 * e:], heads).float()

    def scores(c0):
        s = q @ k[:, :, c0:c0 + chunk].transpose(-1, -2)
        col = torch.arange(c0, c0 + s.shape[-1])
        return torch.where(col < n_real, s, torch.full_like(s, NEG_INF))

    m = torch.full(q.shape[:-1] + (1,), NEG_INF)
    for c0 in range(0, n, chunk):
        m = torch.maximum(m, scores(c0).amax(-1, keepdim=True))
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for c0 in range(0, n, chunk):
        p = torch.exp(scores(c0) - m)
        l = l + p.sum(-1, keepdim=True)
        acc = acc + p.to(dt).float() @ v[:, :, c0:c0 + chunk]
    return (acc / l).to(dt).transpose(1, 2).reshape(b, n, e)


@pytest.mark.parametrize("np_, n_real, dh, b", [(256, 197, 16, 2),
                                                (256, 197, 64, 2),
                                                (640, 577, 16, 1),
                                                (640, 577, 64, 1)])
def test_tiled_bwd_decomposition_matches_jax(np_, n_real, dh, b):
    e = HEADS * dh
    sm = dh ** -0.5
    a = _arrays(np_ + dh, qkv=((b, np_, 3 * e), 0.7), g=((b, np_, e), 1.0))
    a["g"][:, n_real:] = 0.0

    def j_fn(x):
        return j_bwa.blockwise_qkv_attention(x, HEADS, sm, n_real, 1, 128,
                                             128)

    _, vjp = jax.vjp(j_fn, jnp.asarray(a["qkv"]))
    (ref,) = vjp(jnp.asarray(a["g"]))
    qkv, g = torch.from_numpy(a["qkv"]), torch.from_numpy(a["g"])
    out, lse = t_bwa.blockwise_attention_fwd_plain(qkv, HEADS, sm, n_real)
    got = tiled_bwd(qkv, out, lse, g, HEADS, sm, n_real,
                    np.random.default_rng(dh))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain = t_bwa.blockwise_attention_bwd_plain(qkv, out, lse, g, HEADS, sm,
                                                n_real)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    assert not got[:, n_real:, e:].any()  # masked keys: zero dk, dv


def test_two_chunk_forward_matches_jax():
    np_, n_real, dh = 304, 300, 32
    e = HEADS * dh
    sm = dh ** -0.5
    qkv = _arrays(3, qkv=((2, np_, 3 * e), 0.9))["qkv"]
    ref = np.asarray(j_fqa.fused_qkv_attention(jnp.asarray(qkv), HEADS, sm,
                                               n_real))
    t = torch.from_numpy(qkv)
    got = two_chunk_fwd(t, HEADS, sm, n_real)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    plain = t_fqa.fused_qkv_attention_plain(t, HEADS, sm, n_real)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
