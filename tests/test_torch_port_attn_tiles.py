"""The tile decompositions of the Hopper attention kernels, emulated in
torch on the CPU and held against the JAX package.

- ``csrc/tiled_attention_bwd.cuh`` (rows 16 and 17's backward): one block
  per 128-key tile, two warpgroups of 64 keys each, the 64-query tiles
  streamed past them (rows past N zero, with lse = 1e30 and D = 0); per
  query tile s^T, p^T, dp^T, ds^T, dv += p^T do and dk += ds^T q for the
  warpgroup's keys, and the warpgroup's dq partial added into an fp32 sum.
  :func:`tiled_bwd` does the same with the key tiles and their halves
  visited in a shuffled order (any order the sum could be taken in), and,
  with no ``rng``, in the card's fixed order: per key tile the two
  warpgroups' partials summed (warpgroup 0's plus warpgroup 1's), those
  sums added into dq in key-tile order.  Both are held against
  ``jax.vjp`` of the Pallas
  ``blockwise_qkv_attention`` (128 x 128 blocks, interpret mode) and
  against the port's plain twin ``blockwise_attention_bwd_plain``.  The
  Pallas kernel takes a token count that is a multiple of 128, so the
  cases pad to it and mask the keys past ``n_real`` (the cotangent is zero
  on those rows), as ``test_torch_port_blockwise.py`` does.
- ``csrc/qkv_attention_bwd.cu`` (row 2's backward): the statistics pass
  of ``csrc/tiled_attention_fwd.cuh`` (per 64-query tile, 128-key tiles in
  order, the row max, the sum of exp(s - m) and of exp(s - m) dp rescaled
  as the max moves, giving lse and D = rowsum(p dp) in fp32), then the
  same main loop as rows 16 and 17, its key tiles and their halves in a
  shuffled order, or in the card's fixed order.  :func:`stats_rows` and
  :func:`tiled_bwd_from_rows` are held against ``jax.vjp`` of the Pallas
  ``fused_qkv_attention``
  (interpret mode) at NP 256 and 512, n_real 197, 401 and 512, Dh 16, 32
  and 64, and against the port's plain twin ``attention_bwd_plain``.
- ``csrc/tiled_attention_fwd.cuh`` (rows 16 and 17's forward): 64-query
  tiles (a warpgroup's half of a 128-query item) against 64-key tiles in
  order (also 128, the statistics mode's tile), key tiles wholly past
  ``n_real`` skipped, the online softmax
  (running max, rescale, row sums), P rounded for P V, the output divided
  by the row sum at the end and lse = m + log l.  :func:`tiled_fwd` is
  held against the Pallas ``blockwise_qkv_attention`` forward and lse
  (128 x 128 blocks) and the Pallas ``flash_attention`` forward at N 577
  and 640 with keys past ``n_real`` masked.
- ``csrc/qkv_attention.cu`` (row 1) above 256 keys: two 256-key chunks, a
  pass for the full row max, then a pass for exp, the row sum and P V.
  :func:`two_chunk_fwd` is held against the JAX ``fused_qkv_attention``.

At ViT-H/14's head width 80 the kernels reduce over Dh in two parts, the
64-column one and then the 16-column tail (``sm90::HeadTile``); the
mirrors take the scores (and dp) in that order (:func:`dot_dh`), and the
Dh-80 cases of each loop hold it against the Pallas kernels.

fp32 throughout, atol = rtol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cara_tpu_torch.ops.cuda import blockwise_attention as t_bwa
from cara_tpu_torch.ops.cuda import flash_attention as t_flash
from cara_tpu_torch.ops.cuda import fused_qkv_attention as t_fqa
from cara_tpu.ops.pallas import blockwise_attention as j_bwa
from cara_tpu.ops.pallas import flash_attention as j_flash
from cara_tpu.ops.pallas import fused_qkv_attention as j_fqa

TOL = dict(atol=1e-4, rtol=1e-4)
HEADS = 2
KEY_TILE, HALF, QUERY_TILE = 128, 64, 64
FWD_KEY_TILE = 64  # the forward kernel's key tile
PAD_LSE = 1e30
NEG_INF = -1e30


def _arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {k: s * rng.standard_normal(shape).astype(np.float32)
            for k, (shape, s) in shapes.items()}


def _head_major(t, heads):
    b, n, e = t.shape
    return t.reshape(b, n, heads, e // heads).transpose(1, 2)


def _pad_rows(n):
    return -(-n // QUERY_TILE) * QUERY_TILE


def dot_dh(a, b):
    """a @ b^T over the head dimension as the kernels' k-steps sum it:
    one part up to 64 columns; past 64 (Dh 80) the 64-column part, then
    the tail added."""
    if a.shape[-1] <= 64:
        return a @ b.transpose(-1, -2)
    return (a[..., :64] @ b[..., :64].transpose(-1, -2)
            + a[..., 64:] @ b[..., 64:].transpose(-1, -2))


def row_pass(out, lse, do, heads):
    """Rows 16 and 17's row pass: (lse, D = rowsum(do * o)) rows (B, H,
    NP), rows past N with lse = 1e30 and D = 0 (their p is 0)."""
    b, n, _ = out.shape
    np_ = _pad_rows(n)
    g = _head_major(do, heads).float()
    o = _head_major(out, heads).float()
    lse_t = torch.full((b, heads, np_), PAD_LSE)
    lse_t[..., :n] = lse.float().transpose(1, 2)
    d_t = torch.zeros((b, heads, np_))
    d_t[..., :n] = (g * o).sum(-1)
    return lse_t, d_t


def stats_rows(qkv, do, heads, scale, n_real):
    """Row 2's statistics pass: per 64-query tile the 128-key tiles below
    ``n_real`` in order, s = q k^T and dp = do v^T, the running max m of
    the scaled scores, l = sum exp(s - m) and sum exp(s - m) dp rescaled
    as m moves; (lse = m + log l, D = that sum / l) rows as
    :func:`row_pass` gives them."""
    b, n, e3 = qkv.shape
    e = e3 // 3
    q, k, v = (_head_major(qkv[..., i * e:(i + 1) * e], heads).float()
               for i in range(3))
    g = _head_major(do, heads).float()
    np_ = _pad_rows(n)
    lse_t = torch.full((b, heads, np_), PAD_LSE)
    d_t = torch.zeros((b, heads, np_))
    for q0 in range(0, n, QUERY_TILE):
        qs, gs = q[:, :, q0:q0 + QUERY_TILE], g[:, :, q0:q0 + QUERY_TILE]
        m = torch.full(qs.shape[:-1], NEG_INF)
        l = torch.zeros(qs.shape[:-1])
        sd = torch.zeros(qs.shape[:-1])
        for k0 in range(0, n_real, KEY_TILE):
            ks, vs = k[:, :, k0:k0 + KEY_TILE], v[:, :, k0:k0 + KEY_TILE]
            s = dot_dh(qs, ks)
            col = torch.arange(k0, k0 + ks.shape[2])
            s = torch.where(col < n_real, s, torch.full_like(s, NEG_INF))
            dp = dot_dh(gs, vs)
            m_new = torch.maximum(m, s.amax(-1) * scale)
            corr = torch.exp(m - m_new)
            ex = torch.exp(s * scale - m_new[..., None])
            l = l * corr + ex.sum(-1)
            sd = sd * corr + (ex * dp).sum(-1)
            m = m_new
        rows = slice(q0, q0 + qs.shape[2])
        lse_t[..., rows] = m + torch.log(l)
        d_t[..., rows] = sd / l
    return lse_t, d_t


def tiled_bwd(qkv, out, lse, do, heads, scale, n_real, rng):
    """dqkv (B, N, 3E) by rows 16 and 17's decomposition: the row pass,
    then :func:`tiled_bwd_from_rows`."""
    lse_t, d_t = row_pass(out, lse, do, heads)
    return tiled_bwd_from_rows(qkv, do, lse_t, d_t, heads, scale, n_real,
                               rng)


def tiled_bwd_from_rows(qkv, do, lse_t, d_t, heads, scale, n_real, rng):
    """dqkv (B, N, 3E) by the main kernel's decomposition from the (lse,
    D) rows, in the input's dtype at its rounding points (p and ds
    rounded for the products).  ``rng`` shuffles the key tiles and their
    halves, each half's dq partial added into the fp32 sum on its own;
    ``rng=None`` takes the card's order: key tiles in order, each tile's
    two partials summed first (half 0 plus half 1), then added."""
    b, n, e3 = qkv.shape
    e = e3 // 3
    dt = qkv.dtype
    q, k, v = (_head_major(qkv[..., i * e:(i + 1) * e], heads).float()
               for i in range(3))
    g = _head_major(do, heads).float()
    dh = e // heads
    np_ = _pad_rows(n)

    def pad(t):
        return torch.nn.functional.pad(t, (0, 0, 0, np_ - n))

    qp, gp = pad(q), pad(g)
    dq_acc = torch.zeros((b, heads, np_, dh))
    dk = torch.zeros((b, heads, n, dh))
    dv = torch.zeros((b, heads, n, dh))
    tiles = -(-n // KEY_TILE)
    for kt in range(tiles) if rng is None else rng.permutation(tiles):
        k0 = kt * KEY_TILE
        if k0 >= n_real:  # every key masked: dk, dv stay zero
            continue
        # the tile's dq partial (both halves) or each half's on its own
        dq_tile = torch.zeros_like(dq_acc)
        for half in range(2) if rng is None else rng.permutation(2):
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
                s_t = dot_dh(ks, qs)  # keys x queries
                p_t = torch.where(
                    valid, torch.exp(s_t * scale - lse_t[:, :, None, rows]),
                    torch.zeros(()))
                dp_t = dot_dh(vs, gs)
                ds_t = (p_t * (dp_t - d_t[:, :, None, rows])).to(dt).float()
                dv_w += p_t.to(dt).float() @ gs
                dk_w += ds_t @ qs
                dq_tile[:, :, rows] += ds_t.transpose(-1, -2) @ ks
            dk[:, :, a0:a1] = dk_w * scale
            dv[:, :, a0:a1] = dv_w
            if rng is not None:
                dq_acc += dq_tile
                dq_tile.zero_()
        if rng is None:
            dq_acc += dq_tile
    dq = dq_acc[:, :, :n] * scale

    def flat(t):
        return t.to(dt).transpose(1, 2).reshape(b, n, e)

    return torch.cat([flat(dq), flat(dk), flat(dv)], dim=-1)


def tiled_fwd(q, k, v, scale, n_real, key_tile=FWD_KEY_TILE):
    """Rows 16 and 17's forward on (B, H, N, Dh) q, k, v: (out (B, H, N,
    Dh) in the input's dtype, lse (B, N, H) fp32) by 64-query tiles and
    ``key_tile``-key tiles with the online softmax, as the kernel takes
    them."""
    b, h, n, dh = q.shape
    dt = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((b, h, n, dh))
    lse = torch.zeros((b, h, n))
    for q0 in range(0, n, QUERY_TILE):
        qs = qf[:, :, q0:q0 + QUERY_TILE]
        m = torch.full(qs.shape[:-1], NEG_INF)
        l = torch.zeros(qs.shape[:-1])
        acc = torch.zeros(qs.shape)
        for k0 in range(0, n_real, key_tile):  # tiles past n_real skipped
            ks, vs = kf[:, :, k0:k0 + key_tile], vf[:, :, k0:k0 + key_tile]
            s = dot_dh(qs, ks)
            col = torch.arange(k0, k0 + ks.shape[2])
            s = torch.where(col < n_real, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1) * scale)
            corr = torch.exp(m - m_new)
            p = torch.exp(s * scale - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p.to(dt).float() @ vs
            m = m_new
        rows = slice(q0, q0 + qs.shape[2])
        lt = torch.where(l == 0, torch.ones_like(l), l)
        out[:, :, rows] = acc / lt[..., None]
        lse[:, :, rows] = m + torch.log(l.clamp_min(1e-30))
    return out.to(dt), lse.transpose(1, 2)


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
                                                (640, 577, 64, 1),
                                                (640, 577, 80, 1)])
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


@pytest.mark.parametrize("np_, n_real, dh, b", [(256, 197, 64, 2),
                                                (640, 577, 16, 1),
                                                (256, 197, 80, 2)])
def test_tiled_bwd_fixed_order_matches_jax(np_, n_real, dh, b):
    """Rows 16 and 17's backward with dq summed in the card's fixed order
    (key tiles in order, each tile's two warpgroup partials summed first)
    against ``jax.vjp`` of the Pallas kernel and the plain twin."""
    e = HEADS * dh
    sm = dh ** -0.5
    a = _arrays(np_ + dh + 1, qkv=((b, np_, 3 * e), 0.7),
                g=((b, np_, e), 1.0))
    a["g"][:, n_real:] = 0.0

    def j_fn(x):
        return j_bwa.blockwise_qkv_attention(x, HEADS, sm, n_real, 1, 128,
                                             128)

    _, vjp = jax.vjp(j_fn, jnp.asarray(a["qkv"]))
    (ref,) = vjp(jnp.asarray(a["g"]))
    qkv, g = torch.from_numpy(a["qkv"]), torch.from_numpy(a["g"])
    out, lse = t_bwa.blockwise_attention_fwd_plain(qkv, HEADS, sm, n_real)
    got = tiled_bwd(qkv, out, lse, g, HEADS, sm, n_real, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain = t_bwa.blockwise_attention_bwd_plain(qkv, out, lse, g, HEADS, sm,
                                                n_real)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    again = tiled_bwd(qkv, out, lse, g, HEADS, sm, n_real, None)
    assert torch.equal(got, again)


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


# Row 2's backward: (NP, n_real) x head width; n_real 401 and 512 are the
# token counts past the previous kernel's shared-memory cap of 352.
ROW2_CASES = ([(np_, n_real, dh) for dh in (16, 32, 64)
               for np_, n_real in ((256, 197), (512, 401), (512, 512))]
              + [(320, 257, 80), (512, 512, 80)])


@pytest.mark.parametrize("np_, n_real, dh", ROW2_CASES,
                         ids=[f"np{n}_r{r}_dh{d}" for n, r, d in ROW2_CASES])
def test_row2_stats_and_tiles_match_jax(np_, n_real, dh):
    e = HEADS * dh
    sm = dh ** -0.5
    a = _arrays(np_ + n_real + dh, qkv=((2, np_, 3 * e), 0.7),
                g=((2, np_, e), 1.0))

    def j_fn(x):
        return j_fqa.fused_qkv_attention(x, HEADS, sm, n_real)

    _, vjp = jax.vjp(j_fn, jnp.asarray(a["qkv"]))
    (ref,) = vjp(jnp.asarray(a["g"]))
    qkv, g = torch.from_numpy(a["qkv"]), torch.from_numpy(a["g"])
    lse_t, d_t = stats_rows(qkv, g, HEADS, sm, n_real)
    assert (lse_t.shape[-1] - np_) % QUERY_TILE == 0
    got = tiled_bwd_from_rows(qkv, g, lse_t, d_t, HEADS, sm, n_real,
                              np.random.default_rng(n_real + dh))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain = t_fqa.attention_bwd_plain(qkv, g, HEADS, sm, n_real)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    assert not got[:, n_real:, e:].any()  # masked keys: zero dk, dv


@pytest.mark.parametrize("np_, n_real, dh", [(256, 197, 64), (512, 401, 32),
                                             (512, 512, 16), (512, 401, 80)],
                         ids=["np256_r197_dh64", "np512_r401_dh32",
                              "np512_r512_dh16", "np512_r401_dh80"])
def test_row2_fixed_order_matches_jax(np_, n_real, dh):
    """Row 2's statistics pass and main loop with dq summed in the card's
    fixed order, against ``jax.vjp`` of the Pallas kernel and the plain
    twin."""
    e = HEADS * dh
    sm = dh ** -0.5
    a = _arrays(np_ + n_real + dh + 1, qkv=((2, np_, 3 * e), 0.7),
                g=((2, np_, e), 1.0))

    def j_fn(x):
        return j_fqa.fused_qkv_attention(x, HEADS, sm, n_real)

    _, vjp = jax.vjp(j_fn, jnp.asarray(a["qkv"]))
    (ref,) = vjp(jnp.asarray(a["g"]))
    qkv, g = torch.from_numpy(a["qkv"]), torch.from_numpy(a["g"])
    lse_t, d_t = stats_rows(qkv, g, HEADS, sm, n_real)
    got = tiled_bwd_from_rows(qkv, g, lse_t, d_t, HEADS, sm, n_real, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain = t_fqa.attention_bwd_plain(qkv, g, HEADS, sm, n_real)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    assert not got[:, n_real:, e:].any()  # masked keys: zero dk, dv


# (route, N, n_real, head width): the forward's tile loop past 512 tokens,
# the last key tile partly masked (577) or wholly past n_real (640 / 500).
FWD_CASES = [("blockwise", 640, 577, 64), ("blockwise", 577, 500, 64),
             ("blockwise", 640, 577, 16), ("flash", 577, 577, 64),
             ("flash", 640, 640, 64), ("blockwise", 640, 577, 80),
             ("flash", 577, 577, 80)]


@pytest.mark.parametrize("key_tile", [FWD_KEY_TILE, KEY_TILE],
                         ids=["k64", "k128"])
@pytest.mark.parametrize("route, n, n_real, dh", FWD_CASES,
                         ids=[f"{r}_n{n}_r{nr}_dh{d}"
                              for r, n, nr, d in FWD_CASES])
def test_tiled_fwd_decomposition_matches_jax(route, n, n_real, dh,
                                             key_tile):
    e = HEADS * dh
    sm = dh ** -0.5
    np_ = -(-n // KEY_TILE) * KEY_TILE
    qkv = _arrays(n + dh, qkv=((1, np_, 3 * e), 0.8))["qkv"]
    qkv[:, n:] = 0.0  # the Pallas kernels' pad rows
    t = torch.from_numpy(qkv[:, :n])
    q, k, v = (_head_major(t[..., i * e:(i + 1) * e], HEADS)
               for i in range(3))
    out, lse = tiled_fwd(q, k, v, sm, n_real, key_tile)
    # The blockwise Pallas forward's lse is the kernel's definition (and
    # its rows past n_real keep their keys masked as here).
    ref_out, (_, _, ref_lse) = j_bwa._fwd(jnp.asarray(qkv), HEADS, sm,
                                          n_real, 1, 128, 128, None)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(ref_lse)[0:1, :n, :HEADS], **TOL)
    flat = out.transpose(1, 2).reshape(1, n, e)
    if route == "blockwise":
        np.testing.assert_allclose(flat.numpy(), np.asarray(ref_out)[:, :n],
                                   **TOL)
        plain, plain_lse = t_bwa.blockwise_attention_fwd_plain(
            t, HEADS, sm, n_real)
        np.testing.assert_allclose(flat.numpy(), plain.numpy(), **TOL)
        np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), **TOL)
    else:
        jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
        ref = j_flash.flash_attention(jq, jk, jv, sm)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        plain = t_flash.flash_attention_fwd_plain(q, k, v, sm)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), **TOL)
