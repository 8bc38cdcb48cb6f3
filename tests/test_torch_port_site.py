"""The port's forward CaRA site (``ops/cuda/_site.py``) against the Pallas
kernels it replaces, on the CPU.

On the card a site is the LayerNorm row pass (``csrc/block_rows.cu``,
LN sites) and one ``csrc/cp_site.cu`` product; their plain twins are
``layers.layer_norm`` and ``_site.site_forward_plain``.  Here: the
LayerNorm's plain twin against JAX's ``_ln_rows`` on bf16 rows (the
rounding point the row pass writes), within one bf16 ulp (1e-6 near
zero); the plain site with delta scale 1 and 10 and rank 0 (the element
route's W' form), 8, and 96 and 128 (past rank 64, where JAX pads the
rank to 128 and the port's kernels take it in k-tiles of 64), against
``_cp_dense_kernel`` (no activation, GELU, with and without the LN
prologue), ``_cp_dense_dact_kernel`` and
``_mlp_fwd_kernel`` (fc1, GELU, fc2 and the gated residual) in interpret
mode, fp32, atol = rtol = 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cara_tpu_torch.ops.cuda import _site, wd_fold
from cara_tpu_torch.ops.layers import layer_norm
from cara_tpu.ops.pallas import cp_dense as j_dense
from cara_tpu.ops.pallas import cp_mlp as j_mlp

TOL = dict(atol=1e-4, rtol=1e-4)
E, HIDDEN, ROWS, EPS = 64, 256, 74, 1e-6


def _arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {name: (spec[2] if len(spec) > 2 else 0.0)
            + spec[1] * rng.standard_normal(spec[0]).astype(np.float32)
            for name, spec in shapes.items()}


def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (fp32 array)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2 ** -126))))
    return np.exp2(e - 7).astype(np.float32)


@pytest.mark.parametrize("rows, mean", [(197, 0.0), (64, 3.0)])
def test_layer_norm_plain_matches_jax_ln_rows_in_bf16(rows, mean):
    """bf16 rows of 768: the port's LayerNorm (the row pass's plain twin)
    and JAX's ``_ln_rows`` (the Pallas kernels' prologue) agree within one
    bf16 ulp, rows with a large mean included; near zero, where the
    normalized value cancels against the bias, within 1e-6 (the two fp32
    means differ in their last bits)."""
    a = _arrays(rows, x=((rows, 768), 1.5, mean), ls=((768,), 0.2, 1.0),
                lb=((768,), 0.2))
    want = j_dense._ln_rows(*(jnp.asarray(a[k], jnp.bfloat16)
                              for k in ("x", "ls", "lb")), EPS)
    got = layer_norm(*(torch.from_numpy(a[k]).bfloat16()
                       for k in ("x", "ls", "lb")), EPS)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want32 = np.asarray(want.astype(jnp.float32))
    got32 = got.float().numpy()
    bound = np.maximum(
        _bf16_ulp(np.maximum(np.abs(want32), np.abs(got32))), 1e-6)
    assert (np.abs(got32 - want32) <= bound).all()


def _site_arrays(seed, k, n, r):
    return _arrays(seed, x=((ROWS, k), 1.2), w=((k, n), k ** -0.5),
                   b=((n,), 0.05), u=((k, max(r, 1)), 0.2),
                   v=((max(r, 1), n), 0.2), cb=((n,), 0.1),
                   ls=((k,), 0.1, 1.0), lb=((k,), 0.1), g=((ROWS, n), 1.0))


def _uv(a, r, k, n):
    """(U, V) for both packages: rank 0 is (K, 0) / (0, N) in the port
    (``wd_fold.zero_rank``) and JAX's one-column zeros (``_zero_uv``)."""
    if r:
        return ((torch.from_numpy(a["u"]), torch.from_numpy(a["v"])),
                (jnp.asarray(a["u"]), jnp.asarray(a["v"])))
    x = torch.from_numpy(a["x"])
    return wd_fold.zero_rank(x, k, n), j_dense._zero_uv(k, n, jnp.float32)


@pytest.mark.parametrize("s", [1.0, 10.0])
@pytest.mark.parametrize("r", [0, 8, 96, 128])
@pytest.mark.parametrize("form", ["dense", "ln", "ln_gelu", "dact"])
def test_plain_site_matches_cp_dense_kernels(form, r, s):
    """``site_forward_plain`` against ``_cp_dense_kernel`` (``cp_dense``,
    ``cp_dense_ln``, with ``act="gelu"``) and ``_cp_dense_dact_kernel``
    on the same fp32 inputs: 74 rows (off every tile), K 64, N 192."""
    k, n = E, 3 * E
    a = _site_arrays(r + int(s), k, n, r)
    (tu, tv), (ju, jv) = _uv(a, r, k, n)
    t = {key: torch.from_numpy(val) for key, val in a.items()}
    j = {key: jnp.asarray(val) for key, val in a.items()}
    ln = form != "dense"
    kw = {}
    if ln:
        kw["ln"] = (t["ls"], t["lb"], EPS)
    act = "gelu" if form in ("ln_gelu", "dact") else None
    if act:
        kw["act"] = act
    if form == "dact":
        kw["dact_g"] = t["g"]
    got = _site.site_forward_plain(t["x"], t["w"], t["b"], tu, tv, t["cb"],
                                   s, **kw)
    if form == "dact":
        want = j_dense._cp_dense_raw(
            j["x"], j["w"], j["b"], ju, jv, j["cb"], s, 256, n, k, True,
            act=act, g=j["g"], ln=(j["ls"], j["lb"], EPS))
    elif ln:
        want = j_dense.cp_dense_ln(j["x"], j["w"], j["b"], ju, jv, j["cb"],
                                   j["ls"], j["lb"], s, interpret=True,
                                   act=act, ln_eps=EPS)
    else:
        want = j_dense.cp_dense(j["x"], j["w"], j["b"], ju, jv, j["cb"], s,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [1.0, 10.0])
@pytest.mark.parametrize("r", [0, 8, 96, 128])
def test_plain_sites_match_mlp_fwd_kernel(r, s):
    """The MLP block as two plain sites (fc1 with LN2 and the GELU, fc2
    with the gated residual) against ``_mlp_fwd_kernel``
    (``cp_mlp_block``), fp32, one gate of 0 among them."""
    # Past rank 8 each factor's std shrinks by (8 / r) ** (1 / 4), so that
    # the delta keeps rank 8's size (its variance grows with r).
    f = min(1.0, 8 / max(r, 1)) ** 0.25
    a = _arrays(30 + r, x=((2, 37, E), 1.2), w1=((E, HIDDEN), 0.125),
                b1=((HIDDEN,), 0.05), u1=((E, max(r, 1)), 0.2 * f),
                v1=((max(r, 1), HIDDEN), 0.2 * f), cb1=((HIDDEN,), 0.1),
                w2=((HIDDEN, E), 0.06), b2=((E,), 0.05),
                u2=((HIDDEN, max(r, 1)), 0.1 * f),
                v2=((max(r, 1), E), 0.2 * f),
                cb2=((E,), 0.1), ls=((E,), 0.1, 1.0), lb=((E,), 0.1))
    dpm = np.array([0.0, 1.0 / 0.9], np.float32).reshape(2, 1, 1)
    if not r:
        for key in ("u1", "v1", "u2", "v2"):
            a[key] = np.zeros_like(a[key])
    t = {key: torch.from_numpy(val) for key, val in a.items()}
    if not r:
        t["u1"], t["v1"] = wd_fold.zero_rank(t["x"], E, HIDDEN)
        t["u2"], t["v2"] = wd_fold.zero_rank(t["x"], HIDDEN, E)
    x2 = t["x"].reshape(-1, E)
    rows = torch.from_numpy(np.repeat(dpm.reshape(2), 37))
    h = _site.site_forward_plain(x2, t["w1"], t["b1"], t["u1"], t["v1"],
                                 t["cb1"], s, ln=(t["ls"], t["lb"], EPS),
                                 act="gelu")
    got = _site.site_forward_plain(h, t["w2"], t["b2"], t["u2"], t["v2"],
                                   t["cb2"], s, res=x2, dpm_rows=rows)
    j = {key: jnp.asarray(val) for key, val in a.items()}
    want = j_mlp.cp_mlp_block(
        j["x"], j["w1"], j["b1"], j["u1"], j["v1"], j["cb1"], j["w2"],
        j["b2"], j["u2"], j["v2"], j["cb2"], j["ls"], j["lb"],
        jnp.asarray(dpm), s, interpret=True, ln_eps=EPS)
    np.testing.assert_allclose(got.reshape(2, 37, E).numpy(),
                               np.asarray(want), **TOL)
