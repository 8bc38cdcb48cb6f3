"""The port's whole-block eval forward (TPU row 19) against the JAX package.

``block_pair_fwd_plain`` against the Pallas kernel ``block_pair_fwd`` in
interpret mode on the rows < n_real: on the same padded input and on the
port's own unpadded N = n_real input; and against the port's plain
half-block wrappers (``cp_attn_block`` -> ``cp_mlp_block``, unit gates)
and JAX's.  At ``tests/test_block_pair.py``'s shapes (b 4, np 128, heads
4, dh 16, rank 3, n_real 100) and at head width 80 (two heads, E 160,
hidden 640, b 2), the latter with the GELU and with quick_gelu
(LayerNorm eps 1e-5, as CLIP), each at delta scales 1 and 1.3.  fp32 on
the CPU, atol = rtol = 1e-4; the inputs are made with numpy from a seed.
"""

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cara_tpu_torch.ops.cuda import block_pair as t_pair
from cara_tpu_torch.ops.cuda import cp_attn_block as t_attn
from cara_tpu_torch.ops.cuda import cp_mlp as t_mlp
from cara_tpu.ops.pallas.block_pair import block_pair_fwd as j_pair
from cara_tpu.ops.pallas.cp_attn_block import cp_attn_block as j_attn
from cara_tpu.ops.pallas.cp_mlp import cp_mlp_block as j_mlp

TOL = dict(atol=1e-4, rtol=1e-4)
B, NP, HEADS, DH, R, NREAL = 4, 128, 4, 16, 3, 100
# name -> (b, np, heads, dh, rank, n_real, activation, LayerNorm eps)
CONFIGS = {"dh16": (B, NP, HEADS, DH, R, NREAL, "gelu", 1e-6),
           "dh80": (2, 128, 2, 80, 3, 100, "gelu", 1e-6),
           "dh80_quick": (2, 128, 2, 80, 3, 100, "quick_gelu", 1e-5)}


def _inputs(seed, s, config="dh16"):
    """x (b, np, E) and the 23 weights of ``block_pair_fwd`` in order."""
    b, np_, heads, dh, r = CONFIGS[config][:5]
    rng = np.random.default_rng(seed)
    e = heads * dh
    hid = 4 * e

    def nrm(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    x = rng.standard_normal((b, np_, e)).astype(np.float32)
    weights = [nrm(e, 3 * e), nrm(3 * e), nrm(e, r), nrm(r, 3 * e),
               nrm(e, e), nrm(e), nrm(e, r), nrm(r, e), nrm(e),
               1.0 + nrm(e), nrm(e),
               nrm(e, hid), nrm(hid), nrm(e, r), nrm(r, hid), nrm(hid),
               nrm(hid, e), nrm(e), nrm(hid, r), nrm(r, e), nrm(e),
               1.0 + nrm(e), nrm(e)]
    return x, weights, dh ** -0.5, s


def _port(x, weights, sm, s, n_real=NREAL, heads=HEADS, **kw):
    with torch.no_grad():
        out = t_pair.block_pair_fwd(torch.from_numpy(x),
                                    *map(torch.from_numpy, weights), heads,
                                    sm, n_real, s, **kw)
    return out.numpy()


class Case(NamedTuple):
    x: np.ndarray
    weights: list
    sm: float
    s: float
    want: np.ndarray
    heads: int
    n_real: int
    act: str
    eps: float


@pytest.fixture(scope="module",
                params=[("dh16", 1.0), ("dh16", 1.3), ("dh80", 1.0),
                        ("dh80", 1.3), ("dh80_quick", 1.0),
                        ("dh80_quick", 1.3)],
                ids=["s1", "s1.3", "dh80-s1", "dh80-s1.3", "dh80-quick-s1",
                     "dh80-quick-s1.3"])
def case(request):
    config, s = request.param
    _, _, heads, _, _, n_real, act, eps = CONFIGS[config]
    x, weights, sm, s = _inputs(0, s, config)
    want = np.asarray(j_pair(jnp.asarray(x), *map(jnp.asarray, weights),
                             heads, sm, n_real, s, 2, act, eps, True))
    return Case(x, weights, sm, s, want, heads, n_real, act, eps)


def _port_case(c, x=None, **kw):
    return _port(c.x if x is None else x, c.weights, c.sm, c.s, c.n_real,
                 c.heads, act=c.act, ln_eps=c.eps, **kw)


def test_block_pair_plain_matches_pallas(case):
    got = _port_case(case, block_b=2)
    n = case.n_real
    assert got.shape == case.x.shape
    np.testing.assert_allclose(got[:, :n], case.want[:, :n], **TOL)


def test_block_pair_unpadded_matches_pallas(case):
    """The port never pads the token axis: N = n_real gives JAX's rows <
    n_real of its 128-padded input."""
    n = case.n_real
    got = _port_case(case, np.ascontiguousarray(case.x[:, :n]))
    assert got.shape == (case.x.shape[0], n, case.x.shape[-1])
    np.testing.assert_allclose(got, case.want[:, :n], **TOL)


def test_block_pair_matches_split_halves(case):
    """Row 19 is the attention half-block and then the MLP half-block
    with unit gates: the port's wrappers (rows 5 and 9, their plain
    versions on the CPU) and JAX's, as ``tests/test_block_pair.py``."""
    c = case
    b, n = c.x.shape[0], c.n_real
    t = [torch.from_numpy(w) for w in c.weights]
    m = b * c.x.shape[1]
    with torch.no_grad():
        xm = t_attn.cp_attn_block(torch.from_numpy(c.x), *t[:11],
                                  torch.ones(b, 1), c.heads, c.sm, n, c.s,
                                  ln_eps=c.eps)
        port = t_mlp.cp_mlp_block(xm, *t[11:], torch.ones(b, 1, 1), c.s,
                                  act=c.act, ln_eps=c.eps)
    j = [jnp.asarray(w) for w in c.weights]
    jxm = j_attn(jnp.asarray(c.x), *j[:11], jnp.ones((b, 1)), c.heads, c.sm,
                 n, c.s, 2, True, ln_eps=c.eps)
    jax_split = j_mlp(jxm.reshape(m, -1), *j[11:], jnp.ones((m, 1)), c.s,
                      256, True, c.act, c.eps).reshape(c.x.shape)
    got = _port_case(c)
    np.testing.assert_allclose(got[:, :n], port.numpy()[:, :n], **TOL)
    np.testing.assert_allclose(got[:, :n],
                               np.asarray(jax_split)[:, :n], **TOL)


def test_block_pair_refuses_autograd_and_bad_shapes():
    x, weights, sm, s = _inputs(1, 1.0)
    t = [torch.from_numpy(w) for w in weights]
    xt = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        t_pair.block_pair_fwd(xt, *t, HEADS, sm, NREAL, s)
    t[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        t_pair.block_pair_fwd(xt.detach(), *t, HEADS, sm, NREAL, s)
    t[0].requires_grad_(False)
    with pytest.raises(ValueError, match="n_real"):
        t_pair.block_pair_fwd(xt.detach(), *t, HEADS, sm, NP + 1, s)
    with pytest.raises(ValueError, match="blockwise"):
        t_pair.block_pair_fwd(torch.zeros(1, 513, x.shape[-1]), *t, HEADS,
                              sm, 513, s)
    with pytest.raises(ValueError, match="impl"):
        t_pair.block_pair_fwd(xt.detach(), *t, HEADS, sm, NREAL, s,
                              impl="fast")
