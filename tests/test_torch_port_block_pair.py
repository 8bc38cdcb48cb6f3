"""The port's whole-block eval forward (TPU row 19) against the JAX package.

``block_pair_fwd_plain`` against the Pallas kernel ``block_pair_fwd`` in
interpret mode at ``tests/test_block_pair.py``'s shapes (b 4, np 128,
heads 4, dh 16, rank 3, n_real 100), on the rows < n_real: on the same
padded input and on the port's own unpadded N = 100 input; and against
the port's plain half-block wrappers (``cp_attn_block`` ->
``cp_mlp_block``, unit gates) and JAX's.  fp32 on the CPU, atol = rtol =
1e-4; the inputs are made with numpy from a seed.
"""

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


def _inputs(seed, s):
    """x (B, NP, E) and the 23 weights of ``block_pair_fwd`` in order."""
    rng = np.random.default_rng(seed)
    e = HEADS * DH
    hid = 4 * e

    def nrm(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    x = rng.standard_normal((B, NP, e)).astype(np.float32)
    weights = [nrm(e, 3 * e), nrm(3 * e), nrm(e, R), nrm(R, 3 * e),
               nrm(e, e), nrm(e), nrm(e, R), nrm(R, e), nrm(e),
               1.0 + nrm(e), nrm(e),
               nrm(e, hid), nrm(hid), nrm(e, R), nrm(R, hid), nrm(hid),
               nrm(hid, e), nrm(e), nrm(hid, R), nrm(R, e), nrm(e),
               1.0 + nrm(e), nrm(e)]
    return x, weights, DH ** -0.5, s


def _port(x, weights, sm, s, n_real=NREAL, **kw):
    with torch.no_grad():
        out = t_pair.block_pair_fwd(torch.from_numpy(x),
                                    *map(torch.from_numpy, weights), HEADS,
                                    sm, n_real, s, **kw)
    return out.numpy()


@pytest.fixture(scope="module", params=[1.0, 1.3], ids=["s1", "s1.3"])
def case(request):
    x, weights, sm, s = _inputs(0, request.param)
    want = np.asarray(j_pair(jnp.asarray(x), *map(jnp.asarray, weights),
                             HEADS, sm, NREAL, s, 2, "gelu", 1e-6, True))
    return x, weights, sm, s, want


def test_block_pair_plain_matches_pallas(case):
    x, weights, sm, s, want = case
    got = _port(x, weights, sm, s, block_b=2)
    assert got.shape == x.shape
    np.testing.assert_allclose(got[:, :NREAL], want[:, :NREAL], **TOL)


def test_block_pair_unpadded_matches_pallas(case):
    """The port never pads the token axis: N = n_real = 100 gives JAX's
    rows < n_real of its 128-padded input."""
    x, weights, sm, s, want = case
    got = _port(np.ascontiguousarray(x[:, :NREAL]), weights, sm, s)
    assert got.shape == (B, NREAL, x.shape[-1])
    np.testing.assert_allclose(got, want[:, :NREAL], **TOL)


def test_block_pair_matches_split_halves(case):
    """Row 19 is the attention half-block and then the MLP half-block
    with unit gates: the port's wrappers (rows 5 and 9, their plain
    versions on the CPU) and JAX's, as ``tests/test_block_pair.py``."""
    x, weights, sm, s, _ = case
    t = [torch.from_numpy(w) for w in weights]
    m = B * NP
    with torch.no_grad():
        xm = t_attn.cp_attn_block(torch.from_numpy(x), *t[:11],
                                  torch.ones(B, 1), HEADS, sm, NREAL, s)
        port = t_mlp.cp_mlp_block(xm, *t[11:], torch.ones(B, 1, 1), s)
    j = [jnp.asarray(w) for w in weights]
    jxm = j_attn(jnp.asarray(x), *j[:11], jnp.ones((B, 1)), HEADS, sm,
                 NREAL, s, 2, True)
    jax_split = j_mlp(jxm.reshape(m, -1), *j[11:], jnp.ones((m, 1)), s, 256,
                      True, "gelu", 1e-6).reshape(x.shape)
    got = _port(x, weights, sm, s)
    np.testing.assert_allclose(got[:, :NREAL], port.numpy()[:, :NREAL],
                               **TOL)
    np.testing.assert_allclose(got[:, :NREAL],
                               np.asarray(jax_split)[:, :NREAL], **TOL)


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
