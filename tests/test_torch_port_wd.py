"""The port's element-wise weight dropout against the JAX package's.

``hash_keep`` must agree bit for bit (the mask is regenerated by the fold
and by the backward finish, and a differing bit would go unnoticed in the
numbers).  The fold and the masked finish run their plain versions here
(CPU tensors) against the Pallas kernels in interpret mode, fp32, with
atol = rtol = 1e-4.  Inputs are numpy arrays from a seed.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cara_tpu_torch.ops.cuda import wd_fold
from cara_tpu.ops.pallas import cp_dense as j_dense

TOL = dict(atol=1e-4, rtol=1e-4)
SEEDS = [0, 1, -1, 7, -2 ** 31, 2 ** 31 - 1, 123456789, -987654321]


def _seed_t(seed):
    return torch.tensor([[seed]], dtype=torch.int32)


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("offset", [(0, 0, 40, 136), (768, 1536, 33, 70),
                                    (3071, 0, 2, 768)])
def test_hash_keep_bit_exact(rate, offset):
    k0, n0, bk, bn = offset
    for seed in SEEDS:
        ref = np.asarray(j_dense.hash_keep(k0, n0, bk, bn, jnp.int32(seed),
                                           rate))
        out = wd_fold.hash_keep_plain(k0, n0, bk, bn, _seed_t(seed),
                                      rate).numpy()
        assert out.shape == ref.shape
        assert np.array_equal(out, ref), (seed, rate, offset)
        # an int seed gives the same mask as the tensor
        assert np.array_equal(
            wd_fold.hash_keep_plain(k0, n0, bk, bn, seed, rate).numpy(), ref)


def test_keep_rate_and_threshold():
    assert wd_fold.keep_threshold(0.1) == int(0.1 * 2 ** 32)
    assert wd_fold.keep_threshold(1.0 - 1e-12) <= 2 ** 32 - 1
    keep = wd_fold.hash_keep_plain(0, 0, 512, 512, 5, 0.3)
    assert abs(keep.float().mean().item() - 0.7) < 0.01


def _fold_inputs(k, n, r, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)).astype(np.float32) * 0.05,
            rng.standard_normal((k, r)).astype(np.float32) * 0.2,
            rng.standard_normal((r, n)).astype(np.float32) * 0.2)


@pytest.mark.parametrize("k, n, r, s, rate, seed",
                         [(64, 192, 4, 1.0, 0.1, 3),
                          (128, 64, 8, 2.5, 0.3, -77)])
def test_build_wd_weight_plain_matches_jax(k, n, r, s, rate, seed):
    w, u, v = _fold_inputs(k, n, r, 11)
    ref = np.asarray(j_dense._build_wd_weight(
        jnp.asarray(w), jnp.asarray(u), jnp.asarray(v), jnp.int32(seed), s,
        rate, None))
    out = wd_fold.build_wd_weight(torch.from_numpy(w), torch.from_numpy(u),
                                  torch.from_numpy(v), _seed_t(seed), s,
                                  rate)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # the dropped elements are W itself, the kept ones moved
    keep = wd_fold.hash_keep_plain(0, 0, k, n, seed, rate).numpy()
    assert np.array_equal(out.numpy()[~keep], w[~keep])


def test_build_wd_weights_grouped_matches_jax():
    """Two sites of different shapes, seeds and ranks folded by one
    grouped call, each against JAX's ``_build_wd_weight``; the counter
    does not move on the CPU."""
    specs = [((64, 192, 4), 5), ((136, 72, 8), -2 ** 31)]
    s, rate = 1.7, 0.2
    arrays = [_fold_inputs(k, n, r, 20 + i)
              for i, ((k, n, r), _) in enumerate(specs)]
    sites = [(*(torch.from_numpy(a) for a in arr), _seed_t(seed))
             for arr, (_, seed) in zip(arrays, specs)]
    before = wd_fold.LAUNCHES
    outs = wd_fold.build_wd_weights(sites, s, rate)
    assert wd_fold.LAUNCHES == before and len(outs) == 2
    for out, (w, u, v), ((k, n, _), seed) in zip(outs, arrays, specs):
        ref = np.asarray(j_dense._build_wd_weight(
            jnp.asarray(w), jnp.asarray(u), jnp.asarray(v), jnp.int32(seed),
            s, rate, None))
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
        keep = wd_fold.hash_keep_plain(0, 0, k, n, seed, rate).numpy()
        assert np.array_equal(out.numpy()[~keep], w[~keep])
    with pytest.raises(ValueError, match="1..4 weights"):
        wd_fold.build_wd_weights(sites * 3, s, rate)


@pytest.mark.parametrize("m, k, n, r, rate, seed",
                         [(48, 64, 128, 4, 0.1, 9), (40, 128, 64, 8, 0.3, -5)])
def test_masked_factor_grads_plain_matches_jax(m, k, n, r, rate, seed):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    _, u, v = _fold_inputs(k, n, r, 5)
    s = 1.5
    ref_du, ref_dv = j_dense._cp_wd_factor_grads(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(u), jnp.asarray(v),
        jnp.int32(seed), s, rate, 16, k, n, None)
    dt = torch.from_numpy(x).t() @ torch.from_numpy(g)
    du, dv = wd_fold.masked_factor_grads_plain(
        dt, torch.from_numpy(u), torch.from_numpy(v), _seed_t(seed), s, rate,
        torch.float32)
    np.testing.assert_allclose(du.numpy(), np.asarray(ref_du), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(ref_dv), **TOL)
