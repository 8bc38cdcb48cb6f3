"""The port's eval forward, merge and CP math against the JAX package.

One numpy parameter tree (``cara_tpu_torch.models.convert``, seeded) goes
to both packages: to JAX as arrays, to the port through
``params_from_numpy``.  The JAX forward runs with the impls the TPU
resolves (merged: ``attn_impl="fused", dense_impl="xla"``, which reaches
``fused_qkv_attention``; adapter: ``attn_impl="fused",
dense_impl="fused"``, which reaches ``cp_attn_block`` and
``cp_mlp_block``), in Pallas interpret mode.  fp32, atol = rtol = 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cara_tpu_torch import config as t_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import merge as t_merge
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops import cp as t_cp
from cara_tpu import config as j_config
from cara_tpu.models import merge as j_merge
from cara_tpu.models import vit as j_vit
from cara_tpu.ops import cp as j_cp

TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _setup(repr_size=None, scale=3.0, seed=0):
    kw = {} if repr_size is None else {"repr_size": repr_size}
    tcfg = t_config.get_model_config("vit_tiny_test", **kw)
    jcfg = j_config.get_model_config("vit_tiny_test", **kw)
    tcc = t_config.CaraConfig(rank=4, scale=scale)
    jcc = j_config.CaraConfig(rank=4, scale=scale)
    params = convert.init_vit_params(tcfg, seed)
    cara = convert.perturb_adapter(
        convert.init_cara_params(tcfg, tcc, seed + 1), seed + 2, std=0.1)
    x = np.random.default_rng(seed + 3).standard_normal(
        (2, tcfg.image_size, tcfg.image_size, 3)).astype(np.float32)
    return tcfg, jcfg, tcc, jcc, params, cara, x


@pytest.mark.parametrize("adapter", [False, True], ids=["merged", "adapter"])
@pytest.mark.parametrize("repr_size", [None, 64], ids=["head", "pre_logits"])
def test_vit_forward_matches_jax(adapter, repr_size):
    tcfg, jcfg, tcc, jcc, params, cara, x = _setup(repr_size)
    if adapter:
        jkw = dict(cara_params=_jax_tree(cara), cara_cfg=jcc,
                   attn_impl="fused", dense_impl="fused")
        tkw = dict(cara_params=convert.params_from_numpy(cara, "cpu"),
                   cara_cfg=tcc)
    else:
        jkw = dict(attn_impl="fused", dense_impl="xla")
        tkw = {}
    ref = np.asarray(j_vit.vit_forward(_jax_tree(params), jnp.asarray(x),
                                       jcfg, **jkw))
    tp = convert.params_from_numpy(params, "cpu")
    for impl in ("auto", "plain"):
        out = t_vit.vit_forward(tp, torch.from_numpy(x), tcfg, impl=impl,
                                **tkw)
        assert out.shape == (2, tcfg.num_classes)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_merged_forward_equals_adapter_forward():
    tcfg, _, tcc, _, params, cara, x = _setup(scale=7.0)
    tp = convert.params_from_numpy(params, "cpu")
    tc = convert.params_from_numpy(cara, "cpu")
    merged = t_merge.merge_cara(tp, tc, tcfg, tcc)
    a = t_vit.vit_forward(merged, torch.from_numpy(x), tcfg)
    b = t_vit.vit_forward(tp, torch.from_numpy(x), tcfg, cara_params=tc,
                          cara_cfg=tcc)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    base = t_vit.vit_forward(tp, torch.from_numpy(x), tcfg)
    assert np.abs(a.numpy() - base.numpy()).max() > 1e-3  # delta is live


def test_merge_cara_matches_jax():
    tcfg, jcfg, tcc, jcc, params, cara, _ = _setup()
    ref = j_merge.merge_cara(_jax_tree(params), _jax_tree(cara), jcfg, jcc)
    out = t_merge.merge_cara(convert.params_from_numpy(params, "cpu"),
                             convert.params_from_numpy(cara, "cpu"),
                             tcfg, tcc)
    for site in ("qkv", "proj", "fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(
                out["blocks"][site][leaf].numpy(),
                np.asarray(ref["blocks"][site][leaf]), **TOL)


@pytest.mark.parametrize("name", [
    "qkv_delta", "rows_delta_out", "rows_delta_in"])
def test_cp_deltas_match_jax(name):
    rng = np.random.default_rng(5)
    e, h, d, r, rows = 16, 2, 8, 3, 4

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if name == "qkv_delta":
        args = (a(2, 5, e), a(3, r), a(e, r), a(h, r), a(d, r), a(r))
    elif name == "rows_delta_out":
        args = (a(2, 5, e), a(rows, r), a(e, r), a(e, r), a(r))
    else:
        args = (a(2, 5, rows * e), a(rows, r), a(e, r), a(e, r), a(r))
    targs = [torch.from_numpy(v) for v in args]
    jargs = [jnp.asarray(v) for v in args]
    for impl in ("materialized", "factorized"):
        fn = f"{name}_{impl}"
        out = getattr(t_cp, fn)(*targs).numpy()
        ref = np.asarray(getattr(j_cp, fn)(*jargs))
        np.testing.assert_allclose(out, ref, **TOL)
