"""The port's mixture-of-expert CaRA adapters (``models/moe.py``) against
the JAX package's.

The tree and its init, the validation, the router's gates and
load-balance loss (the all-ties case included), the four gated deltas and
the gated bias, ``vit_forward`` in eval at CP orders 3, 4 and 5 and in
training with JAX's (X, r) rank masks and drop-path gates injected, the
loss with the aux term and every trainable gradient against
``jax.value_and_grad``, two train steps, forced routing against the
single adapter with zero gradients for the unselected experts,
checkpoints both ways, ``Predictor`` (always unmerged) and the refusals,
``lambda_stats``, the ``--moe`` flag and one CLI run.  Tiny model, numpy
trees from a seed, fp32 on the CPU, atol = rtol = 1e-4 unless stated.
"""

import argparse
import dataclasses
import glob

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from test_torch_port_train import _flat, jax_randomness
from cara_tpu_torch import api as t_api
from cara_tpu_torch import serving as t_serving
from cara_tpu_torch.cli import common as t_common
from cara_tpu_torch.cli import export as t_export
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import merge as t_merge
from cara_tpu_torch.models import moe as t_moe
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu_torch.train import steps as t_steps
from cara_tpu_torch.utils.logging import MetricLogger
from cara_tpu import api as j_api
from cara_tpu import config as j_config
from cara_tpu import serving as j_serving
from cara_tpu.cli import common as j_common
from cara_tpu.models import merge as j_merge
from cara_tpu.models import moe as j_moe
from cara_tpu.models import vit as j_vit
from cara_tpu.ops import cp as j_cp
from cara_tpu.train import checkpoint as j_ckpt
from cara_tpu.train import steps as j_steps
from cara_tpu.utils import logging as j_logging

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = "vit_tiny_test"
B = 2
X, K = 3, 2


def _cc(**over):
    kw = dict(rank=4, scale=2.0, moe_experts=X, moe_top_k=K,
              weight_dropout=0.1, weight_dropout_impl="rank")
    kw.update(over)
    return CaraConfig(**kw), j_config.CaraConfig(**kw)


def _setup(model_over=None, **over):
    """(cfg, cc, params, tree, batch, j_cfg, j_cc): the experts' zero
    factors and every bias perturbed, so that each expert's delta is
    nonzero and the experts differ."""
    mo = dict(num_classes=10, drop_path_rate=0.5, **(model_over or {}))
    cfg = get_model_config(MODEL, **mo)
    j_cfg = j_config.get_model_config(MODEL, **mo)
    cc, j_cc = _cc(**over)
    params = convert.init_vit_params(cfg, 0)
    tree = convert.perturb_adapter(convert.init_cara_params(cfg, cc, 1), 2,
                                   std=0.05)
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, B).astype(np.int32)}
    return cfg, cc, params, tree, batch, j_cfg, j_cc


def _t(tree):
    return convert.params_from_numpy(tree, "cpu")


def _shapes(tree, prefix=""):
    """path -> shape of every leaf (numpy arrays or JAX shape structs)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_torch_moe_tree_init_and_validation_match_jax():
    """Shapes and the init's statistics against JAX's ``init_moe_params``
    (independent experts, zero contract modes, a trunc-normal(0.02)
    router, zero bias), ``build_model``'s tree and count, and every
    ``validate_moe`` refusal with JAX's message."""
    cfg = get_model_config(MODEL)
    for order in (3, 4, 5):
        cc, j_cc = _cc(cp_order=order)
        tree = convert.init_cara_params(cfg, cc, 1)
        want = jax.eval_shape(lambda: j_moe.init_moe_params(
            jax.random.key(1), cfg, j_cc))
        assert _shapes(tree) == _shapes(want)
        assert t_moe.is_moe_params(tree) and j_moe.is_moe_params(tree)
        zero = "A2" if order in (3, 4) else "A3"
        for name in (zero, "P2", "bias1", "bias2", "bias3"):
            assert not np.asarray(tree["experts"][name]).any(), name
        a1 = np.asarray(tree["experts"]["A1"])
        assert np.abs(a1[0] - a1[1]).max() > 1e-3
    kernel = tree["router"]["kernel"]
    assert kernel.shape == (cfg.embed_dim, X) and kernel.dtype == np.float32
    assert np.abs(kernel).max() <= 0.04 and 0.01 < kernel.std() < 0.025
    assert not tree["router"]["bias"].any()
    model = t_api.build_model(MODEL, rank=4, moe_experts=X, moe_top_k=1,
                              weight_dropout_impl="rank", num_classes=5)
    j_model = j_api.build_model(MODEL, rank=4, moe_experts=X, moe_top_k=1,
                                weight_dropout_impl="rank", num_classes=5)
    assert model.cara_cfg == CaraConfig(
        **dataclasses.asdict(j_model.cara_cfg))
    assert _shapes(model.cara_params) == _shapes(j_model.cara_params)
    assert model.trainable_count == j_model.trainable_count
    cc, j_cc = _cc()
    for over, train, match in (
            (dict(delta_impl="materialized"), False, "factorized"),
            (dict(cp_order=2), False, "cp_order"),
            (dict(moe_top_k=X + 1), False, "moe_top_k"),
            (dict(weight_dropout_impl="element"), True, "rank")):
        for lib, c in ((t_moe, cc), (j_moe, j_cc)):
            with pytest.raises(ValueError, match=match):
                lib.validate_moe(dataclasses.replace(c, **over), train=train)
    t_moe.validate_moe(dataclasses.replace(cc, weight_dropout_impl="element"))


@pytest.mark.parametrize("case", ["random", "ties", "forced"])
def test_torch_moe_route_matches_jax(case):
    """Gates, aux and the router's gradient (through both) against
    ``jax.vjp`` of ``route``; with a zero router every probability ties
    and both select experts 0..K-1 (``jax.lax.top_k``'s lower index
    first); a router forced onto one expert gives aux X at top 1."""
    rng = np.random.default_rng(4)
    tokens = rng.standard_normal((B, 7, 16)).astype(np.float32)
    xn, k = 5, 2
    router = {"kernel": rng.standard_normal((16, xn)).astype(np.float32),
              "bias": 0.1 * rng.standard_normal(xn).astype(np.float32)}
    if case == "ties":  # experts 0, 2 and 4 tie first for every token
        router = {"kernel": np.zeros((16, xn), np.float32),
                  "bias": np.array([1, 0, 1, 0, 1], np.float32)}
    if case == "forced":
        k = 1
        router = {"kernel": np.zeros((16, xn), np.float32),
                  "bias": np.where(np.arange(xn) == 3, 1e4, -1e4).astype(
                      np.float32)}
    cot = rng.standard_normal((B, 7, xn)).astype(np.float32)

    def j_fn(tok, r):
        gates, aux = j_moe.route(tok, r, k)
        return jnp.sum(gates * cot) + 3.0 * aux, (gates, aux)

    (_, (j_gates, j_aux)), j_grad = jax.value_and_grad(
        j_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(tokens),
                                            jax.tree.map(jnp.asarray, router))
    tok = torch.from_numpy(tokens).requires_grad_(True)
    rt = {n: torch.from_numpy(v).requires_grad_(True)
          for n, v in router.items()}
    gates, aux = t_moe.route(tok, rt, k)
    np.testing.assert_allclose(gates.detach().numpy(), np.asarray(j_gates),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-5)
    assert ((gates > 0).sum(-1) == k).all()
    if case == "ties":  # the lower indices of the three tied
        assert (gates[..., 0] > 0).all() and (gates[..., 2] > 0).all()
    if case == "forced":
        assert aux.item() == pytest.approx(xn, rel=1e-5)
    (torch.sum(gates * torch.from_numpy(cot)) + 3.0 * aux).backward()
    np.testing.assert_allclose(tok.grad.numpy(), np.asarray(j_grad[0]),
                               atol=1e-5, rtol=1e-4)
    for n in router:
        np.testing.assert_allclose(rt[n].grad.numpy(),
                                   np.asarray(j_grad[1][n]), atol=1e-5,
                                   rtol=1e-4, err_msg=n)
    # the all-ties router selects experts 0..K-1, as JAX does
    zero = {n: torch.zeros_like(v) for n, v in rt.items()}
    g0, a0 = t_moe.route(tok.detach(), zero, 2)
    assert (g0[..., :2] == 0.5).all() and not g0[..., 2:].any()
    assert float(a0) == pytest.approx(1.0)


@pytest.mark.parametrize("order", [3, 4, 5])
def test_torch_moe_gated_deltas_match_jax(order):
    """``moe_qkv_delta``, ``moe_rows_delta_out`` (the projection and MLP
    up rows), ``moe_rows_delta_in`` and ``moe_bias`` against JAX's, with
    and without JAX's (X, r) rank masks; and their cotangents for one
    random output cotangent."""
    cfg, cc, _, tree, _, _, j_cc = _setup(cp_order=order)
    rng = np.random.default_rng(5)
    e, hid, mr = cfg.embed_dim, cfg.hidden_dim, cfg.mlp_ratio
    x = rng.standard_normal((B, 5, e)).astype(np.float32)
    h = rng.standard_normal((B, 5, hid)).astype(np.float32)
    gates_j, _ = j_moe.route(jnp.asarray(x), tree["router"], K)
    gates = torch.from_numpy(np.asarray(gates_j))
    experts = tree["experts"]
    a1, p1 = j_moe.moe_stacked_layer_slices(
        jax.tree.map(jnp.asarray, experts), cfg, j_cc)
    ta1, tp1 = t_moe.moe_stacked_layer_slices(_t(experts), cfg, cc)
    np.testing.assert_array_equal(ta1.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(tp1.numpy(), np.asarray(p1))
    layer = 1
    key = jax.random.key(8)
    mask = torch.from_numpy(np.asarray(j_cp.weight_dropout_mask(
        key, (X, cc.rank), cc.weight_dropout)))
    tx, th = torch.from_numpy(x), torch.from_numpy(h)
    for drop in (None, key):
        comp = None if drop is None else mask
        pairs = [
            (j_moe.moe_qkv_delta(jnp.asarray(x), experts, a1[layer], gates_j,
                                 cfg, j_cc, drop_rng=drop),
             t_moe.moe_qkv_delta(tx, _t(experts), ta1[layer], gates, cfg,
                                 cc, comp)),
            (j_moe.moe_rows_delta_out(jnp.asarray(x), p1[layer][:, 0:1],
                                      experts, gates_j, drop,
                                      cc.weight_dropout),
             t_moe.moe_rows_delta_out(tx, tp1[layer][:, 0:1], _t(experts),
                                      gates, comp)),
            (j_moe.moe_rows_delta_out(jnp.asarray(x),
                                      p1[layer][:, 1:1 + mr], experts,
                                      gates_j, drop, cc.weight_dropout),
             t_moe.moe_rows_delta_out(tx, tp1[layer][:, 1:1 + mr],
                                      _t(experts), gates, comp)),
            (j_moe.moe_rows_delta_in(jnp.asarray(h),
                                     p1[layer][:, 1 + mr:], experts,
                                     gates_j, drop, cc.weight_dropout),
             t_moe.moe_rows_delta_in(th, tp1[layer][:, 1 + mr:],
                                     _t(experts), gates, comp))]
        for i, (want, got) in enumerate(pairs):
            assert np.abs(np.asarray(want)).max() > 1e-3
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"site {i}, masks {comp}")
    for name in ("bias1", "bias2", "bias3"):
        np.testing.assert_allclose(
            t_moe.moe_bias(gates, _t(experts)[name]).numpy(),
            np.asarray(j_moe.moe_bias(gates_j, experts[name])), **TOL)
    # the cotangents of the qkv site's delta, factors and gates
    cot = rng.standard_normal((B, 5, 3, cfg.num_heads, cfg.head_dim))
    cot = cot.astype(np.float32)

    def j_fn(xx, ex, g):
        ea1, _ = j_moe.moe_stacked_layer_slices(ex, cfg, j_cc)
        return jnp.sum(j_moe.moe_qkv_delta(xx, ex, ea1[layer], g, cfg,
                                           j_cc) * cot)

    j_g = jax.grad(j_fn, argnums=(0, 1, 2))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, experts), gates_j)
    tx = tx.clone().requires_grad_(True)
    tex = {n: v.clone().requires_grad_(True)
           for n, v in _t(experts).items()}
    tg = gates.clone().requires_grad_(True)
    ea1, _ = t_moe.moe_stacked_layer_slices(tex, cfg, cc)
    torch.sum(t_moe.moe_qkv_delta(tx, tex, ea1[layer], tg, cfg, cc)
              * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_g[0]), **TOL)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(j_g[2]), **TOL)
    for n, v in tex.items():
        want = np.asarray(j_g[1][n])
        got = np.zeros_like(want) if v.grad is None else v.grad.numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=n)


@pytest.mark.parametrize("order", [3, 4, 5])
def test_torch_moe_eval_forward_matches_jax(order):
    """Eval logits and aux against JAX's at each CP order (the fused
    attention's plain twin against the XLA one; the XLA dense forms,
    which ``resolve_impls`` pins and ``"fused"`` is refused for)."""
    cfg, cc, params, tree, batch, j_cfg, j_cc = _setup(cp_order=order)
    ref, j_aux = j_vit.vit_forward(
        params, jnp.asarray(batch["image"]), j_cfg, cara_params=tree,
        cara_cfg=j_cc, attn_impl="xla", dense_impl="xla",
        return_moe_aux=True)
    out, aux = t_vit.vit_forward(
        _t(params), torch.from_numpy(batch["image"]), cfg, _t(tree), cc,
        return_moe_aux=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-5)
    assert t_vit.resolve_impls("auto", "auto", cc) == ("fused", "xla")
    for lib, c, p, x in ((t_vit, cc, _t(params),
                          torch.from_numpy(batch["image"])),
                         (j_vit, j_cc, params, jnp.asarray(batch["image"]))):
        with pytest.raises(ValueError, match="dense_impl='xla'"):
            lib.vit_forward(p, x, cfg if lib is t_vit else j_cfg,
                            cara_params=_t(tree) if lib is t_vit else tree,
                            cara_cfg=c, dense_impl="fused")
    plain = t_vit.vit_forward(_t(params), torch.from_numpy(batch["image"]),
                              cfg)
    assert not torch.equal(plain, out)  # the experts' deltas are on
    if order == 4:  # JAX's own init tree, carried across as numpy
        j_tree = convert.perturb_adapter(jax.device_get(
            j_moe.init_moe_params(jax.random.key(3), j_cfg, j_cc)), 4,
            std=0.05)
        ref = j_vit.vit_forward(
            params, jnp.asarray(batch["image"]), j_cfg, cara_params=j_tree,
            cara_cfg=j_cc, attn_impl="xla", dense_impl="xla")
        out = t_vit.vit_forward(_t(params), torch.from_numpy(batch["image"]),
                                cfg, _t(j_tree), cc)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="'experts', 'router'"):
        t_vit.vit_forward(_t(params), torch.from_numpy(batch["image"]), cfg,
                          _t(tree["experts"]), cc)


def test_torch_moe_train_forward_matches_jax():
    """The training forward at order 5, three experts top 2, with JAX's
    drop-path gates and (X, r) rank masks injected (order 4 at two
    experts: ``test_torch_port_train.py``), against JAX's fused
    attention in interpret mode."""
    cfg, cc, params, tree, batch, j_cfg, j_cc = _setup(cp_order=5)
    rng = jax.random.PRNGKey(7)
    ref = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                            cara_params=tree, cara_cfg=j_cc, train=True,
                            rng=rng, attn_impl="fused", dense_impl="xla")
    rand = jax_randomness(rng, cfg, B, cc)
    assert rand["comp"].shape == (cfg.depth, 4, X, cc.rank)
    assert (rand["comp"] == 0).any() and (rand["gates"] == 0).any()
    out = t_vit.vit_forward(_t(params), torch.from_numpy(batch["image"]),
                            cfg, _t(tree), cc, train=True, randomness=rand)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the port's own draw has JAX's layout
    own = t_vit.draw_randomness(cfg, B, "cpu", torch.Generator(), cara_cfg=cc)
    assert own["comp"].shape == rand["comp"].shape


def test_torch_moe_train_steps_match_jax():
    """Step 1's loss (cross-entropy plus ``moe_aux_coef`` times aux) and
    every trainable leaf's gradient, router included, against
    ``jax.value_and_grad``; then two steps of ``make_train_step`` (loss,
    grad_norm, the updated trainables) against JAX's."""
    cfg, cc, params, tree, batch, j_cfg, j_cc = _setup(moe_aux_coef=0.5)
    rng = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = j_steps.make_optimizer(1e-3, steps_per_epoch=1, total_epochs=20)
    j_frozen, j_state = j_steps.init_train_state(tx, params, tree)
    j_step = jax.jit(j_steps.make_train_step(
        j_cfg, j_cc, tx, attn_impl="xla", dense_impl="xla"))

    def j_loss(trainable, step_rng):
        logits, aux = j_vit.vit_forward(
            j_steps.merge_params(j_frozen, trainable), jb["image"], j_cfg,
            cara_params=trainable["cara"], cara_cfg=j_cc, train=True,
            rng=step_rng, attn_impl="xla", dense_impl="xla",
            return_moe_aux=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jb["label"]).mean() + j_cc.moe_aux_coef * aux

    frozen, state = t_steps.init_train_state(params, tree, "cpu", 1e-3, 1,
                                             total_epochs=20)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    step_rng = jax.random.fold_in(rng, 0)
    j_l, j_g = jax.jit(jax.value_and_grad(j_loss))(j_state.trainable,
                                                   step_rng)
    loss, _, grads = t_steps.loss_and_grads(
        cfg, cc, state.trainable, frozen, tbatch,
        randomness=jax_randomness(step_rng, cfg, B, cc))
    np.testing.assert_allclose(loss.item(), float(j_l), **TOL)
    j_gf = _flat(j_g)
    paths = [p for p, _ in t_steps.tree_leaves(state.trainable)]
    assert sorted(paths) == sorted(j_gf)
    assert np.abs(j_gf["cara/router/kernel"]).max() > 1e-6
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), j_gf[path], **TOL,
                                   err_msg=path)
    t_step = t_steps.make_train_step(cfg, cc)
    for step in range(2):
        rand = jax_randomness(jax.random.fold_in(rng, step), cfg, B, cc)
        j_state, jm = j_step(j_state, j_frozen, jb, rng)
        state, m = t_step(state, frozen, tbatch, randomness=rand)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                       err_msg=key)
        want = _flat(j_state.trainable)
        for path, leaf in t_steps.tree_leaves(state.trainable):
            np.testing.assert_allclose(leaf.detach().numpy(), want[path],
                                       **TOL, err_msg=f"step {step} {path}")


def test_torch_moe_forced_routing_is_the_single_adapter():
    """A router forced onto expert j reproduces the single adapter of
    expert j's factors (eval logits), and with the router forced onto
    expert 0 the other experts' gradients are exactly zero while expert
    0's are not (``tests/test_moe.py``'s anchors)."""
    cfg, cc, params, tree, batch, _, _ = _setup(weight_dropout=0.0)
    x = torch.from_numpy(batch["image"])
    single = dataclasses.replace(cc, moe_experts=0)

    def forced(j):
        return {"experts": _t(tree["experts"]), "router": {
            "kernel": torch.zeros(cfg.embed_dim, X),
            "bias": torch.where(torch.arange(X) == j, 1e4, -1e4)}}

    for j in (0, 2):
        got = t_vit.vit_forward(_t(params), x, cfg, forced(j), cc)
        want = t_vit.vit_forward(
            _t(params), x, cfg,
            {n: v[j] for n, v in _t(tree["experts"]).items()}, single,
            dense_impl="xla")
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)
    cara = forced(0)
    for v in cara["experts"].values():
        v.requires_grad_(True)
    logits, aux = t_vit.vit_forward(_t(params), x, cfg, cara, cc,
                                    return_moe_aux=True)
    loss = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(batch["label"]).long()) + aux
    loss.backward()
    for name, v in cara["experts"].items():
        assert not v.grad[1:].any(), f"{name} leaked gradients"
        if name in ("A1", "A2", "P1", "P2"):
            assert v.grad[0].abs().max() > 0, name


def test_torch_moe_checkpoints_cross_load(tmp_path):
    """A MoE model and adapter file written by each package load in the
    other, ``infer_cara_cfg`` rebuilds JAX's config (from the meta, and
    from the router's width without it), and both serve the same logits
    (``Predictor`` unmerged whatever ``merge`` says); a resume snapshot
    of the nested tree restores it bit for bit."""
    cfg, cc, params, tree, batch, j_cfg, j_cc = _setup()
    _, state = t_steps.init_train_state(params, tree, "cpu", 1e-3, 1)
    t_ckpt.save_train_state(str(tmp_path / "snap"), 3, state)
    back, _ = t_ckpt.restore_train_state(str(tmp_path / "snap"), 3, state)
    for (p, a), (q, b) in zip(t_steps.tree_leaves(state.trainable),
                              t_steps.tree_leaves(back.trainable)):
        assert p == q and torch.equal(a, b)
    meta = {**dataclasses.asdict(cc), "model": MODEL}
    images = batch["image"]
    for writer in ("port", "jax"):
        path = str(tmp_path / f"{writer}.npz")
        if writer == "port":
            t_ckpt.save_model(path, _t(params), _t(tree), meta)
        else:
            j_ckpt.save_model(path, params, tree, meta)
        for loader in (t_ckpt, j_ckpt):
            p2, c2, m2 = loader.load_model(path)
            for k, v in _flat(tree).items():
                np.testing.assert_array_equal(_flat(c2)[k], v)
        _, c2, m2 = t_ckpt.load_model(path)
        assert t_ckpt.infer_cara_cfg(c2, m2) == CaraConfig(
            **dataclasses.asdict(j_ckpt.infer_cara_cfg(c2, m2)))
        bare = {"scale": 2.0}
        got = t_ckpt.infer_cara_cfg(c2, bare)
        assert got == CaraConfig(**dataclasses.asdict(
            j_ckpt.infer_cara_cfg(c2, bare)))
        assert (got.moe_experts, got.moe_top_k,
                got.weight_dropout_impl) == (X, 2, "rank")
        pred = t_serving.Predictor.from_checkpoint_auto(
            path, MODEL, merge=True, device="cpu", dtype=torch.float32,
            batch_size=4)
        assert pred._cara is not None
        want = j_serving.Predictor.from_checkpoint_auto(
            path, MODEL, merge=True, dtype=jnp.float32, batch_size=4)
        np.testing.assert_allclose(pred.logits(images), want.logits(images),
                                   **TOL)
    adapter = str(tmp_path / "adapter.npz")
    t_ckpt.save_adapter(adapter, _t(tree), _t(params["head"]), meta)
    c3, head, m3 = j_ckpt.load_adapter(adapter)
    assert j_ckpt.infer_cara_cfg(c3, m3).moe_experts == X
    np.testing.assert_array_equal(c3["router"]["kernel"],
                                  tree["router"]["kernel"])


def test_torch_moe_refusals_match_jax():
    """``merge_cara``, ``MultiTaskPredictor`` and ToMe refuse a mixture of
    experts, as JAX's do."""
    cfg, cc, params, tree, _, j_cfg, j_cc = _setup()
    for merge, c, p, tr in ((t_merge.merge_cara, cc, _t(params), _t(tree)),
                            (j_merge.merge_cara, j_cc, params, tree)):
        with pytest.raises(ValueError, match="MoE adapters cannot be merged"):
            merge(p, tr, cfg, c)
    task = {"cara": tree, "head": params["head"], "scale": 2.0,
            "cp_order": 4}
    for cls, kw in ((t_serving.MultiTaskPredictor, dict(device="cpu")),
                    (j_serving.MultiTaskPredictor, {})):
        with pytest.raises(ValueError, match="MoE adapter"):
            cls(params, cfg, {"a": task}, **kw)
    for cls, kw in ((t_serving.Predictor, dict(device="cpu")),
                    (j_serving.Predictor, {})):
        with pytest.raises(ValueError, match="tome_r requires a dense"):
            cls(params, cfg, cara_params=tree, cara_cfg=cc, tome_r=2, **kw)


def test_torch_moe_lambda_stats_and_flags_match_jax(capsys):
    """``lambda_stats`` pools every expert's lambdas as JAX's does; the
    ``--moe`` flag's keywords (the element impl turned into the rank one,
    with the note) and its errors are JAX's."""
    _, _, _, tree, _, _, _ = _setup()
    got = MetricLogger(enabled=False).lambda_stats(_t(tree), histogram=True)
    want = j_logging.MetricLogger(enabled=False).lambda_stats(
        tree, histogram=True)
    assert got.keys() == want.keys()
    for k in ("r1_mean", "r1_std", "r2_mean", "r2_std"):
        assert got[k] == pytest.approx(want[k], rel=1e-6)
    assert got["r1_hist"]["counts"] == want["r1_hist"]["counts"]
    for flags in (["--moe", "4,2"], ["--moe", "3"], ["--moe", "2,1",
                                                     "--weight-dropout-impl",
                                                     "rank"]):
        args = t_cli.parse_args(["--dim", "8", *flags])
        j_args = argparse.Namespace(**vars(args))
        assert t_common.adapter_impl_kwargs(args) == \
            j_common.adapter_impl_kwargs(j_args)
    assert "element -> rank" in capsys.readouterr().out
    for spec, extra, match in (("x", (), "integers"), ("2,1,1", (), "X\\[,K"),
                               ("1", (), ">= 2 experts"),
                               ("3,4", (), "1 <= K <= X"),
                               ("2", ("--method", "lora"), "CaRA-only")):
        args = t_cli.parse_args(["--moe", spec, *extra])
        j_args = argparse.Namespace(**vars(args))
        for fn, a in ((t_common.adapter_impl_kwargs, args),
                      (j_common.adapter_impl_kwargs, j_args)):
            with pytest.raises(SystemExit, match=match):
                fn(a)


def test_torch_moe_cli_trains_evaluates_and_exports(tmp_path):
    """``cli.vit_cp --moe 2 --device cpu``: its checkpoint records the
    mixture, ``--evaluate`` reads it without ``--moe`` (the same
    accuracy), ``cli.export --mode merged`` refuses it with JAX's message
    and ``--mode adapter`` writes it."""
    out = tmp_path / "run"
    argv = ["--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
            "--dim", "4", "--epochs", "11", "--batch-size", "8",
            "--eval-batch-size", "8", "--synthetic-size", "8",
            "--dtype", "float32", "--log-every", "1000",
            "--backbone", str(tmp_path / "missing.npz"),
            "--out-dir", str(out), "--device", "cpu"]
    acc = t_cli.main(argv + ["--moe", "2"])
    (ckpt,) = glob.glob(str(out / "vit_*.npz"))
    _, tree, meta = t_ckpt.load_model(ckpt)
    assert (meta["moe_experts"], meta["moe_top_k"],
            meta["weight_dropout_impl"]) == (2, 2, "rank")
    assert tree["router"]["kernel"].shape == (64, 2)
    assert t_cli.main(argv + ["--evaluate", ckpt]) == pytest.approx(acc)
    export = ["--ckpt", ckpt, "--device", "cpu", "--out"]
    with pytest.raises(SystemExit, match="MoE adapters cannot be merged"):
        t_export.main(export + [str(tmp_path / "m.npz"), "--mode",
                                "merged"])
    t_export.main(export + [str(tmp_path / "a.npz"), "--mode", "adapter"])
    assert t_ckpt.is_adapter_checkpoint(str(tmp_path / "a.npz"))


def test_torch_moe_smoke_stand_in_takes_every_block_argument():
    """``chip_smoke._pair_block`` stands in for ``models.vit._block`` in
    the row 19 eval checks: it takes every argument ``_block`` takes
    (``moe_gates`` among them), so ``vit_forward``'s call reaches it."""
    import inspect

    import chip_smoke

    want = set(inspect.signature(t_vit._block).parameters)
    got = set(inspect.signature(chip_smoke._pair_block).parameters)
    assert want <= got, sorted(want - got)
