"""Gradient accumulation and activation checkpointing (remat) of the
port's train step against the JAX package's.

``make_train_step(grad_accum=N)`` against JAX's on the element, rank and
full routes, and on the element route where a layer draws the element
masks of the XLA dense forms (``dense_impl="xla"``, attention dropout):
one step's loss, accuracy, gradient norm, AdamW's first moment (0.1 x
the accumulated gradient after one update) and the updated trainables,
with JAX's randomness injected as JAX splits it (the weight-dropout
seeds and element masks once for the step, the drop-path gates and
dropout masks of microbatch i from ``fold_in(step_rng, i)``).
``remat`` True, "dots" and False against each other and against
``jax.value_and_grad`` of JAX's forward.  fp32, atol = rtol = 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_port_dropout as port_dropout
import test_torch_port_train as port_train
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.train import steps as t_steps
from cara_tpu import config as j_config
from cara_tpu.models import vit as j_vit
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = "vit_tiny_test"
B = 8


def _setup(route, **model_over):
    """(cfg, cara_cfg, params, cara, batch, j_cfg, j_cara_cfg, impls) at
    batch ``B``; ``route`` "element" / "rank" (CaRA, weight dropout 0.1,
    the fused kernels) or "full" (no adapter, the flash attention);
    ``model_over`` override the model's fields."""
    over = dict(num_classes=10, drop_path_rate=0.5, **model_over)
    cfg = get_model_config(MODEL, **over)
    j_cfg = j_config.get_model_config(MODEL, **over)
    params = convert.init_vit_params(cfg, 0)
    if route == "full":
        cc = CaraConfig(method="full", weight_dropout=0.0)
        cara, impls = {}, ("flash", "xla")
    else:
        cc = CaraConfig(rank=4, scale=2.0, weight_dropout=0.1,
                        weight_dropout_impl=route)
        cara = convert.perturb_adapter(
            convert.init_cara_params(cfg, cc, 1), 2, std=0.05)
        impls = ("fused", "fused")
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, B).astype(np.int32)}
    j_cc = j_config.CaraConfig(method=cc.method, rank=cc.rank,
                               scale=cc.scale,
                               weight_dropout=cc.weight_dropout,
                               weight_dropout_impl=cc.weight_dropout_impl)
    return cfg, cc, params, cara, batch, j_cfg, j_cc, impls


def accum_randomness(step_rng, cfg, cc, grad_accum,
                     impls=("fused", "fused")):
    """JAX's randomness of each microbatch (``steps.py:489-498``): the
    weight-dropout draw from ``step_rng``, shared (the seeds, the rank
    masks and, under ``impls`` that draw them, the element masks of the
    XLA dense forms); the gates and dropout masks from
    ``fold_in(step_rng, i)``."""
    adapter = cc if cc.method == "cara" else None
    size = B // grad_accum
    weights = [n for n, (_, kind) in t_vit.layer_mask_specs(
        cfg, adapter, size, *impls).items() if kind == "weight"]
    shared = port_dropout.jax_randomness(step_rng, cfg, size, adapter,
                                         *impls)
    out = []
    for i in range(grad_accum):
        rand = port_dropout.jax_randomness(jax.random.fold_in(step_rng, i),
                                           cfg, size, adapter, *impls)
        rand.update({k: shared[k] for k in ("seeds", "comp", "rows")
                     if k in shared})
        for layer, first in zip(rand.get("masks") or (),
                                shared.get("masks") or ()):
            layer.update({n: first[n] for n in weights})
        out.append(rand)
    return out


def _accum_step_vs_jax(cfg, cc, params, cara, batch, j_cfg, j_cc, impls,
                       grad_accum):
    """One accumulated step of the port against JAX's on the same
    randomness: loss, accuracy, gradient norm, the updated trainables
    and AdamW's first moment."""
    rng = jax.random.PRNGKey(11)
    tx = j_steps.make_optimizer(1e-3, steps_per_epoch=1, total_epochs=20)
    j_frozen, j_state = j_steps.init_train_state(tx, params, cara,
                                                 method=cc.method)
    j_step = jax.jit(j_steps.make_train_step(
        j_cfg, j_cc, tx, attn_impl=impls[0], dense_impl=impls[1],
        grad_accum=grad_accum))
    j_state, jm = j_step(j_state, j_frozen,
                         {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    frozen, state = t_steps.init_train_state(
        params, cara, "cpu", 1e-3, 1, total_epochs=20, method=cc.method)
    t_step = t_steps.make_train_step(cfg, cc, attn_impl=impls[0],
                                     dense_impl=impls[1],
                                     grad_accum=grad_accum)
    rands = accum_randomness(jax.random.fold_in(rng, 0), cfg, cc,
                             grad_accum, impls)
    assert any((r["gates"] == 0).any() for r in rands)
    state, m = t_step(state, frozen,
                      {k: torch.from_numpy(v) for k, v in batch.items()},
                      randomness=rands)
    for key in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    want = port_train._flat(j_state.trainable)
    mu = port_train._flat(j_state.opt_state[0].mu)
    leaves = t_steps.tree_leaves(state.trainable)
    assert sorted(p for p, _ in leaves) == sorted(want)
    for path, leaf in leaves:
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], **TOL,
                                   err_msg=path)
        np.testing.assert_allclose(
            state.opt.optimizer.state[leaf]["exp_avg"].numpy(), mu[path],
            **TOL, err_msg=f"mu {path}")
    assert state.step == 1
    return rands


@pytest.mark.parametrize("grad_accum", [2, 4])
@pytest.mark.parametrize("route", ["element", "rank", "full"])
def test_torch_grad_accum_step_matches_jax(route, grad_accum):
    _accum_step_vs_jax(*_setup(route), grad_accum)


@pytest.mark.parametrize("impls, over", [
    (("fused", "xla"), {}), (("fused", "fused"), {"attn_dropout_rate": 0.1})],
    ids=["dense_xla", "attn_dropout"])
def test_torch_grad_accum_element_masks_match_jax(impls, over):
    """The element route where a layer draws the element masks of the
    XLA dense forms (``dense_impl="xla"``: qkv, proj, fc1, fc2; attention
    dropout: qkv): 2 microbatches share JAX's one draw of them (from
    ``wd_rng``) and draw their own attention-dropout masks."""
    cfg, cc, params, cara, batch, j_cfg, j_cc, _ = _setup("element", **over)
    rands = _accum_step_vs_jax(cfg, cc, params, cara, batch, j_cfg, j_cc,
                               impls, 2)
    first, second = rands[0]["masks"][0], rands[1]["masks"][0]
    assert (first["qkv"] == 0).any()
    assert torch.equal(first["qkv"], second["qkv"])
    if "attn" in first:
        assert not torch.equal(first["attn"], second["attn"])


def test_torch_grad_accum_refuses_a_batch_that_does_not_divide():
    cfg, cc, params, cara, batch, *_ = _setup("rank")
    frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1)
    step = t_steps.make_train_step(cfg, cc, grad_accum=3)
    with pytest.raises(ValueError, match="not divisible by grad_accum=3"):
        step(state, frozen, {k: torch.from_numpy(v)
                             for k, v in batch.items()})


def test_torch_grad_accum_draws_one_weight_dropout_draw_a_step():
    """From a generator, the microbatches share the step's mask seeds and
    rank masks and draw their own gates; the accumulated step matches
    the same step given those draws."""
    cfg, cc, params, cara, batch, *_ = _setup("rank")
    g = torch.Generator().manual_seed(4)
    rands = t_steps.microbatch_randomness(cfg, cc, B, 4, "cpu", g)
    for r in rands[1:]:
        assert torch.equal(r["seeds"], rands[0]["seeds"])
        assert torch.equal(r["comp"], rands[0]["comp"])
    assert not all(torch.equal(r["gates"], rands[0]["gates"])
                   for r in rands[1:])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for given in (None, rands):
        frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3,
                                                 1)
        step = t_steps.make_train_step(cfg, cc, grad_accum=4)
        state, m = step(state, frozen, tb,
                        generator=torch.Generator().manual_seed(4),
                        randomness=given)
        out.append((float(m["loss"]), [t.detach().clone() for _, t in
                                       t_steps.tree_leaves(state.trainable)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impls, over", [
    (("fused", "xla"), {}), (("fused", "fused"), {"attn_dropout_rate": 0.1})],
    ids=["dense_xla", "attn_dropout"])
def test_torch_grad_accum_shares_the_element_masks_of_a_step(impls, over):
    """From a generator, the element route's microbatches share the
    step's element masks of the XLA dense forms and draw their own
    attention-dropout masks; the step from the generator matches the
    same step given those draws."""
    cfg, cc, params, cara, batch, *_ = _setup("element", **over)
    g = torch.Generator().manual_seed(4)
    rands = t_steps.microbatch_randomness(cfg, cc, B, 2, "cpu", g,
                                          attn_impl=impls[0],
                                          dense_impl=impls[1])
    weights = [n for n, (_, kind) in t_vit.layer_mask_specs(
        cfg, cc, B // 2, *impls).items() if kind == "weight"]
    assert weights
    for layer, other in zip(rands[0]["masks"], rands[1]["masks"]):
        for name in weights:
            assert torch.equal(layer[name], other[name]), name
        if "attn" in layer:
            assert not torch.equal(layer["attn"], other["attn"])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for given in (None, rands):
        frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3,
                                                 1)
        step = t_steps.make_train_step(cfg, cc, attn_impl=impls[0],
                                       dense_impl=impls[1], grad_accum=2)
        state, m = step(state, frozen, tb,
                        generator=torch.Generator().manual_seed(4),
                        randomness=given)
        out.append((float(m["loss"]), [t.detach().clone() for _, t in
                                       t_steps.tree_leaves(state.trainable)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def _grads(cfg, cc, params, cara, batch, remat, **kw):
    frozen, state = t_steps.init_train_state(
        params, cara, "cpu", 1e-3, 1, method=cc.method)
    loss, _, grads = t_steps.loss_and_grads(
        cfg, cc, state.trainable, frozen,
        {k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat,
        **kw)
    paths = [p for p, _ in t_steps.tree_leaves(state.trainable)]
    return loss, dict(zip(paths, grads))


def test_torch_remat_full_route_matches_jax():
    """Full fine-tuning through the flash attention (its autograd.Function
    recomputed under ``use_reentrant=False``): remat True, "dots" and
    False against ``jax.value_and_grad`` of JAX's remat forward, JAX's
    gates injected."""
    cfg, cc, params, _, batch, j_cfg, j_cc, impls = _setup("full")
    rng = jax.random.PRNGKey(5)
    x, y = jnp.asarray(batch["image"]), jnp.asarray(batch["label"])

    def j_loss(p):
        logits = j_vit.vit_forward(p, x, j_cfg, train=True, rng=rng,
                                   attn_impl="flash", dense_impl="xla",
                                   remat=True)
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, y[:, None], 1).mean()

    j_l, j_g = jax.value_and_grad(j_loss)(params)
    j_g = port_train._flat({"backbone": {k: v for k, v in j_g.items()
                                         if k != "head"},
                            "head": j_g["head"]})
    rand = port_train.jax_randomness(rng, cfg, B)
    for remat in (False, True, "dots"):
        loss, grads = _grads(cfg, cc, params, {}, batch, remat,
                             randomness=rand, attn_impl=impls[0],
                             dense_impl=impls[1])
        np.testing.assert_allclose(loss.item(), float(j_l), **TOL)
        assert sorted(grads) == sorted(j_g)
        for path, g in grads.items():
            np.testing.assert_allclose(g.numpy(), j_g[path], **TOL,
                                       err_msg=f"remat={remat} {path}")


def test_torch_remat_keeps_the_dropout_masks_of_the_forward():
    """CaRA on the XLA dense form with activation and attention dropout
    drawn from a generator inside the forward: remat True and "dots" give
    the gradients of remat False (the masks are drawn before each
    checkpointed block, so the recompute sees the same ones)."""
    over = dict(num_classes=10, drop_path_rate=0.5, dropout_rate=0.2,
                attn_dropout_rate=0.2)
    cfg = get_model_config(MODEL, **over)
    cc = CaraConfig(rank=4, scale=2.0, weight_dropout=0.1)
    params = convert.init_vit_params(cfg, 0)
    cara = convert.perturb_adapter(convert.init_cara_params(cfg, cc, 1), 2,
                                   std=0.05)
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, B).astype(np.int32)}
    out = {}
    for remat in (False, True, "dots"):
        out[remat] = _grads(cfg, cc, params, cara, batch, remat,
                            generator=torch.Generator().manual_seed(9),
                            attn_impl="xla", dense_impl="xla")
    for remat in (True, "dots"):
        assert out[remat][0].item() == pytest.approx(out[False][0].item(),
                                                     abs=1e-6)
        for path, g in out[False][1].items():
            np.testing.assert_allclose(out[remat][1][path].numpy(),
                                       g.numpy(), atol=1e-6, rtol=1e-6,
                                       err_msg=f"remat={remat} {path}")


def test_torch_remat_auto_follows_the_dense_form():
    """``remat="auto"``: on where the dense form is XLA (full, linear,
    ``dense_impl="xla"``), off on the CaRA kernel route, as JAX's rule
    (``steps.py:428-429``)."""
    seen = []
    real = t_vit.vit_forward

    def spy(*args, **kw):
        seen.append(kw.get("remat"))
        return real(*args, **kw)

    cfg, cc, params, cara, batch, *_ = _setup("rank")
    tb = {k: torch.from_numpy(v[:2]) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_steps, "vit_forward", spy)
        for c, p, kw in ((cc, cara, {}), (cc, cara, {"dense_impl": "xla"}),
                         (CaraConfig(method="full", weight_dropout=0.0), {},
                          {}),
                         (CaraConfig(method="linear", weight_dropout=0.0),
                          {}, {}), (cc, cara, {"dense_impl": "xla",
                                               "remat": False})):
            frozen, state = t_steps.init_train_state(
                params, p, "cpu", 1e-3, 1, method=c.method)
            t_steps.make_train_step(cfg, c, **kw)(state, frozen, tb)
    assert seen == [False, True, True, True, False]
