"""The port's CP orders 2, 3 and 5, the materialized delta and
``cli.dim_experiment`` against the JAX package.

``vit_forward``'s training forward (logits and every adapter gradient)
at orders 2, 3 and 5 (order 2's qkv delta always the dense tensor, on
the rank route; order 3 on the element route's kernels, order 5 on the
rank route's) and with ``delta_impl="materialized"`` at orders 3, 4 and
5 (the XLA dense forms, every site's dense delta masked element-wise);
order 2's merge; one ``dim_experiment`` train step at order 5, rank 32,
on the element route; the ablation's eval cadence and build through both
CLIs; a CLI run that trains.  JAX's seeds, gates and element masks are
derived from its keys and injected
(``test_torch_port_dropout.jax_randomness``).  Tiny model, numpy inputs
from a seed, fp32, atol = rtol = 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import test_torch_port_train as port_train
from test_torch_port_dropout import jax_randomness
from cara_tpu_torch import config as t_config
from cara_tpu_torch.cli import dim_experiment as t_dim
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import merge as t_merge
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.train import loop as t_loop
from cara_tpu_torch.train import steps as t_steps
from cara_tpu import config as j_config
from cara_tpu.cli import dim_experiment as j_dim
from cara_tpu.models import merge as j_merge
from cara_tpu.models import vit as j_vit
from cara_tpu.train import loop as j_loop
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
B = port_train.B
# (order, delta form, weight-dropout route): order 2 on the rank route,
# whose qkv delta stays dense with its element mask while the other sites
# take the rank masks (on the element route every site of order 2 is a
# masked dense delta, as with the materialized form); order 5 on the rank
# route too (its lambda R1 * A1[l] under the rank mask; its element route
# is the dim_experiment step's below).
CASES = [(2, "factorized", "rank"), (3, "factorized", "element"),
         (5, "factorized", "rank"), (3, "materialized", "element"),
         (4, "materialized", "element"), (5, "materialized", "element")]


def _setup(order, delta_impl, **over):
    return port_train._setup(cp_order=order, delta_impl=delta_impl, **over)


def _j_loss(params, j_cfg, j_cc, x, labels, rng, dense_impl):
    def loss(cara):
        logits = j_vit.vit_forward(
            params, x, j_cfg, cara_params=cara, cara_cfg=j_cc, train=True,
            rng=rng, attn_impl="fused", dense_impl=dense_impl)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean(), logits
    return loss


def _train_pair(order, delta_impl, seed=7, **over):
    """(port logits, JAX logits, port grads, JAX grads) of one training
    forward and backward with JAX's randomness injected."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup(order, delta_impl,
                                                       **over)
    dense = t_vit.resolve_impls("auto", "auto", cc)[1]
    rng = jax.random.PRNGKey(seed)
    (_, ref), j_g = jax.jit(jax.value_and_grad(
        _j_loss(params, j_cfg, j_cc, jnp.asarray(batch["image"]),
                jnp.asarray(batch["label"]), rng, "fused"),
        has_aux=True))(cara)
    rand = jax_randomness(rng, cfg, B, cc, "fused", dense)
    tc = {k: v.requires_grad_(True)
          for k, v in convert.params_from_numpy(cara, "cpu").items()}
    out = t_vit.vit_forward(convert.params_from_numpy(params, "cpu"),
                            torch.from_numpy(batch["image"]), cfg, tc, cc,
                            train=True, randomness=rand)
    loss = torch.nn.functional.cross_entropy(
        out, torch.from_numpy(batch["label"]).long())
    grads = dict(zip(tc, torch.autograd.grad(loss, list(tc.values()))))
    return out, ref, grads, j_g, rand


@pytest.mark.parametrize("order, delta_impl, impl", CASES)
def test_torch_vit_forward_orders_match_jax(order, delta_impl, impl):
    """The training forward's logits and the gradient of every adapter
    leaf (the eval forward of these forms is the same without masks and
    gates; ``test_torch_port_multitask.py`` holds it at orders 2 and 5,
    the serving tests at 4)."""
    dense_masks = order == 2 or delta_impl == "materialized"
    out, ref, grads, j_g, rand = _train_pair(order, delta_impl,
                                             weight_dropout_impl=impl)
    assert ("masks" in rand) == dense_masks
    if dense_masks:  # a dropped element of a dense delta is exercised
        assert not rand["masks"][0]["qkv"].all()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    assert sorted(grads) == sorted(j_g)
    for name, g in grads.items():
        assert g.abs().sum() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(j_g[name]), **TOL,
                                   err_msg=name)


def test_torch_merge_order_2_matches_jax():
    """``merge_cara`` folds order 2's dense qkv tensor as JAX's."""
    cfg, cc, params, cara, _, j_cfg, j_cc = _setup(2, "factorized")
    got = t_merge.merge_cara(convert.params_from_numpy(params, "cpu"),
                             convert.params_from_numpy(cara, "cpu"), cfg, cc)
    want = j_merge.merge_cara(params, cara, j_cfg, j_cc)
    for site in ("qkv", "proj", "fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(
                got["blocks"][site][leaf].numpy(),
                np.asarray(want["blocks"][site][leaf]), atol=1e-6,
                err_msg=f"{site}/{leaf}")


def test_torch_dim_experiment_train_step_matches_jax():
    """One train step of the ablation's default rank (32) at order 5,
    through both packages' ``make_train_step``: loss, accuracy, gradient
    norm and the updated trainables."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup(5, "factorized",
                                                       rank=32)
    rng = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = j_steps.make_optimizer(1e-3, steps_per_epoch=1, total_epochs=20)
    j_frozen, j_state = j_steps.init_train_state(tx, params, cara)
    j_state, jm = jax.jit(j_steps.make_train_step(
        j_cfg, j_cc, tx, attn_impl="fused", dense_impl="fused"))(
            j_state, j_frozen, jb, rng)
    frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1,
                                             total_epochs=20)
    state, m = t_steps.make_train_step(cfg, cc)(
        state, frozen, {k: torch.from_numpy(v) for k, v in batch.items()},
        randomness=jax_randomness(jax.random.fold_in(rng, 0), cfg, B, cc))
    for key in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    want = port_train._flat(j_state.trainable)
    for path, leaf in t_steps.tree_leaves(state.trainable):
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], **TOL,
                                   err_msg=path)


def _capture_fit(monkeypatch, loop, calls):
    def fake_fit(**kw):
        calls.append(kw)
        return {"best_acc": 0.0, "preempted": False, "state": kw["state"]}
    monkeypatch.setattr(loop, "fit", fake_fit)


def _capture_build(monkeypatch, api, calls, build):
    """``api.build_model`` recording its arguments, the model built by
    ``build`` (the port's numpy initializers: JAX's draws would compile
    a kernel for every op; the shapes come from the same registry)."""
    def fake_build(name, **kw):
        calls.append(dict(kw, model=name))
        return build(name, **kw)
    monkeypatch.setattr(api, "build_model", fake_build)


@pytest.mark.parametrize("dims, delta_impl", [(5, "materialized")])
def test_torch_dim_experiment_builds_as_jax(monkeypatch, tmp_path, dims,
                                            delta_impl):
    """Both CLIs build the same model (the arguments of ``build_model``:
    ``--ranks`` / ``--dims`` / ``--delta-impl`` with the task table's
    scale, lambda init, rate and seed) and hand ``fit`` the same
    ablation: eval every 5 epochs from epoch 50, the same adapter
    shapes."""
    from cara_tpu import api as j_api
    from cara_tpu import config as j_config
    from cara_tpu_torch import api as t_api

    port_build = t_api.build_model

    def jax_model(name, **kw):  # the port's arrays in JAX's bundle
        m = port_build(name, **{k: v for k, v in kw.items()
                                if k != "dtype"})
        return j_api.CaraModel(
            j_config.get_model_config(name, num_classes=m.cfg.num_classes,
                                      **(kw.get("model_overrides") or {})),
            j_config.CaraConfig(**dataclasses.asdict(m.cara_cfg)),
            m.params, m.cara_params)

    builds = {"jax": [], "port": []}
    _capture_build(monkeypatch, j_dim.api, builds["jax"], jax_model)
    _capture_build(monkeypatch, t_dim.api, builds["port"], port_build)
    calls = {"jax": [], "port": []}
    _capture_fit(monkeypatch, j_loop, calls["jax"])
    _capture_fit(monkeypatch, t_loop, calls["port"])
    argv = ["--synthetic", "--dataset", "svhn", "--model", "vit_tiny_test",
            "--ranks", "8", "--dims", str(dims), "--delta-impl", delta_impl,
            "--batch-size", "8", "--eval-batch-size", "8",
            "--synthetic-size", "16", "--dtype", "float32", "--backbone",
            str(tmp_path / "none.npz"), "--out-dir", str(tmp_path)]
    j_dim.main(argv)
    t_dim.main(argv + ["--device", "cpu"])
    (j_build,), (t_build,) = builds["jax"], builds["port"]
    assert t_build == j_build
    assert (t_build["cp_order"], t_build["rank"], t_build["delta_impl"]) \
        == (dims, 8, delta_impl)
    (j_kw,), (t_kw,) = calls["jax"], calls["port"]
    for kw in (j_kw, t_kw):
        fc = kw["fit_cfg"]
        assert (fc.eval_every, fc.eval_start) == (5, 50)
    assert (t_dim.EVAL_EVERY, t_dim.EVAL_START) == (5, 50)
    t_cc, j_cc = dataclasses.asdict(t_kw["cara_cfg"]), dataclasses.asdict(
        j_kw["cara_cfg"])
    assert {k: j_cc[k] for k in t_cc} == t_cc
    assert (t_cc["cp_order"], t_cc["rank"], t_cc["delta_impl"]) == (
        dims, 8, delta_impl)
    t_shapes = {p: tuple(v.shape) for p, v in
                t_steps.tree_leaves(t_kw["state"].trainable["cara"])}
    assert t_shapes == {k: tuple(v.shape) for k, v in
                        j_kw["state"].trainable["cara"].items()}
    with pytest.raises(SystemExit, match="fixed to cara"):
        t_dim.main(argv + ["--method", "linear"])
    with pytest.raises(SystemExit, match="ROADMAP.md queue 1: parallelism"):
        t_dim.main(argv + ["--pipeline", "2,2"])


def test_torch_dim_experiment_cli_trains_on_cpu(tmp_path, capsys):
    """``python -m cara_tpu_torch.cli.dim_experiment`` at order 2 (the
    dense deltas) trains and evaluates (its final eval) on the plain
    versions."""
    acc = t_dim.main([
        "--synthetic", "--dataset", "patch_camelyon", "--model",
        "vit_tiny_test", "--ranks", "4", "--dims", "2", "--batch-size", "8",
        "--eval-batch-size", "8", "--synthetic-size", "8", "--dtype",
        "float32", "--backbone", str(tmp_path / "none.npz"), "--out-dir",
        str(tmp_path), "--log-every", "1000", "--epochs", "2",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"Accuracy: {acc}" in out
    assert 0.0 <= acc <= 1.0


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_torch_order_2_bf16_drift_is_no_worse_than_jax():
    """Order 2 under a large delta in bf16: ViT-B's width (E 768, 12
    heads, hidden 3072) at 2 layers, 2 images of 224 px, rank 16, scale
    10, the order-2 factors perturbed at std 0.02 with no 1 / sqrt(E)
    scaling (a qkv delta about 13x the backbone's weights).  One bf16
    eval forward of ``cara_tpu`` (Pallas attention in interpret mode, the
    XLA dense forms order 2 takes) and one of the port, each against its
    own fp32 logits by relative L2: the port's drift is at most the
    larger of 0.05 and 1.5x JAX's, so that bf16 arithmetic, not a rounding
    point of the port, is what moves the logits."""
    over = dict(num_classes=10, depth=2)
    cfg = t_config.get_model_config("vit_base_patch16_224_in21k", **over)
    cc = t_config.CaraConfig(rank=16, scale=10.0, weight_dropout=0.1,
                             cp_order=2)
    j_cfg = j_config.get_model_config("vit_base_patch16_224_in21k", **over)
    j_cc = j_config.CaraConfig(**dataclasses.asdict(cc))
    params = convert.init_vit_params(cfg, 0)
    cara = convert.perturb_adapter(convert.init_cara_params(cfg, cc, 1), 2)
    x = np.random.default_rng(3).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)

    def j_logits(dtype):
        p, c = (j_steps.cast_floating(t, dtype) for t in (params, cara))
        return j_vit.vit_forward(p, jnp.asarray(x, dtype), j_cfg,
                                 cara_params=c, cara_cfg=j_cc,
                                 attn_impl="fused", dense_impl="xla")

    def t_logits(dtype):
        p, c = (t_steps.cast_floating(convert.params_from_numpy(t, "cpu"),
                                      dtype) for t in (params, cara))
        with torch.no_grad():
            return t_vit.vit_forward(p, torch.from_numpy(x).to(dtype), cfg,
                                     c, cc).float().numpy()

    j16, j32 = j_logits(jnp.bfloat16), j_logits(jnp.float32)
    t16, t32 = t_logits(torch.bfloat16), t_logits(torch.float32)
    jax_drift, port_drift = _rel_l2(j16, j32), _rel_l2(t16, t32)
    print(f"order 2, bf16 against fp32 logits, relative L2: cara_tpu "
          f"{jax_drift:.4e}, port {port_drift:.4e}; max|port - cara_tpu| "
          f"fp32 {np.abs(t32 - np.asarray(j32)).max():.4e}, bf16 "
          f"{np.abs(t16 - np.asarray(j16, np.float32)).max():.4e}, "
          f"max|logits| {np.abs(t32).max():.4e}")
    assert np.isfinite(port_drift)
    assert port_drift <= max(0.05, 1.5 * jax_drift), (port_drift, jax_drift)
