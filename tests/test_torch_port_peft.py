"""The port's LoRA and FacT (TT and Tucker) against the JAX package's.

The trees' shapes, counts and init; ``expand_to_lora``; ``vit_forward``'s
logits and every adapter gradient on the element, rank, row and rate-0
routes, in the fused form (the kernels' plain twins, held against JAX's
Pallas kernels in interpret mode) and the XLA form, with JAX's seeds,
gates and masks injected; the merges; one train step; adapter
checkpoints written by one package and read by the other with the method
inferred; a two-task ``MultiTaskPredictor`` of each family; the CLI's
``--lora-alpha`` / ``--fact-scale`` / ``--fact-core-rank``, and a CLI run
whose checkpoint exports merged and serves.  Tiny model, numpy trees
from a seed, fp32 on the CPU, atol = rtol = 1e-4.
"""

import argparse
import dataclasses
import glob

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_dropout import jax_randomness
from test_torch_port_train import _flat
from cara_tpu_torch import serving as t_serving
from cara_tpu_torch.cli import common as t_common
from cara_tpu_torch.cli import export as t_export
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import fact as t_fact
from cara_tpu_torch.models import lora as t_lora
from cara_tpu_torch.models import merge as t_merge
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu_torch.train import steps as t_steps
from cara_tpu import config as j_config
from cara_tpu import serving as j_serving
from cara_tpu.cli import common as j_common
from cara_tpu.models import fact as j_fact
from cara_tpu.models import lora as j_lora
from cara_tpu.models import merge as j_merge
from cara_tpu.models import vit as j_vit
from cara_tpu.train import checkpoint as j_ckpt
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = "vit_tiny_test"
B = 2
METHODS = ("lora", "fact_tt", "fact_tk")
ROUTES = {"element": dict(weight_dropout=0.1),
          "rank": dict(weight_dropout=0.1, weight_dropout_impl="rank"),
          "row": dict(weight_dropout=0.1, weight_dropout_impl="row"),
          "rate0": dict(weight_dropout=0.0)}


def _cc(method, **over):
    kw = dict(method=method, rank=4, scale=1.5,
              fact_core_rank=3 if method == "fact_tk" else 0)
    kw.update(over)
    return CaraConfig(**kw), j_config.CaraConfig(**kw)


def _setup(method, **over):
    """(cfg, cc, params, adapter, batch, j_cfg, j_cc): the adapter's zero
    factor perturbed, so every leaf has a gradient."""
    model_over = dict(num_classes=10, drop_path_rate=0.5)
    cfg = get_model_config(MODEL, **model_over)
    j_cfg = j_config.get_model_config(MODEL, **model_over)
    cc, j_cc = _cc(method, **over)
    params = convert.init_vit_params(cfg, 0)
    adapter = convert.perturb_adapter(
        convert.init_cara_params(cfg, cc, 1), 2, std=0.05)
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, B).astype(np.int32)}
    return cfg, cc, params, adapter, batch, j_cfg, j_cc


@pytest.mark.parametrize("method", METHODS)
def test_torch_peft_trees_match_jax(method):
    """Shapes, counts (ViT-B/16 at rank 8: LoRA 1,179,648, FacT-TT 21,504)
    and the init's zero delta; the family predicates."""
    for name in (MODEL, "vit_base_patch16_224_in21k"):
        kw = dict(method=method, rank=8, weight_dropout=0.0,
                  fact_core_rank=5 if method == "fact_tk" else 0)
        got = CaraConfig(**kw).trainable_param_count(get_model_config(name))
        assert got == j_config.CaraConfig(**kw).trainable_param_count(
            j_config.get_model_config(name)), name
    vit_b = get_model_config("vit_base_patch16_224_in21k")
    want = {"lora": 1_179_648, "fact_tt": 21_504}
    if method in want:
        assert CaraConfig(method=method, rank=8).trainable_param_count(
            vit_b) == want[method]
    cfg = get_model_config(MODEL)
    cc, j_cc = _cc(method)
    tree = convert.init_cara_params(cfg, cc, 1)
    if method == "lora":
        shapes = t_lora.lora_param_shapes(cfg, cc)
        assert shapes == j_lora.lora_param_shapes(cfg, j_cc)
        assert t_lora.is_lora_params(tree) and j_lora.is_lora_params(tree)
        for site, leaves in tree.items():
            assert leaves["a"].shape == shapes[site]["a"]
            bound = 1.0 / np.sqrt(shapes[site]["a"][1])
            assert np.abs(leaves["a"]).max() <= bound and leaves["a"].any()
            assert not leaves["b"].any()  # the delta is exactly 0
    else:
        shapes = t_fact.fact_param_shapes(cfg, cc)
        assert shapes == j_fact.fact_param_shapes(cfg, j_cc)
        assert {k: v.shape for k, v in tree.items()} == shapes
        assert t_fact.detect_method(tree) == j_fact.detect_method(tree) \
            == method
        assert not t_lora.is_lora_params(tree)
        assert not tree["G" if method == "fact_tt" else "C"].any()
        lora = t_fact.expand_to_lora(
            convert.params_from_numpy(tree, "cpu"), cfg, cc)
        assert all(not (d["a"] @ d["b"]).any() for d in lora.values())


@pytest.mark.parametrize("method", ["fact_tt", "fact_tk"])
def test_torch_expand_to_lora_matches_jax(method):
    cfg, cc, _, tree, _, j_cfg, j_cc = _setup(method)
    got = t_fact.expand_to_lora(convert.params_from_numpy(tree, "cpu"), cfg,
                                cc)
    want = j_fact.expand_to_lora(jax.tree.map(jnp.asarray, tree), j_cfg,
                                 j_cc)
    assert _flat(want).keys() == _flat(got).keys()
    for path, val in _flat(want).items():
        leaf = dict(t_steps.tree_leaves(got))[path]
        np.testing.assert_allclose(leaf.numpy(), val, **TOL, err_msg=path)
    with pytest.raises(ValueError, match="core stack"):
        t_fact.expand_to_lora(convert.params_from_numpy(tree, "cpu"), cfg,
                              dataclasses.replace(cc, rank=2))


def _jax_forward_grads(setup, form):
    """JAX's training logits and adapter gradients (``form`` the dense
    form) of a forward whose loss is the logits' weighted sum."""
    _, _, params, tree, batch, j_cfg, j_cc = setup
    x = jnp.asarray(batch["image"])

    def j_loss(adapter):
        logits = j_vit.vit_forward(params, x, j_cfg, cara_params=adapter,
                                   cara_cfg=j_cc, train=True, rng=RNG,
                                   attn_impl="fused", dense_impl=form)
        return (logits * WEIGHTS).sum(), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return np.asarray(logits), _flat(grads)


def _port_forward_grads(setup, form):
    """The port's, with JAX's randomness of that form injected."""
    cfg, cc, params, tree, batch, _, _ = setup
    rand = jax_randomness(RNG, cfg, B, cc, "fused", form)
    adapter = convert.map_floating(convert.params_from_numpy(tree, "cpu"),
                                   lambda t: t.requires_grad_(True))
    logits = t_vit.vit_forward(
        convert.params_from_numpy(params, "cpu"),
        torch.from_numpy(batch["image"]), cfg, cara_params=adapter,
        cara_cfg=cc, train=True, randomness=rand, dense_impl=form)
    (logits * torch.from_numpy(WEIGHTS)).sum().backward()
    return logits.detach(), {p: t.grad
                             for p, t in t_steps.tree_leaves(adapter)}


RNG = jax.random.PRNGKey(7)
WEIGHTS = np.random.default_rng(5).standard_normal((B, 10)).astype(
    np.float32)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("method", METHODS)
def test_torch_peft_vit_forward_and_grads_match_jax(method, route):
    """Training logits and every adapter gradient, in both of the port's
    forms (the fused sites' plain twins, and XLA), with JAX's randomness.
    On the element route each form is held against JAX's same form (the
    fused kernels hash their masks from the seeds, the XLA form masks the
    dense ``A @ B``); on the others both against JAX's fused route (the
    Pallas kernels in interpret mode), whose masks both forms share.
    (The eval logits are held in the checkpoint and multi-task tests.)"""
    setup = _setup(method, **ROUTES[route])
    ref = {"fused": _jax_forward_grads(setup, "fused")}
    ref["xla"] = (_jax_forward_grads(setup, "xla") if route == "element"
                  else ref["fused"])
    for form, (j_logits, j_grads) in ref.items():
        logits, grads = _port_forward_grads(setup, form)
        np.testing.assert_allclose(logits.numpy(), j_logits, **TOL,
                                   err_msg=form)
        assert sorted(grads) == sorted(j_grads)
        for path, g in grads.items():
            assert g is not None and g.abs().sum() > 0, path
            np.testing.assert_allclose(g.numpy(), j_grads[path], **TOL,
                                       err_msg=f"{form} {path}")


@pytest.mark.parametrize("method", METHODS)
def test_torch_peft_merge_matches_jax(method):
    """Every block weight of the merge, and the merged forward equals the
    unmerged one."""
    cfg, cc, params, tree, batch, j_cfg, j_cc = _setup(method)
    tp = convert.params_from_numpy(params, "cpu")
    got = t_merge.merge_cara(tp, convert.params_from_numpy(tree, "cpu"),
                             cfg, cc)
    want = j_merge.merge_cara(params, tree, j_cfg, j_cc)
    for site in ("qkv", "proj", "fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(
                got["blocks"][site][leaf].numpy(),
                np.asarray(want["blocks"][site][leaf]), atol=1e-6,
                rtol=1e-5, err_msg=f"{site}/{leaf}")
    x = torch.from_numpy(batch["image"])
    merged = t_vit.vit_forward(got, x, cfg)
    unmerged = t_vit.vit_forward(tp, x, cfg, convert.params_from_numpy(
        tree, "cpu"), cc)
    np.testing.assert_allclose(merged.numpy(), unmerged.numpy(), **TOL)


@pytest.mark.parametrize("method", ["lora", "fact_tk"])
def test_torch_peft_train_step_matches_jax(method):
    """One ``make_train_step`` step on the rank route (the port's fused
    sites; JAX's XLA form, the same math with the same masks): loss,
    accuracy, grad norm and every updated trainable (AdamW with decay on
    the nested tree) against JAX's step."""
    cfg, cc, params, tree, batch, j_cfg, j_cc = _setup(method,
                                                       **ROUTES["rank"])
    rng = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = j_steps.make_optimizer(1e-3, steps_per_epoch=1, total_epochs=20)
    j_frozen, j_state = j_steps.init_train_state(tx, params, tree)
    j_step = jax.jit(j_steps.make_train_step(
        j_cfg, j_cc, tx, attn_impl="fused", dense_impl="xla"))
    frozen, state = t_steps.init_train_state(params, tree, "cpu", 1e-3, 1,
                                             total_epochs=20, method=method)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    rand = jax_randomness(jax.random.fold_in(rng, 0), cfg, B, cc)
    j_state, jm = j_step(j_state, j_frozen, jb, rng)
    state, m = t_steps.make_train_step(cfg, cc)(state, frozen, tbatch,
                                                randomness=rand)
    for key in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    want = _flat(j_state.trainable)
    got = t_steps.tree_leaves(state.trainable)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, leaf in got:
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], **TOL,
                                   err_msg=path)


@pytest.mark.parametrize("method", METHODS)
def test_torch_peft_checkpoints_cross_load(method, tmp_path):
    """Adapter and full checkpoints each package writes, the other reads,
    with the method, rank, core rank, scale and dropout inferred from
    the tree and the meta (and from the tree alone without a method)."""
    cfg, cc, params, tree, batch, j_cfg, j_cc = _setup(
        method, weight_dropout=0.2, weight_dropout_impl="rank")
    meta = {**dataclasses.asdict(cc), "model": MODEL}
    mine, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    t_ckpt.save_adapter(str(mine), convert.params_from_numpy(tree, "cpu"),
                        params["head"], meta)
    j_ckpt.save_adapter(str(theirs), tree, params["head"], meta)
    for path in (mine, theirs):
        for load in (t_ckpt.load_adapter, j_ckpt.load_adapter):
            got, head, got_meta = load(str(path))
            assert _flat(got).keys() == _flat(tree).keys()
            for key, val in _flat(tree).items():
                np.testing.assert_array_equal(np.asarray(_flat(got)[key]),
                                              val)
        got, _, got_meta = t_ckpt.load_adapter(str(path))
        t_cfg = t_ckpt.infer_cara_cfg(got, got_meta)
        j_got = j_ckpt.infer_cara_cfg(got, got_meta)
        for field in ("method", "rank", "fact_core_rank", "scale",
                      "weight_dropout", "weight_dropout_impl"):
            assert getattr(t_cfg, field) == getattr(j_got, field) \
                == getattr(cc, field), field
        bare = t_ckpt.infer_cara_cfg(got, {"scale": 1.5})
        assert (bare.method, bare.rank) == (method, cc.rank)
    full = tmp_path / "full.npz"
    j_ckpt.save_model(str(full), params, tree, meta)
    pred = t_serving.Predictor.from_checkpoint_auto(
        str(full), MODEL, merge=False, dtype=torch.float32, device="cpu",
        batch_size=B)
    want = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                             cara_params=tree, cara_cfg=j_cc)
    np.testing.assert_allclose(pred.logits(batch["image"]),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_torch_peft_multitask_matches_jax(method):
    """Two tasks of one family at different scales and class counts: each
    task's logits against JAX's group and the port's single-task
    Predictor; mixed families and FacT-TK core ranks refuse."""
    cfg = get_model_config(MODEL, num_classes=0)
    params = convert.init_vit_params(cfg, 3)
    rng = np.random.default_rng(4)
    tasks = {}
    for i, (name, scale, nc) in enumerate((("a", 0.5, 3), ("b", 4.0, 6))):
        cc, _ = _cc(method)
        tasks[name] = {
            "cara": convert.perturb_adapter(
                convert.init_cara_params(cfg, cc, 10 + i), 20 + i, std=0.05),
            "head": {"kernel": (0.1 * rng.standard_normal((64, nc))
                                ).astype(np.float32),
                     "bias": (0.1 * rng.standard_normal(nc)).astype(
                         np.float32)},
            "scale": scale, "cp_order": 4}
    port = t_serving.MultiTaskPredictor(params, cfg, tasks, batch_size=4,
                                        dtype=torch.float32, device="cpu")
    ref = j_serving.MultiTaskPredictor(params, cfg, tasks, batch_size=4,
                                       dtype=jnp.float32)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    for name, task in tasks.items():
        got = port.logits(images, name)
        np.testing.assert_allclose(got, ref.logits(images, name), **TOL)
        one_cfg = dataclasses.replace(cfg,
                                      num_classes=task["head"]["kernel"].shape[1])
        single = t_serving.Predictor(
            dict(params, head=task["head"]), one_cfg,
            cara_params=task["cara"],
            cara_cfg=dataclasses.replace(_cc(method)[0],
                                         scale=task["scale"]), merge=False,
            dtype=torch.float32, device="cpu", batch_size=4)
        np.testing.assert_allclose(got, single.logits(images), **TOL)
    other = "fact_tt" if method == "lora" else "lora"
    mixed = dict(tasks, b=dict(tasks["b"], cara=convert.init_cara_params(
        get_model_config(MODEL), _cc(other)[0], 5)))
    with pytest.raises(ValueError, match="different families"):
        t_serving.MultiTaskPredictor(params, cfg, mixed, device="cpu")
    if method == "fact_tk":
        tk = dict(tasks, b=dict(tasks["b"], cara=convert.init_cara_params(
            get_model_config(MODEL), _cc(method, fact_core_rank=2)[0], 5)))
        with pytest.raises(ValueError, match="core rank"):
            t_serving.MultiTaskPredictor(params, cfg, tk, device="cpu")


@pytest.mark.parametrize("flags", [
    ["--method", "lora"], ["--method", "lora", "--lora-alpha", "16"],
    ["--method", "lora", "--weight-dropout", "0.2"],
    ["--method", "fact_tt"], ["--method", "fact_tt", "--fact-scale", "3"],
    ["--method", "fact_tk", "--fact-core-rank", "5",
     "--weight-dropout-impl", "rank", "--weight-dropout", "0.1"],
    ["--method", "cara", "--fact-core-rank", "5"]])
def test_torch_peft_cli_flags_resolve_as_jax(flags):
    """``adapter_scale_wd`` and the adapter keywords of ``build_model``
    against JAX's; the flags are no longer refused."""
    args = t_cli.parse_args(["--dim", "8", *flags])
    j_args = argparse.Namespace(**vars(args))
    assert t_common.adapter_scale_wd(args, 7.0, 0.3) == \
        j_common.adapter_scale_wd(j_args, 7.0, 0.3)
    want = j_common.adapter_impl_kwargs(j_args)
    assert t_common.adapter_impl_kwargs(args) == want


def test_torch_peft_cli_trains_exports_and_serves(tmp_path):
    """``--method fact_tk --fact-core-rank 2`` trains on the CPU; its
    checkpoint records the method, exports merged, and the merged and
    unmerged Predictors agree; ``--evaluate`` reads it without
    ``--method``."""
    out = tmp_path / "run"
    argv = ["--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
            "--dim", "4", "--epochs", "11", "--batch-size", "8",
            "--eval-batch-size", "8", "--synthetic-size", "16",
            "--dtype", "float32", "--log-every", "1000",
            "--backbone", str(tmp_path / "missing.npz"),
            "--out-dir", str(out), "--device", "cpu"]
    acc = t_cli.main(argv + ["--method", "fact_tk", "--fact-core-rank", "2"])
    (ckpt,) = glob.glob(str(out / "vit_*.npz"))
    _, tree, meta = t_ckpt.load_model(ckpt)
    assert meta["method"] == "fact_tk" and tree["C"].shape == (2, 4, 4)
    merged = str(tmp_path / "merged.npz")
    t_export.main(["--ckpt", ckpt, "--out", merged, "--mode", "merged",
                   "--device", "cpu"])
    images = np.random.default_rng(0).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    kw = dict(dtype=torch.float32, device="cpu", batch_size=4)
    a = t_serving.Predictor.from_checkpoint_auto(ckpt, MODEL, merge=False,
                                                 **kw).logits(images)
    b = t_serving.Predictor.from_checkpoint_auto(merged, MODEL,
                                                 **kw).logits(images)
    np.testing.assert_allclose(a, b, **TOL)
    assert t_cli.main(argv + ["--evaluate", ckpt]) == pytest.approx(acc)
