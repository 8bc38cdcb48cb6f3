"""The port's PEFT zoo (VPT deep / shallow, SSF, BitFit, the Houlsby and
AdaptFormer bottleneck adapters) against the JAX package's.

The trees' shapes, counts and init; ``vit_forward``'s training logits
and every trainable leaf's gradient against ``jax.vjp`` (the fused
attention's plain twin against the Pallas kernel in interpret mode, the
XLA dense forms), with JAX's drop-path gates and adapter-dropout masks
injected; VPT with and without a cls token and past 512 tokens (the
blockwise attention); SSF and BitFit with CLIP's ``ln_pre``; SSF on an
int8 backbone (gamma folded into the dequant scale); the merges and the
merge refusals; one train step a method; checkpoints written by either
package read by the other; the CLI flags, and one CLI run a family.
Tiny model, numpy trees from a seed, fp32 on the CPU, atol = rtol =
1e-4.
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
from cara_tpu_torch import api as t_api
from cara_tpu_torch import serving as t_serving
from cara_tpu_torch.cli import common as t_common
from cara_tpu_torch.cli import export as t_export
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import adapter as t_adapter
from cara_tpu_torch.models import bitfit as t_bitfit
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import merge as t_merge
from cara_tpu_torch.models import ssf as t_ssf
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.models import vpt as t_vpt
from cara_tpu_torch.ops.cuda import blockwise_attention as t_bwa
from cara_tpu_torch.ops.cuda import fused_qkv_attention as t_fqa
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu_torch.train import steps as t_steps
from cara_tpu import api as j_api
from cara_tpu import config as j_config
from cara_tpu import serving as j_serving
from cara_tpu.cli import common as j_common
from cara_tpu.models import adapter as j_adapter
from cara_tpu.models import bitfit as j_bitfit
from cara_tpu.models import merge as j_merge
from cara_tpu.models import ssf as j_ssf
from cara_tpu.models import vit as j_vit
from cara_tpu.models import vpt as j_vpt
from cara_tpu.train import checkpoint as j_ckpt
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = "vit_tiny_test"
B = 2
METHODS = ("vpt_deep", "vpt_shallow", "ssf", "bitfit", "adapter",
           "adaptformer")
RNG = jax.random.PRNGKey(7)
WEIGHTS = np.random.default_rng(5).standard_normal((B, 10)).astype(
    np.float32)


def _cc(method, **over):
    kw = dict(method=method, rank=4, weight_dropout=0.0, vpt_tokens=3,
              scale=0.5 if method == "adaptformer" else 1.0,
              adapter_dropout=(0.1 if method in ("adapter", "adaptformer")
                               else 0.0))
    kw.update(over)
    return CaraConfig(**kw), j_config.CaraConfig(**kw)


def _setup(method, model_over=None, **over):
    """(cfg, cc, params, tree, batch, j_cfg, j_cc): the tree's zero leaves
    (the up projections, BitFit's deltas) and the biases perturbed, so
    every leaf has a gradient and the delta is not the identity."""
    mo = dict(num_classes=10, drop_path_rate=0.5, **(model_over or {}))
    cfg = get_model_config(MODEL, **mo)
    j_cfg = j_config.get_model_config(MODEL, **mo)
    cc, j_cc = _cc(method, **over)
    params = convert.init_vit_params(cfg, 0)
    if cfg.ln_pre:  # not the identity, so that its fold shows
        rng = np.random.default_rng(9)
        params["ln_pre"] = {
            "scale": (1.0 + 0.1 * rng.standard_normal(cfg.embed_dim)
                      ).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(cfg.embed_dim)
                     ).astype(np.float32)}
    tree = convert.perturb_adapter(convert.init_cara_params(cfg, cc, 1), 2,
                                   std=0.05)
    rng = np.random.default_rng(3)
    size = cfg.image_size
    batch = {"image": rng.standard_normal((B, size, size, 3)).astype(
        np.float32), "label": rng.integers(0, 10, B).astype(np.int32)}
    return cfg, cc, params, tree, batch, j_cfg, j_cc


def _leaves(tree):
    return dict(t_steps.tree_leaves(tree))


@pytest.mark.parametrize("method", METHODS)
def test_torch_zoo_trees_match_jax(method):
    """Shapes, counts (tiny and ViT-B/16; CLIP's ``ln_pre`` for SSF and
    BitFit), the init's statistics and zero leaves, the predicates and
    ``detect_method`` against JAX's."""
    for name in (MODEL, "vit_base_patch16_224_in21k",
                 "vit_large_patch14_224_clip"):
        kw = dict(method=method, rank=8, weight_dropout=0.0, vpt_tokens=5)
        got = CaraConfig(**kw).trainable_param_count(get_model_config(name))
        assert got == j_config.CaraConfig(**kw).trainable_param_count(
            j_config.get_model_config(name)), name
    cfg = get_model_config(MODEL)
    cc, j_cc = _cc(method)
    tree = convert.init_cara_params(cfg, cc, 1)
    leaves = _leaves(convert.params_from_numpy(tree, "cpu"))
    assert sum(t.numel() for t in leaves.values()) == \
        cc.trainable_param_count(cfg)
    if method.startswith("vpt"):
        assert t_vpt.vpt_param_shapes(cfg, cc) == j_vpt.vpt_param_shapes(
            cfg, j_cc)
        val = np.sqrt(6.0 / (3 * 8 * 8 + 64))
        assert np.abs(tree["prompts"]).max() <= val
        assert t_vpt.is_vpt_params(tree) and j_vpt.is_vpt_params(tree)
        assert t_vpt.detect_method(tree) == j_vpt.detect_method(tree) \
            == method
        t_vpt.check_geometry(tree, cfg, cc)
        with pytest.raises(ValueError, match="vpt_tokens"):
            t_vpt.check_geometry(tree, cfg, dataclasses.replace(
                cc, vpt_tokens=4))
    elif method == "ssf":
        assert t_ssf.ssf_param_shapes(cfg) == j_ssf.ssf_param_shapes(cfg)
        g = np.concatenate([v.ravel() for k, v in _flat(tree).items()
                            if k.endswith("/g")])
        assert abs(g.mean() - 1.0) < 0.01 and 0.015 < g.std() < 0.025
        assert t_ssf.is_ssf_params(tree) and j_ssf.is_ssf_params(tree)
        ident = t_ssf.identity_ssf_params(cfg)
        want = j_ssf.identity_ssf_params(cfg)
        for path, val in _flat(want).items():
            np.testing.assert_array_equal(_flat(ident)[path], val)
    elif method == "bitfit":
        assert t_bitfit.bitfit_param_shapes(cfg) == \
            j_bitfit.bitfit_param_shapes(cfg)
        assert not any(v.any() for v in _flat(tree).values())
        assert t_bitfit.is_bitfit_params(tree) and \
            j_bitfit.is_bitfit_params(tree)
        t_bitfit.check_geometry(tree, cfg)
        with pytest.raises(ValueError, match="geometry"):
            t_bitfit.check_geometry(tree, get_model_config(MODEL,
                                                           ln_pre=True))
    else:
        assert t_adapter.adapter_param_shapes(cfg, cc) == \
            j_adapter.adapter_param_shapes(cfg, j_cc)
        for site, pair in tree.items():
            if site.endswith("_down"):
                assert 0 < np.abs(pair["kernel"]).max() <= 1 / 8
            else:
                assert not pair["kernel"].any()
            assert not pair["bias"].any()
        assert t_adapter.is_adapter_params(tree) and \
            j_adapter.is_adapter_params(tree)
        assert t_adapter.detect_method(tree) == \
            j_adapter.detect_method(tree) == method
        other = "adaptformer" if method == "adapter" else "adapter"
        with pytest.raises(ValueError, match="other adapter variant"):
            t_adapter.check_geometry(tree, cfg, dataclasses.replace(
                cc, method=other))


def _jax_forward_grads(setup, train=True, dense="xla"):
    """JAX's logits and trainable gradients of a forward whose loss is the
    logits' weighted sum (the fused attention, ``dense`` forms)."""
    _, _, params, tree, batch, j_cfg, j_cc = setup
    x = jnp.asarray(batch["image"])

    def j_loss(adapter):
        logits = j_vit.vit_forward(params, x, j_cfg, cara_params=adapter,
                                   cara_cfg=j_cc, train=train,
                                   rng=RNG if train else None,
                                   attn_impl="fused", dense_impl=dense)
        return (logits * WEIGHTS).sum(), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return np.asarray(logits), _flat(grads)


def _port_forward_grads(setup, train=True, params=None, **kw):
    """The port's, with JAX's randomness injected in training."""
    cfg, cc, np_params, tree, batch, _, _ = setup
    rand = jax_randomness(RNG, cfg, B, cc, "fused", "xla") if train else None
    adapter = convert.map_floating(convert.params_from_numpy(tree, "cpu"),
                                   lambda t: t.requires_grad_(True))
    params = convert.params_from_numpy(
        np_params, "cpu") if params is None else params
    logits = t_vit.vit_forward(params, torch.from_numpy(batch["image"]), cfg,
                               cara_params=adapter, cara_cfg=cc, train=train,
                               randomness=rand, **kw)
    (logits * torch.from_numpy(WEIGHTS)).sum().backward()
    return logits.detach(), {p: t.grad for p, t in _leaves(adapter).items()}


def _check(got, want):
    logits, grads = got
    j_logits, j_grads = want
    np.testing.assert_allclose(logits.numpy(), j_logits, **TOL)
    assert sorted(grads) == sorted(j_grads)
    for path, g in grads.items():
        assert g is not None and g.abs().sum() > 0, path
        np.testing.assert_allclose(g.numpy(), j_grads[path], **TOL,
                                   err_msg=path)


@pytest.mark.parametrize("method", METHODS)
def test_torch_zoo_vit_forward_and_grads_match_jax(method):
    """Training logits and every trainable leaf's gradient, JAX's
    drop-path gates (and, for both bottleneck methods, its
    adapter-dropout masks at rate 0.1) injected.  (The eval logits are
    held in the checkpoint test.)"""
    setup = _setup(method)
    if method in ("adapter", "adaptformer"):
        masks = jax_randomness(RNG, setup[0], B, setup[1])["masks"]
        names = {"adapter": {"ad_attn", "ad_mlp"},
                 "adaptformer": {"ad_mlp"}}[method]
        assert set(masks[0]) == names
        assert not all(m.all() for m in masks[0].values())
    _check(_port_forward_grads(setup), _jax_forward_grads(setup))


@pytest.mark.parametrize("case", ["shallow-meanpool", "deep-517"])
def test_torch_zoo_vpt_routes_match_jax(case, monkeypatch):
    """VPT without a cls token (the prompts stripped before the mean
    pool), and at 485 + 32 = 517 tokens, where the prompts take the
    sequence past 512 onto the blockwise attention (TPU row 16): logits
    and gradients against JAX's, and the attention forms each side
    called recorded."""
    kind, route = case.split("-")
    method = f"vpt_{kind}"
    if route == "meanpool":
        setup = _setup(method, dict(use_cls_token=False))
    else:
        setup = _setup(method, dict(image_size=88, patch_size=4),
                       vpt_tokens=32)
        assert setup[0].seq_len + 32 == 517
    calls = []
    for mod, name in ((t_fqa, "fused_qkv_attention"),
                      (t_bwa, "blockwise_qkv_attention")):
        fn = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _f=fn, _n=name, **k: (calls.append(_n),
                                                        _f(*a, **k))[1])
    _check(_port_forward_grads(setup), _jax_forward_grads(setup))
    long = route == "517"
    assert set(calls) == {"blockwise_qkv_attention" if long
                          else "fused_qkv_attention"}


@pytest.mark.parametrize("method", ["ssf", "bitfit"])
def test_torch_zoo_ln_pre_matches_jax(method):
    """SSF and BitFit on a model with CLIP's ``ln_pre`` and a mean pool:
    the ``ln_pre`` factors fold, logits and gradients against JAX's; a
    tree with ``ln_pre`` factors on a model without one is refused."""
    setup = _setup(method, dict(ln_pre=True, use_cls_token=False))
    assert "ln_pre" in setup[3] or "ln_pre_bias" in setup[3]
    _check(_port_forward_grads(setup), _jax_forward_grads(setup))
    cfg, cc, params, tree, batch = setup[:5]
    plain = convert.init_vit_params(get_model_config(MODEL), 0)
    with pytest.raises(ValueError, match="no ln_pre"):
        t_vit.vit_forward(convert.params_from_numpy(plain, "cpu"),
                          torch.from_numpy(batch["image"]),
                          get_model_config(MODEL, num_classes=10),
                          convert.params_from_numpy(tree, "cpu"), cc)


@pytest.mark.parametrize("merge", [False, True], ids=["unmerged",
                                                      "merged"])
@pytest.mark.parametrize("method", ["ssf", "bitfit"])
def test_torch_zoo_int8_backbone_matches_jax(method, merge):
    """``Predictor(quantize="int8")`` of SSF (gamma folded into the
    per-output-channel dequant scale when unmerged) and BitFit, merged
    and unmerged, against JAX's ``Predictor``; SSF's unmerged fold keeps
    the codes and scales the scale."""
    cfg, cc, params, tree, batch, j_cfg, j_cc = _setup(method)
    kw = dict(cara_params=tree, merge=merge, batch_size=B, quantize="int8")
    got = t_serving.Predictor(params, cfg, cara_cfg=cc, dtype=torch.float32,
                              device="cpu", **kw).logits(batch["image"])
    want = j_serving.Predictor(params, j_cfg, cara_cfg=j_cc,
                               dtype=jnp.float32, **kw).logits(batch["image"])
    np.testing.assert_allclose(got, want, **TOL)
    if method == "ssf" and not merge:
        from cara_tpu_torch.models.quant import quantize_block_weights
        q = quantize_block_weights(convert.params_from_numpy(params, "cpu"))
        folded = t_ssf.apply_ssf(q, convert.params_from_numpy(tree, "cpu"))
        k, kq = folded["blocks"]["fc1"]["kernel"], q["blocks"]["fc1"]["kernel"]
        assert torch.equal(k["q"], kq["q"])
        g = torch.from_numpy(tree["blocks"]["fc1"]["g"])
        assert torch.allclose(k["scale"], kq["scale"] * g[:, None, :])


@pytest.mark.parametrize("method", METHODS)
def test_torch_zoo_merge_matches_jax(method):
    """SSF and BitFit merge exactly (every folded leaf against JAX's, and
    the merged forward equals the unmerged one); VPT and the bottleneck
    adapters raise JAX's errors, and ``Predictor(merge=True)`` serves
    them unmerged."""
    cfg, cc, params, tree, batch, j_cfg, j_cc = _setup(method)
    tp = convert.params_from_numpy(params, "cpu")
    tt = convert.params_from_numpy(tree, "cpu")
    x = torch.from_numpy(batch["image"])
    unmerged = t_vit.vit_forward(tp, x, cfg, tt, cc)
    if method in ("ssf", "bitfit"):
        got = t_merge.merge_cara(tp, tt, cfg, cc)
        want = _flat(j_merge.merge_cara(params, tree, j_cfg, j_cc))
        for path, leaf in _leaves(got).items():
            np.testing.assert_allclose(leaf.numpy(), want[path], atol=1e-6,
                                       rtol=1e-6, err_msg=path)
        merged = t_vit.vit_forward(got, x, cfg)
        np.testing.assert_allclose(merged.numpy(), unmerged.numpy(), **TOL)
    else:
        with pytest.raises(ValueError) as err:
            t_merge.merge_cara(tp, tt, cfg, cc)
        with pytest.raises(ValueError) as j_err:
            j_merge.merge_cara(params, tree, j_cfg, j_cc)
        assert str(err.value) == str(j_err.value)
        pred = t_serving.Predictor(params, cfg, cara_params=tree,
                                   cara_cfg=cc, merge=True, batch_size=B,
                                   dtype=torch.float32, device="cpu")
        assert pred._cara is not None
        np.testing.assert_allclose(pred.logits(batch["image"]),
                                   unmerged.numpy(), **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_torch_zoo_train_step_matches_jax(method):
    """One ``make_train_step`` step (remat "auto": on, the XLA dense
    forms): loss, accuracy, grad norm and every updated trainable
    against JAX's step with the same randomness."""
    cfg, cc, params, tree, batch, j_cfg, j_cc = _setup(method)
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
def test_torch_zoo_checkpoints_cross_load(method, tmp_path):
    """Adapter checkpoints each package writes, the other reads, with the
    method, rank, VPT's token count, scale and adapter dropout inferred
    from the tree and the meta as JAX infers them (from the tree alone
    too, where AdaptFormer refuses the missing scale); a full checkpoint
    of JAX's served unmerged by the port with JAX's eval logits."""
    cfg, cc, params, tree, batch, j_cfg, j_cc = _setup(method)
    meta = {**dataclasses.asdict(cc), "model": MODEL}
    mine, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    t_ckpt.save_adapter(str(mine), convert.params_from_numpy(tree, "cpu"),
                        params["head"], meta)
    j_ckpt.save_adapter(str(theirs), tree, params["head"], meta)
    fields = ("method", "rank", "vpt_tokens", "scale", "adapter_dropout",
              "weight_dropout")
    for path in (mine, theirs):
        for load in (t_ckpt.load_adapter, j_ckpt.load_adapter):
            got, _, _ = load(str(path))
            assert _flat(got).keys() == _flat(tree).keys()
            for key, val in _flat(tree).items():
                np.testing.assert_array_equal(np.asarray(_flat(got)[key]),
                                              val)
        got, _, got_meta = t_ckpt.load_adapter(str(path))
        for m in (got_meta, {}):
            if method == "adaptformer" and not m:
                for infer in (t_ckpt.infer_cara_cfg, j_ckpt.infer_cara_cfg):
                    with pytest.raises(ValueError, match="adaptformer"):
                        infer(got, m)
                continue
            t_cfg = t_ckpt.infer_cara_cfg(got, m)
            j_got = j_ckpt.infer_cara_cfg(got, m)
            for field in fields:
                assert getattr(t_cfg, field) == getattr(j_got, field), field
            if m:
                for field in ("method", "scale", "adapter_dropout"):
                    assert getattr(t_cfg, field) == getattr(cc, field)
                if method.startswith("vpt"):
                    assert t_cfg.vpt_tokens == cc.vpt_tokens
    full = tmp_path / "full.npz"
    j_ckpt.save_model(str(full), params, tree, meta)
    pred = t_serving.Predictor.from_checkpoint_auto(
        str(full), MODEL, dtype=torch.float32, device="cpu", batch_size=B)
    want = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                             cara_params=tree, cara_cfg=j_cc)
    np.testing.assert_allclose(pred.logits(batch["image"]),
                               np.asarray(want), **TOL)


def test_torch_zoo_api_and_refusals_match_jax():
    """``build_model`` for the six methods (trees' shapes, AdaptFormer's
    default dropout 0.1, Houlsby's 0) against JAX's; the bottleneck
    adapters refuse ``dense_impl="fused"`` with JAX's message; a
    one-family multi-task group of zoo trees raises JAX's error."""
    for method in METHODS:
        model = t_api.build_model(MODEL, method=method, num_classes=7,
                                  rank=4, vpt_tokens=2)
        j_model = j_api.build_model(MODEL, method=method, num_classes=7,
                                    rank=4, vpt_tokens=2)
        assert model.cara_cfg == CaraConfig(**dataclasses.asdict(
            j_model.cara_cfg))
        assert {k: v.shape for k, v in _flat(model.cara_params).items()} \
            == {k: v.shape for k, v in _flat(j_model.cara_params).items()}
        assert model.trainable_count == j_model.trainable_count
    for method in ("adapter", "adaptformer"):
        cfg, cc, params, tree, batch, j_cfg, j_cc = _setup(method)
        with pytest.raises(ValueError) as err:
            t_vit.vit_forward(convert.params_from_numpy(params, "cpu"),
                              torch.from_numpy(batch["image"]), cfg,
                              convert.params_from_numpy(tree, "cpu"), cc,
                              dense_impl="fused")
        with pytest.raises(ValueError) as j_err:
            j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                              cara_params=tree, cara_cfg=j_cc,
                              dense_impl="fused")
        assert str(err.value) == str(j_err.value)
    for method in METHODS:
        assert t_vit.resolve_impls("auto", "auto", _cc(method)[0]) == (
            "fused", "xla")


@pytest.mark.parametrize("flags", [
    ["--method", "vpt_deep", "--vpt-tokens", "5"], ["--method", "vpt_shallow"],
    ["--method", "ssf"], ["--method", "bitfit"], ["--method", "adapter"],
    ["--method", "adapter", "--adapter-scale", "2", "--adapter-dropout",
     "0.2"],
    ["--method", "adaptformer"],
    ["--method", "adaptformer", "--adapter-dropout", "0"],
    ["--method", "cara", "--vpt-tokens", "5", "--adapter-scale", "3"]])
def test_torch_zoo_cli_flags_resolve_as_jax(flags):
    """``adapter_scale_wd`` and the adapter keywords of ``build_model``
    against JAX's; the flags are no longer refused, and
    ``--weight-dropout`` is refused for every zoo method as JAX refuses
    it."""
    args = t_cli.parse_args(["--dim", "8", *flags])
    j_args = argparse.Namespace(**vars(args))
    assert t_common.adapter_scale_wd(args, 7.0, 0.3) == \
        j_common.adapter_scale_wd(j_args, 7.0, 0.3)
    assert t_common.adapter_impl_kwargs(args) == \
        j_common.adapter_impl_kwargs(j_args)
    if args.method != "cara":
        args.weight_dropout = j_args.weight_dropout = 0.1
        for resolve, a in ((t_common.adapter_scale_wd, args),
                           (j_common.adapter_scale_wd, j_args)):
            with pytest.raises(SystemExit, match="does not apply"):
                resolve(a, 7.0, 0.3)


@pytest.mark.parametrize("method", ["vpt_shallow", "ssf", "adaptformer"])
def test_torch_zoo_cli_trains_and_serves(method, tmp_path):
    """``cli.vit_cp --method X --synthetic`` on the CPU, one method a
    family: its checkpoint records the method; SSF exports merged (equal
    to unmerged), VPT and AdaptFormer refuse ``--mode merged``;
    ``--evaluate`` reads it without ``--method``."""
    out = tmp_path / "run"
    argv = ["--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
            "--dim", "4", "--epochs", "11", "--batch-size", "8",
            "--eval-batch-size", "8", "--synthetic-size", "16",
            "--dtype", "float32", "--log-every", "1000",
            "--backbone", str(tmp_path / "missing.npz"),
            "--out-dir", str(out), "--device", "cpu"]
    acc = t_cli.main(argv + ["--method", method, "--vpt-tokens", "2"])
    (ckpt,) = glob.glob(str(out / "vit_*.npz"))
    _, tree, meta = t_ckpt.load_model(ckpt)
    assert meta["method"] == method
    merged = str(tmp_path / "merged.npz")
    export = ["--ckpt", ckpt, "--out", merged, "--mode", "merged",
              "--device", "cpu"]
    kw = dict(dtype=torch.float32, device="cpu", batch_size=4)
    if method == "ssf":
        t_export.main(export)
        images = np.random.default_rng(0).standard_normal(
            (3, 32, 32, 3)).astype(np.float32)
        a = t_serving.Predictor.from_checkpoint_auto(
            ckpt, MODEL, merge=False, **kw).logits(images)
        b = t_serving.Predictor.from_checkpoint_auto(merged, MODEL,
                                                     **kw).logits(images)
        np.testing.assert_allclose(a, b, **TOL)
    else:
        with pytest.raises(SystemExit, match="cannot fold"):
            t_export.main(export)
    assert t_cli.main(argv + ["--evaluate", ckpt]) == pytest.approx(acc)
