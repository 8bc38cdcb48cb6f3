"""The port's no-adapter training routes -- full fine-tuning and the linear
probe -- against the JAX package's.

The flash attention's plain twin (forward and the q, k, v cotangents)
against the Pallas kernel of ``cara_tpu/ops/pallas/flash_attention.py``
in interpret mode, with q, k and v passed as the transposed views of a
qkv tensor that the model makes; ``vit_forward`` without an adapter, in
training (JAX's drop-path gates injected) and in eval, through the flash
attention (``attn_impl="flash", dense_impl="xla"`` on the JAX side, 17
and 577 tokens) and the fused one; two train steps of ``full`` and of
``linear`` (the whole trainable tree and the AdamW moments); the
trainable split and counts; no-adapter checkpoints written by each
package and read by the other; the CLI with ``--method full`` on the CPU,
whose checkpoint ``cli.serve`` serves, and the refusals.  Inputs are
numpy arrays from a seed, everything fp32, atol = rtol = 1e-4.
"""

import dataclasses
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_port_train as port_train
from test_torch_port_split import _arrays, _close
from cara_tpu_torch import api as t_api
from cara_tpu_torch.cli import common as t_common
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops.cuda import flash_attention as t_flash
from cara_tpu_torch.serving import Predictor
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu_torch.train import steps as t_steps
from cara_tpu import api as j_api
from cara_tpu import config as j_config
from cara_tpu.models import vit as j_vit
from cara_tpu.ops.pallas import flash_attention as j_flash
from cara_tpu.train import checkpoint as j_ckpt
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = "vit_tiny_test"
B = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 96 px in 4-px patches: 24 x 24 patches + cls = 577 tokens, past 512.
OVER_577 = dict(image_size=96, patch_size=4)


def _views(qkv, heads):
    """q, k, v (B, H, N, Dh): ``qkv.reshape(b, n, 3, h, d)`` split and
    transposed, as ``cara_tpu``'s ``_block`` makes them."""
    b, n, e3 = qkv.shape
    return [t.transpose(1, 2)
            for t in qkv.reshape(b, n, 3, heads, e3 // (3 * heads)).unbind(2)]


@pytest.mark.parametrize("n", [64, 70, 197, 577])
def test_torch_flash_attention_matches_jax(n):
    """Output and dq, dk, dv of the plain twin against the Pallas kernel
    and its ``jax.vjp`` (N padded to a multiple of 128 there, not here);
    the port reads strided views of one qkv tensor."""
    b, h, d = 2, 2, 16
    sm = d ** -0.5
    a = _arrays(n, qkv=((b, n, 3 * h * d), 1.0), g=((b, h, n, d), 1.0))
    r = a["qkv"].reshape(b, n, 3, h, d)
    jq, jk, jv = (jnp.asarray(r[:, :, i]).transpose(0, 2, 1, 3)
                  for i in range(3))
    ref, vjp = jax.vjp(lambda q, k, v: j_flash.flash_attention(
        q, k, v, sm, 2, True), jq, jk, jv)
    want = vjp(jnp.asarray(a["g"]))
    qkv = torch.from_numpy(a["qkv"]).requires_grad_(True)
    q, k, v = _views(qkv, h)
    assert not q.is_contiguous()  # strided (B, H, N, Dh) views
    out = t_flash.flash_attention(q, k, v, sm)
    _close(out, ref, "out")
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(a["g"]))
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        _close(got, w, name)


def test_torch_flash_attention_refuses_other_impls():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="impl"):
        t_flash.flash_attention(q, q, q, 0.25, impl="xla")
    with pytest.raises(ValueError, match="B, H, N, Dh"):
        t_flash.flash_attention(q[0], q[0], q[0], 0.25)


def _setup(method, over=None, num_classes=10):
    over = dict(num_classes=num_classes, drop_path_rate=0.5, **(over or {}))
    cfg = get_model_config(MODEL, **over)
    j_cfg = j_config.get_model_config(MODEL, **over)
    params = convert.init_vit_params(cfg, 0)
    rng = np.random.default_rng(3)
    size = cfg.image_size
    batch = {"image": rng.standard_normal((B, size, size, 3)).astype(
        np.float32),
        "label": rng.integers(0, num_classes, B).astype(np.int32)}
    cc = CaraConfig(method=method, weight_dropout=0.0)
    j_cc = j_config.CaraConfig(method=method, weight_dropout=0.0)
    return cfg, cc, params, batch, j_cfg, j_cc


@pytest.mark.parametrize("attn_impl, train, over", [
    ("flash", True, None), ("flash", False, None), ("fused", True, None),
    ("flash", True, OVER_577)], ids=["flash-train", "flash-eval",
                                     "fused-train", "flash-train-577"])
def test_torch_vit_forward_without_adapter_matches_jax(attn_impl, train,
                                                       over):
    """The block without an adapter (``vit.py:779-813`` with drop-path)
    against JAX's ``dense_impl="xla"`` forward, JAX's gates injected."""
    cfg, _, params, batch, j_cfg, _ = _setup("full", over)
    b = 2 if over else B
    x = batch["image"][:b]
    rng = jax.random.PRNGKey(7)
    ref = j_vit.vit_forward(params, jnp.asarray(x), j_cfg, train=train,
                            rng=rng if train else None, attn_impl=attn_impl,
                            dense_impl="xla")
    rand = port_train.jax_randomness(rng, cfg, b) if train else None
    if train:
        assert (rand["gates"] == 0).any()  # a dropped path is exercised
    out = t_vit.vit_forward(convert.params_from_numpy(params, "cpu"),
                            torch.from_numpy(x), cfg, train=train,
                            randomness=rand, attn_impl=attn_impl)
    _close(out, ref, "logits")


def test_torch_vit_forward_refuses_unknown_impls():
    cfg = get_model_config(MODEL)
    cc = CaraConfig(rank=4)
    params = convert.params_from_numpy(convert.init_vit_params(cfg, 0),
                                       "cpu")
    cara = convert.params_from_numpy(convert.init_cara_params(cfg, cc, 1),
                                     "cpu")
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match="attn_impl"):
        t_vit.vit_forward(params, x, cfg, cara, cc, attn_impl="sdpa")
    with pytest.raises(ValueError, match="dense_impl"):
        t_vit.vit_forward(params, x, cfg, dense_impl="cublas")


def _flat(tree):
    return port_train._flat(tree)


@pytest.mark.parametrize("method", ["full", "linear"])
def test_torch_no_adapter_train_steps_match_jax(method):
    """Two steps of ``make_train_step``: loss, accuracy, grad_norm, every
    trainable leaf and its AdamW moments against JAX's
    (``attn_impl="flash"`` for full, ``"fused"`` for linear, as
    ``_resolve_impls`` gives them on the TPU); the linear probe moves only
    the head."""
    cfg, cc, params, batch, j_cfg, j_cc = _setup(method)
    rng = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = j_steps.make_optimizer(1e-3, steps_per_epoch=1, total_epochs=20)
    j_frozen, j_state = j_steps.init_train_state(tx, params, {},
                                                 method=method)
    attn = "flash" if method == "full" else "fused"
    j_step = jax.jit(j_steps.make_train_step(j_cfg, j_cc, tx,
                                             attn_impl=attn))
    frozen, state = t_steps.init_train_state(params, {}, "cpu", 1e-3, 1,
                                             total_epochs=20, method=method)
    paths = [p for p, _ in t_steps.tree_leaves(state.trainable)]
    assert sorted(paths) == sorted(_flat(j_state.trainable))
    if method == "linear":
        assert all(p.startswith("head/") for p in paths)
        before = {p: t.clone() for p, t in t_steps.tree_leaves(frozen)}
    else:
        assert frozen == {} and any(p.startswith("backbone/blocks/")
                                    for p in paths)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_step = t_steps.make_train_step(cfg, cc)
    for step in range(2):
        rand = port_train.jax_randomness(jax.random.fold_in(rng, step), cfg,
                                         B)
        j_state, jm = j_step(j_state, j_frozen, jb, rng)
        state, m = t_step(state, frozen, tbatch, randomness=rand)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                       err_msg=key)
        want = _flat(j_state.trainable)
        adam = j_state.opt_state[0]
        mu, nu = _flat(adam.mu), _flat(adam.nu)
        for path, leaf in t_steps.tree_leaves(state.trainable):
            np.testing.assert_allclose(leaf.detach().numpy(), want[path],
                                       **TOL, err_msg=f"step {step} {path}")
            moments = state.opt.optimizer.state[leaf]
            np.testing.assert_allclose(moments["exp_avg"].numpy(), mu[path],
                                       **TOL, err_msg=f"mu {path}")
            np.testing.assert_allclose(moments["exp_avg_sq"].numpy(),
                                       nu[path], atol=1e-8, rtol=1e-4,
                                       err_msg=f"nu {path}")
    if method == "linear":
        for path, leaf in t_steps.tree_leaves(frozen):
            assert torch.equal(leaf, before[path]), path


@pytest.mark.parametrize("method", ["full", "linear"])
def test_torch_split_merge_and_counts_match_jax(method):
    cfg, _, params, _, j_cfg, _ = _setup(method)
    frozen, trainable = t_steps.split_trainable(params, {}, method)
    j_frozen, j_trainable = j_steps.split_trainable(params, {}, method)
    assert sorted(frozen) == sorted(j_frozen)
    assert sorted(_flat(trainable)) == sorted(_flat(j_trainable))
    merged = t_steps.merge_params(frozen, trainable)
    assert sorted(_flat(merged)) == sorted(_flat(params))
    for name in (MODEL, "vit_base_patch16_224_in21k",
                 "vit_large_patch14_224_clip"):
        want = j_config.CaraConfig(
            method=method, weight_dropout=0.0).trainable_param_count(
            j_config.get_model_config(name, num_classes=7))
        got = CaraConfig(method=method, weight_dropout=0.0
                         ).trainable_param_count(
            get_model_config(name, num_classes=7))
        assert got == want, name
    model = t_api.build_model(MODEL, method=method, num_classes=7, rank=4)
    assert model.cara_params == {} and model.cara_cfg.weight_dropout == 0
    j_model = j_api.build_model(MODEL, method=method, num_classes=7, rank=4)
    assert model.trainable_count == j_model.trainable_count
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_api.build_model(MODEL, method="moe")


def test_torch_no_adapter_checkpoints_cross_load(tmp_path):
    """A full checkpoint (``params/`` only, ``method`` in the meta) that
    each package writes, the other reads; the port serves it as the plain
    backbone, with JAX's eval logits."""
    cfg, _, params, batch, j_cfg, _ = _setup("full")
    meta = {"method": "full", "scale": 1.0, "model": MODEL}
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    t_ckpt.save_model(mine, params, None, meta)
    j_ckpt.save_model(theirs, params, None, meta)
    for path, load in ((mine, j_ckpt.load_model), (theirs,
                                                    t_ckpt.load_model)):
        got, cara, got_meta = load(path)
        assert cara is None and got_meta["method"] == "full"
        want = _flat(params)
        assert sorted(_flat(got)) == sorted(want)
        for k, v in _flat(got).items():
            assert np.array_equal(v, want[k]), k
    pred = Predictor.from_checkpoint_auto(theirs, MODEL, device="cpu",
                                          dtype=torch.float32, batch_size=4)
    ref = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                            attn_impl="fused", dense_impl="xla")
    np.testing.assert_allclose(pred.logits(batch["image"]), np.asarray(ref),
                               **TOL)


def _serve_once(ckpt):
    """Start ``cli.serve --device cpu`` on ``ckpt``, POST one image to
    ``/predict`` and stop it; returns the answer."""
    from test_torch_port_serving import _png

    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cara_tpu_torch.cli.serve", "--ckpt", ckpt,
         "--model", MODEL, "--device", "cpu", "--dtype", "float32",
         "--port", "0", "--max-batch", "4"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("serving on http://"):
                port = int(line.split()[2].rsplit(":", 1)[1])
                break
        assert port is not None, "cli.serve did not start"
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=_png(0), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            return json.loads(r.read())
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def test_torch_cli_full_trains_and_its_checkpoint_serves(tmp_path,
                                                         monkeypatch):
    out = tmp_path / "run"
    argv = ["--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
            "--batch-size", "8", "--eval-batch-size", "8",
            "--synthetic-size", "32", "--dtype", "float32",
            "--backbone", str(tmp_path / "none.npz"), "--out-dir", str(out),
            "--log-every", "1000", "--epochs", "11", "--method", "full"]
    acc = t_cli.main(argv + ["--device", "cpu"])
    files = sorted(out.glob("vit_patch_camelyon_*_seed_89.npz"))
    assert acc > 0 and len(files) == 1
    params, cara, meta = j_ckpt.load_model(str(files[0]))
    assert cara is None and meta["method"] == "full"
    assert meta["weight_dropout"] == 0.0 and meta["scale"] == 1.0
    assert params["blocks"]["qkv"]["kernel"].shape == (2, 64, 192)
    # the whole backbone moved, not only the head
    start = convert.init_vit_params(get_model_config(MODEL), 89)
    assert not np.allclose(params["blocks"]["fc1"]["kernel"],
                           start["blocks"]["fc1"]["kernel"])
    assert _serve_once(str(files[0]))["class"] in (0, 1)
    # --evaluate reads it back through the flash attention
    assert t_cli.main(argv + ["--device", "cpu", "--evaluate",
                              str(files[0])]) == pytest.approx(acc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_cli.main(argv)


@pytest.mark.parametrize("extra, match", [
    (["--method", "full", "--weight-dropout", "0.1"], "does not apply"),
    (["--method", "moe"], "ROADMAP"),
    (["--method", "full", "--dense-impl", "fused"], "backbone-weight"),
    (["--pipeline", "2,4"], "ROADMAP")])
def test_torch_cli_refuses_what_is_not_ported(extra, match):
    with pytest.raises(SystemExit, match=match):
        t_cli.main(["--synthetic", "--device", "cpu", *extra])


def test_torch_resolve_attn_impl_matches_jax():
    """``resolve_impls`` against ``_resolve_impls`` (on a TPU their
    "auto" is "fused"): full fine-tuning takes the flash attention and
    refuses the fused dense sites; "auto" dense is fused with CaRA and
    XLA without an adapter."""
    for method in ("cara", "linear", "full"):
        cc = CaraConfig(method=method,
                        weight_dropout=0.1 if method == "cara" else 0.0)
        j_cc = j_config.CaraConfig(**dataclasses.asdict(cc))
        for impl in ("fused", "flash", "xla"):
            want = j_steps._resolve_impls(impl, "xla", j_cc, None)[:2]
            assert t_steps.resolve_impls(impl, "xla", cc) == want
        assert t_steps.resolve_impls("auto", "auto", cc) == (
            "flash" if method == "full" else "fused",
            "fused" if method == "cara" else "xla")
        if method == "full":
            with pytest.raises(ValueError, match="backbone-weight"):
                t_steps.resolve_impls("auto", "fused", cc)
    assert t_common.adapter_scale_wd(
        type("A", (), {"method": "linear", "weight_dropout": None})(),
        10.0, 0.1) == (1.0, 0.0)
