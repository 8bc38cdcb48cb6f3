"""ViT-H/14's head width, Dh 80, through the port against the JAX package.

``vit_huge_patch14_224_in21k`` has 16 heads of 80 columns, which the
port's attention kernels (rows 1, 2, 16 and 17) take as a 64-column and a
16-column part (``csrc/sm90_common.cuh``, ``HeadTile``); the card's cases
are in ``test_torch_port_cuda.py``.  Here a small ViT-H (patch 14 at 56
px, so 17 tokens; E 160 in two heads of width 80; depth 2) runs on the
CPU through the port's plain versions and through JAX's fused / Pallas
route in interpret mode, as the JAX package's own tests run it:

* the adapter's eval logits;
* one element-route and one rank-route train step: the loss and every
  trainable leaf's gradient, JAX's per-layer seeds, gates and rank masks
  handed to the port;
* one full fine-tuning step (``method="full"``, ``attn_impl="flash"``:
  row 17) with JAX's drop-path gates: the loss and every leaf's
  gradient;
* under ``CARA_ATTN_MEGA=0 CARA_ATTNPROJ=1`` (monkeypatched in both
  packages), where the attention and the projection site are one call
  (``fused_qkv_attention_proj``, TPU rows 3 and 4): the eval logits, one
  rank-route step's loss and every trainable leaf's gradient, and the
  call's forward and cotangents against ``jax.vjp`` at Dh 80 with keys
  past ``n_real`` masked.

Inputs are made with numpy from a seed; fp32, atol = rtol = 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_port_train as port_train
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops.cuda import fused_qkv_attention as t_fqa
from cara_tpu_torch.train import steps as t_steps
from cara_tpu import config as j_config
from cara_tpu.models import vit as j_vit
from cara_tpu.ops.pallas import fused_qkv_attention as j_fqa
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
HUGE = "vit_huge_patch14_224_in21k"
HUGE_OVER = dict(num_classes=10, image_size=56, embed_dim=160, num_heads=2,
                 depth=2)
B = 4


def _setup(impl="element", method="cara"):
    cfg = get_model_config(HUGE, **HUGE_OVER)
    j_cfg = j_config.get_model_config(HUGE, **HUGE_OVER)
    assert cfg.head_dim == 80 and cfg.num_patches + 1 == 17
    if method == "cara":
        cara_cfg = CaraConfig(rank=4, scale=2.0, weight_dropout=0.1,
                              weight_dropout_impl=impl)
    else:
        cara_cfg = CaraConfig(method=method, weight_dropout=0.0)
    params = convert.init_vit_params(cfg, 0)
    cara = (convert.perturb_adapter(convert.init_cara_params(cfg, cara_cfg,
                                                             1), 2, std=0.05)
            if method == "cara" else {})
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((B, 56, 56, 3)).astype(np.float32),
             "label": rng.integers(0, 10, B).astype(np.int32)}
    j_cc = j_config.CaraConfig(**dataclasses.asdict(cara_cfg))
    return cfg, cara_cfg, params, cara, batch, j_cfg, j_cc


def test_small_huge_eval_logits_match_jax():
    """The adapter's eval forward of the small ViT-H: row 1's plain twin
    at Dh 80 against JAX's fused route."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup()
    ref = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                            cara_params=cara, cara_cfg=j_cc)
    with torch.no_grad():
        out = t_vit.vit_forward(convert.params_from_numpy(params, "cpu"),
                                torch.from_numpy(batch["image"]), cfg,
                                cara_params=convert.params_from_numpy(
                                    cara, "cpu"), cara_cfg=cc)
    assert out.shape == (B, 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _grads_against_jax(cfg, cc, params, cara, batch, j_cfg, j_cc, method,
                       attn_impl, dense_impl):
    """One step's loss and trainable-leaf gradients, JAX's against the
    port's with JAX's randomness handed over."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = j_steps.make_optimizer(1e-3, steps_per_epoch=1, total_epochs=20)
    j_frozen, j_state = j_steps.init_train_state(tx, params, cara,
                                                 method=method)
    step_rng = jax.random.fold_in(jax.random.PRNGKey(11), 0)
    adapter = method == "cara"

    def j_loss(trainable):
        logits = j_vit.vit_forward(
            j_steps.merge_params(j_frozen, trainable), jb["image"], j_cfg,
            cara_params=trainable["cara"] if adapter else None,
            cara_cfg=j_cc if adapter else None, train=True, rng=step_rng,
            attn_impl=attn_impl, dense_impl=dense_impl)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jb["label"]).mean()

    j_l, j_g = jax.value_and_grad(j_loss)(j_state.trainable)
    frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1,
                                             total_epochs=20, method=method)
    rand = port_train.jax_randomness(step_rng, cfg, B,
                                     cc if adapter else None)
    loss, _, grads = t_steps.loss_and_grads(
        cfg, cc, state.trainable, frozen,
        {k: torch.from_numpy(v) for k, v in batch.items()}, randomness=rand,
        attn_impl=attn_impl, dense_impl=dense_impl)
    np.testing.assert_allclose(loss.item(), float(j_l), **TOL)
    j_gf = port_train._flat(j_g)
    paths = [p for p, _ in t_steps.tree_leaves(state.trainable)]
    assert sorted(paths) == sorted(j_gf)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), j_gf[path], **TOL,
                                   err_msg=path)
    return rand


@pytest.mark.parametrize("impl", ["element", "rank"])
def test_small_huge_train_step_grads_match_jax(impl):
    """One train step of the small ViT-H on the element or the rank route
    (rows 7 / 8 or 1 / 2 at Dh 80, JAX's fused route): the loss and every
    trainable leaf's gradient."""
    setup = _setup(impl)
    rand = _grads_against_jax(*setup, "cara", "fused", "fused")
    if impl == "rank":
        assert (rand["comp"] == 0).any()  # a dropped rank component


def test_small_huge_full_step_grads_match_jax():
    """One full fine-tuning step of the small ViT-H through the flash
    attention (row 17 at Dh 80) with JAX's drop-path gates: the loss and
    every leaf's gradient against JAX's Pallas flash route."""
    cfg, cc, params, _, batch, j_cfg, j_cc = _setup(method="full")
    cfg = dataclasses.replace(cfg, drop_path_rate=0.5)
    j_cfg = dataclasses.replace(j_cfg, drop_path_rate=0.5)
    rand = _grads_against_jax(cfg, cc, params, {}, batch, j_cfg, j_cc,
                              "full", "flash", "xla")
    assert (rand["gates"] == 0).any()  # a dropped path is exercised


def _attnproj(monkeypatch):
    """``CARA_ATTN_MEGA=0 CARA_ATTNPROJ=1`` on both sides; returns the
    names of the packages whose ``fused_qkv_attention_proj`` was called."""
    for mod in (j_vit, t_vit):
        monkeypatch.setattr(mod, "_ATTN_MEGA", "0")
        monkeypatch.setattr(mod, "_ATTNPROJ", True)
    called = set()
    for tag, mod in (("jax", j_fqa), ("port", t_fqa)):
        fn = mod.fused_qkv_attention_proj

        def spy(*args, _fn=fn, _tag=tag, **kw):
            called.add(_tag)
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, "fused_qkv_attention_proj", spy)
    return called


def test_small_huge_eval_logits_under_attnproj_match_jax(monkeypatch):
    """The adapter's eval forward of the small ViT-H through row 3 at Dh
    80 on both sides."""
    called = _attnproj(monkeypatch)
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup("rank")
    impls = dict(attn_impl="fused", dense_impl="fused")
    ref = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                            cara_params=cara, cara_cfg=j_cc, **impls)
    with torch.no_grad():
        out = t_vit.vit_forward(convert.params_from_numpy(params, "cpu"),
                                torch.from_numpy(batch["image"]), cfg,
                                cara_params=convert.params_from_numpy(
                                    cara, "cpu"), cara_cfg=cc, **impls)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert called == {"jax", "port"}


def test_small_huge_rank_step_under_attnproj_matches_jax(monkeypatch):
    """One rank-route step of the small ViT-H through rows 3 and 4: the
    loss and every trainable leaf's gradient."""
    called = _attnproj(monkeypatch)
    _grads_against_jax(*_setup("rank"), "cara", "fused", "fused")
    assert called == {"jax", "port"}


def test_fused_qkv_attention_proj_dh80_matches_jax_vjp():
    """Rows 3 and 4 at Dh 80 (two heads, E 160, rank 4, delta scale 1.7),
    keys >= 20 of 24 masked: the forward and the cotangents of qkv, the
    bias and the factors against ``jax.vjp`` of the Pallas kernel in
    interpret mode."""
    e, heads, n, n_real, r, s = 160, 2, 24, 20, 4, 1.7
    rng = np.random.default_rng(5)

    def arr(*shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    a = dict(qkv=arr(2, n, 3 * e, std=0.7), w=arr(e, e, std=0.1),
             b=arr(e, std=0.1), u=arr(e, r, std=0.1), v=arr(r, e, std=0.1),
             cb=arr(e, std=0.1), g=arr(2, n, e, std=1.0))
    diff = ("qkv", "b", "u", "v", "cb")
    sm = 80 ** -0.5
    ja = {k: jnp.asarray(v) for k, v in a.items()}

    def j_fn(qkv, b, u, v, cb):
        return j_fqa.fused_qkv_attention_proj(qkv, ja["w"], b, u, v, cb,
                                              heads, sm, n_real, s)

    ref, vjp = jax.vjp(j_fn, *(ja[k] for k in diff))
    ref_grads = vjp(ja["g"])
    ta = {k: torch.from_numpy(v).requires_grad_(k in diff)
          for k, v in a.items()}
    out = t_fqa.fused_qkv_attention_proj(
        ta["qkv"], ta["w"], ta["b"], ta["u"], ta["v"], ta["cb"], heads, sm,
        n_real, s)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    grads = torch.autograd.grad(out, [ta[k] for k in diff], ta["g"])
    for name, got, want in zip(diff, grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=name)
    assert not grads[0][:, :, e:3 * e].reshape(2, n, 2, e)[:, n_real:].any()
