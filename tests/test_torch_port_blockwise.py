"""The port's 384-px route against the JAX package's: the blockwise
attention, the split element-dropout sites, TPU row 15, and the forward
and train step at 577 tokens.

``blockwise_qkv_attention`` (forward, log-sum-exp and the qkv cotangent)
against the Pallas kernel in interpret mode; ``cp_dense_wd`` /
``cp_dense_ln_wd`` (forward and the x, u, v, cb cotangents) against
``jax.vjp``; row 15's plain twin against ``_cp_wd_factor_grads``; then
``vit_forward`` at N = 577 (``vit_tiny_test`` at 96 px with 4-px patches,
24 x 24 + 1 tokens) in eval with the adapter kept and merged, in training
for the element and rank routes with JAX's seeds, gates and masks
injected, one train step's gradients, and the CLI.  JAX pads the 577
tokens to 584 and to 640 for the qkv site and masks keys at 577; the port
does not pad.  Inputs are numpy arrays from a seed, everything fp32,
atol = rtol = 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import test_torch_port_train as port_train
from test_torch_port_split import _arrays, _close
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops.cuda import blockwise_attention as t_bwa
from cara_tpu_torch.ops.cuda import cp_dense as t_dense
from cara_tpu_torch.ops.cuda import wd_fold as t_wd
from cara_tpu_torch.train import steps as t_steps
from cara_tpu import config as j_config
from cara_tpu.models import merge as j_merge
from cara_tpu.models import vit as j_vit
from cara_tpu.ops.pallas import blockwise_attention as j_bwa
from cara_tpu.ops.pallas import cp_dense as j_dense
from cara_tpu.train import checkpoint as j_ckpt
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
E, HEADS, R, B = 64, 4, 4, 2
EPS = 1e-6
RATE = 0.3
MODEL = "vit_tiny_test"
# 96 px in 4-px patches: 24 x 24 patches + cls = 577 tokens, past 512.
OVER = dict(image_size=96, patch_size=4)


@pytest.mark.parametrize("np_, n_real", [(256, 200), (128, 128)])
def test_torch_blockwise_attention_matches_jax(np_, n_real):
    """Forward, lse and dqkv against the Pallas kernel (128 x 128 tiles);
    the cotangent is zero on the rows at or past ``n_real``."""
    sm = (E // HEADS) ** -0.5
    a = _arrays(1, qkv=((B, np_, 3 * E), 0.7), g=((B, np_, E), 1.0))
    a["g"][:, n_real:] = 0.0
    jq = jnp.asarray(a["qkv"])

    def j_fn(q):
        return j_bwa.blockwise_qkv_attention(q, HEADS, sm, n_real, 1, 128,
                                             128)

    ref, vjp = jax.vjp(j_fn, jq)
    (ref_grad,) = vjp(jnp.asarray(a["g"]))
    _, (_, _, ref_lse) = j_bwa._fwd(jq, HEADS, sm, n_real, 1, 128, 128, None)
    qkv = torch.from_numpy(a["qkv"]).requires_grad_(True)
    out = t_bwa.blockwise_qkv_attention(qkv, HEADS, sm, n_real)
    _close(out, ref, "out")
    _, lse = t_bwa.blockwise_attention_fwd_plain(qkv.detach(), HEADS, sm,
                                                 n_real)
    _close(lse, np.asarray(ref_lse)[..., :HEADS], "lse")
    (grad,) = torch.autograd.grad(out, [qkv], torch.from_numpy(a["g"]))
    _close(grad, ref_grad, "dqkv")
    assert t_bwa.LAUNCHES == t_bwa.BWD_LAUNCHES == 0  # CPU: no kernel


DENSE_DIFF = ("x", "u", "v", "cb")


@pytest.mark.parametrize("ln, n_out, s", [(True, 3 * E, 1.0),
                                          (False, E, 1.5)])
def test_torch_cp_dense_wd_matches_jax_vjp(ln, n_out, s):
    """The element-dropout sites at rate 0.3 on 37 tokens: forward and
    the x, u, v, cb cotangents (the mask from one int32 seed)."""
    a = _arrays(2, x=((B, 37, E), 1.2), w=((E, n_out), 0.08),
                b=((n_out,), 0.05), u=((E, R), 0.2), v=((R, n_out), 0.2),
                cb=((n_out,), 0.1), ls=((E,), 0.1, 1.0), lb=((E,), 0.1),
                g=((B, 37, n_out), 1.0))
    seed = np.array([[-123456789]], np.int32)
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jseed = jnp.asarray(seed)

    def j_fn(x, u, v, cb):
        if ln:
            return j_dense.cp_dense_ln_wd(x, ja["w"], ja["b"], u, v, cb,
                                          ja["ls"], ja["lb"], jseed, s, RATE,
                                          256, 1024, 768, None, None, EPS)
        return j_dense.cp_dense_wd(x, ja["w"], ja["b"], u, v, cb, jseed, s,
                                   RATE)

    ref, vjp = jax.vjp(j_fn, *(ja[k] for k in DENSE_DIFF))
    ref_grads = vjp(ja["g"])
    ta = {k: torch.from_numpy(v).requires_grad_(k in DENSE_DIFF)
          for k, v in a.items()}
    tseed = torch.from_numpy(seed)
    args = (ta["x"], ta["w"], ta["b"], ta["u"], ta["v"], ta["cb"])
    if ln:
        out = t_dense.cp_dense_ln_wd(*args, ta["ls"], ta["lb"], tseed, s,
                                     RATE, EPS)
    else:
        out = t_dense.cp_dense_wd(*args, tseed, s, RATE)
    _close(out, ref)
    grads = torch.autograd.grad(out, [ta[k] for k in DENSE_DIFF], ta["g"])
    for name, got, want in zip(DENSE_DIFF, grads, ref_grads):
        _close(got, want, name)
    assert t_dense.WD_LAUNCHES == t_dense.WD_BWD_LAUNCHES == 0


def test_torch_cp_wd_factor_grads_plain_matches_jax_kernel():
    """Row 15's plain twin against ``_cp_wd_factor_grads``: 74 rows (off
    the 256-row tile), K 64, N 192, rank 4, rate 0.3, scale 2."""
    m, k, n, s = 74, E, 3 * E, 2.0
    a = _arrays(3, x=((m, k), 1.0), g=((m, n), 1.0), u=((k, R), 0.2),
                v=((R, n), 0.2))
    seed = np.array([[987654321]], np.int32)
    ja = {key: jnp.asarray(v) for key, v in a.items()}
    du_ref, dv_ref = j_dense._cp_wd_factor_grads(
        ja["x"], ja["g"], ja["u"], ja["v"], jnp.asarray(seed), s, RATE, 256,
        k, n, None)
    t = {key: torch.from_numpy(v) for key, v in a.items()}
    du, dv = t_wd.cp_wd_factor_grads(t["x"], t["g"], t["u"], t["v"],
                                     torch.from_numpy(seed), s, RATE)
    _close(du, du_ref, "du")
    _close(dv, dv_ref, "dv")
    assert t_wd.FACTOR_LAUNCHES == 0


def _setup577(**cara_over):
    """``port_train._setup`` at 577 tokens, batch 2."""
    over = dict(num_classes=10, drop_path_rate=0.5, **OVER)
    cfg = get_model_config(MODEL, **over)
    cara_cfg = CaraConfig(**{"rank": 4, "scale": 2.0, "weight_dropout": 0.1,
                             **cara_over})
    params = convert.init_vit_params(cfg, 0)
    cara = convert.perturb_adapter(
        convert.init_cara_params(cfg, cara_cfg, 1), 2, std=0.05)
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((B, 96, 96, 3)).astype(np.float32),
             "label": rng.integers(0, 10, B).astype(np.int32)}
    j_cfg = j_config.get_model_config(MODEL, **over)
    j_cc = j_config.CaraConfig(**dataclasses.asdict(cara_cfg))
    return cfg, cara_cfg, params, cara, batch, j_cfg, j_cc


@pytest.mark.parametrize("adapter", [True, False], ids=["adapter", "merged"])
def test_torch_vit_forward_577_tokens_matches_jax(adapter):
    """Eval at N = 577: the adapter kept (the split sites and the
    blockwise attention) and merged into the backbone (GEMMs and the
    blockwise attention)."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup577()
    assert cfg.num_patches + 1 == 577
    x = jnp.asarray(batch["image"])
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jc = jax.tree_util.tree_map(jnp.asarray, cara)
    if adapter:
        ref = j_vit.vit_forward(jp, x, j_cfg, cara_params=jc, cara_cfg=j_cc,
                                attn_impl="fused", dense_impl="fused")
        tkw = dict(cara_params=convert.params_from_numpy(cara, "cpu"),
                   cara_cfg=cc)
    else:
        merged = j_merge.merge_cara(jp, jc, j_cfg, j_cc)
        ref = j_vit.vit_forward(merged, x, j_cfg, attn_impl="fused",
                                dense_impl="xla")
        params, tkw = jax.device_get(merged), {}
    tp = convert.params_from_numpy(params, "cpu")
    for impl in ("auto", "plain"):
        out = t_vit.vit_forward(tp, torch.from_numpy(batch["image"]), cfg,
                                impl=impl, **tkw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["element", "rank"])
def test_torch_vit_forward_train_577_tokens_matches_jax(impl):
    """The training forward at N = 577 with JAX's randomness injected:
    the element route through the split wd sites, the rank route through
    the split sites, both with the blockwise attention."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup577(
        weight_dropout_impl=impl)
    rng = jax.random.PRNGKey(7)
    ref = j_vit.vit_forward(jax.tree_util.tree_map(jnp.asarray, params),
                            jnp.asarray(batch["image"]), j_cfg,
                            cara_params=jax.tree_util.tree_map(
                                jnp.asarray, cara),
                            cara_cfg=j_cc, train=True, rng=rng,
                            attn_impl="fused", dense_impl="fused")
    rand = port_train.jax_randomness(rng, cfg, B, cc)
    assert (rand["gates"] == 0).any()  # a dropped path is exercised
    out = t_vit.vit_forward(
        convert.params_from_numpy(params, "cpu"),
        torch.from_numpy(batch["image"]), cfg,
        cara_params=convert.params_from_numpy(cara, "cpu"), cara_cfg=cc,
        train=True, randomness=rand)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_torch_train_step_grads_577_tokens_match_jax():
    """One element-dropout train step at N = 577: the loss and every
    trainable leaf's gradient."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup577()
    rng = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = j_steps.make_optimizer(1e-3, steps_per_epoch=1, total_epochs=20)
    j_frozen, j_state = j_steps.init_train_state(tx, params, cara)

    def j_loss(trainable):
        logits = j_vit.vit_forward(
            j_steps.merge_params(j_frozen, trainable), jb["image"], j_cfg,
            cara_params=trainable["cara"], cara_cfg=j_cc, train=True,
            rng=rng, attn_impl="fused", dense_impl="fused")
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jb["label"]).mean()

    j_l, j_g = jax.value_and_grad(j_loss)(j_state.trainable)
    frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1,
                                             total_epochs=20)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = t_steps.loss_and_grads(
        cfg, cc, state.trainable, frozen, tbatch,
        randomness=port_train.jax_randomness(rng, cfg, B))
    np.testing.assert_allclose(loss.item(), float(j_l), **TOL)
    j_gf = port_train._flat(j_g)
    paths = [p for p, _ in t_steps.tree_leaves(state.trainable)]
    assert sorted(paths) == sorted(j_gf)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), j_gf[path], **TOL,
                                   err_msg=path)


def test_torch_cli_trains_at_577_tokens_on_cpu(tmp_path):
    out = tmp_path / "run"
    acc = t_cli.main([
        "--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
        "--model-override", "image_size=96", "--model-override",
        "patch_size=4", "--batch-size", "8", "--eval-batch-size", "8",
        "--synthetic-size", "8", "--dtype", "float32", "--backbone",
        str(tmp_path / "none.npz"), "--out-dir", str(out), "--log-every",
        "1000", "--dim", "4", "--epochs", "11", "--device", "cpu"])
    files = sorted(out.glob("vit_patch_camelyon_*_seed_89.npz"))
    assert acc > 0 and len(files) == 1
    params, _, meta = j_ckpt.load_model(str(files[0]))
    assert meta["model_overrides"] == OVER
    assert params["pos_embed"].shape == (1, 577, E)
