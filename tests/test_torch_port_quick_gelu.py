"""The quick_gelu modes of the port's kernels against the JAX package.

CLIP ViT-L/14 (``vit_large_patch14_224_clip``) runs its MLP blocks with
``act="quick_gelu"``, ``y sigmoid(1.702 y)``, which JAX fuses into the
Pallas kernels of TPU rows 9, 10, 11, 13 and 19.  On the CPU the port
runs the plain twins of those kernels (the card's are in
``test_torch_port_cuda.py``), JAX its Pallas kernels in interpret mode:

* rows 9 and 10 (``cp_mlp_block``) and rows 9 and 11
  (``cp_mlp_block_wd``), the forward and every ``jax.vjp`` cotangent, in
  the recompute form and in the save-pre form (``_SAVE_PRE`` forced on
  both sides, as in ``test_torch_port_saved.py``);
* row 19's plain twin against ``block_pair_fwd(act="quick_gelu")``;
* the slice as a whole: a small CLIP model (patch 14 at 56 px, E 64, 4
  heads, depth 2, ``ln_pre``, quick_gelu, ``proj_dim`` 48, LayerNorm eps
  1e-5): its eval logits with the adapter, and one element step's and
  one rank step's loss and trainable-leaf gradients, with JAX's
  randomness handed to the port.

Inputs are made with numpy from a seed; fp32, atol = rtol = 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_port_saved as saved_tests
import test_torch_port_train as port_train
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops.cuda import cp_mlp as t_mlp
from cara_tpu_torch.train import steps as t_steps
from cara_tpu import config as j_config
from cara_tpu.models import vit as j_vit
from cara_tpu.ops.pallas import cp_mlp as j_mlp
from cara_tpu.ops.pallas.block_pair import block_pair_fwd as j_pair
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
ACT = "quick_gelu"
EPS = 1e-5
MLP_ARGS, MLP_DIFF = saved_tests.MLP_ARGS, saved_tests.MLP_DIFF
CLIP = "vit_large_patch14_224_clip"
CLIP_OVER = dict(num_classes=10, image_size=56, patch_size=14, embed_dim=64,
                 depth=2, num_heads=4, proj_dim=48)
B = 4


@pytest.fixture(params=["recompute", "saved"])
def form(request, monkeypatch):
    """The MLP block's residual form, the same on both sides."""
    flag = "1" if request.param == "saved" else "0"
    for mod in (j_mlp, t_mlp):
        monkeypatch.setattr(mod, "_SAVE_PRE", flag)
    return request.param


def _mlp_case(seed, n):
    m = saved_tests._mlp_arrays(seed, n)
    jm = {k: jnp.asarray(v) for k, v in m.items()}
    tm = {k: torch.from_numpy(v).requires_grad_(k in MLP_DIFF)
          for k, v in m.items()}
    return jm, tm


def _against_jax(j_fn, t_fn, jm, tm):
    ref, vjp = jax.vjp(j_fn, *(jm[k] for k in MLP_DIFF))
    ref_grads = vjp(jm["g"])
    out = t_fn(*(tm[k] for k in MLP_ARGS))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    grads = torch.autograd.grad(out, [tm[k] for k in MLP_DIFF], tm["g"])
    saved_tests._check_grads(grads, ref_grads, MLP_DIFF)


@pytest.mark.parametrize("n, zero_gate", [(37, False), (16, True)])
def test_cp_mlp_block_quick_gelu_matches_jax(form, n, zero_gate):
    """Rows 9 and 10 with quick_gelu: ``cp_mlp_block``'s forward and
    every cotangent against ``jax.vjp`` of JAX's kernels."""
    jm, tm = _mlp_case(16, n)
    dpm = saved_tests._gate(zero_gate).reshape(2, 1, 1)

    def j_fn(x, u1, v1, cb1, u2, v2, cb2):
        return j_mlp.cp_mlp_block(
            x, jm["w1"], jm["b1"], u1, v1, cb1, jm["w2"], jm["b2"], u2, v2,
            cb2, jm["ls"], jm["lb"], jnp.asarray(dpm), 1.0, 256, None, ACT,
            EPS)

    def t_fn(*args):
        return t_mlp.cp_mlp_block(*args, torch.from_numpy(dpm), 1.0, ACT,
                                  EPS)

    _against_jax(j_fn, t_fn, jm, tm)


@pytest.mark.parametrize("n, zero_gate", [(37, False), (16, True)])
def test_cp_mlp_block_wd_quick_gelu_matches_jax(form, n, zero_gate):
    """Rows 9 and 11 with quick_gelu: ``cp_mlp_block_wd`` (exact element
    weight dropout) against ``jax.vjp`` of JAX's kernels."""
    jm, tm = _mlp_case(17, n)
    dpm = saved_tests._gate(zero_gate).reshape(2, 1, 1)
    (ts1, ts2), (js1, js2) = saved_tests._seeds()

    def j_fn(x, u1, v1, cb1, u2, v2, cb2):
        return j_mlp.cp_mlp_block_wd(
            x, jm["w1"], jm["b1"], u1, v1, cb1, jm["w2"], jm["b2"], u2, v2,
            cb2, jm["ls"], jm["lb"], jnp.asarray(dpm), js1, js2, 1.0,
            saved_tests.RATE, 256, None, ACT, EPS)

    def t_fn(*args):
        return t_mlp.cp_mlp_block_wd(*args, torch.from_numpy(dpm), ts1, ts2,
                                     1.0, saved_tests.RATE, ACT, EPS)

    _against_jax(j_fn, t_fn, jm, tm)


@pytest.mark.parametrize("s", [1.0, 1.3], ids=["s1", "s1.3"])
def test_block_pair_quick_gelu_matches_jax(s):
    """Row 19's plain twin with quick_gelu against the Pallas kernel on
    the real rows (keys past ``n_real`` masked on both sides)."""
    import test_torch_port_block_pair as pair_tests

    x, weights, sm, s = pair_tests._inputs(3, s)
    want = np.asarray(j_pair(jnp.asarray(x), *map(jnp.asarray, weights),
                             pair_tests.HEADS, sm, pair_tests.NREAL, s, 2,
                             ACT, EPS, True))
    got = pair_tests._port(x, weights, sm, s, act=ACT, ln_eps=EPS)
    n = pair_tests.NREAL
    np.testing.assert_allclose(got[:, :n], want[:, :n], **TOL)
    gelu = pair_tests._port(x, weights, sm, s, ln_eps=EPS)
    assert not np.allclose(gelu[:, :n], got[:, :n], **TOL)


def _clip_setup(impl):
    cfg = get_model_config(CLIP, **CLIP_OVER)
    j_cfg = j_config.get_model_config(CLIP, **CLIP_OVER)
    assert (cfg.activation, cfg.ln_pre, cfg.layernorm_eps) == (ACT, True,
                                                                EPS)
    cara_cfg = CaraConfig(rank=4, scale=2.0, weight_dropout=0.1,
                          weight_dropout_impl=impl)
    params = convert.init_vit_params(cfg, 0)
    cara = convert.perturb_adapter(
        convert.init_cara_params(cfg, cara_cfg, 1), 2, std=0.05)
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((B, 56, 56, 3)).astype(np.float32),
             "label": rng.integers(0, 10, B).astype(np.int32)}
    j_cc = j_config.CaraConfig(**dataclasses.asdict(cara_cfg))
    return cfg, cara_cfg, params, cara, batch, j_cfg, j_cc


def test_small_clip_eval_logits_match_jax():
    """The adapter's eval forward of the small CLIP model (``ln_pre``, the
    quick_gelu MLP blocks, the 48-wide projection, the head)."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = _clip_setup("element")
    assert "ln_pre" in params and "proj_out" in params
    ref = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                            cara_params=cara, cara_cfg=j_cc)
    with torch.no_grad():
        out = t_vit.vit_forward(convert.params_from_numpy(params, "cpu"),
                                torch.from_numpy(batch["image"]), cfg,
                                cara_params=convert.params_from_numpy(
                                    cara, "cpu"), cara_cfg=cc)
    assert out.shape == (B, 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["element", "rank"])
def test_small_clip_train_step_grads_match_jax(impl):
    """One train step of the small CLIP model on the element or the rank
    route: the loss and every trainable leaf's gradient against JAX's
    fused route, its per-layer seeds (and rank masks) handed to the
    port."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = _clip_setup(impl)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = j_steps.make_optimizer(1e-3, steps_per_epoch=1, total_epochs=20)
    j_frozen, j_state = j_steps.init_train_state(tx, params, cara)
    step_rng = jax.random.fold_in(jax.random.PRNGKey(11), 0)

    def j_loss(trainable):
        logits = j_vit.vit_forward(
            j_steps.merge_params(j_frozen, trainable), jb["image"], j_cfg,
            cara_params=trainable["cara"], cara_cfg=j_cc, train=True,
            rng=step_rng, attn_impl="fused", dense_impl="fused")
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jb["label"]).mean()

    j_l, j_g = jax.value_and_grad(j_loss)(j_state.trainable)
    frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1,
                                             total_epochs=20)
    rand = port_train.jax_randomness(step_rng, cfg, B, cc)
    if impl == "rank":
        assert (rand["comp"] == 0).any()  # a dropped rank component
    loss, _, grads = t_steps.loss_and_grads(
        cfg, cc, state.trainable, frozen,
        {k: torch.from_numpy(v) for k, v in batch.items()}, randomness=rand)
    np.testing.assert_allclose(loss.item(), float(j_l), **TOL)
    j_gf = port_train._flat(j_g)
    paths = [p for p, _ in t_steps.tree_leaves(state.trainable)]
    assert sorted(paths) == sorted(j_gf)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), j_gf[path], **TOL,
                                   err_msg=path)
