"""The port's attention-block switches against the JAX package's.

``CARA_ATTN_MEGA`` (the attention megakernel: "1" / "0" force it, "auto"
runs it for eval and element-dropout training) and ``CARA_ATTNPROJ=1``
(the attention and the projection site in one kernel on the non-element
routes): ``cp_attn_block``'s forward and cotangents (its backward is TPU
row 6) and ``fused_qkv_attention_proj``'s (rows 3 and 4) against
``jax.vjp`` of the Pallas kernels in interpret mode; the switch rule;
``vit_forward`` in eval and training on the rank, row, rate-0 and
element routes with each switch set on both sides (JAX's seeds, gates
and masks injected), the attention forms each side called, and one rank
step's gradients; the environment read at import.  Inputs are numpy
arrays from a seed, everything fp32, atol = rtol = 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import test_torch_port_train as port_train
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops.cuda import cp_attn_block as t_attn
from cara_tpu_torch.ops.cuda import fused_qkv_attention as t_fqa
from cara_tpu_torch.train import steps as t_steps
from cara_tpu.models import vit as j_vit
from cara_tpu.ops.pallas import cp_attn_block as j_attn
from cara_tpu.ops.pallas import fused_qkv_attention as j_fqa
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
E, HEADS, R, B = 64, 4, 4, 2
SM = (E // HEADS) ** -0.5
EPS = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {name: ((spec[2] if len(spec) > 2 else 0.0)
                   + spec[1] * rng.standard_normal(spec[0])).astype(
                       np.float32)
            for name, spec in shapes.items()}


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **TOL, err_msg=name)


ATTN_ARGS = ("x", "wq", "bq", "u1", "v1", "wp", "bp", "u2", "v2", "cb2",
             "ls", "lb", "dpm")
ATTN_DIFF = ("x", "bq", "u1", "v1", "bp", "u2", "v2", "cb2")


@pytest.mark.parametrize("n, s", [(17, 1.0), (24, 2.0)])
def test_cp_attn_block_matches_jax_vjp(n, s):
    """Row 6: the forward and the cotangents of x, both biases and the
    four factors, with one image's drop-path gate zero."""
    a = _arrays(1, x=((B, n, E), 1.2), wq=((E, 3 * E), 0.08),
                bq=((3 * E,), 0.05), u1=((E, R), 0.2), v1=((R, 3 * E), 0.2),
                wp=((E, E), 0.08), bp=((E,), 0.05), u2=((E, R), 0.2),
                v2=((R, E), 0.2), cb2=((E,), 0.1), ls=((E,), 0.1, 1.0),
                lb=((E,), 0.1), g=((B, n, E), 1.0))
    a["dpm"] = np.array([[0.0], [1.0 / 0.9]], np.float32)
    ja = {k: jnp.asarray(v) for k, v in a.items()}

    def j_fn(*diff):
        args = dict(ja, **dict(zip(ATTN_DIFF, diff)))
        return j_attn.cp_attn_block(*(args[k] for k in ATTN_ARGS), HEADS,
                                    SM, n, s, 2, None, EPS)

    ref, vjp = jax.vjp(j_fn, *(ja[k] for k in ATTN_DIFF))
    ref_grads = vjp(ja["g"])
    ta = {k: torch.from_numpy(v).requires_grad_(k in ATTN_DIFF)
          for k, v in a.items()}
    out = t_attn.cp_attn_block(*(ta[k] for k in ATTN_ARGS), HEADS, SM, n, s,
                               EPS)
    _close(out, ref)
    grads = torch.autograd.grad(out, [ta[k] for k in ATTN_DIFF], ta["g"])
    for name, got, want in zip(ATTN_DIFF, grads, ref_grads):
        _close(got, want, name)
    assert t_attn.BWD_LAUNCHES == 0  # CPU tensors launch nothing
    # a dropped path: the residual only, in both directions
    assert torch.equal(out[0], ta["x"][0])
    assert torch.equal(grads[0][0], ta["g"][0])


PROJ_DIFF = ("qkv", "b", "u", "v", "cb")


@pytest.mark.parametrize("n, n_real, s", [(17, 17, 1.0), (24, 20, 1.7)])
def test_fused_qkv_attention_proj_matches_jax_vjp(n, n_real, s):
    """Rows 3 and 4: the forward and the cotangents of qkv, the bias and
    the factors (keys >= ``n_real`` masked)."""
    a = _arrays(2, qkv=((B, n, 3 * E), 0.7), w=((E, E), 0.1),
                b=((E,), 0.1), u=((E, R), 0.1), v=((R, E), 0.1),
                cb=((E,), 0.1), g=((B, n, E), 1.0))
    ja = {k: jnp.asarray(v) for k, v in a.items()}

    def j_fn(qkv, b, u, v, cb):
        return j_fqa.fused_qkv_attention_proj(qkv, ja["w"], b, u, v, cb,
                                              HEADS, SM, n_real, s)

    ref, vjp = jax.vjp(j_fn, *(ja[k] for k in PROJ_DIFF))
    ref_grads = vjp(ja["g"])
    ta = {k: torch.from_numpy(v).requires_grad_(k in PROJ_DIFF)
          for k, v in a.items()}
    out = t_fqa.fused_qkv_attention_proj(
        ta["qkv"], ta["w"], ta["b"], ta["u"], ta["v"], ta["cb"], HEADS, SM,
        n_real, s)
    _close(out, ref)
    grads = torch.autograd.grad(out, [ta[k] for k in PROJ_DIFF], ta["g"])
    for name, got, want in zip(PROJ_DIFF, grads, ref_grads):
        _close(got, want, name)
    assert t_fqa.PROJ_LAUNCHES == t_fqa.PROJ_BWD_LAUNCHES == 0


@pytest.mark.parametrize("mega", ["0", "1", "auto", True, False])
def test_attn_mega_rule_matches_jax(monkeypatch, mega):
    monkeypatch.setattr(j_vit, "_ATTN_MEGA", mega)
    monkeypatch.setattr(t_vit, "_ATTN_MEGA", mega)
    for use_elem in (False, True):
        for training in (False, True):
            assert (t_vit._attn_mega_on(use_elem, training)
                    == j_vit._attn_mega_on(use_elem, training))


def test_switches_are_read_from_the_environment():
    """``models.vit`` reads both switches at import, as JAX does."""
    code = ("from cara_tpu_torch.models import vit; "
            "print(vit._ATTN_MEGA, vit._ATTNPROJ, "
            "vit._attn_mega_on(False, True))")
    base = {k: v for k, v in os.environ.items()
            if k not in ("CARA_ATTN_MEGA", "CARA_ATTNPROJ")}
    for env, want in (({"CARA_ATTN_MEGA": "1", "CARA_ATTNPROJ": "1"},
                       ["1", "True", "True"]), ({}, ["auto", "False",
                                                     "False"])):
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=dict(base, **env), capture_output=True,
                              text=True, check=True)
        assert proc.stdout.split() == want, proc.stdout


# name -> (``_ATTN_MEGA``, ``_ATTNPROJ``) on both sides.
SWITCHES = {"mega1": ("1", False), "mega0": ("0", False),
            "attnproj": ("0", True), "attnproj_auto": ("auto", True)}
# The attention-half entry points whose calls each side records.
J_FORMS = ((j_attn, "cp_attn_block"), (j_attn, "cp_attn_block_wd"),
           (j_fqa, "fused_qkv_attention"),
           (j_fqa, "fused_qkv_attention_proj"))
T_FORMS = ((t_attn, "cp_attn_block"), (t_attn, "cp_attn_block_wd"),
           (t_fqa, "fused_qkv_attention"),
           (t_fqa, "fused_qkv_attention_proj"))


def _switch(monkeypatch, name):
    mega, proj = SWITCHES[name]
    for mod in (j_vit, t_vit):
        monkeypatch.setattr(mod, "_ATTN_MEGA", mega)
        monkeypatch.setattr(mod, "_ATTNPROJ", proj)


def _spy(monkeypatch, forms):
    """Record which of ``forms`` are called (module attributes, which
    both ``_block``s look up at call time)."""
    called = set()
    for mod, name in forms:
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            called.add(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    return called


def _forward_pair(monkeypatch, switch, train, impl="rank", rate=0.1):
    """(port logits, JAX logits, port forms, JAX forms) of one forward of
    the tiny model under ``switch``."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = port_train._setup(
        weight_dropout_impl=impl, weight_dropout=rate)
    _switch(monkeypatch, switch)
    j_called = _spy(monkeypatch, J_FORMS)
    t_called = _spy(monkeypatch, T_FORMS)
    rng = jax.random.PRNGKey(7)
    ref = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                            cara_params=cara, cara_cfg=j_cc, train=train,
                            rng=rng if train else None, attn_impl="fused",
                            dense_impl="fused")
    rand = (port_train.jax_randomness(rng, cfg, port_train.B, cc)
            if train else None)
    out = t_vit.vit_forward(
        convert.params_from_numpy(params, "cpu"),
        torch.from_numpy(batch["image"]), cfg,
        convert.params_from_numpy(cara, "cpu"), cc, train=train,
        randomness=rand)
    return out, ref, t_called, j_called


@pytest.mark.parametrize("switch, forms", [
    ("mega0", {"fused_qkv_attention"}),
    ("attnproj", {"fused_qkv_attention_proj"}),
    ("attnproj_auto", {"cp_attn_block"})])
def test_vit_forward_eval_under_switch_matches_jax(monkeypatch, switch,
                                                   forms):
    out, ref, t_called, j_called = _forward_pair(monkeypatch, switch, False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    assert t_called == j_called == forms


@pytest.mark.parametrize("switch, impl, rate, forms", [
    ("mega1", "rank", 0.1, {"cp_attn_block"}),
    ("mega1", "row", 0.1, {"cp_attn_block"}),
    ("mega1", "element", 0.0, {"cp_attn_block"}),
    ("attnproj", "rank", 0.1, {"fused_qkv_attention_proj"}),
    ("attnproj", "row", 0.1, {"fused_qkv_attention_proj"}),
    ("attnproj_auto", "element", 0.0, {"fused_qkv_attention_proj"}),
    ("mega0", "element", 0.1, {"fused_qkv_attention"}),
    ("attnproj_auto", "element", 0.1, {"cp_attn_block_wd"})],
    ids=["mega1-rank", "mega1-row", "mega1-rate0", "attnproj-rank",
         "attnproj-row", "attnproj-rate0", "mega0-element",
         "attnproj-element"])
def test_vit_forward_train_under_switch_matches_jax(monkeypatch, switch,
                                                    impl, rate, forms):
    """The training forward with JAX's seeds, gates and masks; the
    element route never takes the attention + projection kernel."""
    out, ref, t_called, j_called = _forward_pair(monkeypatch, switch, True,
                                                 impl, rate)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    assert t_called == j_called == forms


@pytest.mark.parametrize("switch", ["mega1", "attnproj"])
def test_rank_step_gradients_under_switch_match_jax(monkeypatch, switch):
    """One rank-dropout step: the loss and every trainable leaf's
    gradient."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = port_train._setup(
        weight_dropout_impl="rank")
    _switch(monkeypatch, switch)
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
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = t_steps.loss_and_grads(
        cfg, cc, state.trainable, frozen, tbatch,
        randomness=port_train.jax_randomness(step_rng, cfg, port_train.B,
                                             cc))
    np.testing.assert_allclose(loss.item(), float(j_l), **TOL)
    want = port_train._flat(j_g)
    paths = [p for p, _ in t_steps.tree_leaves(state.trainable)]
    assert sorted(paths) == sorted(want)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), want[path], **TOL,
                                   err_msg=path)
