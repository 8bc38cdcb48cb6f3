"""The port's rank / row / no-dropout training route against the JAX
package's split fused path.

``cp_dense`` / ``cp_dense_ln`` (forward and cotangents), the row 12 dx
twin and an emulation of its kernel's folded gv, the differentiable
``fused_qkv_attention`` and ``cp_mlp_block``, each against the Pallas
kernel it replaces (interpret mode on the CPU, gradients through
``jax.vjp``); then ``vit_forward(train=True)`` for the
rank, row and rate-0 routes and two rank train steps, with JAX's masks,
seeds and gates injected; the CLI and the device default.  Inputs are
numpy arrays from a seed, everything fp32, atol = rtol = 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import test_torch_port_train as port_train
from cara_tpu_torch.cli import common as t_common
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops.cuda import _bwd as t_bwd
from cara_tpu_torch.ops.cuda import cp_dense as t_dense
from cara_tpu_torch.ops.cuda import cp_mlp as t_mlp
from cara_tpu_torch.ops.cuda import fused_qkv_attention as t_fqa
from cara_tpu_torch.train import steps as t_steps
from cara_tpu.models import vit as j_vit
from cara_tpu.ops.pallas import cp_dense as j_dense
from cara_tpu.ops.pallas import cp_mlp as j_mlp
from cara_tpu.ops.pallas import fused_qkv_attention as j_fqa
from cara_tpu.train import checkpoint as j_ckpt
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
E, HEADS, R, HIDDEN, B = 64, 4, 4, 256, 2
EPS = 1e-6
MODEL = "vit_tiny_test"


def _arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {name: (spec[2] if len(spec) > 2 else 0.0)
            + spec[1] * rng.standard_normal(spec[0]).astype(np.float32)
            for name, spec in shapes.items()}


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **TOL, err_msg=name)


DENSE_DIFF = ("x", "u", "v", "cb")


@pytest.mark.parametrize("ln, n_out, s", [(True, 3 * E, 1.0),
                                          (False, 200, 1.5)])
def test_torch_cp_dense_matches_jax_vjp(ln, n_out, s):
    """Forward and the x, u, v, cb cotangents; 37 tokens (off every
    tile) and an output width that is no multiple of 128."""
    a = _arrays(1, x=((B, 37, E), 1.2), w=((E, n_out), 0.08),
                b=((n_out,), 0.05), u=((E, R), 0.2), v=((R, n_out), 0.2),
                cb=((n_out,), 0.1), ls=((E,), 0.1, 1.0), lb=((E,), 0.1),
                g=((B, 37, n_out), 1.0))
    ja = {k: jnp.asarray(v) for k, v in a.items()}

    def j_fn(x, u, v, cb):
        if ln:
            return j_dense.cp_dense_ln(x, ja["w"], ja["b"], u, v, cb,
                                       ja["ls"], ja["lb"], s, 256, 1536, 768,
                                       None, None, EPS)
        return j_dense.cp_dense(x, ja["w"], ja["b"], u, v, cb, s)

    ref, vjp = jax.vjp(j_fn, *(ja[k] for k in DENSE_DIFF))
    ref_grads = vjp(ja["g"])
    ta = {k: torch.from_numpy(v).requires_grad_(k in DENSE_DIFF)
          for k, v in a.items()}
    args = (ta["x"], ta["w"], ta["b"], ta["u"], ta["v"], ta["cb"])
    if ln:
        out = t_dense.cp_dense_ln(*args, ta["ls"], ta["lb"], s, EPS)
    else:
        out = t_dense.cp_dense(*args, s)
    _close(out, ref)
    grads = torch.autograd.grad(out, [ta[k] for k in DENSE_DIFF], ta["g"])
    for name, got, want in zip(DENSE_DIFF, grads, ref_grads):
        _close(got, want, name)


@pytest.mark.parametrize("ln", [False, True])
def test_torch_cp_dense_dx_plain_matches_jax_kernel(ln):
    """Row 12's plain twin against ``_cp_dense_dx_raw``: dx and gv."""
    m, n, s = 74, 3 * E, 2.0
    a = _arrays(2, g=((m, n), 1.0), w=((E, n), 0.08), u=((E, R), 0.2),
                v=((R, n), 0.2), x=((m, E), 1.2), ls=((E,), 0.1, 1.0))
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    j_ln = (ja["ls"], EPS) if ln else None
    dx_ref, gv_ref = j_dense._cp_dense_dx_raw(
        ja["g"], ja["w"], ja["u"], ja["v"], s, 512, E, n, None, ln=j_ln,
        x=ja["x"])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    dx, gv = t_dense.cp_dense_dx(t["g"], t["w"], t["u"], t["v"], s,
                                 (t["ls"], EPS) if ln else None, t["x"])
    _close(dx, dx_ref, "dx")
    _close(gv, np.asarray(gv_ref)[:, :R], "gv")
    assert t_dense.DX_LAUNCHES == 0  # CPU tensors launch nothing


def folded_dx(g, w, u, v, s, ln=None, x=None, tile=64):
    """Row 12 as ``grad_gemm.cu``'s NT product with its folded rank step
    computes it: over 64-wide tiles of the contraction (N) the fp32
    accumulators of g W^T and of z = g V^T, z rounded to the input's dtype
    once at the end and emitted as gv, then the rank step s z U^T on the
    same accumulators, one 64-wide chunk of z at a time (past rank 64 gv
    comes from the rank product first and the step takes ceil(r / 64)
    k-tiles); ``ln`` = (scale, eps) with the raw input ``x`` adds the
    LayerNorm input backward."""
    m, n = g.shape
    acc = torch.zeros((m, w.shape[0]))
    z = torch.zeros((m, v.shape[0]))
    for n0 in range(0, n, tile):
        gt = g[:, n0:n0 + tile].float()
        acc += gt @ w[:, n0:n0 + tile].float().t()
        z += gt @ v[:, n0:n0 + tile].float().t()
    gv = z.to(g.dtype)
    for c0 in range(0, gv.shape[1], 64):
        acc += s * (gv[:, c0:c0 + 64].float() @ u[:, c0:c0 + 64].float().t())
    if ln is None:
        return acc.to(g.dtype), gv
    return t_bwd.ln_input_bwd_plain(x, acc, ln[0], ln[1]).to(g.dtype), gv


@pytest.mark.parametrize("ln, r", [(False, R), (True, R), (False, 96)],
                         ids=["plain", "ln", "plain_r96"])
def test_folded_gv_dx_matches_jax_kernel(ln, r):
    """The folded gv of row 12 (z accumulated over 64-wide tiles beside g
    W^T, rounded once, then the rank step) against ``_cp_dense_dx_raw``
    in interpret mode with 64-wide N tiles: dx and gv; at rank 96 the
    rank step over z's two 64-wide chunks (JAX pads the rank to 128),
    each factor's std shrunk by (R / r) ** (1 / 4) so that the delta
    keeps rank R's size."""
    m, n, s = 74, 3 * E, 2.0
    f = 0.2 * (R / r) ** 0.25
    a = _arrays(5, g=((m, n), 1.0), w=((E, n), 0.08), u=((E, r), f),
                v=((r, n), f), x=((m, E), 1.2), ls=((E,), 0.1, 1.0))
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    j_ln = (ja["ls"], EPS) if ln else None
    dx_ref, gv_ref = j_dense._cp_dense_dx_raw(
        ja["g"], ja["w"], ja["u"], ja["v"], s, 512, E, 64, None, ln=j_ln,
        x=ja["x"])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    dx, gv = folded_dx(t["g"], t["w"], t["u"], t["v"], s,
                       (t["ls"], EPS) if ln else None, t["x"])
    _close(dx, dx_ref, "dx")
    _close(gv, np.asarray(gv_ref)[:, :r], "gv")


@pytest.mark.parametrize("n, n_real", [(40, 33), (24, 24)])
def test_torch_fused_qkv_attention_autograd_matches_jax(n, n_real):
    sm = (E // HEADS) ** -0.5
    a = _arrays(3, qkv=((B, n, 3 * E), 0.7), g=((B, n, E), 1.0))
    ref, vjp = jax.vjp(lambda q: j_fqa.fused_qkv_attention(q, HEADS, sm,
                                                           n_real),
                       jnp.asarray(a["qkv"]))
    (ref_grad,) = vjp(jnp.asarray(a["g"]))
    qkv = torch.from_numpy(a["qkv"]).requires_grad_(True)
    out = t_fqa.fused_qkv_attention(qkv, HEADS, sm, n_real)
    _close(out, ref)
    (grad,) = torch.autograd.grad(out, [qkv], torch.from_numpy(a["g"]))
    _close(grad, ref_grad)


MLP_DIFF = ("x", "u1", "v1", "cb1", "u2", "v2", "cb2")


@pytest.mark.parametrize("n, zero_gate, s", [(37, False, 1.0),
                                             (16, True, 2.0)])
def test_torch_cp_mlp_block_matches_jax_vjp(n, zero_gate, s):
    m = _arrays(4, x=((B, n, E), 1.2), w1=((E, HIDDEN), 0.08),
                b1=((HIDDEN,), 0.05), u1=((E, R), 0.2),
                v1=((R, HIDDEN), 0.2), cb1=((HIDDEN,), 0.1),
                w2=((HIDDEN, E), 0.08), b2=((E,), 0.05),
                u2=((HIDDEN, R), 0.2), v2=((R, E), 0.2), cb2=((E,), 0.1),
                ls=((E,), 0.1, 1.0), lb=((E,), 0.1), g=((B, n, E), 1.0))
    dpm = np.array([0.0 if zero_gate else 1.0, 1.0 / 0.9],
                   np.float32).reshape(B, 1, 1)
    jm = {k: jnp.asarray(v) for k, v in m.items()}

    def j_fn(x, u1, v1, cb1, u2, v2, cb2):
        return j_mlp.cp_mlp_block(
            x, jm["w1"], jm["b1"], u1, v1, cb1, jm["w2"], jm["b2"], u2, v2,
            cb2, jm["ls"], jm["lb"], jnp.asarray(dpm), s, 256, None, "gelu",
            EPS)

    ref, vjp = jax.vjp(j_fn, *(jm[k] for k in MLP_DIFF))
    ref_grads = vjp(jm["g"])
    tm = {k: torch.from_numpy(v).requires_grad_(k in MLP_DIFF)
          for k, v in m.items()}
    out = t_mlp.cp_mlp_block(
        tm["x"], tm["w1"], tm["b1"], tm["u1"], tm["v1"], tm["cb1"],
        tm["w2"], tm["b2"], tm["u2"], tm["v2"], tm["cb2"], tm["ls"],
        tm["lb"], torch.from_numpy(dpm), s, "gelu", EPS)
    _close(out, ref)
    grads = torch.autograd.grad(out, [tm[k] for k in MLP_DIFF], tm["g"])
    for name, got, want in zip(MLP_DIFF, grads, ref_grads):
        _close(got, want, name)
    if zero_gate:  # a dropped path: the residual only, in both directions
        assert torch.equal(out[0], tm["x"][0])
        assert torch.equal(grads[0][0], tm["g"][0])


@pytest.mark.parametrize("impl, rate", [("rank", 0.1), ("row", 0.1),
                                        ("element", 0.0)],
                         ids=["rank", "row", "rate0"])
def test_torch_vit_forward_train_split_route_matches_jax(impl, rate):
    cfg, cc, params, cara, batch, j_cfg, j_cc = port_train._setup(
        weight_dropout_impl=impl, weight_dropout=rate)
    rng = jax.random.PRNGKey(7)
    ref = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                            cara_params=cara, cara_cfg=j_cc, train=True,
                            rng=rng, attn_impl="fused", dense_impl="fused")
    rand = port_train.jax_randomness(rng, cfg, port_train.B, cc)
    assert (rand["gates"] == 0).any()  # a dropped path is exercised
    if rate:  # a dropped rank component or row is exercised
        masks = rand.get("comp", rand.get("rows"))
        assert any((m == 0).any() for m in masks)
    tp = convert.params_from_numpy(params, "cpu")
    tc = convert.params_from_numpy(cara, "cpu")
    x = torch.from_numpy(batch["image"])
    out = t_vit.vit_forward(tp, x, cfg, tc, cc, train=True, randomness=rand)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    # drawn from the generator: the route's masks, seeded alike
    drawn = t_vit.draw_randomness(cfg, port_train.B, "cpu",
                                  torch.Generator(), cara_cfg=cc)
    assert sorted(drawn) == sorted(rand)
    for key in ("comp", "rows"):
        if key in rand:
            want = rand[key] if key == "comp" else rand[key][3]
            got = drawn[key] if key == "comp" else drawn[key][3]
            assert got.shape == want.shape
            vals = got.unique()
            assert ((vals == 0) | torch.isclose(
                vals, torch.tensor(1.0 / (1.0 - rate)))).all()
    a, b = (t_vit.vit_forward(tp, x, cfg, tc, cc, train=True,
                              generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a, b)


def test_torch_train_steps_rank_match_jax():
    """Two rank-dropout steps of make_train_step: loss, accuracy,
    grad_norm and every updated trainable."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = port_train._setup(
        weight_dropout_impl="rank")
    rng = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = j_steps.make_optimizer(1e-3, steps_per_epoch=1, total_epochs=20)
    j_frozen, j_state = j_steps.init_train_state(tx, params, cara)
    j_step = jax.jit(j_steps.make_train_step(
        j_cfg, j_cc, tx, attn_impl="fused", dense_impl="fused"))
    frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1,
                                             total_epochs=20)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_step = t_steps.make_train_step(cfg, cc)
    for step in range(2):
        rand = port_train.jax_randomness(jax.random.fold_in(rng, step), cfg,
                                         port_train.B, cc)
        j_state, jm = j_step(j_state, j_frozen, jb, rng)
        state, m = t_step(state, frozen, tbatch, randomness=rand)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                       err_msg=key)
        want = port_train._flat(j_state.trainable)
        for path, leaf in t_steps.tree_leaves(state.trainable):
            np.testing.assert_allclose(leaf.detach().numpy(), want[path],
                                       **TOL, err_msg=f"step {step} {path}")


def test_torch_cli_trains_with_rank_dropout_on_cpu(tmp_path):
    out = tmp_path / "run"
    acc = t_cli.main([
        "--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
        "--batch-size", "8", "--eval-batch-size", "8", "--synthetic-size",
        "32", "--dtype", "float32", "--backbone", str(tmp_path / "none.npz"),
        "--out-dir", str(out), "--log-every", "1000", "--dim", "4",
        "--epochs", "11", "--weight-dropout-impl", "rank", "--device",
        "cpu"])
    files = sorted(out.glob("vit_patch_camelyon_*_seed_89.npz"))
    assert acc > 0 and len(files) == 1
    _, cara, meta = j_ckpt.load_model(str(files[0]))
    assert meta["weight_dropout_impl"] == "rank"
    assert cara["P1"].shape[-1] == 4
    with pytest.raises(SystemExit):  # not one of element / rank / row
        t_cli.main(["--synthetic", "--weight-dropout-impl", "block"])


def test_torch_resolve_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_common.resolve_device(None)
    assert t_common.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("part", ["dq", "dk", "dv"])
def test_torch_smoke_attention_bwd_check_catches_one_wrong_part(part):
    """``chip_smoke`` holds the attention backward's dq, dk and dv each by
    relative L2: the bf16 plain backward passes against fp32, and the
    same with one part 10 % off (a wrong softmax-scale term) fails."""
    inp = chip_smoke.kernel_inputs(torch.device("cpu"), b=2, n=17, e=64,
                                   heads=4, hidden=256, r=4, zero_gates=1)
    _, plain, ref32 = chip_smoke.kernel_calls(inp)["fused_qkv_attention_bwd"]
    out, ref = plain(), ref32()
    chip_smoke._check_outputs("fused_qkv_attention_bwd", out, ref)
    out[part] = out[part] * 1.1
    with pytest.raises(chip_smoke.SmokeFailure, match=part):
        chip_smoke._check_outputs("fused_qkv_attention_bwd", out, ref)
