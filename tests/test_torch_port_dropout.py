"""The port's regularised training against the JAX package's.

Row 13's activation body (``cp_dense`` / ``cp_dense_ln`` / ``cp_dense_wd``
/ ``cp_dense_ln_wd`` with ``act="gelu"`` and ``"quick_gelu"``: forward
against the Pallas kernel in interpret mode, every cotangent against
``jax.vjp``; the dact helper's plain twin against ``_cp_dense_raw(...,
g=)``), ``dropout`` and ``mha`` with JAX's masks, the XLA qkv delta with
an element mask or a rank mask, then ``vit_forward(train=True)`` with
activation and attention dropout on every route (element, rank, row,
rate 0, full, linear) at 17 and 577 tokens, CaRA with the XLA and flash
attentions and the XLA dense forms, two rank train steps with dropout,
and the CLI.  JAX's per-layer seeds, gates and masks are derived as its
``vit_forward`` derives them and injected.  Inputs are numpy arrays from
a seed, everything fp32, atol = rtol = 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_port_train as port_train
from test_torch_port_split import _arrays, _close
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import cara as t_cara
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops import layers as t_layers
from cara_tpu_torch.ops.cuda import cp_dense as t_dense
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu_torch.train import steps as t_steps
from cara_tpu import config as j_config
from cara_tpu.models import cara as j_cara
from cara_tpu.models import vit as j_vit
from cara_tpu.ops import cp as j_cp
from cara_tpu.ops import layers as j_layers
from cara_tpu.ops.pallas import cp_dense as j_dense
from cara_tpu.train import checkpoint as j_ckpt
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
E, HEADS, R, HIDDEN, B = 64, 4, 4, 256, 2
EPS = 1e-6
MODEL = "vit_tiny_test"
RATES = dict(dropout_rate=0.1, attn_dropout_rate=0.1)
OVER_577 = dict(image_size=96, patch_size=4)
DENSE_DIFF = ("x", "u", "v", "cb")
FORMS = ("cp_dense", "cp_dense_ln", "cp_dense_wd", "cp_dense_ln_wd")


def _site_arrays(seed, m_lead, k, n):
    return _arrays(seed, x=(m_lead + (k,), 1.2), w=((k, n), 0.08),
                   b=((n,), 0.05), u=((k, R), 0.2), v=((R, n), 0.2),
                   cb=((n,), 0.1), ls=((k,), 0.1, 1.0), lb=((k,), 0.1),
                   g=(m_lead + (n,), 1.0))


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("form", FORMS)
def test_torch_cp_dense_act_matches_jax_vjp(form, act):
    """Forward and the x, u, v, cb cotangents of the four site forms with
    an activation: the backward recomputes the pre-activation (the dact
    helper), then runs the site's backward on dpre."""
    s, rate = 1.5, 0.3
    a = _site_arrays(11, (B, 37), E, HIDDEN)
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    seed = np.array([[123457]], np.int32)
    ln = form.startswith("cp_dense_ln")
    wd = form.endswith("_wd")

    def j_fn(x, u, v, cb):
        args = (x, ja["w"], ja["b"], u, v, cb)
        lnargs = (ja["ls"], ja["lb"]) if ln else ()
        if wd:
            return getattr(j_dense, form)(
                *args, *lnargs, jnp.asarray(seed), s, rate, 256, 1024, 768,
                None, act, *((EPS,) if ln else ()))
        return getattr(j_dense, form)(*args, *lnargs, s, 256, 1536, 768,
                                      None, act, *((EPS,) if ln else ()))

    ref, vjp = jax.vjp(j_fn, *(ja[k] for k in DENSE_DIFF))
    ref_grads = vjp(ja["g"])
    ta = {k: torch.from_numpy(v).requires_grad_(k in DENSE_DIFF)
          for k, v in a.items()}
    args = [ta["x"], ta["w"], ta["b"], ta["u"], ta["v"], ta["cb"]]
    if ln:
        args += [ta["ls"], ta["lb"]]
    if wd:
        args += [torch.from_numpy(seed.reshape(1)), s, rate]
    else:
        args += [s]
    kw = dict(ln_eps=EPS) if ln else {}
    out = getattr(t_dense, form)(*args, act=act, **kw)
    _close(out, ref)
    grads = torch.autograd.grad(out, [ta[k] for k in DENSE_DIFF], ta["g"])
    for name, got, want in zip(DENSE_DIFF, grads, ref_grads):
        _close(got, want, name)
    assert t_dense.ACT_LAUNCHES == 0 and t_dense.DACT_LAUNCHES == 0


@pytest.mark.parametrize("act, ln", [("gelu", False), ("gelu", True),
                                     ("quick_gelu", True)])
def test_torch_cp_dense_dact_plain_matches_jax_kernel(act, ln):
    """The dact helper's plain twin against ``_cp_dense_raw(..., g=)``:
    ``g * act'(pre)`` with the pre-activation recomputed."""
    m, s = 74, 2.0
    a = _site_arrays(12, (m,), E, HIDDEN)
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    ref = j_dense._cp_dense_raw(
        ja["x"], ja["w"], ja["b"], ja["u"], ja["v"], ja["cb"], s, 256, 256,
        E, None, act, g=ja["g"], ln=(ja["ls"], ja["lb"], EPS) if ln else None)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = t_dense.cp_dense_dact(t["g"], t["x"], t["w"], t["b"], t["u"],
                                t["v"], t["cb"], s,
                                (t["ls"], t["lb"], EPS) if ln else None, act)
    _close(got, ref)
    with pytest.raises(ValueError, match="activation"):
        t_dense.cp_dense_dact(t["g"], t["x"], t["w"], t["b"], t["u"],
                              t["v"], t["cb"], s, act=None)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_torch_dropout_and_mha_match_jax(rate):
    """``dropout`` with the mask ``jax.random.bernoulli`` draws from the
    key, and ``mha`` with its dropout on the probabilities."""
    key = jax.random.PRNGKey(3)
    a = _arrays(13, x=((B, 9, E), 1.0), q=((B, HEADS, 9, 16), 1.0),
                k=((B, HEADS, 9, 16), 1.0), v=((B, HEADS, 9, 16), 1.0))
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate, (B, 9, E)))
    ref = j_layers.dropout(jnp.asarray(a["x"]), rate, key)
    got = t_layers.dropout(torch.from_numpy(a["x"]), rate,
                           torch.from_numpy(keep))
    _close(got, ref)
    assert not keep.all()
    assert torch.equal(t_layers.dropout(torch.from_numpy(a["x"]), rate,
                                        None), torch.from_numpy(a["x"]))
    sm = 0.25
    ref = j_layers.mha(*(jnp.asarray(a[k]) for k in "qkv"), sm, rate, key)
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate,
                                           (B, HEADS, 9, 9)))
    got = t_layers.mha(*(torch.from_numpy(a[k]) for k in "qkv"), sm, rate,
                       torch.from_numpy(keep))
    _close(got, ref)
    ref = j_layers.mha(*(jnp.asarray(a[k]) for k in "qkv"), sm)
    _close(t_layers.mha(*(torch.from_numpy(a[k]) for k in "qkv"), sm), ref)


@pytest.mark.parametrize("order", [3, 4, 5])
@pytest.mark.parametrize("materialized", [True, False],
                         ids=["element_mask", "rank_mask"])
def test_torch_qkv_delta_matches_jax(order, materialized):
    """The XLA qkv delta with the element mask over the dense tensor
    (materialized) or the rank mask on lambda (factorized), both drawn
    from JAX's key."""
    cfg = get_model_config(MODEL)
    cc = CaraConfig(rank=R, cp_order=order, weight_dropout=0.3)
    j_cfg = j_config.get_model_config(MODEL)
    j_cc = j_config.CaraConfig(**dataclasses.asdict(cc))
    cara = convert.perturb_adapter(convert.init_cara_params(cfg, cc, 1), 2,
                                   std=0.05)
    f1 = cara["A1"][:1 if order == 5 else 3]
    x = _arrays(14, x=((B, 9, E), 1.0))["x"]
    key = jax.random.PRNGKey(5)
    ref = j_cara.qkv_delta(jnp.asarray(x), cara, jnp.asarray(f1), j_cfg,
                           j_cc, materialized=materialized, drop_rng=key)
    tc = convert.params_from_numpy(cara, "cpu")
    if materialized:
        shape = (3, E, E)
        mask = np.asarray(j_cp.weight_dropout_mask(key, shape, 0.3))
        kw = dict(drop_mask=torch.from_numpy(mask))
    else:
        mask = np.asarray(j_cp.weight_dropout_mask(key, (R,), 0.3))
        kw = dict(comp_mask=torch.from_numpy(mask))
    assert (mask == 0).any()
    got = t_cara.qkv_delta(torch.from_numpy(x), tc, torch.from_numpy(f1),
                           cfg, cc, materialized=materialized, **kw)
    _close(got, ref)


def jax_randomness(rng, cfg, batch, cara_cfg=None, attn_impl="fused",
                   dense_impl="fused"):
    """``test_torch_port_train.jax_randomness`` plus each layer's masks
    (``t_vit.layer_mask_specs`` for these impls) as ``cara_tpu``'s
    ``_block`` draws them: ``k_do1..3`` and ``k_attn`` from the layer's
    ``split(skey, 7)``, the bottleneck adapters' ``ad_attn`` / ``ad_mlp``
    from the two halves of its ``k_ad`` (the seventh), the element
    route's dense masks from its ``k_wd_*`` keys
    (``weight_dropout_mask``)."""
    out = port_train.jax_randomness(rng, cfg, batch, cara_cfg)
    specs = t_vit.layer_mask_specs(cfg, cara_cfg, batch, attn_impl,
                                   dense_impl)
    if not specs:
        return out
    depth = cfg.depth
    keys = jax.random.split(jax.random.fold_in(rng, 0), depth)
    skeys = jax.random.split(jax.random.fold_in(rng, 1), depth)
    skey_of = {"attn": 2, "do1": 3, "do2": 4, "do3": 5}
    wkey_of = {"qkv": 0, "proj": 1, "fc1": 2, "fc2": 3}
    masks = []
    for layer in range(depth):
        sk = jax.random.split(skeys[layer], 7)
        wk = jax.random.split(keys[layer], 4)
        m = {}
        for name, (shape, kind) in specs.items():
            if kind == "keep":
                rate = (cfg.attn_dropout_rate if name == "attn"
                        else cfg.dropout_rate)
                m[name] = torch.from_numpy(np.array(jax.random.bernoulli(
                    sk[skey_of[name]], 1.0 - rate, shape)))
            elif kind == "adapter":
                k_ad = jax.random.split(sk[6])[0 if name == "ad_attn" else 1]
                m[name] = torch.from_numpy(np.array(jax.random.bernoulli(
                    k_ad, 1.0 - cara_cfg.adapter_dropout, shape)))
            else:
                m[name] = torch.from_numpy(np.array(
                    j_cp.weight_dropout_mask(wk[wkey_of[name]], shape,
                                             cara_cfg.weight_dropout)))
        masks.append(m)
    out["masks"] = masks
    return out


def _setup(method="cara", over=None, **cara_over):
    """``port_train._setup`` with the dropout rates (and ``over``) on the
    model; ``method`` linear / full drop the adapter."""
    model_over = dict(RATES, num_classes=10, drop_path_rate=0.5,
                      **(over or {}))
    cfg = get_model_config(MODEL, **model_over)
    j_cfg = j_config.get_model_config(MODEL, **model_over)
    _, cc, params, cara, batch, _, j_cc = port_train._setup(**cara_over)
    if method != "cara":
        cc = CaraConfig(method=method, weight_dropout=0.0)
        j_cc = j_config.CaraConfig(method=method, weight_dropout=0.0)
        cara = None
    params = convert.init_vit_params(cfg, 0)
    rng = np.random.default_rng(3)
    size = cfg.image_size
    batch = {"image": rng.standard_normal((B, size, size, 3)).astype(
        np.float32), "label": rng.integers(0, 10, B).astype(np.int32)}
    return cfg, cc, params, cara, batch, j_cfg, j_cc


ROUTES = {"element": dict(), "rank": dict(weight_dropout_impl="rank"),
          "row": dict(weight_dropout_impl="row"),
          "rate0": dict(weight_dropout=0.0), "full": None, "linear": None}


def _forward_pair(route, train, over=None, attn_impl="fused",
                  dense_impl="fused", rates=None):
    """(port logits, JAX logits) of one forward on ``route``."""
    method = route if route in ("full", "linear") else "cara"
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup(
        method, over, **(ROUTES[route] or {}))
    if rates is not None:
        cfg = dataclasses.replace(cfg, **rates)
        j_cfg = dataclasses.replace(j_cfg, **rates)
    if method == "full" and attn_impl == "fused":
        attn_impl = "flash"
    if method != "cara":
        dense_impl = "xla"
    rng = jax.random.PRNGKey(7)
    x = batch["image"]
    ref = j_vit.vit_forward(
        params, jnp.asarray(x), j_cfg, cara_params=cara,
        cara_cfg=None if cara is None else j_cc, train=train,
        rng=rng if train else None, attn_impl=attn_impl,
        dense_impl=dense_impl)
    rand = None
    if train:
        rand = jax_randomness(rng, cfg, B, None if cara is None else cc,
                              attn_impl, dense_impl)
        assert (rand["gates"] == 0).any()
        if cfg.dropout_rate:  # a dropped activation is exercised
            assert not rand["masks"][0]["do2"].all()
    out = t_vit.vit_forward(
        convert.params_from_numpy(params, "cpu"), torch.from_numpy(x), cfg,
        None if cara is None else convert.params_from_numpy(cara, "cpu"),
        None if cara is None else cc, train=train, randomness=rand,
        attn_impl=attn_impl, dense_impl=dense_impl)
    return out, ref


@pytest.mark.parametrize("over", [None, OVER_577], ids=["n17", "n577"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_torch_vit_forward_train_with_dropout_matches_jax(route, over):
    """Activation and attention dropout at 0.1 on every route: the
    megakernels give way to the split sites with the GELU in the fc1
    kernel, the attention to ``mha``."""
    out, ref = _forward_pair(route, True, over)
    _close(out, ref, "logits")


@pytest.mark.parametrize("route", ["element", "rank"])
def test_torch_vit_forward_train_activation_dropout_only_matches_jax(route):
    """Activation dropout alone: the fused attention stays, the MLP is
    the split GELU sites."""
    out, ref = _forward_pair(route, True,
                             rates=dict(attn_dropout_rate=0.0))
    _close(out, ref, "logits")


@pytest.mark.parametrize("attn_impl, dense_impl, train, route", [
    ("xla", "fused", False, "element"), ("xla", "fused", True, "element"),
    ("xla", "fused", True, "rank"), ("flash", "fused", False, "element"),
    ("flash", "fused", True, "element"), ("flash", "fused", True, "row"),
    ("fused", "xla", False, "element"), ("fused", "xla", True, "element"),
    ("fused", "xla", True, "rank"), ("fused", "xla", True, "row"),
    ("xla", "xla", True, "element"), ("xla", "fused", True, "linear")])
def test_torch_vit_forward_cara_impls_match_jax(attn_impl, dense_impl, train,
                                                route):
    """CaRA with the XLA and flash attentions (the XLA qkv delta on the
    qkv GEMM; on the element route its Bernoulli mask over the dense
    delta) and with the XLA dense forms, eval and train, no activation
    dropout; the linear probe over the XLA attention."""
    out, ref = _forward_pair(route, train, attn_impl=attn_impl,
                             dense_impl=dense_impl,
                             rates=dict(dropout_rate=0.0,
                                        attn_dropout_rate=0.0))
    _close(out, ref, "logits")


def test_torch_vit_forward_linear_fused_dense_matches_jax():
    """``--method linear --dense-impl fused``: the block megakernels on
    zero factors, in eval and, for the MLP, in training."""
    for train in (False, True):
        cfg, _, params, _, batch, j_cfg, _ = _setup("linear")
        cfg = dataclasses.replace(cfg, dropout_rate=0.0,
                                  attn_dropout_rate=0.0)
        j_cfg = dataclasses.replace(j_cfg, dropout_rate=0.0,
                                    attn_dropout_rate=0.0)
        rng = jax.random.PRNGKey(7)
        ref = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                                train=train, rng=rng if train else None,
                                attn_impl="fused", dense_impl="fused")
        rand = jax_randomness(rng, cfg, B) if train else None
        out = t_vit.vit_forward(convert.params_from_numpy(params, "cpu"),
                                torch.from_numpy(batch["image"]), cfg,
                                train=train, randomness=rand,
                                dense_impl="fused")
        _close(out, ref, "logits")


def test_torch_draw_randomness_draws_the_route_masks():
    """Drawn from the generator: the masks of ``layer_mask_specs``, per
    layer inside the forward or up front with ``masks=True``, seeded
    alike."""
    cfg, cc, params, cara, batch, _, _ = _setup()
    drawn = t_vit.draw_randomness(cfg, B, "cpu", torch.Generator(),
                                  cara_cfg=cc, masks=True, attn_impl="xla")
    specs = t_vit.layer_mask_specs(cfg, cc, B, "xla")
    assert sorted(specs) == ["attn", "do1", "do2", "do3", "qkv"]
    assert len(drawn["masks"]) == cfg.depth
    for name, (shape, kind) in specs.items():
        got = drawn["masks"][0][name]
        assert got.shape == shape
        assert got.dtype == (torch.bool if kind == "keep" else torch.float32)
    keep = torch.cat([m["do2"].flatten() for m in drawn["masks"]])
    assert abs(keep.float().mean().item() - 0.9) < 0.02
    tp = convert.params_from_numpy(params, "cpu")
    tc = convert.params_from_numpy(cara, "cpu")
    x = torch.from_numpy(batch["image"])
    a, b = (t_vit.vit_forward(tp, x, cfg, tc, cc, train=True,
                              generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a, b)
    c = t_vit.vit_forward(tp, x, cfg, tc, cc, train=True,
                          generator=torch.Generator().manual_seed(6))
    assert not torch.equal(a, c)


def test_torch_train_steps_with_dropout_match_jax():
    """Two rank-dropout steps with activation and attention dropout:
    loss, accuracy, grad_norm, every updated trainable and its AdamW
    moments."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup(
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
        rand = jax_randomness(jax.random.fold_in(rng, step), cfg, B, cc)
        j_state, jm = j_step(j_state, j_frozen, jb, rng)
        state, m = t_step(state, frozen, tbatch, randomness=rand)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                       err_msg=key)
        want = port_train._flat(j_state.trainable)
        adam = j_state.opt_state[0]
        mu, nu = port_train._flat(adam.mu), port_train._flat(adam.nu)
        for path, leaf in t_steps.tree_leaves(state.trainable):
            np.testing.assert_allclose(leaf.detach().numpy(), want[path],
                                       **TOL, err_msg=f"step {step} {path}")
            moments = state.opt.optimizer.state[leaf]
            np.testing.assert_allclose(moments["exp_avg"].numpy(), mu[path],
                                       **TOL, err_msg=f"mu {path}")
            np.testing.assert_allclose(moments["exp_avg_sq"].numpy(),
                                       nu[path], atol=1e-8, rtol=1e-4,
                                       err_msg=f"nu {path}")


def test_torch_cli_trains_with_dropout_on_cpu(tmp_path):
    """``--model-override dropout_rate=0.1`` with attention dropout and
    ``--attn-impl xla``: the best checkpoint, which both packages load
    with the overrides in its meta."""
    out = tmp_path / "run"
    acc = t_cli.main([
        "--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
        "--batch-size", "8", "--eval-batch-size", "8", "--synthetic-size",
        "32", "--dtype", "float32", "--backbone", str(tmp_path / "none.npz"),
        "--out-dir", str(out), "--log-every", "1000", "--dim", "4",
        "--epochs", "11", "--device", "cpu", "--model-override",
        "dropout_rate=0.1", "--model-override", "attn_dropout_rate=0.1",
        "--attn-impl", "xla"])
    files = sorted(out.glob("vit_patch_camelyon_*_seed_89.npz"))
    assert acc > 0 and len(files) == 1
    for load in (j_ckpt.load_model, t_ckpt.load_model):
        params, cara, meta = load(str(files[0]))
        assert meta["model_overrides"] == RATES
        assert cara["P1"].shape[-1] == 4
        assert params["blocks"]["fc1"]["kernel"].shape == (2, E, HIDDEN)
