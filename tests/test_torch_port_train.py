"""The port's training path against the JAX package's.

``vit_forward(train=True)``, the train step and its optimizer, the
schedule, the data pipeline, the npz loader and the checkpoint keeper,
each against its ``cara_tpu`` twin on the same numpy inputs.  The JAX
forward runs the fused route (``attn_impl="fused", dense_impl="fused"``,
Pallas in interpret mode), the one the port's kernels replace; its
per-layer seeds and drop-path gates are derived as ``vit_forward`` derives
them and handed to the port.  fp32, atol = rtol = 1e-4 unless stated.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cara_tpu_torch import api as t_api
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.data import vtab as t_vtab
from cara_tpu_torch.models import convert, npz as t_npz
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.serving import Predictor
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu_torch.train import schedule as t_sched
from cara_tpu_torch.train import steps as t_steps
from cara_tpu import config as j_config
from cara_tpu.data import vtab as j_vtab
from cara_tpu.models import npz as j_npz
from cara_tpu.models import vit as j_vit
from cara_tpu.ops import cp as j_cp
from cara_tpu.train import checkpoint as j_ckpt
from cara_tpu.train import schedule as j_sched
from cara_tpu.train import steps as j_steps

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = "vit_tiny_test"
B = 4


def _setup(rank=4, num_classes=10, **cara_over):
    # drop-path 0.5 at the last layer, so that a dropped path shows up
    over = dict(num_classes=num_classes, drop_path_rate=0.5)
    cfg = get_model_config(MODEL, **over)
    cara_cfg = CaraConfig(**{"rank": rank, "scale": 2.0,
                             "weight_dropout": 0.1, **cara_over})
    params = convert.init_vit_params(cfg, 0)
    cara = convert.perturb_adapter(
        convert.init_cara_params(cfg, cara_cfg, 1), 2, std=0.05)
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, num_classes, B).astype(np.int32)}
    j_cfg = j_config.get_model_config(MODEL, **over)
    j_cc = j_config.CaraConfig(**dataclasses.asdict(cara_cfg))
    return cfg, cara_cfg, params, cara, batch, j_cfg, j_cc


def jax_randomness(rng, cfg, batch, cara_cfg=None):
    """The per-layer mask seeds and drop-path gates ``cara_tpu``'s
    ``vit_forward`` derives from ``rng`` (``vit.py:1405-1408, 439-445``,
    ``_wd_seed``, ``_dp_gate``), in the port's ``randomness`` layout; with
    ``cara_cfg`` of the rank or row kind at a rate above 0, also the four
    sites' rank (``_rank_comp``; a mixture of experts' (X, r),
    ``moe._comp_masks``) or row (``_row_u``) masks."""
    depth, e = cfg.depth, cfg.embed_dim
    impl = None
    if cara_cfg is not None and cara_cfg.weight_dropout > 0:
        impl = cara_cfg.weight_dropout_impl
    keys = jax.random.split(jax.random.fold_in(rng, 0), depth)
    skeys = jax.random.split(jax.random.fold_in(rng, 1), depth)
    dpr = jnp.linspace(0.0, cfg.drop_path_rate, depth)
    seeds, gates, comp = [], [], []
    rows = [[] for _ in range(4)]
    for layer in range(depth):
        site_keys = jax.random.split(keys[layer], 4)
        seeds.append([np.asarray(jax.random.randint(
            k, (1, 1), -2 ** 31, 2 ** 31 - 1, jnp.int32)) for k in site_keys])
        if impl == "rank":
            shape = ((cara_cfg.moe_experts,) if cara_cfg.moe else ()) + (
                cara_cfg.rank,)
            comp.append([np.asarray(j_cp.weight_dropout_mask(
                k, shape, cara_cfg.weight_dropout)) for k in site_keys])
        if impl == "row":
            for site, (k, width) in enumerate(zip(
                    site_keys, (e, e, e, cfg.hidden_dim))):
                rows[site].append(np.asarray(j_cp.weight_dropout_mask(
                    k, (width, 1), cara_cfg.weight_dropout)).reshape(width))
        sk = jax.random.split(skeys[layer], 7)
        keep = 1.0 - dpr[layer]
        gates.append([np.asarray(
            jax.random.bernoulli(sk[i], keep, (batch, 1, 1)).astype(
                jnp.float32) / keep).reshape(batch) for i in (0, 1)])
    out = {"seeds": torch.from_numpy(np.array(seeds)).reshape(depth, 4, 1, 1),
           "gates": torch.from_numpy(np.array(gates))}
    if impl == "rank":
        out["comp"] = torch.from_numpy(np.array(comp))
    if impl == "row":
        out["rows"] = [torch.from_numpy(np.array(m)) for m in rows]
    return out


def test_vit_forward_train_matches_jax():
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup()
    rng = jax.random.PRNGKey(7)
    ref = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                            cara_params=cara, cara_cfg=j_cc, train=True,
                            rng=rng, attn_impl="fused", dense_impl="fused")
    rand = jax_randomness(rng, cfg, B)
    assert (rand["gates"] == 0).any()  # a dropped path is exercised
    out = t_vit.vit_forward(
        convert.params_from_numpy(params, "cpu"),
        torch.from_numpy(batch["image"]), cfg,
        cara_params=convert.params_from_numpy(cara, "cpu"), cara_cfg=cc,
        train=True, randomness=rand)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    # without injected randomness the draw is seeded from the generator
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    x = torch.from_numpy(batch["image"])
    tp = convert.params_from_numpy(params, "cpu")
    tc = convert.params_from_numpy(cara, "cpu")
    a = t_vit.vit_forward(tp, x, cfg, tc, cc, train=True, generator=g1)
    b = t_vit.vit_forward(tp, x, cfg, tc, cc, train=True, generator=g2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("field, value", [
    ("delta_impl", "materialized"), ("cp_order", 2), ("moe_experts", 2)])
def test_vit_forward_train_refuses_unported_routes(field, value):
    """The routes on the XLA dense forms that JAX's fused default gives
    way to: the materialized delta and CP order 2 (the dense deltas, their
    element masks injected; ``test_torch_port_orders.py`` holds every
    order) and a mixture of two experts (rank route, its (X, r) masks
    injected; ``test_torch_port_moe.py`` holds the rest) match JAX's
    training forward; MoE with element masks is refused, as in JAX."""
    from test_torch_port_dropout import jax_randomness as masked

    over = {field: value}
    if field == "moe_experts":
        over["weight_dropout_impl"] = "rank"
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup(**over)
    args = (convert.params_from_numpy(params, "cpu"),
            torch.from_numpy(batch["image"]), cfg)
    rng = jax.random.PRNGKey(7)
    ref = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                            cara_params=cara, cara_cfg=j_cc, train=True,
                            rng=rng, attn_impl="fused",
                            dense_impl="xla" if cc.moe else "fused")
    rand = masked(rng, cfg, B, cc, "fused", "xla")
    out = t_vit.vit_forward(
        *args, cara_params=convert.params_from_numpy(cara, "cpu"),
        cara_cfg=cc, train=True, randomness=rand)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="weight_dropout_impl='rank'"):
        t_vit.check_trainable(cfg, CaraConfig(moe_experts=2))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_train_steps_match_jax():
    """Step 1's loss and every trainable leaf's gradient, then two steps of
    make_train_step: loss, grad_norm and the updated trainables; the
    port's state rebuilt from JAX's arrays after step 1 matches its own."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = _setup()
    rng = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = j_steps.make_optimizer(1e-3, steps_per_epoch=1, total_epochs=20)
    j_frozen, j_state = j_steps.init_train_state(tx, params, cara)
    j_step = jax.jit(j_steps.make_train_step(
        j_cfg, j_cc, tx, attn_impl="fused", dense_impl="fused"))

    def j_loss(trainable, step_rng):
        logits = j_vit.vit_forward(
            j_steps.merge_params(j_frozen, trainable), jb["image"], j_cfg,
            cara_params=trainable["cara"], cara_cfg=j_cc, train=True,
            rng=step_rng, attn_impl="fused", dense_impl="fused")
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jb["label"]).mean()

    frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1,
                                             total_epochs=20)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    step_rng = jax.random.fold_in(rng, 0)
    j_l, j_g = jax.value_and_grad(j_loss)(j_state.trainable, step_rng)
    loss, _, grads = t_steps.loss_and_grads(
        cfg, cc, state.trainable, frozen, tbatch,
        randomness=jax_randomness(step_rng, cfg, B))
    np.testing.assert_allclose(loss.item(), float(j_l), **TOL)
    j_gf = _flat(j_g)
    paths = [p for p, _ in t_steps.tree_leaves(state.trainable)]
    assert sorted(paths) == sorted(j_gf)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), j_gf[path], **TOL,
                                   err_msg=path)

    t_step = t_steps.make_train_step(cfg, cc)
    for step in range(2):
        rand = jax_randomness(jax.random.fold_in(rng, step), cfg, B)
        j_state, jm = j_step(j_state, j_frozen, jb, rng)
        state, m = t_step(state, frozen, tbatch, randomness=rand)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                       err_msg=key)
        want = _flat(j_state.trainable)
        for path, leaf in t_steps.tree_leaves(state.trainable):
            np.testing.assert_allclose(leaf.detach().numpy(), want[path],
                                       **TOL, err_msg=f"step {step} {path}")
        if step == 0:
            adam = j_state.opt_state[0]
            rebuilt = t_steps.train_state_from_numpy(
                1, jax.device_get(j_state.trainable), jax.device_get(adam.mu),
                jax.device_get(adam.nu), "cpu", 1e-3, 1, total_epochs=20)
            mine = dict(t_steps.tree_leaves(state.trainable))
            for path, leaf in t_steps.tree_leaves(rebuilt.trainable):
                np.testing.assert_allclose(
                    rebuilt.opt.optimizer.state[leaf]["exp_avg"].numpy(),
                    state.opt.optimizer.state[mine[path]]["exp_avg"].numpy(),
                    **TOL)


def test_schedule_matches_jax():
    for spe, epochs in ((3, 100), (7, 30)):
        j = j_sched.cara_cosine_schedule(1e-3, spe, epochs)
        t = t_sched.cara_cosine_schedule(1e-3, spe, epochs)
        # JAX evaluates the curve in fp32, the port in Python floats
        for step in range(0, spe * epochs + 5, 2):
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-5)


def test_adamw_matches_optax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((4,)).astype(np.float32)}}
    sched = j_sched.cara_cosine_schedule(1e-2, 1, 20)
    tx = optax.adamw(learning_rate=sched, weight_decay=1e-4)
    j_params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(j_params)
    t_params = convert.params_from_numpy(tree, "cpu")
    leaves = [t for _, t in t_steps.tree_leaves(t_params)]
    for t in leaves:
        t.requires_grad_(True)
    opt = t_steps.make_optimizer(t_params, 1e-2, 1, 20)
    for step in range(3):
        g = jax.tree.map(lambda x: np.asarray(
            rng.standard_normal(x.shape), np.float32), tree)
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state,
                                   j_params)
        j_params = optax.apply_updates(j_params, upd)
        opt.update(leaves, [x for _, x in t_steps.tree_leaves(
            convert.params_from_numpy(g, "cpu"))], step)
        want = _flat(j_params)
        for path, leaf in t_steps.tree_leaves(t_params):
            np.testing.assert_allclose(leaf.detach().numpy(), want[path],
                                       atol=1e-6, rtol=1e-5)


def test_data_pipeline_matches_jax():
    t_src = t_vtab.synthetic_source(21, 5, 16, seed=4)
    j_src = j_vtab.synthetic_source(21, 5, 16, seed=4)
    assert np.array_equal(t_src.images, j_src.images)
    assert np.array_equal(t_src.labels, j_src.labels)
    for train in (True, False):
        t_ld = t_vtab.BatchLoader(t_src, 8, train=train, seed=9)
        j_ld = j_vtab.BatchLoader(j_src, 8, train=train, seed=9,
                                  process_index=0, process_count=1)
        assert t_ld.steps_per_epoch() == j_ld.steps_per_epoch()
        for _ in range(2):  # two epochs: the shuffle advances alike
            for tb, jb in zip(t_ld, j_ld, strict=True):
                for key in ("image", "label", "valid"):
                    assert np.array_equal(tb[key], jb[key]), key
    assert t_vtab.get_classes_num("svhn") == j_vtab.get_classes_num("svhn")


def _fake_npz(path, cfg, seed=0):
    """A Google-format npz of random arrays for ``cfg`` (grid 5x5)."""
    rng = np.random.default_rng(seed)
    e, h, d, p = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.patch_size
    z = {"embedding/kernel": (p, p, 3, e), "embedding/bias": (e,),
         "cls": (1, 1, e), "Transformer/posembed_input/pos_embedding":
         (1, 26, e), "Transformer/encoder_norm/scale": (e,),
         "Transformer/encoder_norm/bias": (e,)}
    attn = "MultiHeadDotProductAttention_1"
    for i in range(cfg.depth):
        pre = f"Transformer/encoderblock_{i}/"
        for n in ("LayerNorm_0", "LayerNorm_2"):
            z[pre + n + "/scale"] = (e,)
            z[pre + n + "/bias"] = (e,)
        for n in ("query", "key", "value"):
            z[f"{pre}{attn}/{n}/kernel"] = (e, h, d)
            z[f"{pre}{attn}/{n}/bias"] = (h, d)
        z[f"{pre}{attn}/out/kernel"] = (h, d, e)
        z[f"{pre}{attn}/out/bias"] = (e,)
        z[pre + "MlpBlock_3/Dense_0/kernel"] = (e, cfg.hidden_dim)
        z[pre + "MlpBlock_3/Dense_0/bias"] = (cfg.hidden_dim,)
        z[pre + "MlpBlock_3/Dense_1/kernel"] = (cfg.hidden_dim, e)
        z[pre + "MlpBlock_3/Dense_1/bias"] = (e,)
    np.savez(path, **{k: rng.standard_normal(s).astype(np.float32)
                      for k, s in z.items()})


def test_npz_backbone_matches_jax(tmp_path):
    cfg = get_model_config(MODEL)
    j_cfg = j_config.get_model_config(MODEL)
    path = str(tmp_path / "vit.npz")
    _fake_npz(path, cfg)
    t_tree = t_npz.load_npz_backbone(path, cfg)
    j_tree = j_npz.load_npz_backbone(path, j_cfg)
    t_flat, j_flat = _flat(t_tree), _flat(j_tree)
    assert sorted(t_flat) == sorted(j_flat)
    for k in t_flat:
        assert np.array_equal(t_flat[k], j_flat[k]), k
    # 5x5 -> 4x4 grid (downscale: antialiased bicubic, as jax.image)
    t_res = t_npz.maybe_resize_pos_embed(t_tree, cfg)["pos_embed"]
    j_res = j_npz.maybe_resize_pos_embed(j_tree, j_cfg)["pos_embed"]
    np.testing.assert_allclose(t_res, np.asarray(j_res), atol=1e-5)
    up = dataclasses.replace(cfg, image_size=48)
    np.testing.assert_allclose(
        t_npz.maybe_resize_pos_embed(t_tree, up)["pos_embed"],
        np.asarray(j_npz.maybe_resize_pos_embed(
            j_tree, dataclasses.replace(j_cfg, image_size=48))["pos_embed"]),
        atol=1e-5)
    model = t_api.build_model(MODEL, rank=4, num_classes=3,
                              backbone_path=path)
    assert model.params["head"]["kernel"].shape == (64, 3)
    assert np.array_equal(model.params["blocks"]["qkv"]["kernel"],
                          t_tree["blocks"]["qkv"]["kernel"])


def test_cli_trains_and_checkpoint_loads_in_both_packages(tmp_path):
    out = tmp_path / "run"
    acc = t_cli.main([
        "--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
        "--batch-size", "8", "--eval-batch-size", "8", "--synthetic-size",
        "32", "--dtype", "float32", "--backbone", str(tmp_path / "none.npz"),
        "--out-dir", str(out), "--log-every", "1000", "--dim", "4",
        "--epochs", "11", "--device", "cpu"])
    files = sorted(out.glob("vit_patch_camelyon_*_seed_89.npz"))
    assert acc > 0 and len(files) == 1
    params, cara, meta = j_ckpt.load_model(str(files[0]))
    assert meta["scale"] == 10 and meta["model"] == MODEL
    assert cara["P1"].shape[-1] == 4 and params["head"]["kernel"].shape[-1] == 2
    pred = Predictor.from_checkpoint_auto(str(files[0]), MODEL, device="cpu",
                                          dtype=torch.float32, batch_size=8)
    logits = pred.logits(np.zeros((3, 32, 32, 3), np.float32))
    assert logits.shape == (3, 2) and np.isfinite(logits).all()
    # a flag whose feature is not ported is refused, naming the ROADMAP
    with pytest.raises(SystemExit, match="ROADMAP"):
        t_cli.main(["--synthetic", "--mesh", "2,1"])


def test_keeper_rotates_and_writes_host_copies(tmp_path):
    keeper = t_ckpt.BestCheckpointKeeper(str(tmp_path), "svhn", 3)
    leaf = torch.ones(2, requires_grad=True)
    first = keeper.update(0.5, {"head": {"bias": leaf}}, {"R1": leaf},
                          meta={"scale": 2.0})
    with torch.no_grad():
        leaf.add_(1.0)  # the optimizer moves on while the write runs
    assert keeper.update(0.4, {}, None) is None
    second = keeper.update(0.75, {"head": {"bias": leaf}}, {"R1": leaf})
    keeper.wait()
    assert not (tmp_path / first.split("/")[-1]).exists()
    params, cara, meta = j_ckpt.load_model(second)
    assert meta["acc"] == 0.75 and meta["seed"] == 3
    assert np.array_equal(cara["R1"], [2.0, 2.0])
