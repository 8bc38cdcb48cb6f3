"""The port's ToMe token merging (``models/tome.py``) against the JAX
package's.

The merge schedule and token counts, the bipartite matching (tied scores
and the protected cls token included) and the merge's sum over shared
destinations, ``tome_forward`` at r 0, 2 and 4 on dense, int8 (w8) and
w8a8 block trees and on a model without a cls token (the size-weighted
mean pool), ``mha``'s key bias, ``Predictor(tome_r=...)`` with its guards
and ``quantize``, and the ``serve`` / ``predict`` / ``export --tome-r``
flags.  Tiny model, numpy trees from a seed, fp32 on the CPU, atol = rtol
= 1e-4 unless stated.
"""

import dataclasses
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cara_tpu_torch import server as t_server
from cara_tpu_torch import serving as t_serving
from cara_tpu_torch.cli import serve as t_serve
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import quant as t_quant
from cara_tpu_torch.models import tome as t_tome
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops.layers import mha
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu import config as j_config
from cara_tpu import serving as j_serving
from cara_tpu.models import quant as j_quant
from cara_tpu.models import tome as j_tome
from cara_tpu.ops.layers import mha as j_mha

TOL = dict(atol=1e-4, rtol=1e-4)
# w8a8 codes its activations as round(x / ax): an fp32 ulp before the
# rounding flips a code by one, which moves a logit by up to ~5e-3 on
# these inputs (4.4e-3 measured at r 0, where the forward is the plain
# one); the weight-only and dense trees hold TOL.
W8A8_TOL = dict(atol=1e-2, rtol=1e-2)
MODEL = "vit_tiny_test"
B = 3
# JAX's ToMe forward jitted (r static): eager, each layer's shapes are
# dispatched op by op.
J_TOME = jax.jit(j_tome.tome_forward, static_argnums=(2, 3))


def _images(n=B, size=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _model(**over):
    """(cfg, j_cfg, params) of the tiny model at 64 px (65 tokens, so
    that r 4 merges in every layer), ``over`` on its config."""
    over = dict(num_classes=10, image_size=64, **over)
    cfg = get_model_config(MODEL, **over)
    return cfg, j_config.get_model_config(MODEL, **over), \
        convert.init_vit_params(cfg, 0)


def test_torch_tome_schedule_matches_jax():
    """``merge_schedule`` and ``token_counts`` against JAX's, with and
    without a cls token and at an r that the clamp cuts; r < 0 raises."""
    for over in ({}, {"use_cls_token": False}, {"image_size": 64}):
        cfg = get_model_config(MODEL, **over)
        j_cfg = j_config.get_model_config(MODEL, **over)
        for r in (0, 1, 4, 8, 40):
            assert t_tome.merge_schedule(cfg, r) == \
                j_tome.merge_schedule(j_cfg, r)
            assert t_tome.token_counts(cfg, r) == \
                j_tome.token_counts(j_cfg, r)
    assert t_tome.merge_schedule(cfg, 40)[-1] >= 0
    for lib, c in ((t_tome, cfg), (j_tome, j_cfg)):
        with pytest.raises(ValueError, match=">= 0"):
            lib.merge_schedule(c, -1)


@pytest.mark.parametrize("case", ["random", "ties", "no_cls"])
def test_torch_tome_matching_and_merge_match_jax(case):
    """``_bipartite_indices`` gives JAX's indices exactly (tied scores:
    repeated tokens, resolved by the first maximum and a stable sort; the
    cls token never merges), and ``_merge_sum`` JAX's sums, with several
    sources on one destination."""
    rng = np.random.default_rng(1)
    n, d, r = 13, 8, 4
    metric = rng.standard_normal((2, n, d)).astype(np.float32)
    if case == "ties":
        metric[:, 2] = metric[:, 4] = metric[:, 6] = metric[:, 1]
        metric[:, 3] = metric[:, 5]
    protect = case != "no_cls"
    want = j_tome._bipartite_indices(jnp.asarray(metric), r, protect)
    got = t_tome._bipartite_indices(torch.from_numpy(metric), r, protect)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if protect:
        assert not (got[1] == 0).any() and (got[0][:, 0] == 0).all()
    dst = got[2].numpy()
    if case == "ties":
        assert any(len(set(row)) < len(row) for row in dst)
    x = rng.standard_normal((2, n, 5)).astype(np.float32)
    merged = t_tome._merge_sum(torch.from_numpy(x), *got)
    ref = j_tome._merge_sum(jnp.asarray(x), *want)
    assert merged.shape == (2, n - r, 5)
    np.testing.assert_allclose(merged.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def test_torch_mha_key_bias_matches_jax():
    """``mha``'s key bias (ToMe's proportional attention) against JAX's;
    None leaves the attention bit for bit."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 3, 6, 4)).astype(np.float32)
               for _ in range(3))
    bias = np.log(rng.integers(1, 4, (2, 1, 1, 6)).astype(np.float32))
    want = j_mha(*map(jnp.asarray, (q, k, v)), 0.5, key_bias=bias)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = mha(*t, 0.5, key_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(mha(*t, 0.5), mha(*t, 0.5, key_bias=None))
    assert not torch.allclose(got, mha(*t, 0.5))


@pytest.mark.parametrize("tree", ["dense", "int8", "w8a8", "no_cls"])
def test_torch_tome_forward_matches_jax(tree):
    """Logits of ``tome_forward`` at r 0, 2 and 4 against JAX's on the
    dense, weight-only int8 and w8a8 (``W8A8_TOL``) block trees
    (``quantize_block_weights``, the codes bit for bit) and without a cls
    token; at r 0 it is the plain eval forward of the XLA forms."""
    over = {"use_cls_token": False} if tree == "no_cls" else {}
    cfg, j_cfg, params = _model(**over)
    j_params = params
    t_params = convert.params_from_numpy(params, "cpu")
    if tree in ("int8", "w8a8"):
        mode = "w8" if tree == "int8" else "w8a8"
        j_params = jax.device_get(j_quant.quantize_block_weights(
            jax.tree.map(jnp.asarray, params), mode=mode))
        t_params = t_quant.quantize_block_weights(t_params, mode=mode)
        key = "q" if tree == "int8" else "qa"
        np.testing.assert_array_equal(
            t_params["blocks"]["fc1"]["kernel"][key].numpy(),
            np.asarray(j_params["blocks"]["fc1"]["kernel"][key]))
    x = _images()
    outs = []
    for r in (0, 2, 4):
        want = J_TOME(j_params, jnp.asarray(x), j_cfg, r)
        got = t_tome.tome_forward(t_params, torch.from_numpy(x), cfg, r)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), err_msg=f"r {r}",
            **(W8A8_TOL if tree == "w8a8" else TOL))
        outs.append(got)
    assert not torch.allclose(outs[0], outs[2])  # merging changes the math
    plain = t_vit.vit_forward(t_params, torch.from_numpy(x), cfg,
                              attn_impl="xla", dense_impl="xla")
    np.testing.assert_allclose(outs[0].numpy(), plain.numpy(),
                               **(W8A8_TOL if tree == "w8a8" else TOL))
    with pytest.raises(ValueError, match="dense block tree"):
        t_tome.tome_forward(dict(t_params, blocks={"qkv": None}),
                            torch.from_numpy(x), cfg, 2)


def _checkpoint(tmp_path, cfg, params, method="cara"):
    cc = CaraConfig(method=method, rank=4, scale=2.0,
                    weight_dropout=0.1 if method == "cara" else 0.0,
                    vpt_tokens=2)
    tree = convert.perturb_adapter(convert.init_cara_params(cfg, cc, 1), 2,
                                   std=0.05)
    path = str(tmp_path / f"{method}.npz")
    meta = {**dataclasses.asdict(cc), "model": MODEL,
            "model_overrides": {"image_size": 64}}
    t_ckpt.save_model(path, params, tree, meta)
    return path


def test_torch_tome_predictor_matches_jax(tmp_path):
    """``Predictor(tome_r=...)`` merges the adapter and serves its ToMe
    forward, also int8, as JAX's does; an adapter left unmerged (CaRA with
    ``merge=False``, VPT, the bottleneck adapters, a mixture of experts)
    raises as JAX's does."""
    cfg, _, params = _model()
    path = _checkpoint(tmp_path, cfg, params)
    x = _images(5)
    for quantize in (None, "int8"):
        kw = dict(merge=True, tome_r=3, quantize=quantize, batch_size=4,
                  buckets=None)
        got = t_serving.Predictor.from_checkpoint_auto(
            path, MODEL, device="cpu", dtype=torch.float32, **kw)
        assert got.tome_r == 3 and got._cara is None
        want = j_serving.Predictor.from_checkpoint_auto(
            path, MODEL, dtype=jnp.float32, **kw)
        np.testing.assert_allclose(got.logits(x), want.logits(x), **TOL)
    for method in ("cara", "vpt_deep", "adapter", "moe"):
        cc = CaraConfig(method="cara" if method == "moe" else method,
                        rank=4, scale=2.0, weight_dropout=0.0, vpt_tokens=2,
                        moe_experts=2 if method == "moe" else 0)
        tree = convert.init_cara_params(cfg, cc, 1)
        for cls, kw in ((t_serving.Predictor, dict(device="cpu")),
                        (j_serving.Predictor, {})):
            with pytest.raises(ValueError, match="tome_r requires a dense"):
                cls(params, cfg, cara_params=tree, cara_cfg=cc, tome_r=2,
                    merge=method != "cara", **kw)


def test_torch_tome_cli_flags(tmp_path, monkeypatch):
    """``cli.serve --tome-r`` hands the server a ToMe ``Predictor`` (and
    refuses ``--no-merge`` and several checkpoints, as JAX does);
    ``cli.predict --tome-r`` is held against JAX's in
    ``test_torch_port_export.py``."""
    cfg, _, params = _model()
    path = _checkpoint(tmp_path, cfg, params)
    served = []

    class Server:
        def __init__(self, pred, **kw):
            served.append(pred)
            self.port = 0

        def serve_forever(self):
            raise KeyboardInterrupt

        def close(self):
            pass

    monkeypatch.setattr(t_server, "InferenceServer", Server)
    monkeypatch.setattr(signal, "signal", lambda *args: None)
    argv = ["--ckpt", path, "--model", MODEL, "--device", "cpu", "--dtype",
            "float32", "--no-warmup", "--max-batch", "4", "--tome-r", "3"]
    assert t_serve.main(argv) == 0
    (pred,) = served
    x = _images(2)
    want = t_serving.Predictor.from_checkpoint_auto(
        path, MODEL, device="cpu", dtype=torch.float32, batch_size=4,
        tome_r=3)
    np.testing.assert_allclose(pred.logits(x), want.logits(x), **TOL)
    assert pred.tome_r == 3
    for extra in (["--no-merge"], ["--ckpt", path]):
        with pytest.raises(SystemExit, match="single merged checkpoint"):
            t_serve.main(argv + extra)
