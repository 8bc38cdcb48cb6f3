"""The port past CP rank 64 against the JAX package.

JAX pads a rank below 128 up to 128 in its Pallas kernels and takes any
larger one (``cara_tpu/ops/pallas/cp_dense.py``, ``_pad_rank``); the
port's kernels carry the rank step in k-tiles of 64.  On the CPU the
port runs its kernels' plain twins, which take any rank; these tests
hold them against ``cara_tpu``'s fused / Pallas route in interpret mode
at ranks 96 and 128: ``vit_forward``'s eval logits, one element-route and
one rank-route training forward's gradients of every adapter leaf (JAX's
seeds, gates and masks injected), and a ``cli.vit_cp --synthetic --dim
96 --device cpu`` run.  Tiny model (E 64, depth 2, 17 tokens), numpy
inputs from a seed, fp32, atol = rtol = 1e-4.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_orders as port_orders
import test_torch_port_train as port_train
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import vit as t_vit
from cara_tpu.models import vit as j_vit

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = "vit_tiny_test"


@pytest.mark.parametrize("rank", [96, 128])
def test_torch_vit_forward_eval_past_rank_64_matches_jax(rank):
    """The eval forward with the adapter unmerged (rows 5 and 9's plain
    twins) against JAX's fused route (the Pallas block kernels)."""
    cfg, cc, params, cara, batch, j_cfg, j_cc = port_train._setup(rank=rank)
    ref = j_vit.vit_forward(params, jnp.asarray(batch["image"]), j_cfg,
                            cara_params=cara, cara_cfg=j_cc,
                            attn_impl="fused", dense_impl="fused")
    out = t_vit.vit_forward(convert.params_from_numpy(params, "cpu"),
                            torch.from_numpy(batch["image"]), cfg,
                            convert.params_from_numpy(cara, "cpu"), cc)
    assert cara["P1"].shape[-1] == rank
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["element", "rank"])
def test_torch_train_grads_past_rank_64_match_jax(impl):
    """One training forward and backward at rank 96 on the element route
    (the fold and the masked factor gradients, rows 7, 8, 11 and 14) and
    on the rank route (rows 9, 10, 12 and 13): the logits and every
    adapter leaf's gradient."""
    out, ref, grads, j_g, _ = port_orders._train_pair(
        4, "factorized", rank=96, weight_dropout_impl=impl)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    assert sorted(grads) == sorted(j_g)
    for name, g in grads.items():
        assert g.abs().sum() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(j_g[name]), **TOL,
                                   err_msg=name)


def test_torch_cli_trains_at_rank_96_on_cpu(tmp_path, capsys):
    """``cli.vit_cp --dim 96``: one epoch of one step, its logged loss
    finite, and the model it built of rank 96 (the parameter count)."""
    t_cli.main([
        "--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
        "--batch-size", "8", "--eval-batch-size", "8", "--synthetic-size",
        "8", "--dtype", "float32", "--backbone", str(tmp_path / "none.npz"),
        "--out-dir", str(tmp_path / "run"), "--log-every", "1", "--dim",
        "96", "--epochs", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    steps = [json.loads(l) for l in lines if l.startswith('{"epoch"')]
    assert len(steps) == 1 and steps[0]["step"] == 1
    assert np.isfinite(steps[0]["loss"])
    count = [l for l in lines if l.startswith("Total parameters:")]
    cara = port_train._setup(rank=96)[3]  # the adapter's leaves at rank 96
    assert count == [f"Total parameters: {sum(v.size for v in cara.values())}"]
