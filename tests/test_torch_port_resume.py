"""Adapter-only files, resume snapshots and preemption of the port
against the JAX package's.

Adapter npz files round-trip and each package reads the other's; the
port's snapshots (``step_%08d/`` with ``state.npz`` and ``extra.json``,
``keep_last`` pruning, a rename into place) restore the step, the
trainables, AdamW's moments and the generator, so a restored step equals
the uninterrupted run's next step bit for bit with dropout on; SIGTERM at
step 4 and a relaunch through both packages' CLIs (as
``tests/test_preempt.py``, weight dropout and drop-path 0, both runs from
the port's initial weights) snapshot at the same step and end with the
same trainables (atol = rtol = 1e-4).
"""

import contextlib
import dataclasses
import io
import os
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_port_train as port_train
from cara_tpu_torch import api as t_api
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu_torch.train import loop as t_loop
from cara_tpu_torch.train import steps as t_steps
from cara_tpu.cli import vit_cp as j_cli
from cara_tpu.train import checkpoint as j_ckpt
from cara_tpu.train import loop as j_loop

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = "vit_tiny_test"


def _adapter_trees():
    cfg = get_model_config(MODEL)
    cc = CaraConfig(rank=4, scale=2.0)
    cara = convert.perturb_adapter(convert.init_cara_params(cfg, cc, 1), 2)
    head = {"kernel": np.arange(640, dtype=np.float32).reshape(64, 10),
            "bias": np.ones(10, np.float32)}
    return cara, head


def test_torch_adapter_files_round_trip_across_packages(tmp_path):
    cara, head = _adapter_trees()
    meta = {"scale": 2.0, "model": MODEL}
    for writer, reader in ((t_ckpt, j_ckpt), (j_ckpt, t_ckpt),
                           (t_ckpt, t_ckpt)):
        path = str(tmp_path / f"{writer.__name__}-{reader.__name__}.npz")
        tensors = convert.params_from_numpy(cara, "cpu")
        writer.save_adapter(path, tensors if writer is t_ckpt else cara,
                            head, meta)
        assert reader.is_adapter_checkpoint(path)
        got, got_head, got_meta = reader.load_adapter(path)
        assert got_meta == meta
        flat, want = port_train._flat(got), port_train._flat(cara)
        assert sorted(flat) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(flat[k]), want[k])
        np.testing.assert_array_equal(np.asarray(got_head["kernel"]),
                                      head["kernel"])
    full = str(tmp_path / "full.npz")
    t_ckpt.save_model(full, {"head": head}, cara, meta)
    assert not t_ckpt.is_adapter_checkpoint(full)
    assert not j_ckpt.is_adapter_checkpoint(full)
    t_ckpt.save_adapter(str(tmp_path / "bare.npz"), cara)
    assert t_ckpt.load_adapter(str(tmp_path / "bare.npz"))[1:] == (None, {})


def _train_setup(**over):
    cfg = get_model_config(MODEL, num_classes=10, drop_path_rate=0.5,
                           **over)
    cc = CaraConfig(rank=4, scale=2.0, weight_dropout=0.1)
    params = convert.init_vit_params(cfg, 0)
    cara = convert.perturb_adapter(convert.init_cara_params(cfg, cc, 1), 2,
                                   std=0.05)
    rng = np.random.default_rng(3)
    batch = {"image": torch.from_numpy(
        rng.standard_normal((4, 32, 32, 3)).astype(np.float32)),
        "label": torch.from_numpy(rng.integers(0, 10, 4))}
    return cfg, cc, params, cara, batch


def test_torch_snapshot_round_trip_and_pruning(tmp_path):
    cfg, cc, params, cara, batch = _train_setup()
    frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1)
    step = t_steps.make_train_step(cfg, cc)
    gen = torch.Generator().manual_seed(0)
    d = str(tmp_path / "resume")
    assert t_ckpt.latest_step(d) is None
    digests = {}
    for _ in range(5):
        state, _ = step(state, frozen, batch, generator=gen)
        digests[state.step] = t_ckpt.save_train_state(
            d, state.step, state, {"epoch": state.step // 2}, generator=gen)
    os.makedirs(os.path.join(d, "step_00000009.tmp123"))  # a torn write
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004",
                                     "step_00000005", "step_00000009.tmp123"]
    assert t_ckpt.latest_step(d) == 5
    assert sorted(os.listdir(os.path.join(d, "step_00000005"))) == [
        "extra.json", "state.npz"]
    _, fresh = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1)
    gen2 = torch.Generator().manual_seed(99)
    fit_cfg = t_loop.FitConfig(epochs=3)
    restored, fit_cfg = t_loop.maybe_resume(d, fresh, fit_cfg, gen2)
    assert restored.step == 5 and fit_cfg.start_epoch == 2
    assert t_ckpt.digest(t_ckpt.snapshot_arrays(restored, gen2)) == \
        digests[5] == t_ckpt.digest(t_ckpt.snapshot_arrays(state, gen))
    # a tree of another shape is refused
    _, other = t_steps.init_train_state(params, {}, "cpu", 1e-3, 1,
                                        method="linear")
    with pytest.raises(ValueError, match="does not match"):
        t_ckpt.restore_train_state(d, 5, other)


def test_torch_restored_step_equals_the_uninterrupted_one(tmp_path):
    """With weight, activation and attention dropout and drop-path on, a
    step taken after restoring a snapshot into a fresh state and a
    generator of another seed gives the uninterrupted run's next step bit
    for bit."""
    cfg, cc, params, cara, batch = _train_setup(dropout_rate=0.1,
                                                attn_dropout_rate=0.1)
    frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1)
    step = t_steps.make_train_step(cfg, cc)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, _ = step(state, frozen, batch, generator=gen)
    t_ckpt.save_train_state(str(tmp_path), 2, state, {"epoch": 0},
                            generator=gen)
    state, m = step(state, frozen, batch, generator=gen)
    _, fresh = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1)
    gen2 = torch.Generator().manual_seed(1)
    fresh, extra = t_ckpt.restore_train_state(str(tmp_path), 2, fresh, gen2)
    assert extra == {"epoch": 0}
    fresh, m2 = step(fresh, frozen, batch, generator=gen2)
    assert fresh.step == state.step == 3
    assert torch.equal(m["loss"], m2["loss"])
    mine = t_steps.tree_leaves(state.trainable)
    for (path, a), (_, b) in zip(mine, t_steps.tree_leaves(fresh.trainable)):
        assert torch.equal(a, b), path
        sa, sb = (state.opt.optimizer.state[a],
                  fresh.opt.optimizer.state[b])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"]), path


def _cli_args(tmp_path, extra):
    return ["--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
            "--batch-size", "8", "--eval-batch-size", "8",
            "--synthetic-size", "64", "--dtype", "float32",
            "--backbone", str(tmp_path / "missing.npz"),
            "--out-dir", str(tmp_path), "--log-every", "1000", "--dim", "4",
            "--resume-dir", str(tmp_path / "resume"), "--weight-dropout",
            "0", "--model-override", "drop_path_rate=0", "--epochs", "2",
            *extra]


def _preempt_at_4(mp, module, real):
    count = {"n": 0}

    def prefetch_and_preempt(*args, **kw):
        for b in real(*args, **kw):
            count["n"] += 1
            if count["n"] == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    mp.setattr(module, "prefetch", prefetch_and_preempt)


def _run_preempted(tmp_path, main, module, extra, mp):
    real = module.prefetch
    before = signal.getsignal(signal.SIGTERM)
    _preempt_at_4(mp, module, real)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(_cli_args(tmp_path, extra))
    assert "Preempted (SIGTERM) at step 4" in out.getvalue(), out.getvalue()
    assert '"preempted": true' in out.getvalue()
    assert signal.getsignal(signal.SIGTERM) is before
    mp.setattr(module, "prefetch", real)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        acc = main(_cli_args(tmp_path, extra))
    assert "resumed from" in out.getvalue() and "step 4" in out.getvalue()
    assert "Preempted" not in out.getvalue()
    files = sorted(tmp_path.glob("vit_patch_camelyon_*_seed_89.npz"))
    assert acc > 0 and len(files) == 1
    return files[0]


def test_torch_sigterm_and_relaunch_match_jax_cli(tmp_path, monkeypatch):
    real_build = j_cli.api.build_model

    def build_from_port_init(name, **kw):
        """JAX's model with the port's seeded initial weights."""
        model = real_build(name, **kw)
        mine = t_api.build_model(
            name, rank=kw["rank"], scale=kw["scale"], l_mu=kw["l_mu"],
            l_std=kw["l_std"], num_classes=kw["num_classes"],
            seed=kw["seed"], backbone_path=kw["backbone_path"],
            weight_dropout=kw["weight_dropout"],
            model_overrides=kw["model_overrides"])
        as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa
        return dataclasses.replace(model, params=as_jax(mine.params),
                                   cara_params=as_jax(mine.cara_params))

    monkeypatch.setattr(j_cli.api, "build_model", build_from_port_init)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    j_file = _run_preempted(tmp_path / "jax", j_cli.main, j_loop, [],
                            monkeypatch)
    t_file = _run_preempted(tmp_path / "port", t_cli.main, t_loop,
                            ["--device", "cpu"], monkeypatch)
    assert (j_ckpt.latest_step(str(tmp_path / "jax" / "resume"))
            == t_ckpt.latest_step(str(tmp_path / "port" / "resume")) == 4)
    j_params, j_cara, _ = j_ckpt.load_model(str(j_file))
    t_params, t_cara, _ = t_ckpt.load_model(str(t_file))
    want = port_train._flat({"params": j_params, "cara": j_cara})
    got = port_train._flat({"params": t_params, "cara": t_cara})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
