"""The port's logging, profiling, NaN check and kernel build cache, and
the training CLI's flags that reach them, against the JAX package where
it has a twin.

``lambda_stats`` equal to JAX's on the same R1 / R2; the metric line and
the wandb note (wandb is not installed here) as JAX writes them;
``--memory-report`` prints ``null`` on the CPU, as JAX does where the
backend has no memory analysis; ``--profile-dir`` writes a Chrome trace;
``nan_check`` raises ``FloatingPointError`` on a NaN batch, naming the
step and the first such tensor, and not without it; the build cache
(``--compilation-cache`` / ``$CARA_JIT_CACHE``) moves the kernel build
and loads a library whose stamp matches without building.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from cara_tpu_torch.cli import common as t_common
from cara_tpu_torch.cli import vit_cp as t_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.ops.cuda import _build
from cara_tpu_torch.train import steps as t_steps
from cara_tpu_torch.utils import jit_cache as t_cache
from cara_tpu_torch.utils import logging as t_logging
from cara_tpu_torch.utils import profiling as t_prof
from cara_tpu.utils import logging as j_logging

MODEL = "vit_tiny_test"
PORTED = ("grad_accum", "no_remat", "resume_dir", "resume_every_steps",
          "profile_dir", "memory_report", "nan_check", "wandb",
          "compilation_cache", "merged_eval")


def test_torch_lambda_stats_match_jax():
    rng = np.random.default_rng(0)
    cara = {"R1": rng.standard_normal((8,)).astype(np.float32),
            "R2": rng.standard_normal((12, 8)).astype(np.float32)}
    j = j_logging.MetricLogger(enabled=False)
    t = t_logging.MetricLogger(enabled=False)
    for hist in (False, True):
        want = j.lambda_stats(cara, histogram=hist)
        assert t.lambda_stats(cara, histogram=hist) == want
        assert t.lambda_stats(convert.params_from_numpy(cara, "cpu"),
                              histogram=hist) == want
    assert t.lambda_stats({}) == j.lambda_stats({}) == {}


def test_torch_metric_logger_writes_what_jax_writes(capsys):
    lines = []
    for mod in (j_logging, t_logging):
        buf = io.StringIO()
        logger = mod.MetricLogger(use_wandb=True, stream=buf)
        logger.log({"loss": torch.tensor(0.5) if mod is t_logging
                    else np.float32(0.5), "epoch": 2, "preempted": True},
                   step=7)
        rec = json.loads(buf.getvalue())
        rec.pop("ts")
        lines.append(rec)
        logger.finish()
    assert lines[0] == lines[1] == {"loss": 0.5, "epoch": 2.0,
                                    "preempted": True, "step": 7}
    notes = capsys.readouterr().err.strip().splitlines()
    assert len(notes) == 2 and notes[0] == notes[1]
    assert "wandb unavailable" in notes[0]


def _cli(tmp_path, *extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        acc = t_cli.main([
            "--synthetic", "--dataset", "patch_camelyon", "--model", MODEL,
            "--batch-size", "8", "--eval-batch-size", "8",
            "--synthetic-size", "16", "--dtype", "float32", "--backbone",
            str(tmp_path / "none.npz"), "--out-dir", str(tmp_path),
            "--log-every", "1", "--dim", "4", "--epochs", "1", "--device",
            "cpu", *extra])
    return acc, buf.getvalue()


def test_torch_cli_memory_report_trace_and_telemetry(tmp_path):
    acc, out = _cli(tmp_path, "--memory-report", "--profile-dir",
                    str(tmp_path / "prof"), "--wandb", "--grad-accum", "2",
                    "--nan-check", "--no-remat")
    lines = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    assert lines[0] == {"train_step_memory": None}
    steps = [l for l in lines if "loss" in l]
    assert [l["step"] for l in steps] == [1, 2]
    assert all("r1_mean" in l and "r2_std" in l for l in steps)
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(tmp_path / "prof" / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any("aten::" in str(n) for n in names)
    assert 0.0 <= acc <= 1.0


def test_torch_ported_flags_leave_unported():
    assert not set(PORTED) & set(t_common.UNPORTED)
    args = t_cli.parse_args(["--grad-accum", "2", "--no-remat",
                             "--resume-dir", "r", "--resume-every-steps",
                             "3", "--nan-check", "--compilation-cache", "c",
                             "--merged-eval"])
    assert (args.grad_accum, args.no_remat, args.resume_every_steps) == (
        2, True, 3)


def _nan_setup():
    cfg = get_model_config(MODEL, num_classes=10)
    cc = CaraConfig(rank=4, scale=2.0, weight_dropout=0.1)
    params = convert.init_vit_params(cfg, 0)
    cara = convert.init_cara_params(cfg, cc, 1)
    frozen, state = t_steps.init_train_state(params, cara, "cpu", 1e-3, 1)
    rng = np.random.default_rng(0)
    image = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    batch = {"image": torch.from_numpy(image),
             "label": torch.from_numpy(rng.integers(0, 10, 4))}
    return cfg, cc, frozen, state, batch


def test_torch_nan_check_raises_on_a_nan_batch():
    cfg, cc, frozen, state, batch = _nan_setup()
    gen = torch.Generator().manual_seed(0)
    checked = t_steps.make_train_step(cfg, cc, nan_check=True)
    state, m = checked(state, frozen, batch, generator=gen)
    assert torch.isfinite(m["loss"])
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][2, 5, 5, 0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"at step 1 in loss .*LogSoftmaxBackward"):
        checked(state, frozen, bad, generator=gen)
    assert state.step == 1  # no update was taken
    unchecked = t_steps.make_train_step(cfg, cc)
    state, m = unchecked(state, frozen, bad, generator=gen)
    assert not torch.isfinite(m["loss"])
    with pytest.raises(FloatingPointError, match="in grad cara/"):
        t_steps.check_finite(3, [("loss", torch.tensor(1.0)),
                                 ("grad cara/R1", torch.tensor([np.inf]))])


def test_torch_compilation_cache_moves_and_reuses_the_build(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.delenv("CARA_JIT_CACHE", raising=False)
    default = _build.BUILD_DIR
    assert t_cache.enable_compilation_cache() == str(default)
    monkeypatch.setenv("CARA_JIT_CACHE", "0")
    assert t_cache.enable_compilation_cache() == str(default)
    monkeypatch.setenv("CARA_JIT_CACHE", str(tmp_path / "env"))
    assert _build.BUILD_DIR != tmp_path / "env"
    assert t_cache.enable_compilation_cache() == str(tmp_path / "env")
    cache = tmp_path / "cache"
    t_common.setup_runtime(type("A", (), {"compilation_cache":
                                          str(cache)})())
    assert _build.BUILD_DIR == cache
    # a library whose stamp matches the sources loads without nvcc
    (cache / _build.LIB_NAME).write_bytes(b"")
    (cache / (_build.LIB_NAME + ".sha256")).write_text(_build._digest())
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("built"))
    assert _build.build() == cache / _build.LIB_NAME
    assert _build.BUILD_INFO["cached"] is True
    monkeypatch.setattr(_build, "_lib", object())
    with pytest.raises(RuntimeError, match="before the first kernel call"):
        t_cache.enable_compilation_cache(str(tmp_path / "late"))


def test_torch_step_timer_counts_after_warmup():
    timer = t_prof.StepTimer(batch_size=8, warmup_steps=1)
    for _ in range(3):
        with timer:
            pass
    assert timer.steps_timed == 2 and timer.images_per_sec > 0
    assert t_prof.tensor_bytes({"a": torch.zeros(4)}, [torch.zeros(2, 2,
                               dtype=torch.bfloat16)]) == 24
