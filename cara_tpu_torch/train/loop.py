"""The fine-tuning protocol: fit and evaluate (port of
``cara_tpu/train/loop.py``, single device).

N epochs over the train loader, eval every ``eval_every`` epochs (skipping
epoch 0), best-checkpoint rotation and a final re-eval
(``image_classification/vit_cp.py:19-70``).  Batches reach the device
from pinned host memory one step ahead of use; metrics are fetched only
on the ``log_every`` cadence, which is also where the throughput is
taken (wall time between two fetches, as the reference package does).

What JAX's loop adds to the reference, ported: a ``torch.profiler``
trace (``profile_dir``), a one-time memory report of the first step,
lambda telemetry through the :class:`MetricLogger`, resume snapshots
every ``resume_every_steps`` steps, and SIGTERM handling
(:func:`preemption_watcher`): at the next step boundary the run saves a
snapshot, logs a ``preempted`` record and returns without the final
eval.  :func:`maybe_resume` restores the newest snapshot; the run then
restarts at the first batch of the epoch the snapshot names with the
restored step, moments, schedule position and ``torch.Generator`` state
(JAX's semantics; JAX folds the step into its key, the port carries the
generator's state, so a restored step draws what the uninterrupted run
would have drawn).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from cara_tpu_torch.train import checkpoint as ckpt_lib
from cara_tpu_torch.train import steps as steps_lib
from cara_tpu_torch.utils.logging import MetricLogger
from cara_tpu_torch.utils.profiling import memory_report, trace


@dataclasses.dataclass
class FitConfig:
    epochs: int = 100
    eval_every: int = 10
    eval_start: int = 1          # vit_cp: any epoch != 0
    log_every: int = 10          # steps between metric log lines
    lambda_telemetry: bool = False
    profile_dir: Optional[str] = None
    memory_report: bool = False  # log the first step's device memory once
    resume_dir: Optional[str] = None
    resume_every_steps: int = 0  # 0 = disabled
    start_epoch: int = 0         # set by maybe_resume


class _PreemptFlag:
    """Set asynchronously by the signal handler, read at step boundaries."""

    def __init__(self):
        self.fired = False
        self.signum: Optional[int] = None


@contextlib.contextmanager
def preemption_watcher(enabled: bool = True):
    """Catch SIGTERM and flip a flag instead of dying mid-step
    (``cara_tpu/train/loop.py:63-88``): ``fit`` polls the flag at every
    step boundary, saves a resume snapshot (when ``resume_dir`` is set)
    and returns, so a relaunched job continues through
    :func:`maybe_resume`.  The previous handler is restored on exit;
    outside the main thread (``fit`` driven from a worker) the watcher is
    a no-op, since CPython registers signals on the main thread only."""
    flag = _PreemptFlag()
    if not enabled or threading.current_thread() is not threading.main_thread():
        yield flag
        return

    def _handler(signum, frame):
        flag.fired, flag.signum = True, signum

    prev = signal.signal(signal.SIGTERM, _handler)
    try:
        yield flag
    finally:
        signal.signal(signal.SIGTERM, prev)


def maybe_resume(resume_dir: Optional[str], state, fit_cfg: FitConfig,
                 generator: Optional[torch.Generator] = None):
    """The newest snapshot in ``resume_dir`` as a new state shaped and
    set up as ``state`` (``generator`` takes its saved state); returns
    (state, fit_cfg) with ``start_epoch`` set to the snapshot's epoch.
    Without a snapshot both return unchanged."""
    if not resume_dir:
        return state, fit_cfg
    last = ckpt_lib.latest_step(resume_dir)
    if last is None:
        return state, fit_cfg
    state, extra = ckpt_lib.restore_train_state(resume_dir, last, state,
                                                generator)
    start_epoch = int((extra or {}).get("epoch", 0))
    print(f"[cara_tpu] resumed from {resume_dir} step {last} "
          f"(epoch {start_epoch})", flush=True)
    return state, dataclasses.replace(fit_cfg, start_epoch=start_epoch)


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; host arrays are pinned so the
    copy runs asynchronously on the current stream."""
    out = {}
    pin = torch.device(device).type == "cuda"
    for key, val in batch.items():
        t = torch.as_tensor(val)
        if pin:
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=pin)
    return out


def prefetch(loader, device):
    """Yield device batches with the next one already in flight."""
    pending = None
    for batch in loader:
        nxt = to_device(batch, device)
        if pending is not None:
            yield pending
        pending = nxt
    if pending is not None:
        yield pending


def evaluate(eval_step: Callable, params, cara_params, loader,
             device) -> float:
    """sum(correct) / sum(valid) over a loader (the plain-mean equivalent
    of the reference's avalanche Accuracy, ``vit_cp.py:73-82``)."""
    correct = total = None
    for batch in prefetch(loader, device):
        c, t = eval_step(params, cara_params, batch)
        correct = c if correct is None else correct + c
        total = t if total is None else total + t
    if total is None:
        return 0.0
    return float(correct) / max(float(total), 1.0)


def fit(*, cfg, cara_cfg, frozen, state: steps_lib.TrainState,
        train_loader, eval_loader, device,
        generator: Optional[torch.Generator] = None,
        fit_cfg: FitConfig = FitConfig(), logger: Optional[MetricLogger] = None,
        keeper=None, eval_step: Optional[Callable] = None,
        compute_dtype=None, ckpt_meta: Optional[Dict[str, Any]] = None,
        attn_impl: str = "auto", dense_impl: str = "auto", remat="auto",
        grad_accum: int = 1, nan_check: bool = False) -> Dict[str, Any]:
    """Run the fine-tuning protocol; returns a summary with ``best_acc``,
    ``final_acc`` (None when preempted), ``preempted``,
    ``images_per_sec`` and ``last_loss``.  ``frozen`` is the fp32
    backbone (kept for the checkpoint; empty for full fine-tuning, whose
    backbone trains); its compute-dtype copy is made once here.  An empty
    adapter tree (the linear probe, full fine-tuning) evaluates and is
    saved as no adapter: the checkpoint holds the whole model, with
    ``method`` in its meta.  ``remat``, ``grad_accum`` and ``nan_check``
    are :func:`~cara_tpu_torch.train.steps.make_train_step`'s."""
    logger = logger or MetricLogger(enabled=True)
    meta = {**dataclasses.asdict(cara_cfg), **(ckpt_meta or {})}
    train_step = steps_lib.make_train_step(
        cfg, cara_cfg, compute_dtype=compute_dtype, attn_impl=attn_impl,
        dense_impl=dense_impl, remat=remat, grad_accum=grad_accum,
        nan_check=nan_check)
    eval_step = eval_step or steps_lib.make_eval_step(
        cfg, cara_cfg, compute_dtype=compute_dtype, attn_impl=attn_impl,
        dense_impl=dense_impl)
    frozen_compute = (steps_lib.cast_floating(frozen, compute_dtype)
                      if compute_dtype is not None else frozen)
    bs = train_loader.batch_size
    best_acc = 0.0
    imgs_per_sec = 0.0
    last_metrics: Dict[str, Any] = {}
    # Start from the restored step, so that a resumed run never counts
    # the steps before the snapshot as its own work.
    sync_t, sync_step = time.perf_counter(), state.step
    mem_reported = not fit_cfg.memory_report

    def host_trees():
        with torch.no_grad():
            params = steps_lib.merge_params(frozen, state.trainable)
            return params, state.trainable["cara"] or None

    def snapshot(epoch):
        ckpt_lib.save_train_state(fit_cfg.resume_dir, state.step, state,
                                  {"epoch": epoch}, generator=generator)

    with trace(fit_cfg.profile_dir), preemption_watcher() as preempt:
        for epoch in range(fit_cfg.start_epoch, fit_cfg.epochs):
            for batch in prefetch(train_loader, device):
                if mem_reported:
                    state, metrics = train_step(state, frozen_compute, batch,
                                                generator=generator)
                else:
                    (state, metrics), rec = memory_report(
                        train_step, state, frozen_compute, batch,
                        generator=generator)
                    print(json.dumps({"train_step_memory": rec}), flush=True)
                    mem_reported = True
                step = state.step
                if step % fit_cfg.log_every == 0:
                    loss = float(metrics["loss"])  # device sync
                    now = time.perf_counter()
                    if step > sync_step:
                        imgs_per_sec = (step - sync_step) * bs / (
                            now - sync_t)
                    sync_t, sync_step = now, step
                    rec = {"epoch": epoch, "loss": loss,
                           "accuracy": float(metrics["accuracy"]),
                           "grad_norm": float(metrics["grad_norm"]),
                           "images_per_sec": imgs_per_sec}
                    if fit_cfg.lambda_telemetry:
                        rec.update(logger.lambda_stats(
                            state.trainable["cara"]))
                    logger.log(rec, step=step)
                if (fit_cfg.resume_dir and fit_cfg.resume_every_steps
                        and step % fit_cfg.resume_every_steps == 0):
                    snapshot(epoch)
                last_metrics = metrics
                if preempt.fired:
                    # SIGTERM mid-epoch: save the resumable state now (the
                    # periodic cadence may be far away or off) and unwind.
                    if fit_cfg.resume_dir:
                        snapshot(epoch)
                    logger.log({"preempted": True, "epoch": epoch,
                                "resume_saved": bool(fit_cfg.resume_dir)},
                               step=step)
                    break
            if preempt.fired:
                break
            if (epoch % fit_cfg.eval_every == 0 and epoch != 0
                    and epoch >= fit_cfg.eval_start):
                acc = evaluate(eval_step,
                               steps_lib.merge_params(frozen_compute,
                                                      state.trainable),
                               state.trainable["cara"] or None, eval_loader,
                               device)
                logger.log({"epoch": epoch, "val_acc": acc}, step=state.step)
                if acc > best_acc:
                    best_acc = acc
                    if keeper is not None:
                        keeper.update(acc, *host_trees(), meta=meta)

    if imgs_per_sec == 0.0 and state.step > sync_step and last_metrics:
        float(last_metrics["loss"])  # device sync
        imgs_per_sec = (state.step - sync_step) * bs / (
            time.perf_counter() - sync_t)
    # The final evaluation (vit_cp.py:189-196), skipped when preempted:
    # the grace window is for the snapshot, and the relaunched run
    # evaluates on its own cadence.
    final_acc = None
    if not preempt.fired:
        final_acc = evaluate(eval_step,
                             steps_lib.merge_params(frozen_compute,
                                                    state.trainable),
                             state.trainable["cara"] or None, eval_loader,
                             device)
        if final_acc > best_acc:
            best_acc = final_acc
            if keeper is not None:
                keeper.update(final_acc, *host_trees(), meta=meta)
    if keeper is not None:
        keeper.wait()
    return {"best_acc": best_acc, "final_acc": final_acc, "state": state,
            "frozen": frozen, "images_per_sec": imgs_per_sec,
            "preempted": preempt.fired,
            "last_loss": (float(last_metrics["loss"]) if last_metrics
                          else None)}
