"""The fine-tuning protocol: fit and evaluate (port of
``cara_tpu/train/loop.py``, single device).

N epochs over the train loader, eval every ``eval_every`` epochs (skipping
epoch 0), best-checkpoint rotation and a final re-eval
(``image_classification/vit_cp.py:19-70``).  Batches reach the device
from pinned host memory one step ahead of use; metrics are fetched only
on the ``log_every`` cadence, which is also where the throughput is
taken (wall time between two fetches, as the reference package does).
Resume, preemption handling, profiling and the memory report are not
ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, Optional

import torch

from cara_tpu_torch.train import steps as steps_lib

_TODO = "ROADMAP.md queue 1: training modules still to port"


@dataclasses.dataclass
class FitConfig:
    epochs: int = 100
    eval_every: int = 10
    eval_start: int = 1          # vit_cp: any epoch != 0
    log_every: int = 10          # steps between metric log lines
    profile_dir: Optional[str] = None
    memory_report: bool = False
    resume_dir: Optional[str] = None
    resume_every_steps: int = 0

    def __post_init__(self):
        if self.profile_dir or self.memory_report:
            raise NotImplementedError(
                f"profiling and the memory report are not yet ported "
                f"({_TODO})")
        if self.resume_dir or self.resume_every_steps:
            raise NotImplementedError(
                f"resume checkpoints and preemption handling are not yet "
                f"ported ({_TODO})")


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


def _log(rec: Dict[str, Any], step: int) -> None:
    print(json.dumps({**rec, "step": step, "ts": round(time.time(), 3)}),
          flush=True)


def fit(*, cfg, cara_cfg, frozen, state: steps_lib.TrainState,
        train_loader, eval_loader, device,
        generator: Optional[torch.Generator] = None,
        fit_cfg: FitConfig = FitConfig(), keeper=None,
        eval_step: Optional[Callable] = None, compute_dtype=None,
        ckpt_meta: Optional[Dict[str, Any]] = None,
        attn_impl: str = "auto", dense_impl: str = "auto") -> Dict[str, Any]:
    """Run the fine-tuning protocol; returns a summary with ``best_acc``,
    ``final_acc``, ``images_per_sec`` and ``last_loss``.  ``frozen`` is
    the fp32 backbone (kept for the checkpoint; empty for full
    fine-tuning, whose backbone trains); its compute-dtype copy is made
    once here.  An empty adapter tree (the linear probe, full
    fine-tuning) evaluates and is saved as no adapter: the checkpoint
    holds the whole model, with ``method`` in its meta."""
    meta = {**dataclasses.asdict(cara_cfg), **(ckpt_meta or {})}
    train_step = steps_lib.make_train_step(
        cfg, cara_cfg, compute_dtype=compute_dtype, attn_impl=attn_impl,
        dense_impl=dense_impl)
    eval_step = eval_step or steps_lib.make_eval_step(
        cfg, cara_cfg, compute_dtype=compute_dtype, attn_impl=attn_impl,
        dense_impl=dense_impl)
    frozen_compute = (steps_lib.cast_floating(frozen, compute_dtype)
                      if compute_dtype is not None else frozen)
    bs = train_loader.batch_size
    best_acc = 0.0
    imgs_per_sec = 0.0
    last_metrics: Dict[str, Any] = {}
    sync_t, sync_step = time.perf_counter(), state.step

    def host_trees():
        with torch.no_grad():
            params = steps_lib.merge_params(frozen, state.trainable)
            return params, state.trainable["cara"] or None

    for epoch in range(fit_cfg.epochs):
        for batch in prefetch(train_loader, device):
            state, metrics = train_step(state, frozen_compute, batch,
                                        generator=generator)
            last_metrics = metrics
            if state.step % fit_cfg.log_every == 0:
                loss = float(metrics["loss"])  # device sync
                now = time.perf_counter()
                if state.step > sync_step:
                    imgs_per_sec = (state.step - sync_step) * bs / (
                        now - sync_t)
                sync_t, sync_step = now, state.step
                _log({"epoch": epoch, "loss": loss,
                      "accuracy": float(metrics["accuracy"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "images_per_sec": imgs_per_sec}, state.step)
        if (epoch % fit_cfg.eval_every == 0 and epoch != 0
                and epoch >= fit_cfg.eval_start):
            acc = evaluate(eval_step,
                           steps_lib.merge_params(frozen_compute,
                                                  state.trainable),
                           state.trainable["cara"] or None, eval_loader,
                           device)
            _log({"epoch": epoch, "val_acc": acc}, state.step)
            if acc > best_acc:
                best_acc = acc
                if keeper is not None:
                    keeper.update(acc, *host_trees(), meta=meta)

    if imgs_per_sec == 0.0 and state.step > sync_step and last_metrics:
        float(last_metrics["loss"])  # device sync
        imgs_per_sec = (state.step - sync_step) * bs / (
            time.perf_counter() - sync_t)
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
            "last_loss": (float(last_metrics["loss"]) if last_metrics
                          else None)}
