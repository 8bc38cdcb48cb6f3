"""Profiling hooks (port of ``cara_tpu/utils/profiling.py``).

* :class:`StepTimer`: wall-clock step timing with warm-up exclusion and
  images per second.
* :func:`trace`: a ``torch.profiler`` trace behind a flag (CPU activity,
  and the card's kernels where there is one), written as a Chrome trace
  (``trace_<pid>.json``) into the directory; the counterpart of the
  ``jax.profiler`` xplane dump.
* :func:`annotate`: a named span inside the trace (``record_function``).
* :func:`memory_report`: the device memory of one train step, from the
  caching allocator's counters, where JAX reads the compiled step's
  ``memory_analysis``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class StepTimer:
    """Tracks step wall time with warmup exclusion; reports images/sec."""

    def __init__(self, batch_size: int, warmup_steps: int = 2):
        self.batch_size = batch_size
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self):
        self._count = 0
        self._total = 0.0
        self._last: Optional[float] = None

    def __enter__(self):
        self._last = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._last
        self._count += 1
        if self._count > self.warmup_steps:
            self._total += dt
        return False

    @property
    def steps_timed(self) -> int:
        return max(self._count - self.warmup_steps, 0)

    @property
    def mean_step_time(self) -> float:
        return self._total / self.steps_timed if self.steps_timed else 0.0

    @property
    def images_per_sec(self) -> float:
        t = self.mean_step_time
        return self.batch_size / t if t > 0 else 0.0


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace when ``log_dir`` is set; no-op otherwise.
    The Chrome trace is written into ``log_dir`` when the block exits,
    also when it exits early (a preempted run)."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """Named span inside a trace (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


def _mib(nbytes: float) -> float:
    return round(nbytes / 2 ** 20, 2)


def tensor_bytes(*trees) -> int:
    """Bytes of every tensor in nested dicts, lists and tuples."""
    total = 0
    for tree in trees:
        if isinstance(tree, dict):
            total += tensor_bytes(*tree.values())
        elif isinstance(tree, (list, tuple)):
            total += tensor_bytes(*tree)
        elif isinstance(tree, torch.Tensor):
            total += tree.numel() * tree.element_size()
    return total


def memory_report(step, state, frozen, batch, **kwargs):
    """Run one train step, ``step(state, frozen, batch, **kwargs)``, and
    return ``(its result, report)``.  The report gives, in MiB,
    ``argument_mib``: the bytes of the step's arguments after it (the
    trainables and the optimizer's moments, the backbone, the batch);
    ``temp_mib``: the peak the step adds to what was allocated before it
    (``max_memory_allocated`` after a reset); ``total_mib``: that peak.
    It is None off the card, as JAX's is where the backend has no memory
    analysis.  JAX compiles the step and reads the report before running
    it; here the first step itself is measured."""
    dev = batch["image"].device
    if dev.type != "cuda":
        return step(state, frozen, batch, **kwargs), None
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    result = step(state, frozen, batch, **kwargs)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    moments = [v for s in state.opt.optimizer.state.values()
               for v in s.values() if isinstance(v, torch.Tensor)]
    arg_bytes = tensor_bytes(state.trainable, moments, frozen, batch)
    return result, {"argument_mib": _mib(arg_bytes),
                    "temp_mib": _mib(peak - before),
                    "total_mib": _mib(peak)}
