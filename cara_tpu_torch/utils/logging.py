"""Metric logging: JSON lines on stdout, optionally teed to wandb (port of
``cara_tpu/utils/logging.py``).

The reference's metric surface (per-batch loss, epoch, val_acc and the
lambda diagnostics of ``CP_R1`` / ``CP_R2``,
``image_classification/vit_cp.py:30-44``) behind a logger that needs no
wandb: ``use_wandb=True`` tees to it when ``wandb`` imports and starts,
and otherwise says so on stderr and keeps to stdout.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional

import numpy as np


class MetricLogger:
    """stdout JSON-lines logger; optionally tees to wandb if available."""

    def __init__(self, use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict] = None, stream=None,
                 enabled: bool = True):
        self.enabled = enabled
        self.stream = stream or sys.stdout
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(**(wandb_kwargs or {}))
            except Exception as exc:  # wandb not installed / offline
                print(f"[cara_tpu] wandb unavailable ({exc}); using stdout "
                      "only", file=sys.stderr)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        rec = {k: _to_scalar(v) for k, v in metrics.items()}
        if step is not None:
            rec["step"] = int(step)
        rec["ts"] = round(time.time(), 3)
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()
        if self._wandb is not None:
            self._wandb.log({k: rec[k] for k in metrics}, step=step)

    def lambda_stats(self, cara_params,
                     histogram: bool = False) -> Dict[str, Any]:
        """Mean / std of the CP weight vectors R1 and R2 (numpy or tensor
        leaves), plus 16-bin histograms with ``histogram`` (the stdout
        analog of the reference's wandb.Histogram telemetry); a mixture of
        experts' tree pools every expert's vectors.  A tree without them
        (the linear probe and full fine-tuning, whose adapter tree is
        empty) has no lambda to report."""
        if "experts" in cara_params and "R1" not in cara_params:
            cara_params = cara_params["experts"]
        if "R1" not in cara_params:
            return {}
        r1 = _host(cara_params["R1"])
        r2 = _host(cara_params["R2"])
        out: Dict[str, Any] = {
            "r1_mean": float(r1.mean()), "r1_std": float(r1.std()),
            "r2_mean": float(r2.mean()), "r2_std": float(r2.std()),
        }
        if histogram:
            for name, arr in (("r1", r1), ("r2", r2)):
                counts, edges = np.histogram(arr, bins=16)
                out[f"{name}_hist"] = {
                    "counts": counts.tolist(),
                    "min": float(edges[0]), "max": float(edges[-1]),
                }
            if self._wandb is not None:
                import wandb  # type: ignore

                self._wandb.log({"R1": wandb.Histogram(r1),
                                 "R2": wandb.Histogram(r2)})
        return out

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a tensor: fp32 numpy on the host
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf)


def _to_scalar(v):
    if isinstance(v, bool):  # float(True) == 1.0 would mangle JSON booleans
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
