"""The reference's effective learning-rate curve (port of
``cara_tpu/train/schedule.py``).

timm's ``CosineLRScheduler(t_initial=100, warmup_t=10, lr_min=1e-5,
warmup_lr_init=1e-6)`` stepped with the epoch index after every batch and
dropped at the epoch-50 eval (``image_classification/vit_cp.py:55-59,
187``): an epoch-resolution warmup + cosine, frozen after
``freeze_epoch``.  The cosine is evaluated at the raw epoch index (timm's
``warmup_prefix=False``).
"""

from __future__ import annotations

import math
from typing import Callable


def cara_cosine_schedule(
    base_lr: float,
    steps_per_epoch: int,
    total_epochs: int = 100,
    warmup_epochs: int = 10,
    lr_min: float = 1e-5,
    warmup_lr_init: float = 1e-6,
    freeze_epoch: int = 50,
) -> Callable[[int], float]:
    """``schedule(step) -> lr`` for the 0-based optimizer step."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, total_epochs - 1)
        eff = float(min(epoch, freeze_epoch))
        if eff < warmup_epochs:
            return warmup_lr_init + eff * (base_lr - warmup_lr_init) \
                / warmup_epochs
        return lr_min + 0.5 * (base_lr - lr_min) * (
            1.0 + math.cos(math.pi * eff / total_epochs))

    return schedule
