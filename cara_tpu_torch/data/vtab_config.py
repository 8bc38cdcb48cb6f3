"""Per-dataset CaRA hyper-parameters for the 19 VTAB-1k tasks (port of
``cara_tpu/data/vtab_config.py``, the same table).

Values are the reference's tuned per-task table
(``image_classification/vtab_config.py:1-135``): lambda-init mean/std for
``CP_R1``/``CP_R2``, the delta scale ``s`` and the RNG seed.
``get_task_hparams(task, paper=True)`` gives the 8 tasks the reference
annotates "# Dropout: 0.3" (``vtab_config.py:16,23,30,44,72,86,114,128``)
weight dropout 0.3; the released code uses 0.1 everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class TaskHParams:
    init_mean: float
    init_std: float
    scale: float
    seed: int
    logger: bool = False
    weight_dropout: float = 0.1


# (init_mean, init_std, scale, seed) per task.
_TABLE = {
    "cifar":                (1.5,  0.1,   0.1,  14),
    "caltech101":           (0.9,  0.01,  100,  56),
    "dtd":                  (1.0,  0.0,   0.1,  14),
    "oxford_flowers102":    (1.0,  0.02,  10.0, 50),
    "oxford_iiit_pet":      (1.2,  0.06,  1.0,  93),
    "svhn":                 (1.0,  0.05,  100,  14),
    "sun397":               (1.35, 0.06,  1.0,  43),
    "patch_camelyon":       (1.0,  0.0,   10,   89),
    "eurosat":              (1.08, 0.028, 10,   32),
    "resisc45":             (1.16, 0.03,  10,   28),
    "diabetic_retinopathy": (1.0,  0.0,   0.1,  81),
    "clevr_count":          (1.0,  0.0,   5,    44),
    "clevr_dist":           (1.0,  0.0,   2.5,  25),
    "dmlab":                (1.0,  0.0,   10,   72),
    "kitti":                (1.0,  0.0,   5,    31),
    "dsprites_loc":         (1.0,  0.0,   50,   12),
    "dsprites_ori":         (1.3,  0.07,  1.0,  79),
    "smallnorb_azi":        (1.0,  0.0,   100,  67),
    "smallnorb_ele":        (1.0,  0.0,   10.0, 30),
}

TASK_HPARAMS: Dict[str, TaskHParams] = {
    name: TaskHParams(*vals) for name, vals in _TABLE.items()
}

# Tasks the reference annotates "# Dropout: 0.3" in its per-task table
# (image_classification/vtab_config.py:16,23,30,44,72,86,114,128) — the
# paper runs used 0.3 there while the released code hard-codes 0.1.
PAPER_DROPOUT_03 = frozenset({
    "dtd", "oxford_flowers102", "oxford_iiit_pet", "sun397",
    "diabetic_retinopathy", "clevr_dist", "dsprites_ori", "smallnorb_ele",
})


def get_task_hparams(task: str, paper: bool = False) -> TaskHParams:
    hp = TASK_HPARAMS[task]
    if paper and task in PAPER_DROPOUT_03:
        hp = dataclasses.replace(hp, weight_dropout=0.3)
    return hp
