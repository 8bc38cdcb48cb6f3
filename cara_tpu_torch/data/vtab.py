"""Image normalization of the VTAB pipeline (port of the constants and
``normalize`` of ``cara_tpu/data/vtab.py``; the datasets come later)."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(x: np.ndarray) -> np.ndarray:
    """[0, 1] float HWC (or NHWC) -> ImageNet-normalized."""
    return (x - IMAGENET_MEAN) / IMAGENET_STD
