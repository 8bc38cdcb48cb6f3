"""VTAB-1k data pipeline: file lists or synthetic arrays -> static-shape
NHWC numpy batches (port of ``cara_tpu/data/vtab.py``, single process).

Reference behavior (``image_classification/vtab.py``): 19 tasks with
``impath label`` file lists under ``<root>/<task>/{train800,val200,
train800val200,test}.txt``; bicubic resize to 224, scale to [0, 1],
ImageNet normalization; ``evaluate=True`` trains on ``train800val200``
(shuffled, drop_last) and tests on ``test``.

Numpy RNGs throughout, seeded as the JAX package seeds them, so one seed
gives the same synthetic arrays and the same batch order in both
packages.  Train splits small enough are decoded once into a uint8 RAM
cache and normalized on the device (``train.steps.prep_images``).  The
native C++ decoder and multi-host sharding are not ported (PIL only).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# Task registry: name -> number of classes (``vtab.py:9-34``).
VTAB_TASKS: Dict[str, int] = {
    "cifar": 100,
    "caltech101": 102,
    "dtd": 47,
    "oxford_flowers102": 102,
    "oxford_iiit_pet": 37,
    "svhn": 10,
    "sun397": 397,
    "patch_camelyon": 2,
    "eurosat": 10,
    "resisc45": 45,
    "diabetic_retinopathy": 5,
    "clevr_count": 8,
    "clevr_dist": 6,
    "dmlab": 6,
    "kitti": 4,
    "dsprites_loc": 16,
    "dsprites_ori": 16,
    "smallnorb_azi": 18,
    "smallnorb_ele": 9,
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def get_classes_num(task: str) -> int:
    return VTAB_TASKS[task]


def normalize(x: np.ndarray) -> np.ndarray:
    """[0, 1] float HWC (or NHWC) -> ImageNet-normalized."""
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def read_file_list(path: str) -> List[Tuple[str, int]]:
    """Parse ``impath label`` lines (``vtab.py:40-50``)."""
    out: List[Tuple[str, int]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            impath, label = line.rsplit(maxsplit=1)
            out.append((impath, int(label)))
    return out


def load_image_u8(path: str, size: int) -> np.ndarray:
    """Decode + bicubic resize -> uint8 HWC RGB (``vtab.py:36-37,79``)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size), Image.BICUBIC)
        return np.asarray(im, np.uint8)


class FileListSource:
    """Images decoded on demand from a file list (PIL), normalized on the
    host, or, when ``cached``, decoded once into uint8 and normalized on
    the device."""

    def __init__(self, root: str, flist: str, image_size: int = 224):
        self.root = root
        self.items = read_file_list(flist)
        self.image_size = image_size
        self.cached = False  # get_data caches splits up to cache_limit
        self._cache: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.items)

    @property
    def labels(self) -> np.ndarray:
        return np.array([lab for _, lab in self.items], np.int32)

    def _path(self, idx: int) -> str:
        return os.path.join(self.root, self.items[idx][0])

    def load(self, idx: int) -> np.ndarray:
        raw = load_image_u8(self._path(idx), self.image_size)
        return normalize(raw.astype(np.float32) / 255.0)

    def load_batch(self, indices) -> np.ndarray:
        """uint8 rows of the RAM cache (decoded on first use)."""
        if self._cache is None:
            self._cache = np.stack([load_image_u8(self._path(i),
                                                  self.image_size)
                                    for i in range(len(self))])
        return self._cache[np.asarray(indices)]


class ArraySource:
    """In-memory source (synthetic data, tests): batches are row slices."""

    cached = True

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        if images.ndim != 4 or len(images) != len(labels):
            raise ValueError("ArraySource wants (N, H, W, C) images and N "
                             "labels")
        self.images = images.astype(np.float32)
        self._labels = labels.astype(np.int32)
        self.image_size = images.shape[1]

    def __len__(self) -> int:
        return len(self.images)

    @property
    def labels(self) -> np.ndarray:
        return self._labels

    def load(self, idx: int) -> np.ndarray:
        return self.images[idx]

    def load_batch(self, indices) -> np.ndarray:
        return self.images[np.asarray(indices)]


def synthetic_source(num: int, num_classes: int, image_size: int = 224,
                     seed: int = 0) -> ArraySource:
    """Class-shifted Gaussian images; the JAX package's arrays, bit for
    bit, from the same seed."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=(num,)).astype(np.int32)
    x = np.random.default_rng(seed).standard_normal(
        (num, image_size, image_size, 3), dtype=np.float32) * 0.5
    x += (y[:, None, None, None].astype(np.float32) / num_classes - 0.5)
    return ArraySource(x, y)


class BatchLoader:
    """Batches with static shapes.  train: reshuffled every epoch by a
    numpy ``RandomState(seed)``, ragged tail dropped (``vtab.py:87``).
    eval: in order, the final batch zero-padded with a ``valid`` mask."""

    def __init__(self, source, batch_size: int, *, train: bool,
                 seed: int = 0, num_workers: int = 8):
        self.source = source
        self.batch_size = batch_size
        self.train = train
        self.rng = np.random.RandomState(seed)
        self.num_workers = num_workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()

    def _pool_get(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            return self._pool

    def steps_per_epoch(self) -> int:
        n = len(self.source)
        if self.train:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.source)
        order = np.arange(n)
        if self.train:
            self.rng.shuffle(order)
            order = order[: (n // self.batch_size) * self.batch_size]
        labels = self.source.labels
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            if self.source.cached:
                stacked = self.source.load_batch(idx)
            else:
                stacked = np.stack(list(self._pool_get().map(
                    self.source.load, idx)))
            valid = np.ones(len(idx), np.float32)
            lab = labels[idx]
            if len(idx) < bs:  # eval tail: pad to the static shape
                pad = bs - len(idx)
                stacked = np.concatenate(
                    [stacked, np.zeros((pad,) + stacked.shape[1:],
                                       stacked.dtype)])
                lab = np.concatenate([lab, np.zeros(pad, np.int32)])
                valid = np.concatenate([valid, np.zeros(pad, np.float32)])
            yield {"image": stacked, "label": lab, "valid": valid}


def get_data(task: str, root: str = "./data/vtab-1k", evaluate: bool = True,
             batch_size: int = 64, eval_batch_size: int = 256,
             image_size: int = 224, seed: int = 0, num_workers: int = 8,
             synthetic: bool = False, synthetic_size: int = 1000,
             cache_limit: int = 5000) -> Tuple[BatchLoader, BatchLoader]:
    """(train_loader, eval_loader) with the reference split protocol
    (``vtab.py:76-107``); ``synthetic=True`` generates data with the
    task's class count."""
    ncls = get_classes_num(task)
    if synthetic:
        train_src = synthetic_source(synthetic_size, ncls, image_size, seed)
        test_src = synthetic_source(max(synthetic_size // 4, eval_batch_size),
                                    ncls, image_size, seed + 1)
    else:
        tdir = os.path.join(root, task)
        train_list = "train800val200.txt" if evaluate else "train800.txt"
        test_list = "test.txt" if evaluate else "val200.txt"
        train_src = FileListSource(tdir, os.path.join(tdir, train_list),
                                   image_size)
        test_src = FileListSource(tdir, os.path.join(tdir, test_list),
                                  image_size)
        for src in (train_src, test_src):
            src.cached = len(src) <= cache_limit
    train = BatchLoader(train_src, batch_size, train=True, seed=seed,
                        num_workers=num_workers)
    test = BatchLoader(test_src, eval_batch_size, train=False, seed=seed,
                       num_workers=num_workers)
    return train, test
