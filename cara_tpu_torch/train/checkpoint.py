"""Checkpoints (port of ``cara_tpu/train/checkpoint.py``): single-file
npz models, adapter-only files, the best-checkpoint keeper and the
mid-training resume snapshots.

The model and adapter formats are the JAX package's: one ``.npz`` whose
keys are the ``/``-joined paths of the nested tree under ``params/``
(backbone + head), ``cara/`` (adapter) and, in an adapter-only file,
``head/``, plus a ``__meta__`` uint8 JSON blob.  A file either package
writes loads in the other.  Trees load as numpy arrays;
``models.convert.params_from_numpy`` moves them to a device.

The resume snapshots keep JAX's layout of directories
(``step_{step:08d}/`` with ``extra.json`` beside the state, the newest
``keep_last`` kept) but not its orbax format, which the card's machine
does not have: ``state.npz`` holds the step, the trainables, AdamW's
first and second moments under ``trainable/``, ``mu/`` and ``nu/``
(``steps.adam_moments``; a restore rebuilds the state through
``steps.train_state_from_numpy``) and the state of the run's
``torch.Generator``.  A snapshot is written into
a temporary directory that is then renamed, so a crash never leaves a
torn one.  The port does not read JAX's orbax snapshots, nor JAX the
port's.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cara_tpu_torch.config import (BOTTLENECK_METHODS, FACT_METHODS,
                                   VPT_METHODS, CaraConfig)
from cara_tpu_torch.models import adapter as adapter_lib
from cara_tpu_torch.models import bitfit as bitfit_lib
from cara_tpu_torch.models import fact as fact_lib
from cara_tpu_torch.models import lora as lora_lib
from cara_tpu_torch.models import ssf as ssf_lib
from cara_tpu_torch.models import vpt as vpt_lib
from cara_tpu_torch.train.steps import (adam_moments, train_state_from_numpy,
                                        tree_leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def to_numpy_tree(tree):
    """The same nested dict with every tensor copied to a host numpy array
    (bf16 as fp32)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return None if tree is None else _to_numpy(tree)


def flatten_tree(tree, prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif tree is not None:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    return tree


def save_model(path: str, params: Dict[str, Any],
               cara_params: Optional[Dict[str, Any]] = None,
               meta: Optional[Dict[str, Any]] = None) -> None:
    """Full-model single file (backbone + head [+ adapter]).  Leaves may
    be numpy arrays or tensors (bf16 tensors are stored as fp32)."""
    flat = flatten_tree({"params": params})
    if cara_params is not None:
        flat.update(flatten_tree({"cara": cara_params}))
    if meta is not None:
        flat["__meta__"] = _meta_blob(meta)
    np.savez(path, **flat)


def load_model(path: str) -> Tuple[Dict, Optional[Dict], Dict]:
    """Returns (params, cara_params_or_None, meta) as numpy trees."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}
        meta = _read_meta(z)
    tree = unflatten_tree(flat)
    return tree.get("params", {}), tree.get("cara"), meta


def _meta_blob(meta) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _read_meta(z) -> Dict[str, Any]:
    if "__meta__" not in z.files:
        return {}
    return json.loads(bytes(z["__meta__"].tolist()).decode())


def save_adapter(path: str, cara_params: Dict[str, Any],
                 head: Optional[Dict[str, Any]] = None,
                 meta: Optional[Dict[str, Any]] = None) -> None:
    """Adapter-only artifact: CP factors (+ classifier head)."""
    flat = flatten_tree({"cara": cara_params})
    if head is not None:
        flat.update(flatten_tree({"head": head}))
    if meta is not None:
        flat["__meta__"] = _meta_blob(meta)
    np.savez(path, **flat)


def is_adapter_checkpoint(path: str) -> bool:
    """True for adapter-only artifacts (a ``cara/`` subtree but no
    ``params/`` backbone)."""
    with np.load(path) as z:
        return (any(k.startswith("cara/") for k in z.files)
                and not any(k.startswith("params/") for k in z.files))


def load_adapter(path: str) -> Tuple[Dict, Optional[Dict], Dict]:
    """Returns (cara_params, head_or_None, meta) as numpy trees."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}
        meta = _read_meta(z)
    tree = unflatten_tree(flat)
    return tree.get("cara", {}), tree.get("head"), meta


def infer_cara_cfg(cara_params, meta, scale=None, cp_order=None):
    """Rebuild the :class:`CaraConfig` of a loaded adapter tree from the
    artifact meta (``cara_tpu/train/checkpoint.py:121-197``): the method
    from the meta's ``method`` or the tree's shape (VPT's prompts, SSF's
    pairs, BitFit's deltas, the bottleneck pairs, FacT's U/V factors,
    LoRA's per-site {a, b} pairs, CaRA's CP factors or their mixture of
    experts' {"experts", "router"} tree), the rank (FacT-TK's core rank,
    VPT's token count) from the tree, the dropout rates and impl from the
    meta; a mixture's experts, top-k and aux coefficient from the meta,
    the router's width where it records none.  VPT, SSF and BitFit have
    no delta scale (1.0); Houlsby adapters default to 1.0 and AdaptFormer
    refuses a missing scale.  Other methods raise when the delta scale is
    neither recorded nor given (per-task scales span 0.1-100; a silent 1.0
    would mis-apply the adapter)."""
    moe = "router" in cara_params and "experts" in cara_params
    meta_method = str(meta.get("method", "") or "")
    if meta_method in VPT_METHODS or vpt_lib.is_vpt_params(cara_params):
        return CaraConfig(
            method=meta_method or vpt_lib.detect_method(cara_params),
            scale=1.0, weight_dropout=0.0,
            vpt_tokens=int(np.shape(cara_params["prompts"])[1]))
    if meta_method == "ssf" or ssf_lib.is_ssf_params(cara_params):
        return CaraConfig(method="ssf", scale=1.0, weight_dropout=0.0)
    if meta_method == "bitfit" or bitfit_lib.is_bitfit_params(cara_params):
        return CaraConfig(method="bitfit", scale=1.0, weight_dropout=0.0)
    if (meta_method in BOTTLENECK_METHODS
            or adapter_lib.is_adapter_params(cara_params)):
        method = meta_method or adapter_lib.detect_method(cara_params)
        if scale is None:
            if "scale" in meta:
                scale = float(meta["scale"])
            elif method == "adapter":
                scale = 1.0  # Houlsby adapters are unscaled by definition
            else:
                raise ValueError(
                    "adaptformer checkpoint records no delta scale and "
                    "none was given — the parallel-branch scale (official "
                    "default 0.1) changes the forward; pass scale= "
                    "explicitly")
        return CaraConfig(
            method=method, scale=scale, weight_dropout=0.0,
            rank=int(np.shape(cara_params["mlp_down"]["kernel"])[-1]),
            adapter_dropout=float(meta.get("adapter_dropout", 0.0)))
    fact = meta_method in FACT_METHODS or (
        not moe and fact_lib.detect_method(cara_params) is not None)
    lora = meta_method == "lora" or (
        not moe and not fact and lora_lib.is_lora_params(cara_params))
    cara = (meta_method in ("", "cara") and not fact and not lora
            and ("R1" in cara_params or moe))
    if not (fact or lora or cara):
        raise NotImplementedError(
            f"adapter method {meta_method or '?'!r} (keys "
            f"{sorted(cara_params)}) is not yet ported to cara_tpu_torch "
            "(ROADMAP.md queue 1: the PEFT zoo)")
    if scale is None:
        if "scale" not in meta:
            raise ValueError(
                "checkpoint records no delta scale and none was given; "
                "refusing to default to 1.0 (a wrong scale silently "
                "mis-applies the adapter)")
        scale = float(meta["scale"])
    if fact or lora:
        kw = dict(weight_dropout=float(meta.get("weight_dropout", 0.0)),
                  weight_dropout_impl=str(
                      meta.get("weight_dropout_impl", "element")))
        if fact:
            return CaraConfig(
                method=meta_method or fact_lib.detect_method(cara_params),
                scale=scale, rank=int(np.shape(cara_params["U"])[-1]),
                fact_core_rank=(int(np.shape(cara_params["C"])[0])
                                if "C" in cara_params else 0), **kw)
        return CaraConfig(method="lora", scale=scale,
                          rank=int(np.shape(cara_params["qkv"]["a"])[-1]),
                          **kw)
    r1 = cara_params["experts"]["R1"] if moe else cara_params["R1"]
    kw = dict(
        rank=int(np.shape(r1)[-1]), scale=scale,
        cp_order=int(cp_order if cp_order is not None
                     else meta.get("cp_order", 4)),
        weight_dropout=float(meta.get("weight_dropout", 0.1)))
    if moe:
        kw.update(
            moe_experts=int(meta.get(
                "moe_experts", np.shape(cara_params["router"]["kernel"])[-1])),
            moe_top_k=int(meta.get("moe_top_k", 2)),
            moe_aux_coef=float(meta.get("moe_aux_coef", 0.01)),
            weight_dropout_impl=str(meta.get("weight_dropout_impl", "rank")))
    return CaraConfig(**kw)


class BestCheckpointKeeper:
    """Best-accuracy rotation with the reference filename convention
    (save the new best, delete the previous one, ``vit_cp.py:61-66``):
    ``vit_{dataset}_{acc}_seed_{seed}.npz`` in ``out_dir``.

    ``update`` copies the trees to host memory before it returns (the
    optimizer then updates the trainables in place); the file is written
    on a background thread, at most one write in flight, and ``wait()``
    joins it."""

    def __init__(self, out_dir: str, dataset: str, seed: int):
        self.out_dir = out_dir
        self.dataset = dataset
        self.seed = seed
        self.best_acc = 0.0
        self.best_path: Optional[str] = None
        self._thread: Optional[threading.Thread] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _write(new_path, params, cara_params, meta, old_path) -> None:
        save_model(new_path, params, cara_params, meta)
        if old_path and os.path.exists(old_path):
            os.remove(old_path)

    def update(self, acc: float, params, cara_params,
               meta=None) -> Optional[str]:
        if acc <= self.best_acc:
            return None
        self.wait()
        self.best_acc = acc
        new_path = os.path.join(
            self.out_dir,
            f"vit_{self.dataset}_{round(acc, 5)}_seed_{self.seed}.npz")
        os.makedirs(self.out_dir, exist_ok=True)
        args = (new_path, to_numpy_tree(params), to_numpy_tree(cara_params),
                {**(meta or {}), "acc": acc, "seed": self.seed},
                self.best_path)
        self.best_path = new_path
        self._thread = threading.Thread(target=self._write, args=args,
                                        daemon=True)
        self._thread.start()
        return new_path


# --- mid-training resume ---------------------------------------------------


def _step_dirs(ckpt_dir: str):
    """Steps of the complete snapshots in ``ckpt_dir`` (``step_%08d``
    directories; a temporary one being written is not complete)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d[5:]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and d[5:].isdigit())


def snapshot_arrays(state, generator=None) -> Dict[str, np.ndarray]:
    """The flat arrays of a resume snapshot of ``state`` (and the state
    of ``generator``), as :func:`save_train_state` writes them."""
    mu, nu = adam_moments(state)
    flat = {"step": np.asarray(state.step, np.int64)}
    flat.update(flatten_tree(to_numpy_tree(
        {"trainable": state.trainable, "mu": mu, "nu": nu})))
    if generator is not None:
        flat["generator"] = generator.get_state().numpy()
    return flat


def digest(flat: Dict[str, np.ndarray]) -> str:
    """sha256 over a flat tree's keys, dtypes, shapes and bytes."""
    h = hashlib.sha256()
    for key in sorted(flat):
        arr = np.ascontiguousarray(flat[key])
        h.update(f"{key}:{arr.dtype.str}:{arr.shape}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def save_train_state(ckpt_dir: str, step: int, state, extra=None,
                     keep_last: int = 3, generator=None) -> str:
    """Save the resumable state (the step, trainables, AdamW's moments and,
    when given, the run's ``generator``) as ``step_{step:08d}/``; returns
    the :func:`digest` of what was written.

    Keeps only the newest ``keep_last`` snapshots, pruned after the new
    one lands, so a crash mid-save never leaves the directory empty
    (``keep_last=0`` keeps all).  The snapshot is written under a
    temporary name and renamed into place; an existing snapshot of the
    same step is replaced, as orbax's ``force=True`` does."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = f"{path}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    flat = snapshot_arrays(state, generator)
    np.savez(os.path.join(tmp, "state.npz"), **flat)
    if extra is not None:
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    if keep_last > 0:
        for old in _step_dirs(ckpt_dir)[:-keep_last]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{old:08d}"),
                          ignore_errors=True)
    return digest(flat)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _step_dirs(ckpt_dir)
    return steps[-1] if steps else None


def load_snapshot(ckpt_dir: str, step: int) -> Dict[str, np.ndarray]:
    """The flat arrays of the snapshot of ``step``."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "state.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def restore_train_state(ckpt_dir: str, step: int, template, generator=None):
    """The snapshot of ``step`` as a new
    :class:`~cara_tpu_torch.train.steps.TrainState` on the device of
    ``template`` (one from ``init_train_state`` with the same trainable
    tree), whose optimizer's settings it keeps
    (:func:`~cara_tpu_torch.train.steps.train_state_from_numpy`);
    ``generator`` (when given and saved) takes the saved state.  Returns
    (state, extra) as JAX's returns (restored, extra)."""
    flat = load_snapshot(ckpt_dir, step)
    tree = unflatten_tree({k: v for k, v in flat.items()
                           if k.split("/")[0] in ("trainable", "mu", "nu")})
    want = {p: tuple(t.shape) for p, t in tree_leaves(template.trainable)}
    got = {p: a.shape for p, a in flatten_tree(
        tree.get("trainable", {})).items()}
    if got != want:
        raise ValueError(f"snapshot step {step} does not match the "
                         f"trainable tree ({sorted(set(want) ^ set(got))[:4]}"
                         " differ)")
    device = next(iter(tree_leaves(template.trainable)))[1].device
    state = train_state_from_numpy(int(flat["step"]), tree["trainable"],
                                   tree["mu"], tree["nu"], device,
                                   **template.opt.hparams)
    if generator is not None and "generator" in flat:
        generator.set_state(torch.from_numpy(flat["generator"]))
    extra = None
    extra_path = os.path.join(ckpt_dir, f"step_{step:08d}", "extra.json")
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    return state, extra
