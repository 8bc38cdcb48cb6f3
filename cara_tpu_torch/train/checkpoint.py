"""Single-file npz model checkpoints (port of ``cara_tpu/train/checkpoint.py``,
the model-file subset).

The format is the JAX package's: one ``.npz`` whose keys are the
``/``-joined paths of the nested tree under ``params/`` (backbone + head)
and ``cara/`` (adapter), plus a ``__meta__`` uint8 JSON blob.  A file
either package writes loads in the other.  Trees load as numpy arrays;
``models.convert.params_from_numpy`` moves them to a device.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cara_tpu_torch.config import CaraConfig


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


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
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8)
    np.savez(path, **flat)


def load_model(path: str) -> Tuple[Dict, Optional[Dict], Dict]:
    """Returns (params, cara_params_or_None, meta) as numpy trees."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}
        meta = {}
        if "__meta__" in z.files:
            meta = json.loads(bytes(z["__meta__"].tolist()).decode())
    tree = unflatten_tree(flat)
    return tree.get("params", {}), tree.get("cara"), meta


def infer_cara_cfg(cara_params, meta, scale=None, cp_order=None):
    """Rebuild the :class:`CaraConfig` of a loaded CaRA factor tree from
    the artifact meta.  Raises when the delta scale is neither recorded
    nor given (per-task scales span 0.1-100; a silent 1.0 would mis-apply
    the adapter).  Other adapter families are not yet ported."""
    method = str(meta.get("method", "") or "cara")
    if method != "cara" or "R1" not in cara_params:
        raise NotImplementedError(
            f"adapter method {method!r} (keys {sorted(cara_params)}) is not "
            "yet ported to cara_tpu_torch; CaRA factor trees only")
    if scale is None:
        if "scale" not in meta:
            raise ValueError(
                "checkpoint records no delta scale and none was given; "
                "refusing to default to 1.0 (a wrong scale silently "
                "mis-applies the adapter)")
        scale = float(meta["scale"])
    return CaraConfig(
        rank=int(np.shape(cara_params["R1"])[-1]), scale=scale,
        cp_order=int(cp_order if cp_order is not None
                     else meta.get("cp_order", 4)),
        weight_dropout=float(meta.get("weight_dropout", 0.1)))
