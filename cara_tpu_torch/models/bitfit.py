"""BitFit: bias-only fine-tuning (port of ``cara_tpu/models/bitfit.py``).

The adapter tree holds additive deltas of the backbone's biases, all zero
at init, so the step-0 forward is the frozen backbone's exactly:

    {"blocks": {"qkv_bias": (L, 3E), "proj_bias": (L, E),
                "fc1_bias": (L, hid), "fc2_bias": (L, E),
                "ln1_bias": (L, E),  "ln2_bias": (L, E)},
     "embed_bias": (E,), "norm_bias": (E,)}           [+ "ln_pre_bias"]

``pre_logits`` stays frozen: it is not part of the encoder stack.
:func:`apply_bitfit` adds the deltas onto the frozen tree under autograd
(a few O(E) adds, no weight copies), then the plain forward runs on it;
int8 backbones compose (only kernels quantize, biases stay dense).
:func:`merge_bitfit` is the same fold, for merged export and serving.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from cara_tpu_torch.config import ViTConfig

BLOCK_SITES = ("qkv_bias", "proj_bias", "fc1_bias", "fc2_bias",
               "ln1_bias", "ln2_bias")


def bitfit_param_shapes(model: ViTConfig) -> Dict:
    """Nested dict of delta shapes (the frozen tree's bias slots)."""
    n_layers, e, hid = model.depth, model.embed_dim, model.hidden_dim
    shapes = {
        "blocks": {
            "qkv_bias": (n_layers, 3 * e),
            "proj_bias": (n_layers, e),
            "fc1_bias": (n_layers, hid),
            "fc2_bias": (n_layers, e),
            "ln1_bias": (n_layers, e),
            "ln2_bias": (n_layers, e),
        },
        "embed_bias": (e,),
        "norm_bias": (e,),
    }
    if model.ln_pre:
        shapes["ln_pre_bias"] = (e,)
    return shapes


def init_bitfit_params(model: ViTConfig) -> Dict:
    """numpy fp32 tree of zeros (the init draws nothing)."""

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return np.zeros(tree, np.float32)

    return zeros(bitfit_param_shapes(model))


def is_bitfit_params(tree) -> bool:
    return (isinstance(tree, dict)
            and "blocks" in tree and "norm_bias" in tree
            and isinstance(tree["blocks"], dict)
            and set(BLOCK_SITES) <= set(tree["blocks"]))


def _add(node: Dict[str, Any], delta) -> Dict[str, Any]:
    return dict(node, bias=node["bias"] + delta.to(node["bias"].dtype))


def apply_bitfit(params: Dict[str, Any],
                 deltas: Dict[str, Any]) -> Dict[str, Any]:
    """Frozen tree + bias deltas -> the modified tree (new dicts)."""
    bp = dict(params["blocks"])
    d = deltas["blocks"]
    for site in ("qkv", "proj", "fc1", "fc2"):
        bp[site] = _add(bp[site], d[f"{site}_bias"])
    for ln in ("ln1", "ln2"):
        key = f"{ln}_bias"
        bp[key] = bp[key] + d[key].to(bp[key].dtype)
    out = dict(params)
    out["blocks"] = bp
    out["embed"] = _add(params["embed"], deltas["embed_bias"])
    out["norm"] = _add(params["norm"], deltas["norm_bias"])
    if "ln_pre_bias" in deltas:
        if "ln_pre" not in out:
            raise ValueError(
                "BitFit tree carries ln_pre_bias but the model has no "
                "ln_pre — was it trained with a different model config?")
        out["ln_pre"] = _add(params["ln_pre"], deltas["ln_pre_bias"])
    return out


def merge_bitfit(params: Dict[str, Any], deltas: Dict[str, Any],
                 model: ViTConfig, cara) -> Dict[str, Any]:
    """Exact merged export: BitFit is a bias fold."""
    del model, cara
    return apply_bitfit(params, deltas)


def check_geometry(deltas: Dict[str, Any], model: ViTConfig) -> None:
    """Fail fast on a tree trained with a different model geometry."""
    want = bitfit_param_shapes(model)

    def walk(w, d, path):
        if isinstance(w, dict):
            if not isinstance(d, dict) or set(w) != set(d):
                raise ValueError(
                    f"BitFit tree keys at {path or 'root'} "
                    f"({sorted(d) if isinstance(d, dict) else type(d)}) do "
                    f"not match the model geometry ({sorted(w)})")
            for k in w:
                walk(w[k], d[k], f"{path}/{k}")
        elif tuple(d.shape) != w:
            raise ValueError(
                f"BitFit delta {path} has shape {tuple(d.shape)}; model "
                f"geometry wants {w}")

    walk(want, deltas, "")
