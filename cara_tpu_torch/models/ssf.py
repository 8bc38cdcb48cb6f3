"""SSF: scale-and-shift feature adaptation (port of
``cara_tpu/models/ssf.py``).

SSF puts a per-channel affine ``y = gamma * x + beta`` after every
operation of the frozen transformer and trains only the (gamma, beta)
pairs: the patch-embed projection, per block {ln1, qkv, proj, ln2, fc1,
fc2}, the final norm, and CLIP's ``ln_pre`` where the model has one.
Parameter tree (block entries layer-stacked):

    {"blocks": {"ln1": {"g": (L, E), "b": (L, E)}, "qkv": (L, 3E) x2,
                "proj": (L, E) x2, "ln2": (L, E) x2,
                "fc1": (L, hid) x2, "fc2": (L, E) x2},
     "embed": {"g": (E,), "b": (E,)}, "norm": {"g": (E,), "b": (E,)}}
                                                    [+ "ln_pre"]

Init (numpy, seeded): ``gamma ~ N(1, 0.02)``, ``beta ~ N(0, 0.02)``.

Every insertion point follows a linear op or a LayerNorm, so the affine
folds exactly into that op's weights: ``gamma*(Wx + b) + beta ==
(W*gamma)x + (gamma*b + beta)``.  :func:`apply_ssf` makes that fold on
the frozen tree under autograd, then the plain forward runs on it and
the gradients reach (gamma, beta) through the fold.  On an int8 backbone
(``models/quant.py``) gamma folds into the per-output-channel dequant
scale and the codes stay as they are.  :func:`merge_ssf` is the same
fold, for merged export and serving.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from cara_tpu_torch.config import ViTConfig

LINEAR_SITES = ("qkv", "proj", "fc1", "fc2")
LN_SITES = ("ln1", "ln2")


def ssf_param_shapes(model: ViTConfig) -> Dict:
    """Nested dict of per-site channel widths ({"g", "b"} pairs)."""
    n_layers, e, hid = model.depth, model.embed_dim, model.hidden_dim
    width = {"qkv": 3 * e, "proj": e, "fc1": hid, "fc2": e,
             "ln1": e, "ln2": e}
    shapes = {
        "blocks": {site: {"g": (n_layers, w), "b": (n_layers, w)}
                   for site, w in width.items()},
        "embed": {"g": (e,), "b": (e,)},
        "norm": {"g": (e,), "b": (e,)},
    }
    if model.ln_pre:
        shapes["ln_pre"] = {"g": (e,), "b": (e,)}
    return shapes


def _is_pair(tree) -> bool:
    return "g" in tree and "b" in tree and not isinstance(tree["g"], dict)


def init_ssf_params(model: ViTConfig, seed: int) -> Dict:
    """numpy fp32 tree: gamma ~ N(1, 0.02), beta ~ N(0, 0.02), drawn pair
    by pair in the shapes' key order."""
    rng = np.random.default_rng(seed)

    def build(tree):
        if _is_pair(tree):
            return {"g": (1.0 + 0.02 * rng.standard_normal(tree["g"])
                          ).astype(np.float32),
                    "b": (0.02 * rng.standard_normal(tree["b"])
                          ).astype(np.float32)}
        return {k: build(v) for k, v in tree.items()}

    return build(ssf_param_shapes(model))


def identity_ssf_params(model: ViTConfig) -> Dict:
    """gamma = 1, beta = 0 everywhere: the forward is the frozen
    backbone's exactly."""

    def build(tree):
        if _is_pair(tree):
            return {"g": np.ones(tree["g"], np.float32),
                    "b": np.zeros(tree["b"], np.float32)}
        return {k: build(v) for k, v in tree.items()}

    return build(ssf_param_shapes(model))


def is_ssf_params(tree) -> bool:
    return (isinstance(tree, dict)
            and "blocks" in tree and "norm" in tree and "embed" in tree
            and isinstance(tree.get("norm"), dict)
            and set(tree["norm"]) == {"g", "b"}
            and isinstance(tree["blocks"], dict)
            and set(LINEAR_SITES + LN_SITES) <= set(tree["blocks"]))


def _fold_linear(site: Dict[str, Any], g: torch.Tensor,
                 b: torch.Tensor) -> Dict[str, Any]:
    """gamma*(Wx + bias) + beta == (W*gamma)x + (gamma*bias + beta); an
    int8 quant dict's gamma folds into its (..., 1, out) scale."""
    kern, bias = site["kernel"], site["bias"]
    new_bias = g.to(bias.dtype) * bias + b.to(bias.dtype)
    if isinstance(kern, dict):
        sc = kern["scale"]
        return {"kernel": dict(kern, scale=sc * g.to(sc.dtype)[..., None, :]),
                "bias": new_bias}
    return {"kernel": kern * g.to(kern.dtype)[..., None, :],
            "bias": new_bias}


def _fold_norm(norm: Dict[str, torch.Tensor], g, b) -> Dict[str, Any]:
    sc, bi = norm["scale"], norm["bias"]
    return {"scale": sc * g.to(sc.dtype),
            "bias": bi * g.to(bi.dtype) + b.to(bi.dtype)}


def apply_ssf(params: Dict[str, Any], ssf: Dict[str, Any]) -> Dict[str, Any]:
    """Frozen tree + (gamma, beta) tree -> the folded tree (new dicts; the
    frozen leaves are not changed)."""
    bp = dict(params["blocks"])
    sb = ssf["blocks"]
    for site in LINEAR_SITES:
        bp[site] = _fold_linear(bp[site], sb[site]["g"], sb[site]["b"])
    for ln in LN_SITES:
        folded = _fold_norm({"scale": bp[f"{ln}_scale"],
                             "bias": bp[f"{ln}_bias"]},
                            sb[ln]["g"], sb[ln]["b"])
        bp[f"{ln}_scale"], bp[f"{ln}_bias"] = folded["scale"], folded["bias"]
    out = dict(params)
    out["blocks"] = bp
    out["embed"] = _fold_linear(params["embed"], ssf["embed"]["g"],
                                ssf["embed"]["b"])
    out["norm"] = _fold_norm(params["norm"], ssf["norm"]["g"],
                             ssf["norm"]["b"])
    if "ln_pre" in ssf:
        if "ln_pre" not in out:
            raise ValueError(
                "SSF tree carries ln_pre factors but the model has no "
                "ln_pre — was it trained with a different model config?")
        out["ln_pre"] = _fold_norm(params["ln_pre"], ssf["ln_pre"]["g"],
                                   ssf["ln_pre"]["b"])
    return out


def merge_ssf(params: Dict[str, Any], ssf: Dict[str, Any], model: ViTConfig,
              cara) -> Dict[str, Any]:
    """Exact merged export: SSF folds into the adjacent linear / LN ops."""
    del model, cara
    return apply_ssf(params, ssf)
