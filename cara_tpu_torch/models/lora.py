"""LoRA adapters: per-layer low-rank factor pairs at the CaRA sites (port
of ``cara_tpu/models/lora.py``).

The same four injection sites as CaRA (qkv, attention projection, MLP up,
MLP down).  Every fused CaRA site takes its delta as a collapsed
``(U, V)`` pair, ``delta = (x @ U) @ V``, which is LoRA's own form
(``U = A``, ``V = B``): LoRA runs through the port's site kernels with no
kernel of its own, with zero adapter biases.

Parameter tree (every leaf stacked on a leading layer axis):

    {"qkv":  {"a": (L, E, r),   "b": (L, r, 3E)},
     "proj": {"a": (L, E, r),   "b": (L, r, E)},
     "fc1":  {"a": (L, E, r),   "b": (L, r, hid)},
     "fc2":  {"a": (L, hid, r), "b": (L, r, E)}}

qkv's ``b`` columns are the fused-qkv layout (3, H, Dh) flattened.  Init
(numpy, seeded): ``A ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, ``B = 0``,
so the delta is exactly zero at step 0.  The ``alpha / r`` scale is
``CaraConfig.scale``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cara_tpu_torch.config import CaraConfig, ViTConfig

SITES = ("qkv", "proj", "fc1", "fc2")


def lora_param_shapes(model: ViTConfig, cara: CaraConfig
                      ) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Per-site factor shapes, every leaf layer-stacked."""
    n_layers, e, hid, r = (model.depth, model.embed_dim, model.hidden_dim,
                           cara.rank)
    return {
        "qkv": {"a": (n_layers, e, r), "b": (n_layers, r, 3 * e)},
        "proj": {"a": (n_layers, e, r), "b": (n_layers, r, e)},
        "fc1": {"a": (n_layers, e, r), "b": (n_layers, r, hid)},
        "fc2": {"a": (n_layers, hid, r), "b": (n_layers, r, e)},
    }


def init_lora_params(model: ViTConfig, cara: CaraConfig,
                     seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """numpy fp32 tree: A kaiming-uniform over its fan-in, B zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for site, shapes in lora_param_shapes(model, cara).items():
        bound = 1.0 / math.sqrt(shapes["a"][1])  # x @ A contracts dim 1
        out[site] = {
            "a": rng.uniform(-bound, bound, shapes["a"]).astype(np.float32),
            "b": np.zeros(shapes["b"], np.float32)}
    return out


def is_lora_params(tree) -> bool:
    """True for the per-site {a, b} layer-stacked tree above."""
    return (isinstance(tree, dict) and set(tree) == set(SITES)
            and all(isinstance(tree[s], dict) and set(tree[s]) == {"a", "b"}
                    for s in SITES))


def layer_stacks(params: Dict[str, Any]):
    """``(qkv stack, {"proj", "fc1", "fc2"} stacks)``: the two per-layer
    slots of the block (CaRA's A1 / P1 row slices)."""
    return params["qkv"], {s: params[s] for s in SITES[1:]}


def site_uv(site_params: Dict[str, torch.Tensor],
            comp: Optional[torch.Tensor] = None):
    """One layer's ``(U, V)`` of a site; ``comp`` (r,) is the rank
    weight-dropout mask, folded into V."""
    a, b = site_params["a"], site_params["b"]
    if comp is not None:
        b = b * comp[:, None]
    return a, b


def delta(x: torch.Tensor, site_params: Dict[str, torch.Tensor], *,
          element: bool = False, drop_mask: Optional[torch.Tensor] = None,
          comp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The XLA form's delta ``x @ dropout(A @ B)``, unscaled (the caller
    applies ``s``).  ``element`` materializes the dense (in, out) ``A @
    B`` and multiplies it by ``drop_mask`` (the inverted element mask, or
    None); otherwise ``comp_mask`` (r,) masks rank components in the
    factorized form.  The masks are drawn by the caller."""
    a, b = site_params["a"], site_params["b"]
    if element:
        t = a @ b
        if drop_mask is not None:
            t = t * drop_mask
        return x @ t.to(x.dtype)
    if comp_mask is not None:
        b = b * comp_mask[:, None]
    return (x @ a.to(x.dtype)) @ b.to(x.dtype)


def element_mask_shapes(model: ViTConfig) -> Dict[str, Tuple[int, int]]:
    """The (in, out) shape of each site's dense delta ``A @ B``, which the
    element route masks on the XLA form."""
    e, hid = model.embed_dim, model.hidden_dim
    return {"qkv": (e, 3 * e), "proj": (e, e), "fc1": (e, hid),
            "fc2": (hid, e)}


def merge_lora(params: Dict[str, Any], lora_params: Dict[str, Any],
               model: ViTConfig, cara: CaraConfig) -> Dict[str, Any]:
    """Fold the eval-mode LoRA deltas into the dense backbone:
    ``W_site += s * A @ B`` per layer, the product in fp32.  LoRA adds no
    bias."""
    del model
    s = cara.scale
    blocks = dict(params["blocks"])
    for site in SITES:
        a, b = lora_params[site]["a"], lora_params[site]["b"]
        kernel = blocks[site]["kernel"]
        d = torch.einsum("lir,lro->lio", a.float(), b.float())
        blocks[site] = {"kernel": kernel + (s * d).to(kernel.dtype),
                        "bias": blocks[site]["bias"]}
    out = dict(params)
    out["blocks"] = blocks
    return out
