"""Bottleneck adapters, Houlsby sequential and AdaptFormer parallel (port
of ``cara_tpu/models/adapter.py``).

* ``"adapter"`` (Houlsby): ``z + up(gelu(down(z)))`` on both sublayer
  outputs (after the attention projection and after fc2), inside the
  block's dropout, drop-path and residual.
* ``"adaptformer"``: one bottleneck ``up(dropout(relu(down(x))))`` a
  block on the pre-LN2 residual stream, scaled by ``s``
  (``CaraConfig.scale``) and added beside the drop-pathed MLP branch,
  with its own internal dropout (``CaraConfig.adapter_dropout``).

Parameter tree, every leaf layer-stacked::

    {"attn_down": {"kernel": (L, E, r), "bias": (L, r)},   # "adapter" only
     "attn_up":   {"kernel": (L, r, E), "bias": (L, E)},   # "adapter" only
     "mlp_down":  {"kernel": (L, E, r), "bias": (L, r)},
     "mlp_up":    {"kernel": (L, r, E), "bias": (L, E)}}

Init (numpy, seeded): down kernel ``U(-1/sqrt(E), 1/sqrt(E))``, up
kernel and both biases zero, so the adapter is the identity at step 0.
The nonlinearity makes these adapters unmergeable (``merge_cara``
raises) and keeps them off the fused CaRA sites: they run on the XLA
dense block forms, their two rank-r GEMMs plain PyTorch, as the
reference leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cara_tpu_torch.config import CaraConfig, ViTConfig
from cara_tpu_torch.ops.layers import dropout, gelu, linear

SEQ_SITES = ("attn_down", "attn_up", "mlp_down", "mlp_up")
PAR_SITES = ("mlp_down", "mlp_up")


def adapter_param_shapes(model: ViTConfig, cara: CaraConfig
                         ) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Per-site {kernel, bias} shapes, every leaf layer-stacked."""
    n_layers, e, r = model.depth, model.embed_dim, cara.rank
    down = {"kernel": (n_layers, e, r), "bias": (n_layers, r)}
    up = {"kernel": (n_layers, r, e), "bias": (n_layers, e)}
    shapes = {"mlp_down": down, "mlp_up": up}
    if cara.method == "adapter":
        shapes["attn_down"] = down
        shapes["attn_up"] = up
    return shapes


def init_adapter_params(model: ViTConfig, cara: CaraConfig,
                        seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """numpy fp32 tree: down kaiming-uniform over E, up and biases zero
    (the down sites drawn in sorted order)."""
    shapes = adapter_param_shapes(model, cara)
    rng = np.random.default_rng(seed)
    bound = 1.0 / math.sqrt(model.embed_dim)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for site in sorted(s for s in shapes if s.endswith("_down")):
        out[site] = {
            "kernel": rng.uniform(-bound, bound, shapes[site]["kernel"]
                                  ).astype(np.float32),
            "bias": np.zeros(shapes[site]["bias"], np.float32)}
        up = site.replace("_down", "_up")
        out[up] = {"kernel": np.zeros(shapes[up]["kernel"], np.float32),
                   "bias": np.zeros(shapes[up]["bias"], np.float32)}
    return out


def is_adapter_params(tree) -> bool:
    """True for the layer-stacked bottleneck tree above (either method)."""
    return (isinstance(tree, dict)
            and set(tree) in (set(SEQ_SITES), set(PAR_SITES))
            and all(isinstance(tree[s], dict)
                    and set(tree[s]) == {"kernel", "bias"} for s in tree))


def detect_method(tree) -> str:
    """"adapter" (sequential) vs "adaptformer" (parallel) from the tree."""
    return "adapter" if "attn_down" in tree else "adaptformer"


def check_geometry(tree, model: ViTConfig, cara: CaraConfig) -> None:
    """Fail fast on a tree trained with a different model/config."""
    want = adapter_param_shapes(model, cara)
    if set(tree) != set(want):
        raise ValueError(
            f"adapter tree sites {sorted(tree)} do not match "
            f"method={cara.method!r} (wants {sorted(want)}) — was it "
            "trained as the other adapter variant?")
    for site, pair in want.items():
        for leaf, shape in pair.items():
            got = tuple(tree[site][leaf].shape)
            if got != shape:
                raise ValueError(
                    f"adapter {site}/{leaf} has shape {got}; rank="
                    f"{cara.rank} on this model geometry wants {shape}")


def bottleneck(x: torch.Tensor, down: Dict[str, torch.Tensor],
               up: Dict[str, torch.Tensor], act: str,
               keep: Optional[torch.Tensor] = None,
               rate: float = 0.0) -> torch.Tensor:
    """``up(dropout(act(down(x))))`` for one layer's {kernel, bias} pair,
    in ``x.dtype``; ``act`` "relu" or "gelu" (exact erf); ``keep`` the
    boolean (..., r) dropout mask of rate ``rate`` (None in eval).  The
    caller adds the skip or the scale."""
    dt = x.dtype
    h = linear(x, down["kernel"].to(dt), down["bias"].to(dt))
    h = torch.relu(h) if act == "relu" else gelu(h)
    h = dropout(h, rate, keep)
    return linear(h, up["kernel"].to(dt), up["bias"].to(dt))
