"""VPT: visual prompt tuning, deep and shallow (port of
``cara_tpu/models/vpt.py``).

The backbone stays frozen and only P learnable prompt tokens train:
VPT-Deep replaces each layer's prompt slots with that layer's tokens
before the block runs, VPT-Shallow inserts them once at the input.
Parameter tree: ``{"prompts": (L, P, E)}`` (deep) or ``(1, P, E)``
(shallow).  The prompts sit between the cls token and the patch tokens
(positions 1..P with a cls token, 0..P-1 without), after the position
embedding (they take none), and are stripped before a mean-pool head
reads the tokens.  Init (numpy, seeded): xavier-uniform over the
patch-embed fan, ``U(-v, v), v = sqrt(6 / (3 * patch**2 + E))``.

The sequence becomes N + P tokens, and the attention takes its route by
that length as for any other: the full-score kernels (TPU rows 1, 2) up
to 512 tokens, the blockwise ones (row 16) past it.  The prompt ops are
out-of-place tensor ops that autograd records.  VPT is architectural:
there is no merged export (``merge_cara`` raises).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from cara_tpu_torch.config import CaraConfig, ViTConfig


def vpt_param_shapes(model: ViTConfig,
                     cara: CaraConfig) -> Dict[str, Tuple[int, ...]]:
    stacks = model.depth if cara.method == "vpt_deep" else 1
    return {"prompts": (stacks, cara.vpt_tokens, model.embed_dim)}


def init_vpt_params(model: ViTConfig, cara: CaraConfig,
                    seed: int) -> Dict[str, np.ndarray]:
    """numpy fp32 tree: xavier-uniform over the patch-embed fan."""
    shape = vpt_param_shapes(model, cara)["prompts"]
    val = math.sqrt(6.0 / float(3 * model.patch_size * model.patch_size
                                + model.embed_dim))
    rng = np.random.default_rng(seed)
    return {"prompts": rng.uniform(-val, val, shape).astype(np.float32)}


def is_vpt_params(tree) -> bool:
    return (isinstance(tree, dict) and set(tree) == {"prompts"}
            and getattr(tree["prompts"], "ndim", 0) == 3)


def detect_method(tree) -> str:
    """"vpt_deep" / "vpt_shallow" from the prompt stack's leading axis."""
    return "vpt_deep" if tree["prompts"].shape[0] > 1 else "vpt_shallow"


def check_geometry(tree, model: ViTConfig, cara: CaraConfig) -> None:
    want = vpt_param_shapes(model, cara)["prompts"]
    got = tuple(tree["prompts"].shape)
    if got != want:
        raise ValueError(
            f"VPT prompt stack has shape {got}; method={cara.method!r} "
            f"with vpt_tokens={cara.vpt_tokens} on this model geometry "
            f"wants {want} — was the tree trained with a different "
            "model/config?")


def _broadcast(tokens: torch.Tensor, prompts: torch.Tensor) -> torch.Tensor:
    b = tokens.shape[0]
    return prompts.to(tokens.dtype).expand(b, *prompts.shape[-2:])


def insert_prompts(tokens: torch.Tensor, prompts: torch.Tensor,
                   pos0: int) -> torch.Tensor:
    """The (P, E) ``prompts``, broadcast over the batch, concatenated into
    the sequence at ``pos0`` (1 with a cls token, 0 without)."""
    return torch.cat([tokens[:, :pos0], _broadcast(tokens, prompts),
                      tokens[:, pos0:]], dim=1)


def set_prompts(tokens: torch.Tensor, prompts_l: torch.Tensor,
                pos0: int) -> torch.Tensor:
    """VPT-Deep's per-layer replacement of the prompt slots with this
    layer's (P, E) tokens."""
    p = prompts_l.shape[-2]
    return torch.cat([tokens[:, :pos0], _broadcast(tokens, prompts_l),
                      tokens[:, pos0 + p:]], dim=1)


def strip_prompts(tokens: torch.Tensor, n_prompts: int,
                  pos0: int) -> torch.Tensor:
    """The sequence without its prompt slots."""
    return torch.cat([tokens[:, :pos0], tokens[:, pos0 + n_prompts:]], dim=1)
