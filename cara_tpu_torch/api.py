"""High-level model construction (port of ``cara_tpu/api.py``: CaRA
and its mixture of experts, LoRA, FacT-TT / TK, VPT deep / shallow, SSF,
BitFit, the Houlsby and AdaptFormer bottleneck adapters, and the
non-adapter control rows ``linear`` and ``full``).

The reference's public surface is ``cara(config)`` returning a patched
timm module (``src/cara/cara.py:169-188``); the functional equivalent
returns a :class:`CaraModel` bundle of numpy trees and both configs.

Random initialization uses numpy generators (``models/convert.py``): the
backbone from ``seed``, the adapter from ``seed + 1`` and the classifier
head from ``seed + 2``.  The JAX package draws from ``jax.random``, so the
two packages' seeded models differ; a checkpoint carries one across.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional

import numpy as np

from cara_tpu_torch.config import (NO_ADAPTER, PORTED_METHODS, CaraConfig,
                                   ViTConfig, get_model_config)
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import npz as npz_lib
from cara_tpu_torch.models.torch_import import TORCH_SUFFIXES


@dataclasses.dataclass
class CaraModel:
    cfg: ViTConfig
    cara_cfg: CaraConfig
    params: Dict[str, Any]        # backbone + head (head is trainable)
    cara_params: Dict[str, Any]   # adapter (trainable); {} for linear/full

    @property
    def trainable_count(self) -> int:
        """Adapter parameters only, head excluded: the reference's printed
        "Total parameters" (``vit_cp.py:175-183``).  The non-adapter
        control rows have no adapter tree: ``linear`` reports the head
        (what trains), ``full`` the whole model.  A mixture of experts
        counts its tree: the X experts and the router."""
        if self.cara_cfg.moe:
            from cara_tpu_torch.train.checkpoint import flatten_tree

            return sum(a.size for a in flatten_tree(self.cara_params).values())
        return self.cara_cfg.trainable_param_count(self.cfg)


def _head_in_dim(cfg: ViTConfig) -> int:
    return cfg.proj_dim or cfg.repr_size or cfg.embed_dim


def linear_init(seed: int, in_dim: int, out_dim: int) -> Dict[str, Any]:
    """torch ``nn.Linear`` default init (timm ``reset_classifier``,
    ``vit_cp.py:166``): weight and bias uniform in +-1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / math.sqrt(in_dim)
    return {"kernel": rng.uniform(-bound, bound, (in_dim, out_dim)
                                  ).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (out_dim,)).astype(np.float32)}


def build_model(
    model_name: str = "vit_base_patch16_224_in21k",
    *,
    method: str = "cara",
    rank: int = 32,
    scale: float = 1.0,
    l_mu: float = 1.0,
    l_std: float = 0.0,
    num_classes: Optional[int] = None,
    seed: int = 0,
    backbone_path: Optional[str] = None,
    cp_order: int = 4,
    delta_impl: str = "factorized",
    weight_dropout: Optional[float] = None,
    weight_dropout_impl: str = "element",
    moe_experts: int = 0,
    moe_top_k: int = 2,
    moe_aux_coef: float = 0.01,
    model_overrides: Optional[Dict[str, Any]] = None,
    fact_core_rank: int = 0,
    vpt_tokens: int = 8,
    adapter_dropout: Optional[float] = None,
) -> CaraModel:
    """Backbone (the npz at ``backbone_path`` when it exists, else random)
    + CaRA adapter + a fresh head of ``num_classes``, as the reference
    training script builds them (``vit_cp.py:155-166``).  ``weight_dropout=None``
    resolves to the method's default: the reference's 0.1 for CaRA, 0
    for ``linear`` / ``full``, whose adapter tree is empty
    (``cara_tpu/models/cara.py:142-147``).  ``weight_dropout_impl`` is
    "element" (the reference's), "rank" or "row"; ``cp_order`` 2-5 and
    ``delta_impl`` "factorized" or "materialized" (the dense deltas,
    element-masked in training).  A ``backbone_path`` ending in .pt,
    .pth or .bin is a HuggingFace CLIP vision tower
    (``models/clip_import.py``), any other an npz.  ``method`` "lora",
    "fact_tt" or "fact_tk" builds LoRA's or FacT's tree (weight dropout
    0 by default; ``fact_core_rank`` is FacT-TK's core rank, 0 for
    ``rank``); "vpt_deep" / "vpt_shallow" ``vpt_tokens`` prompts a stack,
    "ssf", "bitfit", and the bottleneck adapters "adapter" / "adaptformer"
    of width ``rank`` with internal dropout ``adapter_dropout`` (None: 0.1
    for AdaptFormer, its release's, and 0 for Houlsby; ``api.py:98-101``).
    ``moe_experts > 1`` builds CaRA's mixture of experts
    (``models/moe.py``): the {"experts", "router"} tree, routed top
    ``moe_top_k``, training adding ``moe_aux_coef`` times the load-balance
    loss."""
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"method={method!r} is not yet ported to cara_tpu_torch "
            "(ROADMAP.md queue 1: the PEFT zoo)")
    cfg = get_model_config(model_name, **(model_overrides or {}))
    if num_classes is not None:
        cfg = dataclasses.replace(cfg, num_classes=num_classes)
    if weight_dropout is None:
        weight_dropout = 0.1 if method == "cara" else 0.0
    if adapter_dropout is None:
        adapter_dropout = 0.1 if method == "adaptformer" else 0.0
    cara_cfg = CaraConfig(
        method=method, rank=rank, scale=scale, l_mu=l_mu, l_std=l_std,
        cp_order=cp_order, delta_impl=delta_impl,
        weight_dropout=weight_dropout,
        weight_dropout_impl=weight_dropout_impl,
        moe_experts=moe_experts, moe_top_k=moe_top_k,
        moe_aux_coef=moe_aux_coef, fact_core_rank=fact_core_rank,
        vpt_tokens=vpt_tokens, adapter_dropout=adapter_dropout)
    # A given num_classes always gets a fresh head; otherwise the npz's
    # own head is kept where its width matches.
    load_cfg = cfg if num_classes is None else dataclasses.replace(
        cfg, num_classes=0)
    if delta_impl not in ("factorized", "materialized"):
        raise ValueError(f"delta_impl must be 'factorized' or "
                         f"'materialized', got {delta_impl!r}")
    if backbone_path and os.path.exists(backbone_path):
        if backbone_path.endswith(TORCH_SUFFIXES):
            from cara_tpu_torch.models import clip_import

            params = clip_import.load_clip_backbone(backbone_path, cfg)
        else:
            params = npz_lib.load_npz_backbone(backbone_path, load_cfg)
        params = npz_lib.maybe_resize_pos_embed(params, cfg)
    else:
        params = convert.init_vit_params(
            dataclasses.replace(cfg, num_classes=0), seed)
    if cfg.num_classes > 0 and "head" not in params:
        params["head"] = linear_init(seed + 2, _head_in_dim(cfg),
                                     cfg.num_classes)
    cara_params = ({} if method in NO_ADAPTER
                   else convert.init_cara_params(cfg, cara_cfg, seed + 1))
    return CaraModel(cfg, cara_cfg, params, cara_params)
