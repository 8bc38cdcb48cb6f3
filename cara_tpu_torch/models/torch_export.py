"""Exporter to the reference's torch ``.pt`` format (port of
``cara_tpu/models/torch_export.py``), the inverse of
:mod:`cara_tpu_torch.models.torch_import`.

The port's stacked tree -> a timm-0.4.12 ViT ``state_dict`` with the CaRA
``CP_*`` parameters at the root, which the reference's ``--evaluate``
loads with a strict ``load_state_dict`` (``vit_cp.py:66,168-173``): linear
kernels (in, out) -> (out, in), the patch-embed GEMM kernel (P*P*C, E) ->
the OIHW conv weight (E, C, P, P), the stacked layers -> ``blocks.{i}.*``,
the CP factors with their ``CP_`` prefix.  Values are fp32 (the
reference trains in fp32).  Only CP adapters of orders 2-5 exist in the
reference; any other adapter tree is refused.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from cara_tpu_torch.config import ViTConfig
from cara_tpu_torch.models.torch_import import FACTOR_NAMES, SHARED_NAMES


def _np32(v) -> np.ndarray:
    """Array-like or tensor (bf16 too) -> contiguous fp32 numpy."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().float().numpy()
    return np.ascontiguousarray(np.asarray(v, dtype=np.float32))


def to_torch_state_dict(params: Dict[str, Any],
                        cara_params: Optional[Dict[str, Any]],
                        cfg: ViTConfig,
                        cp_order: int = 4) -> Dict[str, np.ndarray]:
    """(params, cara_params) -> the flat timm ``state_dict`` as fp32 numpy
    arrays.  Raises ``ValueError`` for an adapter tree that is not a
    plain CP factor set of ``cp_order``."""
    e, depth, p, c = cfg.embed_dim, cfg.depth, cfg.patch_size, cfg.in_chans
    emb_k = _np32(params["embed"]["kernel"])
    if emb_k.shape != (p * p * c, e):
        raise ValueError(f"embed kernel shape {emb_k.shape} does not match "
                         f"config (want ({p * p * c}, {e}))")
    sd: Dict[str, np.ndarray] = {
        "cls_token": _np32(params["cls"]),
        "pos_embed": _np32(params["pos_embed"]),
        "patch_embed.proj.weight": np.ascontiguousarray(
            emb_k.reshape(p, p, c, e).transpose(3, 2, 0, 1)),
        "patch_embed.proj.bias": _np32(params["embed"]["bias"]),
    }
    blocks = params["blocks"]
    b32 = {k: ({kk: _np32(vv) for kk, vv in v.items()}
               if isinstance(v, dict) else _np32(v))
           for k, v in blocks.items()}
    for i in range(depth):
        pre = f"blocks.{i}."
        sd[pre + "norm1.weight"] = b32["ln1_scale"][i]
        sd[pre + "norm1.bias"] = b32["ln1_bias"][i]
        for ours, theirs in (("qkv", "attn.qkv"), ("proj", "attn.proj")):
            sd[pre + theirs + ".weight"] = np.ascontiguousarray(
                b32[ours]["kernel"][i].T)
            sd[pre + theirs + ".bias"] = b32[ours]["bias"][i]
        sd[pre + "norm2.weight"] = b32["ln2_scale"][i]
        sd[pre + "norm2.bias"] = b32["ln2_bias"][i]
        for ours, theirs in (("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            sd[pre + theirs + ".weight"] = np.ascontiguousarray(
                b32[ours]["kernel"][i].T)
            sd[pre + theirs + ".bias"] = b32[ours]["bias"][i]
    sd["norm.weight"] = _np32(params["norm"]["scale"])
    sd["norm.bias"] = _np32(params["norm"]["bias"])
    for ours, theirs in (("pre_logits", "pre_logits.fc"), ("head", "head")):
        if ours in params:
            sd[theirs + ".weight"] = np.ascontiguousarray(
                _np32(params[ours]["kernel"]).T)
            sd[theirs + ".bias"] = _np32(params[ours]["bias"])
    if cara_params is not None:
        if cp_order not in FACTOR_NAMES:
            raise ValueError(f"unsupported cp_order {cp_order}")
        names = FACTOR_NAMES[cp_order] + SHARED_NAMES
        missing = [n for n in names if n not in cara_params]
        extra = [n for n in cara_params if n not in names]
        if missing or extra:
            raise ValueError(
                "adapter tree is not a plain CP factor set (only CP "
                "adapters exist in the reference; LoRA/VPT/SSF/BitFit/"
                f"adapter/MoE trees cannot export) — missing={missing} "
                f"unexpected={extra}")
        for n in names:
            sd["CP_" + n] = _np32(cara_params[n])
    return sd


def save_torch_checkpoint(path: str, params: Dict[str, Any],
                          cara_params: Optional[Dict[str, Any]],
                          cfg: ViTConfig, cp_order: int = 4) -> None:
    """Write a ``.pt`` the reference loads (``torch.save`` of a flat
    tensor ``state_dict``, the format of ``vit_cp.py:66``)."""
    import torch

    sd = to_torch_state_dict(params, cara_params, cfg, cp_order)
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, path)
