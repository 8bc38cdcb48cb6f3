"""Importer of CLIP vision towers in HuggingFace's layout (port of
``cara_tpu/models/clip_import.py``).

Maps a ``CLIPVisionModelWithProjection`` state dict (the format
``openai/clip-vit-large-patch14`` ships in) onto the port's stacked tree
for ``vit_large_patch14_224_clip`` (ln_pre, quick_gelu, the visual
projection).  It reads a state dict only and imports no ``transformers``.
Key map (HF -> port)::

    vision_model.embeddings.class_embedding (E,)           cls (1, 1, E)
    vision_model.embeddings.patch_embedding.weight (E,C,P,P) embed.kernel
        -> transpose (2, 3, 1, 0), reshape (P*P*C, E); bias zeros (none)
    vision_model.embeddings.position_embedding.weight (N+1, E) pos_embed
    vision_model.pre_layrnorm.{weight,bias}                ln_pre (the
        upstream attribute's spelling; ``pre_layernorm`` is read too)
    ...layers.{i}.self_attn.{q,k,v}_proj  3 x (E, E)       blocks.qkv:
        rows concatenated, then transposed: (E, 3E), columns (3, H, Dh)
    ...layers.{i}.self_attn.out_proj                       blocks.proj
    ...layers.{i}.layer_norm{1,2}                 blocks.ln{1,2}_{scale,bias}
    ...layers.{i}.mlp.fc{1,2}                              blocks.fc{1,2}
    vision_model.post_layernorm                            norm
    visual_projection.weight (proj, E)             proj_out.kernel (E, proj)
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from cara_tpu_torch.config import ViTConfig


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().float().numpy()
    return np.asarray(v)


def _get(sd: Dict[str, Any], *keys: str) -> np.ndarray:
    for k in keys:
        if k in sd:
            return _np(sd[k])
    raise KeyError(f"CLIP state dict missing {keys[0]!r} — sample keys: "
                   f"{sorted(sd)[:6]}...")


def is_clip_state_dict(sd: Dict[str, Any]) -> bool:
    return any(k.startswith("vision_model.") for k in sd)


def convert_hf_clip_vision(sd: Dict[str, Any], cfg: ViTConfig,
                           dtype=np.float32) -> Dict[str, Any]:
    """HF CLIP vision state dict -> the port's backbone tree (numpy)."""
    e, depth, p, c = cfg.embed_dim, cfg.depth, cfg.patch_size, cfg.in_chans
    vm = "vision_model."
    layer = vm + "encoder.layers.{}."
    conv = _get(sd, vm + "embeddings.patch_embedding.weight")
    if conv.shape != (e, c, p, p):
        raise ValueError(f"patch embedding {conv.shape} != {(e, c, p, p)} "
                         "— wrong --model geometry for this checkpoint?")

    def stack(name, transpose=False):
        arrs = [_get(sd, layer.format(i) + name) for i in range(depth)]
        return np.stack([a.T if transpose else a for a in arrs]).astype(dtype)

    def qkv(part, i):
        return np.concatenate([
            _get(sd, layer.format(i) + f"self_attn.{n}_proj.{part}")
            for n in ("q", "k", "v")], axis=0)

    def linear(name):
        return {"kernel": stack(name + ".weight", transpose=True),
                "bias": stack(name + ".bias")}

    params: Dict[str, Any] = {
        "embed": {"kernel": np.ascontiguousarray(conv.transpose(
                      2, 3, 1, 0).reshape(p * p * c, e)).astype(dtype),
                  "bias": np.zeros((e,), dtype)},
        "cls": _get(sd, vm + "embeddings.class_embedding").reshape(
            1, 1, e).astype(dtype),
        "pos_embed": _get(
            sd, vm + "embeddings.position_embedding.weight")[None].astype(
                dtype),
        "ln_pre": {
            "scale": _get(sd, vm + "pre_layrnorm.weight",
                          vm + "pre_layernorm.weight").astype(dtype),
            "bias": _get(sd, vm + "pre_layrnorm.bias",
                         vm + "pre_layernorm.bias").astype(dtype)},
        "blocks": {
            "ln1_scale": stack("layer_norm1.weight"),
            "ln1_bias": stack("layer_norm1.bias"),
            "qkv": {"kernel": np.stack([qkv("weight", i).T
                                        for i in range(depth)]).astype(dtype),
                    "bias": np.stack([qkv("bias", i)
                                      for i in range(depth)]).astype(dtype)},
            "proj": linear("self_attn.out_proj"),
            "ln2_scale": stack("layer_norm2.weight"),
            "ln2_bias": stack("layer_norm2.bias"),
            "fc1": linear("mlp.fc1"),
            "fc2": linear("mlp.fc2"),
        },
        "norm": {"scale": _get(sd, vm + "post_layernorm.weight").astype(dtype),
                 "bias": _get(sd, vm + "post_layernorm.bias").astype(dtype)},
    }
    if cfg.proj_dim is not None:
        params["proj_out"] = {"kernel": np.ascontiguousarray(
            _get(sd, "visual_projection.weight").T).astype(dtype)}
    return params


def load_clip_backbone(path: str, cfg: ViTConfig, dtype=np.float32):
    """A torch-serialized HF CLIP checkpoint (.pt / .pth / .bin) -> the
    port's backbone tree."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    if not is_clip_state_dict(sd):
        raise ValueError(f"{path} does not look like an HF CLIP vision "
                         "checkpoint (no 'vision_model.*' keys)")
    return convert_hf_clip_vision(sd, cfg, dtype)
