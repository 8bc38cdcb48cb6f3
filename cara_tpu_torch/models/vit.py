"""Eval forward of the Vision Transformer with optional CaRA adapters (port
of ``cara_tpu/models/vit.py``, serving subset).

Layouts are the JAX package's: NHWC images, (in, out) kernels, blocks
stacked on a leading layer axis, qkv columns out-flat (3, H, Dh).  The
layer loop is plain Python (eager PyTorch has no ``scan`` to lower).

Two block routes, chosen by whether an adapter is present, as on the TPU:

* merged / plain backbone: LN1, the qkv GEMM, the
  :func:`fused_qkv_attention` kernel, then the proj / fc1 / GELU / fc2
  GEMMs, all plain PyTorch (``F.linear`` / ``F.layer_norm``: XLA ops
  outside any Pallas kernel in the reference);
* adapter kept: :func:`cp_attn_block` then :func:`cp_mlp_block`.

``impl="auto"`` calls the kernel wrappers, which launch the CUDA kernels
for CUDA tensors and run their plain versions for CPU tensors;
``impl="plain"`` calls the plain versions on any device (the reference
the kernels are held against).  The TPU-only machinery of the reference
(the 197 -> 200 stream pad, tile pickers, tune cache, ``CARA_*`` knobs)
is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from cara_tpu_torch.config import CaraConfig, ViTConfig
from cara_tpu_torch.models import cara as cara_lib
from cara_tpu_torch.ops.cuda import cp_attn_block as attn_mod
from cara_tpu_torch.ops.cuda import cp_mlp as mlp_mod
from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa_mod
from cara_tpu_torch.ops.layers import activation, layer_norm, linear

Params = Dict[str, Any]
IMPLS = ("auto", "plain")


def patch_embed(params: Params, x: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """(B, H, W, C) -> (B, num_patches, E) by reshape + matmul; flatten
    order (ph, pw, c) as the HWIO conv kernel of the npz checkpoints."""
    b = x.shape[0]
    p, g = cfg.patch_size, cfg.grid_size
    x = x.reshape(b, g, p, g, p, cfg.in_chans)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * cfg.in_chans)
    return linear(x, params["embed"]["kernel"], params["embed"]["bias"])


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _block(x, bp, f1, p1, cfg: ViTConfig, cara_params, cara_cfg, impl):
    """One eval transformer block (drop-path and dropout are identities)."""
    e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    mr = cfg.mlp_ratio
    b, n = x.shape[:2]
    plain = impl == "plain"
    dpm = torch.ones((b, 1), dtype=x.dtype, device=x.device)
    if cara_params is None:
        xa = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.layernorm_eps)
        qkv = linear(xa, bp["qkv"]["kernel"], bp["qkv"]["bias"])
        attn = (fqa_mod.fused_qkv_attention_plain if plain
                else fqa_mod.fused_qkv_attention)
        o = attn(qkv, h, d ** -0.5, n)
        x = x + linear(o, bp["proj"]["kernel"], bp["proj"]["bias"])
        xm = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.layernorm_eps)
        hid = activation(linear(xm, bp["fc1"]["kernel"], bp["fc1"]["bias"]),
                         cfg.activation)
        return x + linear(hid, bp["fc2"]["kernel"], bp["fc2"]["bias"])

    s = cara_cfg.scale
    dt = x.dtype

    def fold(t):  # the delta scale rides the factors; kernels run at s=1
        return (t * s).to(dt).contiguous()

    def cast(t):
        return t.to(dt).contiguous()

    p2, p3, r2 = cara_params["P2"], cara_params["P3"], cara_params["R2"]
    u1, v1 = cara_lib.qkv_uv(cara_params, f1, cfg, cara_cfg)
    u2, v2 = cara_lib.rows_out_uv(p1[0:1], p2, p3, r2)
    attn_block = (attn_mod.cp_attn_block_plain if plain
                  else attn_mod.cp_attn_block)
    x = attn_block(
        x, bp["qkv"]["kernel"], bp["qkv"]["bias"], cast(u1), fold(v1),
        bp["proj"]["kernel"], bp["proj"]["bias"], cast(u2), fold(v2),
        fold(cara_params["bias1"]), bp["ln1_scale"], bp["ln1_bias"], dpm,
        h, d ** -0.5, n, 1.0, cfg.layernorm_eps)
    u3, v3 = cara_lib.rows_out_uv(p1[1:1 + mr], p2, p3, r2)
    u4, v4 = cara_lib.rows_in_uv(p1[1 + mr:1 + 2 * mr], p2, p3, r2)
    mlp_block = mlp_mod.cp_mlp_block_plain if plain else mlp_mod.cp_mlp_block
    return mlp_block(
        x, bp["fc1"]["kernel"], bp["fc1"]["bias"], cast(u3), fold(v3),
        fold(cara_params["bias2"]), bp["fc2"]["kernel"], bp["fc2"]["bias"],
        cast(u4), fold(v4), fold(cara_params["bias3"]),
        bp["ln2_scale"], bp["ln2_bias"], dpm.reshape(b, 1, 1), 1.0,
        cfg.activation, cfg.layernorm_eps)


def vit_forward(params: Params, x: torch.Tensor, cfg: ViTConfig,
                cara_params: Optional[Dict[str, torch.Tensor]] = None,
                cara_cfg: Optional[CaraConfig] = None,
                impl: str = "auto") -> torch.Tensor:
    """Eval forward: images (B, H, W, C) NHWC -> logits (B, num_classes).

    ``params`` / ``cara_params`` are tensor trees on ``x``'s device (see
    ``models.convert.params_from_numpy``); the forward computes in
    ``x.dtype``."""
    if (cara_params is None) != (cara_cfg is None):
        raise ValueError("cara_params and cara_cfg must be provided together")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if cara_cfg is not None:
        if cara_cfg.method != "cara" or cara_cfg.moe:
            raise NotImplementedError(
                f"method={cara_cfg.method!r} (moe={cara_cfg.moe}) is not yet "
                "ported to cara_tpu_torch; CaRA adapters only")
        if cara_cfg.cp_order == 2:
            raise NotImplementedError(
                "cp_order=2 has no rank-space form for the block kernels "
                "and its materialized path is not yet ported")
        if not isinstance(cara_params, dict) or "A1" not in cara_params:
            raise ValueError("cara_cfg.method='cara' wants the CP factor tree "
                             "(A1..., P1-P3, R1/R2, bias1-3)")
    tokens = patch_embed(params, x, cfg)
    if cfg.use_cls_token:
        cls = params["cls"].to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + params["pos_embed"].to(tokens.dtype)
    if cfg.ln_pre:
        tokens = layer_norm(tokens, params["ln_pre"]["scale"],
                            params["ln_pre"]["bias"], cfg.layernorm_eps)
    a1 = p1 = None
    if cara_params is not None:
        a1, p1 = cara_lib.stacked_layer_slices(cara_params, cfg, cara_cfg)
    for layer in range(cfg.depth):
        tokens = _block(
            tokens, _layer(params["blocks"], layer),
            None if a1 is None else a1[layer],
            None if p1 is None else p1[layer],
            cfg, cara_params, cara_cfg, impl)
    if cfg.use_cls_token:
        # LayerNorm is per token: only the cls row feeds the head.
        feat = layer_norm(tokens[:, 0], params["norm"]["scale"],
                          params["norm"]["bias"], cfg.layernorm_eps)
    else:
        feat = layer_norm(tokens, params["norm"]["scale"],
                          params["norm"]["bias"], cfg.layernorm_eps).mean(1)
    if cfg.repr_size is not None:
        pl_ = params["pre_logits"]
        feat = torch.tanh(linear(feat, pl_["kernel"], pl_["bias"]))
    if cfg.proj_dim is not None:
        feat = feat @ params["proj_out"]["kernel"]
    if "head" not in params:
        return feat
    return linear(feat, params["head"]["kernel"], params["head"]["bias"])
