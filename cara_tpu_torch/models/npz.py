"""Loader for the original Google-format ViT ``.npz`` checkpoints
(``ViT-B_16.npz``), numpy only (port of ``cara_tpu/models/npz.py``).

The reference feeds this file to timm (``vit_cp.py:155``).  Key layout
(AugReg / original releases)::

    embedding/kernel (P,P,3,D)            embedding/bias (D,)
    cls (1,1,D)
    Transformer/posembed_input/pos_embedding (1,N+1,D)
    Transformer/encoderblock_{i}/LayerNorm_0/{scale,bias}
    Transformer/encoderblock_{i}/MultiHeadDotProductAttention_1/
        {query,key,value}/kernel (D,H,Dh)  .../bias (H,Dh)
        out/kernel (H,Dh,D)                out/bias (D,)
    Transformer/encoderblock_{i}/LayerNorm_2/{scale,bias}
    Transformer/encoderblock_{i}/MlpBlock_3/Dense_{0,1}/{kernel,bias}
    Transformer/encoder_norm/{scale,bias}
    pre_logits/{kernel,bias}              (absent in some releases)
    head/{kernel,bias}                    (absent / num_classes varies)

The q/k/v kernels are fused into the (D, 3*D) qkv kernel with output order
(3, heads, head_dim), the layout both packages' forwards unpack.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from cara_tpu_torch.config import ViTConfig


def _get(z, key):
    if key not in z:
        raise KeyError(f"npz checkpoint missing '{key}' — keys present: "
                       f"{sorted(z.keys())[:8]}...")
    return np.asarray(z[key])


def load_npz_backbone(path: str, cfg: ViTConfig) -> Dict[str, Any]:
    """Read the npz and return the stacked-blocks fp32 numpy tree."""
    with np.load(path) as z:
        return convert_npz_dict(dict(z), cfg)


def convert_npz_dict(z: Dict[str, np.ndarray],
                     cfg: ViTConfig) -> Dict[str, Any]:
    e, depth, p = cfg.embed_dim, cfg.depth, cfg.patch_size
    emb_k = _get(z, "embedding/kernel")  # (P, P, C, D) HWIO
    if emb_k.shape != (p, p, cfg.in_chans, e):
        raise ValueError(f"embedding/kernel {emb_k.shape} does not match "
                         f"patch {p} x {cfg.in_chans} -> {e}")

    def arr(x):
        return np.asarray(x, np.float32)

    params: Dict[str, Any] = {
        "embed": {"kernel": arr(emb_k.reshape(p * p * cfg.in_chans, e)),
                  "bias": arr(_get(z, "embedding/bias"))},
        "cls": arr(_get(z, "cls")),
        "pos_embed": arr(_get(z, "Transformer/posembed_input/pos_embedding")),
        "norm": {"scale": arr(_get(z, "Transformer/encoder_norm/scale")),
                 "bias": arr(_get(z, "Transformer/encoder_norm/bias"))},
    }
    attn = "MultiHeadDotProductAttention_1"
    cols = {k: [] for k in ("ln1_s", "ln1_b", "ln2_s", "ln2_b", "qkv_k",
                            "qkv_b", "out_k", "out_b", "fc1_k", "fc1_b",
                            "fc2_k", "fc2_b")}
    for i in range(depth):
        def blk(suffix):
            return _get(z, f"Transformer/encoderblock_{i}/{suffix}")

        cols["ln1_s"].append(blk("LayerNorm_0/scale"))
        cols["ln1_b"].append(blk("LayerNorm_0/bias"))
        cols["ln2_s"].append(blk("LayerNorm_2/scale"))
        cols["ln2_b"].append(blk("LayerNorm_2/bias"))
        qs = [blk(f"{attn}/{n}/kernel") for n in ("query", "key", "value")]
        bs = [blk(f"{attn}/{n}/bias") for n in ("query", "key", "value")]
        # (D,H,Dh) x3 -> (D, 3, H, Dh) -> (D, 3D); bias (H,Dh) x3 -> (3D,)
        cols["qkv_k"].append(np.stack(qs, axis=1).reshape(e, 3 * e))
        cols["qkv_b"].append(np.stack(bs, axis=0).reshape(3 * e))
        cols["out_k"].append(blk(f"{attn}/out/kernel").reshape(e, e))
        cols["out_b"].append(blk(f"{attn}/out/bias"))
        cols["fc1_k"].append(blk("MlpBlock_3/Dense_0/kernel"))
        cols["fc1_b"].append(blk("MlpBlock_3/Dense_0/bias"))
        cols["fc2_k"].append(blk("MlpBlock_3/Dense_1/kernel"))
        cols["fc2_b"].append(blk("MlpBlock_3/Dense_1/bias"))

    def st(key):
        return arr(np.stack(cols[key]))

    params["blocks"] = {
        "ln1_scale": st("ln1_s"), "ln1_bias": st("ln1_b"),
        "qkv": {"kernel": st("qkv_k"), "bias": st("qkv_b")},
        "proj": {"kernel": st("out_k"), "bias": st("out_b")},
        "ln2_scale": st("ln2_s"), "ln2_bias": st("ln2_b"),
        "fc1": {"kernel": st("fc1_k"), "bias": st("fc1_b")},
        "fc2": {"kernel": st("fc2_k"), "bias": st("fc2_b")},
    }
    if "pre_logits/kernel" in z and cfg.repr_size is not None:
        params["pre_logits"] = {"kernel": arr(_get(z, "pre_logits/kernel")),
                                "bias": arr(_get(z, "pre_logits/bias"))}
    if "head/kernel" in z and cfg.num_classes > 0:
        hk = _get(z, "head/kernel")
        if hk.shape[-1] == cfg.num_classes:
            params["head"] = {"kernel": arr(hk),
                              "bias": arr(_get(z, "head/bias"))}
    return params


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel (a = -0.5), as ``jax.image``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) bicubic resampling weights with antialiasing on
    downscale and per-output normalization: ``jax.image.resize``'s
    ``compute_weight_mat`` at translation 0."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = _keys_cubic(x / kernel_scale).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def maybe_resize_pos_embed(params, cfg: ViTConfig):
    """Bicubic-interpolate a checkpoint pos-embed to the configured grid
    (fine-tuning at another resolution); a no-op when it already fits."""
    pos = np.asarray(params["pos_embed"])
    if pos.shape[1] == cfg.seq_len:
        return params
    has_cls = cfg.use_cls_token
    grid_old = int(round((pos.shape[1] - (1 if has_cls else 0)) ** 0.5))
    body = (pos[:, 1:] if has_cls else pos).reshape(grid_old, grid_old, -1)
    w = _resize_weights(grid_old, cfg.grid_size)
    body = np.einsum("hwd,hH,wW->HWd", body.astype(np.float32), w, w)
    body = body.reshape(1, cfg.grid_size ** 2, -1).astype(pos.dtype)
    out = dict(params)
    out["pos_embed"] = (np.concatenate([pos[:, :1], body], axis=1)
                        if has_cls else body)
    return out
