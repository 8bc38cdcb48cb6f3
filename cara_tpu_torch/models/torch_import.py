"""Importer of the reference's torch ``.pt`` checkpoints (port of
``cara_tpu/models/torch_import.py``).

The reference's released per-task checkpoints are full ``state_dict``s
of a timm-0.4.12 ViT with the CaRA ``CP_*`` parameters on the root
module (``src/cara/cara.py:112-125``) and the classifier head reset
(``vit_cp.py:166``); its ``--evaluate`` reads them.  This module maps
such a state dict onto the port's stacked numpy tree (the layout of
``models/npz.py``):

* ``nn.Linear`` weights are (out, in) and compute ``x @ W.T + b``; the
  port's kernels are (in, out): transposed;
* ``patch_embed.proj.weight`` is an OIHW conv kernel (E, C, P, P);
  the patch embed is a GEMM over (ph, pw, c)-flattened patches:
  permuted to HWIO and flattened, as the npz loader does;
* ``blocks.{i}.attn.qkv.weight`` is (3E, E), its rows ordered
  (3, heads, head_dim): transposed it is the (E, 3E) kernel whose
  columns are (3, H, Dh), timm's ``reshape(B, N, 3, H, Dh)``;
* ``CP_*`` copy over without their prefix (the row bookkeeping of
  ``A1`` and ``P1`` is the reference's ``attn_idx`` / ``idx``);
* a ``module.`` prefix on every key (``DataParallel``) is dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from cara_tpu_torch.config import ViTConfig

TORCH_SUFFIXES = (".pt", ".pth", ".bin")

#: The qkv factor names of each CP order (``set_cara`` / ``set_CP``).
FACTOR_NAMES = {5: ("A1", "A2", "A3", "A4", "A5"),
                4: ("A1", "A2", "A3", "A4"),
                3: ("A1", "A2", "A3"),
                2: ("A1", "A2")}
SHARED_NAMES = ("P1", "P2", "P3", "R1", "R2", "bias1", "bias2", "bias3")


def _np(v) -> np.ndarray:
    """torch.Tensor | np.ndarray -> np.ndarray."""
    if hasattr(v, "detach"):
        return v.detach().cpu().float().numpy()
    return np.asarray(v)


def _get(sd: Dict[str, Any], key: str) -> np.ndarray:
    if key not in sd:
        raise KeyError(f"torch state dict missing '{key}' — first keys "
                       f"present: {sorted(sd)[:10]}...")
    return _np(sd[key])


def infer_cara_layout(sd: Dict[str, Any]) -> Optional[Tuple[int, int]]:
    """(cp_order, rank) from the ``CP_*`` keys, or None without an
    adapter."""
    if "CP_R1" not in sd:
        return None
    rank = int(_np(sd["CP_R1"]).shape[0])
    for order in (5, 4, 3):
        if f"CP_A{order}" in sd:
            return order, rank
    return 2, rank


def convert_torch_state_dict(sd: Dict[str, Any], cfg: ViTConfig,
                             dtype=np.float32):
    """timm-0.4.12 ViT state dict (+ ``CP_*``) -> (params, cara_params or
    None, info); ``info`` is ``{"cp_order", "rank"}`` with an adapter
    (the scale and lambda init are not in a ``.pt``: they come from the
    task table, as in the reference's ``--evaluate``)."""
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    e, depth, p, c = cfg.embed_dim, cfg.depth, cfg.patch_size, cfg.in_chans

    def arr(key):
        return _get(sd, key).astype(dtype)

    def lin_t(key):  # torch (out, in) -> (in, out)
        return np.ascontiguousarray(_get(sd, key).T).astype(dtype)

    emb_w = _get(sd, "patch_embed.proj.weight")
    if emb_w.shape != (e, c, p, p):
        raise ValueError(
            f"patch_embed.proj.weight shape {emb_w.shape} does not match "
            f"config (want ({e}, {c}, {p}, {p}))")
    params: Dict[str, Any] = {
        "embed": {"kernel": np.ascontiguousarray(emb_w.transpose(
                      2, 3, 1, 0).reshape(p * p * c, e)).astype(dtype),
                  "bias": arr("patch_embed.proj.bias")},
        "cls": arr("cls_token"),
        "pos_embed": arr("pos_embed"),
        "norm": {"scale": arr("norm.weight"), "bias": arr("norm.bias")},
    }
    names = {"ln1_scale": "norm1.weight", "ln1_bias": "norm1.bias",
             "ln2_scale": "norm2.weight", "ln2_bias": "norm2.bias"}
    linears = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
               "fc2": "mlp.fc2"}
    blocks: Dict[str, Any] = {
        ours: np.stack([arr(f"blocks.{i}.{theirs}") for i in range(depth)])
        for ours, theirs in names.items()}
    for ours, theirs in linears.items():
        kernels = [lin_t(f"blocks.{i}.{theirs}.weight") for i in range(depth)]
        if ours == "qkv" and kernels[0].shape != (e, 3 * e):
            raise ValueError(f"blocks.0.attn.qkv.weight.T shape "
                             f"{kernels[0].shape}, want ({e}, {3 * e})")
        blocks[ours] = {"kernel": np.stack(kernels),
                        "bias": np.stack([arr(f"blocks.{i}.{theirs}.bias")
                                          for i in range(depth)])}
    params["blocks"] = blocks
    if "pre_logits.fc.weight" in sd and cfg.repr_size is not None:
        params["pre_logits"] = {"kernel": lin_t("pre_logits.fc.weight"),
                                "bias": arr("pre_logits.fc.bias")}
    if "head.weight" in sd:
        params["head"] = {"kernel": lin_t("head.weight"),
                          "bias": arr("head.bias")}
    layout = infer_cara_layout(sd)
    if layout is None:
        return params, None, {}
    order, rank = layout
    cara = {n: arr("CP_" + n) for n in FACTOR_NAMES[order] + SHARED_NAMES}
    return params, cara, {"cp_order": order, "rank": rank}


def load_torch_checkpoint(path: str, cfg: ViTConfig, dtype=np.float32):
    """A reference ``.pt`` (``torch.load(..., weights_only=True)``; a
    trainer's ``{"state_dict": ...}`` wrapper is unwrapped) -> (params,
    cara_params, info)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return convert_torch_state_dict(sd, cfg, dtype)


def is_torch_checkpoint(path: str) -> bool:
    return path.endswith(TORCH_SUFFIXES)
