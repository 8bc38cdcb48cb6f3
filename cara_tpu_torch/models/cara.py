"""CaRA adapter parameters: shapes, per-layer slicing and the collapsed
(U, V) factor pairs the block kernels consume (port of
``cara_tpu/models/cara.py``).

Layout (order 4, the published method): ``A1`` has ``3*depth`` rows (row
``3l+k`` is layer l's q/k/v coordinate); ``P1`` has ``(1+2*mlp_ratio)``
rows per layer (1 projection row, ``mlp_ratio`` MLP-up rows, then
``mlp_ratio`` MLP-down rows).  The numpy initializers live in
``models/convert.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cara_tpu_torch.config import CaraConfig, ViTConfig


def qkv_factor_shapes(model: ViTConfig,
                      cara: CaraConfig) -> Dict[str, Tuple[int, ...]]:
    """QKV-tensorisation factor shapes per CP order."""
    l, e, h, d, r = (model.depth, model.embed_dim, model.num_heads,
                     model.head_dim, cara.rank)
    if cara.cp_order == 5:
        return {"A1": (l, r), "A2": (3, r), "A3": (e, r), "A4": (h, r),
                "A5": (d, r)}
    if cara.cp_order == 4:
        return {"A1": (3 * l, r), "A2": (e, r), "A3": (h, r), "A4": (d, r)}
    if cara.cp_order == 3:
        return {"A1": (3 * l, r), "A2": (e, r), "A3": (e, r)}
    if cara.cp_order == 2:
        return {"A1": (3 * l, r), "A2": (e * e, r)}
    raise ValueError(f"cp_order must be in {{2,3,4,5}}, got {cara.cp_order}")


def cara_param_shapes(model: ViTConfig,
                      cara: CaraConfig) -> Dict[str, Tuple[int, ...]]:
    """All trainable adapter shapes (generalized ``cara.py:112-125``)."""
    e, r = model.embed_dim, cara.rank
    rows = (1 + 2 * model.mlp_ratio) * model.depth
    shapes = dict(qkv_factor_shapes(model, cara))
    shapes.update(
        P1=(rows, r), P2=(e, r), P3=(e, r),
        R1=(r,), R2=(r,),
        bias1=(e,), bias2=(model.hidden_dim,), bias3=(e,),
    )
    return shapes


def qkv_rows_per_layer(cp_order: int) -> int:
    """``attn_idx`` stride: 1 for order 5, else 3."""
    return 1 if cp_order == 5 else 3


def stacked_layer_slices(params: Dict[str, torch.Tensor], model: ViTConfig,
                         cara: CaraConfig):
    """``(a1, p1)``: A1 as (depth, qkv_rows, r) and P1 as
    (depth, 1+2*mlp_ratio, r) — the per-layer row slices."""
    a1 = params["A1"].reshape(model.depth, qkv_rows_per_layer(cara.cp_order),
                              cara.rank)
    p1 = params["P1"].reshape(model.depth, 1 + 2 * model.mlp_ratio,
                              cara.rank)
    return a1, p1


def qkv_uv(params: Dict[str, torch.Tensor], f1: torch.Tensor,
           model: ViTConfig, cara: CaraConfig):
    """Collapse the qkv CP factors into ``delta = (x @ U) @ V`` with
    U (E, r) and V (r, 3E), the V columns out-flat (3, H, Dh)."""
    e, r = model.embed_dim, cara.rank
    order = cara.cp_order
    if order == 4:
        lam = params["R1"]
        m = ((f1 * lam[None, :])[:, None, None, :]
             * params["A3"][None, :, None, :]
             * params["A4"][None, None, :, :])
        return params["A2"], m.reshape(3 * e, r).T
    if order == 5:
        lam = params["R1"] * f1[0]
        m = ((params["A2"] * lam[None, :])[:, None, None, :]
             * params["A4"][None, :, None, :]
             * params["A5"][None, None, :, :])
        return params["A3"], m.reshape(3 * e, r).T
    if order == 3:
        m = (f1 * params["R1"][None, :])[:, None, :] * params["A3"][None]
        return params["A2"], m.reshape(3 * e, r).T
    raise ValueError(f"qkv_uv unsupported for cp_order={order}")


def rows_out_uv(p1, p2, p3, r2):
    """(U, V) for the ``x @ T.T`` sites (projection, MLP up):
    U = p3 (E, r), V (r, rows*E)."""
    rows, r = p1.shape
    e = p2.shape[0]
    v = ((p1 * r2[None, :])[:, None, :] * p2[None, :, :]).reshape(
        rows * e, r).T
    return p3, v


def rows_in_uv(p1, p2, p3, r2):
    """(U, V) for the ``x @ T`` site (MLP down): U (rows*E, r), V (r, E)."""
    rows, r = p1.shape
    e = p2.shape[0]
    u = (p1[:, None, :] * p2[None, :, :]).reshape(rows * e, r)
    return u, r2[:, None] * p3.T
