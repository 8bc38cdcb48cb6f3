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

from typing import Dict, Optional, Tuple

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
           model: ViTConfig, cara: CaraConfig,
           comp_mask: Optional[torch.Tensor] = None):
    """Collapse the qkv CP factors into ``delta = (x @ U) @ V`` with
    U (E, r) and V (r, 3E), the V columns out-flat (3, H, Dh).
    ``comp_mask`` (r,) multiplies lambda (rank weight dropout).  Every
    leaf may carry leading axes (the experts' stack of ``models/moe.py``,
    JAX's ``vmap`` of this function): U (..., E, r), V (..., r, 3E)."""
    e, r = model.embed_dim, cara.rank
    order = cara.cp_order
    lead = f1.shape[:-2]

    def flat_t(m):  # (..., 3, a, b, r) -> (..., r, 3E)
        return m.reshape(*lead, 3 * e, r).transpose(-1, -2)

    if order == 4:
        lam = params["R1"] if comp_mask is None else params["R1"] * comp_mask
        m = ((f1 * lam[..., None, :])[..., :, None, None, :]
             * params["A3"][..., None, :, None, :]
             * params["A4"][..., None, None, :, :])
        return params["A2"], flat_t(m)
    if order == 5:
        lam = params["R1"] * f1[..., 0, :]
        if comp_mask is not None:
            lam = lam * comp_mask
        m = ((params["A2"] * lam[..., None, :])[..., :, None, None, :]
             * params["A4"][..., None, :, None, :]
             * params["A5"][..., None, None, :, :])
        return params["A3"], flat_t(m)
    if order == 3:
        lam = params["R1"] if comp_mask is None else params["R1"] * comp_mask
        m = ((f1 * lam[..., None, :])[..., :, None, :]
             * params["A3"][..., None, :, :])
        return params["A2"], flat_t(m)
    raise ValueError(f"qkv_uv unsupported for cp_order={order}")


def rows_out_uv(p1, p2, p3, r2, comp_mask=None):
    """(U, V) for the ``x @ T.T`` sites (projection, MLP up):
    U = p3 (E, r), V (r, rows*E); ``comp_mask`` multiplies lambda.
    Leading axes ride along, as in :func:`qkv_uv`."""
    lam = r2 if comp_mask is None else r2 * comp_mask
    *lead, rows, r = p1.shape
    e = p2.shape[-2]
    v = ((p1 * lam[..., None, :])[..., :, None, :]
         * p2[..., None, :, :]).reshape(*lead, rows * e, r)
    return p3, v.transpose(-1, -2)


def rows_in_uv(p1, p2, p3, r2, comp_mask=None):
    """(U, V) for the ``x @ T`` site (MLP down): U (rows*E, r), V (r, E);
    ``comp_mask`` multiplies lambda.  Leading axes ride along."""
    lam = r2 if comp_mask is None else r2 * comp_mask
    *lead, rows, r = p1.shape
    e = p2.shape[-2]
    u = (p1[..., :, None, :] * p2[..., None, :, :]).reshape(
        *lead, rows * e, r)
    return u, lam[..., :, None] * p3.transpose(-1, -2)


def qkv_delta(x: torch.Tensor, params: Dict[str, torch.Tensor],
              f1: torch.Tensor, model: ViTConfig, cara: CaraConfig, *,
              materialized: bool, drop_mask: Optional[torch.Tensor] = None,
              comp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-layer qkv delta of the XLA block forms (``cara_tpu``'s
    ``qkv_delta``), orders 2-5: ``x`` (B, N, E) the attention input
    (post-LN), ``f1`` this layer's A1 slice -> (B, N, 3, H, Dh),
    unscaled.  ``materialized`` builds the dense (3, E, H*Dh) tensor and
    multiplies it by ``drop_mask`` (the inverted element mask, or None);
    otherwise the rank-space chain with ``comp_mask`` (r,) on lambda.
    Order 2 always materializes (its contract mode is E*E, so the chain
    saves nothing; ``cara.py:283-292``) and takes ``drop_mask`` on every
    route.  The masks are drawn by the caller."""
    from cara_tpu_torch.ops import cp as cp_ops

    e, h, d = model.embed_dim, model.num_heads, model.head_dim
    b, n = x.shape[:2]
    order = cara.cp_order
    if order not in (2, 3, 4, 5):
        raise ValueError(f"cp_order must be in {{2,3,4,5}}, got {order}")
    if order == 2:
        t = cp_ops.cp_to_tensor(params["R1"], (f1, params["A2"]))
        t = t.reshape(3, e, e)
        if drop_mask is not None:
            t = t * drop_mask
        return torch.einsum("bne,keo->bnko", x, t).reshape(b, n, 3, h, d)
    if materialized:
        if order == 5:
            t = cp_ops.cp_to_tensor(
                params["R1"],
                (f1, params["A2"], params["A3"], params["A4"], params["A5"]),
            )[0].reshape(3, e, h * d)
        elif order == 4:
            t = cp_ops.cp_to_tensor(
                params["R1"], (f1, params["A2"], params["A3"], params["A4"])
            ).reshape(3, e, h * d)
        else:  # (3, E, E), contract the A2 mode
            t = cp_ops.cp_to_tensor(params["R1"],
                                    (f1, params["A2"], params["A3"]))
        if drop_mask is not None:
            t = t * drop_mask
        return torch.einsum("bne,keo->bnko", x, t).reshape(b, n, 3, h, d)
    if order == 4:
        return cp_ops.qkv_delta_factorized(
            x, f1, params["A2"], params["A3"], params["A4"], params["R1"],
            comp_mask)
    u, v = qkv_uv(params, f1, model, cara, comp_mask)
    return ((x @ u) @ v).reshape(b, n, 3, h, d)
