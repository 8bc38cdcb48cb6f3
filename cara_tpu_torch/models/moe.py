"""Mixture-of-expert CaRA adapters with per-token routing (port of
``cara_tpu/models/moe.py``).

``X = cara_cfg.moe_experts`` independent CaRA adapters (every factor of
``models/cara.py`` with a leading expert axis) and one linear router on
the post-stem tokens.  Each token's delta at the four adapter sites (qkv,
attention projection, MLP up, MLP down) is the gate-weighted sum of its
top-k experts' deltas:

    delta(x_t) = sum_x  g_x(t) * delta_x(x_t),     g sparse over top-k

The deltas are computed densely over the expert axis and masked by the
renormalized top-k gates: each expert collapses to its (U, V) pair
(``cara.qkv_uv`` / ``rows_out_uv`` / ``rows_in_uv`` on the stacked
factors, the counterpart of JAX's ``vmap``), then two ``einsum`` s a site
contract the rank and expert modes, the second one carrying the gates,
so an unselected expert contributes exactly zero and the expert axis
costs no Python loop.  The blocks run the XLA dense forms (the fused
site kernels have no expert axis; ``vit.resolve_impls`` pins them) and
the fused attention.

Restrictions as in JAX (:func:`validate_moe`): the factorized delta, CP
order 3, 4 or 5, and in training the rank weight dropout (or rate 0),
whose (X, r) masks, one a site, the caller draws and passes in.  Expert
parallelism (a mesh's expert axis) is not ported (ROADMAP.md queue 1:
parallelism).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cara_tpu_torch.config import CaraConfig, ViTConfig
from cara_tpu_torch.models import cara as cara_lib

Tree = Dict[str, Any]


def validate_moe(cara_cfg: CaraConfig, train: bool = False) -> None:
    """Reject configurations the MoE path does not define."""
    if cara_cfg.moe_top_k < 1 or cara_cfg.moe_top_k > cara_cfg.moe_experts:
        raise ValueError(
            f"moe_top_k={cara_cfg.moe_top_k} must be in "
            f"[1, moe_experts={cara_cfg.moe_experts}]")
    if cara_cfg.delta_impl != "factorized":
        raise ValueError("MoE adapters require delta_impl='factorized' "
                         "(the dense-materialized path has no expert axis)")
    if cara_cfg.cp_order == 2:
        raise ValueError("MoE adapters require cp_order in {3,4,5} — order "
                         "2 has no rank-space contraction to gate")
    if (train and cara_cfg.weight_dropout > 0.0
            and cara_cfg.weight_dropout_impl != "rank"):
        raise ValueError(
            "MoE training with weight_dropout > 0 requires "
            "weight_dropout_impl='rank' — element-wise masks are a "
            "single-adapter Pallas-kernel semantics")


def init_moe_params(model: ViTConfig, cara: CaraConfig, seed: int) -> Tree:
    """{"experts": the stacked CaRA tree (leading axis X), "router":
    {kernel (E, X), bias (X,)}} as numpy fp32.  Each expert is an
    independent draw of the reference init (``convert.init_cara_params``:
    zero contract modes, so every expert's delta is 0 at step 0); the
    router's kernel is trunc-normal(0.02), its bias zero.  The X + 1
    streams are children of ``numpy.random.SeedSequence(seed)``."""
    from cara_tpu_torch.models.convert import _trunc_normal, init_cara_params

    validate_moe(cara)
    x = cara.moe_experts
    k_router, *keys = np.random.SeedSequence(seed).spawn(x + 1)
    single = dataclasses.replace(cara, moe_experts=0)
    experts = [init_cara_params(model, single,
                                int(k.generate_state(1)[0]))
               for k in keys]
    stacked = {name: np.stack([e[name] for e in experts])
               for name in experts[0]}
    router = {"kernel": _trunc_normal(np.random.default_rng(k_router),
                                      (model.embed_dim, x), 0.02),
              "bias": np.zeros((x,), np.float32)}
    return {"experts": stacked, "router": router}


def is_moe_params(cara_params) -> bool:
    return (isinstance(cara_params, dict) and "experts" in cara_params
            and "router" in cara_params)


def route(tokens: torch.Tensor, router: Dict[str, torch.Tensor],
          top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token top-k routing -> (gates (B, N, X) in ``tokens.dtype``,
    aux, a 0-d fp32 tensor).

    The router runs in fp32; the gates are the softmax probabilities of
    the selected experts renormalized over the top-k set, zero elsewhere.
    The selection is ``jax.lax.top_k``'s: on equal probabilities the lower
    expert index first (a stable descending sort; ``torch.topk`` promises
    no order on ties).  ``aux`` is the Switch-Transformer load-balance
    loss ``X * sum_x f_x * P_x`` (f: the fraction of assignment slots
    routed to expert x, P: its mean probability, both over every (B, N)
    token): 1.0 for uniform routing."""
    x = router["kernel"].shape[-1]
    logits = (tokens.float() @ router["kernel"].float()
              + router["bias"].float())
    probs = torch.softmax(logits, dim=-1)                     # (B, N, X)
    top_v, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[..., :top_k], top_i[..., :top_k]
    top_v = top_v / top_v.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(top_i, x).float()   # (B, N, k, X)
    gates = (top_v[..., None] * onehot).sum(dim=-2)
    f = onehot.sum(dim=-2).mean(dim=(0, 1)) / top_k
    p = probs.mean(dim=(0, 1))
    aux = x * (f * p).sum()
    return gates.to(tokens.dtype), aux


def moe_stacked_layer_slices(experts: Dict[str, torch.Tensor],
                             model: ViTConfig, cara: CaraConfig):
    """The expert-stacked per-layer factor slices: a1 (L, X, qkv_rows, r)
    and p1 (L, X, 1 + 2 * mlp_ratio, r), the layer axis first."""
    x, r = experts["R1"].shape
    a1 = experts["A1"].reshape(x, model.depth,
                               cara_lib.qkv_rows_per_layer(cara.cp_order), r)
    p1 = experts["P1"].reshape(x, model.depth, 1 + 2 * model.mlp_ratio, r)
    return a1.transpose(0, 1), p1.transpose(0, 1)


def _gated(x, u, v, gates, spec_in: str) -> torch.Tensor:
    """``sum_x g_x (x @ U_x) @ V_x``: U (X, K, r), V (X, r, O)."""
    z = torch.einsum(spec_in, x, u.to(x.dtype))
    return torch.einsum("bnxr,xro->bno", z * gates[..., None],
                        v.to(x.dtype))


def moe_qkv_delta(x: torch.Tensor, experts: Dict[str, torch.Tensor],
                  f1x: torch.Tensor, gates: torch.Tensor, model: ViTConfig,
                  cara: CaraConfig,
                  comp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gate-weighted qkv delta: (B, N, E) -> (B, N, 3, H, Dh), unscaled.
    ``f1x``: this layer's expert-stacked A1 slice (X, qkv_rows, r);
    ``comp``: the (X, r) rank masks, or None."""
    b, n = x.shape[:2]
    u, v = cara_lib.qkv_uv(experts, f1x, model, cara, comp)
    delta = _gated(x, u, v, gates, "bne,xer->bnxr")
    return delta.reshape(b, n, 3, model.num_heads, model.head_dim)


def moe_rows_delta_out(x: torch.Tensor, p1x: torch.Tensor,
                       experts: Dict[str, torch.Tensor], gates: torch.Tensor,
                       comp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gate-weighted ``x @ T.T`` delta (attention projection, MLP up):
    ``p1x`` this layer's (X, rows, r) P1 rows -> (B, N, rows * E)."""
    u, v = cara_lib.rows_out_uv(p1x, experts["P2"], experts["P3"],
                                experts["R2"], comp)
    return _gated(x, u, v, gates, "bne,xer->bnxr")


def moe_rows_delta_in(x: torch.Tensor, p1x: torch.Tensor,
                      experts: Dict[str, torch.Tensor], gates: torch.Tensor,
                      comp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gate-weighted ``x @ T`` delta (MLP down): (B, N, rows * E) ->
    (B, N, E)."""
    u, v = cara_lib.rows_in_uv(p1x, experts["P2"], experts["P3"],
                               experts["R2"], comp)
    return _gated(x, u, v, gates, "bnh,xhr->bnxr")


def moe_bias(gates: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Gate-weighted additive expert bias: (B, N, X) x (X, D) -> (B, N, D)."""
    return torch.einsum("bnx,xd->bnd", gates, bias.to(gates.dtype))
