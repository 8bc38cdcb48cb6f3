"""FacT adapters: tensor-train / Tucker factor tuning at the CaRA sites
(port of ``cara_tpu/models/fact.py``).

Every adapted weight increment is a stack of (E, E) blocks: q, k, v and
the projection one each, fc1 ``hidden / E`` blocks along its output axis
and fc2 as many along its input axis, ``S = 4 + 2 * hidden / E`` blocks a
layer.  With U, V (E, r) shared by every block:

    FacT-TT:  dW_m = U @ G_m @ V^T            G (L, S, r, r)
    FacT-TK:  dW_m = U @ (sum_p P_mp C_p) @ V^T
                                              P (L, S, rl), C (rl, r, r)

:func:`expand_to_lora` collapses the shared factors into the per-site
layer-stacked LoRA tree (:mod:`cara_tpu_torch.models.lora`) with a few
rank-space einsums, under autograd, so ``vit_forward`` runs FacT as LoRA
through the same site kernels and the gradients reach U, V, G / P, C.

Init (numpy, seeded): U, V kaiming-uniform over E, the middle factor zero
(TT ``G = 0``; TK ``C = 0`` with ``P`` xavier-normal), so the delta is
exactly zero at step 0.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cara_tpu_torch.config import CaraConfig, ViTConfig
from cara_tpu_torch.models import lora as lora_lib

TT_KEYS = frozenset({"U", "V", "G"})
TK_KEYS = frozenset({"U", "V", "P", "C"})


def _geometry(model: ViTConfig) -> Tuple[int, int, int]:
    """(fc blocks per MLP matrix, blocks per layer S, embed dim E)."""
    e, hid = model.embed_dim, model.hidden_dim
    if hid % e != 0:
        raise ValueError(
            f"FacT tensorises weights as (E, E) blocks; hidden_dim={hid} "
            f"is not a multiple of embed_dim={e}")
    n_fc = hid // e
    return n_fc, 4 + 2 * n_fc, e


def core_rank(cara: CaraConfig) -> int:
    """Tucker block-mode rank ``rl`` (0 in the config means ``rank``)."""
    return cara.fact_core_rank or cara.rank


def fact_param_shapes(model: ViTConfig,
                      cara: CaraConfig) -> Dict[str, Tuple[int, ...]]:
    """Factor shapes for ``cara.method`` "fact_tt" or "fact_tk"."""
    _, s, e = _geometry(model)
    n_layers, r = model.depth, cara.rank
    shapes: Dict[str, Tuple[int, ...]] = {"U": (e, r), "V": (e, r)}
    if cara.method == "fact_tt":
        shapes["G"] = (n_layers, s, r, r)
    else:
        rl = core_rank(cara)
        shapes["P"] = (n_layers, s, rl)
        shapes["C"] = (rl, r, r)
    return shapes


def init_fact_params(model: ViTConfig, cara: CaraConfig,
                     seed: int) -> Dict[str, np.ndarray]:
    """numpy fp32 tree: U, V kaiming-uniform, the middle factor zero."""
    shapes = fact_param_shapes(model, cara)
    rng = np.random.default_rng(seed)
    bound = 1.0 / math.sqrt(model.embed_dim)
    out = {k: rng.uniform(-bound, bound, shapes[k]).astype(np.float32)
           for k in ("U", "V")}
    if "G" in shapes:
        out["G"] = np.zeros(shapes["G"], np.float32)
    else:
        # xavier-normal over the (S * L, rl) routing matrix
        p_shape = shapes["P"]
        fan = p_shape[1] * p_shape[2] + p_shape[0] * p_shape[2]
        std = math.sqrt(2.0 / float(fan))
        out["P"] = (std * rng.standard_normal(p_shape)).astype(np.float32)
        out["C"] = np.zeros(shapes["C"], np.float32)
    return out


def is_fact_params(tree) -> bool:
    return isinstance(tree, dict) and set(tree) in (TT_KEYS, TK_KEYS)


def detect_method(tree) -> Optional[str]:
    """"fact_tt" / "fact_tk" for a FacT factor tree, else None."""
    if not isinstance(tree, dict):
        return None
    keys = set(tree)
    if keys == TT_KEYS:
        return "fact_tt"
    if keys == TK_KEYS:
        return "fact_tk"
    return None


def block_cores(fact_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The per-block middle factor (L, S, r, r): TT's ``G``, or Tucker's
    routing matrix contracted with the shared core stack."""
    if "G" in fact_params:
        return fact_params["G"]
    return torch.einsum("lsp,pab->lsab", fact_params["P"], fact_params["C"])


def expand_to_lora(fact_params: Dict[str, torch.Tensor], model: ViTConfig,
                   cara: CaraConfig) -> Dict[str, Dict[str, torch.Tensor]]:
    """The per-site layer-stacked LoRA tree of the shared factors.

    Per block ``dW = U G V^T``, so qkv, proj and fc1 (blocks along the
    output axis) get ``a = U`` broadcast over the layers and ``b =
    concat_m(G_m V^T)``, qkv's three blocks in the fused-qkv column order
    (q, then k, then v); fc2 (blocks along the input axis) gets ``a =
    vstack_m(U G_m)`` and ``b = V^T`` broadcast.  Block order in a layer:
    q, k, v, proj, fc1 x n, fc2 x n."""
    n_fc, s, e = _geometry(model)
    n_layers, r = model.depth, cara.rank
    u, v = fact_params["U"], fact_params["V"]
    g = block_cores(fact_params)
    if tuple(g.shape) != (n_layers, s, r, r):
        raise ValueError(
            f"FacT core stack has shape {tuple(g.shape)}; model/config "
            f"geometry wants {(n_layers, s, r, r)}: was the tree trained "
            "with a different model or rank?")
    g_qkv, g_proj = g[:, 0:3], g[:, 3]
    g_fc1, g_fc2 = g[:, 4:4 + n_fc], g[:, 4 + n_fc:]
    a_bcast = u.expand(n_layers, e, r)
    b_qkv = torch.einsum("lkab,jb->lakj", g_qkv, v).reshape(
        n_layers, r, 3 * e)
    b_proj = torch.einsum("lab,jb->laj", g_proj, v)
    b_fc1 = torch.einsum("lnab,jb->lanj", g_fc1, v).reshape(
        n_layers, r, n_fc * e)
    a_fc2 = torch.einsum("ia,lnab->lnib", u, g_fc2).reshape(
        n_layers, n_fc * e, r)
    b_fc2 = v.T.expand(n_layers, r, e)
    return {"qkv": {"a": a_bcast, "b": b_qkv},
            "proj": {"a": a_bcast, "b": b_proj},
            "fc1": {"a": a_bcast, "b": b_fc1},
            "fc2": {"a": a_fc2, "b": b_fc2}}


def merge_fact(params, fact_params, model: ViTConfig, cara: CaraConfig):
    """Fold the eval-mode FacT deltas into the dense backbone: the
    expansion, then :func:`~cara_tpu_torch.models.lora.merge_lora`."""
    return lora_lib.merge_lora(params, expand_to_lora(fact_params, model,
                                                      cara), model, cara)
