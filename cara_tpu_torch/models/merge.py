"""Merged-weight serving: fold the adapter deltas into the dense backbone
(port of ``cara_tpu/models/merge.py``: CaRA, LoRA, FacT, SSF and BitFit
trees; VPT and the bottleneck adapters cannot fold and raise).

In eval the delta is exactly linear, so per layer, for CaRA:
``qkv += s*T_qkv``, ``proj += s*T_proj.T`` (+ ``s*bias1``),
``fc1 += s*T_up.T`` (+ ``s*bias2``), ``fc2 += s*T_down`` (+ ``s*bias3``);
for LoRA ``W_site += s * A @ B`` (``lora.merge_lora``), and FacT expands
to LoRA first (``fact.merge_fact``).  SSF folds into the adjacent linear
and LayerNorm weights (``ssf.merge_ssf``), BitFit adds its bias deltas
(``bitfit.merge_bitfit``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from cara_tpu_torch.config import (BOTTLENECK_METHODS, FACT_METHODS,
                                   VPT_METHODS, CaraConfig, ViTConfig)
from cara_tpu_torch.models import adapter as adapter_lib
from cara_tpu_torch.models import bitfit as bitfit_lib
from cara_tpu_torch.models import cara as cara_lib
from cara_tpu_torch.models import fact as fact_lib
from cara_tpu_torch.models import lora as lora_lib
from cara_tpu_torch.models import ssf as ssf_lib
from cara_tpu_torch.models import vpt as vpt_lib
from cara_tpu_torch.ops import cp as cp_ops


def _qkv_tensor(params, f1, model: ViTConfig, cara: CaraConfig):
    """Dense per-layer qkv delta (3, E, E_out), out flat (H, Dh)."""
    e = model.embed_dim
    order = cara.cp_order
    if order == 5:
        t = cp_ops.cp_to_tensor(
            params["R1"],
            (f1, params["A2"], params["A3"], params["A4"], params["A5"]))[0]
        return t.reshape(3, e, e)
    if order == 4:
        t = cp_ops.cp_to_tensor(
            params["R1"], (f1, params["A2"], params["A3"], params["A4"]))
        return t.reshape(3, e, e)
    if order == 3:
        return cp_ops.cp_to_tensor(
            params["R1"], (f1, params["A2"], params["A3"]))
    t = cp_ops.cp_to_tensor(params["R1"], (f1, params["A2"]))
    return t.reshape(3, e, e)


def merge_cara(params: Dict[str, Any], cara_params: Dict[str, Any],
               model: ViTConfig, cara: CaraConfig) -> Dict[str, Any]:
    """Return a new backbone tree with the adapter folded in, dispatched
    on the family as JAX's (``merge.py:56-92``): VPT and bottleneck trees
    raise JAX's ``ValueError``s; SSF and BitFit trees fold through
    ``ssf.merge_ssf`` / ``bitfit.merge_bitfit``, FacT trees (the method or
    the U/V factor shape) through ``fact.merge_fact``, LoRA trees through
    ``lora.merge_lora``, CaRA's here.  The fold runs in the backbone's
    dtype on its device."""
    if cara.method in VPT_METHODS or vpt_lib.is_vpt_params(cara_params):
        raise ValueError(
            "VPT is architectural (learnable prompt tokens, not a weight "
            "delta) and cannot fold into dense weights — serve the "
            "adapter path (Predictor(merge=False) does this automatically "
            "for prompt trees)")
    if (cara.method in BOTTLENECK_METHODS
            or adapter_lib.is_adapter_params(cara_params)):
        raise ValueError(
            "bottleneck adapters are nonlinear (gelu/relu between the "
            "down/up projections) and cannot fold into dense weights — "
            "serve the adapter path (Predictor(merge=False) does this "
            "automatically for bottleneck trees)")
    if cara.method == "ssf" or ssf_lib.is_ssf_params(cara_params):
        return ssf_lib.merge_ssf(params, cara_params, model, cara)
    if cara.method == "bitfit" or bitfit_lib.is_bitfit_params(cara_params):
        return bitfit_lib.merge_bitfit(params, cara_params, model, cara)
    if cara.method in FACT_METHODS or fact_lib.is_fact_params(cara_params):
        return fact_lib.merge_fact(params, cara_params, model, cara)
    if cara.method == "lora" or lora_lib.is_lora_params(cara_params):
        return lora_lib.merge_lora(params, cara_params, model, cara)
    if cara.moe or ("experts" in cara_params and "router" in cara_params):
        raise ValueError(
            "MoE adapters cannot be merged into the dense backbone — the "
            "delta is input-dependent (per-token routing); serve them "
            "unmerged (adapter checkpoints work in eval/serving as-is)")
    if cara.method != "cara" or "A1" not in cara_params:
        raise NotImplementedError(
            f"merge for method={cara.method!r} is not yet ported to "
            "cara_tpu_torch (ROADMAP.md queue 1: the PEFT zoo)")
    e, mr, n_layers = model.embed_dim, model.mlp_ratio, model.depth
    s = cara.scale
    a1, p1 = cara_lib.stacked_layer_slices(cara_params, model, cara)
    p2, p3, r2 = cara_params["P2"], cara_params["P3"], cara_params["R2"]
    qkv_d, proj_d, fc1_d, fc2_d = [], [], [], []
    for layer in range(n_layers):
        t_qkv = _qkv_tensor(cara_params, a1[layer], model, cara)
        qkv_d.append(t_qkv.permute(1, 0, 2).reshape(e, 3 * e))
        t_proj = cp_ops.cp_to_tensor(r2, (p1[layer, 0:1], p2, p3))
        proj_d.append(t_proj.reshape(e, e).T)
        t_up = cp_ops.cp_to_tensor(r2, (p1[layer, 1:1 + mr], p2, p3))
        fc1_d.append(t_up.reshape(mr * e, e).T)
        t_down = cp_ops.cp_to_tensor(
            r2, (p1[layer, 1 + mr:1 + 2 * mr], p2, p3))
        fc2_d.append(t_down.reshape(mr * e, e))

    blocks = dict(params["blocks"])
    dt = blocks["qkv"]["kernel"].dtype

    def fold(site, deltas, cb=None):
        out = {"kernel": blocks[site]["kernel"]
               + s * torch.stack(deltas).to(dt),
               "bias": blocks[site]["bias"]}
        if cb is not None:
            out["bias"] = out["bias"] + s * cb.to(dt).expand_as(out["bias"])
        blocks[site] = out

    fold("qkv", qkv_d)
    fold("proj", proj_d, cara_params["bias1"])
    fold("fc1", fc1_d, cara_params["bias2"])
    fold("fc2", fc2_d, cara_params["bias3"])
    out = dict(params)
    out["blocks"] = blocks
    return out
