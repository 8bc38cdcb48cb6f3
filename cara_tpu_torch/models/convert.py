"""Parameter trees: numpy <-> torch, and seeded numpy initializers.

The port keeps the JAX package's tree layout (``cara_tpu/models/vit.py``
``init_vit_params``): NHWC patch embedding flattened (ph, pw, c), linear
kernels (in, out), blocks stacked on a leading layer axis, the qkv output
axis out-flat (3, H, Dh).  ``params_from_numpy`` therefore turns a tree
that either package's ``load_model`` returns into the port's tensors with
no relayout, so both packages compute the same thing from one file.

Random numbers come from ``numpy.random.default_rng(seed)``; the same seed
gives the same tree on every host.  (The JAX package draws from
``jax.random``, so its seeded trees differ; tests hand one numpy tree to
both packages instead.)
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from cara_tpu_torch.config import (BOTTLENECK_METHODS, FACT_METHODS,
                                   VPT_METHODS, CaraConfig, ViTConfig)
from cara_tpu_torch.models.cara import cara_param_shapes

Tree = Dict[str, Any]


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """Nested dict of array-likes -> the same dict of tensors on
    ``device``: a backbone, or any method's adapter tree (CaRA's flat
    factors, the nested per-site or per-layer trees of the others).

    Floating leaves are cast to ``dtype`` (kept as stored when None);
    integer leaves keep their type; ``None`` leaves stay ``None``.
    Tensors pass through (moved and cast)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if tree is None:
        return None
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(tree)))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def map_floating(tree, fn):
    """Apply ``fn`` to every floating tensor leaf."""
    if isinstance(tree, dict):
        return {k: map_floating(v, fn) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return fn(tree)
    return tree


def _trunc_normal(rng, shape, std):
    """``std * truncated_normal(-2, 2)`` by resampling the tails."""
    x = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) > 2.0
    return (x * std).astype(np.float32)


def init_vit_params(cfg: ViTConfig, seed: int) -> Tree:
    """Random backbone (numpy fp32) with the JAX package's tree layout."""
    rng = np.random.default_rng(seed)
    e, hid, n_layers = cfg.embed_dim, cfg.hidden_dim, cfg.depth
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.in_chans

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def lin(i, o):
        return {"kernel": _trunc_normal(rng, (i, o), 0.02), "bias": zeros(o)}

    def stacked(i, o):
        return {"kernel": _trunc_normal(rng, (n_layers, i, o), 0.02),
                "bias": zeros(n_layers, o)}

    params: Tree = {
        "embed": lin(patch_dim, e),
        "cls": (_trunc_normal(rng, (1, 1, e), 0.02)
                if cfg.use_cls_token else None),
        "pos_embed": _trunc_normal(rng, (1, cfg.seq_len, e), 0.02),
        "blocks": {
            "ln1_scale": ones(n_layers, e), "ln1_bias": zeros(n_layers, e),
            "qkv": stacked(e, 3 * e),
            "proj": stacked(e, e),
            "ln2_scale": ones(n_layers, e), "ln2_bias": zeros(n_layers, e),
            "fc1": stacked(e, hid),
            "fc2": stacked(hid, e),
        },
        "norm": {"scale": ones(e), "bias": zeros(e)},
    }
    if cfg.ln_pre:
        params["ln_pre"] = {"scale": ones(e), "bias": zeros(e)}
    if cfg.repr_size is not None:
        params["pre_logits"] = lin(e, cfg.repr_size)
    if cfg.proj_dim is not None:
        params["proj_out"] = {
            "kernel": _trunc_normal(rng, (e, cfg.proj_dim), e ** -0.5)}
    if cfg.num_classes > 0:
        head_in = cfg.proj_dim or cfg.repr_size or e
        bound = 1.0 / math.sqrt(head_in)
        params["head"] = {
            "kernel": rng.uniform(-bound, bound, (head_in, cfg.num_classes)
                                  ).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (cfg.num_classes,)
                                ).astype(np.float32)}
    return params


_QKV_INITS = {
    5: {"A1": "xavier", "A2": "orthogonal", "A3": "zeros", "A4": "orthogonal",
        "A5": "orthogonal"},
    4: {"A1": "xavier", "A2": "zeros", "A3": "orthogonal", "A4": "orthogonal"},
    3: {"A1": "xavier", "A2": "zeros", "A3": "orthogonal"},
    2: {"A1": "xavier", "A2": "zeros"},
}


def _orthogonal(rng, shape):
    """Semi-orthogonal matrix via QR (``nn.init.orthogonal_``)."""
    rows, cols = shape
    a = rng.standard_normal((max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))[None, :]
    if rows < cols:
        q = q.T
    return q[:rows, :cols].astype(np.float32)


def init_cara_params(cfg: ViTConfig, cara_cfg: CaraConfig,
                     seed: int) -> Tree:
    """Adapter tree (numpy fp32) of ``cara_cfg.method``
    (``cara_tpu/models/cara.py:110-158``): LoRA's per-site A / B tree
    (``models/lora.py``), FacT's shared factors (``models/fact.py``), VPT's
    prompts, SSF's (gamma, beta) pairs, BitFit's bias deltas, the
    bottleneck adapters' down / up pairs (``models/vpt.py``, ``ssf.py``,
    ``bitfit.py``, ``adapter.py``), or CaRA's factors with the reference's
    init scheme: xavier A1/P1, orthogonal mode factors, zero contract-mode
    factors (A2 at order 4, P2) and biases; with ``cara_cfg.moe`` the
    {"experts", "router"} tree of ``models/moe.py``.  The delta is
    exactly 0 but for VPT's prompts and SSF's near-identity draw."""
    method = cara_cfg.method
    if cara_cfg.moe:
        from cara_tpu_torch.models.moe import init_moe_params

        return init_moe_params(cfg, cara_cfg, seed)
    if method in VPT_METHODS:
        from cara_tpu_torch.models.vpt import init_vpt_params

        return init_vpt_params(cfg, cara_cfg, seed)
    if method == "ssf":
        from cara_tpu_torch.models.ssf import init_ssf_params

        return init_ssf_params(cfg, seed)
    if method == "bitfit":
        from cara_tpu_torch.models.bitfit import init_bitfit_params

        return init_bitfit_params(cfg)
    if method in BOTTLENECK_METHODS:
        from cara_tpu_torch.models.adapter import init_adapter_params

        return init_adapter_params(cfg, cara_cfg, seed)
    if cara_cfg.method == "lora":
        from cara_tpu_torch.models.lora import init_lora_params

        return init_lora_params(cfg, cara_cfg, seed)
    if cara_cfg.method in FACT_METHODS:
        from cara_tpu_torch.models.fact import init_fact_params

        return init_fact_params(cfg, cara_cfg, seed)
    if cara_cfg.method != "cara":
        raise NotImplementedError(
            f"method={cara_cfg.method!r} is not yet ported "
            "(ROADMAP.md queue 1: the PEFT zoo)")
    rng = np.random.default_rng(seed)
    inits = dict(_QKV_INITS[cara_cfg.cp_order])
    inits.update(P1="xavier", P2="zeros", P3="orthogonal")
    out: Tree = {}
    for name, shape in cara_param_shapes(cfg, cara_cfg).items():
        if name in ("R1", "R2"):
            if cara_cfg.l_std != 0.0:
                out[name] = (cara_cfg.l_mu + cara_cfg.l_std
                             * rng.standard_normal(shape)).astype(np.float32)
            else:
                out[name] = np.full(shape, cara_cfg.l_mu, np.float32)
        elif name.startswith("bias") or inits[name] == "zeros":
            out[name] = np.zeros(shape, np.float32)
        elif inits[name] == "xavier":
            std = math.sqrt(2.0 / (shape[0] + shape[1]))
            out[name] = (std * rng.standard_normal(shape)).astype(np.float32)
        else:
            out[name] = _orthogonal(rng, shape)
    return out


def perturb_adapter(cara_params: Tree, seed: int, std: float = 0.02) -> Tree:
    """Fill the zero-initialized factors (CaRA's contract modes, LoRA's
    B, FacT's G / C, the bottleneck adapters' up kernels, BitFit's
    deltas) and the biases with seeded ``N(0, std)`` noise so
    the adapter's delta is nonzero (a freshly initialized adapter is the
    identity, which would hide a wrong delta path).  Nested trees are
    walked in key order.  Returns a new tree; other leaves are shared."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = dict(tree)
        for name, val in tree.items():
            if isinstance(val, dict):
                out[name] = walk(val)
                continue
            arr = np.asarray(val)
            if name.startswith("bias") or not arr.any():
                out[name] = (std * rng.standard_normal(arr.shape)).astype(
                    arr.dtype)
        return out

    return walk(cara_params)
