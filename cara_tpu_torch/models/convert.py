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

from cara_tpu_torch.config import CaraConfig, ViTConfig
from cara_tpu_torch.models.cara import cara_param_shapes

Tree = Dict[str, Any]


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """Nested dict of array-likes -> the same dict of tensors on ``device``.

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
    """CaRA factor tree (numpy fp32) with the reference's init scheme:
    xavier A1/P1, orthogonal mode factors, zero contract-mode factors
    (A2 at order 4, P2) and biases, so the delta is exactly 0."""
    if cara_cfg.method != "cara":
        raise NotImplementedError(
            f"method={cara_cfg.method!r} is not yet ported")
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
    """Fill the zero-initialized factors and the biases with seeded
    ``N(0, std)`` noise so the adapter's delta is nonzero (a freshly
    initialized adapter is the identity, which would hide a wrong delta
    path).  Returns a new tree; other leaves are shared."""
    rng = np.random.default_rng(seed)
    out = dict(cara_params)
    for name, val in cara_params.items():
        arr = np.asarray(val)
        if name.startswith("bias") or not arr.any():
            out[name] = (std * rng.standard_normal(arr.shape)).astype(
                arr.dtype)
    return out
