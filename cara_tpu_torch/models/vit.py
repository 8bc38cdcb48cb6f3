"""Forward of the Vision Transformer with optional CaRA adapters (port of
``cara_tpu/models/vit.py``): eval, and the training forward of the
element-wise, rank, row and no weight-dropout routes and of the backbone
without an adapter.

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

Training (``train=True``) runs the routes the TPU takes (``_block``),
with per-image drop-path gates of rates ``linspace(0, drop_path_rate,
depth)``:

* element-wise weight dropout (``use_elem``, the default): per layer
  :func:`cp_attn_block_wd` and :func:`cp_mlp_block_wd`, the exact mask on
  all four dense deltas;
* rank or row weight dropout, or rate 0: the split attention path --
  :func:`cp_dense_ln` for qkv, :func:`fused_qkv_attention`,
  :func:`cp_dense` for the projection, ``x + proj * gate`` in the compute
  dtype -- then :func:`cp_mlp_block`.  Rank masks (r,) multiply each
  site's lambda (``_rank_comp``); row masks multiply the rows of each
  site's U (``_row_u``).

Past ``MAX_NP_FULL_SCORES`` (512) tokens -- ViT-B/16 at 384 px has 577
-- the full-score attention and the attention megakernel do not fit, and
every route takes the TPU's long-sequence form (``vit.py:587-596,
704-710, 716-737, 818-833``): :func:`blockwise_qkv_attention` in place of
:func:`fused_qkv_attention`; the adapter's eval and the rank / row /
rate-0 routes the split path above; element training the split path with
the element-dropout sites :func:`cp_dense_ln_wd` (qkv) and
:func:`cp_dense_wd` (proj) in place of :func:`cp_attn_block_wd`, then
:func:`cp_mlp_block_wd`.

Without an adapter (the linear probe and full fine-tuning train this
way, ``cara_params=None``) a block is LN1, the qkv GEMM, the attention,
the proj GEMM, ``x + proj * gate``, then LN2, fc1, GELU, fc2 and
``x + down * gate`` (``vit.py:779-813, 835, 871-873, 994-1030,
1048-1049, 1083-1084``); the GEMMs and LayerNorms are plain PyTorch, as
they are XLA ops outside any Pallas kernel in the reference, and in eval
the gates are ones.  ``attn_impl`` picks the attention there, as in
JAX's ``_block``: ``"fused"`` (``"auto"``) the layout-native kernel on
the qkv GEMM output (row 1, or the blockwise attention past 512
tokens), ``"flash"`` :func:`flash_attention` on the (B, H, N, Dh) views
of q, k and v at any token count (row 17; full fine-tuning, whose
gradients reach every weight through it).  With an adapter only the
fused attention is ported (the CaRA + flash branch needs JAX's XLA delta
forms).

Per layer it draws four int32 mask seeds (``_wd_seed``), two gates
(``_dp_gate``) and the rank or row masks from a ``torch.Generator`` on
the device, or takes them from ``randomness``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from cara_tpu_torch.config import CaraConfig, ViTConfig
from cara_tpu_torch.models import cara as cara_lib
from cara_tpu_torch.ops.cp import weight_dropout_mask
from cara_tpu_torch.ops.cuda import blockwise_attention as bwa_mod
from cara_tpu_torch.ops.cuda import cp_attn_block as attn_mod
from cara_tpu_torch.ops.cuda import cp_dense as dense_mod
from cara_tpu_torch.ops.cuda import cp_mlp as mlp_mod
from cara_tpu_torch.ops.cuda import flash_attention as flash_mod
from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa_mod
from cara_tpu_torch.ops.layers import activation, layer_norm, linear

Params = Dict[str, Any]
IMPLS = ("auto", "plain")
ATTN_IMPLS = ("auto", "fused", "flash")
WEIGHT_DROPOUT_IMPLS = ("element", "rank", "row")
# Where the training routes that are not ported yet stand (ROADMAP.md).
_TODO = "ROADMAP.md queue 2"


def patch_embed(params: Params, x: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """(B, H, W, C) -> (B, num_patches, E) by reshape + matmul; flatten
    order (ph, pw, c) as the HWIO conv kernel of the npz checkpoints."""
    b = x.shape[0]
    p, g = cfg.patch_size, cfg.grid_size
    x = x.reshape(b, g, p, g, p, cfg.in_chans)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * cfg.in_chans)
    return linear(x, params["embed"]["kernel"], params["embed"]["bias"])


def _unstack(tree, depth):
    """Per-layer trees of a layer-stacked tree, one ``unbind`` per leaf:
    its backward stacks the layers' gradients once, where indexing the
    stack once per layer would scatter each layer's gradient into a
    zeroed copy of the whole stack (full fine-tuning trains them)."""
    leaves = {k: _unstack(v, depth) if isinstance(v, dict) else v.unbind(0)
              for k, v in tree.items()}
    return [{k: v[i] for k, v in leaves.items()} for i in range(depth)]


def _block(x, bp, f1, p1, cfg: ViTConfig, cara_params, cara_cfg, impl,
           rand=None, attn_impl="fused"):
    """One transformer block.  In eval (``rand`` None) drop-path and
    dropout are identities; in training ``rand`` holds the layer's
    randomness: ``seeds`` (qkv, proj, fc1, fc2; int32 (4, 1, 1)),
    ``gates`` (attention, MLP; (2, B)) and, for the rank / row routes,
    ``comp`` ((4, r) or None) or ``rows`` (four (K,) masks or None).
    ``attn_impl`` ("fused" or "flash") picks the attention of the block
    without an adapter."""
    e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    mr = cfg.mlp_ratio
    b, n = x.shape[:2]
    plain = impl == "plain"
    dpm = torch.ones((b, 1), dtype=x.dtype, device=x.device)
    # The TPU's switch: past 512 (padded) tokens the full-score attention
    # and the attention megakernel give way to the blockwise attention.
    long = n > fqa_mod.MAX_NP_FULL_SCORES

    def attention(qkv):
        if long:
            return bwa_mod.blockwise_qkv_attention(qkv, h, d ** -0.5, n,
                                                   impl=impl)
        return fqa_mod.fused_qkv_attention(qkv, h, d ** -0.5, n, impl=impl)

    if cara_params is None:
        xa = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.layernorm_eps)
        qkv = linear(xa, bp["qkv"]["kernel"], bp["qkv"]["bias"])
        if attn_impl == "flash":  # (B, H, N, Dh) views, no copy
            q, k, v = (t.transpose(1, 2)
                       for t in qkv.reshape(b, n, 3, h, d).unbind(2))
            o = flash_mod.flash_attention(q, k, v, d ** -0.5, impl=impl)
            attn_out = o.transpose(1, 2).reshape(b, n, e)
        else:
            attn_out = attention(qkv)
        proj = linear(attn_out, bp["proj"]["kernel"], bp["proj"]["bias"])
        if rand is not None:  # drop-path
            proj = proj * rand["gates"][0].reshape(b, 1, 1).to(x.dtype)
        x = x + proj
        xm = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.layernorm_eps)
        hid = activation(linear(xm, bp["fc1"]["kernel"], bp["fc1"]["bias"]),
                         cfg.activation)
        down = linear(hid, bp["fc2"]["kernel"], bp["fc2"]["bias"])
        if rand is not None:
            down = down * rand["gates"][1].reshape(b, 1, 1).to(x.dtype)
        return x + down

    s = cara_cfg.scale
    dt = x.dtype
    rate = cara_cfg.weight_dropout
    use_elem = (rand is not None and cara_cfg.weight_dropout_impl == "element"
                and rate > 0.0)
    comp = rows = None
    if rand is not None and not use_elem:
        comp, rows = rand.get("comp"), rand.get("rows")

    def fold(t):  # the delta scale rides the factors; kernels run at s=1
        return (t * s).to(dt).contiguous()

    def cast(t):
        return t.to(dt).contiguous()

    def site_uv(site, uv_fn, *args):
        """The site's (U, V), rank mask on lambda, row mask on U's rows."""
        u, v = uv_fn(*args, None if comp is None else comp[site])
        if rows is not None:
            u = u * rows[site][:, None]
        return cast(u), fold(v)

    p2, p3, r2 = cara_params["P2"], cara_params["P3"], cara_params["R2"]
    u1, v1 = site_uv(0, cara_lib.qkv_uv, cara_params, f1, cfg, cara_cfg)
    u2, v2 = site_uv(1, cara_lib.rows_out_uv, p1[0:1], p2, p3, r2)
    attn_args = (
        x, bp["qkv"]["kernel"], bp["qkv"]["bias"], u1, v1,
        bp["proj"]["kernel"], bp["proj"]["bias"], u2, v2,
        fold(cara_params["bias1"]), bp["ln1_scale"], bp["ln1_bias"])
    gate = (dpm.reshape(b, 1, 1) if rand is None
            else rand["gates"][0].reshape(b, 1, 1).to(dt))
    if rand is None and not long:
        attn_block = (attn_mod.cp_attn_block_plain if plain
                      else attn_mod.cp_attn_block)
        x = attn_block(*attn_args, dpm, h, d ** -0.5, n, 1.0,
                       cfg.layernorm_eps)
    elif use_elem and not long:
        x = attn_mod.cp_attn_block_wd(
            *attn_args, rand["gates"][0].reshape(b, 1).to(dt),
            rand["seeds"][0], rand["seeds"][1], h, d ** -0.5, n, 1.0, rate,
            cfg.layernorm_eps, impl=impl)
    elif use_elem:  # the split element sites (vit.py:716-724, 818-824)
        qkv = dense_mod.cp_dense_ln_wd(
            x, bp["qkv"]["kernel"], bp["qkv"]["bias"], u1, v1, None,
            bp["ln1_scale"], bp["ln1_bias"], rand["seeds"][0], 1.0, rate,
            cfg.layernorm_eps, impl=impl)
        proj = dense_mod.cp_dense_wd(attention(qkv), *attn_args[5:10],
                                     rand["seeds"][1], 1.0, rate, impl=impl)
        x = x + proj * gate
    else:  # the split path (vit.py:691-873)
        qkv = dense_mod.cp_dense_ln(
            x, bp["qkv"]["kernel"], bp["qkv"]["bias"], u1, v1, None,
            bp["ln1_scale"], bp["ln1_bias"], 1.0, cfg.layernorm_eps,
            impl=impl)
        proj = dense_mod.cp_dense(attention(qkv), *attn_args[5:10], 1.0,
                                  impl=impl)
        x = x + proj * gate
    u3, v3 = site_uv(2, cara_lib.rows_out_uv, p1[1:1 + mr], p2, p3, r2)
    u4, v4 = site_uv(3, cara_lib.rows_in_uv, p1[1 + mr:1 + 2 * mr], p2, p3,
                     r2)
    mlp_args = (
        x, bp["fc1"]["kernel"], bp["fc1"]["bias"], u3, v3,
        fold(cara_params["bias2"]), bp["fc2"]["kernel"], bp["fc2"]["bias"],
        u4, v4, fold(cara_params["bias3"]), bp["ln2_scale"], bp["ln2_bias"])
    if use_elem:
        return mlp_mod.cp_mlp_block_wd(
            *mlp_args, rand["gates"][1].reshape(b, 1, 1).to(dt),
            rand["seeds"][2], rand["seeds"][3], 1.0, rate, cfg.activation,
            cfg.layernorm_eps, impl=impl)
    gate = (dpm.reshape(b, 1, 1) if rand is None
            else rand["gates"][1].reshape(b, 1, 1).to(dt))
    return mlp_mod.cp_mlp_block(*mlp_args, gate, 1.0, cfg.activation,
                                cfg.layernorm_eps, impl=impl)


def check_trainable(cfg: ViTConfig, cara_cfg: Optional[CaraConfig]) -> None:
    """Refuse the training routes that are not ported yet, naming where
    they stand in the ROADMAP.  ``cara_cfg=None`` is the forward without
    an adapter (the linear probe and full fine-tuning)."""
    if cfg.dropout_rate > 0.0 or cfg.attn_dropout_rate > 0.0:
        raise NotImplementedError(
            "activation / attention dropout in training is not yet ported "
            f"({_TODO}: row 13's GELU body and mha)")
    if cara_cfg is None:
        return
    if cara_cfg.method != "cara" or cara_cfg.moe:
        raise NotImplementedError(
            f"training method={cara_cfg.method!r} (moe={cara_cfg.moe}) is "
            "not yet ported (ROADMAP.md queue 1: the PEFT zoo)")
    if cara_cfg.cp_order == 2 or cara_cfg.delta_impl == "materialized":
        raise NotImplementedError(
            "cp_order=2 and delta_impl='materialized' train on the "
            "materialized delta, not yet ported (ROADMAP.md queue 1: CP "
            "orders and dim_experiment)")
    if cara_cfg.weight_dropout_impl not in WEIGHT_DROPOUT_IMPLS:
        raise ValueError(
            f"weight_dropout_impl must be one of {WEIGHT_DROPOUT_IMPLS}, "
            f"got {cara_cfg.weight_dropout_impl!r}")


def draw_randomness(cfg: ViTConfig, batch: int, device,
                    generator: Optional[torch.Generator],
                    dtype: torch.dtype = torch.float32,
                    cara_cfg: Optional[CaraConfig] = None) -> Dict[str, Any]:
    """Per-layer training randomness: ``seeds`` int32 (depth, 4, 1, 1) —
    the qkv, proj, fc1 and fc2 mask seeds, uniform over
    [-2**31, 2**31 - 1) as ``_wd_seed`` — and ``gates`` (depth, 2, B) in
    ``dtype``: ``bernoulli(1 - r) / (1 - r)`` with r from
    ``linspace(0, drop_path_rate, depth)`` (``_dp_gate``).  With
    ``cara_cfg`` at a rate above 0, the rank route adds ``comp`` (depth,
    4, r) (``_rank_comp``) and the row route ``rows``, four (depth, K)
    masks for the qkv, proj, fc1 (K = E) and fc2 (K = hidden) sites
    (``_row_u``), all inverted masks in ``dtype``."""
    depth = cfg.depth
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (depth, 4, 1, 1),
                          generator=generator, device=device,
                          dtype=torch.int32)
    keeps = 1.0 - torch.linspace(0.0, cfg.drop_path_rate, depth)
    gates = []
    for keep in keeps:  # 0-d fp32, as the reference's traced rate
        probs = torch.full((2, batch), keep.item(), device=device)
        mask = torch.bernoulli(probs, generator=generator)
        gates.append(mask.to(dtype) / keep.to(dtype).to(device))
    out = {"seeds": seeds, "gates": torch.stack(gates)}
    if cara_cfg is None:
        return out
    rate = cara_cfg.weight_dropout
    if cara_cfg.weight_dropout_impl == "rank" and rate > 0.0:
        out["comp"] = weight_dropout_mask((depth, 4, cara_cfg.rank), rate,
                                          dtype, generator, device)
    elif cara_cfg.weight_dropout_impl == "row" and rate > 0.0:
        e = cfg.embed_dim
        out["rows"] = [weight_dropout_mask((depth, k), rate, dtype,
                                           generator, device)
                       for k in (e, e, e, cfg.hidden_dim)]
    return out


def vit_forward(params: Params, x: torch.Tensor, cfg: ViTConfig,
                cara_params: Optional[Dict[str, torch.Tensor]] = None,
                cara_cfg: Optional[CaraConfig] = None,
                impl: str = "auto", *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                randomness: Optional[Dict[str, Any]] = None,
                attn_impl: str = "auto") -> torch.Tensor:
    """Images (B, H, W, C) NHWC -> logits (B, num_classes).

    ``params`` / ``cara_params`` are tensor trees on ``x``'s device (see
    ``models.convert.params_from_numpy``); the forward computes in
    ``x.dtype``.  ``train=True`` runs the training forward (see the
    module docs); its randomness comes from ``randomness`` (as
    :func:`draw_randomness` returns it) or else is drawn from
    ``generator``.  ``attn_impl``: "fused" (or "auto", as on the TPU)
    or, without an adapter, "flash"."""
    if (cara_params is None) != (cara_cfg is None):
        raise ValueError("cara_params and cara_cfg must be provided together")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r} (the XLA attention is not ported)")
    attn_impl = "fused" if attn_impl == "auto" else attn_impl
    if attn_impl == "flash" and cara_cfg is not None:
        raise NotImplementedError(
            "CaRA with attn_impl='flash' needs the XLA delta forms of "
            "cara_tpu's _block, not yet ported (ROADMAP.md queue 1: CaRA "
            "with --attn-impl flash / xla)")
    if train:
        check_trainable(cfg, cara_cfg)
        if randomness is None:
            randomness = draw_randomness(cfg, x.shape[0], x.device,
                                         generator, x.dtype, cara_cfg)
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
    blocks = _unstack(params["blocks"], cfg.depth)
    for layer in range(cfg.depth):
        rand = None
        if train:
            rows = randomness.get("rows")
            rand = {"seeds": randomness["seeds"][layer],
                    "gates": randomness["gates"][layer],
                    "comp": (None if randomness.get("comp") is None
                             else randomness["comp"][layer]),
                    "rows": (None if rows is None
                             else [m[layer] for m in rows])}
        tokens = _block(
            tokens, blocks[layer],
            None if a1 is None else a1[layer],
            None if p1 is None else p1[layer],
            cfg, cara_params, cara_cfg, impl, rand, attn_impl)
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
