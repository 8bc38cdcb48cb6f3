"""Forward of the Vision Transformer with optional CaRA (or its mixture
of experts), LoRA or FacT adapters, or the PEFT zoo's VPT prompts, SSF,
BitFit and bottleneck adapters (port of ``cara_tpu/models/vit.py``):
eval, and the training forward of the element-wise, rank, row and no
weight-dropout routes and of the backbone without an adapter, with
drop-path, activation dropout
(``cfg.dropout_rate``) and attention dropout (``cfg.attn_dropout_rate``).

Layouts are the JAX package's: NHWC images, (in, out) kernels, blocks
stacked on a leading layer axis, qkv columns out-flat (3, H, Dh).  The
layer loop is plain Python (eager PyTorch has no ``scan`` to lower).

``_block`` picks its forms as JAX's does, from ``attn_impl`` ("fused",
"flash" or "xla"; "auto" is "fused"), ``dense_impl`` ("fused" or "xla";
"auto" is "fused" with an adapter and "xla" without) and the rates:

* the block megakernels (:func:`cp_attn_block`, :func:`cp_mlp_block`, or
  their element-dropout forms ``*_wd``; zero factors without an adapter)
  run with the fused dense forms and no activation dropout; the
  attention one with the fused attention and at most 512 tokens, and
  where ``_attn_mega_on`` says so: ``CARA_ATTN_MEGA`` "1" or "0" forces
  it on or off, "auto" (the default) turns it on for eval and
  element-dropout training only;
* otherwise the split sites: :func:`cp_dense_ln` (or
  :func:`cp_dense_ln_wd`) for qkv, the attention, :func:`cp_dense` (or
  :func:`cp_dense_wd`) for the projection; with ``CARA_ATTNPROJ=1``, on
  every route but the element one with the fused dense forms, the fused
  attention and at most 512 tokens, the attention and the projection
  site are one call, :func:`fused_qkv_attention_proj`; for the MLP the
  fc1 site with
  LN2 and the GELU fused (``act``, TPU row 13's GELU body), dropout, the
  fc2 site.  Rank masks (r,) multiply each site's lambda (``_rank_comp``);
  row masks multiply the rows of each site's U (``_row_u``);
* the attention: :func:`fused_qkv_attention` on the qkv output (row 1),
  :func:`blockwise_qkv_attention` past ``MAX_NP_FULL_SCORES`` (512)
  tokens (ViT-B/16 at 384 px has 577), :func:`flash_attention` on the
  (B, H, N, Dh) views of q, k and v for "flash" (row 17), or ``mha`` (XLA
  in JAX, plain here) for "xla" and whenever attention dropout is on;
  any attention but the fused one computes qkv as the GEMM plus the XLA
  qkv delta (``cara.qkv_delta``), which on the element route masks the
  materialized (3, E, E) delta with a Bernoulli draw (``k_wd_qkv``);
* ``dense_impl="xla"``: the GEMMs (``F.linear``, as XLA ops outside any
  Pallas kernel in the reference) with the CP deltas of ``ops/cp.py``
  beside them, the element route's masks on the materialized deltas.
  CaRA at CP order 2 (whose qkv delta is always the dense (3, E, E)
  tensor) and with ``delta_impl="materialized"`` (every site's dense
  delta, masked element-wise in training on any weight-dropout route)
  always take this form, as on the TPU.
  Blocks quantized by ``models/quant.py`` (int8 quant dicts in place of
  the four block kernels) take this form only ("auto" resolves to it,
  "fused" is refused): :func:`matk` computes each GEMM, the bias added
  after it, and an adapter's delta on top, as in the reference.

Without an adapter (the linear probe and full fine-tuning train this
way, ``cara_params=None``) the XLA forms are the default, and in eval
the gates are ones.  ``impl="auto"`` calls the kernel wrappers, which
launch the CUDA kernels for CUDA tensors and run their plain versions
for CPU tensors; ``impl="plain"`` calls the plain versions on any device
(the reference the kernels are held against).  Of the reference's
``CARA_*`` knobs, ``CARA_ATTN_MEGA`` and ``CARA_ATTNPROJ`` are honoured,
read from the environment at import as JAX reads them, and
``CARA_INT8_PALLAS``, read by :func:`matk` at each call; the TPU-only
machinery (the 197 -> 200 stream pad, tile pickers, tune cache, the
other knobs) is not ported.

Per layer it draws four int32 mask seeds (``_wd_seed``), two gates
(``_dp_gate``), the rank or row masks and the dropout masks
(:func:`layer_mask_specs`) from a ``torch.Generator`` on the device, or
takes them from ``randomness``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint as checkpoint_lib

from cara_tpu_torch.config import (ADAPTER_METHODS, BOTTLENECK_METHODS,
                                   FACT_METHODS, LORA_FAMILY, VPT_METHODS,
                                   ZOO_METHODS, CaraConfig, ViTConfig)
from cara_tpu_torch.models import adapter as adapter_lib
from cara_tpu_torch.models import bitfit as bitfit_lib
from cara_tpu_torch.models import cara as cara_lib
from cara_tpu_torch.models import fact as fact_lib
from cara_tpu_torch.models import lora as lora_lib
from cara_tpu_torch.models import moe as moe_lib
from cara_tpu_torch.models import ssf as ssf_lib
from cara_tpu_torch.models import vpt as vpt_lib
from cara_tpu_torch.models.quant import is_quantized
from cara_tpu_torch.ops import cp as cp_ops
from cara_tpu_torch.ops.cp import weight_dropout_mask
from cara_tpu_torch.ops.cuda import blockwise_attention as bwa_mod
from cara_tpu_torch.ops.cuda import cp_attn_block as attn_mod
from cara_tpu_torch.ops.cuda import cp_dense as dense_mod
from cara_tpu_torch.ops.cuda import cp_mlp as mlp_mod
from cara_tpu_torch.ops.cuda import flash_attention as flash_mod
from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa_mod
from cara_tpu_torch.ops.cuda import int8_dense as int8_mod
from cara_tpu_torch.ops.layers import (activation, dropout, layer_norm,
                                       linear, mha)

Params = Dict[str, Any]
IMPLS = ("auto", "plain")
ATTN_IMPLS = ("auto", "fused", "flash", "xla")
DENSE_IMPLS = ("auto", "fused", "xla")
WEIGHT_DROPOUT_IMPLS = ("element", "rank", "row")

# The attention and the projection site in one kernel (TPU row 3); off
# unless CARA_ATTNPROJ=1, as in the reference (vit.py:41-47).
_ATTNPROJ = os.environ.get("CARA_ATTNPROJ", "0") == "1"
# The attention megakernel: "1" / "0" force it, "auto" as
# ``_attn_mega_on`` (vit.py:57-66).
_ATTN_MEGA = os.environ.get("CARA_ATTN_MEGA", "auto")


def _attn_mega_on(use_elem: bool, training: bool) -> bool:
    """Whether the attention megakernel may run (``_attn_mega_on``): a
    bool set by a test wins, "1" and "0" force, "auto" is on for eval
    forwards and element-dropout training."""
    if isinstance(_ATTN_MEGA, bool):
        return _ATTN_MEGA
    if _ATTN_MEGA in ("0", "1"):
        return _ATTN_MEGA == "1"
    return use_elem or not training


def _int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) x int8 (K, N) -> int32, exact.  JAX leaves this
    product to XLA, outside any Pallas kernel: on the card it is
    ``torch._int_mm`` (the int8 tensor cores; it wants more than 16 rows
    and K, N multiples of 8, and runs fastest on a column-major ``wq``,
    which ``Predictor`` keeps), on the CPU an int32 matmul."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    x2 = xq.reshape(-1, k)
    if xq.is_cuda:
        y = torch._int_mm(x2.contiguous(), wq)
    else:
        y = x2.to(torch.int32) @ wq.to(torch.int32)
    return y.reshape(*lead, wq.shape[1])


def matk(x: torch.Tensor, kernel, impl: str = "auto") -> torch.Tensor:
    """``x @ kernel`` where ``kernel`` may be an int8 quant dict of
    ``models/quant.py`` (the reference's ``matk``, vit.py:182-222):

    * ``{"qa", "scale"}`` (w8a8): per-token symmetric activation codes
      ``round(x / ax)``, ``ax = max(max|x| / 127, 1e-12)`` (exact row
      maxima, so no code clips), the int8 x int8 -> int32 product, then
      ``y32 * ax * scale`` in fp32, cast to ``x.dtype``;
    * ``{"q", "scale"}`` (w8): with ``CARA_INT8_PALLAS=1`` (read at each
      call, as the reference reads it), a CUDA ``x`` and a 2-D kernel
      whose dims are multiples of 128, the dequant-fused GEMM kernel
      (TPU row 18, ``ops/cuda/int8_dense.py``) without a bias (the
      reference's zero bias), or its plain version for
      ``impl="plain"``; otherwise ``(x @ q) * scale`` in ``x.dtype``."""
    if isinstance(kernel, dict) and "qa" in kernel:
        wq, s = kernel["qa"], kernel["scale"]
        x32 = x.float()
        ax = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True) / 127.0,
                             1e-12)
        xq = torch.round(x32 / ax).to(torch.int8)
        y32 = _int8_matmul(xq, wq)
        return (y32.float() * ax * s.float()).to(x.dtype)
    if isinstance(kernel, dict) and "q" in kernel:
        wq, s = kernel["q"], kernel["scale"]
        mult = int8_mod.DIM_MULTIPLE
        if (os.environ.get("CARA_INT8_PALLAS") == "1" and x.is_cuda
                and wq.dim() == 2 and wq.shape[0] % mult == 0
                and wq.shape[1] % mult == 0):
            return int8_mod.int8_dense(x, wq, s.reshape(-1), None,
                                       impl=impl)
        return (x @ wq.to(x.dtype)) * s.to(x.dtype)
    return x @ kernel


def _dense(x: torch.Tensor, lin, impl: str) -> torch.Tensor:
    """A block's dense site of the XLA form: ``linear`` for a float
    kernel, ``matk(x, kernel) + bias`` for a quant dict (the bias added
    after the product, as the reference adds it)."""
    if is_quantized(lin["kernel"]):
        return matk(x, lin["kernel"], impl) + lin["bias"]
    return linear(x, lin["kernel"], lin["bias"])


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


def _keep_mask(shape, rate: float, generator, device) -> torch.Tensor:
    """Boolean keep mask, ``bernoulli(1 - rate)`` (``dropout``'s draw)."""
    return torch.empty(shape, dtype=torch.bool, device=device).bernoulli_(
        1.0 - rate, generator=generator)


def materialized_delta(cara_cfg: Optional[CaraConfig]) -> bool:
    """Whether an adapter's dense deltas are materialized on every site
    (``delta_impl="materialized"``): then its weight dropout is the
    element mask on each dense delta, whatever ``weight_dropout_impl``
    says (``vit.py:477-499``)."""
    return cara_cfg is not None and cara_cfg.delta_impl == "materialized"


def layer_mask_specs(cfg: ViTConfig, cara_cfg: Optional[CaraConfig],
                     batch: int, attn_impl: str = "fused",
                     dense_impl: str = "fused") -> Dict[str, tuple]:
    """The random masks one training layer draws, name -> (shape, kind),
    kind ``"keep"`` (boolean, activation / attention dropout) or
    ``"weight"`` (the inverted element mask of weight dropout on a dense
    delta of the XLA forms): ``do1`` / ``do2`` / ``do3`` (the proj, GELU
    and fc2 outputs; ``k_do1..3``), ``attn`` (the probabilities of
    ``mha``; ``k_attn``), and the dense masks (``k_wd_*``): ``qkv`` where
    the qkv delta is the XLA one (any attention but the fused one without
    attention dropout, or ``dense_impl="xla"``) on the element route, with
    the materialized delta, and at CP order 2 on every route but the row
    one (order 2 always materializes its qkv delta); ``proj`` / ``fc1`` /
    ``fc2`` under ``dense_impl="xla"`` on the element route and with the
    materialized delta.  The dense masks take the layout of the method's
    delta: CaRA's tensors, qkv (3, E, E), proj (E, E), fc1 and fc2 (hid,
    E); LoRA's and FacT's (in, out) products ``A @ B``, qkv (E, 3E), proj
    (E, E), fc1 (E, hid), fc2 (hid, E)
    (``cara_tpu/models/lora.py:141-142``).  The bottleneck adapters at an
    ``adapter_dropout`` above 0 add ``ad_attn`` (Houlsby only) and
    ``ad_mlp``, kind ``"adapter"``: the (B, N, r) keep masks of their
    internal dropout (``k_ad``'s two halves, ``vit.py:439-469``).  VPT's
    layers run N + P tokens."""
    e, h, n, hid = cfg.embed_dim, cfg.num_heads, cfg.seq_len, cfg.hidden_dim
    if cara_cfg is not None and cara_cfg.method in VPT_METHODS:
        n += cara_cfg.vpt_tokens
    out = {}
    if cfg.dropout_rate > 0.0:
        out.update(do1=((batch, n, e), "keep"), do2=((batch, n, hid), "keep"),
                   do3=((batch, n, e), "keep"))
    if cfg.attn_dropout_rate > 0.0:
        out["attn"] = ((batch, h, n, n), "keep")
    if (cara_cfg is not None and cara_cfg.method in BOTTLENECK_METHODS
            and cara_cfg.adapter_dropout > 0.0):
        if cara_cfg.method == "adapter":
            out["ad_attn"] = ((batch, n, cara_cfg.rank), "adapter")
        out["ad_mlp"] = ((batch, n, cara_cfg.rank), "adapter")
    if cara_cfg is None or cara_cfg.weight_dropout <= 0.0:
        return out
    impl = cara_cfg.weight_dropout_impl
    dense = materialized_delta(cara_cfg) or impl == "element"
    lora = cara_cfg.method in LORA_FAMILY
    shapes = (lora_lib.element_mask_shapes(cfg) if lora else
              {"qkv": (3, e, e), "proj": (e, e), "fc1": (hid, e),
               "fc2": (hid, e)})
    order2 = not lora and cara_cfg.cp_order == 2
    fused_attn = attn_impl == "fused" and cfg.attn_dropout_rate == 0.0
    if dense_impl == "xla" or not fused_attn:
        if dense or (order2 and impl != "row"):
            out["qkv"] = (shapes["qkv"], "weight")
    if dense_impl == "xla" and dense:
        out.update({k: (shapes[k], "weight") for k in ("proj", "fc1", "fc2")})
    return out


def draw_layer_masks(specs, cfg: ViTConfig, cara_cfg, generator, device,
                     dtype) -> Dict[str, torch.Tensor]:
    """One layer's masks of :func:`layer_mask_specs` from ``generator``
    (other bits than ``jax.random``); weight masks in ``dtype``."""
    out = {}
    for name, (shape, kind) in specs.items():
        if kind == "keep":
            rate = (cfg.attn_dropout_rate if name == "attn"
                    else cfg.dropout_rate)
            out[name] = _keep_mask(shape, rate, generator, device)
        elif kind == "adapter":
            out[name] = _keep_mask(shape, cara_cfg.adapter_dropout,
                                   generator, device)
        else:
            out[name] = weight_dropout_mask(shape, cara_cfg.weight_dropout,
                                            dtype, generator, device)
    return out


def _block(x, bp, f1, p1, cfg: ViTConfig, cara_params, cara_cfg, impl,
           rand=None, attn_impl="fused", dense_impl="fused", scale=None,
           ad=None, moe_gates=None):
    """One transformer block (``cara_tpu``'s ``_block``).  In eval
    (``rand`` None) drop-path and dropout are identities; in training
    ``rand`` holds the layer's randomness: ``seeds`` (qkv, proj, fc1,
    fc2; int32 (4, 1, 1)), ``gates`` (attention, MLP; (2, B)), for the
    rank / row routes ``comp`` ((4, r) or None) or ``rows`` (four (K,)
    masks or None), and ``masks``, this layer's :func:`layer_mask_specs`
    masks, or None to draw them now from ``generator``.  ``attn_impl``
    ("fused", "flash" or "xla") and ``dense_impl`` ("fused" or "xla")
    pick the forms as the TPU's ``_block`` does.  ``scale`` (a 0-d
    tensor in ``x.dtype``, or None for ``cara_cfg.scale``) is the delta
    scale.  ``f1`` / ``p1`` are this layer's CaRA row slices (A1, P1) or,
    for LoRA, its qkv pair and its {proj, fc1, fc2} pairs; each site's
    (U, V) comes from ``adapter_uv`` (JAX's ``_adapter_uv``), and LoRA's
    adapter biases are zeros.  ``ad`` is this layer's bottleneck-adapter
    {site: {kernel, bias}} (``cara_params`` None, ``cara_cfg`` the
    adapter's): Houlsby's modules on the projection's and fc2's outputs,
    AdaptFormer's beside the MLP on the pre-LN2 stream, scaled
    (``vit.py:866-885, 1079-1087``).  ``moe_gates`` (B, N, X) are the
    router's gates of a mixture of experts (``models/moe.py``):
    ``cara_params`` is then the expert-stacked tree, ``f1`` / ``p1`` its
    (X, rows, r) slices, ``comp`` (4, X, r), and each site adds the
    gate-weighted delta and bias of ``moe_lib`` on the XLA dense forms
    (``vit.py:743-751, 783-788, 837-843, 998-1004, 1051-1057``)."""
    e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    mr = cfg.mlp_ratio
    b, n = x.shape[:2]
    dt = x.dtype
    train = rand is not None
    # The TPU's switch: past 512 (padded) tokens the full-score attention
    # and the attention megakernel give way to the blockwise attention.
    long = n > fqa_mod.MAX_NP_FULL_SCORES
    use_cara = cara_params is not None
    lora = use_cara and cara_cfg.method == "lora"
    moe = moe_gates is not None
    rate = cara_cfg.weight_dropout if use_cara else 0.0
    # The materialized delta (and CP order 2, whose dense forms
    # ``resolve_impls`` pins) draws its element masks in ``masks``.
    materialized = use_cara and materialized_delta(cara_cfg)
    use_elem = (train and use_cara and rate > 0.0 and not materialized
                and cara_cfg.weight_dropout_impl == "element")
    fused_dense = dense_impl == "fused" and use_cara
    fused_plain = dense_impl == "fused" and not use_cara
    fused_attn = attn_impl == "fused" and cfg.attn_dropout_rate == 0.0
    ad_seq = ad is not None and cara_cfg.method == "adapter"
    ad_rate = cara_cfg.adapter_dropout if ad is not None else 0.0
    # Activation dropout cannot ride inside the block megakernels, and the
    # attention one runs where ``_attn_mega_on`` says.
    attn_mega = ((fused_dense or fused_plain) and fused_attn and not long
                 and _attn_mega_on(use_elem, train)
                 and cfg.dropout_rate == 0.0)
    attn_proj = (fused_dense and fused_attn and _ATTNPROJ and not use_elem
                 and not long)
    mlp_mega = (fused_dense or fused_plain) and cfg.dropout_rate == 0.0
    comp = rows = None
    if train and use_cara and not use_elem and not materialized:
        comp, rows = rand.get("comp"), rand.get("rows")
    masks = None
    if train:
        masks = rand.get("masks")
        if masks is None:
            masks = draw_layer_masks(
                layer_mask_specs(cfg, cara_cfg, b, attn_impl, dense_impl),
                cfg, cara_cfg, rand.get("generator"), x.device, dt)

    def gate(i):  # drop-path, (B, 1, 1) in the compute dtype
        if not train:
            return torch.ones((b, 1, 1), dtype=dt, device=x.device)
        return rand["gates"][i].reshape(b, 1, 1).to(dt)

    def branch(t, i, name):
        """The sublayer's output ``t`` after activation dropout
        (``k_do1`` / ``k_do3``) and drop-path, added to the stream."""
        if not train:
            return x + t
        if cfg.dropout_rate > 0.0:
            t = dropout(t, cfg.dropout_rate, masks[name])
        return x + t * gate(i)

    def ad_module(t, site, act):
        """A bottleneck module of ``ad`` on ``t`` (``ad_attn`` /
        ``ad_mlp`` its dropout mask in training)."""
        keep = masks[f"ad_{site}"] if train and ad_rate > 0.0 else None
        return adapter_lib.bottleneck(t, ad[f"{site}_down"], ad[f"{site}_up"],
                                      act, keep, ad_rate)

    def wmask(name):  # the element mask on a dense XLA delta
        m = None if masks is None else masks.get(name)
        return None if m is None else m.to(dt)

    def site_comp(site):
        return None if comp is None else comp[site]

    def row_x(t, site):  # the row mask on the XLA delta's input features
        return t if rows is None else t * rows[site].to(dt)

    def attention(qkv):
        if long:
            return bwa_mod.blockwise_qkv_attention(qkv, h, d ** -0.5, n,
                                                   impl=impl)
        return fqa_mod.fused_qkv_attention(qkv, h, d ** -0.5, n, impl=impl)

    if use_cara:
        s = cara_cfg.scale if scale is None else scale

        def fold(t):  # the delta scale rides the factors; kernels at s=1
            return (t * s).to(dt).contiguous()

        if lora:  # LoRA's per-layer pairs are the (U, V) form already
            def adapter_uv(site, comp):
                sp = f1 if site == 0 else p1[lora_lib.SITES[site]]
                return lora_lib.site_uv(sp, comp)

            cb_proj, cb_down = x.new_zeros((e,)), x.new_zeros((e,))
            cb_up = x.new_zeros((cfg.hidden_dim,))
        else:
            p2, p3, r2 = (cara_params["P2"], cara_params["P3"],
                          cara_params["R2"])
            # P1's rows of the layer (an expert axis leads under MoE)
            p1_proj, p1_up, p1_down = (p1[..., 0:1, :],
                                       p1[..., 1:1 + mr, :],
                                       p1[..., 1 + mr:1 + 2 * mr, :])

            def adapter_uv(site, comp):
                if site == 0:
                    return cara_lib.qkv_uv(cara_params, f1, cfg, cara_cfg,
                                           comp)
                if site == 3:
                    return cara_lib.rows_in_uv(p1_down, p2, p3, r2, comp)
                return cara_lib.rows_out_uv(p1_proj if site == 1 else p1_up,
                                            p2, p3, r2, comp)

            cb_proj, cb_up, cb_down = (
                moe_lib.moe_bias(moe_gates, cara_params[k]) if moe
                else cara_params[k] for k in ("bias1", "bias2", "bias3"))

        def site_uv(site):
            """The site's (U, V), rank mask on V, row mask on U."""
            u, v = adapter_uv(site, site_comp(site))
            if rows is not None:
                u = u * rows[site][:, None]
            return u.to(dt).contiguous(), fold(v)

        def lora_delta(t, site):
            """LoRA's XLA delta of ``site`` on ``t``, unscaled."""
            name = lora_lib.SITES[site]
            return lora_lib.delta(
                row_x(t, site), f1 if site == 0 else p1[name],
                element=use_elem or materialized, drop_mask=wmask(name),
                comp_mask=site_comp(site))
    if fused_dense:  # the kernels' collapsed (U, V) pairs
        u1, v1 = site_uv(0)
        u2, v2 = site_uv(1)
        attn_args = (x, bp["qkv"]["kernel"], bp["qkv"]["bias"], u1, v1,
                     bp["proj"]["kernel"], bp["proj"]["bias"], u2, v2,
                     fold(cb_proj), bp["ln1_scale"], bp["ln1_bias"])
    elif attn_mega:  # the megakernel without an adapter: zero factors
        zero = x.new_zeros
        attn_args = (x, bp["qkv"]["kernel"], bp["qkv"]["bias"],
                     zero((e, 1)), zero((1, 3 * e)), bp["proj"]["kernel"],
                     bp["proj"]["bias"], zero((e, 1)), zero((1, e)),
                     zero((e,)), bp["ln1_scale"], bp["ln1_bias"])

    # --- attention (vit.py:596-813) ---
    if attn_mega:
        if use_elem:
            x = attn_mod.cp_attn_block_wd(
                *attn_args, rand["gates"][0].reshape(b, 1).to(dt),
                rand["seeds"][0], rand["seeds"][1], h, d ** -0.5, n, 1.0,
                rate, cfg.layernorm_eps, impl=impl)
        else:
            x = attn_mod.cp_attn_block(*attn_args, gate(0).reshape(b, 1), h,
                                       d ** -0.5, n, 1.0, cfg.layernorm_eps,
                                       impl=impl)
    else:
        if fused_dense and fused_attn:
            if use_elem:  # the split element sites (vit.py:716-724)
                qkv = dense_mod.cp_dense_ln_wd(
                    x, bp["qkv"]["kernel"], bp["qkv"]["bias"], u1, v1, None,
                    bp["ln1_scale"], bp["ln1_bias"], rand["seeds"][0], 1.0,
                    rate, cfg.layernorm_eps, impl=impl)
            else:
                qkv = dense_mod.cp_dense_ln(
                    x, bp["qkv"]["kernel"], bp["qkv"]["bias"], u1, v1, None,
                    bp["ln1_scale"], bp["ln1_bias"], 1.0, cfg.layernorm_eps,
                    impl=impl)
        else:  # the qkv GEMM, plus the XLA qkv delta with an adapter
            xa = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"],
                            cfg.layernorm_eps)
            qkv = _dense(xa, bp["qkv"], impl)
            if lora:
                delta = lora_delta(xa, 0)
            elif moe:
                delta = moe_lib.moe_qkv_delta(xa, cara_params, f1, moe_gates,
                                              cfg, cara_cfg, site_comp(0))
            elif use_cara:
                delta = cara_lib.qkv_delta(
                    row_x(xa, 0), cara_params, f1, cfg, cara_cfg,
                    materialized=use_elem or materialized,
                    drop_mask=wmask("qkv"), comp_mask=site_comp(0))
            if use_cara:
                qkv = qkv + delta.reshape(b, n, 3 * e).to(dt) * s
        if attn_proj:  # the attention output stays in the kernel
            proj = fqa_mod.fused_qkv_attention_proj(
                qkv, *attn_args[5:10], h, d ** -0.5, n, 1.0, impl=impl)
        else:
            if fused_attn:
                attn_out = attention(qkv)
            else:  # (B, H, N, Dh) views, no copy
                q, k, v = (t.transpose(1, 2)
                           for t in qkv.reshape(b, n, 3, h, d).unbind(2))
                if attn_impl == "flash" and cfg.attn_dropout_rate == 0.0:
                    o = flash_mod.flash_attention(q, k, v, d ** -0.5,
                                                  impl=impl)
                    attn_out = o.transpose(1, 2).reshape(b, n, e)
                else:
                    keep = (masks["attn"]
                            if train and cfg.attn_dropout_rate > 0 else None)
                    attn_out = mha(q, k, v, d ** -0.5, cfg.attn_dropout_rate,
                                   keep)
            if fused_dense and use_elem:
                proj = dense_mod.cp_dense_wd(attn_out, *attn_args[5:10],
                                             rand["seeds"][1], 1.0, rate,
                                             impl=impl)
            elif fused_dense:
                proj = dense_mod.cp_dense(attn_out, *attn_args[5:10], 1.0,
                                          impl=impl)
            else:
                proj = _dense(attn_out, bp["proj"], impl)
                if lora:  # no adapter bias
                    proj = proj + lora_delta(attn_out, 1) * s
                elif use_cara:
                    if moe:
                        pd = moe_lib.moe_rows_delta_out(
                            attn_out, p1_proj, cara_params, moe_gates,
                            site_comp(1))
                    elif use_elem or materialized:
                        pd = cp_ops.rows_delta_out_materialized(
                            attn_out, p1_proj, p2, p3, r2, wmask("proj"))
                    else:
                        pd = cp_ops.rows_delta_out_factorized(
                            row_x(attn_out, 1), p1_proj, p2, p3, r2,
                            site_comp(1))
                    proj = proj + (pd + cb_proj) * s
        if ad_seq:  # Houlsby: z + up(gelu(down(z))) on the sublayer output
            proj = proj + ad_module(proj, "attn", "gelu")
        x = branch(proj, 0, "do1")

    ad_par = None
    if ad is not None and not ad_seq:
        # AdaptFormer: on the pre-LN2 stream, joined after the MLP branch
        # outside its dropout and drop-path.
        s_ad = cara_cfg.scale if scale is None else scale
        ad_par = ad_module(x, "mlp", "relu") * s_ad

    # --- MLP (vit.py:835-1087) ---
    if fused_dense:
        u3, v3 = site_uv(2)
        u4, v4 = site_uv(3)
        fc_args = (bp["fc1"]["kernel"], bp["fc1"]["bias"], u3, v3,
                   fold(cb_up))
        fc2_args = (bp["fc2"]["kernel"], bp["fc2"]["bias"], u4, v4,
                    fold(cb_down))
    elif mlp_mega:  # the megakernel without an adapter: zero factors
        hid = cfg.hidden_dim
        zero = x.new_zeros
        fc_args = (bp["fc1"]["kernel"], bp["fc1"]["bias"], zero((e, 1)),
                   zero((1, hid)), zero((hid,)))
        fc2_args = (bp["fc2"]["kernel"], bp["fc2"]["bias"], zero((hid, 1)),
                    zero((1, e)), zero((e,)))
    if mlp_mega:
        mlp_args = (x, *fc_args, *fc2_args, bp["ln2_scale"], bp["ln2_bias"])
        if use_elem:
            return mlp_mod.cp_mlp_block_wd(
                *mlp_args, gate(1), rand["seeds"][2], rand["seeds"][3], 1.0,
                rate, cfg.activation, cfg.layernorm_eps, impl=impl)
        return mlp_mod.cp_mlp_block(*mlp_args, gate(1), 1.0, cfg.activation,
                                    cfg.layernorm_eps, impl=impl)
    if fused_dense:  # LN2 prologue and GELU epilogue in the fc1 site
        if use_elem:
            hidden = dense_mod.cp_dense_ln_wd(
                x, *fc_args, bp["ln2_scale"], bp["ln2_bias"],
                rand["seeds"][2], 1.0, rate, cfg.layernorm_eps, impl=impl,
                act=cfg.activation)
        else:
            hidden = dense_mod.cp_dense_ln(
                x, *fc_args, bp["ln2_scale"], bp["ln2_bias"], 1.0,
                cfg.layernorm_eps, impl=impl, act=cfg.activation)
    else:
        xm = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.layernorm_eps)
        up = _dense(xm, bp["fc1"], impl)
        if lora:
            up = up + lora_delta(xm, 2) * s
        elif use_cara:
            if moe:
                ud = moe_lib.moe_rows_delta_out(xm, p1_up, cara_params,
                                                moe_gates, site_comp(2))
            elif use_elem or materialized:
                ud = cp_ops.rows_delta_out_materialized(
                    xm, p1_up, p2, p3, r2, wmask("fc1"))
            else:
                ud = cp_ops.rows_delta_out_factorized(
                    row_x(xm, 2), p1_up, p2, p3, r2, site_comp(2))
            up = up + (ud + cb_up) * s
        hidden = activation(up, cfg.activation)
    if train and cfg.dropout_rate > 0.0:
        hidden = dropout(hidden, cfg.dropout_rate, masks["do2"])
    if fused_dense and use_elem:
        down = dense_mod.cp_dense_wd(hidden, *fc2_args, rand["seeds"][3],
                                     1.0, rate, impl=impl)
    elif fused_dense:
        down = dense_mod.cp_dense(hidden, *fc2_args, 1.0, impl=impl)
    else:
        down = _dense(hidden, bp["fc2"], impl)
        if lora:
            down = down + lora_delta(hidden, 3) * s
        elif use_cara:
            if moe:
                dd = moe_lib.moe_rows_delta_in(hidden, p1_down, cara_params,
                                               moe_gates, site_comp(3))
            elif use_elem or materialized:
                dd = cp_ops.rows_delta_in_materialized(
                    hidden, p1_down, p2, p3, r2, wmask("fc2"))
            else:
                dd = cp_ops.rows_delta_in_factorized(
                    row_x(hidden, 3), p1_down, p2, p3, r2, site_comp(3))
            down = down + (dd + cb_down) * s
    if ad_seq:
        down = down + ad_module(down, "mlp", "gelu")
    x = branch(down, 1, "do3")
    return x if ad_par is None else x + ad_par


def check_trainable(cfg: ViTConfig, cara_cfg: Optional[CaraConfig]) -> None:
    """Refuse the training routes that are not ported yet, naming where
    they stand in the ROADMAP.  ``cara_cfg=None`` is the forward without
    an adapter (the linear probe and full fine-tuning)."""
    if cara_cfg is None:
        return
    if cara_cfg.method not in ADAPTER_METHODS + ZOO_METHODS:
        raise NotImplementedError(
            f"training method={cara_cfg.method!r} is not yet ported "
            "(ROADMAP.md queue 1: the PEFT zoo)")
    if cara_cfg.moe:
        moe_lib.validate_moe(cara_cfg, train=True)
    if cara_cfg.weight_dropout_impl not in WEIGHT_DROPOUT_IMPLS:
        raise ValueError(
            f"weight_dropout_impl must be one of {WEIGHT_DROPOUT_IMPLS}, "
            f"got {cara_cfg.weight_dropout_impl!r}")


def draw_randomness(cfg: ViTConfig, batch: int, device,
                    generator: Optional[torch.Generator],
                    dtype: torch.dtype = torch.float32,
                    cara_cfg: Optional[CaraConfig] = None,
                    masks: bool = False, attn_impl: str = "fused",
                    dense_impl: str = "fused") -> Dict[str, Any]:
    """Per-layer training randomness: ``seeds`` int32 (depth, 4, 1, 1) —
    the qkv, proj, fc1 and fc2 mask seeds, uniform over
    [-2**31, 2**31 - 1) as ``_wd_seed`` — and ``gates`` (depth, 2, B) in
    ``dtype``: ``bernoulli(1 - r) / (1 - r)`` with r from
    ``linspace(0, drop_path_rate, depth)`` (``_dp_gate``).  With
    ``cara_cfg`` at a rate above 0, the rank route adds ``comp`` (depth,
    4, r) (``_rank_comp``; (depth, 4, X, r) for X experts, ``moe.py``'s
    ``_comp_masks``) and the row route ``rows``, four (depth, K)
    masks for the qkv, proj, fc1 (K = E) and fc2 (K = hidden) sites
    (``_row_u``), all inverted masks in ``dtype``.  The dropout masks
    (:func:`layer_mask_specs` for these impls) are drawn per layer inside
    the forward, or here, one dict a layer under ``masks``, when
    ``masks`` is set: a check that runs one step on several paths hands
    them all the same masks."""
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
    rate = 0.0 if cara_cfg is None else cara_cfg.weight_dropout
    if materialized_delta(cara_cfg):
        rate = 0.0  # element masks on the dense deltas, in ``masks``
    if rate > 0.0 and cara_cfg.weight_dropout_impl == "rank":
        experts = (cara_cfg.moe_experts,) if cara_cfg.moe else ()
        out["comp"] = weight_dropout_mask(
            (depth, 4, *experts, cara_cfg.rank), rate, dtype, generator,
            device)
    elif rate > 0.0 and cara_cfg.weight_dropout_impl == "row":
        e = cfg.embed_dim
        out["rows"] = [weight_dropout_mask((depth, k), rate, dtype,
                                           generator, device)
                       for k in (e, e, e, cfg.hidden_dim)]
    if masks:
        specs = layer_mask_specs(cfg, cara_cfg, batch, attn_impl, dense_impl)
        out["masks"] = [draw_layer_masks(specs, cfg, cara_cfg, generator,
                                         device, dtype)
                        for _ in range(depth)]
    return out


# The matmuls whose outputs the "dots" remat policy keeps
# (``jax.checkpoint_policies.checkpoint_dots``).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return checkpoint_lib.CheckpointPolicy.MUST_SAVE
    return checkpoint_lib.CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(
    checkpoint_lib.create_selective_checkpoint_contexts, _dots_policy)


def resolve_impls(attn_impl: str, dense_impl: str,
                  cara_cfg: Optional[CaraConfig], quantized: bool = False):
    """(attn_impl, dense_impl) of a forward with (``cara_cfg``) or without
    an adapter, "auto" resolved as on the TPU (``_resolve_impls``,
    ``resolve_dense_impl``): the fused attention; the fused dense sites
    with CaRA, the XLA GEMMs without.  Full fine-tuning takes the flash
    attention for "fused" and refuses the fused dense sites, whose
    backward gives the backbone no gradient.  ``quantized`` blocks (int8
    quant dicts) take the XLA dense forms, with or without an adapter,
    and refuse "fused" (``vit.py:1297-1311``).  CaRA at CP order 2 or
    with the materialized delta takes the XLA dense forms, whatever is
    asked: the fused sites consume the rank-space (U, V) pair, which
    neither has (``vit.py:562-563``, ``resolve_dense_impl``).  The PEFT
    zoo's methods (VPT, SSF, BitFit, the bottleneck adapters) have no
    low-rank delta for the fused sites: "auto" resolves to the fused
    attention and the XLA dense forms (``vit.py:1118-1128``), and the
    bottleneck adapters refuse "fused", which has no point to insert them
    at (``vit.py:1271-1276``).  Mixture-of-expert adapters take the XLA
    dense forms and refuse "fused", whose kernels have no expert axis
    (``vit.py:1287-1291``)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    if dense_impl not in DENSE_IMPLS:
        raise ValueError(f"dense_impl must be one of {DENSE_IMPLS}, got "
                         f"{dense_impl!r}")
    method = None if cara_cfg is None else cara_cfg.method
    adapter = method in ADAPTER_METHODS
    attn_impl = "fused" if attn_impl == "auto" else attn_impl
    if adapter and (cara_cfg.cp_order == 2 or materialized_delta(cara_cfg)):
        dense_impl = "xla"
    if cara_cfg is not None and cara_cfg.moe:
        if dense_impl == "fused":
            raise ValueError("MoE adapters require dense_impl='xla' — the "
                             "fused factor kernels have no expert axis")
        dense_impl = "xla"
    if dense_impl == "auto":
        dense_impl = "fused" if adapter and not quantized else "xla"
    if quantized and dense_impl == "fused":
        raise ValueError(
            "int8-quantized weights require dense_impl='xla': the fused "
            "kernels consume dense kernel arrays, not quant dicts")
    if method in BOTTLENECK_METHODS and dense_impl == "fused":
        raise ValueError(
            "bottleneck adapters are nonlinear modules on the XLA "
            "block path — the fused megakernels have no insertion "
            "point for them (dense_impl='fused' would silently skip "
            "the adapters); use dense_impl='auto' or 'xla'")
    if method == "full":
        if dense_impl == "fused":
            raise ValueError(
                "method='full' trains the dense weights; the fused "
                "megakernels' backward emits no backbone-weight "
                "gradients: use dense_impl='auto' or 'xla'")
        if attn_impl == "fused":
            attn_impl = "flash"
    return attn_impl, dense_impl


def vit_forward(params: Params, x: torch.Tensor, cfg: ViTConfig,
                cara_params: Optional[Dict[str, torch.Tensor]] = None,
                cara_cfg: Optional[CaraConfig] = None,
                impl: str = "auto", *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                randomness: Optional[Dict[str, Any]] = None,
                attn_impl: str = "auto",
                dense_impl: str = "auto", remat=False,
                scale_override: Optional[torch.Tensor] = None,
                return_moe_aux: bool = False):
    """Images (B, H, W, C) NHWC -> logits (B, num_classes).

    ``params`` / ``cara_params`` are tensor trees on ``x``'s device (see
    ``models.convert.params_from_numpy``); the forward computes in
    ``x.dtype``.  ``train=True`` runs the training forward (see the
    module docs); its randomness comes from ``randomness`` (as
    :func:`draw_randomness` returns it) or else is drawn from
    ``generator``, the dropout masks one layer at a time.  ``attn_impl``
    ("fused", "flash", "xla" or "auto", the fused one) and
    ``dense_impl`` ("fused", "xla" or "auto", fused with an adapter and
    XLA without or on int8-quantized blocks) pick the block's forms.

    ``remat`` (``vit.py:1435-1441``): True runs each block of a recorded
    training forward under ``torch.utils.checkpoint.checkpoint`` (its
    activations recomputed in the backward), "dots" keeps the matmul
    outputs and recomputes the rest (PyTorch's selective checkpoint
    policy), False keeps everything.  The layer's dropout masks are drawn
    before its checkpointed body, so the recompute sees the same masks;
    every other random input of the block comes from ``randomness``.

    ``scale_override`` (``vit.py:1180``): a 0-d tensor replacing
    ``cara_cfg.scale``, cast to the compute dtype as JAX casts it; it
    rides the collapsed factors (``v * s``, ``cb * s``), so one set of
    kernel calls at scale 1 serves every per-task scale
    (``serving.MultiTaskPredictor``).

    LoRA (``method="lora"``) takes its per-site tree; FacT (``"fact_tt"``,
    ``"fact_tk"``) is expanded into that tree first, under autograd
    (``fact.expand_to_lora``, ``vit.py:1196-1211``), and runs as LoRA.
    SSF and BitFit fold into ``params`` under autograd
    (``vit.py:1212-1237``) and the plain forward runs on the result.
    VPT inserts its prompts after the position embedding (and ``ln_pre``),
    VPT-Deep replaces them before every block, and a mean-pool model
    strips them before its head (``vit.py:1337-1340, 1415-1420,
    1451-1454``).  The bottleneck adapters ride the blocks as per-layer
    slices of their tree (``_block``'s ``ad``).

    Mixture-of-expert adapters (``cara_cfg.moe``, ``models/moe.py``) take
    the {"experts", "router"} tree: the router runs once on the post-stem
    tokens (after the position embedding and ``ln_pre``) and its gates
    ride every block (``vit.py:1360-1368``).  ``return_moe_aux=True``
    returns ``(logits, aux)``, aux the load-balance loss (a 0-d fp32
    zero without MoE), which training adds times ``moe_aux_coef``."""
    if (cara_params is None) != (cara_cfg is None):
        raise ValueError("cara_params and cara_cfg must be provided together")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    prompts = ad_tree = None
    if cara_cfg is not None:
        method = cara_cfg.method
        if method not in ADAPTER_METHODS + ZOO_METHODS:
            raise NotImplementedError(
                f"method={method!r} is not yet ported to cara_tpu_torch "
                "(ROADMAP.md queue 1: the PEFT zoo)")
        if cara_cfg.moe:
            moe_lib.validate_moe(cara_cfg, train=train)
            if not moe_lib.is_moe_params(cara_params):
                raise ValueError(
                    "cara_cfg.moe_experts > 1 wants the {'experts', "
                    "'router'} param tree from models.moe.init_moe_params; "
                    f"got keys {sorted(cara_params)}")
        if method == "ssf":
            if not ssf_lib.is_ssf_params(cara_params):
                raise ValueError(
                    "cara_cfg.method='ssf' wants the (gamma, beta) tree "
                    "from models.ssf.init_ssf_params; got keys "
                    f"{sorted(cara_params)}")
            params = ssf_lib.apply_ssf(params, cara_params)
        elif method == "bitfit":
            if not bitfit_lib.is_bitfit_params(cara_params):
                raise ValueError(
                    "cara_cfg.method='bitfit' wants the bias-delta tree "
                    "from models.bitfit.init_bitfit_params; got keys "
                    f"{sorted(cara_params)}")
            params = bitfit_lib.apply_bitfit(params, cara_params)
        elif method in VPT_METHODS:
            if not vpt_lib.is_vpt_params(cara_params):
                raise ValueError(
                    f"cara_cfg.method={method!r} wants the "
                    "{'prompts'} tree from models.vpt.init_vpt_params; got "
                    f"keys {sorted(cara_params)}")
            vpt_lib.check_geometry(cara_params, cfg, cara_cfg)
            prompts = cara_params["prompts"]
        elif method in BOTTLENECK_METHODS:
            if not adapter_lib.is_adapter_params(cara_params):
                raise ValueError(
                    f"cara_cfg.method={method!r} wants the "
                    "layer-stacked bottleneck tree from "
                    "models.adapter.init_adapter_params; got keys "
                    f"{sorted(cara_params)}")
            adapter_lib.check_geometry(cara_params, cfg, cara_cfg)
            ad_tree = cara_params
        if method in ZOO_METHODS:
            # The tree is consumed: the blocks run without a delta, with
            # ``cara_cfg`` for the zoo's masks and the adapters' settings.
            cara_params = None
        if method in FACT_METHODS:
            if not fact_lib.is_fact_params(cara_params):
                raise ValueError(
                    f"cara_cfg.method={cara_cfg.method!r} wants the shared "
                    "factor tree of models.fact.init_fact_params (U/V + G "
                    f"or P/C); got keys {sorted(cara_params)}")
            cara_params = fact_lib.expand_to_lora(cara_params, cfg, cara_cfg)
            cara_cfg = dataclasses.replace(cara_cfg, method="lora")
        if cara_cfg.method == "lora":
            if not lora_lib.is_lora_params(cara_params):
                raise ValueError(
                    "cara_cfg.method='lora' wants the per-site {a, b} tree "
                    "of models.lora.init_lora_params; got keys "
                    f"{sorted(cara_params)}")
        elif method == "cara" and not cara_cfg.moe and (
                not isinstance(cara_params, dict)
                or "A1" not in cara_params):
            raise ValueError("cara_cfg.method='cara' wants the CP factor tree "
                             "(A1..., P1-P3, R1/R2, bias1-3)")
    attn_impl, dense_impl = resolve_impls(
        attn_impl, dense_impl, cara_cfg,
        quantized=is_quantized(params["blocks"]["qkv"]["kernel"]))
    if train:
        check_trainable(cfg, cara_cfg)
        if randomness is None:
            randomness = draw_randomness(cfg, x.shape[0], x.device,
                                         generator, x.dtype, cara_cfg)
    tokens = patch_embed(params, x, cfg)
    if cfg.use_cls_token:
        cls = params["cls"].to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + params["pos_embed"].to(tokens.dtype)
    if cfg.ln_pre:
        tokens = layer_norm(tokens, params["ln_pre"]["scale"],
                            params["ln_pre"]["bias"], cfg.layernorm_eps)
    pos0 = 1 if cfg.use_cls_token else 0
    deep = prompts is not None and cara_cfg.method == "vpt_deep"
    if prompts is not None:  # between the cls and the patch tokens
        tokens = vpt_lib.insert_prompts(tokens, prompts[0], pos0)
    ad_layers = None if ad_tree is None else _unstack(ad_tree, cfg.depth)
    a1 = p1 = gates = aux = None
    if cara_params is not None and cara_cfg.moe:
        gates, aux = moe_lib.route(tokens, cara_params["router"],
                                   cara_cfg.moe_top_k)
        cara_params = cara_params["experts"]
        a1, p1 = moe_lib.moe_stacked_layer_slices(cara_params, cfg, cara_cfg)
    elif cara_params is not None and cara_cfg.method == "lora":
        # LoRA's layer stacks, one unbind a leaf (see ``_unstack``)
        qkv_stack, rest = lora_lib.layer_stacks(cara_params)
        a1, p1 = _unstack(qkv_stack, cfg.depth), _unstack(rest, cfg.depth)
    elif cara_params is not None:
        a1, p1 = cara_lib.stacked_layer_slices(cara_params, cfg, cara_cfg)
    blocks = _unstack(params["blocks"], cfg.depth)
    if scale_override is not None:
        scale_override = scale_override.to(tokens.dtype)
    remat = remat and train and torch.is_grad_enabled()
    for layer in range(cfg.depth):
        if deep:  # this layer's prompts replace the slots
            tokens = vpt_lib.set_prompts(tokens, prompts[layer], pos0)
        rand = None
        if train:
            rows, masks = randomness.get("rows"), randomness.get("masks")
            rand = {"seeds": randomness["seeds"][layer],
                    "gates": randomness["gates"][layer],
                    "comp": (None if randomness.get("comp") is None
                             else randomness["comp"][layer]),
                    "rows": (None if rows is None
                             else [m[layer] for m in rows]),
                    "masks": None if masks is None else masks[layer],
                    "generator": generator}
            if remat and rand["masks"] is None:
                rand["masks"] = draw_layer_masks(
                    layer_mask_specs(cfg, cara_cfg, tokens.shape[0],
                                     attn_impl, dense_impl),
                    cfg, cara_cfg, generator, tokens.device, tokens.dtype)
        block = functools.partial(
            _block, bp=blocks[layer], f1=None if a1 is None else a1[layer],
            p1=None if p1 is None else p1[layer], cfg=cfg,
            cara_params=cara_params, cara_cfg=cara_cfg, impl=impl,
            rand=rand, attn_impl=attn_impl, dense_impl=dense_impl,
            scale=scale_override,
            ad=None if ad_layers is None else ad_layers[layer],
            moe_gates=gates)
        if remat:
            # Every random input is drawn already: no RNG state to keep.
            tokens = checkpoint_lib.checkpoint(
                block, tokens, use_reentrant=False, preserve_rng_state=False,
                **({"context_fn": _DOTS_CONTEXT} if remat == "dots" else {}))
        else:
            tokens = block(tokens)
    if prompts is not None and not cfg.use_cls_token:
        # mean-pool reads the patch tokens only; the cls row is position 0
        tokens = vpt_lib.strip_prompts(tokens, prompts.shape[1], pos0)
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
    if "head" in params:
        feat = linear(feat, params["head"]["kernel"], params["head"]["bias"])
    if not return_moe_aux:
        return feat
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=feat.device)
    return feat, aux
