"""Model / adapter / training configuration dataclasses (port of
``cara_tpu/config.py``; the same registry and defaults, checked against
the JAX package by ``tests/test_torch_port_config.py``).

The reference (BonnBytes/CaRA) hard-codes ViT-B/16 geometry everywhere
(768 / 12 heads / 12 layers baked into ``src/cara/cara.py:112-125``).  Here every
shape is derived from a :class:`ViTConfig`, so the same adapter code serves
ViT-B/16, ViT-L/16 and CLIP ViT-L/14 (reference has no such generalization —
SURVEY.md section 7 stage 6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Vision-Transformer geometry.

    Defaults reproduce timm ``vit_base_patch16_224_in21k`` as used by the
    reference CLI (``image_classification/vit_cp.py:115,155``): 224x224 input,
    16x16 patches, 12 layers, 768 wide, 12 heads, a 768-wide tanh
    ``pre_logits`` representation layer, and drop-path 0.1.
    """

    image_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    repr_size: Optional[int] = 768
    num_classes: int = 21843
    drop_path_rate: float = 0.1
    dropout_rate: float = 0.0
    attn_dropout_rate: float = 0.0
    layernorm_eps: float = 1e-6
    # Global average pool instead of the CLS token (used by some CLIP variants).
    use_cls_token: bool = True
    # CLIP-style options: LayerNorm before the transformer stack, quickGELU
    # activation, and a final linear projection of the pooled feature.
    ln_pre: bool = False
    activation: str = "gelu"          # "gelu" (exact erf) | "quick_gelu"
    proj_dim: Optional[int] = None

    @property
    def head_dim(self) -> int:
        assert self.embed_dim % self.num_heads == 0
        return self.embed_dim // self.num_heads

    @property
    def hidden_dim(self) -> int:
        return self.embed_dim * self.mlp_ratio

    @property
    def grid_size(self) -> int:
        assert self.image_size % self.patch_size == 0
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)


@dataclasses.dataclass(frozen=True)
class CaraConfig:
    """CP-adapter (CaRA) hyper-parameters.

    Mirrors the config dict consumed by ``cara()`` (``src/cara/cara.py:169-188``):
    ``rank`` == ``--dim``, ``scale``/``l_mu``/``l_std`` come from the per-dataset
    table (``image_classification/vtab_config.py``).  ``cp_order`` generalizes the
    ablation CLI's ``--dims`` flag (``image_classification/dim_experiment.py:356-361``).
    """

    # Adapter family: "cara" (the reference's CP tensorisation), "lora"
    # (per-matrix low-rank adapters at the same four sites — the baseline
    # method the CaRA paper compares against), or "fact_tt"/"fact_tk"
    # (FacT tensor-train / Tucker factor-tuning, AAAI 2023 — the published
    # tensorisation family CaRA generalizes; models/fact.py).  All ride the
    # same training loop, fused Pallas kernels (the megakernels consume
    # collapsed (U, V) factor pairs — FacT/LoRA trees collapse to that form
    # in rank space), merge/export, and serving stack.
    method: str = "cara"
    rank: int = 32
    scale: float = 1.0
    l_mu: float = 1.0
    l_std: float = 0.0
    # Dropout applied to the CP *delta weight* (reference: nn.Dropout(0.1) on the
    # reconstructed tensor, src/cara/cara.py:35,57,81,92 — weight dropout, shared
    # across the batch, NOT activation dropout).
    weight_dropout: float = 0.1
    # CP order of the QKV tensorisation: 4 = published method
    # (dim_experiment.py:275-283); {2,3,5} are the ablations.
    cp_order: int = 4
    # "factorized": never materialize the dense delta — chain of rank-r
    # contractions (the TPU-native path; algorithm family sketched-but-dead in
    # dim_experiment.py:107-183).  "materialized": reconstruct the dense delta
    # exactly like the reference hot loop (cara.py:27-35) — needed for exact
    # weight-dropout semantics and used as the golden path in tests.
    delta_impl: str = "factorized"
    # Training-time weight-dropout semantics on the factorized path:
    # "element" (default): EXACT reference semantics — element-wise Bernoulli
    #   on the dense delta (cara.py:35,57,81,92).  The fused TPU kernels
    #   regenerate the mask tile-wise from a hash of absolute weight
    #   coordinates (never materialized in HBM); the XLA fallback
    #   materializes the masked delta per site (slower, train-only).
    # "rank": structured rank-component dropout (mask over the r axis) —
    #   cheaper, native to the factorized form, but a different regularizer
    #   than the published method.
    # "row": structured input-row dropout — Bernoulli over the K input rows
    #   of each site's effective (in, out) dense delta, applied via
    #   (m 1^T) o (U V^T) == (diag(m) U) V^T, so it runs on the fast
    #   non-wd kernels (no dense cotangent dT = x^T g in backward).
    #   Expectation-equivalent to "element": identical mean AND identical
    #   per-entry marginal variance (p/(1-p) scaled, p = drop rate); only the within-row
    #   covariance differs (element: independent entries, row: fully
    #   correlated along the output axis).  K = 768-3072 independent draws
    #   per site vs the rank impl's r (~8) — far closer to the element
    #   regularizer's granularity at the rank impl's speed (measured 982
    #   vs 892 img/s at ViT-B bs64, benchmarks/RESULTS.md round 5).
    #   SOLUTION QUALITY (measured, tests/test_wd_impl_quality.py): at
    #   rate 0.1 row TIES element on the synthetic full protocol; at the
    #   strong 0.3 rate (--paper-hparams tasks) element measurably wins
    #   at tiny geometry — element stays the default, use row at rates
    #   <= 0.1 when the ~10% speedup matters.  Rank degrades quality at
    #   both rates on that study; treat it as a speed experiment only.
    # Eval is identical for all (dropout off).  delta_impl="materialized"
    # always uses element-wise semantics.
    weight_dropout_impl: str = "element"
    # Mixture-of-expert adapters (framework extension — the reference is a
    # single-adapter method; this is the MoE-LoRA-style generalization, and
    # the carrier of EXPERT PARALLELISM: the expert axis of the stacked
    # adapter params shards over the mesh's ``expert`` axis).
    # ``moe_experts > 1`` trains that many independent CaRA adapters plus a
    # per-token linear router; each token's delta is the gate-weighted sum
    # of its top-k experts' deltas at all four adapter sites.  Requires the
    # factorized delta path, cp_order in {3,4,5}, and rank weight-dropout
    # semantics (models/moe.py docs).
    moe_experts: int = 0
    moe_top_k: int = 2
    # Switch-Transformer-style load-balance auxiliary loss coefficient
    # (scaled dot of per-expert token fraction x mean router prob).
    moe_aux_coef: float = 0.01
    # FacT-TK Tucker block-mode rank rl (the leading axis of the shared
    # core stack C: (rl, r, r)); 0 means "same as rank".  Ignored by every
    # other method.
    fact_core_rank: int = 0
    # VPT prompt-token count P per insertion point (methods "vpt_deep" /
    # "vpt_shallow", models/vpt.py).  Ignored by every other method.
    vpt_tokens: int = 8
    # Internal activation-dropout rate of the bottleneck adapters
    # (methods "adapter"/"adaptformer", models/adapter.py — between the
    # nonlinearity and the up projection; AdaptFormer's official default
    # is 0.1).  Ignored by every other method.
    adapter_dropout: float = 0.0

    #: The full adapter-family set the framework dispatches on.  Beyond
    #: the reference's CaRA and its CP-order ablations, this covers the
    #: published PEFT baselines the CaRA paper compares against:
    #: LoRA (models/lora.py), FacT TT/TK (models/fact.py), VPT deep /
    #: shallow prompt tuning (models/vpt.py), SSF scale-and-shift
    #: (models/ssf.py), BitFit bias tuning (models/bitfit.py), and the
    #: bottleneck-module pair — Houlsby sequential ("adapter") and
    #: AdaptFormer parallel ("adaptformer") (models/adapter.py) — plus the
    #: two universal non-adapter control rows of every PEFT comparison
    #: table: "linear" (linear probe — classifier head only, backbone
    #: frozen) and "full" (full fine-tuning — every backbone weight
    #: trains).  Both have an EMPTY adapter tree; the trainable/frozen
    #: split happens in train.steps.split_trainable.
    METHODS = ("cara", "lora", "fact_tt", "fact_tk",
               "vpt_deep", "vpt_shallow", "ssf", "bitfit",
               "adapter", "adaptformer", "linear", "full")

    def __post_init__(self):
        if self.method not in self.METHODS:
            raise ValueError(
                f"method must be one of {self.METHODS}; got {self.method!r}")
        if self.method != "cara" and self.moe_experts > 1:
            raise ValueError(
                "MoE adapters are CaRA-only (models.moe stacks CP factor "
                "trees); use method='cara' with --moe")
        if (self.method in ("vpt_deep", "vpt_shallow", "ssf", "bitfit",
                            "adapter", "adaptformer", "linear", "full")
                and self.weight_dropout > 0.0):
            raise ValueError(
                f"method={self.method!r} has no delta weight to drop — "
                "weight_dropout applies to the low-rank delta families "
                "(cara/lora/fact); set weight_dropout=0.0 (bottleneck "
                "adapters regularize via adapter_dropout instead)")
        if self.method.startswith("vpt") and self.vpt_tokens < 1:
            raise ValueError(
                f"vpt_tokens must be >= 1, got {self.vpt_tokens}")
        if not 0.0 <= self.adapter_dropout < 1.0:
            raise ValueError(
                f"adapter_dropout must be in [0, 1), got "
                f"{self.adapter_dropout}")

    @property
    def moe(self) -> bool:
        return self.moe_experts > 1

    def trainable_param_count(self, model: ViTConfig) -> int:
        """Number of trainable CP parameters (excl. classifier head).

        For ViT-B/16 order-4 this reproduces the reference's printed count
        ``2526*rank + 4608`` (shapes ``src/cara/cara.py:112-125``, print
        ``image_classification/vit_cp.py:175-183``): rank 32 -> 85,440.
        Only ``method="cara"`` is ported so far; the PEFT zoo's counts
        raise until their modules are.
        """
        if self.method != "cara":
            raise NotImplementedError(
                f"method={self.method!r} is not yet ported to "
                "cara_tpu_torch (CaRA only so far)")
        from cara_tpu_torch.models.cara import cara_param_shapes

        shapes = cara_param_shapes(model, self)
        return sum(int(_prod(s)) for s in shapes.values())


def _prod(xs: Tuple[int, ...]) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


# Model registry: name -> ViTConfig, mirroring the timm names the reference CLI
# accepts via --model (vit_cp.py:115).
MODEL_REGISTRY = {
    "vit_base_patch16_224_in21k": ViTConfig(),
    "vit_base_patch16_224": ViTConfig(repr_size=None, num_classes=1000),
    "vit_large_patch16_224_in21k": ViTConfig(
        embed_dim=1024, depth=24, num_heads=16, repr_size=1024
    ),
    "vit_large_patch14_224_clip": ViTConfig(
        patch_size=14, embed_dim=1024, depth=24, num_heads=16, repr_size=None,
        num_classes=0, ln_pre=True, activation="quick_gelu", proj_dim=768,
        layernorm_eps=1e-5, drop_path_rate=0.0,
    ),
    "vit_huge_patch14_224_in21k": ViTConfig(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16,
        repr_size=1280,
    ),
    "vit_small_patch16_224_in21k": ViTConfig(
        embed_dim=384, depth=12, num_heads=6, repr_size=384),
    # High-resolution fine-tune from the same ViT-B_16.npz (pos-embed is
    # bicubic-resized 14x14 -> 24x24 on load, npz.maybe_resize_pos_embed);
    # 577 tokens — past the full-score VMEM cap, so the blockwise
    # online-softmax attention path auto-engages.
    "vit_base_patch16_384_in21k": ViTConfig(image_size=384),
    "vit_base_patch16_384": ViTConfig(
        image_size=384, repr_size=None, num_classes=1000),
    "vit_base_patch32_224_in21k": ViTConfig(patch_size=32),
    "vit_tiny_patch16_224_in21k": ViTConfig(
        embed_dim=192, depth=12, num_heads=3, repr_size=192),
    # Small geometry for smoke tests / CI (not a reference model).
    "vit_tiny_test": ViTConfig(
        image_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
        repr_size=None, num_classes=10, drop_path_rate=0.1,
    ),
}


def get_model_config(name: str, **overrides) -> ViTConfig:
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown model '{name}'. Known: {sorted(MODEL_REGISTRY)}"
        )
    cfg = MODEL_REGISTRY[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
