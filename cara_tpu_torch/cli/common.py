"""Shared CLI plumbing of the training entry point (port of
``cara_tpu/cli/common.py``, the subset this slice serves).

Every flag of the JAX package's training CLI is parsed, so a command line
written for it parses here too; the flags whose feature is not ported
yet are refused, with the ROADMAP item that ports them, when they are set
to anything but their default.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from cara_tpu_torch.config import (BOTTLENECK_METHODS, FACT_METHODS,
                                   FOLD_METHODS, NO_ADAPTER, PORTED_METHODS,
                                   VPT_METHODS, ViTConfig)
from cara_tpu_torch.data.vtab import VTAB_TASKS
from cara_tpu_torch.models.vit import WEIGHT_DROPOUT_IMPLS

DATASET_CHOICES = sorted(VTAB_TASKS)

_PEFT = "ROADMAP.md queue 1: the PEFT zoo"
_PARALLEL = "ROADMAP.md queue 1: parallelism"
# dest -> (default, where the feature stands).
UNPORTED = {
    "mesh": (None, _PARALLEL), "hbm_gb": (None, _PARALLEL),
    "dcn_mesh": (None, _PARALLEL), "pipeline": (None, _PARALLEL),
    "fsdp": (False, _PARALLEL), "distributed": (False, _PARALLEL),
}


def add_common_args(p: argparse.ArgumentParser) -> None:
    """The reference's flags (``vit_cp.py:85-116``), the extensions this
    slice serves, ``--device``, and the JAX CLI's other flags (refused
    by :func:`refuse_unported` unless left at their defaults)."""
    p.add_argument("--lr", default=1e-3, type=float, help="Learning rate")
    p.add_argument("--dataset", default="svhn", type=str,
                   choices=DATASET_CHOICES, help="VTAB-1k task to train")
    p.add_argument("--model", type=str, default="vit_base_patch16_224_in21k")
    p.add_argument("--model-override", action="append", default=None,
                   metavar="K=V",
                   help="Override a ViTConfig field of --model (repeatable)")
    p.add_argument("--data-root", default="./data/vtab-1k", type=str)
    p.add_argument("--backbone", default="./ViT-B_16.npz", type=str,
                   help="Google-format npz backbone; random init if missing")
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--batch-size", default=64, type=int)
    p.add_argument("--eval-batch-size", default=256, type=int)
    p.add_argument("--seed", default=None, type=int,
                   help="Override the per-dataset seed from the task table")
    p.add_argument("--synthetic", action="store_true",
                   help="Generated data (no VTAB files needed)")
    p.add_argument("--synthetic-size", default=1000, type=int)
    p.add_argument("--weight-dropout", default=None, type=float,
                   help="Override the task table's weight-dropout rate")
    p.add_argument("--paper-hparams", action="store_true",
                   help="Weight dropout 0.3 on the 8 tasks the reference "
                        "annotates so (explicit --weight-dropout wins)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="Compute dtype (trainables and optimizer stay fp32)")
    p.add_argument("--out-dir", default=".", type=str)
    p.add_argument("--log-every", default=10, type=int)
    p.add_argument("--weight-dropout-impl", default="element",
                   choices=WEIGHT_DROPOUT_IMPLS,
                   help="Weight-dropout semantics: exact element-wise on "
                        "the dense delta (the reference's), or the "
                        "structured rank-component / input-row masks")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: cuda, which needs a card; "
                        "--device cpu runs the plain versions of the "
                        "kernels)")
    # The JAX CLI's other flags: parsed, refused unless at their default.
    p.add_argument("--method", default="cara", type=str,
                   help="cara (the adapter), lora, fact_tt / fact_tk "
                        "(FacT's tensor-train / Tucker factors), vpt_deep "
                        "/ vpt_shallow (prompt tokens), ssf (scale and "
                        "shift), bitfit (bias deltas), adapter / "
                        "adaptformer (Houlsby / AdaptFormer bottleneck "
                        "modules, width --dim), linear (the head over the "
                        "frozen backbone) or full (every weight)")
    p.add_argument("--lora-alpha", default=None, type=float,
                   help="LoRA: delta scale alpha / rank (default alpha = "
                        "rank)")
    p.add_argument("--fact-scale", default=None, type=float,
                   help="FacT: delta scale (default 1.0)")
    p.add_argument("--fact-core-rank", default=0, type=int,
                   help="FacT-TK: Tucker core rank (0: the rank)")
    p.add_argument("--vpt-tokens", default=8, type=int,
                   help="VPT: prompt tokens a stack")
    p.add_argument("--adapter-scale", default=None, type=float,
                   help="Bottleneck adapters: output scale (default 1.0 "
                        "Houlsby, 0.1 AdaptFormer)")
    p.add_argument("--adapter-dropout", default=None, type=float,
                   help="Bottleneck adapters: internal dropout rate "
                        "(default 0 Houlsby, 0.1 AdaptFormer)")
    p.add_argument("--delta-impl", default="factorized",
                   choices=["factorized", "materialized"],
                   help="CP delta path: factorized = rank-space (the "
                        "kernels); materialized = the dense deltas with "
                        "element-wise weight dropout (the reference's "
                        "exact semantics, the XLA dense forms)")
    p.add_argument("--mesh", default=None, type=str)
    p.add_argument("--moe", default=None, type=str, metavar="X[,K]",
                   help="Mixture-of-expert adapters (models/moe.py): X "
                        "CaRA adapters with a per-token top-K router "
                        "(default K=2); implies weight-dropout-impl rank "
                        "and the XLA dense forms")
    p.add_argument("--hbm-gb", default=None, type=float)
    p.add_argument("--dcn-mesh", default=None, type=str)
    p.add_argument("--pipeline", default=None, type=str)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--no-remat", action="store_true",
                   help="Keep every block's activations for the backward "
                        "(default: recompute them where the dense form is "
                        "not the fused one: --method full|linear, "
                        "--dense-impl xla)")
    p.add_argument("--grad-accum", default=1, type=int,
                   help="Microbatches a step: gradients summed in fp32, "
                        "one optimizer update (the batch must divide)")
    p.add_argument("--attn-impl", default="auto",
                   choices=["auto", "fused", "flash", "xla"],
                   help="fused (auto: the attention kernel on the qkv GEMM "
                        "output), flash (the flash kernel on q, k, v; full "
                        "fine-tuning takes it for fused) or xla (the plain "
                        "attention, which attention dropout always takes)")
    p.add_argument("--dense-impl", default="auto",
                   choices=["auto", "fused", "xla"],
                   help="fused (auto with an adapter: the site kernels and "
                        "block megakernels) or xla (GEMMs with the CP delta "
                        "beside them; auto without an adapter)")
    p.add_argument("--wandb", action="store_true",
                   help="Tee the metric lines (with lambda telemetry) to "
                        "wandb where it imports and starts")
    p.add_argument("--memory-report", action="store_true",
                   help="Print the first train step's device memory once")
    p.add_argument("--profile-dir", default=None, type=str,
                   help="Write a torch.profiler Chrome trace of the "
                        "training loop here")
    p.add_argument("--resume-dir", default=None, type=str,
                   help="Resume snapshots: restore the newest at start, "
                        "save one on SIGTERM")
    p.add_argument("--resume-every-steps", default=0, type=int,
                   help="Also save a resume snapshot every N steps")
    p.add_argument("--nan-check", action="store_true",
                   help="Raise FloatingPointError on a NaN or Inf in a "
                        "step's loss, logits or gradients")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--compilation-cache", default=None, type=str,
                   help="Directory of the CUDA kernel build "
                        "(default: $CARA_JIT_CACHE, else build/kernels)")


def refuse_unported(args) -> None:
    for dest, (default, where) in UNPORTED.items():
        if getattr(args, dest, default) != default:
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{flag} is not yet ported to cara_tpu_torch "
                             f"({where})")
    method = getattr(args, "method", "cara")
    if method not in PORTED_METHODS:
        raise SystemExit(f"--method {method} is not yet ported to "
                         f"cara_tpu_torch ({_PEFT})")
    if method == "full" and getattr(args, "dense_impl", "auto") == "fused":
        raise SystemExit(
            "--method full trains the dense weights; the fused megakernels' "
            "backward emits no backbone-weight gradients: use --dense-impl "
            "auto or xla")


def adapter_impl_kwargs(args) -> dict:
    """``build_model`` keyword arguments of the adapter flags
    (``cara_tpu/cli/common.py:197-243``): the weight-dropout impl, the
    method, FacT-TK's ``--fact-core-rank``, VPT's ``--vpt-tokens``, the
    bottleneck adapters' ``--adapter-dropout`` (0.1 for AdaptFormer, 0
    for Houlsby when not given) and ``--moe X[,K]`` (CaRA only; K is
    min(2, X) when not given), which turns the element impl into the rank
    one with a printed note."""
    kw = {"weight_dropout_impl": args.weight_dropout_impl}
    method = getattr(args, "method", "cara")
    if method != "cara":
        kw["method"] = method
    if method == "fact_tk" and getattr(args, "fact_core_rank", 0):
        kw["fact_core_rank"] = args.fact_core_rank
    if method in VPT_METHODS:
        kw["vpt_tokens"] = getattr(args, "vpt_tokens", 8)
    if method in BOTTLENECK_METHODS:
        rate = getattr(args, "adapter_dropout", None)
        if rate is None:
            rate = 0.1 if method == "adaptformer" else 0.0
        kw["adapter_dropout"] = float(rate)
    spec = getattr(args, "moe", None)
    if not spec:
        return kw
    if method != "cara":
        raise SystemExit("--moe is CaRA-only (models.moe stacks CP factor "
                         f"trees); drop --method {method} or --moe")
    try:
        parts = [int(v) for v in spec.split(",")]
    except ValueError:
        raise SystemExit(f"--moe wants 'X[,K]' integers, got {spec!r}")
    if len(parts) not in (1, 2):
        raise SystemExit(f"--moe wants 'X[,K]', got {spec!r}")
    x = parts[0]
    k = parts[1] if len(parts) > 1 else min(2, x)
    if x < 2 or k < 1 or k > x:
        raise SystemExit(
            f"--moe wants X >= 2 experts and 1 <= K <= X, got {spec!r}")
    kw.update(moe_experts=x, moe_top_k=k)
    if kw["weight_dropout_impl"] == "element":
        print("--moe: weight-dropout-impl element -> rank "
              "(MoE semantics, models/moe.py)")
        kw["weight_dropout_impl"] = "rank"
    return kw


def adapter_scale_wd(args, hp_scale: float, hp_wd: float):
    """(delta scale, weight-dropout rate) for ``args.method``
    (``cara_tpu/cli/common.py:248-292``): CaRA keeps the task table's
    values (``--weight-dropout`` overrides the rate); LoRA's scale is
    ``alpha / rank`` (``--lora-alpha``, alpha = rank by default), FacT's
    ``--fact-scale`` (1.0 by default), both with rate 0 unless
    ``--weight-dropout`` is given; VPT, SSF and BitFit have no delta
    weight (scale 1.0, rate 0, ``--weight-dropout`` refused); the
    bottleneck adapters take ``--adapter-scale`` (1.0 Houlsby, 0.1
    AdaptFormer by default) and refuse ``--weight-dropout``
    (``--adapter-dropout`` instead); ``linear`` / ``full`` have no adapter
    at all, so the scale is 1.0, the rate 0 and ``--weight-dropout`` is
    refused."""
    wd_flag = getattr(args, "weight_dropout", None)
    method = getattr(args, "method", "cara")
    if method == "lora":
        alpha = getattr(args, "lora_alpha", None)
        alpha = float(args.dim) if alpha is None else float(alpha)
        return alpha / args.dim, (0.0 if wd_flag is None else wd_flag)
    if method in FACT_METHODS:
        s = getattr(args, "fact_scale", None)
        return (1.0 if s is None else float(s)), (
            0.0 if wd_flag is None else wd_flag)
    if method in VPT_METHODS + FOLD_METHODS:
        if wd_flag:
            raise SystemExit(
                f"--weight-dropout does not apply to --method {method} "
                "(no delta weight to drop)")
        return 1.0, 0.0
    if method in BOTTLENECK_METHODS:
        if wd_flag:
            raise SystemExit(
                f"--weight-dropout does not apply to --method {method} "
                "(bottleneck adapters regularize via --adapter-dropout)")
        s = getattr(args, "adapter_scale", None)
        if s is None:
            s = 0.1 if method == "adaptformer" else 1.0
        return float(s), 0.0
    if method in NO_ADAPTER:
        if wd_flag:
            raise SystemExit(
                f"--weight-dropout does not apply to --method {method} "
                "(no adapter at all)")
        return 1.0, 0.0
    return hp_scale, (hp_wd if wd_flag is None else wd_flag)


def setup_runtime(args) -> None:
    """Process-wide set-up before any kernel runs
    (``cara_tpu/cli/common.py:552-554``): the kernel build cache.  JAX's
    ``--nan-check`` switches on ``jax_debug_nans`` here; the port's check
    is a train-step option (``make_train_step(nan_check=True)``)."""
    from cara_tpu_torch.utils.jit_cache import enable_compilation_cache

    enable_compilation_cache(getattr(args, "compilation_cache", None))


def resolve_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def resolve_device(name) -> torch.device:
    """``--device``; by default the card, and an error where there is
    none: the CPU runs only when asked for."""
    if name is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device found: pass --device cpu to "
                             "run the plain versions of the kernels on the "
                             "CPU")
        return torch.device("cuda")
    return torch.device(name)


def resolve_model_overrides(args) -> dict:
    """``--model-override k=v`` pairs -> a typed ``model_overrides`` dict
    (values parsed by the declared type of the :class:`ViTConfig` field;
    ``none`` -> None for the optional fields)."""
    pairs = getattr(args, "model_override", None)
    if not pairs:
        return {}
    fields = {f.name: f for f in dataclasses.fields(ViTConfig)}
    out = {}
    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep:
            raise SystemExit(f"--model-override wants K=V, got {pair!r}")
        if key not in fields:
            raise SystemExit(
                f"--model-override: ViTConfig has no field {key!r} "
                f"(known: {', '.join(sorted(fields))})")
        default = fields[key].default
        low = raw.strip().lower()
        try:
            if low in ("none", "null"):
                out[key] = None
            elif isinstance(default, bool):
                if low not in ("true", "false", "1", "0"):
                    raise ValueError(raw)
                out[key] = low in ("true", "1")
            elif isinstance(default, int) or default is None:
                out[key] = int(raw)
            elif isinstance(default, float):
                out[key] = float(raw)
            else:
                out[key] = raw
        except ValueError:
            raise SystemExit(f"--model-override {key}: can't parse {raw!r} "
                             f"as {type(default).__name__}")
    return out
