"""Checkpoint export CLI (port of ``cara_tpu/cli/export.py``): a full
checkpoint (an npz, or a reference ``.pt``, which needs ``--model``) ->
a merged, adapter-only, full or reference ``.pt`` artifact.

* ``--mode merged`` folds the adapter (CaRA's CP factors, LoRA's pairs,
  FacT's factors, SSF's scales and shifts or BitFit's bias deltas, the
  method from the checkpoint's meta or its tree) into the dense backbone
  (exact in eval): a plain ViT for serving, no adapter cost.  VPT's
  prompts, the bottleneck adapters and a mixture of experts (its
  per-token routing) cannot fold and are refused.  The
  fold runs in fp32 on ``--device`` (the card by default) with TF32 off,
  so the merged weights are those of JAX's fp32 merge.
* ``--mode adapter`` keeps only the adapter tree and the head (an npz
  that both packages' ``load_adapter`` read).
* ``--mode full`` re-saves a (backbone, adapter) pair as one artifact.
* ``--mode torch`` writes the reference's ``.pt`` (a timm state dict with
  ``CP_*``, ``models/torch_export.py``), which its ``--evaluate`` loads;
  a ``.pt`` records no scale (the reference takes it from its task
  table).

The scale and model checks are JAX's: a merged or adapter export needs
the delta scale (from the checkpoint's meta or ``--scale``) and a merge
the model (meta or ``--model``).  ``--mode stablehlo`` is not ported
(ROADMAP.md queue 1: the PEFT zoo); ``--quantize`` and ``--tome-r``
apply to it alone, as in JAX.

    python -m cara_tpu_torch.cli.export --ckpt vit_svhn_*.npz \\
        --out merged.npz --mode merged [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib

import torch

from cara_tpu_torch.cli.common import resolve_device
from cara_tpu_torch.config import get_model_config
from cara_tpu_torch.models import torch_import
from cara_tpu_torch.models.convert import params_from_numpy
from cara_tpu_torch.models.merge import merge_cara
from cara_tpu_torch.models.torch_export import save_torch_checkpoint
from cara_tpu_torch.train import checkpoint as ckpt_lib

_PEFT = "ROADMAP.md queue 1: the PEFT zoo"


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--ckpt", required=True, type=str,
                   help="Input full-model checkpoint (.npz, or a "
                        "reference .pt with --model)")
    p.add_argument("--out", required=True, type=str)
    p.add_argument("--mode", default="merged",
                   choices=["merged", "adapter", "full", "stablehlo",
                            "torch"],
                   help="stablehlo is not yet ported")
    p.add_argument("--model", default=None,
                   help="Model name (default: from checkpoint meta)")
    p.add_argument("--dim", default=32, type=int, help="CP rank")
    p.add_argument("--scale", default=None, type=float,
                   help="Delta scale (default: from checkpoint meta; "
                        "REQUIRED if the checkpoint records none: the "
                        "per-task scale spans 0.1-100 and a wrong default "
                        "silently mis-merges)")
    p.add_argument("--cp-order", default=None, type=int,
                   choices=[2, 3, 4, 5],
                   help="CP order (default: from checkpoint meta)")
    p.add_argument("--device", default=None, type=str,
                   help="Where the merge runs (default: cuda, which needs "
                        "a card)")
    # The stablehlo mode's options, parsed and refused with it.
    p.add_argument("--batch-size", default=64, type=int,
                   help=argparse.SUPPRESS)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"], help=argparse.SUPPRESS)
    p.add_argument("--platforms", default="cpu,tpu", help=argparse.SUPPRESS)
    p.add_argument("--quantize", default=None,
                   choices=[None, "int8", "w8a8"], help=argparse.SUPPRESS)
    p.add_argument("--tome-r", default=0, type=int,
                   help="ToMe token merging: only with --mode stablehlo "
                        "(merge at serve time instead: serve --tome-r)")
    return p.parse_args(argv)


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def main(argv=None) -> str:
    args = parse_args(argv)
    if args.mode == "stablehlo":
        raise SystemExit(f"--mode stablehlo is not yet ported to "
                         f"cara_tpu_torch ({_PEFT})")
    if args.quantize:
        raise SystemExit(
            "--quantize only applies to --mode stablehlo (npz modes keep "
            "full-precision weights; quantize at serve time instead: "
            "serve --quantize)")
    if args.tome_r:
        raise SystemExit(
            "--tome-r only applies to --mode stablehlo (npz modes keep the "
            "exact forward; merge at serve time instead: serve --tome-r)")
    if torch_import.is_torch_checkpoint(args.ckpt):
        # A reference .pt: converted in memory, then exported like an
        # npz; it records no model name and no scale.
        if args.model is None:
            raise SystemExit(".pt import needs --model (torch checkpoints "
                             "record no model name)")
        params, cara_params, info = torch_import.load_torch_checkpoint(
            args.ckpt, get_model_config(args.model))
        meta = {"model": args.model}
        if cara_params is not None:
            meta["cp_order"] = info["cp_order"]
    else:
        params, cara_params, meta = ckpt_lib.load_model(args.ckpt)
    if cara_params is None and args.mode not in ("full", "torch"):
        # torch mode without an adapter: a merged checkpoint exports as a
        # plain timm state dict.
        raise SystemExit("checkpoint has no adapter subtree")
    if args.scale is not None:
        scale = args.scale
    elif "scale" in meta:
        scale = float(meta["scale"])
    elif args.mode in ("full", "torch"):
        scale = None  # re-saved verbatim; a .pt carries no scale
    else:
        raise SystemExit(
            "checkpoint records no delta scale and --scale was not given; "
            "refusing to default to 1.0 (vtab_config scales span 0.1-100, "
            "a wrong scale silently mis-merges the adapter)")

    if args.mode == "torch":
        model_name = args.model or meta.get("model")
        if model_name is None:
            raise SystemExit(
                "checkpoint records no model name and --model was not given")
        mo = {k: v for k, v in meta.get("model_overrides", {}).items()
              if k != "num_classes"}
        cfg = get_model_config(model_name, **mo)
        order = args.cp_order or int(meta.get("cp_order", 0)) or (
            4 if cara_params is None else
            max((int(k[1]) for k in cara_params
                 if len(k) == 2 and k[0] == "A" and k[1].isdigit()),
                default=4))
        if cara_params is not None and "scale" in meta:
            print(f"note: .pt carries no delta scale; upstream --evaluate "
                  f"applies its per-task vtab_config table — this "
                  f"checkpoint was trained with scale={meta['scale']}")
        try:
            save_torch_checkpoint(args.out, params, cara_params, cfg, order)
        except ValueError as exc:
            raise SystemExit(str(exc))
    elif args.mode == "adapter":
        ckpt_lib.save_adapter(args.out, cara_params, params.get("head"),
                              {**meta, "scale": scale})
    elif args.mode == "merged":
        num_classes = params["head"]["kernel"].shape[-1] \
            if "head" in params else 0
        model_name = args.model or meta.get("model")
        if model_name is None:
            raise SystemExit(
                "checkpoint records no model name and --model was not given")
        # Geometry overrides recorded at training time travel in meta;
        # the stored head fixes num_classes regardless.
        mo = {k: v for k, v in meta.get("model_overrides", {}).items()
              if k != "num_classes"}
        cfg = get_model_config(model_name, num_classes=num_classes, **mo)
        try:
            cara_cfg = ckpt_lib.infer_cara_cfg(
                cara_params, meta, scale=scale, cp_order=args.cp_order)
        except (ValueError, NotImplementedError) as exc:
            raise SystemExit(str(exc))
        if cara_cfg.moe:
            raise SystemExit(
                "MoE adapters cannot be merged (per-token routing is "
                "input-dependent); use --mode adapter/full, or --mode "
                "stablehlo which embeds the unmerged forward")
        device = resolve_device(args.device)
        with _no_tf32():
            try:
                merged = merge_cara(
                    params_from_numpy(params, device, torch.float32),
                    params_from_numpy(cara_params, device, torch.float32),
                    cfg, cara_cfg)
            except ValueError as exc:  # VPT, the bottleneck adapters
                raise SystemExit(str(exc))
        ckpt_lib.save_model(args.out, merged, None,
                            {**meta, "merged": True, "scale": scale})
    else:
        ckpt_lib.save_model(args.out, params, cara_params, meta)
    print(f"wrote {args.out} ({args.mode})")
    return args.out


if __name__ == "__main__":
    main()
