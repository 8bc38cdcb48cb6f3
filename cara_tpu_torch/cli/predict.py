"""Batch prediction CLI (port of ``cara_tpu/cli/predict.py``): classify
image files with a trained checkpoint.

Decodes each file with PIL (``data.vtab.load_image_u8``: RGB, bicubic
resize, the reference's normalization), then runs
``Predictor.from_checkpoint_auto`` on ``--device`` (the card by default)
with the adapter folded into the dense weights (``--no-merge`` keeps
it; VPT prompts and bottleneck adapters always stay unfolded), and
prints one JSON line an image: its top-k classes and their logits.
``--tome-r R`` merges R token pairs a layer (``models/tome.py``; merged
path only).  The native C++ decoder that JAX tries first is not ported
(ROADMAP.md queue 1: training modules still to port), nor ``--exported``
(ROADMAP.md queue 1: the PEFT zoo).  A reference ``.pt``
checkpoint needs ``--scale`` when it carries an adapter.

    python -m cara_tpu_torch.cli.predict --ckpt vit_svhn_*.npz \\
        --model vit_base_patch16_224_in21k images/*.png [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cara_tpu_torch.cli.common import resolve_device
from cara_tpu_torch.data.vtab import load_image_u8, normalize
from cara_tpu_torch.serving import Predictor

_MODEL_DEFAULT = "vit_base_patch16_224_in21k"
_PEFT = "ROADMAP.md queue 1: the PEFT zoo"


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("images", nargs="+", help="Image files (jpeg/png)")
    p.add_argument("--ckpt", default=None, type=str)
    p.add_argument("--exported", default=None, type=str,
                   help="not yet ported")
    p.add_argument("--model", default=_MODEL_DEFAULT)
    p.add_argument("--num-classes", default=None, type=int,
                   help="Override (default: inferred from the checkpoint)")
    p.add_argument("--batch-size", default=64, type=int)
    p.add_argument("--no-merge", action="store_true",
                   help="Keep the adapter path instead of folding weights")
    p.add_argument("--scale", default=None, type=float,
                   help="Delta scale (default: from checkpoint meta; "
                        "required if the checkpoint records none)")
    p.add_argument("--top", default=1, type=int, help="Top-k to report")
    p.add_argument("--tome-r", default=0, type=int,
                   help="ToMe token merging: merge this many token pairs "
                        "a layer (models/tome.py); merged path only")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: cuda, which needs a card)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="Serving dtype (the CUDA kernels take bfloat16)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.exported:
        raise SystemExit(f"--exported is not yet ported to cara_tpu_torch "
                         f"({_PEFT})")
    if args.ckpt is None:
        raise SystemExit("pass --ckpt")
    if args.tome_r and args.no_merge:
        raise SystemExit("--tome-r needs the merged dense forward; drop "
                         "--no-merge")
    try:
        pred = Predictor.from_checkpoint_auto(
            args.ckpt, args.model, num_classes=args.num_classes,
            scale=args.scale, merge=not args.no_merge, tome_r=args.tome_r,
            batch_size=args.batch_size, dtype=getattr(torch, args.dtype),
            device=resolve_device(args.device))
    except ValueError as exc:  # e.g. missing delta scale
        raise SystemExit(str(exc))
    size = pred.cfg.image_size
    imgs = np.stack([
        normalize(load_image_u8(p, size).astype(np.float32) / 255.0)
        for p in args.images])
    logits = pred.logits(imgs)
    topk = np.argsort(-logits, axis=-1)[:, :args.top]
    results = []
    for path, classes, lg in zip(args.images, topk, logits):
        rec = {"image": path,
               "classes": classes.tolist(),
               "scores": [round(float(lg[c]), 4) for c in classes]}
        results.append(rec)
        print(json.dumps(rec))
    return results


if __name__ == "__main__":
    main()
