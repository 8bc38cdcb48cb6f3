"""Online inference daemon: HTTP serving with dynamic micro-batching on the
GPU (port of ``cara_tpu/cli/serve.py``).

Run: ``python -m cara_tpu_torch.cli.serve --ckpt vit_cifar_*.npz --port 8000``
(add ``--no-merge`` to keep the adapter unfolded; VPT prompts and
bottleneck adapters are never folded; a reference ``.pt`` needs
``--scale``).  ``--quantize int8`` serves int8 block weights
(weight-only), ``--quantize w8a8`` int8 activations too
(``models/quant.py``); with ``CARA_INT8_PALLAS=1`` in the environment the
weight-only GEMMs run the dequant-fused int8 kernel on the card (TPU row
18).  Several ``--ckpt`` (each ``name=path``, or a path named by the
dataset in its meta) serve those task adapters over one shared backbone
(``serving.MultiTaskPredictor``; ``--backbone X.npz`` where every
checkpoint is adapter-only): ``POST /predict?task=<name>``.  ``--tome-r
R`` serves one merged checkpoint with ToMe token merging
(``models/tome.py``).  ``--exported`` (a StableHLO artifact) is accepted
but refused, naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse

import torch

from cara_tpu_torch.serving import MultiTaskPredictor, Predictor

_PEFT = "ROADMAP.md queue 1: the PEFT zoo"


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--ckpt", action="append", default=None,
                   help="Checkpoint (.npz written by either package, or a "
                        "reference .pt); repeat as name=path to serve "
                        "several tasks over one backbone")
    p.add_argument("--model", default="vit_base_patch16_224_in21k")
    p.add_argument("--num-classes", default=None, type=int)
    p.add_argument("--scale", default=None, type=float,
                   help="Delta scale (default: from checkpoint meta)")
    p.add_argument("--device", default="cuda",
                   help="torch device the weights live on")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="serving dtype (the CUDA kernels take bfloat16)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8000, type=int)
    p.add_argument("--max-batch", default=64, type=int,
                   help="largest batch per device call")
    p.add_argument("--max-wait-ms", default=2.0, type=float,
                   help="How long the first request in a batch waits for "
                        "co-riders (0 = serve singles immediately)")
    p.add_argument("--max-wait-cap-ms", default=None, type=float,
                   help="Hard bound on adaptive batch collection (default "
                        "4x --max-wait-ms)")
    p.add_argument("--top", default=5, type=int)
    p.add_argument("--request-timeout", default=120.0, type=float,
                   help="per-request inference wait cap (seconds)")
    p.add_argument("--buckets", default="auto",
                   help="batch buckets: 'auto' (powers of 4 up to "
                        "--max-batch), 'none' (one full-size bucket), or "
                        "CSV sizes e.g. 1,8,64")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the pre-serve run of every bucket (the first "
                        "request then pays the kernel build)")
    p.add_argument("--no-merge", action="store_true",
                   help="Keep the adapter path instead of folding weights")
    p.add_argument("--quantize", default=None, choices=["int8", "w8a8"],
                   help="int8 block weights: 'int8' weight-only (with "
                        "CARA_INT8_PALLAS=1 through the dequant-fused "
                        "kernel), 'w8a8' int8 activations too")
    # JAX-CLI options whose paths are not yet ported: refused below.
    p.add_argument("--exported", default=None, help=argparse.SUPPRESS)
    p.add_argument("--backbone", default=None,
                   help="Multi-task: the shared backbone npz when every "
                        "--ckpt is adapter-only")
    p.add_argument("--tome-r", default=0, type=int,
                   help="ToMe token merging: merge this many token pairs "
                        "a layer (models/tome.py); single-task merged "
                        "serving only")
    return p.parse_args(argv)


def _task_name(spec: str) -> tuple:
    """'name=path' -> (name, path); a bare path -> (the dataset in its
    meta, or its stem; path).  A bare path that holds '=' (runs/lr=1e-3/
    best.npz) is recognized by existing on disk and never split."""
    import json
    import os

    import numpy as np

    if "=" in spec and not os.path.exists(spec):
        return tuple(spec.split("=", 1))
    name = None
    try:
        with np.load(spec) as z:
            if "__meta__" in z.files:
                name = json.loads(
                    bytes(z["__meta__"].tolist()).decode()).get("dataset")
    except Exception:
        pass
    return (name or os.path.splitext(os.path.basename(spec))[0], spec)


def _parse_buckets(spec: str):
    if spec == "auto":
        return "auto"
    if spec == "none":
        return None
    return [int(x) for x in spec.split(",")]


def main(argv=None):
    args = parse_args(argv)
    if args.exported:
        raise SystemExit(f"--exported is not yet ported to cara_tpu_torch "
                         f"({_PEFT}; use python -m cara_tpu.cli.serve)")
    if not args.ckpt:
        raise SystemExit("pass --ckpt")
    if args.tome_r and (args.no_merge or len(args.ckpt) > 1):
        raise SystemExit("--tome-r serves a single merged checkpoint (not "
                         "--exported / --no-merge / multi-task: token "
                         "merging needs the dense in-process forward)")
    kw = dict(batch_size=args.max_batch, dtype=getattr(torch, args.dtype),
              device=args.device, buckets=_parse_buckets(args.buckets),
              quantize=args.quantize)
    if len(args.ckpt) > 1:
        if args.no_merge:
            raise SystemExit("--no-merge is a single-task option "
                             "(multi-task serving always runs the "
                             "shared-backbone adapter path)")
        if args.scale is not None or args.num_classes is not None:
            raise SystemExit("--scale/--num-classes are single-task "
                             "options; per-task scale/head come from each "
                             "checkpoint's meta in multi-task mode")
        named = [_task_name(c) for c in args.ckpt]
        ckpts = dict(named)
        if len(ckpts) != len(named):
            dupes = sorted({n for n, _ in named
                            if sum(1 for m, _ in named if m == n) > 1})
            raise SystemExit(
                f"duplicate task name(s) {dupes} — disambiguate with "
                "explicit name=path specs")
        pred = MultiTaskPredictor.from_checkpoints(
            ckpts, args.model, backbone=args.backbone, **kw)
        print(f"multi-task: {len(ckpts)} adapters over one backbone "
              f"({', '.join(ckpts)})", flush=True)
    else:
        pred = Predictor.from_checkpoint_auto(
            args.ckpt[0], args.model, num_classes=args.num_classes,
            scale=args.scale, merge=not args.no_merge,
            tome_r=args.tome_r, **kw)

    from cara_tpu_torch.server import InferenceServer

    srv = InferenceServer(pred, host=args.host, port=args.port,
                          max_wait_ms=args.max_wait_ms, top=args.top,
                          request_timeout_s=args.request_timeout,
                          max_wait_cap_ms=args.max_wait_cap_ms)
    if not args.no_warmup:
        print("warming up (building the kernels, running every bucket)...",
              flush=True)
        pred.warmup()
    print(f"serving on http://{args.host}:{srv.port}  "
          f"(max_batch={args.max_batch}, wait={args.max_wait_ms}ms)",
          flush=True)
    import signal
    import threading

    def _term(signum, frame):  # systemd/k8s stop -> same path as Ctrl-C
        raise KeyboardInterrupt

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _term)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.close()
    return 0


if __name__ == "__main__":
    main()
