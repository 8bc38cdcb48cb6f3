"""Online inference daemon: HTTP serving with dynamic micro-batching on the
GPU (port of ``cara_tpu/cli/serve.py``, single task).

Run: ``python -m cara_tpu_torch.cli.serve --ckpt vit_cifar_*.npz --port 8000``
(add ``--no-merge`` to keep the adapter unfolded).  The options of the
JAX CLI that serve a StableHLO artifact, several tasks, int8 weights or
ToMe are accepted but refused: those paths are not yet ported.
"""

from __future__ import annotations

import argparse

import torch

from cara_tpu_torch.serving import Predictor


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--ckpt", action="append", default=None,
                   help="Checkpoint (.npz) written by either package")
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
    # JAX-CLI options whose paths are not yet ported: refused below.
    p.add_argument("--exported", default=None, help=argparse.SUPPRESS)
    p.add_argument("--backbone", default=None, help=argparse.SUPPRESS)
    p.add_argument("--quantize", default=None, help=argparse.SUPPRESS)
    p.add_argument("--tome-r", default=0, type=int, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _parse_buckets(spec: str):
    if spec == "auto":
        return "auto"
    if spec == "none":
        return None
    return [int(x) for x in spec.split(",")]


def main(argv=None):
    args = parse_args(argv)
    for flag, value in (("--exported", args.exported),
                        ("--backbone", args.backbone),
                        ("--quantize", args.quantize),
                        ("--tome-r", args.tome_r)):
        if value:
            raise SystemExit(f"{flag} is not yet ported to cara_tpu_torch "
                             "(use python -m cara_tpu.cli.serve)")
    if not args.ckpt:
        raise SystemExit("pass --ckpt")
    if len(args.ckpt) > 1:
        raise SystemExit("multi-task serving (several --ckpt) is not yet "
                         "ported to cara_tpu_torch")
    pred = Predictor.from_checkpoint_auto(
        args.ckpt[0], args.model, num_classes=args.num_classes,
        scale=args.scale, merge=not args.no_merge,
        batch_size=args.max_batch, dtype=getattr(torch, args.dtype),
        device=args.device, buckets=_parse_buckets(args.buckets))

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
