"""GPU smoke run of the PyTorch/CUDA port's serving path.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits nonzero without them.  Phases, each
fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the kernels from ``cara_tpu_torch/csrc`` (seconds printed);
3. each kernel wrapper against its plain PyTorch version at ViT-B shapes
   (B=64, N=197, E=768, H=12, hidden 3072, rank 8, bf16 inputs; the plain
   reference runs in fp32 with TF32 off): max |error| against the stated
   tolerance, and the median time of kernel and plain (the plain version
   on the same bf16 inputs) over 20 runs by CUDA events;
4. the serving path: ViT-B/16 in21k at full width and depth from seed 0
   (tanh pre_logits, 10 classes) with a perturbed order-4 rank-8 CaRA
   adapter at scale 10, saved as an npz checkpoint, then served merged
   and unmerged through ``Predictor.from_checkpoint_auto`` and
   ``InferenceServer``: 96 requests from 8 client threads through the
   micro-batcher, ``/healthz`` and ``/stats`` over HTTP, logits against
   the plain forward on the same weights and merged against unmerged,
   images per second at batch 64;
5. every kernel's launch counter grew during phase 4.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.data.vtab import normalize
from cara_tpu_torch.models import convert
from cara_tpu_torch.models.vit import vit_forward
from cara_tpu_torch.ops.cuda import _build
from cara_tpu_torch.ops.cuda import cp_attn_block as attn_mod
from cara_tpu_torch.ops.cuda import cp_mlp as mlp_mod
from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa_mod
from cara_tpu_torch.server import InferenceServer
from cara_tpu_torch.serving import Predictor
from cara_tpu_torch.train.checkpoint import save_model

MODEL = "vit_base_patch16_224_in21k"
KERNEL_MODULES = {
    "fused_qkv_attention": fqa_mod,
    "cp_attn_block": attn_mod,
    "cp_mlp_block": mlp_mod,
}
SOURCES = {
    "fused_qkv_attention": ("cara_tpu_torch/csrc/qkv_attention.cu",
                            "cara_tpu/ops/pallas/fused_qkv_attention.py:200"),
    "cp_attn_block": ("cara_tpu_torch/csrc/cp_site.cu",
                      "cara_tpu/ops/pallas/cp_attn_block.py:305"),
    "cp_mlp_block": ("cara_tpu_torch/csrc/cp_site.cu",
                     "cara_tpu/ops/pallas/cp_mlp.py:253"),
}
# |kernel - fp32 plain| <= ATOL + RTOL * |plain|, elementwise.  The kernel
# rounds its intermediates (qkv, P, z, h) and its output to bf16, the
# reference does not; bf16 keeps 8 bits, so 2e-2 leaves ~4 ulps of room.
KERNEL_TOL = {"fused_qkv_attention": (1e-2, 1e-2),
              "cp_attn_block": (2e-2, 2e-2),
              "cp_mlp_block": (2e-2, 2e-2)}
# Logits: bf16 through 12 layers against fp32 on the same weights.
LOGIT_RTOL = 0.05


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events per run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(dev, b=64, n=197, e=768, heads=12, hidden=3072, r=8,
                  seed=0, n_real=None):
    """bf16 inputs at the main path's shapes, from a seeded generator;
    keys at or past ``n_real`` (default ``n``) are masked."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        t = torch.randn(shape, generator=g, device=dev) * std + mean
        return t.to(torch.bfloat16)

    return dict(
        b=b, n=n, n_real=n if n_real is None else n_real, e=e, heads=heads,
        sm=(e // heads) ** -0.5,
        qkv=rnd(b, n, 3 * e, std=0.6),
        attn=dict(x=rnd(b, n, e), wq=rnd(e, 3 * e, std=0.02),
                  bq=rnd(3 * e, std=0.02), u1=rnd(e, r, std=0.05),
                  v1=rnd(r, 3 * e, std=0.05), wp=rnd(e, e, std=0.02),
                  bp=rnd(e, std=0.02), u2=rnd(e, r, std=0.05),
                  v2=rnd(r, e, std=0.05), cb2=rnd(e, std=0.02),
                  ln_scale=rnd(e, std=0.1, mean=1.0),
                  ln_bias=rnd(e, std=0.1),
                  dpm=torch.ones((b, 1), device=dev, dtype=torch.bfloat16)),
        mlp=dict(x=rnd(b, n, e), w1=rnd(e, hidden, std=0.02),
                 b1=rnd(hidden, std=0.02), u1=rnd(e, r, std=0.05),
                 v1=rnd(r, hidden, std=0.05), cb1=rnd(hidden, std=0.02),
                 w2=rnd(hidden, e, std=0.02), b2=rnd(e, std=0.02),
                 u2=rnd(hidden, r, std=0.05), v2=rnd(r, e, std=0.05),
                 cb2=rnd(e, std=0.02), ln_scale=rnd(e, std=0.1, mean=1.0),
                 ln_bias=rnd(e, std=0.1),
                 dpm=torch.ones((b, 1, 1), device=dev,
                                dtype=torch.bfloat16)))


# Positional tensor arguments of the two block wrappers, in order.
ATTN_ARGS = ("x", "wq", "bq", "u1", "v1", "wp", "bp", "u2", "v2", "cb2",
             "ln_scale", "ln_bias", "dpm")
MLP_ARGS = ("x", "w1", "b1", "u1", "v1", "cb1", "w2", "b2", "u2", "v2",
            "cb2", "ln_scale", "ln_bias", "dpm")


def kernel_calls(inp):
    """name -> (kernel call, plain call on the same inputs, fp32 plain)."""
    h, sm, n = inp["heads"], inp["sm"], inp["n_real"]
    a, m = inp["attn"], inp["mlp"]
    a32 = {k: v.float() for k, v in a.items()}
    m32 = {k: v.float() for k, v in m.items()}
    an, mn = ATTN_ARGS, MLP_ARGS
    qkv = inp["qkv"]
    return {
        "fused_qkv_attention": (
            lambda: fqa_mod.fused_qkv_attention(qkv, h, sm, n),
            lambda: fqa_mod.fused_qkv_attention_plain(qkv, h, sm, n),
            lambda: fqa_mod.fused_qkv_attention_plain(qkv.float(), h, sm,
                                                      n)),
        "cp_attn_block": (
            lambda: attn_mod.cp_attn_block(*(a[k] for k in an), h, sm, n),
            lambda: attn_mod.cp_attn_block_plain(*(a[k] for k in an), h, sm,
                                                 n),
            lambda: attn_mod.cp_attn_block_plain(*(a32[k] for k in an), h,
                                                 sm, n)),
        "cp_mlp_block": (
            lambda: mlp_mod.cp_mlp_block(*(m[k] for k in mn)),
            lambda: mlp_mod.cp_mlp_block_plain(*(m[k] for k in mn)),
            lambda: mlp_mod.cp_mlp_block_plain(*(m32[k] for k in mn))),
    }


def kernel_phase(dev, inp, timed: bool = True) -> dict:
    """Each kernel against its fp32 plain version; returns per-kernel
    ``max_abs_err``, ``ms`` and ``plain_ms``."""
    results = {}
    for name, (kern, plain, ref32) in kernel_calls(inp).items():
        with torch.inference_mode():
            out = kern().float()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ref = ref32()
            err = (out - ref).abs()
            atol, rtol = KERNEL_TOL[name]
            excess = (err - (atol + rtol * ref.abs())).max().item()
            max_err = err.max().item()
            print(f"[kernel] {name}: max|err| {max_err:.3e} vs fp32 plain, "
                  f"tolerance atol {atol} + rtol {rtol}*|ref| "
                  f"({'ok' if excess <= 0 else 'MISS'})", flush=True)
            require(bool(torch.isfinite(out).all()), f"{name}: non-finite")
            require(excess <= 0, f"{name}: kernel disagrees with plain")
            ms = plain_ms = None
            if timed:
                ms = median_ms(kern)
                plain_ms = median_ms(plain)
                print(f"[kernel] {name}: median {ms:.4f} ms, plain "
                      f"(bf16 inputs) {plain_ms:.4f} ms over 20 runs",
                      flush=True)
        results[name] = {"max_abs_err": max_err, "ms": ms,
                         "plain_ms": plain_ms}
    return results


def make_checkpoint(path, model=MODEL, num_classes=10, rank=8, scale=10.0,
                    seed=0, **overrides):
    cfg = get_model_config(model, num_classes=num_classes, **overrides)
    cara_cfg = CaraConfig(rank=rank, scale=scale, cp_order=4)
    params = convert.init_vit_params(cfg, seed)
    cara = convert.perturb_adapter(
        convert.init_cara_params(cfg, cara_cfg, seed + 1), seed + 2)
    meta = {"method": "cara", "scale": scale, "cp_order": 4,
            "weight_dropout": cara_cfg.weight_dropout, "model": model}
    if overrides:
        meta["model_overrides"] = overrides
    save_model(path, params, cara, meta)
    return cfg


def make_images(n, size, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return normalize(raw.astype(np.float32) / 255.0).astype(np.float32)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        require(r.status == 200, f"GET {path}: HTTP {r.status}")
        return json.loads(r.read())


def serve_requests(srv, images, clients=8):
    """Submit every image through the batcher from ``clients`` threads;
    returns the logits in image order."""
    futures = [None] * len(images)
    errors = []

    def client(k):
        try:
            for i in range(k, len(images), clients):
                futures[i] = srv.batcher.submit(images[i])
        except Exception as exc:  # recorded and raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    require(not errors, f"submit failed: {errors}")
    rows = [f.result(timeout=300)[0] for f in futures]
    return np.stack(rows)


def reference_logits(pred, images, chunk=32):
    """fp32 plain forward on the predictor's own (bf16) weights."""
    params = convert.map_floating(pred._params, lambda t: t.float())
    cara = (None if pred._cara is None
            else convert.map_floating(pred._cara, lambda t: t.float()))
    outs = []
    with torch.inference_mode():
        for s in range(0, len(images), chunk):
            x = torch.from_numpy(images[s:s + chunk]).to(pred.device)
            outs.append(vit_forward(
                params, x, pred.cfg, cara_params=cara,
                cara_cfg=pred._cara_cfg, impl="plain").cpu().numpy())
    return np.concatenate(outs)


def serving_phase(dev, ckpt, model, images, batch_size=64, dtype=None,
                  timed=True) -> dict:
    """Serve ``images`` merged and unmerged; returns per-mode logits."""
    dtype = torch.bfloat16 if dtype is None else dtype
    out = {}
    for merge in (True, False):
        mode = "merged" if merge else "adapter"
        pred = Predictor.from_checkpoint_auto(
            ckpt, model, batch_size=batch_size, buckets="auto", merge=merge,
            device=dev, dtype=dtype)
        t0 = time.perf_counter()
        srv = InferenceServer(pred, port=0).start(warmup=True)
        print(f"[serve:{mode}] warmup over buckets {pred.buckets}: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        try:
            logits = serve_requests(srv, images)
            health = _get(srv.port, "/healthz")
            stats = _get(srv.port, "/stats")
        finally:
            srv.close()
        require(health.get("status") == "ok", f"healthz: {health}")
        print(f"[serve:{mode}] /stats {json.dumps(stats)}", flush=True)
        require(stats["requests"] == len(images),
                f"{mode}: {stats['requests']} of {len(images)} answered")
        require(stats["mean_batch_occupancy"] > 1,
                f"{mode}: requests did not coalesce ({stats})")
        require(logits.shape == (len(images), pred.cfg.num_classes),
                f"{mode}: logits shape {logits.shape}")
        require(bool(np.isfinite(logits).all()), f"{mode}: non-finite")
        ref = reference_logits(pred, images)
        err = float(np.abs(logits - ref).max())
        tol = LOGIT_RTOL * float(np.abs(ref).max())
        print(f"[serve:{mode}] max|logits - fp32 plain| {err:.4e}, "
              f"tolerance {tol:.4e} ({LOGIT_RTOL} x max|ref|)", flush=True)
        require(err <= tol, f"{mode}: logits disagree with the plain path")
        if timed:
            batch = images[:batch_size]
            pred.logits(batch)
            iters = 10
            t0 = time.perf_counter()
            for _ in range(iters):
                pred.logits(batch)
            dt = time.perf_counter() - t0
            print(f"[serve:{mode}] {iters * len(batch) / dt:.1f} img/s at "
                  f"batch {len(batch)} (Predictor.logits, host clock, "
                  f"{dt / iters * 1e3:.3f} ms per batch)", flush=True)
        out[mode] = logits
    err = float(np.abs(out["merged"] - out["adapter"]).max())
    tol = LOGIT_RTOL * float(np.abs(out["adapter"]).max())
    print(f"[serve] max|merged - adapter| {err:.4e}, tolerance {tol:.4e}",
          flush=True)
    require(err <= tol, "merged and adapter logits disagree")
    return out


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(nvidia_smi_line(), flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    _build.lib()
    info = _build.BUILD_INFO
    print(f"[build] {_build.BUILD_DIR / _build.LIB_NAME}: "
          f"{info['seconds']:.3f} s (cached={info['cached']})", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}", flush=True)

    results = kernel_phase(dev, kernel_inputs(dev))

    images = make_images(96, 224)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "vit_smoke_seed_0.npz")
        t0 = time.perf_counter()
        make_checkpoint(ckpt)
        print(f"[serve] checkpoint written in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        for mod in KERNEL_MODULES.values():
            mod.LAUNCHES = 0
        serving_phase(dev, ckpt, MODEL, images)
        launches = {k: m.LAUNCHES for k, m in KERNEL_MODULES.items()}
    print(f"[serve] kernel launches on the serving path: {launches}",
          flush=True)
    for name, count in launches.items():
        require(count > 0, f"{name} never launched on the serving path")

    kernels = []
    for name in KERNEL_MODULES:
        src, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **results[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
