"""GPU smoke run of the PyTorch/CUDA port: serving and training.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits nonzero without them.  Phases, each
fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the kernels from ``cara_tpu_torch/csrc`` (seconds printed);
3. each kernel wrapper against its plain PyTorch version at ViT-B shapes
   (B=64, N=197, E=768, H=12, hidden 3072, rank 8, bf16 inputs, drop rate
   0.1, two drop-path gates zero for the training kernels; the plain
   reference runs in fp32 with TF32 off): max |error| against the stated
   tolerance, the weight-dropout fold's keep pattern against the plain
   mask bit for bit, and the median time of kernel and plain (the plain
   version on the same bf16 inputs) over 20 runs by CUDA events;
4. the serving path: ViT-B/16 in21k at full width and depth from seed 0
   (tanh pre_logits, 10 classes) with a perturbed order-4 rank-8 CaRA
   adapter at scale 10, saved as an npz checkpoint, then served merged
   and unmerged through ``Predictor.from_checkpoint_auto`` and
   ``InferenceServer``: 96 requests from 8 client threads through the
   micro-batcher, ``/healthz`` and ``/stats`` over HTTP, logits against
   the plain forward on the same weights and merged against unmerged,
   images per second at batch 64; every serving kernel's launch counter
   grew;
5. the training path: ViT-B/16 in21k at full width and depth from seed 0,
   CaRA order 4 rank 8, weight dropout 0.1 (element-wise), drop-path 0.1,
   bf16 compute with fp32 trainables, batch 64: (a) one step's gradients
   of every trainable leaf through the kernels against the fp32 plain
   path on the same weights and the same injected randomness, (b) 30
   steps on one fixed synthetic batch (finite, falling loss), (c) ms per
   step by CUDA events, img/s on the host clock and the plain path's ms
   per step, (d) ``cli.vit_cp --synthetic`` for a few epochs, whose best
   checkpoint ``Predictor.from_checkpoint_auto`` then serves; every
   training kernel's launch counter grew.

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

from cara_tpu_torch.cli import vit_cp as vit_cp_cli
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.data.vtab import normalize
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import vit as vit_lib
from cara_tpu_torch.models.vit import vit_forward
from cara_tpu_torch.ops.cuda import _build, wd_fold
from cara_tpu_torch.ops.cuda import cp_attn_block as attn_mod
from cara_tpu_torch.ops.cuda import cp_mlp as mlp_mod
from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa_mod
from cara_tpu_torch.server import InferenceServer
from cara_tpu_torch.serving import Predictor
from cara_tpu_torch.train import steps as steps_lib
from cara_tpu_torch.train.checkpoint import save_model

MODEL = "vit_base_patch16_224_in21k"
# name -> (module, launch counter, source, TPU kernel replaced).
KERNELS = {
    "fused_qkv_attention": (
        fqa_mod, "LAUNCHES", "cara_tpu_torch/csrc/qkv_attention.cu",
        "cara_tpu/ops/pallas/fused_qkv_attention.py:200"),
    "cp_attn_block": (
        attn_mod, "LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_attn_block.py:305"),
    "cp_mlp_block": (
        mlp_mod, "LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:253"),
    "build_wd_weight": (
        wd_fold, "LAUNCHES", "cara_tpu_torch/csrc/wd_fold.cu",
        "cara_tpu/ops/pallas/cp_dense.py:565"),
    "cp_attn_block_wd": (
        attn_mod, "WD_LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_attn_block.py:521"),
    "cp_attn_block_wd_bwd": (
        attn_mod, "WD_BWD_LAUNCHES",
        "cara_tpu_torch/csrc/qkv_attention_bwd.cu",
        "cara_tpu/ops/pallas/cp_attn_block.py:578"),
    "cp_mlp_block_wd_bwd": (
        mlp_mod, "WD_BWD_LAUNCHES", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:579"),
}
SERVING_KERNELS = ("fused_qkv_attention", "cp_attn_block", "cp_mlp_block")
TRAINING_KERNELS = ("build_wd_weight", "cp_attn_block_wd",
                    "cp_attn_block_wd_bwd", "cp_mlp_block_wd_bwd")
# |kernel - fp32 plain| <= ATOL + RTOL * |ref|, elementwise.  The kernels
# round their intermediates (qkv, P, z, h; in the backward do, dqkv, ds,
# dpre) and their outputs to bf16, the reference does not; bf16 keeps 8
# bits, so 2e-2 leaves ~4 ulps of room, 5e-2 for the backward's dx, which
# passes three rounded products.  The fold's only rounding is its output.
KERNEL_TOL = {"fused_qkv_attention": (1e-2, 1e-2),
              "cp_attn_block": (2e-2, 2e-2),
              "cp_mlp_block": (2e-2, 2e-2),
              "build_wd_weight": (1e-3, 1e-2),
              "cp_attn_block_wd": (2e-2, 2e-2),
              "cp_attn_block_wd_bwd": (5e-2, 5e-2),
              "cp_mlp_block_wd_bwd": (5e-2, 5e-2)}
# Factor and bias gradients reduce over B*N = 12608 rows of bf16
# products: held by ||kernel - ref|| / ||ref|| (relative L2).
GRAD_REL_L2 = 2e-2
# Logits: bf16 through 12 layers against fp32 on the same weights.
LOGIT_RTOL = 0.05
# One train step's gradient of each trainable leaf, bf16 kernels against
# the fp32 plain path: relative L2.  The error of bf16 rounding (2^-8) at
# every rounded intermediate, forward and backward, through 12 layers; a
# wrong mask, gate or missing term shows as O(1).
TRAIN_GRAD_REL_L2 = 5e-2
DROP_RATE = 0.1


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
                  seed=0, n_real=None, zero_gates=2):
    """bf16 inputs at the main path's shapes, from a seeded generator;
    keys at or past ``n_real`` (default ``n``) are masked.  The training
    kernels get drop-path gates ``1/(1-p)`` with the first ``zero_gates``
    images dropped, four int32 mask seeds and output cotangents."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        t = torch.randn(shape, generator=g, device=dev) * std + mean
        return t.to(torch.bfloat16)

    gates = torch.full((b, 1), 1.0 / (1.0 - DROP_RATE), device=dev)
    gates[:zero_gates] = 0.0
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (4, 1, 1), generator=g,
                          device=dev, dtype=torch.int32)
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
                                dtype=torch.bfloat16)),
        gates=gates.to(torch.bfloat16), seeds=list(seeds),
        g_attn=rnd(b, n, e), g_mlp=rnd(b, n, e))


# Positional tensor arguments of the two block wrappers, in order, and
# the inputs the training wrappers differentiate.
ATTN_ARGS = ("x", "wq", "bq", "u1", "v1", "wp", "bp", "u2", "v2", "cb2",
             "ln_scale", "ln_bias", "dpm")
MLP_ARGS = ("x", "w1", "b1", "u1", "v1", "cb1", "w2", "b2", "u2", "v2",
            "cb2", "ln_scale", "ln_bias", "dpm")
ATTN_DIFF = ("x", "u1", "v1", "u2", "v2", "cb2")
MLP_DIFF = ("x", "u1", "v1", "cb1", "u2", "v2", "cb2")
FOLD_SITES = ("qkv", "proj", "fc1", "fc2")


def _fold_sites(inp):
    a, m, sd = inp["attn"], inp["mlp"], inp["seeds"]
    return {"qkv": (a["wq"], a["u1"], a["v1"], sd[0]),
            "proj": (a["wp"], a["u2"], a["v2"], sd[1]),
            "fc1": (m["w1"], m["u1"], m["v1"], sd[2]),
            "fc2": (m["w2"], m["u2"], m["v2"], sd[3])}


def _grad_call(block, args, diff, inp_tree, g, impl, dtype):
    """One forward of a training block (its graph kept), returning a call
    that runs only its backward: name -> gradient."""
    leaves = {k: v.detach().to(dtype).requires_grad_(k in diff)
              if v.is_floating_point() else v for k, v in inp_tree.items()}
    out = block(*(leaves[k] for k in args), impl=impl)
    grad_out = g.to(dtype)
    wrt = [leaves[k] for k in diff]
    return lambda: dict(zip(diff, torch.autograd.grad(
        out, wrt, grad_out, retain_graph=True)))


def kernel_calls(inp):
    """name -> (kernel call, plain call on the same inputs, fp32 plain);
    each returns a tensor or a dict of tensors."""
    h, sm, n = inp["heads"], inp["sm"], inp["n_real"]
    a, m = inp["attn"], inp["mlp"]
    a32 = {k: v.float() for k, v in a.items()}
    m32 = {k: v.float() for k, v in m.items()}
    an, mn = ATTN_ARGS, MLP_ARGS
    qkv = inp["qkv"]
    s1, s2, s3, s4 = inp["seeds"]
    rate = DROP_RATE
    sites = _fold_sites(inp)
    aw = dict(a, dpm=inp["gates"])
    mw = dict(m, dpm=inp["gates"].reshape(-1, 1, 1))
    aw32 = {k: v.float() for k, v in aw.items()}

    def attn_wd(*args, impl="auto"):
        return attn_mod.cp_attn_block_wd(*args, s1, s2, h, sm, n, 1.0, rate,
                                         impl=impl)

    def mlp_wd(*args, impl="auto"):
        return mlp_mod.cp_mlp_block_wd(*args, s3, s4, 1.0, rate, impl=impl)

    def attn_bwd(impl, dtype):
        return _grad_call(attn_wd, an, ATTN_DIFF, aw, inp["g_attn"], impl,
                          dtype)

    def mlp_bwd(impl, dtype):
        return _grad_call(mlp_wd, mn, MLP_DIFF, mw, inp["g_mlp"], impl,
                          dtype)

    bf = torch.bfloat16
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
        "build_wd_weight": (
            lambda: {k: wd_fold.build_wd_weight(w, u, v, sd, 1.0, rate)
                     for k, (w, u, v, sd) in sites.items()},
            lambda: {k: wd_fold.build_wd_weight_plain(w, u, v, sd, 1.0, rate)
                     for k, (w, u, v, sd) in sites.items()},
            lambda: {k: wd_fold.build_wd_weight_plain(
                w.float(), u.float(), v.float(), sd, 1.0, rate)
                for k, (w, u, v, sd) in sites.items()}),
        "cp_attn_block_wd": (
            lambda: attn_wd(*(aw[k] for k in an)),
            lambda: attn_mod.cp_attn_block_wd_plain(
                *(aw[k] for k in an), s1, s2, h, sm, n, 1.0, rate),
            lambda: attn_mod.cp_attn_block_wd_plain(
                *(aw32[k] for k in an), s1, s2, h, sm, n, 1.0, rate)),
        "cp_attn_block_wd_bwd": (attn_bwd("auto", bf), attn_bwd("plain", bf),
                                 attn_bwd("plain", torch.float32)),
        "cp_mlp_block_wd_bwd": (mlp_bwd("auto", bf), mlp_bwd("plain", bf),
                                mlp_bwd("plain", torch.float32)),
    }


def rel_l2(out, ref) -> float:
    return ((out.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def _check_outputs(name, out, ref) -> float:
    """Elementwise bound for tensors, the fold's weights and a backward's
    dx; relative L2 for the factor and bias gradients.  Returns the max
    |err| of the elementwise-checked outputs."""
    if not isinstance(out, dict):
        out, ref = {"out": out}, {"out": ref}
    atol, rtol = KERNEL_TOL[name]
    max_err = 0.0
    for key in out:
        o, r = out[key].float(), ref[key].float()
        require(o.shape == r.shape, f"{name}/{key}: shape {tuple(o.shape)}")
        require(bool(torch.isfinite(o).all()), f"{name}/{key}: non-finite")
        if key in ("out", "x") or name == "build_wd_weight":
            err = (o - r).abs()
            excess = (err - (atol + rtol * r.abs())).max().item()
            max_err = max(max_err, err.max().item())
            print(f"[kernel] {name}/{key}: max|err| {err.max().item():.3e} "
                  f"vs fp32 plain, tolerance atol {atol} + rtol {rtol}*|ref| "
                  f"({'ok' if excess <= 0 else 'MISS'})", flush=True)
            require(excess <= 0, f"{name}/{key}: kernel disagrees with plain")
        else:
            rel = rel_l2(o, r)
            print(f"[kernel] {name}/{key}: relative L2 {rel:.3e} vs fp32 "
                  f"plain, bound {GRAD_REL_L2} "
                  f"({'ok' if rel <= GRAD_REL_L2 else 'MISS'})", flush=True)
            require(rel <= GRAD_REL_L2, f"{name}/{key}: kernel disagrees "
                    "with plain")
    return max_err


def wd_keep_check(dev, inp) -> int:
    """The fold's keep pattern against the plain mask, bit for bit: with
    W = 0, U = V = 1 an output element is nonzero exactly where kept."""
    checked = 0
    for site, (w, u, v, sd) in _fold_sites(inp).items():
        k, nn = w.shape
        r = u.shape[1]
        ones_u = torch.ones((k, r), device=dev, dtype=torch.bfloat16)
        ones_v = torch.ones((r, nn), device=dev, dtype=torch.bfloat16)
        out = wd_fold.build_wd_weight(torch.zeros_like(w), ones_u, ones_v,
                                      sd, 1.0, DROP_RATE)
        keep = wd_fold.hash_keep_plain(0, 0, k, nn, sd, DROP_RATE, dev)
        same = bool(torch.equal(out != 0, keep))
        print(f"[kernel] build_wd_weight/{site}: keep pattern of {k}x{nn} "
              f"{'equals' if same else 'DIFFERS from'} the plain mask "
              f"(kept {keep.float().mean().item():.4f})", flush=True)
        require(same, f"build_wd_weight/{site}: keep pattern differs")
        checked += keep.numel()
    return checked


def kernel_phase(dev, inp, timed: bool = True) -> dict:
    """Each kernel against its fp32 plain version; returns per-kernel
    ``max_abs_err``, ``ms`` and ``plain_ms``."""
    wd_keep_check(dev, inp)
    results = {}
    for name, (kern, plain, ref32) in kernel_calls(inp).items():
        out = kern()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        max_err = _check_outputs(name, out, ref32())
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


def reset_launches() -> None:
    for mod, attr, _, _ in KERNELS.values():
        setattr(mod, attr, 0)


def read_launches(names) -> dict:
    return {k: getattr(KERNELS[k][0], KERNELS[k][1]) for k in names}


def train_setup(dev, model=MODEL, num_classes=10, rank=8, scale=10.0,
                batch=64, seed=0):
    """Seeded ViT + perturbed CaRA adapter (element-wise weight dropout
    0.1, the model's drop-path) -> (cfg, cara_cfg, fp32 frozen, state,
    one fixed device batch of normalized images)."""
    cfg = get_model_config(model, num_classes=num_classes)
    cara_cfg = CaraConfig(rank=rank, scale=scale, weight_dropout=DROP_RATE)
    params = convert.init_vit_params(cfg, seed)
    cara = convert.perturb_adapter(
        convert.init_cara_params(cfg, cara_cfg, seed + 1), seed + 2)
    frozen, state = steps_lib.init_train_state(
        params, cara, dev, 1e-3, steps_per_epoch=1, total_epochs=100)
    rng = np.random.default_rng(seed + 3)
    data = {"image": torch.from_numpy(make_images(batch, cfg.image_size,
                                                  seed + 4)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, num_classes, batch).astype(np.int64)).to(dev)}
    return cfg, cara_cfg, frozen, state, data


def grad_check(dev, cfg, cara_cfg, frozen, state, data, generator,
               dtype=torch.bfloat16) -> dict:
    """(a) One step's gradients of every trainable leaf through the
    kernels (``dtype`` compute) against the fp32 plain path on the same
    (``dtype``-rounded) backbone and the same drop-path gates and mask
    seeds; relative L2 per leaf against ``TRAIN_GRAD_REL_L2``."""
    rand = vit_lib.draw_randomness(cfg, data["image"].shape[0], dev,
                                   generator, dtype)
    frozen_c = steps_lib.cast_floating(frozen, dtype)
    loss, _, grads = steps_lib.loss_and_grads(
        cfg, cara_cfg, state.trainable, frozen_c, data, compute_dtype=dtype,
        randomness=rand)
    rand32 = {"seeds": rand["seeds"], "gates": rand["gates"].float()}
    ref_loss, _, ref_grads = steps_lib.loss_and_grads(
        cfg, cara_cfg, state.trainable,
        steps_lib.cast_floating(frozen_c, torch.float32), data,
        impl="plain", randomness=rand32)
    paths = [p for p, _ in steps_lib.tree_leaves(state.trainable)]
    worst = 0.0
    for path, g, ref in zip(paths, grads, ref_grads):
        rel = rel_l2(g, ref)
        worst = max(worst, rel)
        require(bool(torch.isfinite(g).all()), f"grad {path}: non-finite")
        print(f"[train] grad {path}: relative L2 {rel:.3e} vs fp32 plain "
              f"(|ref| {ref.norm().item():.3e})", flush=True)
    print(f"[train] loss {loss.item():.6f}, fp32 plain {ref_loss.item():.6f};"
          f" worst gradient relative L2 {worst:.3e}, bound "
          f"{TRAIN_GRAD_REL_L2}", flush=True)
    require(worst <= TRAIN_GRAD_REL_L2, "train-step gradients disagree "
            "with the fp32 plain path")
    return {"worst_grad_rel_l2": worst, "loss": loss.item(),
            "plain_loss": ref_loss.item()}


def fixed_batch_steps(cfg, cara_cfg, frozen, state, data, generator, steps,
                      dtype=torch.bfloat16, impl="auto", timed=True):
    """(b, c) ``steps`` train steps on one fixed batch: the losses, the
    median device ms per step (CUDA events) and img/s on the host clock
    (synchronized at both ends)."""
    step_fn = steps_lib.make_train_step(cfg, cara_cfg, compute_dtype=dtype,
                                        impl=impl)
    frozen_c = steps_lib.cast_floating(frozen, dtype)
    losses, times = [], []
    if timed:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        state, metrics = step_fn(state, frozen_c, data, generator=generator)
        if timed:
            end.record()
            times.append((start, end))
        losses.append(metrics["loss"])
    if timed:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    ms = ([s.elapsed_time(e) for s, e in times] if timed else [])
    return state, losses, ms, wall


def training_phase(dev, timed=True, steps=30, plain_steps=3, batch=64,
                   model=MODEL) -> dict:
    """(a) gradients against the fp32 plain path, (b) a falling loss over
    ``steps`` steps on a fixed batch, (c) ms per step and img/s, kernel
    and plain, (d) ``cli.vit_cp --synthetic`` whose best checkpoint is
    served.  Launch counters are read for (b)-(d)."""
    cfg, cara_cfg, frozen, state, data = train_setup(dev, model=model,
                                                     batch=batch)
    print(f"[train] {model}: depth {cfg.depth}, E {cfg.embed_dim}, heads "
          f"{cfg.num_heads}, rank {cara_cfg.rank}, weight dropout "
          f"{cara_cfg.weight_dropout} (element), drop-path "
          f"{cfg.drop_path_rate}, batch {batch}, bf16", flush=True)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    out = grad_check(dev, cfg, cara_cfg, frozen, state, data, generator)

    reset_launches()
    state, losses, ms, wall = fixed_batch_steps(
        cfg, cara_cfg, frozen, state, data, generator, steps, timed=timed)
    print(f"[train] loss over {steps} steps on one batch: "
          + " ".join(f"{v:.4f}" for v in losses), flush=True)
    require(all(np.isfinite(losses)), "non-finite training loss")
    require(losses[-1] < losses[0], "the loss did not fall")
    out["losses"] = losses
    if timed:
        steady = ms[5:] if len(ms) > 8 else ms
        out["ms_per_step"] = statistics.median(steady)
        out["img_per_s"] = steps * batch / wall
        _, _, pms, _ = fixed_batch_steps(cfg, cara_cfg, frozen, state, data,
                                         generator, plain_steps,
                                         impl="plain")
        out["plain_ms_per_step"] = statistics.median(pms[1:] or pms)
        print(f"[train] median {out['ms_per_step']:.3f} ms per step (CUDA "
              f"events, steps 6-{steps}), {out['img_per_s']:.1f} img/s on "
              f"the host clock over {steps} steps; plain path (bf16) "
              f"{out['plain_ms_per_step']:.3f} ms per step", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--dataset", "svhn", "--model", model,
                "--dim", "8", "--epochs", "11", "--batch-size", str(batch),
                "--eval-batch-size", str(batch), "--synthetic-size",
                str(2 * batch), "--log-every", "11", "--out-dir", tmp,
                "--backbone", os.path.join(tmp, "none.npz"),
                "--device", str(dev)]
        t0 = time.perf_counter()
        acc = vit_cp_cli.main(argv)
        ckpts = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
        print(f"[train] cli.vit_cp depth {cfg.depth}: best acc {acc}, "
              f"{time.perf_counter() - t0:.1f} s, checkpoints {ckpts}",
              flush=True)
        require(len(ckpts) == 1, "the CLI wrote no best checkpoint")
        pred = Predictor.from_checkpoint_auto(
            os.path.join(tmp, ckpts[0]), model, batch_size=batch, device=dev,
            dtype=torch.bfloat16)
        logits = pred.logits(make_images(8, cfg.image_size, 5))
        require(logits.shape == (8, 10) and bool(np.isfinite(logits).all()),
                f"served checkpoint gave {logits.shape} logits")
        print(f"[train] the best checkpoint serves: logits {logits.shape}",
              flush=True)
    out["launches"] = read_launches(TRAINING_KERNELS + ("cp_mlp_block",))
    print(f"[train] kernel launches on the training path: "
          f"{out['launches']}", flush=True)
    for name in TRAINING_KERNELS:
        require(out["launches"][name] > 0,
                f"{name} never launched on the training path")
    return out


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
        reset_launches()
        serving_phase(dev, ckpt, MODEL, images)
        launches = read_launches(SERVING_KERNELS)
    print(f"[serve] kernel launches on the serving path: {launches}",
          flush=True)
    for name, count in launches.items():
        require(count > 0, f"{name} never launched on the serving path")

    train = training_phase(dev)
    launches.update({k: train["launches"][k] for k in TRAINING_KERNELS})

    kernels = []
    for name, (_, _, src, replaces) in KERNELS.items():
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
