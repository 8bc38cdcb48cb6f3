"""Time this tree's attention kernels and end-to-end paths beside another
tree's (for example the parent commit unpacked by ``git archive``), in
turns on one card.

    git archive HEAD~1 | tar -x -C build/parent
    python tools/compare_parent.py --other build/parent

Each round runs in a child process whose working directory and import
path are one tree (``--child``), so each tree's package, ``chip_smoke.py``
and kernel library (built from that tree's sources into its own
``build/kernels``) are used as they are.  The order is other, this, this,
other (``--rounds`` pairs).  A child measures, on ViT-B/16 at batch 64 in
bf16:

- the kernels of TPU row 1 (forward, N = 197), row 2 (backward, N = 197
  and 512; a tree whose kernel refuses 512 gives null), row 16 (forward
  and backward, N = 577) and row 17 (forward and backward, N = 197 and
  577), median of 20 CUDA-event timed calls, beside SDPA (forward and
  backward) on the same inputs; the forwards and row 2 also back to back
  (``*_b2b_ms``: 20 calls between two events, so the card does not wait
  for the host between them);
- the same kernels at head width 80 (ViT-H/14: rows 1 and 2 at N 257,
  rows 16 and 17 at 577, row 17 at 257) and row 17 at 16 and 32, back to
  back (null where a tree refuses the width);
- TPU rows 11 (the element route's MLP-block backward), 10 (the rank
  route's) and 8 (the element route's attention-block backward), each in
  its recompute form and, where the tree has it, its saved-residual form
  (``*_saved``: the forward kept the pre-activation, or qkv and the
  attention output), 12 (both
  split-route sites' dx with their factor gradients), the forwards of
  rows 5 (the attention block), 7 (its element-dropout form), 9 (the MLP
  block), 13 (both split sites; the fc1 site's GELU body forward and
  dact) and 19 (the whole-block eval) at B = 64, N = 197
  (``chip_smoke``'s entries; in a tree with the quick_gelu forms, rows 9,
  10, 11, 13 and 19 with quick_gelu too, ``*_quick``), median of 20
  timed calls and back to back,
  the host's time to issue one call (``*_host_ms``), with each row's
  device time split by launch (``torch.profiler``, five calls); row
  11's five ``grad_gemm`` products alone (NN ``PRE_GELU``, NT ``DGELU``,
  NT dxa, the two TN dT products) and the forward site's five
  forms (qkv with LN, proj and fc2 with the residual, fc1 with LN and
  GELU, fc1's dact; whole and as the product alone) with their TFLOP/s,
  beside ``torch.matmul`` on the same bf16 shapes (a yardstick only);
- merged and adapter serving at 224 px and merged serving at 384 px
  (``Predictor.logits``, host clock, 10 batches);
- the rank and element steps at 224 px, the element and rank steps at
  384 px and the full fine-tuning step at 224 px (median ms per step by
  CUDA events over the steps after the fifth, on one fixed batch).

- TPU row 3 (the attention + projection kernel) at ViT-B 197, 401 and
  512 tokens, CLIP ViT-L/14 and ViT-H/14 at 257, beside SDPA +
  ``torch.addmm`` (null where a tree refuses the shape).
- TPU row 18 (the dequant-fused int8 GEMM) at ``INT8_SHAPES`` (ViT-B and
  ViT-H/14's qkv and fc2 sites at batch 64 and 1) and row 14 (the
  element-dropout fold) over a layer's four weights at ViT-B and ViT-H
  widths (grouped two a launch where the tree has ``build_wd_weights``,
  else one a launch), single calls by events, back to back and by
  launch, with a digest of the fold's outputs (``fold_*_sha256``: two
  trees whose digests agree folded the same bits); merged ViT-B serving
  in bf16 and int8 with ``CARA_INT8_PALLAS`` unset and set.

``--only`` picks some of the sections (kernels, widths, rows, serving,
train, proj, quant).
Prints the card's name and power limit and one JSON line per child, and
writes them to ``--out`` as one JSON file where it is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kernels(cs, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from cara_tpu_torch.ops.cuda import blockwise_attention as bwa
    from cara_tpu_torch.ops.cuda import flash_attention as fl
    from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa

    b, h, d = 64, 12, 64
    sm = d ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(torch.bfloat16)

    def heads(t, n):
        return [x.transpose(1, 2) for x in t.reshape(b, n, 3, h, d).unbind(2)]

    def sdpa_fwd(q, k, v):
        with torch.inference_mode():
            return F.scaled_dot_product_attention(q, k, v)

    def timed(key, fn):
        out[key + "_ms"] = cs.median_ms(fn)
        out[key + "_b2b_ms"] = _b2b_ms(fn)

    qkv = rnd(b, 197, 3 * h * d, std=0.6)
    with torch.inference_mode():
        out["row1_ms"] = cs.median_ms(
            lambda: fqa.attention_cuda(qkv, h, sm, 197))
        q, k, v = heads(qkv, 197)
        out["row1_sdpa_ms"] = cs.median_ms(
            lambda: F.scaled_dot_product_attention(q, k, v))
    for n in (577, 197, 512):
        qkv = rnd(b, n, 3 * h * d, std=0.6)
        g = rnd(b, n, h * d)
        q, k, v = heads(qkv, n)
        gh = g.reshape(b, n, h, d).transpose(1, 2)
        if n in (197, 512):
            try:
                timed(f"row2_bwd_{n}",
                      lambda: fqa.attention_bwd_cuda(qkv, g, h, sm, n))
            except (RuntimeError, ValueError) as exc:  # a cap on N
                print(f"row 2 at N {n}: {exc}", flush=True)
                out[f"row2_bwd_{n}_ms"] = out[f"row2_bwd_{n}_b2b_ms"] = None
        if n == 577:
            timed("row16_fwd_577",
                  lambda: bwa.attention_fwd_cuda(qkv, h, sm, n))
            o, lse = bwa.attention_fwd_cuda(qkv, h, sm, n)
            out["row16_bwd_577_ms"] = cs.median_ms(
                lambda: bwa.attention_bwd_cuda(qkv, o, lse, g, h, sm, n))
        if n in (197, 577):
            timed(f"row17_fwd_{n}", lambda: fl.attention_fwd_cuda(q, k, v, sm))
            o, lse = fl.attention_fwd_cuda(q, k, v, sm)
            out[f"row17_bwd_{n}_ms"] = cs.median_ms(
                lambda: fl.attention_bwd_cuda(q, k, v, o, lse, gh, sm))
        timed(f"sdpa_fwd_{n}", lambda: sdpa_fwd(q, k, v))
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        so = F.scaled_dot_product_attention(qq, kk, vv)
        out[f"sdpa_bwd_{n}_ms"] = cs.median_ms(
            lambda: torch.autograd.grad(so, (qq, kk, vv), gh,
                                        retain_graph=True))
    return out


def _widths(cs, dev) -> dict:
    """The attention kernels at other head widths, device ms back to back
    (``*_b2b_ms``, median of five runs of 20 calls): rows 1 and 2 at N
    257, rows 16 and 17 forward and backward at 577 and row 17 at 257,
    sixteen heads of width 80 (ViT-H/14, B 64); row 17 at widths 16 and
    32 (B 64, N 197, twelve heads).  A tree whose kernels refuse a width
    gives null for it."""
    import torch
    from cara_tpu_torch.ops.cuda import blockwise_attention as bwa
    from cara_tpu_torch.ops.cuda import flash_attention as fl
    from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa

    b = 64
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(torch.bfloat16)

    def b2b(key, make):
        try:
            fn = make()
            out[key + "_b2b_ms"] = statistics.median(
                _b2b_ms(fn) for _ in range(5))
        except (RuntimeError, ValueError) as exc:  # a width refused
            print(f"{key}: {exc}", flush=True)
            out[key + "_b2b_ms"] = None

    for dh, h, n, rows in ((80, 16, 257, ("row1", "row2", "row17")),
                           (80, 16, 577, ("row16", "row17")),
                           (16, 12, 197, ("row17",)),
                           (32, 12, 197, ("row17",))):
        sm = dh ** -0.5
        qkv = rnd(b, n, 3 * h * dh, std=0.6)
        g = rnd(b, n, h * dh)
        q, k, v = [x.transpose(1, 2)
                   for x in qkv.reshape(b, n, 3, h, dh).unbind(2)]
        gh = g.reshape(b, n, h, dh).transpose(1, 2)
        tag = f"dh{dh}_{n}"
        if "row1" in rows:
            b2b(f"row1_{tag}", lambda: lambda: fqa.attention_cuda(
                qkv, h, sm, n))
        if "row2" in rows:
            b2b(f"row2_bwd_{tag}", lambda: lambda: fqa.attention_bwd_cuda(
                qkv, g, h, sm, n))
        if "row16" in rows:
            b2b(f"row16_fwd_{tag}", lambda: lambda: bwa.attention_fwd_cuda(
                qkv, h, sm, n))

            def row16_bwd():
                o, lse = bwa.attention_fwd_cuda(qkv, h, sm, n)
                return lambda: bwa.attention_bwd_cuda(qkv, o, lse, g, h, sm,
                                                      n)
            b2b(f"row16_bwd_{tag}", row16_bwd)
        b2b(f"row17_fwd_{tag}", lambda: lambda: fl.attention_fwd_cuda(
            q, k, v, sm))

        def row17_bwd():
            o, lse = fl.attention_fwd_cuda(q, k, v, sm)
            return lambda: fl.attention_bwd_cuda(q, k, v, o, lse, gh, sm)
        b2b(f"row17_bwd_{tag}", row17_bwd)
        del qkv, g, q, k, v, gh
        torch.cuda.empty_cache()
    return out


def _b2b_ms(fn, reps=20):
    """Device ms a call over ``reps`` calls between two events."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps=20) -> float:
    """Median host ms to issue one ``fn()`` (the card idle before it, no
    synchronize inside): the wrappers' Python, ctypes and launch cost."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _launch_split(fn, calls=5) -> dict:
    """Device ms a call of each kernel ``fn`` launches, and its launches a
    call, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:100]: [e.self_device_time_total / 1e3 / calls,
                          e.count / calls]
            for e in prof.key_averages()
            if e.self_device_time_total > 0}


def _site_products(cs, dev, inp) -> dict:
    """The forward site's five forms at ViT-B (M 12608) through
    ``_site.site_cuda`` (its GELU named as the tree's keywords name it:
    ``act="gelu"``, or ``gelu=True`` in a tree before the activation
    argument, whose dact mode was the GELU's alone): the whole site
    (the LN pass included on an LN site) and the product alone on xa =
    bf16(LN(x)), ms by events, TFLOP/s of its products (x W, x U, z V),
    beside ``torch.matmul`` of x W on the same bf16 operands (a yardstick
    only)."""
    import inspect

    import torch
    from cara_tpu_torch.ops.cuda import _site
    from cara_tpu_torch.ops.layers import layer_norm

    a, m = inp["attn"], inp["mlp"]
    b, n, e = inp["b"], inp["n"], inp["e"]
    hid = m["w1"].shape[1]
    x_attn, xm = a["x"].reshape(-1, e), m["x"].reshape(-1, e)
    dpm = inp["gates"].float().expand(b, n).reshape(-1).contiguous()
    h = inp["g_hid"].reshape(-1, hid)
    ln1 = (a["ln_scale"], a["ln_bias"], 1e-6)
    ln2 = (m["ln_scale"], m["ln_bias"], 1e-6)
    s = 1.5
    has_act = "act" in inspect.signature(_site.site_cuda).parameters
    gelu = {"act": "gelu"} if has_act else {"gelu": True}
    dact = {"act": "gelu"} if has_act else {}
    forms = {
        "qkv_ln": ((x_attn, a["wq"], a["bq"], a["u1"], a["v1"], None, s),
                   dict(ln=ln1)),
        "proj_res": ((inp["o"].reshape(-1, e), a["wp"], a["bp"], a["u2"],
                      a["v2"], a["cb2"], s), dict(res=x_attn, dpm_rows=dpm)),
        "fc1_ln_gelu": ((xm, m["w1"], m["b1"], m["u1"], m["v1"], m["cb1"],
                         s), dict(ln=ln2, **gelu)),
        "fc2_res": ((h, m["w2"], m["b2"], m["u2"], m["v2"], m["cb2"], s),
                    dict(res=xm, dpm_rows=dpm)),
        "fc1_dact": ((xm, m["w1"], m["b1"], m["u1"], m["v1"], m["cb1"], s),
                     dict(ln=ln2, dact_g=h, **dact)),
    }
    out = {}
    for key, (args, kw) in forms.items():
        x2, w, u = args[0], args[1], args[3]
        rows, k = x2.shape
        flop = 2 * rows * (k * w.shape[1] + k * u.shape[1]
                           + u.shape[1] * w.shape[1])
        ms = cs.median_ms(lambda: _site.site_cuda(*args, **kw))
        out[f"site_{key}_ms"] = ms
        out[f"site_{key}_split"] = _launch_split(
            lambda: _site.site_cuda(*args, **kw))
        pkw = dict(kw)
        if "ln" in pkw:
            x2 = layer_norm(x2, *pkw.pop("ln"))
        pargs = (x2,) + args[1:]
        pms = cs.median_ms(lambda: _site.site_cuda(*pargs, **pkw))
        out[f"site_{key}_product_ms"] = pms
        out[f"site_{key}_product_tflops"] = flop / pms / 1e9
        lib = cs.median_ms(lambda: torch.matmul(x2, w))
        out[f"site_{key}_matmul_ms"] = lib
        out[f"site_{key}_matmul_tflops"] = (2 * rows * k * w.shape[1]
                                            / lib / 1e9)
    return out


def _quick_rows(cs, dev) -> dict:
    """The quick_gelu forms of rows 9, 10 and 11 (saved), 13 (forward
    and dact) and 19 at the ViT-B shapes of their GELU forms
    (``*_quick``), timed as :func:`_rows` times those, so that the two
    activations compare in one child."""
    from cara_tpu_torch.ops.cuda import block_pair as pair_mod

    inp = cs.kernel_inputs(dev, act="quick_gelu")
    calls = cs.mlp_kernel_calls(inp, names=(
        "cp_mlp_block", "cp_mlp_block_bwd_saved",
        "cp_mlp_block_wd_bwd_saved"))
    calls.update(cs.gelu_kernel_calls(inp))
    pair = cs.pair_args(inp)
    calls["block_pair_fwd"] = (lambda: pair_mod.block_pair_fwd(
        *pair, inp["heads"], inp["sm"], inp["n_real"], 1.0,
        act="quick_gelu"),)
    out = {}
    for key, name in (("row9_quick", "cp_mlp_block"),
                      ("row10_saved_quick", "cp_mlp_block_bwd_saved"),
                      ("row11_saved_quick", "cp_mlp_block_wd_bwd_saved"),
                      ("row13_quick_gelu", "cp_dense_gelu"),
                      ("row13_quick_dact", "cp_dense_dact"),
                      ("row19_quick", "block_pair_fwd")):
        fn = calls[name][0]
        out[f"{key}_ms"] = cs.median_ms(fn)
        out[f"{key}_b2b_ms"] = _b2b_ms(fn)
        out[f"{key}_split"] = _launch_split(fn)
    return out


def _rows(cs, dev) -> dict:
    import torch
    from cara_tpu_torch.ops.cuda import _bwd

    out = {}
    inp = cs.kernel_inputs(dev)
    calls = cs.kernel_calls(inp)
    calls.update(cs.gelu_kernel_calls(inp))
    from cara_tpu_torch.ops.cuda import block_pair as pair_mod
    pair = cs.pair_args(inp)
    calls["block_pair_fwd"] = (lambda: pair_mod.block_pair_fwd(
        *pair, inp["heads"], inp["sm"], inp["n_real"], 1.0),)
    for key, name in (("row11", "cp_mlp_block_wd_bwd"),
                      ("row11_saved", "cp_mlp_block_wd_bwd_saved"),
                      ("row10", "cp_mlp_block_bwd"),
                      ("row10_saved", "cp_mlp_block_bwd_saved"),
                      ("row8", "cp_attn_block_wd_bwd"),
                      ("row8_saved", "cp_attn_block_wd_bwd_saved"),
                      ("row12", "cp_dense_dx"), ("row5", "cp_attn_block"),
                      ("row7", "cp_attn_block_wd"),
                      ("row9", "cp_mlp_block"), ("row13", "cp_dense"),
                      ("row13_gelu", "cp_dense_gelu"),
                      ("row13_dact", "cp_dense_dact"),
                      ("row19", "block_pair_fwd")):
        if name not in calls:  # a tree without the saved forms
            continue
        fn = calls[name][0]
        out[f"{key}_ms"] = cs.median_ms(fn)
        out[f"{key}_b2b_ms"] = _b2b_ms(fn)
        out[f"{key}_host_ms"] = _host_ms(fn)
        out[f"{key}_split"] = _launch_split(fn)
    out.update(_site_products(cs, dev, inp))
    if hasattr(cs, "QUICK_FORMS"):  # a tree with the quick_gelu forms
        out.update(_quick_rows(cs, dev))
    del calls, inp
    torch.cuda.empty_cache()
    m, e, hid = 64 * 197, 768, 3072
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(torch.bfloat16)

    xa, g2 = rnd(m, e), rnd(m, e)
    dprec, h = rnd(m, hid, std=0.1), rnd(m, hid)
    w1, w2 = rnd(e, hid, std=0.02), rnd(hid, e, std=0.02)
    b1, cb1 = rnd(hid, std=0.02), rnd(hid, std=0.02)
    pre = torch.randn((m, hid), generator=gen, device=dev)
    products = {
        "nn_pre_gelu": (lambda: _bwd.gemm(_bwd.NN, _bwd.EPI_PRE_GELU, xa, w1,
                                          bias1=b1, bias2=cb1),
                        lambda: torch.matmul(xa, w1)),
        "nt_dgelu": (lambda: _bwd.gemm(_bwd.NT, _bwd.EPI_DGELU, g2, w2,
                                       aux=pre),
                     lambda: torch.matmul(g2, w2.t())),
        "nt_dxa": (lambda: _bwd.gemm(_bwd.NT, _bwd.EPI_F32, dprec, w1),
                   lambda: torch.matmul(dprec, w1.t())),
        "tn_dt1": (lambda: _bwd.gemm(_bwd.TN, _bwd.EPI_F32, xa, dprec,
                                     splits=_bwd.dt_splits(e, hid, m)),
                   lambda: torch.matmul(xa.t(), dprec)),
        "tn_dt2": (lambda: _bwd.gemm(_bwd.TN, _bwd.EPI_F32, h, g2,
                                     splits=_bwd.dt_splits(hid, e, m)),
                   lambda: torch.matmul(h.t(), g2)),
    }
    flop = 2 * m * e * hid
    for key, (kern, lib) in products.items():
        ms, lib_ms = cs.median_ms(kern), cs.median_ms(lib)
        out[f"gemm_{key}_ms"] = ms
        out[f"gemm_{key}_tflops"] = flop / ms / 1e9
        out[f"gemm_{key}_matmul_ms"] = lib_ms
        out[f"gemm_{key}_matmul_tflops"] = flop / lib_ms / 1e9
    return out


def _serving(cs, dev) -> dict:
    import torch
    from cara_tpu_torch.serving import Predictor

    out = {}
    runs = ((cs.MODEL, 224, (True, False), ""),
            (cs.MODEL_384, 384, (True,), "_384"))
    for model, size, merges, tag in runs:
        images = cs.make_images(64, size)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "vit_compare_seed_0.npz")
            cs.make_checkpoint(ckpt, model=model)
            for merge in merges:
                pred = Predictor.from_checkpoint_auto(
                    ckpt, model, batch_size=64, merge=merge, device=dev,
                    dtype=torch.bfloat16)
                for _ in range(3):
                    pred.logits(images)
                t0 = time.perf_counter()
                for _ in range(10):
                    pred.logits(images)
                rate = 10 * len(images) / (time.perf_counter() - t0)
                kind = "merged" if merge else "adapter"
                out[f"serve_{kind}{tag}_img_s"] = rate
                del pred
        torch.cuda.empty_cache()
    return out


def _train(cs, dev) -> dict:
    import torch

    out = {}
    routes = (("rank_224", cs.MODEL, dict(impl="rank"), 20),
              ("element_224", cs.MODEL, dict(impl="element"), 20),
              ("element_384", cs.MODEL_384, dict(impl="element"), 12),
              ("rank_384", cs.MODEL_384, dict(impl="rank"), 12),
              ("full_224", cs.MODEL, dict(method="full", lr=1e-4), 20))
    for name, model, kw, steps in routes:
        cfg, cara_cfg, frozen, state, data = cs.train_setup(
            dev, model=model, batch=64, **kw)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        _, losses, ms, _ = cs.fixed_batch_steps(cfg, cara_cfg, frozen, state,
                                                data, gen, steps)
        out[f"step_{name}_ms"] = statistics.median(ms[5:])
        out[f"step_{name}_loss_last"] = losses[-1]
        del frozen, state, data
        torch.cuda.empty_cache()
    return out


# Row 3's shapes: (tag, N, n_real, E, heads), ViT-B at 197, 401 and 512
# tokens (keys >= 500 masked), CLIP ViT-L/14 and ViT-H/14 at 257.
PROJ_SHAPES = (("vitb", 197, 197, 768, 12), ("vitb_401", 401, 401, 768, 12),
               ("vitb_512", 512, 500, 768, 12), ("clip", 257, 257, 1024, 16),
               ("vith", 257, 257, 1280, 16))


def _proj(cs, dev) -> dict:
    """Row 3's forward (``attn_proj_cuda``: the attention and the
    projection site in one kernel, ``CARA_ATTNPROJ=1``) at B 64 and each
    of ``PROJ_SHAPES`` (rank 8): back to back (``*_b2b_ms``, median of
    five runs of 20 calls) and single calls by events (``*_ms``), beside
    SDPA + ``torch.addmm`` on the same inputs (a yardstick only).  A tree
    whose kernel refuses a shape gives null for it."""
    import torch
    from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa

    out = {}
    for tag, n, n_real, e, heads in PROJ_SHAPES:
        inp = cs.kernel_inputs(dev, b=64, n=n, e=e, heads=heads,
                               hidden=4 * e, seed=n + e, n_real=n_real)
        a = inp["attn"]

        def fwd(inp=inp, a=a, heads=heads, n_real=n_real):
            return fqa.attn_proj_cuda(inp["qkv"], a["wp"], a["bp"], a["u2"],
                                      a["v2"], a["cb2"], heads, inp["sm"],
                                      n_real, 1.0)

        lib = cs.library_calls(inp)["fused_qkv_attention_proj"]
        for key, fn in ((f"row3_{tag}", fwd), (f"sdpa_addmm_{tag}", lib)):
            try:
                out[key + "_b2b_ms"] = statistics.median(
                    _b2b_ms(fn) for _ in range(5))
                out[key + "_ms"] = cs.median_ms(fn)
            except (RuntimeError, ValueError) as exc:  # a shape refused
                print(f"{key}: {exc}", flush=True)
                out[key + "_b2b_ms"] = out[key + "_ms"] = None
        del inp, a
        torch.cuda.empty_cache()
    return out


# Row 18's shapes: (tag, M, K, N).
INT8_SHAPES = (("vitb_qkv", 12608, 768, 2304),
               ("vitb_qkv_m197", 197, 768, 2304),
               ("vitb_fc2", 12608, 3072, 768),
               ("vitb_fc2_m197", 197, 3072, 768),
               ("vith_qkv", 16448, 1280, 3840),
               ("vith_qkv_m257", 257, 1280, 3840),
               ("vith_fc2", 16448, 5120, 1280),
               ("vith_fc2_m257", 257, 5120, 1280))
# Row 14's layers: (tag, E, hidden).
FOLD_WIDTHS = (("vitb", 768, 3072), ("vith", 1280, 5120))


def _quant(cs, dev) -> dict:
    """Rows 18 and 14 (see the module docs) and int8 serving."""
    import hashlib

    import torch
    from cara_tpu_torch.ops.cuda import int8_dense as i8
    from cara_tpu_torch.ops.cuda import wd_fold
    from cara_tpu_torch.serving import Predictor

    out = {}
    for tag, m, k, n in INT8_SHAPES:
        t = cs.int8_inputs(dev, m, k, n)

        def row18(t=t):
            return i8.int8_dense(t["x"], t["wq"], t["scale"], t["b"])

        wd = t["wq"].to(torch.bfloat16)
        for key, fn in ((f"row18_{tag}", row18),
                        (f"dequant_matmul_{tag}",
                         lambda t=t, wd=wd: torch.matmul(t["x"], wd))):
            out[key + "_ms"] = cs.median_ms(fn)
            out[key + "_b2b_ms"] = statistics.median(
                _b2b_ms(fn) for _ in range(5))
        out[f"row18_{tag}_launch"] = _launch_split(row18)
        del t, wd
    torch.cuda.empty_cache()
    grouped = hasattr(wd_fold, "build_wd_weights")
    for tag, e, hidden in FOLD_WIDTHS:
        inp = cs.kernel_inputs(dev, b=1, n=17, e=e, heads=16, hidden=hidden,
                               seed=e)
        folds = cs._fold_sites(inp)
        for pair in (("qkv", "proj"), ("fc1", "fc2")):
            sites = [folds[s] for s in pair]
            if grouped:
                def fn(sites=sites):
                    return wd_fold.build_wd_weights(sites, 1.0, cs.DROP_RATE)
            else:
                def fn(sites=sites):
                    return [wd_fold.build_wd_weight(*site, 1.0, cs.DROP_RATE)
                            for site in sites]
            key = f"row14_{tag}_{'_'.join(pair)}"
            digest = hashlib.sha256()
            for w in fn():
                digest.update(w.contiguous().view(torch.int16).cpu()
                              .numpy().tobytes())
            out[f"fold_{tag}_{'_'.join(pair)}_sha256"] = digest.hexdigest()
            out[key + "_ms"] = cs.median_ms(fn)
            out[key + "_b2b_ms"] = statistics.median(
                _b2b_ms(fn) for _ in range(5))
            out[key + "_launch"] = _launch_split(fn)
        del inp, folds
    images = cs.make_images(64, 224)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "vit_compare_seed_0.npz")
        cs.make_checkpoint(ckpt)
        for label, quantize, switch in (("bf16", None, False),
                                        ("int8", "int8", False),
                                        ("int8_switch", "int8", True)):
            pred = Predictor.from_checkpoint_auto(
                ckpt, cs.MODEL, batch_size=64, merge=True, device=dev,
                dtype=torch.bfloat16, quantize=quantize)
            with cs.int8_switch(switch):
                for _ in range(3):
                    pred.logits(images)
                t0 = time.perf_counter()
                for _ in range(10):
                    pred.logits(images)
                out[f"serve_merged_{label}_img_s"] = (
                    10 * len(images) / (time.perf_counter() - t0))
            del pred
    torch.cuda.empty_cache()
    return out


SECTIONS = {"kernels": _kernels, "widths": _widths, "rows": _rows,
            "serving": _serving, "train": _train, "proj": _proj,
            "quant": _quant}


def child(only) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from cara_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    res = {"tree": os.getcwd(), "build_s": _build.BUILD_INFO["seconds"]}
    for name in only:
        res.update(SECTIONS[name](cs, dev))
    print("RESULT " + json.dumps(res), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="the tree to compare with")
    parser.add_argument("--rounds", type=int, default=1,
                        help="pairs of turns (other, this, this, other)")
    parser.add_argument("--out", help="also write the results here (JSON)")
    parser.add_argument("--only", default=",".join(SECTIONS),
                        help="comma-separated sections to measure (of "
                             f"{', '.join(SECTIONS)})")
    parser.add_argument("--child", action="store_true",
                        help="measure the tree in the working directory")
    args = parser.parse_args(argv)
    only = args.only.split(",")
    if not set(only) <= set(SECTIONS):
        parser.error(f"--only takes sections of {', '.join(SECTIONS)}")
    if args.child:
        return child(only)
    if not args.other:
        parser.error("--other is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    order = ["other", "this", "this", "other"] * args.rounds
    results = []
    for label in order:
        tree = trees[label]
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--only",
             args.only], cwd=tree,
            env=env, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            return 1
        res = dict(json.loads(lines[-1][7:]), label=label)
        print(json.dumps(res), flush=True)
        results.append(res)
    # The fold's output digests: equal in every child, or where they differ.
    for key in sorted({k for r in results for k in r
                       if k.endswith("_sha256")}):
        seen = {r["label"]: r.get(key) for r in results}
        same = len(set(seen.values())) == 1
        print(f"{key}: {'the same in every child' if same else seen}",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "results": results}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
