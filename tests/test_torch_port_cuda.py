"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where there is no CUDA device.  Run them
on a machine with one GPU and ``nvcc``::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest sets JAX up, and the port needs
no JAX.) The shapes are small and ragged on purpose: token counts that
are not multiples of 16, masked keys, row counts that are not multiples
of the 128-row GEMM tile, ranks that are not multiples of 16, head
widths 16, 32, 64 and 80; for the training kernels zero drop-path gates
and the weight-dropout fold's keep pattern, bit for bit; for the rank /
row / no-dropout route's kernels (``cp_dense``, its dx, the attention
backward, the MLP block backward) ranks 5 and 8, a delta scale other
than 1 and one step of each route; for the 384-px route's kernels (the
blockwise attention, the element-dropout sites and row 15) key tiles
wholly past ``n_real``, and a tiny model at 577 tokens; for row 17 (the
flash attention) strided and contiguous q, k, v at 197 and 577 tokens, a
head width the kernels do not take refused, and a train step without an
adapter; for the attention-block switches (rows 3, 4 and 6) masked keys,
idle query warps, head widths 64, 32 and 16, ranks 5, 8 and 40, and a
rank step under each switch; row 3 and its backward at ViT-B's 197, 401
and 512 tokens, CLIP ViT-L/14's E 1024 and ViT-H/14's E 1280 (head width
80, 257 and 512 tokens), delta scale 1.5, ranks 8, 65 and 128; for
the dequant-fused int8 GEMM (row 18) ragged row counts, one or three
column tiles and one or two k-steps, and a quantized Predictor with
``CARA_INT8_PALLAS=1``; for the whole-block eval kernel (row 19) head
widths 64, 32 and 16, masked keys, a row group
wholly past N and a delta scale other than 1; for row 2's backward (the
statistics pass and the tiled main kernel) N 197, 257, 401 and 512, past
the previous kernel's 352-token cap, with masked keys at head widths 64,
32, 16 and 80; for ViT-H/14's head width 80 (64 + 16 columns) rows 1, 2,
16 and 17 against their plain versions, row 1 at every chunk plan up to
N 512, and a small ViT-H on the serving, element, rank and full routes;
for row 17 at head widths 16 and 32; for the tiled forward of rows 16
and 17 query and key boxes wholly or partly past N, key tiles wholly
past n_real, size-1 image and head dimensions and more items than SMs;
for the GEMM core of the block backwards (``grad_gemm.cu``) every layout
and epilogue with and without the rank step (from memory or folded in),
ragged M, N and K, N = 64 and split TN planes; for the tiled attention
backward (rows 2, 16, 17) two calls on the same inputs giving dq, dk and
dv bit for bit; for the forward site on that core (``cp_site.cu``: rows
5, 7, 9, 13, 19's qkv site) every epilogue with and without the
LayerNorm row pass, ranks 0, 8 and 64, ViT-B's four (K, N) and 197,
12608 and 36928 rows, bit for bit on a second call, and the LayerNorm
row pass alone; past rank 64 (ranks 65, 96, 128 and 200: the GEMM
core's rank step in k-tiles of 64, the rank pre-pass, the fold and the
masked factor gradients in rank chunks, rows 3 and 19 with z in chunks)
every rank-dependent row against its plain version, the site and the
GEMM core at ViT-B's shapes; a LoRA and a FacT-TK block at ViT-B width
on the element and rate-0 routes through the CaRA sites' kernels.
Inputs are bf16 from a seeded generator; the reference is the plain
version in fp32 on the same inputs with TF32 off, held to
``chip_smoke.KERNEL_TOL`` (and ``GRAD_REL_L2`` / ``TRAIN_GRAD_REL_L2``
for gradients).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.models.merge import merge_cara
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops.cuda import _bwd, _site
from cara_tpu_torch.ops.cuda import blockwise_attention as bwa_mod
from cara_tpu_torch.ops.cuda import cp_dense as dense_mod
from cara_tpu_torch.ops.cuda import flash_attention as flash_mod
from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa_mod
from cara_tpu_torch.ops.cuda import int8_dense as int8_mod
from cara_tpu_torch.ops.cuda import wd_fold
from cara_tpu_torch.ops.layers import activation, activation_grad, layer_norm
from cara_tpu_torch.serving import Predictor

pytestmark = pytest.mark.cuda

# (b, n, n_real, e, heads, hidden, r): head dim 64 / 32 / 16, rank
# padded to 16 / 32 / 64 in the rank pre-pass.
SHAPES = [(3, 37, 30, 128, 2, 512, 5), (2, 197, 197, 256, 8, 1024, 20),
          (5, 50, 41, 64, 4, 256, 40)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _check(name, out, ref):
    atol, rtol = chip_smoke.KERNEL_TOL[name]
    assert out.shape == ref.shape
    assert torch.isfinite(out).all()
    err = (out.float() - ref).abs()
    assert (err <= atol + rtol * ref.abs()).all(), (name, err.max().item())


def _launches(name):
    mod, attr = chip_smoke.KERNELS[name][:2]
    return getattr(mod, attr)


@pytest.mark.parametrize("shape", SHAPES, ids=["dh64", "dh32", "dh16"])
def test_kernels_match_plain(dev, shape):
    b, n, n_real, e, heads, hidden, r = shape
    inp = chip_smoke.kernel_inputs(dev, b=b, n=n, e=e, heads=heads,
                                   hidden=hidden, r=r, seed=1, n_real=n_real)
    for name, (kern, _, ref32) in chip_smoke.kernel_calls(inp).items():
        before = _launches(name)
        out = kern()
        torch.cuda.synchronize()
        chip_smoke._check_outputs(name, out, ref32())
        # the fold entry folds the four sites of a layer in two grouped
        # launches (a block call's pair each), the dense entries run the
        # qkv and the projection site
        want = {"build_wd_weight": 2, "cp_dense": 2, "cp_dense_dx": 2}
        assert _launches(name) == before + want.get(name, 1), name


# (b, n, n_real, e, heads, hidden, r): the training kernels at N 17 and
# 197, ranks 5 and 8, head widths 64 and 32; M = b*n is not a multiple of
# the 128-row GEMM tile; one drop-path gate is zero.
TRAIN_SHAPES = [(3, 17, 17, 128, 2, 512, 5), (2, 197, 197, 256, 8, 1024, 8)]


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=["n17_dh64_r5",
                                                     "n197_dh32_r8"])
def test_training_kernels_match_plain(dev, shape):
    b, n, n_real, e, heads, hidden, r = shape
    inp = chip_smoke.kernel_inputs(dev, b=b, n=n, e=e, heads=heads,
                                   hidden=hidden, r=r, seed=4, n_real=n_real,
                                   zero_gates=1)
    chip_smoke.wd_keep_check(dev, inp)
    calls = chip_smoke.kernel_calls(inp)
    for name in chip_smoke.TRAINING_KERNELS:
        kern, _, ref32 = calls[name]
        out = kern()
        torch.cuda.synchronize()
        chip_smoke._check_outputs(name, out, ref32())
    # a zero gate passes the residual and its cotangent through untouched,
    # in the saved-residual form and in the recompute form
    for name in ("cp_attn_block_wd_bwd", "cp_attn_block_wd_bwd_saved",
                 "cp_mlp_block_wd_bwd", "cp_mlp_block_wd_bwd_saved"):
        dx = calls[name][0]()["x"]
        assert torch.equal(dx[0], inp["g_attn" if "attn" in name
                                     else "g_mlp"][0]), name



@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=["n17_dh64_r5",
                                                     "n197_dh32_r8"])
def test_split_route_kernels_match_plain(dev, shape):
    """The kernels of the rank / row / no-dropout route: ``cp_dense`` and
    ``cp_dense_ln`` forward and backward, the attention backward and the
    MLP block backward with a zero gate."""
    b, n, n_real, e, heads, hidden, r = shape
    inp = chip_smoke.kernel_inputs(dev, b=b, n=n, e=e, heads=heads,
                                   hidden=hidden, r=r, seed=5, n_real=n_real,
                                   zero_gates=1)
    calls = chip_smoke.kernel_calls(inp)
    for name in chip_smoke.NEW_SPLIT_KERNELS:
        kern, _, ref32 = calls[name]
        out = kern()
        torch.cuda.synchronize()
        chip_smoke._check_outputs(name, out, ref32())
    for name in ("cp_mlp_block_bwd", "cp_mlp_block_bwd_saved"):
        dx = calls[name][0]()["x"]
        assert torch.equal(dx[0], inp["g_mlp"][0]), name


@pytest.mark.parametrize("ln", [False, True], ids=["proj", "qkv_ln"])
def test_cp_dense_dx_kernel_matches_plain(dev, ln):
    """Row 12 on its own, dx and gv, with a delta scale other than 1 (it
    rides the U operand of the rank step) and M = 3 * 61 rows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    m, k, n, r, s = 183, 256, 768 if ln else 256, 5, 2.5

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std
                + mean).bfloat16()

    g2, w, u, v = rnd(m, n), rnd(k, n, std=0.05), rnd(k, r, std=0.1), \
        rnd(r, n, std=0.1)
    x2, ls = rnd(m, k), rnd(k, std=0.1, mean=1.0)
    ln_arg = (ls, 1e-6) if ln else None
    before = dense_mod.DX_LAUNCHES
    dx, gv = dense_mod.cp_dense_dx(g2, w, u, v, s, ln_arg, x2)
    torch.cuda.synchronize()
    assert dense_mod.DX_LAUNCHES == before + 1
    f32 = [t.float() for t in (g2, w, u, v)]
    ref_dx, ref_gv = dense_mod.cp_dense_dx_plain(
        *f32, s, (ls.float(), 1e-6) if ln else None, x2.float())
    assert gv.shape == (m, r)
    _check("cp_dense_dx", gv, ref_gv)
    _check("cp_dense_dx", dx, ref_dx)


@pytest.mark.parametrize("over", [{}, {"weight_dropout_impl": "row"},
                                  {"weight_dropout": 0.0}],
                         ids=["rank", "row", "rate0"])
def test_split_route_train_step_on_card_matches_plain(dev, over):
    """A tiny model's step on the split route through the kernels: every
    gradient within chip_smoke's bound of the fp32 plain path."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cfg, cc, frozen, state, data = chip_smoke.train_setup(
        dev, model="vit_tiny_test", batch=6, rank=4, impl="rank")
    cc = dataclasses.replace(cc, **over)
    before = {k: _launches(k) for k in chip_smoke.NEW_SPLIT_KERNELS}
    chip_smoke.grad_check(dev, cfg, cc, frozen, state, data, g)
    for name in chip_smoke.NEW_SPLIT_KERNELS:
        assert _launches(name) > before[name], name

@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_wd_fold_keep_pattern_is_exact(dev, rate):
    """The keep pattern bit for bit, one weight a call and the three
    weights in one grouped launch (each its own shape, seed and rank)."""
    sites = []
    for (k, n, r), seed in zip([(64, 192, 5), (200, 72, 8), (768, 2304, 8)],
                               [-2 ** 31, 12345, 2 ** 31 - 1]):
        sd = torch.tensor([[seed]], dtype=torch.int32, device=dev)
        sites.append((torch.zeros((k, n), device=dev, dtype=torch.bfloat16),
                      torch.ones((k, r), device=dev, dtype=torch.bfloat16),
                      torch.ones((r, n), device=dev, dtype=torch.bfloat16),
                      sd))
    before = _launches("build_wd_weight")
    grouped = wd_fold.build_wd_weights(sites, 1.0, rate)
    assert _launches("build_wd_weight") == before + 1
    for site, out_g in zip(sites, grouped):
        k, n = site[0].shape
        out = wd_fold.build_wd_weight(*site, 1.0, rate)
        keep = wd_fold.hash_keep_plain(0, 0, k, n, site[3], rate, dev)
        assert torch.equal(out != 0, keep), (k, n)
        assert torch.equal(out_g, out), (k, n)


def test_wd_fold_grouped_matches_plain(dev):
    """A block call's two weights of different shapes and ranks in one
    launch, each within the fold's tolerance of the fp32 plain fold and
    bit for bit the one-weight call's."""
    g = torch.Generator(device=dev)
    g.manual_seed(3)

    def rnd(*shape, std):
        return (torch.randn(shape, generator=g, device=dev) * std).to(
            torch.bfloat16)

    sites = [(rnd(320, 1280, std=0.02), rnd(320, 8, std=0.2),
              rnd(8, 1280, std=0.2),
              torch.tensor([7], dtype=torch.int32, device=dev)),
             (rnd(1280, 328, std=0.02), rnd(1280, 5, std=0.2),
              rnd(5, 328, std=0.2),
              torch.tensor([-9], dtype=torch.int32, device=dev))]
    outs = wd_fold.build_wd_weights(sites, 1.5, 0.1)
    torch.cuda.synchronize()
    for (w, u, v, sd), out in zip(sites, outs):
        _check("build_wd_weight", out, wd_fold.build_wd_weight_plain(
            w.float(), u.float(), v.float(), sd, 1.5, 0.1))
        assert torch.equal(out, wd_fold.build_wd_weight(w, u, v, sd, 1.5,
                                                        0.1))


def test_train_step_on_card_matches_plain(dev):
    """A tiny model's train step through the kernels: every gradient
    within chip_smoke's bound of the fp32 plain path, and two steps, each
    layer's MLP backward in the default saved-residual form."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cfg, cc, frozen, state, data = chip_smoke.train_setup(
        dev, model="vit_tiny_test", batch=6, rank=4)
    chip_smoke.grad_check(dev, cfg, cc, frozen, state, data, g)
    before = _launches("cp_mlp_block_wd_bwd_saved")
    _, losses, _, _ = chip_smoke.fixed_batch_steps(
        cfg, cc, frozen, state, data, g, 2)
    assert np.isfinite(losses).all()
    assert _launches("cp_mlp_block_wd_bwd_saved") == before + 2 * cfg.depth


def test_gate_and_scale(dev):
    """Drop-path gates other than 1 and a delta scale other than 1 reach
    the residual epilogue and the rank-r k-step."""
    inp = chip_smoke.kernel_inputs(dev, b=4, n=29, e=128, heads=2,
                                   hidden=512, r=8, seed=2)
    gate = torch.tensor([0.0, 1.25, 1.0, 0.5], device=dev)
    a, m = inp["attn"], inp["mlp"]
    a["dpm"] = gate.reshape(4, 1).bfloat16()
    m["dpm"] = gate.reshape(4, 1, 1).bfloat16()
    attn = chip_smoke.KERNELS["cp_attn_block"][0]
    mlp = chip_smoke.KERNELS["cp_mlp_block"][0]
    with torch.inference_mode():
        out = attn.cp_attn_block(*(a[k] for k in chip_smoke.ATTN_ARGS), 2,
                                 inp["sm"], 29, 2.0)
        ref = attn.cp_attn_block_plain(
            *(a[k].float() for k in chip_smoke.ATTN_ARGS), 2, inp["sm"], 29,
            2.0)
        _check("cp_attn_block", out, ref)
        assert torch.equal(out[0], a["x"][0])  # gate 0: the residual only
        out = mlp.cp_mlp_block(*(m[k] for k in chip_smoke.MLP_ARGS), 3.0)
        ref = mlp.cp_mlp_block_plain(
            *(m[k].float() for k in chip_smoke.MLP_ARGS), 3.0)
        _check("cp_mlp_block", out, ref)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    qkv = torch.zeros((2, 16, 3 * 64), device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        fqa_mod.fused_qkv_attention(qkv, 4, 0.25, 16)
    strided = torch.zeros((2, 16, 6 * 64), device=dev,
                          dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fqa_mod.fused_qkv_attention(strided, 4, 0.25, 16)
    big = torch.zeros((1, 520, 3 * 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="blockwise"):
        fqa_mod.fused_qkv_attention(big, 4, 0.25, 520)


# (b, n, n_real, e, heads, r): head dims 64, 32 and 16; at N = 200 the
# key tiles past 100 are wholly masked.
LONG_SHAPES = [(3, 200, 100, 128, 2, 5), (2, 577, 577, 256, 8, 8),
               (2, 70, 61, 64, 4, 4)]


@pytest.mark.parametrize("shape", LONG_SHAPES, ids=["dh64", "dh32", "dh16"])
def test_long_route_kernels_match_plain(dev, shape):
    """The blockwise attention forward (and its log-sum-exp) and backward,
    the element-dropout sites forward and backward and row 15 against
    their fp32 plain versions, each counted once per wrapper call."""
    b, n, n_real, e, heads, r = shape
    inp = chip_smoke.kernel_inputs(dev, b=b, n=n, e=e, heads=heads,
                                   hidden=4 * e, r=r, seed=7, n_real=n_real)
    calls = chip_smoke.long_kernel_calls(inp)
    assert sorted(calls) == sorted(chip_smoke.LONG_KERNELS)
    for name, (kern, _, ref32) in calls.items():
        before = _launches(name)
        out = kern()
        torch.cuda.synchronize()
        chip_smoke._check_outputs(name, out, ref32())
        want = {"cp_dense_wd": 2, "cp_dense_wd_bwd": 2}
        assert _launches(name) == before + want.get(name, 1), name
    chip_smoke.blockwise_lse_check(inp["qkv"], heads, inp["sm"], n_real)
    if n_real <= 128:  # rows past n_real: zero dk and dv
        dkv = calls["blockwise_qkv_attention_bwd"][0]()
        assert not dkv["dk"][:, n_real:].any()
        assert not dkv["dv"][:, n_real:].any()


@pytest.mark.parametrize("impl", ["element", "rank"])
def test_long_route_train_step_on_card_matches_plain(dev, impl):
    """A tiny model at 577 tokens (96 px in 4-px patches) on the 384-px
    route through the kernels: every gradient within chip_smoke's bound
    of the fp32 plain path; the blockwise attention launches, the
    full-score attention and the attention megakernels do not."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cfg, cc, frozen, state, data = chip_smoke.train_setup(
        dev, model="vit_tiny_test", batch=4, rank=4, impl=impl,
        image_size=96, patch_size=4)
    names = (chip_smoke.LONG_ELEMENT_KERNELS if impl == "element"
             else chip_smoke.LONG_SPLIT_KERNELS)
    short = chip_smoke.SHORT_ATTENTION_KERNELS
    before = {k: _launches(k) for k in names + short}
    chip_smoke.grad_check(dev, cfg, cc, frozen, state, data, g)
    for name in names:
        assert _launches(name) > before[name], name
    for name in short:
        assert _launches(name) == before[name], name


def _cast(tree, dtype):
    return convert.map_floating(tree, lambda t: t.to(dtype))


@pytest.mark.parametrize("adapter", [False, True], ids=["merged", "adapter"])
def test_vit_forward_on_card_matches_plain(dev, adapter):
    """bf16 forward through the kernels against the fp32 plain forward on
    the same (bf16-rounded) weights, within chip_smoke's logit bound."""
    cfg = get_model_config("vit_tiny_test", repr_size=64)
    cc = CaraConfig(rank=4, scale=3.0)
    params = convert.params_from_numpy(convert.init_vit_params(cfg, 0), dev)
    cara = convert.params_from_numpy(convert.perturb_adapter(
        convert.init_cara_params(cfg, cc, 1), 2, std=0.1), dev)
    if adapter:
        cara = _cast(cara, torch.bfloat16)
    else:
        params, cara, cc = merge_cara(params, cara, cfg, cc), None, None
    params = _cast(params, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)).to(dev)
    fqa0 = fqa_mod.LAUNCHES
    with torch.inference_mode():
        out = t_vit.vit_forward(params, x.bfloat16(), cfg,
                                cara_params=cara, cara_cfg=cc)
        ref = t_vit.vit_forward(_cast(params, torch.float32), x, cfg,
                                cara_params=_cast(cara, torch.float32),
                                cara_cfg=cc, impl="plain")
    assert out.shape == (3, cfg.num_classes)
    tol = chip_smoke.LOGIT_RTOL * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    assert (fqa_mod.LAUNCHES > fqa0) != adapter


@pytest.mark.parametrize("adapter", [False, True], ids=["merged", "adapter"])
def test_vit_forward_577_tokens_on_card_matches_plain(dev, adapter):
    """The eval forward at 577 tokens: the blockwise attention (and the
    split sites with the adapter kept) against the fp32 plain forward."""
    cfg = get_model_config("vit_tiny_test", image_size=96, patch_size=4)
    cc = CaraConfig(rank=4, scale=3.0)
    params = convert.params_from_numpy(convert.init_vit_params(cfg, 0), dev)
    cara = convert.params_from_numpy(convert.perturb_adapter(
        convert.init_cara_params(cfg, cc, 1), 2, std=0.1), dev)
    if adapter:
        cara = _cast(cara, torch.bfloat16)
    else:
        params, cara, cc = merge_cara(params, cara, cfg, cc), None, None
    params = _cast(params, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 96, 96, 3)).astype(np.float32)).to(dev)
    bwa0, short0 = _launches("blockwise_qkv_attention"), _launches(
        "fused_qkv_attention")
    with torch.inference_mode():
        out = t_vit.vit_forward(params, x.bfloat16(), cfg,
                                cara_params=cara, cara_cfg=cc)
        ref = t_vit.vit_forward(_cast(params, torch.float32), x, cfg,
                                cara_params=_cast(cara, torch.float32),
                                cara_cfg=cc, impl="plain")
    tol = chip_smoke.LOGIT_RTOL * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    assert _launches("blockwise_qkv_attention") == bwa0 + cfg.depth
    assert _launches("fused_qkv_attention") == short0


# (b, n, heads): row 17 at the token counts of ViT-B/16 at 224 and 384 px
# (head width 64; the other widths are cases of the tiled tests below).
FLASH_SHAPES = [(3, 197, 2), (2, 577, 3)]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=["n197", "n577"])
def test_flash_attention_kernels_match_plain(dev, shape):
    """The flash attention forward and backward on the strided (B, H, N,
    Dh) views of a qkv tensor (as the model passes them) and on
    contiguous q, k, v, against the fp32 plain twins; each wrapper call
    counted once."""
    b, n, heads = shape
    inp = chip_smoke.kernel_inputs(dev, b=b, n=n, e=64 * heads, heads=heads,
                                   hidden=256 * heads, r=4, seed=9)
    for name, (kern, _, ref32) in chip_smoke.flash_kernel_calls(inp).items():
        before = _launches(name)
        out = kern()
        torch.cuda.synchronize()
        chip_smoke._check_outputs(name, out, ref32())
        assert _launches(name) == before + 1, name
    q, k, v = (t.transpose(1, 2).contiguous() for t in inp["qkv"].reshape(
        b, n, 3, heads, 64).unbind(2))
    assert q.is_contiguous()
    out = flash_mod.flash_attention(q, k, v, 0.125)
    ref = flash_mod.flash_attention_fwd_plain(q.float(), k.float(),
                                              v.float(), 0.125)
    _check("flash_attention", out, ref)


def test_flash_attention_refuses_other_head_widths(dev):
    q = torch.zeros((2, 4, 50, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP"):
        flash_mod.flash_attention(q, q, q, 0.25)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_mod.flash_attention(*(torch.zeros(
            (2, 4, 50, 64), device=dev),) * 3, 0.125)


@pytest.mark.parametrize("method", ["full", "linear"])
def test_no_adapter_train_step_on_card_matches_plain(dev, method):
    """A tiny model with head width 64 without an adapter: full
    fine-tuning through the flash kernels (every leaf's gradient within
    chip_smoke's bound of the fp32 plain path), the linear probe over the
    fused attention (the head's)."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cfg, cc, frozen, state, data = chip_smoke.train_setup(
        dev, model="vit_tiny_test", batch=4, method=method, embed_dim=128,
        num_heads=2)
    names = (chip_smoke.FLASH_KERNELS if method == "full"
             else ("fused_qkv_attention",))
    before = {k: _launches(k) for k in names}
    chip_smoke.grad_check(dev, cfg, cc, frozen, state, data, g)
    for name in names:
        assert _launches(name) > before[name], name


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=["n17_dh64_r5",
                                                     "n197_dh32_r8"])
def test_gelu_site_kernels_match_plain(dev, shape):
    """Row 13's activation body on the fc1 site, with the GELU and with
    quick_gelu: the forward with the activation epilogue and the dact
    helper, in the LN form with the rank delta and the W' form at rank
    0, against their fp32 plain twins, each counted once per call under
    its activation's counter (the other activation's unchanged); then
    both forms' backward through autograd (dact, then row 12 or the W'
    dx and row 15) against the plain path."""
    b, n, n_real, e, heads, hidden, r = shape
    counters = {"gelu": ("ACT_LAUNCHES", "DACT_LAUNCHES"),
                "quick_gelu": ("QUICK_ACT_LAUNCHES", "QUICK_DACT_LAUNCHES")}
    every = sum(counters.values(), ())
    for act, (fwd_counter, dact_counter) in counters.items():
        inp = chip_smoke.kernel_inputs(dev, b=b, n=n, e=e, heads=heads,
                                       hidden=hidden, r=r, seed=8,
                                       n_real=n_real, act=act)
        calls = chip_smoke.gelu_kernel_calls(inp)
        assert sorted(calls) == sorted(chip_smoke.GELU_KERNELS)
        for name, (kern, _, ref32) in calls.items():
            before = {c: getattr(dense_mod, c) for c in every}
            out = kern()
            torch.cuda.synchronize()
            chip_smoke._check_outputs(name, out, ref32())
            mine = dact_counter if name.endswith("_dact") else fwd_counter
            assert {c: getattr(dense_mod, c) - before[c] for c in every} \
                == {c: int(c == mine) for c in every}, (act, name)
        m = inp["mlp"]
        seed = inp["seeds"][2]
        diff = ("x", "u1", "v1", "cb1")

        def site(t, impl, wd):
            args = (t["x"], t["w1"], t["b1"], t["u1"], t["v1"], t["cb1"],
                    t["ln_scale"], t["ln_bias"])
            if wd:
                return dense_mod.cp_dense_ln_wd(
                    *args, seed, 2.0, chip_smoke.DROP_RATE, impl=impl,
                    act=act)
            return dense_mod.cp_dense_ln(*args, 2.0, impl=impl, act=act)

        for wd in (False, True):
            before = getattr(dense_mod, dact_counter)
            got = chip_smoke._grad_call(lambda t: site(t, "auto", wd), m,
                                        diff, inp["g_hid"], torch.bfloat16)()
            assert getattr(dense_mod, dact_counter) == before + 1
            ref = chip_smoke._grad_call(lambda t: site(t, "plain", wd), m,
                                        diff, inp["g_hid"], torch.float32)()
            chip_smoke._check_outputs("cp_dense_dact", got, ref)


# The MLP block's counters (chip_smoke.QUICK_FORMS names the quick ones)
# by entry, and the GEMM products each backward form launches once.
MLP_FORMS = {"cp_mlp_block": ("LAUNCHES", ()),
             "cp_mlp_block_bwd": ("BWD_LAUNCHES",
                                  ("NN_PRE_{}GELU", "NT_D{}GELU")),
             "cp_mlp_block_wd_bwd": ("WD_BWD_LAUNCHES",
                                     ("NN_PRE_{}GELU", "NT_D{}GELU")),
             "cp_mlp_block_bwd_saved": ("BWD_SAVED_LAUNCHES",
                                        ("NT_D{}GELU_H",)),
             "cp_mlp_block_wd_bwd_saved": ("WD_BWD_SAVED_LAUNCHES",
                                           ("NT_D{}GELU_H",))}


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=["n17_dh64_r5",
                                                     "n197_dh32_r8"])
def test_mlp_kernels_by_activation_match_plain(dev, shape, act):
    """Rows 9, 10 and 11 with each activation (CLIP's quick_gelu at its
    LayerNorm eps 1e-5), the backwards in the recompute and the saved
    forms, against their fp32 plain twins with a zero gate: each call
    counted once under its form and activation, the GEMM products it
    launches once each under theirs, and the other activation's counters
    unchanged."""
    b, n, n_real, e, heads, hidden, r = shape
    inp = chip_smoke.kernel_inputs(
        dev, b=b, n=n, e=e, heads=heads, hidden=hidden, r=r, seed=12,
        n_real=n_real, zero_gates=1, act=act,
        eps=1e-5 if act == "quick_gelu" else 1e-6)
    quick = "QUICK_" if act == "quick_gelu" else ""
    mlp_counters = [p + c for c, _ in MLP_FORMS.values()
                    for p in ("", "QUICK_")]
    gemm_counters = [f"LAUNCHES_{c.format(p)}" for _, cs in MLP_FORMS.values()
                     for c in cs for p in ("", "QUICK_")]
    calls = chip_smoke.mlp_kernel_calls(inp)
    for name, (counter, products) in MLP_FORMS.items():
        kern, _, ref32 = calls[name]
        before = {c: getattr(chip_smoke.mlp_mod, c) for c in mlp_counters}
        gemm_before = {c: getattr(_bwd, c) for c in gemm_counters}
        out = kern()
        torch.cuda.synchronize()
        chip_smoke._check_outputs(name, out, ref32())
        assert {c: getattr(chip_smoke.mlp_mod, c) - before[c]
                for c in mlp_counters} == {
                    c: int(c == quick + counter) for c in mlp_counters}, name
        mine = {f"LAUNCHES_{c.format(quick)}" for c in products}
        assert {c: getattr(_bwd, c) - gemm_before[c]
                for c in gemm_counters} == {
                    c: int(c in mine) for c in gemm_counters}, name
        if name != "cp_mlp_block":  # a zero gate passes the cotangent
            assert torch.equal(out["x"][0], inp["g_mlp"][0]), name


@pytest.mark.parametrize("route, over, impls, names", [
    ("element", {"dropout_rate": 0.1, "attn_dropout_rate": 0.1},
     ("auto", "auto"), ("cp_dense_wd_gelu", "cp_dense_wd_dact")),
    ("rank", {"dropout_rate": 0.1}, ("flash", "auto"),
     ("cp_dense_gelu", "cp_dense_dact", "flash_attention",
      "flash_attention_bwd")),
    ("element", {}, ("flash", "xla"), ("flash_attention",
                                       "flash_attention_bwd")),
    ("linear", {}, ("auto", "fused"), ("cp_mlp_block",))],
    ids=["element-dropout-mha", "rank-dropout-flash", "element-flash-xla",
         "linear-fused"])
def test_regularised_and_impl_train_steps_on_card_match_plain(
        dev, route, over, impls, names):
    """A tiny model with head width 64 on the routes of activation and
    attention dropout, CaRA with the flash attention and the XLA dense
    forms, and the linear probe over the zero-factor MLP megakernel:
    every gradient within chip_smoke's bound of the fp32 plain path, the
    route's kernels launched."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    method = "linear" if route == "linear" else "cara"
    cfg, cc, frozen, state, data = chip_smoke.train_setup(
        dev, model="vit_tiny_test", batch=4, rank=4, method=method,
        impl=route if method == "cara" else "element", embed_dim=128,
        num_heads=2, **over)
    before = {k: _launches(k) for k in names}
    chip_smoke.grad_check(dev, cfg, cc, frozen, state, data, g, impls=impls)
    for name in names:
        assert _launches(name) > before[name], name


@pytest.mark.parametrize("route, over, names", [
    ("element", {}, chip_smoke.CLIP_ELEMENT_KERNELS),
    ("rank", {}, chip_smoke.CLIP_RANK_KERNELS),
    ("rank", chip_smoke.DROPOUT, chip_smoke.CLIP_DROPOUT_KERNELS)],
    ids=["element", "rank", "rank-dropout"])
def test_clip_train_steps_on_card_match_plain(dev, route, over, names):
    """A small CLIP ViT-L/14 (E 128, two heads of width 64, depth 2,
    ``ln_pre``, quick_gelu, LayerNorm eps 1e-5, a 48-wide projection) on
    the element and rank routes and with activation dropout: every
    gradient within chip_smoke's bound of the fp32 plain path, the
    route's quick_gelu forms launched and no GELU form."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cfg, cc, frozen, state, data = chip_smoke.train_setup(
        dev, model=chip_smoke.MODEL_CLIP, batch=4, rank=4, impl=route,
        image_size=56, embed_dim=128, num_heads=2, depth=2, proj_dim=48,
        **over)
    assert (cfg.activation, cfg.layernorm_eps) == ("quick_gelu", 1e-5)
    watched = names + chip_smoke.GELU_FORMS
    before = {k: _launches(k) for k in watched}
    chip_smoke.grad_check(dev, cfg, cc, frozen, state, data, g)
    for name in names:
        assert _launches(name) > before[name], name
    for name in chip_smoke.GELU_FORMS:
        assert _launches(name) == before[name], name


# A small ViT-H/14: four heads of width 80 (E 320, so that every site
# takes it: K and N multiples of 64), depth 2, 17 tokens at 56 px, or 577
# at 336 px (row 16 at Dh 80).
HUGE_SMALL = dict(embed_dim=320, num_heads=4, depth=2, image_size=56)


@pytest.mark.parametrize("adapter, size", [(False, 56), (True, 56),
                                           (True, 336)],
                         ids=["merged", "adapter", "adapter-577"])
def test_huge_forward_on_card_matches_plain(dev, adapter, size):
    """The small ViT-H's bf16 eval forward through the kernels (row 1 at
    17 tokens, row 16 at 577, head width 80) against the fp32 plain
    forward on the same weights, within chip_smoke's logit bound."""
    cfg = get_model_config(chip_smoke.MODEL_HUGE, num_classes=10,
                           **dict(HUGE_SMALL, image_size=size))
    assert cfg.head_dim == 80
    cc = CaraConfig(rank=4, scale=3.0)
    params = convert.params_from_numpy(convert.init_vit_params(cfg, 0), dev)
    cara = convert.params_from_numpy(convert.perturb_adapter(
        convert.init_cara_params(cfg, cc, 1), 2, std=0.1), dev)
    if adapter:
        cara = _cast(cara, torch.bfloat16)
    else:
        params, cara, cc = merge_cara(params, cara, cfg, cc), None, None
    params = _cast(params, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, size, size, 3)).astype(np.float32)).to(dev)
    # 577 tokens: row 16; the adapter at 17 tokens: the attention block
    # (row 5, whose attention is row 1's kernel); merged: row 1 itself.
    name = ("blockwise_qkv_attention" if size > 224 else
            "cp_attn_block" if adapter else "fused_qkv_attention")
    before = _launches(name)
    with torch.inference_mode():
        out = t_vit.vit_forward(params, x.bfloat16(), cfg,
                                cara_params=cara, cara_cfg=cc)
        ref = t_vit.vit_forward(_cast(params, torch.float32), x, cfg,
                                cara_params=_cast(cara, torch.float32),
                                cara_cfg=cc, impl="plain")
    tol = chip_smoke.LOGIT_RTOL * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    assert _launches(name) > before


@pytest.mark.parametrize("route, method, names", [
    ("element", "cara", ("cp_attn_block_wd", "cp_attn_block_wd_bwd_saved")),
    ("rank", "cara", ("fused_qkv_attention", "fused_qkv_attention_bwd")),
    ("element", "full", chip_smoke.FLASH_KERNELS)],
    ids=["element", "rank", "full"])
def test_huge_train_steps_on_card_match_plain(dev, route, method, names):
    """The small ViT-H on the element and rank routes and in full
    fine-tuning (row 17 at head width 80): every gradient within
    chip_smoke's bound of the fp32 plain path, the route's attention
    kernels launched."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cfg, cc, frozen, state, data = chip_smoke.train_setup(
        dev, model=chip_smoke.MODEL_HUGE, batch=4, rank=4, impl=route,
        method=method, lr=1e-4, **HUGE_SMALL)
    assert cfg.head_dim == 80
    before = {k: _launches(k) for k in names}
    chip_smoke.grad_check(dev, cfg, cc, frozen, state, data, g)
    for name in names:
        assert _launches(name) > before[name], name


# (b, n, n_real, e, heads, hidden, r): head dims 64, 32 and 16; masked
# keys; at N = 37 the last query warp of the 64-row tile is wholly past
# N; ranks 5, 8 and 40 (the attention + projection kernel's z step pads
# them to 8, 8 and 40 columns; rank depths 16, 16 and 64).
ATTN_ROUTE_SHAPES = [(3, 37, 30, 128, 2, 512, 5),
                     (2, 197, 197, 256, 8, 1024, 8),
                     (5, 50, 41, 64, 4, 256, 40)]


# Row 3 at the smoke's shapes (e, heads, n, n_real): ViT-B at 197, 401
# and 512 tokens (keys >= 500 masked), CLIP ViT-L/14 and ViT-H/14 (Dh 80)
# at 257, ViT-H at 512; rank 8, delta scale 1.5.
ATTN_PROJ_SHAPES = [(768, 12, 197, 197), (768, 12, 401, 401),
                    (768, 12, 512, 500), (1024, 16, 257, 257),
                    (1280, 16, 257, 257), (1280, 16, 512, 512)]


@pytest.mark.parametrize("shape", ATTN_PROJ_SHAPES,
                         ids=["vitb_197", "vitb_401", "vitb_512_500",
                              "clip_257", "vith_257", "vith_512"])
def test_attn_proj_kernel_matches_plain_at_every_width(dev, shape):
    """Row 3's forward and its backward with row 4 (``CARA_ATTNPROJ=1``)
    against their fp32 plain twins, each counted once per call, at rank
    8 and past rank 64 (65 and 128: z in chunks of 64)."""
    for r in (8, 65, 128):
        _attn_proj_case(dev, shape, r)


def _attn_proj_case(dev, shape, r):
    e, heads, n, n_real = shape
    inp = chip_smoke.kernel_inputs(dev, b=2, n=n, e=e, heads=heads,
                                   hidden=4 * e, r=r, seed=e + n + r,
                                   n_real=n_real)
    a = inp["attn"]
    args = dict(qkv=inp["qkv"], w=a["wp"], b=a["bp"], u=a["u2"], v=a["v2"],
                cb=a["cb2"])
    diff = ("qkv", "b", "u", "v", "cb")

    def run(impl, dtype):
        t = {k: v.detach().to(dtype).requires_grad_(k in diff)
             for k, v in args.items()}
        out = fqa_mod.fused_qkv_attention_proj(
            t["qkv"], t["w"], t["b"], t["u"], t["v"], t["cb"], heads,
            inp["sm"], n_real, 1.5, impl=impl)
        grads = torch.autograd.grad(out, [t[k] for k in diff],
                                    inp["g_attn"].to(dtype))
        dq, dk, dv = grads[0].chunk(3, dim=-1)
        return out, dict(zip(("dq", "dk", "dv", "db", "du", "dv2", "dcb"),
                             (dq, dk, dv) + tuple(grads[1:])))

    before = (fqa_mod.PROJ_LAUNCHES, fqa_mod.PROJ_BWD_LAUNCHES)
    out, grads = run("auto", torch.bfloat16)
    torch.cuda.synchronize()
    assert (fqa_mod.PROJ_LAUNCHES, fqa_mod.PROJ_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    ref, ref_grads = run("plain", torch.float32)
    chip_smoke._check_outputs("fused_qkv_attention_proj", out, ref)
    chip_smoke._check_outputs("fused_qkv_attention_proj_bwd", grads,
                              ref_grads)


@pytest.mark.parametrize("shape", ATTN_ROUTE_SHAPES,
                         ids=["dh64_r5", "dh32_r8", "dh16_r40"])
def test_attn_route_kernels_match_plain(dev, shape):
    """Row 3 (attention + projection), its backward with row 4, and row 6
    (the attention megakernel's backward) against their fp32 plain twins,
    each counted once per call; a zero drop-path gate passes the
    residual's cotangent through row 6 untouched."""
    b, n, n_real, e, heads, hidden, r = shape
    inp = chip_smoke.kernel_inputs(dev, b=b, n=n, e=e, heads=heads,
                                   hidden=hidden, r=r, seed=9, n_real=n_real,
                                   zero_gates=1)
    calls = chip_smoke.attn_route_kernel_calls(inp)
    assert sorted(calls) == sorted(chip_smoke.ATTN_ROUTE_KERNELS)
    for name, (kern, _, ref32) in calls.items():
        before = _launches(name)
        out = kern()
        torch.cuda.synchronize()
        chip_smoke._check_outputs(name, out, ref32())
        assert _launches(name) == before + 1, name
    dx = calls["cp_attn_block_bwd"][0]()["x"]
    assert torch.equal(dx[0], inp["g_attn"][0])


@pytest.mark.parametrize("switch", list(chip_smoke.SWITCHES))
def test_switched_rank_train_step_on_card_matches_plain(dev, switch):
    """A tiny model's rank step under each attention-block switch: every
    gradient within chip_smoke's bound of the fp32 plain path, the
    switch's kernels launched."""
    values, _, path, _ = chip_smoke.SWITCHES[switch]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cfg, cc, frozen, state, data = chip_smoke.train_setup(
        dev, model="vit_tiny_test", batch=6, rank=4, impl="rank")
    before = {k: _launches(k) for k in path}
    with chip_smoke.attn_switch(**values):
        chip_smoke.grad_check(dev, cfg, cc, frozen, state, data, g)
    for name in path:
        assert _launches(name) > before[name], name


@pytest.mark.parametrize("route", ["element", "rate0"])
@pytest.mark.parametrize("method", ["lora", "fact_tk"])
def test_peft_block_on_card_matches_plain(dev, method, route):
    """One LoRA or FacT-TK block at ViT-B width (E 768, 12 heads, hidden
    3072, 197 tokens, rank 8, the zero factor perturbed) through the CaRA
    sites' kernels: the eval logits within chip_smoke's bound of the
    fp32 plain forward, one train step's gradient of every leaf within
    its bound (``chip_smoke.grad_check``), the route's kernels launched."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cfg, cc, frozen, state, data = chip_smoke.train_setup(
        dev, batch=4, method=method, impl=route,
        scale=chip_smoke.PEFT_SCALE,
        fact_core_rank=chip_smoke.PEFT_CORE_RANK if method == "fact_tk"
        else 0, depth=1)
    path = chip_smoke.PEFT_PATHS[route]
    before = {k: _launches(k) for k in path + ("cp_attn_block",)}
    chip_smoke.grad_check(dev, cfg, cc, frozen, state, data, g)
    for name in path:
        assert _launches(name) > before[name], name
    params, cara = (convert.map_floating(t, lambda t: t.detach())
                    for t in (dict(frozen, head=state.trainable["head"]),
                              state.trainable["cara"]))
    x = data["image"]
    with torch.inference_mode():
        out = t_vit.vit_forward(_cast(params, torch.bfloat16), x.bfloat16(),
                                cfg, cara_params=_cast(cara, torch.bfloat16),
                                cara_cfg=cc)
        ref = t_vit.vit_forward(
            _cast(_cast(params, torch.bfloat16), torch.float32), x, cfg,
            cara_params=_cast(_cast(cara, torch.bfloat16), torch.float32),
            cara_cfg=cc, impl="plain")
    tol = chip_smoke.LOGIT_RTOL * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    assert _launches("cp_attn_block") > before["cp_attn_block"]


# Row 18: row counts that are not multiples of the 128-row tile, one and
# three 128-column tiles, one and two 128-deep k-steps (these small grids
# split the contraction); batch 1 (M 1, 16, 197, 257) at K 3072 and 5120,
# where the contraction is split 8 to 16 ways; ViT-H's qkv width (1280 ->
# 3840) at a ragged M whose grid takes 256-wide blocks whole, and a
# 128-wide grid whole (N 384).
INT8_SHAPES = [(197, 128, 128), (333, 256, 384), (333, 128, 384),
               (197, 256, 128), (1, 3072, 768), (16, 3072, 768),
               (197, 3072, 768), (257, 5120, 1280), (1, 5120, 1280),
               (2057, 1280, 3840), (4500, 256, 384)]


@pytest.mark.parametrize("shape", INT8_SHAPES,
                         ids=[f"m{m}_k{k}_n{n}" for m, k, n in INT8_SHAPES])
def test_int8_dense_kernel_matches_plain(dev, shape):
    """Row 18 against its fp32 plain version, counted once per call, on
    2-D and (B, N, K) inputs."""
    m, k, n = shape
    t = chip_smoke.int8_inputs(dev, m, k, n, seed=m + k + n)
    before = _launches("int8_dense")
    got = int8_mod.int8_dense(t["x"], t["wq"], t["scale"], t["b"])
    torch.cuda.synchronize()
    assert _launches("int8_dense") == before + 1
    _check("int8_dense", got, int8_mod.int8_dense_plain(
        t["x"].float(), t["wq"], t["scale"].float(), t["b"].float()))
    got3 = int8_mod.int8_dense(t["x"].reshape(1, m, k), t["wq"],
                               t["scale"], t["b"])
    assert torch.equal(got3.reshape(m, n), got)
    # without a bias (what matk passes)
    _check("int8_dense", int8_mod.int8_dense(t["x"], t["wq"], t["scale"],
                                             None),
           int8_mod.int8_dense_plain(t["x"].float(), t["wq"],
                                     t["scale"].float(), None))


@pytest.mark.parametrize("shape", [(197, 3072, 768), (1, 768, 2304)],
                         ids=["m197_k3072_n768", "m1_k768_n2304"])
def test_int8_dense_split_is_bitwise_reproducible(dev, shape):
    """At a split-K shape two calls give the same bits: the partials are
    summed in split order, no atomics."""
    m, k, n = shape
    assert int8_mod.plan(m, k, n)[1] > 1
    t = chip_smoke.int8_inputs(dev, m, k, n, seed=5)
    args = (t["x"], t["wq"], t["scale"], t["b"])
    first = int8_mod.int8_dense(*args)
    torch.cuda.synchronize()
    assert torch.equal(int8_mod.int8_dense(*args), first)


def test_int8_dense_refuses_what_the_kernel_does_not_take(dev):
    t = chip_smoke.int8_inputs(dev, 197, 192, 128)
    with pytest.raises(ValueError, match="multiples of 128"):
        int8_mod.int8_dense(t["x"], t["wq"], t["scale"], t["b"])
    t = chip_smoke.int8_inputs(dev, 197, 128, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        int8_mod.int8_dense(t["x"].float(), t["wq"], t["scale"], t["b"])
    with pytest.raises(RuntimeError, match="forward only"):
        int8_mod.int8_dense(t["x"].requires_grad_(True), t["wq"],
                            t["scale"], t["b"])


# Row 19: head widths 64, 32 and 16, masked keys, a 16-row group wholly
# past N (N = 37, 50), ranks 8, 5 and 3; ViT-L/16's width (E 1024, a
# cluster of four blocks), CLIP's (N 257), ViT-H's (E 1280, Dh 80: five
# blocks) at N 257 and at N 512 with keys >= 500 masked, a small Dh-80
# shape (E 160: one block, its second warpgroup without columns),
# ViT-B's width at rank 40 (z 64 wide), hidden 512 over three blocks
# (steps of 3, 3 and 2 chunks) and E 384 (two blocks, the second's second
# warpgroup without columns).
PAIR_SHAPES = [(2, 197, 197, 256, 4, 1024, 8), (3, 37, 30, 128, 4, 512, 5),
               (2, 50, 41, 128, 8, 512, 3), (2, 197, 197, 1024, 16, 4096, 8),
               (2, 257, 257, 1024, 16, 4096, 8),
               (2, 257, 257, 1280, 16, 5120, 8),
               (2, 512, 500, 1280, 16, 5120, 8), (3, 37, 30, 160, 2, 640, 3),
               (2, 97, 97, 768, 12, 3072, 40), (2, 50, 41, 768, 12, 512, 4),
               (2, 37, 30, 384, 6, 512, 5)]
PAIR_IDS = ["dh64", "dh32", "dh16", "vitl16", "clip", "huge", "huge_512",
            "dh80", "vitb_r40", "ragged_steps", "e384"]


@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=PAIR_IDS)
def test_block_pair_kernel_matches_plain(dev, shape):
    """Row 19 against its fp32 plain version and the split halves (rows 5
    and 9) on the card, counted once per call; with a delta scale other
    than 1 too."""
    b, n, n_real, e, heads, hidden, r = shape
    inp = chip_smoke.kernel_inputs(dev, b=b, n=n, e=e, heads=heads,
                                   hidden=hidden, r=r, seed=11,
                                   n_real=n_real)
    before = _launches("block_pair_fwd")
    out = chip_smoke.pair_kernel_phase(dev, inp, timed=False)
    assert _launches("block_pair_fwd") > before
    assert out["block_pair_fwd"]["max_abs_err"] is not None
    args = chip_smoke.pair_args(inp)
    sm = (e // heads) ** -0.5
    got = chip_smoke.pair_mod.block_pair_fwd(*args, heads, sm, n_real, 1.3)
    torch.cuda.synchronize()
    _check("block_pair_fwd", got, chip_smoke.pair_mod.block_pair_fwd_plain(
        *(t.float() for t in args), heads, sm, n_real, 1.3))


@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=PAIR_IDS)
def test_block_pair_quick_gelu_kernel_matches_plain(dev, shape):
    """Row 19 with quick_gelu against its fp32 plain version and the
    split halves (rows 5 and 9 with quick_gelu), and at a delta scale of
    1.3: three calls, each counted under ``QUICK_LAUNCHES`` and none
    under the GELU's ``LAUNCHES``."""
    b, n, n_real, e, heads, hidden, r = shape
    inp = chip_smoke.kernel_inputs(dev, b=b, n=n, e=e, heads=heads,
                                   hidden=hidden, r=r, seed=13,
                                   n_real=n_real, act="quick_gelu")
    pair = chip_smoke.pair_mod
    before = (pair.LAUNCHES, pair.QUICK_LAUNCHES)
    out = chip_smoke.pair_kernel_phase(dev, inp, timed=False)
    assert out["block_pair_fwd_quick"]["max_abs_err"] is not None
    args = chip_smoke.pair_args(inp)
    sm = (e // heads) ** -0.5
    got = pair.block_pair_fwd(*args, heads, sm, n_real, 1.3,
                              act="quick_gelu")
    torch.cuda.synchronize()
    assert (pair.LAUNCHES, pair.QUICK_LAUNCHES) == (before[0],
                                                   before[1] + 3)
    _check("block_pair_fwd_quick", got, pair.block_pair_fwd_plain(
        *(t.float() for t in args), heads, sm, n_real, 1.3, "quick_gelu"))


def test_block_pair_refuses_what_the_kernel_does_not_take(dev):
    """On CUDA tensors E past 1280 and a head width outside HEAD_DIMS
    raise, each naming its ROADMAP item, before any launch."""
    pair = chip_smoke.pair_mod
    before = (pair.LAUNCHES, pair.QUICK_LAUNCHES)
    for e, heads, item in ((1536, 16, "ROADMAP.md queue 2: Row 19 past E "
                            "1280"),
                           (768, 16, "ROADMAP.md queue 2: Attention at head "
                            "widths other than 16, 32, 64 and 80")):
        inp = chip_smoke.kernel_inputs(dev, b=1, n=17, e=e, heads=heads,
                                       hidden=512, r=4)
        with pytest.raises(ValueError, match=item):
            pair.block_pair_fwd(*chip_smoke.pair_args(inp), heads,
                                (e // heads) ** -0.5, 17, 1.0)
    assert (pair.LAUNCHES, pair.QUICK_LAUNCHES) == before


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quantized_predictor_on_card_matches_plain(dev, monkeypatch, mode):
    """A quantized Predictor (E 128, so that row 18 takes its dims) on the
    card with ``CARA_INT8_PALLAS=1``: 4 x depth launches of row 18 a
    forward for weight-only codes, none for w8a8 (``torch._int_mm``),
    logits within chip_smoke's bound of the fp32 plain forward on the
    CPU."""
    cfg = get_model_config("vit_tiny_test", embed_dim=128)
    params = convert.init_vit_params(cfg, 3)
    x = np.random.default_rng(4).standard_normal(
        (5, 32, 32, 3)).astype(np.float32)
    ref = Predictor(params, cfg, batch_size=4, device="cpu",
                    dtype=torch.float32, quantize=mode).logits(x)
    pred = Predictor(params, cfg, batch_size=4, device=dev,
                     dtype=torch.bfloat16, quantize=mode)
    monkeypatch.setenv("CARA_INT8_PALLAS", "1")
    before = _launches("int8_dense")
    got = pred.logits(x)  # a 4-image chunk, then the 1-image bucket
    want = 2 * 4 * cfg.depth if mode == "int8" else 0
    assert _launches("int8_dense") - before == want
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= (chip_smoke.LOGIT_RTOL
                                       * np.abs(ref).max())


# Row 1's wgmma kernel: head widths 16, 32 and 64; one 64-key chunk (16
# tokens), the 200-wide chunk (197), and the two-chunk path past 256 keys
# (257, 512); keys masked in the 257 case.  Head width 80 (the query ring,
# two item slots up to 256 tokens, one past) also at 401 and 512 with
# masked keys.
ROW1_CASES = ([(dh, n, n_real) for dh in (16, 32, 64)
               for n, n_real in ((16, 16), (197, 197), (257, 250),
                                 (512, 512))]
              + [(80, n, n_real) for n, n_real in (
                  (16, 16), (70, 70), (197, 197), (257, 250), (401, 401),
                  (512, 500))])


@pytest.mark.parametrize("dh, n, n_real", ROW1_CASES,
                         ids=[f"dh{d}_n{n}_r{r}" for d, n, r in ROW1_CASES])
def test_qkv_attention_wgmma_matches_plain(dev, dh, n, n_real):
    """Row 1 against ``fused_qkv_attention_plain`` in fp32, B 3 and 3
    heads (so one block walks several (image, head) items), counted once."""
    b, heads = 3, 3
    g = torch.Generator(device=dev)
    g.manual_seed(n + dh)
    qkv = (torch.randn((b, n, 3 * heads * dh), generator=g, device=dev)
           * 0.8).to(torch.bfloat16)
    sm = dh ** -0.5
    before = _launches("fused_qkv_attention")
    with torch.inference_mode():
        out = fqa_mod.fused_qkv_attention(qkv, heads, sm, n_real)
    torch.cuda.synchronize()
    assert _launches("fused_qkv_attention") == before + 1
    ref = fqa_mod.fused_qkv_attention_plain(qkv.float(), heads, sm, n_real)
    _check("fused_qkv_attention", out, ref)


def _bwd_grads(route, qkv, g, heads, sm, n_real, impl):
    """dq, dk, dv of row 16 (the qkv layout) or row 17 (strided (B, H, N,
    Dh) views of qkv) through autograd."""
    b, n, e3 = qkv.shape
    dh = e3 // 3 // heads
    x = qkv.detach().requires_grad_(True)
    if route == "blockwise":
        out = bwa_mod.blockwise_qkv_attention(x, heads, sm, n_real,
                                              impl=impl)
        (d,) = torch.autograd.grad(out, x, g)
        return d.chunk(3, dim=-1)
    q, k, v = (t.transpose(1, 2)
               for t in x.reshape(b, n, 3, heads, dh).unbind(2))
    out = flash_mod.flash_attention(q, k, v, sm, impl=impl)
    gh = g.reshape(b, n, heads, dh).transpose(1, 2)
    return [t.transpose(1, 2).reshape(b, n, -1)
            for t in torch.autograd.grad(out, (q, k, v), gh)]


# (route, n, n_real, dh, b, heads): the tiled backward through both
# wrappers; at N = 640 with n_real 577 the last key tile is wholly masked;
# one image of one head (the size-1 dimensions of the TMA maps).
BWD_CASES = [("blockwise", 197, 197, 64, 2, 3),
             ("blockwise", 577, 577, 64, 2, 3),
             ("blockwise", 640, 577, 64, 2, 3),
             ("blockwise", 200, 100, 32, 2, 3),
             ("blockwise", 70, 61, 16, 2, 3), ("flash", 197, 197, 64, 2, 3),
             ("flash", 577, 577, 64, 2, 3), ("flash", 70, 70, 64, 1, 1),
             ("blockwise", 577, 577, 80, 2, 3),
             ("blockwise", 640, 577, 80, 2, 3),
             ("flash", 257, 257, 80, 2, 3), ("flash", 577, 577, 80, 2, 3),
             ("flash", 70, 70, 80, 1, 1), ("flash", 197, 197, 32, 2, 3),
             ("flash", 70, 70, 16, 2, 4)]


@pytest.mark.parametrize("route, n, n_real, dh, b, heads", BWD_CASES,
                         ids=[f"{r}_n{n}_r{nr}_dh{d}_b{b}_h{h}"
                              for r, n, nr, d, b, h in BWD_CASES])
def test_tiled_attention_bwd_wgmma_matches_plain(dev, monkeypatch, route, n,
                                                 n_real, dh, b, heads):
    """The five-product backward against the fp32 plain twin (relative L2
    ``GRAD_REL_L2`` for dq, dk, dv; keys in [n_real, N) get exactly zero
    dk, dv), counted once a call; then the same call again: its fp32 dq
    sum (the scratch the wrapper zeroes; a scratch left unzeroed would
    double it) is bit for bit the first's, the adds taken in key-tile
    order, and dq, dk and dv are bit for bit the same."""
    e = heads * dh
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + dh)
    qkv = (torch.randn((b, n, 3 * e), generator=gen, device=dev)
           * 0.6).to(torch.bfloat16)
    g = torch.randn((b, n, e), generator=gen, device=dev).to(torch.bfloat16)
    sm = dh ** -0.5
    mod = bwa_mod if route == "blockwise" else flash_mod
    sums = []
    make = bwa_mod.bwd_scratch

    def scratch(*args):
        rows, dq_acc = make(*args)
        sums.append(dq_acc)
        return rows, dq_acc

    monkeypatch.setattr(mod, "bwd_scratch", scratch)
    before = mod.BWD_LAUNCHES
    got = _bwd_grads(route, qkv, g, heads, sm, n_real, "auto")
    torch.cuda.synchronize()
    assert mod.BWD_LAUNCHES == before + 1
    ref = _bwd_grads(route, qkv.float(), g.float(), heads, sm, n_real,
                     "plain")
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(x).all(), name
        rel = chip_smoke.rel_l2(x, r)
        assert rel <= chip_smoke.GRAD_REL_L2, (name, rel)
    if n_real < n:
        assert not got[1][:, n_real:].any()
        assert not got[2][:, n_real:].any()
    again = _bwd_grads(route, qkv, g, heads, sm, n_real, "auto")
    torch.cuda.synchronize()
    assert len(sums) == 2
    assert torch.equal(sums[1], sums[0])
    for x, y in zip(again, got):
        assert torch.equal(x, y)


# Row 2's backward (the statistics pass, then the tiled main kernel and the
# dq pass): (dh, n, n_real, b, heads).  N 257, 401 and 512 are past the
# previous kernel's cap of 352 tokens; keys masked at 250, 500, 380, 61.
ROW2_CASES = [(64, 197, 197, 2, 3), (64, 257, 250, 2, 3),
              (64, 401, 401, 2, 3), (64, 512, 500, 2, 3),
              (32, 401, 380, 2, 3), (16, 512, 512, 2, 3),
              (16, 70, 61, 1, 1), (80, 257, 257, 2, 3),
              (80, 512, 500, 2, 3), (80, 70, 61, 1, 1)]


@pytest.mark.parametrize("dh, n, n_real, b, heads", ROW2_CASES,
                         ids=[f"dh{d}_n{n}_r{r}_b{b}_h{h}"
                              for d, n, r, b, h in ROW2_CASES])
def test_qkv_attention_bwd_tiled_matches_plain(dev, dh, n, n_real, b, heads):
    """dq, dk, dv of ``fused_qkv_attention`` through its backward kernel
    against ``attention_bwd_plain`` in fp32 (relative L2 ``GRAD_REL_L2``;
    keys in [n_real, N) get exactly zero dk, dv), counted once a call; a
    second call gives dq, dk and dv bit for bit (dq's fp32 sum is taken in
    key-tile order)."""
    e = heads * dh
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + dh)
    qkv = (torch.randn((b, n, 3 * e), generator=gen, device=dev)
           * 0.6).to(torch.bfloat16)
    g = torch.randn((b, n, e), generator=gen, device=dev).to(torch.bfloat16)
    sm = dh ** -0.5

    def grads():
        x = qkv.detach().requires_grad_(True)
        out = fqa_mod.fused_qkv_attention(x, heads, sm, n_real)
        return torch.autograd.grad(out, x, g)[0].chunk(3, dim=-1)

    before = fqa_mod.BWD_LAUNCHES
    got = grads()
    torch.cuda.synchronize()
    assert fqa_mod.BWD_LAUNCHES == before + 1
    ref = fqa_mod.attention_bwd_plain(qkv.float(), g.float(), heads, sm,
                                      n_real).chunk(3, dim=-1)
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(x).all(), name
        rel = chip_smoke.rel_l2(x, r)
        assert rel <= chip_smoke.GRAD_REL_L2, (name, rel)
    if n_real < n:
        assert not got[1][:, n_real:].any()
        assert not got[2][:, n_real:].any()
    again = grads()
    for x, y in zip(again, got):
        assert torch.equal(x, y)


# The tiled forward at tail shapes: (route, n, n_real, dh, b, heads).  At
# N = 16 and 70 the second query box of an item and the second key box
# of a tile lie wholly or partly past N; at N = 200 (n_real 100) and 640
# (n_real 577) key tiles wholly past n_real are skipped; one image of one
# head (the size-1 dimensions of the TMA maps); more items than SMs.
FWD_CASES = [("blockwise", 16, 16, 64, 2, 3), ("blockwise", 70, 61, 16, 2, 3),
             ("blockwise", 200, 100, 32, 2, 3),
             ("blockwise", 640, 577, 64, 2, 3),
             ("blockwise", 197, 197, 64, 1, 1),
             ("blockwise", 577, 577, 64, 16, 12),
             ("flash", 16, 16, 64, 2, 3), ("flash", 197, 197, 64, 3, 2),
             ("flash", 577, 577, 64, 2, 3), ("flash", 70, 70, 64, 1, 1),
             ("blockwise", 577, 577, 80, 2, 3),
             ("blockwise", 640, 577, 80, 2, 3),
             ("blockwise", 577, 577, 80, 16, 16), ("flash", 16, 16, 80, 2, 3),
             ("flash", 257, 257, 80, 3, 2), ("flash", 70, 70, 80, 1, 1),
             ("flash", 200, 200, 32, 2, 3), ("flash", 70, 70, 16, 2, 3)]


@pytest.mark.parametrize("route, n, n_real, dh, b, heads", FWD_CASES,
                         ids=[f"{r}_n{n}_r{nr}_dh{d}_b{b}_h{h}"
                              for r, n, nr, d, b, h in FWD_CASES])
def test_tiled_attention_fwd_wgmma_matches_plain(dev, route, n, n_real, dh,
                                                 b, heads):
    """The wgmma forward of rows 16 and 17 against its fp32 plain twin
    (``KERNEL_TOL``) and its log-sum-exp against the plain one
    (``LSE_ATOL``), each wrapper call counted once."""
    e = heads * dh
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + dh + b)
    qkv = (torch.randn((b, n, 3 * e), generator=gen, device=dev)
           * 0.8).to(torch.bfloat16)
    sm = dh ** -0.5
    _, ref_lse = bwa_mod.blockwise_attention_fwd_plain(qkv.float(), heads,
                                                       sm, n_real)
    if route == "blockwise":
        before = bwa_mod.LAUNCHES
        with torch.inference_mode():
            out = bwa_mod.blockwise_qkv_attention(qkv, heads, sm, n_real)
        assert bwa_mod.LAUNCHES == before + 1
        ref, _ = bwa_mod.blockwise_attention_fwd_plain(qkv.float(), heads,
                                                       sm, n_real)
        _, lse = bwa_mod.attention_fwd_cuda(qkv, heads, sm, n_real)
        _check("blockwise_qkv_attention", out, ref)
    else:
        q, k, v = (t.transpose(1, 2)
                   for t in qkv.reshape(b, n, 3, heads, dh).unbind(2))
        before = flash_mod.LAUNCHES
        with torch.inference_mode():
            out = flash_mod.flash_attention(q, k, v, sm)
        assert flash_mod.LAUNCHES == before + 1
        ref = flash_mod.flash_attention_fwd_plain(q.float(), k.float(),
                                                  v.float(), sm)
        _, lse = flash_mod.attention_fwd_cuda(q, k, v, sm)
        _check("flash_attention", out, ref)
    torch.cuda.synchronize()
    assert (lse - ref_lse).abs().max().item() <= chip_smoke.LSE_ATOL


# grad_gemm.cu: (layout, epilogue, rank, m, n, k, r).  rank: None, "a2"
# (NN: the rank operand from memory) or "fold" (NT: z = A V^T inside the
# product); M ragged against the 128-row tile, N below one tile (the
# second 64-column box of an MN-major B wholly past N) or ragged, K
# ragged against the 64-deep k-tile; r 5 (folded z 16 wide) or 20 (64);
# TN with its contraction in 1 or 3 splits.
_LAYOUTS = {"nn": _bwd.NN, "nt": _bwd.NT, "tn": _bwd.TN}
_EPIS = {"f32": _bwd.EPI_F32, "bf16": _bwd.EPI_BF16,
         "pre_gelu": _bwd.EPI_PRE_GELU, "dgelu": _bwd.EPI_DGELU,
         "dgelu_h": _bwd.EPI_DGELU_H}
GEMM_SHAPES = [(200, 200, 136, 5), (296, 64, 768, 20)]
# The quick_gelu forms of the activation epilogues ("pre_quick_gelu",
# "dquick_gelu", "dquick_gelu_h") at the same shapes.
GEMM_CASES = (
    [("nn", epi, rank, *shape)
     for epi in ("bf16", "pre_gelu", "pre_quick_gelu")
     for rank in (None, "a2") for shape in GEMM_SHAPES]
    + [("nt", epi, rank, *shape)
       for epi in ("bf16", "f32", "dgelu", "dgelu_h", "dquick_gelu",
                   "dquick_gelu_h")
       for rank in (None, "fold") for shape in GEMM_SHAPES]
    + [("tn", "f32", splits, *shape) for splits in (1, 3)
       for shape in GEMM_SHAPES])
# Past rank 64 (the rank step in k-tiles of 64 from memory; NT's gv from
# the rank product first): every NN and NT form at ranks 65 and 128, the
# bf16 forms at 96 and 200 too.
GEMM_CASES += (
    [("nn", epi, "a2", m, n, k, r)
     for epi in ("bf16", "pre_gelu", "pre_quick_gelu")
     for r in ((65, 96, 128, 200) if epi == "bf16" else (65, 128))
     for m, n, k, _ in GEMM_SHAPES]
    + [("nt", epi, "fold", m, n, k, r)
       for epi in ("bf16", "f32", "dgelu", "dgelu_h", "dquick_gelu",
                   "dquick_gelu_h")
       for r in ((65, 96, 128, 200) if epi == "bf16" else (65, 128))
       for m, n, k, _ in GEMM_SHAPES])


@pytest.mark.parametrize(
    "layout, epi, rank, m, n, k, r", GEMM_CASES,
    ids=[f"{lay}_{epi}_{rank}_m{m}_n{n}_k{k}_r{r}"
         for lay, epi, rank, m, n, k, r in GEMM_CASES])
def test_grad_gemm_wgmma_matches_plain(dev, layout, epi, rank, m, n, k, r):
    """One ``grad_gemm.cu`` product against fp32 on the same bf16 inputs:
    fp32 outputs within 1e-2 + 1e-2 |ref|, bf16 outputs within
    ``KERNEL_TOL["cp_dense"]`` (one bf16 rounding), the DGELU column
    sums (over every block) and the TN product (its splits summed in
    order, bit for bit the same on a second call) within relative L2
    1e-4, DGELU_H's h = gelu(the bf16 pre-activation) as a bf16
    output; the rank step adds bf16(z) @ B2 with z = A2, or with the
    folded z = bf16(A V^T), whose gv comes out within 1e-2 + 1e-2 |ref| and zero
    past r; counted once by layout and epilogue.  For TN the ``rank``
    column holds the number of contraction splits.  The activation
    epilogues with quick_gelu in place of the GELU ("quick" in ``epi``)
    are held to the same bounds and counted apart."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + n + k + r)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(torch.bfloat16)

    act = "quick_gelu" if "quick" in epi else "gelu"
    epi = epi.replace("quick_", "")
    lay, ep = _LAYOUTS[layout], _EPIS[epi]
    a = rnd(k, m) if layout == "tn" else rnd(m, k)
    b = rnd(n, k, std=k ** -0.5) if layout == "nt" else rnd(k, n,
                                                            std=k ** -0.5)
    kw = {}
    if epi in ("bf16", "pre_gelu"):
        kw["bias1"] = rnd(n, std=0.1)
    if epi == "pre_gelu":
        kw["bias2"] = rnd(n, std=0.1)
    if epi == "dgelu":
        kw["aux"] = torch.randn((m, n), generator=gen, device=dev)
    if epi == "dgelu_h":
        kw["aux"] = rnd(m, n)
    splits = rank if layout == "tn" else 1
    af, bf = a.float(), b.float()
    acc = {"nn": lambda: af @ bf, "nt": lambda: af @ bf.t(),
           "tn": lambda: af.t() @ bf}[layout]()
    v = z = None
    if rank is not None and layout != "tn":
        if layout == "nn":
            kw["b2"] = rnd(r, n)
            b2r = kw["b2"].float()
        else:
            kw["b2"] = _bwd.pad_cols8(rnd(n, r))
            b2r = kw["b2"].float()[:, :r].t()
        if rank == "a2":  # NN
            z = rnd(m, r)
            kw["a2"] = torch.zeros((m, _bwd.rank_width(r)), device=dev,
                                   dtype=torch.bfloat16)
            kw["a2"][:, :r] = z
        else:
            v = rnd(r, k, std=k ** -0.5)
            kw["fold_v"] = v
            z = (af @ v.float().t()).to(torch.bfloat16)
        acc = acc + z.float() @ b2r
    counter = (_bwd._QUICK_COUNTERS if act == "quick_gelu"
               else _bwd._COUNTERS)[lay, ep]
    before = getattr(_bwd, counter)
    out = _bwd.gemm(lay, ep, a, b, splits=splits, act=act, **kw)
    torch.cuda.synchronize()
    assert getattr(_bwd, counter) == before + 1
    outs = list(out) if isinstance(out, tuple) else [out]
    if rank == "fold":
        gv = outs.pop()
        assert gv.shape == (m, _bwd.rank_width(r))
        assert not gv[:, r:].any()
        err = (gv[:, :r].float() - z.float()).abs()
        assert (err <= 1e-2 + 1e-2 * z.float().abs()).all()
        if r > _bwd.RANK_W:
            # gv from the rank product (its own fp32 order): an element
            # rounded to the next bf16 moves the product by up to
            # |b2| ulp(z), so the product is held on the gv it read.
            acc = acc + (gv[:, :r].float() - z.float()) @ b2r

    def close(x, ref, bf16):
        assert x.shape == ref.shape and torch.isfinite(x).all()
        atol, rtol = (chip_smoke.KERNEL_TOL["cp_dense"] if bf16
                      else (1e-2, 1e-2))
        err = (x.float() - ref).abs()
        assert (err <= atol + rtol * ref.abs()).all(), err.max().item()

    if epi == "f32" and layout == "tn":
        assert chip_smoke.rel_l2(outs[0], acc) <= 1e-4
        close(outs[0], acc, False)
        again = _bwd.gemm(lay, ep, a, b, splits=splits, **kw)
        assert torch.equal(again, outs[0])  # the splits' sum in order
    elif epi == "f32":
        close(outs[0], acc, False)
    elif epi == "bf16":
        close(outs[0], acc + kw["bias1"].float(), True)
    elif epi == "pre_gelu":
        pre = acc + kw["bias1"].float() + kw["bias2"].float()
        close(outs[0], pre, False)
        close(outs[1], activation(pre, act), True)
    else:
        dpre = acc * activation_grad(kw["aux"].float(), act)
        close(outs[0], dpre, True)
        assert outs[1].shape == (-(-m // 128), n)
        assert chip_smoke.rel_l2(outs[1].sum(0), dpre.sum(0)) <= 1e-4
        if epi == "dgelu_h":
            close(outs[2], activation(kw["aux"].float(), act), True)


# The tiled attention backward, twice on the same inputs: (row, n, head
# width).  Row 2 at 197 and 512 tokens, row 16 at 577, row 17 at 197 and
# 577, twelve heads of width 64 (the smoke holds the same at batch 64);
# then sixteen heads of width 80 (ViT-H/14: one dq staging buffer) at its
# 257 and 577 tokens.
DETERMINISM_CASES = [("row2", 197, 64), ("row2", 512, 64),
                     ("row16", 577, 64), ("row17", 197, 64),
                     ("row17", 577, 64), ("row2", 257, 80),
                     ("row2", 512, 80), ("row16", 577, 80),
                     ("row17", 257, 80), ("row17", 577, 80)]


@pytest.mark.parametrize("row, n, dh", DETERMINISM_CASES,
                         ids=[f"{r}_n{n}" + ("" if d == 64 else f"_dh{d}")
                              for r, n, d in DETERMINISM_CASES])
def test_attention_bwd_is_bitwise_deterministic(dev, row, n, dh):
    """Two backward calls of rows 2, 16 and 17 on the same inputs give dq,
    dk and dv bit for bit: the adds into dq's fp32 sum are taken in
    key-tile order."""
    b, heads = 8, 12 if dh == 64 else 16
    e = heads * dh
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    qkv = (torch.randn((b, n, 3 * e), generator=gen, device=dev)
           * 0.6).to(torch.bfloat16)
    g = torch.randn((b, n, e), generator=gen, device=dev).to(torch.bfloat16)
    sm = dh ** -0.5

    def grads():
        if row == "row2":
            x = qkv.detach().requires_grad_(True)
            out = fqa_mod.fused_qkv_attention(x, heads, sm, n)
            return torch.autograd.grad(out, x, g)[0].chunk(3, dim=-1)
        route = "blockwise" if row == "row16" else "flash"
        return _bwd_grads(route, qkv, g, heads, sm, n, "auto")

    first = grads()
    second = grads()
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.isfinite(x).all(), name
        assert torch.equal(x, y), name


def test_grad_gemm_from_a_fresh_thread(dev):
    """A thread whose first CUDA work is a ``grad_gemm.cu`` launch (as
    autograd's device thread is when a backward of this library runs
    first) gets the product: the TMA maps are encoded with the primary
    context bound to that thread."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    a = torch.randn((40, 136), generator=gen, device=dev).bfloat16()
    b = torch.randn((72, 136), generator=gen, device=dev).bfloat16()
    out = {}

    def run():
        try:
            out["c"] = _bwd.gemm(_bwd.NT, _bwd.EPI_F32, a, b)
            torch.cuda.synchronize()
        except Exception as exc:  # reported below, in the test's thread
            out["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in out, out.get("error")
    ref = a.float() @ b.float().t()
    assert (out["c"] - ref).abs().max().item() <= 1e-2 * ref.abs().max()


# cp_site.cu on the wgmma core: (ln, act, res, rank, k, n, m).  The four
# (K, N) of ViT-B's sites (qkv, proj, fc1, fc2), every epilogue (the
# residual with or without the GELU, the dact mode), ranks 0 (no rank
# step: the W' form), 8 (z 16 wide) and 64 (z 64 wide), and the row
# counts of one image and of batch 64 at 224 and 384 px (197 and 577
# tokens), ragged against the 128-row tile.
SITE_EPIS = [("none", False), ("none", True), ("gelu", False),
             ("gelu", True), ("dact", False)]
SITE_KN = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
SITE_CASES = [(ln, act, res, r, k, n, m) for ln in (False, True)
              for act, res in SITE_EPIS for r in (0, 8, 64)
              for k, n in SITE_KN for m in (197, 12608, 36928)]
# The quick_gelu forms (the activation and its dact mode) at the fc1
# shapes of ViT-B and of CLIP ViT-L/14 (K 1024, N 4096; 64 x 257 rows).
SITE_CASES += [(ln, act, False, r, k, n, m) for ln in (False, True)
               for act in ("quick_gelu", "quick_dact") for r in (0, 8, 64)
               for k, n in ((768, 3072), (1024, 4096)) for m in (197, 16448)]
# Past rank 64 (the rank pre-pass, then the rank step in k-tiles of 64):
# every epilogue at ranks 65 and 128 on ViT-B's qkv and fc2 shapes, 96
# and 200 on the qkv site, and the quick_gelu forms at 128.
SITE_CASES += [(ln, act, res, r, k, n, m) for ln in (False, True)
               for act, res in SITE_EPIS for r in (65, 128)
               for k, n in ((768, 2304), (3072, 768)) for m in (197, 12608)]
SITE_CASES += [(True, "none", False, r, 768, 2304, 12608) for r in (96, 200)]
SITE_CASES += [(True, act, False, 128, 768, 3072, 12608)
               for act in ("quick_gelu", "quick_dact")]


def _site_inputs(dev, ln, act, res, r, k, n, m, seed):
    """bf16 inputs of one site call and its keyword arguments."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std
                + mean).to(torch.bfloat16)

    # Past rank 64 V's std shrinks by sqrt(64 / r), so that the delta
    # keeps rank 64's size (the fp32 reference does not round z, whose
    # bf16 rounding the kernel's delta carries in every rank term).
    v_std = 0.05 * min(1.0, 64 / max(r, 1)) ** 0.5
    args = (rnd(m, k), rnd(k, n, std=k ** -0.5), rnd(n, std=0.1),
            rnd(k, r, std=k ** -0.5), rnd(r, n, std=v_std), rnd(n, std=0.1))
    kw = {}
    if ln:
        kw["ln"] = (rnd(k, std=0.1, mean=1.0), rnd(k, std=0.1), 1e-6)
    if act != "none":
        kw["act"] = "quick_gelu" if act.startswith("quick") else "gelu"
    if act.endswith("dact"):
        kw["dact_g"] = rnd(m, n)
    if res:
        kw["res"] = rnd(m, n)
        keep = torch.rand((m,), generator=gen, device=dev) >= 0.1
        kw["dpm_rows"] = keep.float() / 0.9
    return args, kw


def _f32(kw):
    out = {}
    for key, val in kw.items():
        if key == "ln":
            val = (val[0].float(), val[1].float(), val[2])
        elif isinstance(val, torch.Tensor):
            val = val.float()
        out[key] = val
    return out


@pytest.mark.parametrize(
    "ln, act, res, r, k, n, m", SITE_CASES,
    ids=[f"{'ln' if ln else 'x'}_{act}{'_res' if res else ''}_r{r}_k{k}"
         f"_n{n}_m{m}" for ln, act, res, r, k, n, m in SITE_CASES])
def test_cp_site_wgmma_matches_plain(dev, ln, act, res, r, k, n, m):
    """One forward site (the LN row pass on an LN site, then the
    ``cp_site.cu`` product with z folded in) against the fp32 plain twin
    on the same bf16 inputs at a delta scale of 2: the output within
    ``KERNEL_TOL`` (the dact mode's at ``cp_site_fc1_dact``'s), z =
    bf16(xa U) within ``cp_site_qkv_ln``'s and zero past the rank, a
    second call bit for bit (no split contraction), counted once under
    its epilogue and activation."""
    args, kw = _site_inputs(dev, ln, act, res, r, k, n, m, m + k + n + r)
    s = 2.0
    quick = "QUICK_" if act.startswith("quick") else ""
    counter = ("LAUNCHES_RES" if res else "LAUNCHES_BF16" if act == "none"
               else f"LAUNCHES_{quick}DACT" if act.endswith("dact")
               else f"LAUNCHES_{quick}GELU")
    before = getattr(_site, counter)
    out, z = _site.site_cuda(*args, s, return_z=True, **kw)
    again, z_again = _site.site_cuda(*args, s, return_z=True, **kw)
    torch.cuda.synchronize()
    assert getattr(_site, counter) == before + 2
    assert torch.equal(out, again) and torch.equal(z, z_again)
    a32, kw32 = [t.float() for t in args], _f32(kw)
    ref = _site.site_forward_plain(*a32, s, **kw32)
    _check("cp_site_fc1_dact" if act.endswith("dact") else "cp_site_qkv_ln",
           out, ref)
    xa = a32[0] if not ln else layer_norm(a32[0], *kw32["ln"])
    assert z.shape == (m, _bwd.rank_width(r)) and not z[:, r:].any()
    _check("cp_site_qkv_ln", z[:, :r], xa @ a32[3])


# The fc1 site's saved pre-activation: (ln, rank, k, n, m).
PRE_CASES = [(ln, r, k, n, m) for ln in (False, True) for r in (0, 8, 64)
             for k, n in ((768, 3072), (64, 200)) for m in (197, 12608)]


@pytest.mark.parametrize(
    "ln, r, k, n, m", PRE_CASES,
    ids=[f"{'ln' if ln else 'x'}_r{r}_k{k}_n{n}_m{m}"
         for ln, r, k, n, m in PRE_CASES])
def test_cp_site_pre_output_matches_plain(dev, ln, r, k, n, m):
    """The GELU site with its second output (the save-pre mode's
    pre-activation, bf16): the output bit for bit the same as without it,
    the pre-activation within ``cp_site_qkv_ln``'s tolerance of the fp32
    plain one (one bf16 rounding) and counted under
    ``LAUNCHES_GELU_PRE``."""
    args, kw = _site_inputs(dev, ln, "gelu", False, r, k, n, m, 7 + m + r)
    s = 2.0
    before = _site.LAUNCHES_GELU_PRE
    out, pre = _site.site_cuda(*args, s, return_pre=True, **kw)
    plain_out = _site.site_cuda(*args, s, **kw)
    torch.cuda.synchronize()
    assert _site.LAUNCHES_GELU_PRE == before + 1
    assert torch.equal(out, plain_out)
    a32, kw32 = [t.float() for t in args], _f32(kw)
    xa = a32[0] if not ln else layer_norm(a32[0], *kw32["ln"])
    ref = _site.site_plain(xa, *a32[1:], s)
    _check("cp_site_qkv_ln", pre, ref)


# The quick_gelu site's saved pre-activation: (ln, rank, k, n, m) at the
# fc1 shapes of ViT-B and CLIP ViT-L/14.
QUICK_PRE_CASES = [(ln, r, k, n, m) for ln in (False, True)
                   for r in (0, 8, 64)
                   for k, n in ((768, 3072), (1024, 4096))
                   for m in (197, 16448)]


@pytest.mark.parametrize(
    "ln, r, k, n, m", QUICK_PRE_CASES,
    ids=[f"{'ln' if ln else 'x'}_r{r}_k{k}_n{n}_m{m}"
         for ln, r, k, n, m in QUICK_PRE_CASES])
def test_cp_site_quick_pre_output_matches_plain(dev, ln, r, k, n, m):
    """The quick_gelu site with its pre-activation output (CLIP's fc1 in
    the save-pre mode): the output bit for bit the same as without it and
    within ``cp_site_fc1_ln_gelu``'s tolerance of the fp32 plain one, the
    pre-activation within ``cp_site_qkv_ln``'s, counted once under
    ``LAUNCHES_QUICK_GELU_PRE`` and never under the GELU's counters."""
    args, kw = _site_inputs(dev, ln, "quick_gelu", False, r, k, n, m,
                            9 + m + r)
    s = 2.0
    before = (_site.LAUNCHES_QUICK_GELU_PRE, _site.LAUNCHES_GELU,
              _site.LAUNCHES_GELU_PRE)
    out, pre = _site.site_cuda(*args, s, return_pre=True, **kw)
    plain_out = _site.site_cuda(*args, s, **kw)
    torch.cuda.synchronize()
    assert (_site.LAUNCHES_QUICK_GELU_PRE, _site.LAUNCHES_GELU,
            _site.LAUNCHES_GELU_PRE) == (before[0] + 1, *before[1:])
    assert torch.equal(out, plain_out)
    a32, kw32 = [t.float() for t in args], _f32(kw)
    _check("cp_site_fc1_ln_gelu", out, _site.site_forward_plain(
        *a32, s, **kw32))
    xa = a32[0] if not ln else layer_norm(a32[0], *kw32["ln"])
    _check("cp_site_qkv_ln", pre, _site.site_plain(xa, *a32[1:], s))


@pytest.mark.parametrize("m, n, per", [(12608, 768, 197), (197, 3072, 1),
                                       (111, 64, 37), (36928, 200, 577)])
def test_gate_colsum_kernel_matches_plain(dev, m, n, per):
    """``gate_colsum`` on an unaligned gate view: g2 = bf16(g *
    gate[row // per]) bit for bit against the plain product, its fp32
    column sums within 1e-5 relative L2 of the sums of the rounded g2, a
    second call bit for bit (a fixed order, the stripe counters set back
    to 0)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + n)
    g = torch.randn((m, n), generator=gen, device=dev).to(torch.bfloat16)
    # a view 2 bytes into its buffer, as a row of the step's (2, B) gates
    gate = (torch.rand((m // per + 1,), generator=gen, device=dev) * 2
            ).to(torch.bfloat16)[1:]
    gate[0] = 0.0
    ds, ds2 = (torch.empty((n,), device=dev) for _ in range(2))
    out = _bwd.gate_colsum(g, gate, per, ds)
    out2 = _bwd.gate_colsum(g, gate, per, ds2)
    torch.cuda.synchronize()
    want = (g.float() * gate.float().repeat_interleave(per)[:, None]
            ).to(torch.bfloat16)
    assert torch.equal(out, want)
    assert chip_smoke.rel_l2(ds, want.float().sum(0)) <= 1e-5
    assert torch.equal(out, out2) and torch.equal(ds, ds2)


@pytest.mark.parametrize("k", [64, 200, 768, 1024, 3072])
def test_ln_rows_kernel_matches_plain(dev, k):
    """The LayerNorm row pass (a forward site's prologue and the
    backward's xa) against the plain ``layer_norm`` on the same bf16 rows,
    within one bf16 ulp of the fp32 result; near zero, where the
    normalized value cancels against the bias, within 1e-5 (the two fp32
    means of up to 3072 values differ in their last bits)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(k)
    x = (torch.randn((777, k), generator=gen, device=dev) * 2
         + 0.5).to(torch.bfloat16)
    ls = (torch.randn((k,), generator=gen, device=dev) * 0.1
          + 1).to(torch.bfloat16)
    lb = (torch.randn((k,), generator=gen, device=dev) * 0.1
          ).to(torch.bfloat16)
    out = _bwd.ln_rows(x, ls, lb, 1e-6)
    torch.cuda.synchronize()
    ref = layer_norm(x.float(), ls.float(), lb.float(), 1e-6)
    ulp = torch.finfo(torch.bfloat16).eps * ref.abs()
    assert ((out.float() - ref).abs() <= ulp.clamp_min(1e-5)).all()


def test_cp_site_from_a_fresh_thread(dev):
    """A thread whose first CUDA work is a site launch (autograd's device
    thread when a forward of this library runs in a backward's
    recompute) gets the product: the TMA maps are encoded with the
    primary context bound to that thread."""
    args, kw = _site_inputs(dev, True, "gelu", False, 8, 768, 2304, 300, 3)
    out = {}

    def run():
        try:
            out["y"] = _site.site_cuda(*args, 1.0, **kw)
            torch.cuda.synchronize()
        except Exception as exc:  # reported below, in the test's thread
            out["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in out, out.get("error")
    ref = _site.site_forward_plain(*[t.float() for t in args], 1.0,
                                   **_f32(kw))
    _check("cp_site_fc1_ln_gelu", out["y"], ref)


# Past rank 64: (b, n, n_real, e, heads, hidden) of the small blocks, at
# ranks 65, 96, 128 and 200.
RANK_SHAPES = [(2, 37, 30, 128, 2, 512), (2, 50, 41, 256, 4, 1024)]
RANK_CASES = [(shape, r) for shape in RANK_SHAPES for r in (65, 96, 128, 200)]


@pytest.mark.parametrize("shape, r", RANK_CASES,
                         ids=[f"e{s[3]}_r{r}" for s, r in RANK_CASES])
def test_rank_dependent_kernels_past_rank_64_match_plain(dev, shape, r):
    """Every rank-dependent row past rank 64 against its fp32 plain
    version (the smoke's entries, ``KERNEL_TOL`` / ``GRAD_REL_L2``):
    rows 5 and 7-13 and their backwards (the GEMM core's rank step in
    k-tiles of 64), row 14's fold and its keep pattern, row 15 and the
    masked factor gradients inside rows 8 and 11 (rank chunks on a grid
    axis), row 3 and its backward, row 6 and row 19 (z in chunks of
    64); each kernel launched."""
    b, n, n_real, e, heads, hidden = shape
    inp = chip_smoke.kernel_inputs(dev, b=b, n=n, e=e, heads=heads,
                                   hidden=hidden, r=r, seed=r + e,
                                   n_real=n_real)
    chip_smoke.wd_keep_check(dev, inp)
    calls = {**chip_smoke.kernel_calls(inp),
             **chip_smoke.attn_route_kernel_calls(inp),
             **{k: v for k, v in chip_smoke.long_kernel_calls(inp).items()
                if k in ("cp_dense_wd", "cp_dense_wd_bwd",
                         "cp_wd_factor_grads")}}
    for name, (kern, _, ref32) in calls.items():
        before = _launches(name)
        out = kern()
        torch.cuda.synchronize()
        chip_smoke._check_outputs(name, out, ref32())
        assert _launches(name) > before, name
    out = chip_smoke.pair_kernel_phase(dev, inp, timed=False)
    assert out["block_pair_fwd"]["max_abs_err"] is not None
    quick = chip_smoke.kernel_inputs(dev, b=b, n=n, e=e, heads=heads,
                                     hidden=hidden, r=r, seed=r + e + 1,
                                     n_real=n_real, act="quick_gelu")
    chip_smoke.pair_kernel_phase(dev, quick, timed=False)
