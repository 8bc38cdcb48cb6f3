"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where there is no CUDA device.  Run them
on a machine with one GPU and ``nvcc``::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest sets JAX up, and the port needs
no JAX.)  The shapes are small and ragged on purpose: token counts that
are not multiples of 16, masked keys, row counts that are not multiples
of the 128-row GEMM tile, ranks that are not multiples of 16, head
widths 16, 32 and 64.  Inputs are bf16 from a seeded generator; the
reference is the plain version in fp32 on the same inputs with TF32 off,
held to ``chip_smoke.KERNEL_TOL``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cara_tpu_torch.config import CaraConfig, get_model_config
from cara_tpu_torch.models import convert
from cara_tpu_torch.models.merge import merge_cara
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa_mod

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


@pytest.mark.parametrize("shape", SHAPES, ids=["dh64", "dh32", "dh16"])
def test_kernels_match_plain(dev, shape):
    b, n, n_real, e, heads, hidden, r = shape
    inp = chip_smoke.kernel_inputs(dev, b=b, n=n, e=e, heads=heads,
                                   hidden=hidden, r=r, seed=1, n_real=n_real)
    for name, (kern, _, ref32) in chip_smoke.kernel_calls(inp).items():
        mod = chip_smoke.KERNEL_MODULES[name]
        before = mod.LAUNCHES
        with torch.inference_mode():
            out = kern()
            torch.cuda.synchronize()
            _check(name, out, ref32())
        assert mod.LAUNCHES == before + 1, name


def test_gate_and_scale(dev):
    """Drop-path gates other than 1 and a delta scale other than 1 reach
    the residual epilogue and the rank-r k-step."""
    inp = chip_smoke.kernel_inputs(dev, b=4, n=29, e=128, heads=2,
                                   hidden=512, r=8, seed=2)
    gate = torch.tensor([0.0, 1.25, 1.0, 0.5], device=dev)
    a, m = inp["attn"], inp["mlp"]
    a["dpm"] = gate.reshape(4, 1).bfloat16()
    m["dpm"] = gate.reshape(4, 1, 1).bfloat16()
    attn = chip_smoke.KERNEL_MODULES["cp_attn_block"]
    mlp = chip_smoke.KERNEL_MODULES["cp_mlp_block"]
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
