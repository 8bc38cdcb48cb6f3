"""The port's int8 serving quantization against the JAX package.

``models/quant.py`` (codes and scales bit for bit), ``models.vit.matk``
(weight-only and w8a8, fp32, atol 1e-5), the plain version of the
dequant-fused int8 GEMM (TPU row 18) against the Pallas kernel in
interpret mode (1e-4), the quantized forward and ``Predictor`` logits,
merged and unmerged (fp32, 1e-4), and the refusals.  Tiny model
(``vit_tiny_test``, E 64, rank-4 CaRA) on the CPU; every input is made
with numpy from a seed and handed to both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cara_tpu_torch import config as t_config
from cara_tpu_torch import serving as t_serving
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import quant as t_quant
from cara_tpu_torch.models import vit as t_vit
from cara_tpu_torch.ops.cuda import int8_dense as t_int8
from cara_tpu_torch.train import checkpoint as t_ckpt
from cara_tpu import config as j_config
from cara_tpu import serving as j_serving
from cara_tpu.models import quant as j_quant
from cara_tpu.models import vit as j_vit
from cara_tpu.ops.pallas.int8_dense import int8_dense as j_int8_dense

TOL = dict(atol=1e-4, rtol=1e-4)
MODES = {"int8": "w8", "w8a8": "w8a8"}
META = {"method": "cara", "scale": 3.0, "cp_order": 4,
        "weight_dropout": 0.1}


def _np(t):
    return t.detach().cpu().numpy()


def _bits(a):
    """Raw bits of a float array from either package (bf16 included)."""
    if isinstance(a, torch.Tensor):
        view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        return a.view(view[a.dtype]).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 128), (96, 128), (64, 192)])
def test_quantize_kernel_bit_for_bit(shape, dtype):
    w = (np.random.default_rng(sum(shape)).standard_normal(shape)
         * 0.05).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel: the 1e-12 clamp
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    j, t = j_quant.quantize_kernel(jw), t_quant.quantize_kernel(tw)
    assert t["q"].dtype == torch.int8 and t["scale"].dtype == tw.dtype
    assert t["scale"].shape == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(_np(t["q"]), np.asarray(j["q"]))
    np.testing.assert_array_equal(_bits(t["scale"]), _bits(j["scale"]))
    np.testing.assert_array_equal(
        _bits(t_quant.dequantize_kernel(t)),
        _bits(j_quant.dequantize_kernel(j)))


@pytest.fixture(scope="module")
def trees():
    cfg = t_config.get_model_config("vit_tiny_test")
    cc = t_config.CaraConfig(rank=4, scale=META["scale"])
    params = convert.init_vit_params(cfg, 21)
    cara = convert.perturb_adapter(convert.init_cara_params(cfg, cc, 22),
                                   23, std=0.1)
    return params, cara


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantize_block_weights_tree_matches_jax(trees, mode):
    params, _ = trees
    j = j_quant.quantize_block_weights(
        jax.tree_util.tree_map(jnp.asarray, params), mode=mode)
    t = t_quant.quantize_block_weights(
        convert.params_from_numpy(params, "cpu"), mode=mode)
    jl, tl = dict(_leaves(j)), dict(_leaves(t))
    assert sorted(jl) == sorted(tl)
    key = "qa" if mode == "w8a8" else "q"
    for name in t_quant.QUANT_NAMES:
        kernel = tl[("blocks", name, "kernel", key)]
        assert kernel.dtype == torch.int8
        assert t_quant.is_quantized(t["blocks"][name]["kernel"])
    for path, leaf in tl.items():
        np.testing.assert_array_equal(_np(leaf), np.asarray(jl[path]),
                                      err_msg=str(path))
    with pytest.raises(ValueError, match="quantize mode"):
        t_quant.quantize_block_weights(t, mode="int4")


@pytest.mark.parametrize("key", ["q", "qa", "dense"])
def test_matk_matches_jax(key):
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((96, 128)) * 0.05).astype(np.float32)
    x = rng.standard_normal((4, 7, 96)).astype(np.float32)
    if key == "dense":
        jk, tk = jnp.asarray(w), torch.from_numpy(w)
    else:
        j = j_quant.quantize_kernel(jnp.asarray(w))
        t = t_quant.quantize_kernel(torch.from_numpy(w))
        jk, tk = {key: j["q"], "scale": j["scale"]}, \
            {key: t["q"], "scale": t["scale"]}
    got = _np(t_vit.matk(torch.from_numpy(x), tk))
    np.testing.assert_allclose(got, np.asarray(j_vit.matk(jnp.asarray(x),
                                                          jk)),
                               atol=1e-5, rtol=0)
    if key == "qa":  # column-major codes (Predictor's layout): same values
        tc = {"qa": tk["qa"].t().contiguous().t(), "scale": tk["scale"]}
        np.testing.assert_array_equal(
            _np(t_vit.matk(torch.from_numpy(x), tc)), got)


def test_matk_switch_on_cpu_takes_no_kernel(monkeypatch):
    """``CARA_INT8_PALLAS=1`` is read at each call; a CPU tensor runs no
    kernel either way (the reference takes its kernel on a TPU only), and
    ``impl="plain"`` is the kernel's plain version."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy((rng.standard_normal((128, 256)) * 0.05).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((197, 128)).astype(np.float32))
    q = t_quant.quantize_kernel(w)
    before = t_int8.LAUNCHES
    off = t_vit.matk(x, q)
    monkeypatch.setenv("CARA_INT8_PALLAS", "1")
    on = t_vit.matk(x, q)
    plain = t_vit.matk(x, q, impl="plain")
    assert t_int8.LAUNCHES == before
    np.testing.assert_allclose(_np(on), _np(off), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(plain), _np(off), atol=1e-5, rtol=0)


# (M, K, N): two k-steps of the Pallas kernel's 128, and (batch 1) one
# row and 16 rows at K 256, N 384, the shapes the card splits over K.
@pytest.mark.parametrize("m, k, n", [
    pytest.param(128, 128, 256, id="128"),
    pytest.param(197, 128, 256, id="197"),
    pytest.param(1, 256, 384, id="m1_k256_n384"),
    pytest.param(16, 256, 384, id="m16_k256_n384")])
def test_int8_dense_plain_matches_pallas(m, k, n):
    rng = np.random.default_rng(7 + m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    q = j_quant.quantize_kernel(jnp.asarray(w))
    want = j_int8_dense(jnp.asarray(x), q["q"], q["scale"].reshape(-1),
                        jnp.asarray(b), 64, 128, 128, True)
    t = t_quant.quantize_kernel(torch.from_numpy(w))
    got = t_int8.int8_dense(torch.from_numpy(x), t["q"],
                            t["scale"].reshape(-1), torch.from_numpy(b))
    plain = t_int8.int8_dense_plain(torch.from_numpy(x), t["q"], t["scale"],
                                    torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_array_equal(_np(plain), _np(got))
    # (..., K) inputs keep their leading axes
    got3 = t_int8.int8_dense(torch.from_numpy(x).reshape(1, m, k),
                             t["q"], t["scale"], torch.from_numpy(b))
    assert got3.shape == (1, m, n)


def test_int8_dense_refuses_autograd():
    x = torch.randn(197, 128, requires_grad=True)
    q = t_quant.quantize_kernel(torch.randn(128, 128))
    with pytest.raises(RuntimeError, match="forward only"):
        t_int8.int8_dense(x, q["q"], q["scale"], torch.zeros(128))
    with torch.no_grad():
        assert t_int8.int8_dense(x, q["q"], q["scale"],
                                 torch.zeros(128)).shape == (197, 128)
    with pytest.raises(ValueError, match="impl"):
        t_int8.int8_dense(x.detach(), q["q"], q["scale"], torch.zeros(128),
                          impl="fast")


def _setup(params, cara):
    tcfg = t_config.get_model_config("vit_tiny_test")
    jcfg = j_config.get_model_config("vit_tiny_test")
    tcc = t_config.CaraConfig(rank=4, scale=META["scale"])
    jcc = j_config.CaraConfig(rank=4, scale=META["scale"])
    x = np.random.default_rng(8).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    return tcfg, jcfg, tcc, jcc, x


@pytest.mark.parametrize("adapter", [False, True], ids=["merged", "adapter"])
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_vit_forward_matches_jax(trees, mode, adapter):
    """The quantized forward: the XLA dense forms with ``matk`` (and the
    adapter's delta on top), the fused attention, as JAX runs them."""
    params, cara = trees
    tcfg, jcfg, tcc, jcc, x = _setup(params, cara)
    jp = j_quant.quantize_block_weights(
        jax.tree_util.tree_map(jnp.asarray, params), mode=mode)
    tp = t_quant.quantize_block_weights(
        convert.params_from_numpy(params, "cpu"), mode=mode)
    jkw = dict(attn_impl="fused", dense_impl="xla")
    tkw = {}
    if adapter:
        jkw.update(cara_params=jax.tree_util.tree_map(jnp.asarray, cara),
                   cara_cfg=jcc)
        tkw.update(cara_params=convert.params_from_numpy(cara, "cpu"),
                   cara_cfg=tcc)
    want = j_vit.vit_forward(jp, jnp.asarray(x), jcfg, **jkw)
    with torch.inference_mode():
        got = t_vit.vit_forward(tp, torch.from_numpy(x), tcfg, **tkw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_quantized_blocks_resolve_to_xla_and_refuse_fused(trees):
    params, cara = trees
    tcfg, _, tcc, _, x = _setup(params, cara)
    tp = t_quant.quantize_block_weights(
        convert.params_from_numpy(params, "cpu"))
    assert t_vit.resolve_impls("auto", "auto", tcc, quantized=True) == (
        "fused", "xla")
    assert t_vit.resolve_impls("auto", "auto", tcc) == ("fused", "fused")
    with pytest.raises(ValueError, match="dense_impl='xla'"):
        t_vit.vit_forward(tp, torch.from_numpy(x), tcfg, dense_impl="fused")
    with pytest.raises(ValueError, match="dense_impl='xla'"):
        t_vit.vit_forward(tp, torch.from_numpy(x), tcfg,
                          cara_params=convert.params_from_numpy(cara, "cpu"),
                          cara_cfg=tcc, dense_impl="fused")


@pytest.mark.parametrize("merge", [True, False], ids=["merged", "adapter"])
@pytest.mark.parametrize("quantize", ["int8", "w8a8"])
def test_quantized_predictor_matches_jax(trees, tmp_path, quantize, merge):
    """``Predictor(quantize=...)`` through ``from_checkpoint_auto``, in
    JAX's order (merge in fp32, quantize, cast), against JAX's; and its
    logits stay within JAX's bounds of the unquantized ones."""
    params, cara = trees
    path = str(tmp_path / "q.npz")
    t_ckpt.save_model(path, params, cara, META)
    port = t_serving.Predictor.from_checkpoint_auto(
        path, "vit_tiny_test", merge=merge, batch_size=4, device="cpu",
        dtype=torch.float32, quantize=quantize)
    ref = j_serving.Predictor.from_checkpoint_auto(
        path, "vit_tiny_test", merge=merge, batch_size=4, dtype=jnp.float32,
        quantize=quantize)
    assert port.quantize == quantize
    kernel = port._params["blocks"]["qkv"]["kernel"]
    assert set(kernel) == {"qa" if quantize == "w8a8" else "q", "scale"}
    x = np.random.default_rng(9).standard_normal(
        (5, 32, 32, 3)).astype(np.float32)
    got = port.logits(x)
    np.testing.assert_allclose(got, ref.logits(x), **TOL)
    base = t_serving.Predictor.from_checkpoint_auto(
        path, "vit_tiny_test", merge=merge, batch_size=4, device="cpu",
        dtype=torch.float32).logits(x)
    k, c = (0.25, 0.1) if quantize == "w8a8" else (0.1, 0.05)
    assert np.abs(got - base).max() < k * np.std(base) + c


def test_predictor_refuses_unknown_quantize(trees):
    params, _ = trees
    cfg = t_config.get_model_config("vit_tiny_test")
    with pytest.raises(ValueError, match="quantize mode"):
        t_serving.Predictor(params, cfg, device="cpu", quantize="int4")
