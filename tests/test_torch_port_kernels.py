"""The port's kernel modules against the JAX kernels they replace.

On the CPU each ``cara_tpu_torch.ops.cuda`` wrapper runs its plain PyTorch
version; the JAX kernels run as their own tests run them here (Pallas
interpret mode, ``interpret=None``).  Inputs are made with numpy from a
seed and handed to both.  Everything is fp32, compared with
atol = rtol = 1e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cara_tpu_torch.ops.cuda import cp_attn_block as t_attn
from cara_tpu_torch.ops.cuda import cp_mlp as t_mlp
from cara_tpu_torch.ops.cuda import fused_qkv_attention as t_fqa
from cara_tpu.ops.pallas import cp_attn_block as j_attn
from cara_tpu.ops.pallas import cp_mlp as j_mlp
from cara_tpu.ops.pallas import fused_qkv_attention as j_fqa

TOL = dict(atol=1e-4, rtol=1e-4)
E, HEADS, R, HIDDEN, B = 64, 4, 4, 256, 2
SM = (E // HEADS) ** -0.5
EPS = 1e-6


def _arrays(seed, **shapes):
    """name -> numpy fp32 array; an entry is (shape, std[, mean])."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in shapes.items():
        shape, std = spec[0], spec[1]
        mean = spec[2] if len(spec) > 2 else 0.0
        out[name] = (mean + std * rng.standard_normal(shape)).astype(
            np.float32)
    return out


def _t(arrs):
    return {k: torch.from_numpy(v) for k, v in arrs.items()}


def _j(arrs):
    return {k: jnp.asarray(v) for k, v in arrs.items()}


def _attn_inputs(n, seed=0):
    a = _arrays(seed, x=((B, n, E), 1.2), wq=((E, 3 * E), 0.08),
                bq=((3 * E,), 0.05), u1=((E, R), 0.1), v1=((R, 3 * E), 0.1),
                wp=((E, E), 0.08), bp=((E,), 0.05), u2=((E, R), 0.1),
                v2=((R, E), 0.1), cb2=((E,), 0.1), ls=((E,), 0.1, 1.0),
                lb=((E,), 0.1))
    a["dpm"] = np.ones((B, 1), np.float32)
    return a


def _mlp_inputs(n, seed=0):
    m = _arrays(seed, x=((B, n, E), 1.2), w1=((E, HIDDEN), 0.08),
                b1=((HIDDEN,), 0.05), u1=((E, R), 0.1),
                v1=((R, HIDDEN), 0.1), cb1=((HIDDEN,), 0.1),
                w2=((HIDDEN, E), 0.08), b2=((E,), 0.05),
                u2=((HIDDEN, R), 0.1), v2=((R, E), 0.1), cb2=((E,), 0.1),
                ls=((E,), 0.1, 1.0), lb=((E,), 0.1))
    m["dpm"] = np.ones((B, 1, 1), np.float32)
    return m


ATTN_ARGS = ("x", "wq", "bq", "u1", "v1", "wp", "bp", "u2", "v2", "cb2",
             "ls", "lb", "dpm")
MLP_ARGS = ("x", "w1", "b1", "u1", "v1", "cb1", "w2", "b2", "u2", "v2",
            "cb2", "ls", "lb", "dpm")


@pytest.mark.parametrize("np_, n_real", [(40, 33), (24, 24)])
def test_fused_qkv_attention_plain_matches_jax(np_, n_real):
    qkv = _arrays(1, qkv=((B, np_, 3 * E), 0.7))["qkv"]
    ref = np.asarray(j_fqa.fused_qkv_attention(
        jnp.asarray(qkv), HEADS, SM, n_real))
    out = t_fqa.fused_qkv_attention(torch.from_numpy(qkv), HEADS, SM, n_real)
    assert out.shape == (B, np_, E)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("n, n_real, s", [(37, 37, 1.0), (128, 100, 2.0)])
def test_cp_attn_block_plain_matches_jax(n, n_real, s):
    a = _attn_inputs(n)
    ja, ta = _j(a), _t(a)
    ref = np.asarray(j_attn.cp_attn_block(
        *(ja[k] for k in ATTN_ARGS), HEADS, SM, n_real, s, 2, None, EPS))
    out = t_attn.cp_attn_block(*(ta[k] for k in ATTN_ARGS), HEADS, SM,
                               n_real, s, EPS).numpy()
    # Rows >= n_real are padding: the TPU kernel zeroes their residual
    # in-kernel, the port does not pad at all.  Valid rows must agree.
    np.testing.assert_allclose(out[:, :n_real], ref[:, :n_real], **TOL)


@pytest.mark.parametrize("n, s", [(37, 1.0), (16, 2.5)])
def test_cp_mlp_block_plain_matches_jax(n, s):
    m = _mlp_inputs(n, seed=2)
    jm, tm = _j(m), _t(m)
    ref = np.asarray(j_mlp.cp_mlp_block(
        *(jm[k] for k in MLP_ARGS), s, 256, None, "gelu", EPS))
    out = t_mlp.cp_mlp_block(*(tm[k] for k in MLP_ARGS), s, "gelu", EPS)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def _wrapper_call(name):
    if name == "fused_qkv_attention":
        qkv = _t(_arrays(3, qkv=((B, 24, 3 * E), 0.7)))["qkv"]
        return qkv, lambda: t_fqa.fused_qkv_attention(qkv, HEADS, SM, 24)
    if name == "cp_attn_block":
        a = _t(_attn_inputs(24))
        return a["x"], lambda: t_attn.cp_attn_block(
            *(a[k] for k in ATTN_ARGS), HEADS, SM, 24)
    m = _t(_mlp_inputs(24))
    return m["x"], lambda: t_mlp.cp_mlp_block(*(m[k] for k in MLP_ARGS))


@pytest.mark.parametrize("name", ["fused_qkv_attention", "cp_attn_block",
                                  "cp_mlp_block"])
def test_wrapper_refuses_autograd(name):
    x, call = _wrapper_call(name)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        call()
    with torch.no_grad():
        assert torch.isfinite(call()).all()
