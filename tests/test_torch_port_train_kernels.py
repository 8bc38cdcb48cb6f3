"""The port's training block kernels against the JAX kernels they replace.

On the CPU the wrappers run their plain versions (forward and the
explicit backward that mirrors the TPU kernel's rounding points); the JAX
kernels run in Pallas interpret mode, their gradients through
``jax.vjp``.  Inputs are numpy arrays from a seed, everything fp32,
atol = rtol = 1e-4.
"""

import numpy as np
import jax
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
RATE = 0.1
SEED1, SEED2 = -1234567, 2 ** 31 - 1


def _arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in shapes.items():
        shape, std = spec[0], spec[1]
        mean = spec[2] if len(spec) > 2 else 0.0
        out[name] = (mean + std * rng.standard_normal(shape)).astype(
            np.float32)
    return out


def _seeds():
    return ([torch.tensor([[s]], dtype=torch.int32) for s in (SEED1, SEED2)],
            [jnp.array([[s]], jnp.int32) for s in (SEED1, SEED2)])


def _gate(zero_gate):
    return np.array([0.0 if zero_gate else 1.0, 1.0 / 0.9], np.float32)


def _close(out, ref):
    np.testing.assert_allclose(np.asarray(out.detach()), np.asarray(ref),
                               **TOL)


@pytest.mark.parametrize("n, n_real", [(40, 33), (24, 24)])
def test_attention_bwd_plain_matches_jax_vjp(n, n_real):
    a = _arrays(1, qkv=((B, n, 3 * E), 0.7), do=((B, n, E), 1.0))
    _, vjp = jax.vjp(lambda q: j_fqa.fused_qkv_attention(q, HEADS, SM,
                                                         n_real),
                     jnp.asarray(a["qkv"]))
    (ref,) = vjp(jnp.asarray(a["do"]))
    out = t_fqa.attention_bwd_plain(torch.from_numpy(a["qkv"]),
                                    torch.from_numpy(a["do"]), HEADS, SM,
                                    n_real)
    _close(out, ref)


ATTN_ARGS = ("x", "wq", "bq", "u1", "v1", "wp", "bp", "u2", "v2", "cb2",
             "ls", "lb")
ATTN_DIFF = ("x", "u1", "v1", "u2", "v2", "cb2")


# Rank 96 past the kernels' 64-wide rank tile: the fold and the masked
# factor gradients in rank chunks on the card, JAX's rank padded to 128.
# Each factor's std shrinks by (R / r) ** (1 / 4) there, so that the
# delta keeps rank R's size.
@pytest.mark.parametrize("n, n_real, zero_gate, r",
                         [(37, 37, False, R), (40, 33, True, R),
                          (37, 37, False, 96)],
                         ids=["37-37-False", "40-33-True", "37-37-False-r96"])
def test_cp_attn_block_wd_matches_jax(n, n_real, zero_gate, r):
    f = 0.2 * (R / r) ** 0.25
    a = _arrays(3, x=((B, n, E), 1.2), wq=((E, 3 * E), 0.08),
                bq=((3 * E,), 0.05), u1=((E, r), f), v1=((r, 3 * E), f),
                wp=((E, E), 0.08), bp=((E,), 0.05), u2=((E, r), f),
                v2=((r, E), f), cb2=((E,), 0.1), ls=((E,), 0.1, 1.0),
                lb=((E,), 0.1), g=((B, n, E), 1.0))
    a["g"][:, n_real:] = 0.0  # padding rows carry no cotangent
    dpm = _gate(zero_gate).reshape(B, 1)
    (ts1, ts2), (js1, js2) = _seeds()
    ja = {k: jnp.asarray(v) for k, v in a.items()}

    def j_fn(x, u1, v1, u2, v2, cb2):
        return j_attn.cp_attn_block_wd(
            x, ja["wq"], ja["bq"], u1, v1, ja["wp"], ja["bp"], u2, v2, cb2,
            ja["ls"], ja["lb"], jnp.asarray(dpm), js1, js2, HEADS, SM,
            n_real, 1.0, RATE, 2, None, EPS)

    ref, vjp = jax.vjp(j_fn, *(ja[k] for k in ATTN_DIFF))
    ref_grads = vjp(ja["g"])
    ta = {k: torch.from_numpy(v).requires_grad_(k in ATTN_DIFF)
          for k, v in a.items()}
    out = t_attn.cp_attn_block_wd(
        ta["x"], ta["wq"], ta["bq"], ta["u1"], ta["v1"], ta["wp"], ta["bp"],
        ta["u2"], ta["v2"], ta["cb2"], ta["ls"], ta["lb"],
        torch.from_numpy(dpm), ts1, ts2, HEADS, SM, n_real, 1.0, RATE, EPS)
    _close(out[:, :n_real], np.asarray(ref)[:, :n_real])
    plain = t_attn.cp_attn_block_wd_plain(
        *(ta[k].detach() for k in ATTN_ARGS), torch.from_numpy(dpm),
        ts1, ts2, HEADS, SM, n_real, 1.0, RATE, EPS)
    assert torch.equal(plain, out.detach())
    grads = torch.autograd.grad(out, [ta[k] for k in ATTN_DIFF], ta["g"])
    for name, got, want in zip(ATTN_DIFF, grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=name)
    if zero_gate:  # a dropped path: the residual only, in both directions
        assert torch.equal(out[0], ta["x"][0])
        assert torch.equal(grads[0][0], ta["g"][0])


MLP_ARGS = ("x", "w1", "b1", "u1", "v1", "cb1", "w2", "b2", "u2", "v2",
            "cb2", "ls", "lb")
MLP_DIFF = ("x", "u1", "v1", "cb1", "u2", "v2", "cb2")


@pytest.mark.parametrize("n, zero_gate, r", [(37, False, R), (16, True, R),
                                             (37, False, 96)],
                         ids=["37-False", "16-True", "37-False-r96"])
def test_cp_mlp_block_wd_matches_jax(n, zero_gate, r):
    f = 0.2 * (R / r) ** 0.25  # as in the attention block's test
    m = _arrays(4, x=((B, n, E), 1.2), w1=((E, HIDDEN), 0.08),
                b1=((HIDDEN,), 0.05), u1=((E, r), f),
                v1=((r, HIDDEN), f), cb1=((HIDDEN,), 0.1),
                w2=((HIDDEN, E), 0.08), b2=((E,), 0.05),
                u2=((HIDDEN, r), f), v2=((r, E), f), cb2=((E,), 0.1),
                ls=((E,), 0.1, 1.0), lb=((E,), 0.1), g=((B, n, E), 1.0))
    dpm = _gate(zero_gate).reshape(B, 1, 1)
    (ts1, ts2), (js1, js2) = _seeds()
    jm = {k: jnp.asarray(v) for k, v in m.items()}

    def j_fn(x, u1, v1, cb1, u2, v2, cb2):
        return j_mlp.cp_mlp_block_wd(
            x, jm["w1"], jm["b1"], u1, v1, cb1, jm["w2"], jm["b2"], u2, v2,
            cb2, jm["ls"], jm["lb"], jnp.asarray(dpm), js1, js2, 1.0, RATE,
            256, None, "gelu", EPS)

    ref, vjp = jax.vjp(j_fn, *(jm[k] for k in MLP_DIFF))
    ref_grads = vjp(jm["g"])
    tm = {k: torch.from_numpy(v).requires_grad_(k in MLP_DIFF)
          for k, v in m.items()}
    out = t_mlp.cp_mlp_block_wd(
        tm["x"], tm["w1"], tm["b1"], tm["u1"], tm["v1"], tm["cb1"],
        tm["w2"], tm["b2"], tm["u2"], tm["v2"], tm["cb2"], tm["ls"],
        tm["lb"], torch.from_numpy(dpm), ts1, ts2, 1.0, RATE, "gelu", EPS)
    _close(out, ref)
    plain = t_mlp.cp_mlp_block_wd_plain(
        *(tm[k].detach() for k in MLP_ARGS), torch.from_numpy(dpm), ts1,
        ts2, 1.0, RATE, "gelu", EPS)
    assert torch.equal(plain, out.detach())
    grads = torch.autograd.grad(out, [tm[k] for k in MLP_DIFF], tm["g"])
    for name, got, want in zip(MLP_DIFF, grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=name)


def test_wd_blocks_at_rate_zero_are_the_eval_blocks():
    """Rate 0 keeps every element: the training forward equals the eval
    forward on the unfolded factors."""
    a = _arrays(5, x=((B, 17, E), 1.0), wq=((E, 3 * E), 0.08),
                bq=((3 * E,), 0.05), u1=((E, R), 0.2), v1=((R, 3 * E), 0.2),
                wp=((E, E), 0.08), bp=((E,), 0.05), u2=((E, R), 0.2),
                v2=((R, E), 0.2), cb2=((E,), 0.1), ls=((E,), 0.1, 1.0),
                lb=((E,), 0.1))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    dpm = torch.ones((B, 1))
    (s1, s2), _ = _seeds()
    args = (t["x"], t["wq"], t["bq"], t["u1"], t["v1"], t["wp"], t["bp"],
            t["u2"], t["v2"], t["cb2"], t["ls"], t["lb"], dpm)
    wd = t_attn.cp_attn_block_wd(*args, s1, s2, HEADS, SM, 17, 1.0, 0.0, EPS)
    ev = t_attn.cp_attn_block(*args, HEADS, SM, 17, 1.0, EPS)
    np.testing.assert_allclose(wd.detach().numpy(), ev.numpy(), **TOL)
