"""The saved-residual modes of the block kernels against JAX's.

``CARA_MLP_SAVE_PRE`` (the MLP block keeps its pre-activation for the
backward, rows 10 and 11) and ``CARA_ATTN_SAVE_QKV`` (the attention block
with element-wise weight dropout keeps qkv, and in the port also the
attention output, row 8), each forced to "1" on both sides
(``cara_tpu.ops.pallas.cp_mlp._SAVE_PRE`` / ``cp_attn_block._SAVE_QKV``
and the port's twins).  On the CPU the port runs its plain versions at
the saved mode's rounding points, JAX its Pallas kernels in interpret
mode; forwards and ``jax.vjp`` cotangents in fp32 within atol = rtol =
1e-4, and the saved MLP backward's plain twin against
``_mlp_bwd_kernel(saved_pre=True)`` in bf16 on the same saved
pre-activation.  Then the switch rule: "auto" is off on the CPU and on
for CUDA tensors, "1" / "0" force, only a forward that autograd records
keeps anything, and the value is read from the environment at import.
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cara_tpu_torch.ops.cuda import cp_attn_block as t_attn
from cara_tpu_torch.ops.cuda import cp_mlp as t_mlp
from cara_tpu.ops.pallas import cp_attn_block as j_attn
from cara_tpu.ops.pallas import cp_mlp as j_mlp

TOL = dict(atol=1e-4, rtol=1e-4)
E, HEADS, R, HIDDEN, B = 64, 4, 4, 256, 2
SM = (E // HEADS) ** -0.5
EPS = 1e-6
RATE = 0.1
SEED1, SEED2 = -1234567, 2 ** 31 - 1
MLP_ARGS = ("x", "w1", "b1", "u1", "v1", "cb1", "w2", "b2", "u2", "v2",
            "cb2", "ls", "lb")
MLP_DIFF = ("x", "u1", "v1", "cb1", "u2", "v2", "cb2")
ATTN_ARGS = ("x", "wq", "bq", "u1", "v1", "wp", "bp", "u2", "v2", "cb2",
             "ls", "lb")
ATTN_DIFF = ("x", "u1", "v1", "u2", "v2", "cb2")


def _arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in shapes.items():
        shape, std = spec[0], spec[1]
        mean = spec[2] if len(spec) > 2 else 0.0
        out[name] = (mean + std * rng.standard_normal(shape)).astype(
            np.float32)
    return out


def _mlp_arrays(seed, n):
    return _arrays(seed, x=((B, n, E), 1.2), w1=((E, HIDDEN), 0.08),
                   b1=((HIDDEN,), 0.05), u1=((E, R), 0.2),
                   v1=((R, HIDDEN), 0.2), cb1=((HIDDEN,), 0.1),
                   w2=((HIDDEN, E), 0.08), b2=((E,), 0.05),
                   u2=((HIDDEN, R), 0.2), v2=((R, E), 0.2), cb2=((E,), 0.1),
                   ls=((E,), 0.1, 1.0), lb=((E,), 0.1), g=((B, n, E), 1.0))


def _seeds():
    return ([torch.tensor([[s]], dtype=torch.int32) for s in (SEED1, SEED2)],
            [jnp.array([[s]], jnp.int32) for s in (SEED1, SEED2)])


def _gate(zero_gate):
    return np.array([0.0 if zero_gate else 1.0, 1.0 / 0.9], np.float32)


@pytest.fixture
def saved(monkeypatch):
    """Both sides in the saved modes; the port's backwards record the
    saved residuals they were given."""
    for mod in (j_mlp, t_mlp):
        monkeypatch.setattr(mod, "_SAVE_PRE", "1")
    for mod in (j_attn, t_attn):
        monkeypatch.setattr(mod, "_SAVE_QKV", "1")
    seen = []

    def spy(mod, name, keys):
        fn = getattr(mod, name)

        def wrapped(*args, **kw):
            seen.append((name, {k: kw.get(k) is not None for k in keys}))
            return fn(*args, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    spy(t_mlp, "cp_mlp_block_bwd_plain", ("pre",))
    spy(t_mlp, "cp_mlp_block_wd_bwd_plain", ("pre",))
    spy(t_attn, "cp_attn_block_wd_bwd_plain", ("qkv", "o"))
    return seen


def _check_grads(grads, ref_grads, names):
    for name, got, want in zip(names, grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("n, zero_gate", [(37, False), (16, True)])
def test_cp_mlp_block_saved_pre_matches_jax(saved, n, zero_gate):
    """Row 10 in the save-pre mode: ``cp_mlp_block``'s forward and every
    cotangent against ``jax.vjp`` of JAX's save-pre kernels."""
    m = _mlp_arrays(6, n)
    dpm = _gate(zero_gate).reshape(B, 1, 1)
    jm = {k: jnp.asarray(v) for k, v in m.items()}

    def j_fn(x, u1, v1, cb1, u2, v2, cb2):
        return j_mlp.cp_mlp_block(
            x, jm["w1"], jm["b1"], u1, v1, cb1, jm["w2"], jm["b2"], u2, v2,
            cb2, jm["ls"], jm["lb"], jnp.asarray(dpm), 1.0, 256, None,
            "gelu", EPS)

    ref, vjp = jax.vjp(j_fn, *(jm[k] for k in MLP_DIFF))
    ref_grads = vjp(jm["g"])
    tm = {k: torch.from_numpy(v).requires_grad_(k in MLP_DIFF)
          for k, v in m.items()}
    out = t_mlp.cp_mlp_block(*(tm[k] for k in MLP_ARGS),
                             torch.from_numpy(dpm), 1.0, "gelu", EPS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    grads = torch.autograd.grad(out, [tm[k] for k in MLP_DIFF], tm["g"])
    _check_grads(grads, ref_grads, MLP_DIFF)
    assert saved == [("cp_mlp_block_bwd_plain", {"pre": True})]


@pytest.mark.parametrize("n, zero_gate", [(37, False), (16, True)])
def test_cp_mlp_block_wd_saved_pre_matches_jax(saved, n, zero_gate):
    """Row 11 in the save-pre mode (``_mlp_bwd_wd_pre_kernel``)."""
    m = _mlp_arrays(7, n)
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
    out = t_mlp.cp_mlp_block_wd(*(tm[k] for k in MLP_ARGS),
                                torch.from_numpy(dpm), ts1, ts2, 1.0, RATE,
                                "gelu", EPS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    grads = torch.autograd.grad(out, [tm[k] for k in MLP_DIFF], tm["g"])
    _check_grads(grads, ref_grads, MLP_DIFF)
    assert saved == [("cp_mlp_block_wd_bwd_plain", {"pre": True})]


@pytest.mark.parametrize("s", [1.0, 2.5], ids=["s1", "s2.5"])
@pytest.mark.parametrize("n, n_real, zero_gate",
                         [(37, 37, False), (40, 33, True)])
def test_cp_attn_block_wd_saved_qkv_matches_jax(saved, s, n, n_real,
                                                zero_gate):
    """Row 8 in the save-qkv mode (``_attn_block_bwd_wd_kernel(
    saved_qkv=True)``; the port keeps the attention output too), at delta
    scale ``s`` 1 and 2.5 (the backward scales dcb2 by it)."""
    a = _arrays(8, x=((B, n, E), 1.2), wq=((E, 3 * E), 0.08),
                bq=((3 * E,), 0.05), u1=((E, R), 0.2), v1=((R, 3 * E), 0.2),
                wp=((E, E), 0.08), bp=((E,), 0.05), u2=((E, R), 0.2),
                v2=((R, E), 0.2), cb2=((E,), 0.1), ls=((E,), 0.1, 1.0),
                lb=((E,), 0.1), g=((B, n, E), 1.0))
    a["g"][:, n_real:] = 0.0  # padding rows carry no cotangent
    dpm = _gate(zero_gate).reshape(B, 1)
    (ts1, ts2), (js1, js2) = _seeds()
    ja = {k: jnp.asarray(v) for k, v in a.items()}

    def j_fn(x, u1, v1, u2, v2, cb2):
        return j_attn.cp_attn_block_wd(
            x, ja["wq"], ja["bq"], u1, v1, ja["wp"], ja["bp"], u2, v2, cb2,
            ja["ls"], ja["lb"], jnp.asarray(dpm), js1, js2, HEADS, SM,
            n_real, s, RATE, 2, None, EPS)

    ref, vjp = jax.vjp(j_fn, *(ja[k] for k in ATTN_DIFF))
    ref_grads = vjp(ja["g"])
    ta = {k: torch.from_numpy(v).requires_grad_(k in ATTN_DIFF)
          for k, v in a.items()}
    out = t_attn.cp_attn_block_wd(*(ta[k] for k in ATTN_ARGS),
                                  torch.from_numpy(dpm), ts1, ts2, HEADS, SM,
                                  n_real, s, RATE, EPS)
    np.testing.assert_allclose(out.detach().numpy()[:, :n_real],
                               np.asarray(ref)[:, :n_real], **TOL)
    grads = torch.autograd.grad(out, [ta[k] for k in ATTN_DIFF], ta["g"])
    _check_grads(grads, ref_grads, ATTN_DIFF)
    assert saved == [("cp_attn_block_wd_bwd_plain",
                      {"qkv": True, "o": True})]


def test_saved_mlp_backward_plain_twin_matches_jax_in_bf16():
    """The saved MLP backward's plain twin against JAX's saved kernel in
    bf16 on the same inputs and the same saved bf16 pre-activation (JAX's
    own, from ``_mlp_fwd_save_pre_kernel``): the twin rounds where the
    kernel does (g2, xa, z1, h = gelu(pre), gv1, gv2, dpre, z2), so the
    two differ only in the order of fp32 sums, which can flip a bf16
    rounding: dx (bf16) within 2e-2 + 2e-2 |ref| elementwise, the factor
    and bias gradients (fp32 sums over the rows) within 1e-2 relative
    L2.  The port's own saved pre (its plain forward) agrees with JAX's
    within one bf16 ulp."""
    n = 37
    m = _mlp_arrays(9, n)
    dpm = _gate(True).reshape(B, 1, 1)
    bf = jnp.bfloat16
    jm = {k: jnp.asarray(v).astype(bf) for k, v in m.items()}
    tm = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in m.items()}
    x2 = jm["x"].reshape(-1, E)
    dpm2 = jnp.broadcast_to(jnp.asarray(dpm), (B, n, 1)).reshape(-1, 1)
    dpm2 = dpm2.astype(bf)
    args = (jm["w1"], jm["b1"], jm["u1"], jm["v1"], jm["cb1"], jm["w2"],
            jm["b2"], jm["u2"], jm["v2"], jm["cb2"], jm["ls"], jm["lb"],
            dpm2, 1.0, 256, None, "gelu", EPS)
    _, pre2p = j_mlp._mlp_fwd_raw(x2, *args, save_pre=True)
    ref = j_mlp._mlp_bwd_raw(
        x2, jm["g"].reshape(-1, E), jm["w1"], jm["b1"], jm["u1"], jm["v1"],
        jm["cb1"], jm["w2"], jm["u2"], jm["v2"], jm["ls"], jm["lb"], dpm2,
        1.0, 256, None, "gelu", EPS, pre2p=pre2p)
    pre = torch.from_numpy(
        np.array(pre2p[:B * n].astype(jnp.float32))).to(torch.bfloat16)
    tdpm = torch.from_numpy(dpm).to(torch.bfloat16)
    _, own_pre = t_mlp._mlp_block_plain(
        *(tm[k] for k in MLP_ARGS), tdpm, 1.0, "gelu", EPS)
    ulp = torch.finfo(torch.bfloat16).eps * pre.float().abs()
    own_pre = own_pre.to(torch.bfloat16).float().reshape(-1, HIDDEN)
    assert ((own_pre - pre.float()).abs() <= ulp.clamp_min(1e-6)).all()
    got = t_mlp.cp_mlp_block_bwd_plain(
        tm["g"], tm["x"], tm["w1"], tm["b1"], tm["u1"], tm["v1"], tm["cb1"],
        tm["w2"], tm["u2"], tm["v2"], tm["ls"], tm["lb"], tdpm, 1.0, "gelu",
        EPS, pre=pre)
    # JAX: (dx, du1, dv1, du2, dv2, ds1, ds2); the port: (dx, du1, dv1,
    # dcb1, du2, dv2, dcb2), dcb = s * ds at s = 1.
    want = dict(zip(("dx", "du1", "dv1", "du2", "dv2", "ds1", "ds2"),
                    (np.asarray(t.astype(jnp.float32)) for t in ref)))
    have = dict(zip(("dx", "du1", "dv1", "ds1", "du2", "dv2", "ds2"),
                    (t.float().numpy() for t in got)))
    np.testing.assert_allclose(have["dx"].reshape(-1, E), want["dx"],
                               atol=2e-2, rtol=2e-2)
    for key in ("du1", "dv1", "du2", "dv2", "ds1", "ds2"):
        diff = np.linalg.norm(have[key] - want[key])
        assert diff <= 1e-2 * np.linalg.norm(want[key]), key


def test_save_switch_rule(monkeypatch):
    """"auto" keeps the residual for CUDA tensors only (JAX: for the
    TPU), "1" and "0" force it either way, as ``_save_pre_on`` /
    ``_save_qkv_on`` do."""
    cpu = torch.zeros(1)
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    for mod, fn in ((t_mlp, "_save_pre_on"), (t_attn, "_save_qkv_on")):
        attr = "_SAVE_PRE" if mod is t_mlp else "_SAVE_QKV"
        for value, want_cpu, want_card in (("auto", False, True),
                                           ("1", True, True),
                                           ("0", False, False)):
            monkeypatch.setattr(mod, attr, value)
            assert getattr(mod, fn)(cpu) is want_cpu, (attr, value)
            assert getattr(mod, fn)(card) is want_card, (attr, value)


def test_only_a_recorded_forward_keeps_the_residuals(monkeypatch):
    """With both switches forced on, a forward under ``torch.no_grad``
    (serving, eval) or on inputs that need no gradient keeps nothing; a
    recorded one keeps the pre-activation, qkv and o."""
    monkeypatch.setattr(t_mlp, "_SAVE_PRE", "1")
    monkeypatch.setattr(t_attn, "_SAVE_QKV", "1")
    flags = []
    for fn in (t_mlp._MlpBlock, t_mlp._MlpBlockWd, t_attn._AttnBlockWd):
        apply = fn.apply

        def spy(*args, _apply=apply):
            flags.append(args[-1])
            return _apply(*args)

        monkeypatch.setattr(fn, "apply", spy)
    m = {k: torch.from_numpy(v) for k, v in _mlp_arrays(10, 9).items()}
    a = {k: torch.from_numpy(v) for k, v in _arrays(
        11, x=((B, 9, E), 1.0), wq=((E, 3 * E), 0.08), bq=((3 * E,), 0.05),
        u1=((E, R), 0.2), v1=((R, 3 * E), 0.2), wp=((E, E), 0.08),
        bp=((E,), 0.05), u2=((E, R), 0.2), v2=((R, E), 0.2),
        cb2=((E,), 0.1), ls=((E,), 0.1, 1.0), lb=((E,), 0.1)).items()}
    (s1, s2), _ = _seeds()
    gm, ga = torch.ones((B, 1, 1)), torch.ones((B, 1))

    def calls(requires_grad):
        mm = {k: v.clone().requires_grad_(requires_grad and k in MLP_DIFF)
              for k, v in m.items()}
        aa = {k: v.clone().requires_grad_(requires_grad and k in ATTN_DIFF)
              for k, v in a.items()}
        t_mlp.cp_mlp_block(*(mm[k] for k in MLP_ARGS), gm)
        t_mlp.cp_mlp_block_wd(*(mm[k] for k in MLP_ARGS), gm, s1, s2, 1.0,
                              RATE)
        t_attn.cp_attn_block_wd(*(aa[k] for k in ATTN_ARGS), ga, s1, s2,
                                HEADS, SM, 9, 1.0, RATE)

    with torch.no_grad():
        calls(True)
    calls(False)
    assert flags == [False] * 6
    calls(True)
    assert flags[6:] == [True] * 3


def test_save_switches_are_read_from_the_environment():
    """``CARA_MLP_SAVE_PRE`` and ``CARA_ATTN_SAVE_QKV`` are read at import,
    as JAX reads them; unset, both are "auto"."""
    code = ("import json; from cara_tpu_torch.ops.cuda import cp_mlp, "
            "cp_attn_block; print(json.dumps([cp_mlp._SAVE_PRE, "
            "cp_attn_block._SAVE_QKV]))")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CARA_MLP_SAVE_PRE", "CARA_ATTN_SAVE_QKV")}
    for extra, want in (({}, ["auto", "auto"]),
                        ({"CARA_MLP_SAVE_PRE": "0",
                          "CARA_ATTN_SAVE_QKV": "1"}, ["0", "1"])):
        proc = subprocess.run([sys.executable, "-c", code],
                              env=dict(env, **extra), capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == want
