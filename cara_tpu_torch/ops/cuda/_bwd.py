"""Launchers of the kernels the backward wrappers compose
(``csrc/grad_gemm.cu``, ``csrc/block_rows.cu``, whose LayerNorm row pass
the forward sites use too, and the rank product of ``csrc/cp_site.cu``),
and the plain LayerNorm input backward they mirror.

These are the products and row passes inside the TPU kernels
``_attn_block_bwd_wd_kernel``, ``_mlp_bwd_wd_kernel``, ``_mlp_bwd_kernel``
and ``_cp_dense_dx_kernel``.  The wrappers count their calls; the GEMM
launcher also counts its launches by layout and epilogue
(``LAUNCHES_NT_DGELU`` and so on), so that a run can show which products
its path went through; the quick_gelu forms of the activation epilogues
count apart (``LAUNCHES_NN_PRE_QUICK_GELU``, ``LAUNCHES_NT_DQUICK_GELU``,
``LAUNCHES_NT_DQUICK_GELU_H``).  Every launcher takes bf16 CUDA tensors
(fp32 where it says so), checks them and raises on what the kernel does
not take.
"""

from __future__ import annotations

import functools
import math

import torch

from cara_tpu_torch.ops.cuda import _build

NN, NT, TN = 0, 1, 2
# The epilogues, numbered as in csrc/sm90_gemm.cuh (4-8 are cp_site.cu's).
EPI_F32, EPI_BF16, EPI_PRE_GELU, EPI_DGELU, EPI_DGELU_H = 0, 1, 2, 3, 9
LAUNCHES_NN_BF16 = LAUNCHES_NN_PRE_GELU = 0
LAUNCHES_NT_BF16 = LAUNCHES_NT_F32 = LAUNCHES_NT_DGELU = 0
LAUNCHES_NT_DGELU_H = LAUNCHES_TN_F32 = 0
LAUNCHES_NN_PRE_QUICK_GELU = LAUNCHES_NT_DQUICK_GELU = 0
LAUNCHES_NT_DQUICK_GELU_H = 0
#: The activations of PRE_GELU, DGELU and DGELU_H, by ``cara_grad_gemm``'s
#: ``act`` code.
ACTS = {"gelu": 0, "quick_gelu": 1}
_ACT_EPIS = (EPI_PRE_GELU, EPI_DGELU, EPI_DGELU_H)
_QUICK_COUNTERS = {(NN, EPI_PRE_GELU): "LAUNCHES_NN_PRE_QUICK_GELU",
                   (NT, EPI_DGELU): "LAUNCHES_NT_DQUICK_GELU",
                   (NT, EPI_DGELU_H): "LAUNCHES_NT_DQUICK_GELU_H"}
_COUNTERS = {(NN, EPI_BF16): "LAUNCHES_NN_BF16",
             (NN, EPI_PRE_GELU): "LAUNCHES_NN_PRE_GELU",
             (NT, EPI_BF16): "LAUNCHES_NT_BF16",
             (NT, EPI_F32): "LAUNCHES_NT_F32",
             (NT, EPI_DGELU): "LAUNCHES_NT_DGELU",
             (NT, EPI_DGELU_H): "LAUNCHES_NT_DGELU_H",
             (TN, EPI_F32): "LAUNCHES_TN_F32"}
_GEMM_BM = 128
_SMS = 132  # the H100's SMs
# The cost of one more split's turn in a TN product's ordered sum (its
# add waits for the one before it), against the whole product: fitted to
# device times of the ViT-B TN shapes by splits on one H100.
_TURN_COST = 0.011
#: The GEMMs' rank k-tile: a rank operand z is 64 wide up to rank 64 and
#: ``rank_width(r)`` = r rounded up to 64 past it, zero past r.
RANK_W = 64


def rank_width(r: int) -> int:
    """Width of the rank operands z and gv of a rank-r site: ``RANK_W``
    up to rank 64, else r rounded up to a multiple of it (the rank step's
    k-tiles of 64)."""
    return -(-max(r, 1) // RANK_W) * RANK_W


def ln_input_bwd_plain(x, dxa, ls, eps: float):
    """d(x) of LayerNorm given d(LN(x)), frozen scale and bias, fp32
    (``cp_mlp._ln_input_bwd``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xn = (xf - mu) * rstd
    dyg = dxa * ls.float()
    return rstd * (dyg - dyg.mean(-1, keepdim=True)
                   - xn * (dyg * xn).mean(-1, keepdim=True))


def _f32(name, key, t, dev):
    if (t.device != dev or t.dtype != torch.float32
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {key} must be a contiguous fp32 tensor "
                         f"on {dev}")


_TURNS = {}


def _turns(dev, n: int):
    """Ordering counters (int32, zero) for the split TN products on the
    current stream, at least ``n``: ``grad_gemm.cu`` sets each back to
    zero as its product ends, so one zeroed buffer a stream serves every
    launch in stream order."""
    key = (dev.index, _build.stream_ptr(dev))
    turns = _TURNS.get(key)
    if turns is None or turns.numel() < n:
        turns = torch.zeros((max(n, 4096),), device=dev, dtype=torch.int32)
        _TURNS[key] = turns
    return turns


def gemm(layout: int, epi: int, a, b, *, bias1=None, bias2=None, aux=None,
         splits: int = 1, a2=None, b2=None, fold_v=None, out=None,
         act: str = "gelu"):
    """One ``grad_gemm.cu`` product; returns the epilogue's outputs.

    NN: a (M, K), b (K, N).  NT: a (M, K), b (N, K).  TN: a (K, M),
    b (K, N), the contraction split over ``splits`` blocks a tile whose
    sums the kernel adds in split order.  F32 -> c32 (M, N), written
    into ``out`` (a contiguous fp32 (M, N) tensor) where it is given;
    BF16 -> c16; PRE_GELU -> (pre fp32, gelu bf16), pre = acc + bias1 +
    bias2; DGELU (``aux`` the fp32 pre-activation) -> (dpre bf16,
    column partial sums (M/128, N) fp32); DGELU_H (``aux`` the bf16
    pre-activation) -> (dpre, column partial sums, h = bf16(gelu(aux))).
    ``act`` ("gelu" or "quick_gelu") is the activation of PRE_GELU, DGELU
    and DGELU_H in place of the GELU.

    NN: ``a2`` (M, ``rank_width(r)``) with ``b2`` = V (r, N) adds the
    rank step ``a2 @ b2`` to the accumulators.  NT: ``fold_v`` V (r, K)
    with ``b2`` = U (N, r8), r8 = r rounded up to 8 (:func:`pad_cols8`),
    folds the rank operand into the product: the kernel accumulates z = a
    V^T in fp32 beside it, rounds z to bf16, adds z @ b2^T and returns gv
    = z (M, ``rank_width(r)``), zero past r, after the epilogue's outputs.
    Past rank 64 gv comes from the rank product first (:func:`rank_z`)
    and the GEMM reads it in k-tiles of 64.  A delta scale rides ``b2``
    (:func:`scaled`)."""
    dev = a.device
    if (layout, epi) not in _COUNTERS:
        raise ValueError(f"grad_gemm has no epilogue {epi} for layout "
                         f"{layout}")
    if act not in ACTS:
        raise ValueError(f"grad_gemm: act must be one of {tuple(ACTS)}, "
                         f"got {act!r}")
    _build.check_cuda_inputs("grad_gemm", dev, a=a, b=b, bias1=bias1,
                             bias2=bias2, a2=a2, b2=b2, fold_v=fold_v)
    if layout == TN:
        k, m = a.shape
        n = b.shape[1]
        ok = b.shape[0] == k
    else:
        m, k = a.shape
        n = b.shape[1] if layout == NN else b.shape[0]
        ok = b.shape[0 if layout == NN else 1] == k
    if not ok:
        raise ValueError(f"grad_gemm: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} do not chain (layout {layout})")
    # 16-byte loads run along the contiguous axis of each operand.
    if n % 8 or (m if layout == TN else k) % 8:
        raise ValueError(f"grad_gemm needs N and the contiguous axis of A "
                         f"to be multiples of 8, got M={m} N={n} K={k} "
                         f"(layout {layout})")
    for key, t in (("bias1", bias1), ("bias2", bias2)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"grad_gemm: {key} must be ({n},)")
    r2 = ldb2 = rfold = 0
    gv = None
    if fold_v is not None:
        rfold = fold_v.shape[0]
        if (layout != NT or a2 is not None or b2 is None
                or fold_v.shape != (rfold, k) or rfold < 1
                or b2.shape != (n, -(-rfold // 8) * 8)):
            raise ValueError(f"grad_gemm folded rank step: v "
                             f"{tuple(fold_v.shape)} b2 "
                             f"{None if b2 is None else tuple(b2.shape)} "
                             f"(layout {layout}, a2 "
                             f"{'set' if a2 is not None else 'None'})")
        if rfold > RANK_W:
            # gv = bf16(a V^T) (M, R) first; the product reads it.
            rw = rank_width(rfold)
            a2 = rank_z(a, fold_v.t())
            b2 = pad_cols(b2, rw)
            gv, fold_v, r2, ldb2 = a2, None, rfold, rw
        else:
            r2 = ldb2 = b2.shape[1]
            gv = torch.empty((m, RANK_W), device=dev, dtype=torch.bfloat16)
    elif a2 is not None:
        r2, ldb2 = b2.shape
        if not (layout == NN and a2.shape == (m, rank_width(r2))
                and r2 >= 1 and b2.shape == (r2, n)):
            raise ValueError(f"grad_gemm rank step: a2 {tuple(a2.shape)} b2 "
                             f"{tuple(b2.shape)} (layout {layout})")
    c32 = c16 = c16b = colpart = None
    if epi == EPI_F32 and out is not None:
        _f32("grad_gemm", "out", out, dev)
        if out.shape != (m, n):
            raise ValueError(f"grad_gemm: out must be ({m}, {n})")
        c32 = out
    elif epi == EPI_F32:
        c32 = torch.empty((m, n), device=dev, dtype=torch.float32)
    turn = None
    if splits > 1:
        turn = _turns(dev, -(-m // _GEMM_BM) * -(-n // _GEMM_BM))
    if epi in (EPI_BF16, EPI_PRE_GELU, EPI_DGELU, EPI_DGELU_H):
        c16 = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
    if epi == EPI_PRE_GELU:
        c32 = torch.empty((m, n), device=dev, dtype=torch.float32)
    if epi in (EPI_DGELU, EPI_DGELU_H):
        if epi == EPI_DGELU:
            _f32("grad_gemm", "aux", aux, dev)
        else:
            _build.check_cuda_inputs("grad_gemm", dev, aux=aux)
            c16b = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
        if aux.shape != (m, n):
            raise ValueError("grad_gemm: aux must be the (M, N) "
                             "pre-activation")
        colpart = torch.empty(((m + _GEMM_BM - 1) // _GEMM_BM, n),
                              device=dev, dtype=torch.float32)
    quick = act == "quick_gelu" and epi in _ACT_EPIS
    code = _build.lib().cara_grad_gemm(
        layout, epi, int(quick), a.data_ptr(), b.data_ptr(),
        _build.ptr(c32), _build.ptr(c16), _build.ptr(c16b),
        _build.ptr(bias1), _build.ptr(bias2),
        _build.ptr(aux), _build.ptr(colpart), _build.ptr(a2),
        _build.ptr(b2), _build.ptr(fold_v), _build.ptr(gv), _build.ptr(turn),
        m, n, k, splits, r2, ldb2, rfold, _build.stream_ptr(dev))
    _build.check(code, "grad_gemm")
    globals()[(_QUICK_COUNTERS if quick else _COUNTERS)[layout, epi]] += 1
    outs = {EPI_F32: (c32,), EPI_BF16: (c16,), EPI_PRE_GELU: (c32, c16),
            EPI_DGELU: (c16, colpart), EPI_DGELU_H: (c16, colpart, c16b)}[epi]
    if gv is not None:
        outs += (gv,)
    return outs[0] if len(outs) == 1 else outs


@functools.lru_cache(maxsize=256)
def dt_splits(m: int, n: int, k: int) -> int:
    """Contraction splits s (1..32) of a TN F32 product (output (m, n),
    contraction k): the s that minimises waves(s) / s + s * (plane / read
    + turn), the time of the product's block waves (``grad_gemm.cu`` runs
    m, n >= 256 as 256-wide blocks, one an SM, other outputs as 128-wide
    blocks, two an SM) plus, for each split, its fp32 add of the output (4
    m n bytes against the operands' 2 k (m + n)) and its turn in the
    ordered sum.  At ViT-B (M = 12608): 2-3 for the dT products, 6-8 for
    the rank-space ones, whose few output tiles must spread the reading
    of the rows over the card."""
    width, slots = (256, _SMS) if min(m, n) >= 256 else (128, 2 * _SMS)
    tiles = -(-m // _GEMM_BM) * -(-n // width)
    plane = 4 * m * n / (2 * k * (m + n))

    def cost(s):
        return -(-tiles * s // slots) / s + s * (plane + _TURN_COST)

    return min(range(1, max(1, min(32, k // 64)) + 1), key=cost)


def rank_z(x2, u):
    """z = bf16(x2 @ U) (M, ``rank_width(r)``), zero past the rank, for
    x2 (M, K) and U (K, r): ``csrc/cp_site.cu``'s rank product alone (U
    may be a view; past rank 64 the kernel reads it zero-padded to the
    width of z)."""
    m, k = x2.shape
    dev = x2.device
    r = u.shape[1]
    if u.shape != (k, r) or r < 1 or k % 8:
        raise ValueError(f"rank_z needs K % 8 == 0 and rank >= 1: x "
                         f"{tuple(x2.shape)} u {tuple(u.shape)}")
    rw = rank_width(r)
    u = pad_cols(u, rw) if r > RANK_W else u.contiguous()
    _build.check_cuda_inputs("rank_z", dev, x=x2, u=u)
    z = torch.empty((m, rw), device=dev, dtype=torch.bfloat16)
    code = _build.lib().cara_rank_z(x2.data_ptr(), u.data_ptr(),
                                    z.data_ptr(), m, k, r,
                                    _build.stream_ptr(dev))
    _build.check(code, "rank_z")
    return z


def scaled(t, s: float):
    """``s * t`` in t's dtype: the kernels take no delta scale, the
    callers fold it into a rank factor or bias (identity at s = 1)."""
    return t if s == 1.0 else (t * s).contiguous()


def _sizes(shapes):
    """Element counts of ``shapes``, each with its size rounded up to 4
    (16 bytes of fp32: every cut starts aligned for 16-byte access)."""
    return [(math.prod(s), -(-math.prod(s) // 4) * 4) for s in shapes]


def flat_buffer(dev, shapes):
    """One fp32 buffer holding tensors of ``shapes`` back to back
    (:func:`cut`): a backward's small gradients, written in place by the
    kernels, then scaled and cast in one launch each."""
    return torch.empty((sum(p for _, p in _sizes(shapes)),), device=dev,
                       dtype=torch.float32)


def cut(flat, shapes):
    """The contiguous views of :func:`flat_buffer`'s tensors in ``flat``
    (or in a copy of it in another dtype)."""
    views, off = [], 0
    for shape, (n, p) in zip(shapes, _sizes(shapes)):
        views.append(flat[off:off + n].view(shape))
        off += p
    return views


def pad_cols(u, width: int):
    """U (K, r) -> (K, width), zero columns past r (contiguous)."""
    k, r = u.shape
    if width == r:
        return u.contiguous()
    out = u.new_zeros((k, width))
    out[:, :r] = u
    return out


def pad_cols8(u):
    """U (K, r) -> (K, r rounded up to 8), zero columns past r: the NT
    rank step's B operand (16-byte rows)."""
    return pad_cols(u, -(-u.shape[1] // 8) * 8)


def pad_rank(u):
    """U (K, r) -> the width the forward kernels read it at: r rounded up
    to 8, and past rank 64 to :func:`rank_width` (their 64-wide rank
    chunks); zero columns past r."""
    r = u.shape[1]
    return pad_cols(u, rank_width(r)) if r > RANK_W else pad_cols8(u)


def factor_grad(a, b, out=None):
    """fp32 ``a^T b`` over the M token rows for a (M, P), b (M, Q), one of
    them a rank operand (``rank_width(r)`` wide): a TN product split over
    M, the splits summed in a fixed order (no unordered atomics).  Reads
    each operand once.  ``out``: as in :func:`gemm`."""
    mrows, p = a.shape
    q = b.shape[1]
    return gemm(TN, EPI_F32, a, b, splits=dt_splits(p, q, mrows), out=out)


def ln_rows(x2, ls, lb, eps: float):
    """xa = bf16(LN(x2)) for x2 (M, K), K % 8 == 0 and K <= 4096."""
    m, k = x2.shape
    dev = x2.device
    _build.check_cuda_inputs("ln_rows", dev, x=x2, ln_scale=ls, ln_bias=lb)
    if k % 8 or k > 4096 or ls.shape != (k,) or lb.shape != (k,):
        raise ValueError(f"ln_rows takes K % 8 == 0, K <= 4096 and (K,) "
                         f"scale and bias, got x {tuple(x2.shape)}")
    out = torch.empty_like(x2)
    code = _build.lib().cara_ln_rows(
        x2.data_ptr(), ls.data_ptr(), lb.data_ptr(), out.data_ptr(), m, k,
        float(eps), _build.stream_ptr(dev))
    _build.check(code, "ln_rows")
    return out


def gate_rows(g2, dpm_rows):
    """bf16(g2 * dpm_rows[:, None]) for g2 (M, N), dpm_rows (M,) fp32."""
    m, n = g2.shape
    dev = g2.device
    _build.check_cuda_inputs("gate_rows", dev, g=g2)
    _f32("gate_rows", "dpm", dpm_rows, dev)
    if dpm_rows.shape != (m,) or n % 8:
        raise ValueError("gate_rows wants dpm (M,) and N % 8 == 0")
    out = torch.empty_like(g2)
    code = _build.lib().cara_gate_rows(
        g2.data_ptr(), dpm_rows.data_ptr(), out.data_ptr(), m, n,
        _build.stream_ptr(dev))
    _build.check(code, "gate_rows")
    return out


def gate_colsum(g2, gate, per: int, ds):
    """bf16(g2 * gate[row // per]) for g2 (M, N) and ``gate`` (M / per,)
    bf16, its fp32 column sums written into ``ds`` (contiguous (N,)), in
    one launch (``block_rows.cu``), every sum in a fixed order."""
    m, n = g2.shape
    dev = g2.device
    _build.check_cuda_inputs("gate_colsum", dev, g=g2)
    # The gates are read one value at a time: any bf16 view (a row of the
    # step's (2, B) gates) will do, aligned or not.
    if (gate.device != dev or gate.dtype != torch.bfloat16
            or not gate.is_contiguous()):
        raise ValueError("gate_colsum: gate must be a contiguous bf16 "
                         f"tensor on {dev}")
    if n % 8 or per < 1 or gate.shape != (-(-m // per),):
        raise ValueError(f"gate_colsum wants N % 8 == 0 and one gate for "
                         f"each {per} rows, got g {tuple(g2.shape)} gate "
                         f"{tuple(gate.shape)}")
    _f32("gate_colsum", "ds", ds, dev)
    if ds.shape != (n,):
        raise ValueError(f"gate_colsum: ds must be ({n},)")
    out = torch.empty_like(g2)
    partial = torch.empty((-(-m // 128), n), device=dev,
                          dtype=torch.float32)
    code = _build.lib().cara_gate_colsum(
        g2.data_ptr(), gate.data_ptr(), per, out.data_ptr(),
        partial.data_ptr(), ds.data_ptr(),
        _turns(dev, -(-n // 256)).data_ptr(), m, n, _build.stream_ptr(dev))
    _build.check(code, "gate_colsum")
    return out


def gate_vector(dpm, lead, dtype):
    """(gate, per) for :func:`gate_colsum`: the drop-path gate ``dpm``,
    broadcastable to ``lead + (1,)``, in ``dtype`` (as JAX casts it to
    x's), one value for each ``per`` rows of the flattened ``lead``: a
    view of a per-image (B, 1, ...) gate, else one value a row."""
    rows = 1
    for d in lead:
        rows *= d
    if (dpm.dim() == len(lead) + 1 and dpm.shape[0] == lead[0]
            and all(d == 1 for d in dpm.shape[1:])):
        return dpm.reshape(-1).to(dtype).contiguous(), rows // lead[0]
    return (torch.broadcast_to(dpm, lead + (1,)).reshape(-1).to(dtype)
            .contiguous(), 1)


def ln_bwd_residual(x2, dxa, ls, g2, eps: float):
    """bf16(g2 + LN'(x2) . dxa): the block's dx (x2, g2 (M, K) bf16, dxa
    (M, K) fp32); ``g2`` None drops the residual term."""
    m, k = x2.shape
    dev = x2.device
    _build.check_cuda_inputs("ln_bwd_residual", dev, x=x2, ln_scale=ls,
                             g=g2)
    _f32("ln_bwd_residual", "dxa", dxa, dev)
    if dxa.shape != (m, k) or (g2 is not None and g2.shape != (m, k)):
        raise ValueError("ln_bwd_residual: x, dxa and g must agree")
    out = torch.empty_like(x2)
    code = _build.lib().cara_ln_bwd_residual(
        x2.data_ptr(), dxa.data_ptr(), ls.data_ptr(), _build.ptr(g2),
        out.data_ptr(), m, k, float(eps), _build.stream_ptr(dev))
    _build.check(code, "ln_bwd_residual")
    return out


def colsum(t, out=None):
    """fp32 column sums of a (M, N) bf16 or fp32 tensor, fixed order;
    into ``out`` (contiguous fp32 (N,)) where it is given."""
    m, n = t.shape
    dev = t.device
    if t.dtype == torch.float32:
        _f32("colsum", "input", t, dev)
    else:
        _build.check_cuda_inputs("colsum", dev, input=t)
    if out is None:
        out = torch.empty((n,), device=dev, dtype=torch.float32)
    _f32("colsum", "out", out, dev)
    partial = torch.empty(((m + 127) // 128, n), device=dev,
                          dtype=torch.float32)
    code = _build.lib().cara_colsum(
        t.data_ptr(), int(t.dtype == torch.float32), out.data_ptr(),
        partial.data_ptr(), m, n, _build.stream_ptr(dev))
    _build.check(code, "colsum")
    return out
