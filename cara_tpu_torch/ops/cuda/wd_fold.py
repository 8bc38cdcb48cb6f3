"""Exact element-wise weight dropout: the hash mask, the folded weight and
the masked factor gradients.

The mask is the TPU package's ``hash_keep``
(``cara_tpu/ops/pallas/cp_dense.py``): element (k, n) of a site's dense
(K, N) delta is kept iff a 32-bit integer hash of the absolute
coordinates and the int32 seed reaches ``rate * 2**32``.  It is never
stored: the forward fold and the backward finish regenerate it.

* :func:`build_wd_weights` replaces ``_build_wd_weight`` (kernel
  ``csrc/wd_fold.cu``): ``W' = W + s/(1-p) * (U V) (.) keep`` rounded
  once, so the block kernels then run on a dense weight.  The TPU kernel
  folds one weight a call; on the H100 a fold takes microseconds (the
  bytes of W and W', and about as long of hash and rank arithmetic), so
  a launch a weight was mostly host cost, and one launch here folds
  every weight of a block call (up to four) over one persistent grid.
  :func:`build_wd_weight` is its one-weight call (the split element
  sites, ``ops/cuda/cp_dense.py``).
* :func:`masked_factor_grads_cuda` is the finish ``masked_site_grads``
  (kernel ``csrc/wd_factor_grads.cu``): ``dtc = bf16(dT (.) keep *
  s/(1-p))``, ``dU = dtc V^T``, ``dV = U^T dtc``; the block backward
  wrappers call it after their ``dT = x^T g`` products.
* :func:`cp_wd_factor_grads` is TPU row 15, ``_cp_wd_factor_grads``
  (``cara_tpu/ops/pallas/cp_dense.py``), the factor gradients of one
  split element-dropout site (``ops/cuda/cp_dense.py`` ``cp_dense_wd``):
  dT = x^T g as ``csrc/grad_gemm.cu``'s TN product, split over the token
  rows and the splits added into one fp32 dT in order, then the masked
  finish on it.  The TPU kernel holds the whole (K, N) fp32 dT in VMEM
  over a sequential grid; on the H100 it makes the round trip through
  device memory (K N 4 B, 7 MB for the qkv site), and the product is
  bound by the tensor cores (2 M K N = 131 GFLOP for qkv at M = 36928
  tokens).

Seeds are int32 tensors of one element on the compute device (the kernels
read them there, so drawing them costs no host sync).  A CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from cara_tpu_torch.ops.cuda import _build, _bwd

#: Number of kernel launches made by :func:`build_wd_weights` (one a
#: call, whatever its number of weights).
LAUNCHES = 0
#: The most weights one launch folds.
MAX_FOLDS = 4
#: Launch pairs (dT product, masked finish) of :func:`cp_wd_factor_grads`.
FACTOR_LAUNCHES = 0
#: Launches of the masked finish (``csrc/wd_factor_grads.cu``) by any
#: caller: :func:`cp_wd_factor_grads` and the block backwards of rows 8
#: and 11.
MASKED_LAUNCHES = 0

_M32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """The uint32 threshold of the mask, computed as ``hash_keep`` does."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) without int64
    overflow: ``c`` is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def hash_keep_plain(k0: int, n0: int, bk: int, bn: int, seed,
                    rate: float, device=None) -> torch.Tensor:
    """(bk, bn) bool keep mask of the plane's block at absolute offset
    (k0, n0); bit for bit ``cp_dense.hash_keep``.  ``seed`` is an int or
    a one-element integer tensor (int32, reinterpreted as uint32)."""
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        sd = seed.reshape(()).to(device=device, dtype=torch.int64) & _M32
    else:
        sd = int(seed) & _M32
    ki = torch.arange(k0, k0 + bk, device=device, dtype=torch.int64)[:, None]
    ni = torch.arange(n0, n0 + bn, device=device, dtype=torch.int64)[None, :]
    h = (_mul32(ki & _M32, 0x9E3779B1) + _mul32(ni & _M32, 0x85EBCA77)) & _M32
    h = h ^ sd
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h >= keep_threshold(rate)


def build_wd_weight_plain(w, u, v, seed, s: float, rate: float):
    """Plain twin of :func:`build_wd_weight`: the rank-r product in fp32,
    masked and scaled, added to W in fp32 and rounded to ``w.dtype``."""
    k, n = w.shape
    d = u.float() @ v.float()
    keep = hash_keep_plain(0, 0, k, n, seed, rate, w.device)
    d = torch.where(keep, d * (s / (1.0 - rate)), torch.zeros_like(d))
    return (w.float() + d).to(w.dtype)


def zero_rank(x, k: int, n: int):
    """Rank-0 (U, V) for a (K, N) site: the masked delta already sits in
    the folded weight (the TPU wrappers' ``_zero_uv``)."""
    return x.new_zeros((k, 0)), x.new_zeros((0, n))


def _check_seed(name, seed, device):
    if (not isinstance(seed, torch.Tensor) or seed.numel() != 1
            or seed.dtype != torch.int32 or seed.device != device):
        raise ValueError(f"{name}: the seed must be a one-element int32 "
                         f"tensor on {device}")


def _check_rank(name, r):
    if r < 1:
        raise ValueError(f"{name}: the kernel takes a rank of at least 1, "
                         f"got {r}")


def build_wd_weights_plain(sites, s: float, rate: float):
    """Plain twin of :func:`build_wd_weights`: each site's
    :func:`build_wd_weight_plain`."""
    return [build_wd_weight_plain(w, u, v, seed, s, rate)
            for w, u, v, seed in sites]


def build_wd_weights(sites, s: float, rate: float):
    """Folded masked weights ``[W'_i]`` (K_i, N_i) of ``sites``, a list of
    (W (K, N), U (K, r), V (r, N), seed) sharing the delta scale ``s`` and
    the drop rate ``rate``: one launch on the card (at most
    ``MAX_FOLDS`` sites)."""
    global LAUNCHES
    if not 1 <= len(sites) <= MAX_FOLDS:
        raise ValueError(f"build_wd_weights folds 1..{MAX_FOLDS} weights "
                         f"a call, got {len(sites)}")
    for w, u, v, _ in sites:
        k, n = w.shape
        r = u.shape[1]
        if u.shape != (k, r) or v.shape != (r, n):
            raise ValueError(f"build_wd_weight shapes: w {tuple(w.shape)} "
                             f"u {tuple(u.shape)} v {tuple(v.shape)}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"drop rate must be in [0, 1), got {rate}")
    dev = sites[0][0].device
    if any(t.device != dev for site in sites for t in site[:3]):
        raise ValueError("build_wd_weights: the sites lie on different "
                         "devices")
    if dev.type == "cpu":
        return build_wd_weights_plain(sites, s, rate)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    outs, desc = [], []
    for w, u, v, seed in sites:
        k, n = w.shape
        _build.check_cuda_inputs("wd_fold", dev, w=w, u=u, v=v)
        _check_seed("wd_fold", seed, dev)
        _check_rank("wd_fold", u.shape[1])
        if n % 8:
            raise ValueError(f"wd_fold needs N % 8 == 0, got N={n}")
        out = torch.empty_like(w)
        outs.append(out)
        desc += [w.data_ptr(), u.data_ptr(), v.data_ptr(), seed.data_ptr(),
                 out.data_ptr(), k, n, u.shape[1]]
    code = _build.lib().cara_wd_fold(
        len(sites), (ctypes.c_longlong * len(desc))(*desc),
        float(s / (1.0 - rate)), keep_threshold(rate),
        _build.stream_ptr(dev))
    _build.check(code, "wd_fold")
    LAUNCHES += 1
    return outs


def build_wd_weight(w, u, v, seed, s: float, rate: float):
    """Folded masked weight ``W'`` (K, N) in ``w.dtype``: W (K, N),
    U (K, r), V (r, N); ``s`` the delta scale, ``rate`` the drop rate
    (:func:`build_wd_weights` of one site)."""
    return build_wd_weights([(w, u, v, seed)], s, rate)[0]


def masked_factor_grads_plain(dt, u, v, seed, s: float, rate: float,
                              work_dtype):
    """Plain twin of the masked finish: dt (K, N) fp32 -> (dU (K, r),
    dV (r, N)) fp32, with ``dtc`` rounded to ``work_dtype``."""
    k, n = dt.shape
    keep = hash_keep_plain(0, 0, k, n, seed, rate, dt.device)
    dtc = torch.where(keep, dt * (s / (1.0 - rate)), torch.zeros_like(dt))
    dtc = dtc.to(work_dtype).float()
    return dtc @ v.float().t(), u.float().t() @ dtc


def masked_factor_grads_cuda(dt, u, v, seed, s: float, rate: float,
                             out=None):
    """Launch ``csrc/wd_factor_grads.cu`` on ``dt`` (K, N) fp32, counted
    in :data:`MASKED_LAUNCHES` (the block backward wrappers call this
    directly); ``out``: contiguous fp32 (dU, dV) to write into, or
    None."""
    global MASKED_LAUNCHES
    k, n = dt.shape
    r = u.shape[1]
    dev = dt.device
    _build.check_cuda_inputs("wd_factor_grads", dev, u=u, v=v)
    _check_seed("wd_factor_grads", seed, dev)
    _check_rank("wd_factor_grads", r)
    if (dt.dtype != torch.float32 or not dt.is_contiguous()
            or u.shape != (k, r) or v.shape != (r, n)):
        raise ValueError("wd_factor_grads wants contiguous fp32 (K, N) dT, "
                         "u (K, r) and v (r, N)")
    if out is None:
        du = torch.empty((k, r), device=dev, dtype=torch.float32)
        dv = torch.empty((r, n), device=dev, dtype=torch.float32)
    else:
        du, dv = out
        if (du.shape != (k, r) or dv.shape != (r, n) or any(
                t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != dev for t in out)):
            raise ValueError("wd_factor_grads: out must be contiguous fp32 "
                             "(K, r) and (r, N) on dT's device")
    dv_part = torch.empty(((k + 7) // 8, r, n), device=dev,
                          dtype=torch.float32)
    du_part = torch.empty(((n + 255) // 256, k, r), device=dev,
                          dtype=torch.float32)
    code = _build.lib().cara_wd_factor_grads(
        dt.data_ptr(), u.data_ptr(), v.data_ptr(),
        seed.data_ptr(), du.data_ptr(), dv.data_ptr(), dv_part.data_ptr(),
        du_part.data_ptr(), k, n, r, float(s / (1.0 - rate)),
        keep_threshold(rate), _build.stream_ptr(dev))
    _build.check(code, "wd_factor_grads")
    MASKED_LAUNCHES += 1
    return du, dv


def cp_wd_factor_grads_plain(xa, g2, u, v, seed, s: float, rate: float):
    """Plain twin of :func:`cp_wd_factor_grads`: fp32 dT = xa^T g2, then
    the masked finish with ``dtc`` rounded to ``xa.dtype``
    (``masked_site_grads``)."""
    dt = xa.float().t() @ g2.float()
    return masked_factor_grads_plain(dt, u, v, seed, s, rate, xa.dtype)


def cp_wd_factor_grads(xa, g2, u, v, seed, s: float, rate: float):
    """(dU (K, r), dV (r, N)) fp32 of a site with element-wise weight
    dropout, from its input xa (M, K) (LN(x) for an LN site) and output
    cotangent g2 (M, N): TPU row 15.  U (K, r), V (r, N); ``seed`` the
    site's one-element int32 mask seed on the device."""
    global FACTOR_LAUNCHES
    m, k = xa.shape
    n = g2.shape[1]
    if g2.shape[0] != m or u.shape[0] != k or v.shape[1] != n:
        raise ValueError(f"cp_wd_factor_grads shapes: xa {tuple(xa.shape)} "
                         f"g {tuple(g2.shape)} u {tuple(u.shape)} v "
                         f"{tuple(v.shape)}")
    if xa.device.type == "cpu":
        return cp_wd_factor_grads_plain(xa, g2, u, v, seed, s, rate)
    if xa.device.type != "cuda":
        raise ValueError(f"no kernel for device {xa.device}")
    dt = _bwd.gemm(_bwd.TN, _bwd.EPI_F32, xa, g2,
                   splits=_bwd.dt_splits(k, n, m))
    out = masked_factor_grads_cuda(dt, u, v, seed, s, rate)
    FACTOR_LAUNCHES += 1
    return out
