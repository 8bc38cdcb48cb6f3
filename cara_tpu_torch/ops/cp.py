"""CP (Canonical-Polyadic) delta contractions (port of ``cara_tpu/ops/cp.py``).

The eval subset: dense reconstruction (``cp_to_tensor``, what
``merge_cara`` folds into the backbone) and the factorized / materialized
deltas without weight dropout.  Shapes and the up/down transpose
asymmetry follow the JAX module's docstring exactly.
"""

from __future__ import annotations

from typing import Sequence

import torch


def cp_to_tensor(weights: torch.Tensor,
                 factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``T[i0,...,ik] = sum_r w[r] * prod_m factors[m][i_m, r]``
    (``tensorly.cp_to_tensor``), by a running Khatri-Rao product."""
    r = weights.shape[-1]
    out = weights.reshape(1, r)
    for f in factors:
        out = (out[:, None, :] * f[None, :, :]).reshape(-1, r)
    shape = tuple(f.shape[0] for f in factors)
    return out.sum(dim=-1).reshape(shape)


def qkv_delta_materialized(x, f1, a2, a3, a4, r1):
    """Order-4 qkv delta via the dense tensor: (B, N, E) -> (B, N, 3, H, Dh)."""
    t = cp_to_tensor(r1, (f1, a2, a3, a4))          # (3, E, H, Dh)
    k, e, h, d = t.shape
    delta = torch.einsum("bne,keo->bnko", x, t.reshape(k, e, h * d))
    b, n = x.shape[:2]
    return delta.reshape(b, n, k, h, d)


def qkv_delta_factorized(x, f1, a2, a3, a4, r1):
    """Rank-space chain ``(x @ a2) @ M``; never builds (3, E, E)."""
    b, n, _ = x.shape
    k, r = f1.shape
    h, d = a3.shape[0], a4.shape[0]
    m = ((f1 * r1[None, :])[:, None, None, :]
         * a3[None, :, None, :] * a4[None, None, :, :])   # (3, H, Dh, r)
    m = m.reshape(k * h * d, r).T                          # (r, 3E)
    return ((x @ a2) @ m).reshape(b, n, k, h, d)


def rows_delta_out_materialized(x, p1, p2, p3, r2):
    """``x @ T.T`` with ``T = cp(r2, (p1, p2, p3)).reshape(rows*E, E)``."""
    t = cp_to_tensor(r2, (p1, p2, p3))
    rows, e2, e3 = t.shape
    return torch.einsum("bne,oe->bno", x, t.reshape(rows * e2, e3))


def rows_delta_out_factorized(x, p1, p2, p3, r2):
    """Factorized ``x @ T.T``: contract the p3 mode.  (B, N, rows*E)."""
    b, n = x.shape[:2]
    rows, r = p1.shape
    e = p2.shape[0]
    m = ((p1 * r2[None, :])[:, None, :] * p2[None, :, :])
    m = m.reshape(rows * e, r).T
    return ((x @ p3) @ m).reshape(b, n, rows * e)


def rows_delta_in_materialized(x, p1, p2, p3, r2):
    """``x @ T`` (untransposed) — the MLP-down site.  (B, N, E)."""
    t = cp_to_tensor(r2, (p1, p2, p3))
    rows, e2, e3 = t.shape
    return torch.einsum("bni,ie->bne", x, t.reshape(rows * e2, e3))


def rows_delta_in_factorized(x, p1, p2, p3, r2):
    """Factorized ``x @ T``: contract (rows, p2), emit the p3 mode."""
    rows, r = p1.shape
    e2 = p2.shape[0]
    m = (p1[:, None, :] * p2[None, :, :]).reshape(rows * e2, r)
    return ((x @ m) * r2[None, None, :]) @ p3.T
