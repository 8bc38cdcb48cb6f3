"""CP (Canonical-Polyadic) delta contractions (port of ``cara_tpu/ops/cp.py``).

Dense reconstruction (``cp_to_tensor``, what ``merge_cara`` folds into the
backbone), the factorized and materialized deltas of the XLA block forms
and the inverted Bernoulli mask of weight dropout.  The materialized
forms take the element mask on the dense delta (``drop_mask``, the
reference's exact weight dropout), the factorized forms the rank mask
``comp_mask`` on lambda.  Shapes and the up/down transpose asymmetry
follow the JAX module's docstring exactly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def weight_dropout_mask(shape, rate: float, dtype=torch.float32,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> Optional[torch.Tensor]:
    """Inverted-dropout mask ``bernoulli(1 - rate) / (1 - rate)`` in
    ``dtype``, or None when inactive (``rate <= 0``); drawn from
    ``generator``, which gives other bits than ``jax.random``."""
    if rate <= 0.0:
        return None
    keep = 1.0 - rate
    probs = torch.full(tuple(shape), keep, device=device)
    return torch.bernoulli(probs, generator=generator).to(dtype) / keep


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


def qkv_delta_materialized(x, f1, a2, a3, a4, r1, drop_mask=None):
    """Order-4 qkv delta via the dense tensor: (B, N, E) -> (B, N, 3, H, Dh);
    ``drop_mask`` (3, E, H*Dh) multiplies the dense tensor."""
    t = cp_to_tensor(r1, (f1, a2, a3, a4))          # (3, E, H, Dh)
    k, e, h, d = t.shape
    t = t.reshape(k, e, h * d)
    if drop_mask is not None:
        t = t * drop_mask
    delta = torch.einsum("bne,keo->bnko", x, t)
    b, n = x.shape[:2]
    return delta.reshape(b, n, k, h, d)


def qkv_delta_factorized(x, f1, a2, a3, a4, r1, comp_mask=None):
    """Rank-space chain ``(x @ a2) @ M``; never builds (3, E, E);
    ``comp_mask`` (r,) multiplies lambda."""
    lam = r1 if comp_mask is None else r1 * comp_mask
    b, n, _ = x.shape
    k, r = f1.shape
    h, d = a3.shape[0], a4.shape[0]
    m = ((f1 * lam[None, :])[:, None, None, :]
         * a3[None, :, None, :] * a4[None, None, :, :])   # (3, H, Dh, r)
    m = m.reshape(k * h * d, r).T                          # (r, 3E)
    return ((x @ a2) @ m).reshape(b, n, k, h, d)


def rows_delta_out_materialized(x, p1, p2, p3, r2, drop_mask=None):
    """``x @ dropout(T).T`` with ``T = cp(r2, (p1, p2, p3)).reshape(rows*E,
    E)``; ``drop_mask`` (rows*E, E)."""
    t = cp_to_tensor(r2, (p1, p2, p3))
    rows, e2, e3 = t.shape
    t = t.reshape(rows * e2, e3)
    if drop_mask is not None:
        t = t * drop_mask
    return torch.einsum("bne,oe->bno", x, t)


def rows_delta_out_factorized(x, p1, p2, p3, r2, comp_mask=None):
    """Factorized ``x @ T.T``: contract the p3 mode.  (B, N, rows*E)."""
    lam = r2 if comp_mask is None else r2 * comp_mask
    b, n = x.shape[:2]
    rows, r = p1.shape
    e = p2.shape[0]
    m = ((p1 * lam[None, :])[:, None, :] * p2[None, :, :])
    m = m.reshape(rows * e, r).T
    return ((x @ p3) @ m).reshape(b, n, rows * e)


def rows_delta_in_materialized(x, p1, p2, p3, r2, drop_mask=None):
    """``x @ dropout(T)`` (untransposed) — the MLP-down site.  (B, N, E);
    ``drop_mask`` (rows*E, E)."""
    t = cp_to_tensor(r2, (p1, p2, p3))
    rows, e2, e3 = t.shape
    t = t.reshape(rows * e2, e3)
    if drop_mask is not None:
        t = t * drop_mask
    return torch.einsum("bni,ie->bne", x, t)


def rows_delta_in_factorized(x, p1, p2, p3, r2, comp_mask=None):
    """Factorized ``x @ T``: contract (rows, p2), emit the p3 mode."""
    lam = r2 if comp_mask is None else r2 * comp_mask
    rows, r = p1.shape
    e2 = p2.shape[0]
    m = (p1[:, None, :] * p2[None, :, :]).reshape(rows * e2, r)
    return ((x @ m) * lam[None, None, :]) @ p3.T
