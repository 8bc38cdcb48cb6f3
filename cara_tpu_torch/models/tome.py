"""ToMe (Token Merging) for serving a ViT with fewer tokens a layer (port
of ``cara_tpu/models/tome.py``).

Bolya et al., "Token Merging: Your ViT But Faster" (ICLR 2023,
arXiv:2210.09461).  Between the attention and the MLP half of every
block, the ``r`` most similar token pairs (bipartite soft matching on the
attention keys, averaged over heads) merge by size-weighted average, and
the attention becomes proportional (``softmax(q k^T / sqrt(d) + log s)``)
so that a token standing for ``s`` patches votes with weight ``s``.

Eval only and opt-in (``serving.Predictor(tome_r=...)``, ``cli.serve
--tome-r``, ``cli.predict --tome-r``); it changes the math, at the
paper's off-the-shelf cost of about 0.1-0.5 top-1 on ViT-B/16 at r <= 13.
It runs dense backbones (merged or plain) and their int8 forms of
``models/quant.py``: each GEMM is ``models.vit``'s XLA dense form
(``F.linear``, or ``matk`` on a quant dict, which with
``CARA_INT8_PALLAS=1`` on the card launches the dequant-fused int8 kernel,
TPU row 18, at each layer's shrinking M).  JAX runs ToMe's attention as
the XLA ``mha`` with a key bias, outside any Pallas kernel, so the plain
``ops.layers.mha`` is its port.  The merge's sum over the tokens that
share a destination is a product with their one-hot matrix, not an
``index_add_``, whose atomic sums on the card come in no fixed order: two
calls on one batch give the same bits, as JAX's serving does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from cara_tpu_torch.config import ViTConfig
from cara_tpu_torch.models.vit import _dense, _unstack, patch_embed
from cara_tpu_torch.ops.layers import activation, layer_norm, linear, mha


def merge_schedule(cfg: ViTConfig, r: int) -> Tuple[int, ...]:
    """Per-layer merge counts of a constant-``r`` schedule, each clamped
    as the official implementation does, ``r_l = min(r, (n_l -
    protected) // 2)`` with the cls token protected, so that merging never
    consumes the sequence."""
    if r < 0:
        raise ValueError(f"tome r must be >= 0, got {r}")
    protected = 1 if cfg.use_cls_token else 0
    out, n = [], cfg.seq_len
    for _ in range(cfg.depth):
        rl = max(0, min(r, (n - protected) // 2))
        out.append(rl)
        n -= rl
    return tuple(out)


def token_counts(cfg: ViTConfig, r: int) -> Tuple[int, ...]:
    """The token count entering each layer."""
    ns, n = [], cfg.seq_len
    for rl in merge_schedule(cfg, r):
        ns.append(n)
        n -= rl
    return tuple(ns)


def _bipartite_indices(metric: torch.Tensor, r: int, protect_cls: bool):
    """Bipartite soft matching (ToMe section 3): the tokens alternate into
    sets A (even positions, the cls token among them) and B (odd); each
    A token scores its most similar B token by cosine similarity, and the
    ``r`` best-scoring A tokens merge into their B targets.  Returns
    ``(unm_idx, src_idx, dst_idx)``: the A indices kept (ascending, so a
    protected cls stays first), the A indices merged and each one's B
    destination.  Ties resolve as in JAX: ``argmax`` takes the first
    maximum and the sort of the scores is stable."""
    m = metric.float()
    m = m / torch.clamp_min(torch.linalg.vector_norm(m, dim=-1,
                                                     keepdim=True), 1e-6)
    a, b = m[:, 0::2], m[:, 1::2]
    scores = a @ b.transpose(1, 2)
    if protect_cls:
        scores[:, 0, :] = -torch.inf  # the cls token never merges
    node_max = scores.amax(dim=-1)
    node_idx = scores.argmax(dim=-1)
    order = torch.argsort(-node_max, dim=-1, stable=True)  # best first
    src_idx = order[:, :r]
    unm_idx = torch.sort(order[:, r:], dim=-1).values  # original order
    dst_idx = torch.gather(node_idx, 1, src_idx)
    return unm_idx, src_idx, dst_idx


def _merge_sum(x: torch.Tensor, unm_idx, src_idx, dst_idx) -> torch.Tensor:
    """(B, N, D) -> (B, N - r, D): the ``r`` selected A rows summed into
    their B destinations, the result [kept A rows, B rows].  The sum is
    the (B, N_B, r) one-hot product with the selected rows (fixed order,
    deterministic on the card)."""
    src, dst = x[:, 0::2], x[:, 1::2]
    d = x.shape[-1]
    unm = torch.gather(src, 1, unm_idx[..., None].expand(-1, -1, d))
    rows = torch.gather(src, 1, src_idx[..., None].expand(-1, -1, d))
    onehot = torch.nn.functional.one_hot(dst_idx, dst.shape[1]).to(x.dtype)
    dst = dst + onehot.transpose(1, 2) @ rows
    return torch.cat([unm, dst], dim=1)


def _tome_block(x, sizes, bp, cfg: ViTConfig, r: int, biased: bool,
                impl: str):
    """One eval block with an ``r``-pair merge between its halves
    (``tome.py:109-146``); proportional attention once a merge has
    happened (``biased``), so that before it the block is the plain one."""
    h, d = cfg.num_heads, cfg.head_dim
    b, n = x.shape[:2]
    xa = layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.layernorm_eps)
    qkv = _dense(xa, bp["qkv"], impl)
    q, k, v = (t.transpose(1, 2)
               for t in qkv.reshape(b, n, 3, h, d).unbind(2))
    key_bias = torch.log(sizes)[:, None, None, :] if biased else None
    attn_out = mha(q, k, v, d ** -0.5, key_bias=key_bias)
    x = x + _dense(attn_out, bp["proj"], impl)
    if r > 0:
        idxs = _bipartite_indices(k.mean(dim=1), r, cfg.use_cls_token)
        # size-weighted average, accumulated in fp32
        ws = _merge_sum(x.float() * sizes[..., None], *idxs)
        sizes = _merge_sum(sizes[..., None], *idxs)[..., 0]
        x = (ws / sizes[..., None]).to(x.dtype)
    xm = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.layernorm_eps)
    hidden = activation(_dense(xm, bp["fc1"], impl), cfg.activation)
    return x + _dense(hidden, bp["fc2"], impl), sizes


def tome_forward(params: Dict[str, Any], x: torch.Tensor, cfg: ViTConfig,
                 r: int, impl: str = "auto") -> torch.Tensor:
    """Eval forward with per-layer token merging: images (B, H, W, C) ->
    logits (B, num_classes), in ``x.dtype``.  Dense (merged, plain or
    int8) block trees only; ``impl="plain"`` takes the int8 kernel's
    plain version on any device.  Without a cls token the pool is the
    size-weighted mean, the mean over the original patches."""
    qkv = params["blocks"]["qkv"]
    if not isinstance(qkv, dict) or "kernel" not in qkv:
        raise ValueError("tome_forward wants the stacked dense block tree")
    tokens = patch_embed(params, x, cfg)
    if cfg.use_cls_token:
        cls = params["cls"].to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + params["pos_embed"].to(tokens.dtype)
    if cfg.ln_pre:
        tokens = layer_norm(tokens, params["ln_pre"]["scale"],
                            params["ln_pre"]["bias"], cfg.layernorm_eps)
    sizes = torch.ones(tokens.shape[:2], dtype=torch.float32,
                       device=tokens.device)
    merged_yet = False
    for rl, bp in zip(merge_schedule(cfg, r),
                      _unstack(params["blocks"], cfg.depth)):
        tokens, sizes = _tome_block(tokens, sizes, bp, cfg, rl, merged_yet,
                                    impl)
        merged_yet = merged_yet or rl > 0
    norm = params["norm"]
    if cfg.use_cls_token:
        feat = layer_norm(tokens[:, 0], norm["scale"], norm["bias"],
                          cfg.layernorm_eps)
    else:
        tokens = layer_norm(tokens, norm["scale"], norm["bias"],
                            cfg.layernorm_eps)
        w = (sizes / sizes.sum(dim=1, keepdim=True))[..., None]
        feat = (tokens.float() * w).sum(dim=1).to(tokens.dtype)
    if cfg.repr_size is not None:
        pl_ = params["pre_logits"]
        feat = torch.tanh(linear(feat, pl_["kernel"], pl_["bias"]))
    if cfg.proj_dim is not None:
        feat = feat @ params["proj_out"]["kernel"]
    if "head" not in params:
        return feat
    return linear(feat, params["head"]["kernel"], params["head"]["bias"])
