"""Train and eval steps, single device (port of ``cara_tpu/train/steps.py``).

Loss and gradients over only the trainable leaves (CaRA factors +
classifier head, the reference's ``requires_grad=False`` freeze at
``vit_cp.py:176-182``; the head alone for the linear probe, every leaf
for full fine-tuning), fp32 master trainables cast to the compute dtype
for the forward, AdamW (lr 1e-3, wd 1e-4, ``vit_cp.py:185``) with the CaRA
schedule setting the learning rate before every update, and metrics kept
on the device.  The frozen backbone is cast to the compute dtype once by
the caller (:func:`cast_floating`).

``grad_accum > 1`` splits the batch into that many microbatches run one
after another, their gradients summed in fp32 and scaled by
``1 / grad_accum`` (``steps.py:482-511``): one AdamW update a step.
With mixture-of-expert adapters the loss adds ``moe_aux_coef`` times the
router's load-balance loss over each microbatch's tokens
(``steps.py:458-476``).  As
in JAX, the weight-dropout draw (the mask seeds, the rank or row masks,
the element masks of the XLA dense forms) is one for the whole step and
the per-sample draws (drop-path gates, dropout masks) are new in every
microbatch.  The element route's fold
(TPU row 14, ``build_wd_weights``) runs once a microbatch, from the
step's seeds: each fold gives the same bits.  ``remat`` picks the
activation checkpointing of ``vit_forward``; "auto" is JAX's policy: on
where the dense form is not the fused one (the full and linear routes),
off on the CaRA kernel routes, whose backward kernels keep only their
minimal residuals.  ``nan_check`` (``--nan-check``, the counterpart of
``jax_debug_nans``) raises ``FloatingPointError`` on a NaN or Inf in a
step's loss, logits or gradients.

Meshes, FSDP and tensor parallelism raise until their ROADMAP item
lands.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from cara_tpu_torch.config import (ADAPTER_METHODS, PORTED_METHODS,
                                   ZOO_METHODS, CaraConfig, ViTConfig)
from cara_tpu_torch.models.convert import map_floating, params_from_numpy
from cara_tpu_torch.models.vit import (draw_randomness, layer_mask_specs,
                                       resolve_impls, vit_forward)
from cara_tpu_torch.train.schedule import cara_cosine_schedule

Params = Dict[str, Any]

# ImageNet statistics for on-device normalization of uint8 batches.
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_PARALLEL = "ROADMAP.md queue 1: parallelism"


def prep_images(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """uint8 RGB -> normalized on the device, in ``dtype`` (fp32 when
    None); float inputs are already normalized and only cast."""
    if x.dtype == torch.uint8:
        dt = dtype or torch.float32
        mean = torch.tensor(_IMAGENET_MEAN, dtype=dt, device=x.device)
        std = torch.tensor(_IMAGENET_STD, dtype=dt, device=x.device)
        return (x.to(dt) / 255.0 - mean) / std
    return x if dtype is None else x.to(dtype)


def split_trainable(params: Params, cara_params: Params,
                    method: str = "cara") -> Tuple[Params, Params]:
    """(frozen backbone, trainable = {"cara": adapter, "head": head}).
    The adapter is CaRA's flat factor tree, LoRA's nested per-site tree,
    FacT's shared factors, VPT's prompts, SSF's (gamma, beta) pairs,
    BitFit's bias deltas or the bottleneck adapters' per-site pairs; the
    optimizer walks any of them (:func:`tree_leaves`).

    ``method="full"`` (full fine-tuning) freezes nothing: the backbone
    moves into ``trainable["backbone"]`` and the frozen tree is empty.
    ``method="linear"`` (the linear probe) is the default split with an
    empty adapter tree (``cara_tpu/train/steps.py:52-76``)."""
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"method={method!r} is not yet ported (ROADMAP.md queue 1: the "
            "PEFT zoo)")
    frozen = {k: v for k, v in params.items() if k != "head"}
    trainable = {"cara": cara_params, "head": params["head"]}
    if method == "full":
        trainable["backbone"] = frozen
        frozen = {}
    return frozen, trainable


def merge_params(frozen: Params, trainable: Params) -> Params:
    full = dict(frozen)
    full.update(trainable.get("backbone") or {})  # full fine-tuning
    full["head"] = trainable["head"]
    return full


def cast_floating(tree, dtype):
    """Cast floating leaves (autograd flows through the cast)."""
    return map_floating(tree, lambda t: t.to(dtype))


def tree_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor leaf, in the tree's key order."""
    out: List[Tuple[str, torch.Tensor]] = []
    for key, val in tree.items():
        if isinstance(val, dict):
            out.extend(tree_leaves(val, f"{prefix}{key}/"))
        elif isinstance(val, torch.Tensor):
            out.append((f"{prefix}{key}", val))
    return out


def mask_padded_classes(logits: torch.Tensor, batch) -> torch.Tensor:
    """Give logit columns past ``batch["num_classes"]`` the dtype's min,
    so a padded head computes the unpadded softmax and argmax."""
    nc = batch.get("num_classes")
    if nc is None:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < nc
    return torch.where(keep, logits,
                       torch.full_like(logits, torch.finfo(logits.dtype).min))


@dataclasses.dataclass
class AdamW:
    """``torch.optim.AdamW`` over the trainable leaves with the learning
    rate set from ``schedule(step)`` before each update: ``optax.adamw``
    with a schedule, decay on every leaf (torch AdamW applies its decay to
    every parameter of the group, the reference's setting).  ``hparams``
    are :func:`make_optimizer`'s arguments but the tree, which rebuild
    it (:func:`train_state_from_numpy`)."""

    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    hparams: Dict[str, Any]

    def update(self, leaves, grads, step: int) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(step)
        for p, g in zip(leaves, grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)


def make_optimizer(trainable: Params, base_lr: float, steps_per_epoch: int,
                   total_epochs: int = 100,
                   weight_decay: float = 1e-4) -> AdamW:
    leaves = [t for _, t in tree_leaves(trainable)]
    opt = torch.optim.AdamW(leaves, lr=base_lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    return AdamW(opt, cara_cosine_schedule(base_lr, steps_per_epoch,
                                           total_epochs),
                 dict(base_lr=base_lr, steps_per_epoch=steps_per_epoch,
                      total_epochs=total_epochs, weight_decay=weight_decay))


@dataclasses.dataclass
class TrainState:
    step: int
    trainable: Params   # {"cara": ..., "head": ...}, fp32, requires_grad
    opt: AdamW


def _own_leaves(trainable: Params) -> Params:
    """Trainable leaves the optimizer may update in place: copies (a
    tensor made from a numpy array shares its memory) that require
    grad."""
    return map_floating(trainable,
                        lambda t: t.detach().clone().requires_grad_(True))


def init_train_state(params: Params, cara_params: Params, device,
                     base_lr: float, steps_per_epoch: int,
                     total_epochs: int = 100, weight_decay: float = 1e-4,
                     method: str = "cara") -> Tuple[Params, TrainState]:
    """numpy (or tensor) trees -> (frozen backbone on ``device`` in fp32,
    a fresh :class:`TrainState` whose trainables are fp32 leaves that
    require grad); ``method`` splits them (:func:`split_trainable`)."""
    params = params_from_numpy(params, device, torch.float32)
    cara_params = params_from_numpy(cara_params, device, torch.float32)
    frozen, trainable = split_trainable(params, cara_params, method)
    trainable = _own_leaves(trainable)
    opt = make_optimizer(trainable, base_lr, steps_per_epoch, total_epochs,
                         weight_decay)
    return frozen, TrainState(0, trainable, opt)


def train_state_from_numpy(step: int, trainable: Params, mu: Params,
                           nu: Params, device, base_lr: float,
                           steps_per_epoch: int, total_epochs: int = 100,
                           weight_decay: float = 1e-4) -> TrainState:
    """A JAX ``TrainState``'s arrays -> the port's: the trainable tree
    (with its ``backbone`` for full fine-tuning) and ``optax.adamw``'s
    first and second moments (``opt_state[0].mu`` / ``.nu``, the same
    tree structure) after ``step`` updates."""
    trainable = _own_leaves(params_from_numpy(trainable, device,
                                              torch.float32))
    opt = make_optimizer(trainable, base_lr, steps_per_epoch, total_epochs,
                         weight_decay)
    mus = dict(tree_leaves(params_from_numpy(mu, device, torch.float32)))
    nus = dict(tree_leaves(params_from_numpy(nu, device, torch.float32)))
    for path, leaf in tree_leaves(trainable):
        m, v = mus.get(path), nus.get(path)
        if m is None or v is None or m.shape != leaf.shape:
            raise ValueError(f"optimizer moments do not match the "
                             f"trainable tree at {path}")
        if step:
            opt.optimizer.state[leaf] = {
                "step": torch.tensor(float(step)), "exp_avg": m.clone(),
                "exp_avg_sq": v.clone()}
    return TrainState(step, trainable, opt)


def adam_moments(state: TrainState) -> Tuple[Params, Params]:
    """AdamW's first and second moments as trees of the trainable tree's
    structure (``opt_state[0].mu`` / ``.nu`` of ``optax.adamw``; zeros
    before the first update): what :func:`train_state_from_numpy`
    reads."""
    slots = state.opt.optimizer.state

    def moment(key):
        return map_floating(state.trainable, lambda t: (
            slots[t][key] if t in slots else torch.zeros_like(t)).detach())

    return moment("exp_avg"), moment("exp_avg_sq")


def _loss_grads_logits(cfg, cara_cfg, trainable, frozen, batch, *,
                       compute_dtype=None, impl="auto", generator=None,
                       randomness=None, attn_impl="auto", dense_impl="auto",
                       remat=False):
    leaves = [t for _, t in tree_leaves(trainable)]
    t = trainable if compute_dtype is None else cast_floating(
        trainable, compute_dtype)
    x = prep_images(batch["image"], compute_dtype)
    cara = t["cara"] or None
    moe = cara is not None and cara_cfg.moe
    logits, aux = vit_forward(
        merge_params(frozen, t), x, cfg, cara_params=cara,
        cara_cfg=cara_cfg if cara is not None else None, impl=impl,
        train=True, generator=generator, randomness=randomness,
        attn_impl=attn_impl, dense_impl=dense_impl, remat=remat,
        return_moe_aux=True)
    logits = mask_padded_classes(logits.float(), batch)
    labels = batch["label"].long()
    loss = torch.nn.functional.cross_entropy(logits, labels)
    if moe:  # the Switch load-balance term (``steps.py:473-476``)
        loss = loss + cara_cfg.moe_aux_coef * aux
    acc = (logits.argmax(-1) == labels).float().mean()
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), acc, grads, logits.detach()


def microbatch_randomness(cfg: ViTConfig, cara_cfg: CaraConfig, batch: int,
                          grad_accum: int, device, generator,
                          dtype=torch.float32, **draw) -> List[Dict]:
    """The randomness of each of a step's ``grad_accum`` microbatches of
    ``batch // grad_accum`` images, as JAX splits it (``steps.py:496-498``,
    ``vit.py:1405-1408``): the weight-dropout draw (``seeds``, the rank
    or row masks and the element masks of the XLA dense forms, whose
    keys come from the step's ``wd_rng``) once for the step, shared; the
    drop-path gates and the dropout masks new in each.  ``draw``:
    ``attn_impl`` and ``dense_impl`` (the resolved forms, which say what
    masks a layer draws) and ``masks``; where a layer draws element
    masks, every microbatch's masks are drawn here, so that they can
    share them."""
    adapter = (cara_cfg if cara_cfg.method in ADAPTER_METHODS + ZOO_METHODS
               else None)
    specs = layer_mask_specs(cfg, adapter, batch // grad_accum,
                             draw.get("attn_impl", "fused"),
                             draw.get("dense_impl", "fused"))
    weights = [n for n, (_, kind) in specs.items() if kind == "weight"]
    if weights and grad_accum > 1:
        draw["masks"] = True
    out = []
    for i in range(grad_accum):
        rand = draw_randomness(cfg, batch // grad_accum, device, generator,
                               dtype, adapter, **draw)
        if i:
            rand.update({k: out[0][k] for k in ("seeds", "comp", "rows")
                         if k in out[0]})
            for layer, first in zip(rand.get("masks") or (), out[0].get(
                    "masks") or ()):
                layer.update({n: first[n] for n in weights})
        out.append(rand)
    return out


def _microbatch(batch, i: int, size: int):
    """Microbatch ``i`` of ``size`` images: the tensors sliced along the
    batch axis, everything else (``num_classes``) as it is."""
    return {k: (v[i * size:(i + 1) * size]
                if isinstance(v, torch.Tensor) and v.dim() else v)
            for k, v in batch.items()}


def check_finite(step: int, named, rerun=None) -> None:
    """Raise ``FloatingPointError`` naming ``step`` and the first of the
    ``(name, tensor)`` pairs that holds a NaN or Inf (one device sync for
    all).  ``rerun`` (a function that repeats the step's forward and
    backward) runs under autograd's anomaly mode to name the backward
    operation that first made a NaN, where it can."""
    ok = torch.stack([torch.isfinite(t).all() for _, t in named])
    if bool(ok.all()):
        return
    bad = [name for (name, _), good in zip(named, ok.tolist()) if not good]
    where = ""
    if rerun is not None:
        try:  # its warnings repeat what the error below names
            with warnings.catch_warnings(), \
                    torch.autograd.detect_anomaly(check_nan=True):
                warnings.simplefilter("ignore")
                rerun()
        except RuntimeError as exc:
            where = f"; anomaly mode: {str(exc).splitlines()[0]}"
    raise FloatingPointError(
        f"NaN or Inf at step {step} in {bad[0]} ({len(bad)} of "
        f"{len(named)} checked tensors){where}")


def resolve_remat(remat, dense_impl: str):
    """JAX's "auto" remat (``steps.py:428-429``): on where the resolved
    dense form is not the fused one; True, False and "dots" as given."""
    return dense_impl != "fused" if remat == "auto" else remat


def loss_and_grads(cfg: ViTConfig, cara_cfg: CaraConfig, trainable: Params,
                   frozen: Params, batch, *, grad_accum: int = 1,
                   randomness=None,
                   generator: Optional[torch.Generator] = None,
                   nan_check_step: Optional[int] = None, **kw):
    """(loss, accuracy, grads) of one train step; ``grads`` follow
    :func:`tree_leaves` of ``trainable``.  An empty adapter tree (the
    linear probe, full fine-tuning) runs the forward without one.  Over
    ``grad_accum`` microbatches of ``batch`` (``steps.py:482-511``) each
    microbatch's gradients are taken in fp32 and summed, then the sums
    of loss, accuracy and gradients scaled by ``1 / grad_accum``.
    ``randomness`` is the batch's (one microbatch) or a list of one a
    microbatch; None draws them from ``generator`` (one microbatch: in
    the forward; several: :func:`microbatch_randomness`).
    ``nan_check_step`` (a step number) runs :func:`check_finite` on each
    microbatch's loss, logits and gradients.  ``kw``: ``compute_dtype``,
    ``impl``, ``attn_impl``, ``dense_impl`` and ``remat`` (of
    ``vit_forward``)."""
    b = batch["label"].shape[0]
    if b % grad_accum:
        raise ValueError(f"per-device batch {b} not divisible by "
                         f"grad_accum={grad_accum}")
    size = b // grad_accum
    rands = [randomness] if grad_accum == 1 else randomness
    if rands is None:
        forms = resolve_impls(kw.get("attn_impl", "auto"),
                              kw.get("dense_impl", "auto"), cara_cfg)
        rands = microbatch_randomness(
            cfg, cara_cfg, b, grad_accum, batch["image"].device, generator,
            kw.get("compute_dtype") or torch.float32,
            attn_impl=forms[0], dense_impl=forms[1])
    paths = [p for p, _ in tree_leaves(trainable)]
    loss = acc = grads = None
    for i, rand in enumerate(rands):
        mb = batch if grad_accum == 1 else _microbatch(batch, i, size)
        args = (cfg, cara_cfg, trainable, frozen, mb)
        l_i, a_i, g_i, logits = _loss_grads_logits(
            *args, generator=generator, randomness=rand, **kw)
        if nan_check_step is not None:
            check_finite(
                nan_check_step,
                [("loss", l_i), ("logits", logits)]
                + [(f"grad {p}", g) for p, g in zip(paths, g_i)],
                rerun=lambda: _loss_grads_logits(
                    *args, generator=generator, randomness=rand, **kw))
        if grad_accum == 1:
            return l_i, a_i, g_i
        if grads is None:
            loss, acc, grads = l_i, a_i, [g.float() for g in g_i]
        else:
            loss, acc = loss + l_i, acc + a_i
            grads = [g + n.float() for g, n in zip(grads, g_i)]
    inv = 1.0 / grad_accum
    return loss * inv, acc * inv, [g * inv for g in grads]


def make_train_step(cfg: ViTConfig, cara_cfg: CaraConfig, *,
                    compute_dtype=None, impl: str = "auto",
                    attn_impl: str = "auto", dense_impl: str = "auto",
                    remat="auto", grad_accum: int = 1,
                    nan_check: bool = False, mesh=None, fsdp: bool = False):
    """``train_step(state, frozen, batch, generator=None, randomness=None)
    -> (state, {"loss", "accuracy", "grad_norm"})``; the metrics stay on
    the device.  ``frozen`` is already in the compute dtype.
    ``attn_impl`` and ``dense_impl`` resolve by :func:`resolve_impls`
    (``_resolve_impls``), ``remat`` by :func:`resolve_remat`.  With
    ``grad_accum > 1``, ``randomness`` is a list of one randomness a
    microbatch (:func:`microbatch_randomness`); without it the step
    draws them from ``generator``."""
    attn_impl, dense_impl = resolve_impls(attn_impl, dense_impl, cara_cfg)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if mesh is not None or fsdp:
        raise NotImplementedError(f"meshes and FSDP are not yet ported "
                                  f"({_PARALLEL})")
    kw = dict(compute_dtype=compute_dtype, impl=impl, attn_impl=attn_impl,
              dense_impl=dense_impl,
              remat=resolve_remat(remat, dense_impl))

    def train_step(state: TrainState, frozen: Params, batch,
                   generator: Optional[torch.Generator] = None,
                   randomness=None):
        loss, acc, grads = loss_and_grads(
            cfg, cara_cfg, state.trainable, frozen, batch,
            grad_accum=grad_accum, randomness=randomness,
            generator=generator,
            nan_check_step=state.step if nan_check else None, **kw)
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        leaves = [t for _, t in tree_leaves(state.trainable)]
        with torch.no_grad():
            state.opt.update(leaves, grads, state.step)
        state.step += 1
        return state, {"loss": loss, "accuracy": acc, "grad_norm": gnorm}

    return train_step


def make_eval_step(cfg: ViTConfig, cara_cfg: Optional[CaraConfig] = None,
                   compute_dtype=None, attn_impl: str = "auto",
                   dense_impl: str = "auto"):
    """``eval_step(params, cara_params, batch) -> (correct, total)`` on the
    device; the ``valid`` mask keeps a padded final batch out of the
    count.  Runs the serving kernels (``cp_attn_block``,
    ``cp_mlp_block``) for CUDA tensors at the default impls, which
    resolve as in training (:func:`resolve_impls`: the flash attention
    for full fine-tuning); an "auto" ``dense_impl`` without adapter
    parameters (a merged checkpoint) is the XLA one."""
    attn_impl, _ = resolve_impls(attn_impl, dense_impl, cara_cfg)

    def eval_step(params: Params, cara_params, batch):
        with torch.no_grad():
            p, cara = params, cara_params
            if compute_dtype is not None:
                p = cast_floating(p, compute_dtype)
                if cara is not None:
                    cara = cast_floating(cara, compute_dtype)
            x = prep_images(batch["image"], compute_dtype)
            logits = vit_forward(
                p, x, cfg, cara_params=cara,
                cara_cfg=cara_cfg if cara is not None else None,
                attn_impl=attn_impl, dense_impl=dense_impl)
            pred = mask_padded_classes(logits.float(), batch).argmax(-1)
            valid = batch.get("valid")
            if valid is None:
                valid = torch.ones_like(batch["label"], dtype=torch.float32)
            correct = ((pred == batch["label"].long()).float() * valid).sum()
            return correct, valid.sum()

    return eval_step
