"""Train and eval steps, single device (port of ``cara_tpu/train/steps.py``).

Loss and gradients over only the trainable leaves (CaRA factors +
classifier head, the reference's ``requires_grad=False`` freeze at
``vit_cp.py:176-182``; the head alone for the linear probe, every leaf
for full fine-tuning), fp32 master trainables cast to the compute dtype
for the forward, AdamW (lr 1e-3, wd 1e-4, ``vit_cp.py:185``) with the CaRA
schedule setting the learning rate before every update, and metrics kept
on the device.  The frozen backbone is cast to the compute dtype once by
the caller (:func:`cast_floating`).

Gradient accumulation, meshes, FSDP and tensor parallelism raise until
their ROADMAP items land.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from cara_tpu_torch.config import PORTED_METHODS, CaraConfig, ViTConfig
from cara_tpu_torch.models.convert import map_floating, params_from_numpy
from cara_tpu_torch.models.vit import resolve_impls, vit_forward
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
    every parameter of the group, the reference's setting)."""

    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]

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
                                           total_epochs))


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


def loss_and_grads(cfg: ViTConfig, cara_cfg: CaraConfig, trainable: Params,
                   frozen: Params, batch, *, compute_dtype=None,
                   impl: str = "auto",
                   generator: Optional[torch.Generator] = None,
                   randomness=None, attn_impl: str = "auto",
                   dense_impl: str = "auto"):
    """(loss, accuracy, grads) of one batch; ``grads`` follow
    :func:`tree_leaves` of ``trainable``.  An empty adapter tree (the
    linear probe, full fine-tuning) runs the forward without one."""
    leaves = [t for _, t in tree_leaves(trainable)]
    t = trainable if compute_dtype is None else cast_floating(
        trainable, compute_dtype)
    x = prep_images(batch["image"], compute_dtype)
    cara = t["cara"] or None
    logits = vit_forward(merge_params(frozen, t), x, cfg,
                         cara_params=cara,
                         cara_cfg=cara_cfg if cara is not None else None,
                         impl=impl, train=True, generator=generator,
                         randomness=randomness, attn_impl=attn_impl,
                         dense_impl=dense_impl)
    logits = mask_padded_classes(logits.float(), batch)
    labels = batch["label"].long()
    loss = torch.nn.functional.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), acc, grads


def make_train_step(cfg: ViTConfig, cara_cfg: CaraConfig, *,
                    compute_dtype=None, impl: str = "auto",
                    attn_impl: str = "auto", dense_impl: str = "auto",
                    grad_accum: int = 1, mesh=None, fsdp: bool = False):
    """``train_step(state, frozen, batch, generator=None, randomness=None)
    -> (state, {"loss", "accuracy", "grad_norm"})``; the metrics stay on
    the device.  ``frozen`` is already in the compute dtype.
    ``attn_impl`` and ``dense_impl`` resolve by :func:`resolve_impls`
    (``_resolve_impls``)."""
    attn_impl, dense_impl = resolve_impls(attn_impl, dense_impl, cara_cfg)
    if grad_accum != 1:
        raise NotImplementedError(
            "grad_accum > 1 is not yet ported (ROADMAP.md queue 1: "
            "training modules still to port)")
    if mesh is not None or fsdp:
        raise NotImplementedError(f"meshes and FSDP are not yet ported "
                                  f"({_PARALLEL})")

    def train_step(state: TrainState, frozen: Params, batch,
                   generator: Optional[torch.Generator] = None,
                   randomness=None):
        loss, acc, grads = loss_and_grads(
            cfg, cara_cfg, state.trainable, frozen, batch,
            compute_dtype=compute_dtype, impl=impl, generator=generator,
            randomness=randomness, attn_impl=attn_impl,
            dense_impl=dense_impl)
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
