"""Inference / serving path (port of ``cara_tpu/serving.py``).

Load a checkpoint once, fold the adapter into dense weights (exact in
eval) or keep it, keep the weights resident on ``device`` in the serving
dtype, and serve padded batches of any size.  Dispatch and fetch are
split: :meth:`Predictor.logits_async` queues the forward on the CUDA
stream and returns a ``fetch`` that copies the logits to the host, so a
server can overlap batch N's compute with batch N-1's copy-out.

``quantize="int8"`` (weight-only) or ``"w8a8"`` (int8 activations too)
quantizes the four block kernels after the merge (``models/quant.py``);
the blocks then run the XLA dense forms through ``models.vit.matk``, and
an unmerged adapter's delta adds on top.  With ``CARA_INT8_PALLAS=1`` in
the environment (read at each forward) the weight-only GEMMs on the card
run the dequant-fused int8 kernel (TPU row 18).  ``tome_r`` serves a
dense (merged, plain or quantized) model with ToMe token merging
(``models/tome.py``).

:class:`MultiTaskPredictor` serves T task adapters of one family (CaRA,
LoRA or FacT) over one shared frozen backbone: the tasks' factor trees
and zero-padded heads are stacked on the device and a task is picked by
index, its delta scale riding the collapsed factors
(``vit_forward(scale_override=...)``), so every task runs the same kernel
calls.  The StableHLO export (``ExportedPredictor``) stays in
``cara_tpu`` for now (ROADMAP.md queue 1: the PEFT zoo).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from cara_tpu_torch.config import CaraConfig, ViTConfig
from cara_tpu_torch.models import adapter as adapter_lib
from cara_tpu_torch.models import bitfit as bitfit_lib
from cara_tpu_torch.models import fact as fact_lib
from cara_tpu_torch.models import lora as lora_lib
from cara_tpu_torch.models import ssf as ssf_lib
from cara_tpu_torch.models import vpt as vpt_lib
from cara_tpu_torch.models.convert import map_floating, params_from_numpy
from cara_tpu_torch.models.merge import merge_cara
from cara_tpu_torch.models.quant import (
    column_major_codes, quantize_block_weights)
from cara_tpu_torch.models.tome import tome_forward
from cara_tpu_torch.models.vit import vit_forward


def _dispatch_batched(call, images, batch_size: int,
                      buckets: Optional[Sequence[int]] = None):
    """Dispatch every chunk through ``call`` (zero-padding the tail to the
    smallest bucket that fits) and return a zero-arg ``fetch`` that
    copies the results to the host and concatenates them."""
    n = len(images)
    if n == 0:
        raise ValueError("no images given")
    sizes = sorted(set(buckets or ())) or [batch_size]
    pending = []
    for start in range(0, n, batch_size):
        chunk = np.asarray(images[start:start + batch_size])
        rows = len(chunk)
        size = next((b for b in sizes if b >= rows), batch_size)
        pad = size - rows
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        pending.append((call(chunk), rows))

    def fetch() -> np.ndarray:
        return np.concatenate([out[:rows].float().cpu().numpy()
                               for out, rows in pending])

    return fetch


def _resolve_buckets(buckets, batch_size: int) -> tuple:
    """'auto' -> powers of 4 up to batch_size; None -> (batch_size,)."""
    if buckets is None:
        return (batch_size,)
    if buckets == "auto":
        out = []
        b = 1
        while b < batch_size:
            out.append(b)
            b *= 4
        return tuple(out) + (batch_size,)
    out = tuple(sorted(set(int(b) for b in buckets)))
    if not out or out[-1] > batch_size or out[0] < 1:
        raise ValueError(
            f"buckets {buckets!r} must be within [1, batch_size="
            f"{batch_size}]")
    return out if out[-1] == batch_size else out + (batch_size,)


class Predictor:
    """Batched image classifier over a merged (or adapter) model of any
    ported method: CaRA, LoRA, FacT, SSF and BitFit merge; CaRA's mixture
    of experts, VPT and the bottleneck adapters always serve unmerged."""

    def __init__(
        self,
        params: Dict[str, Any],
        cfg: ViTConfig,
        *,
        cara_params: Optional[Dict[str, Any]] = None,
        cara_cfg: Optional[CaraConfig] = None,
        merge: bool = True,
        batch_size: int = 64,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        buckets="auto",
        quantize: Optional[str] = None,
        tome_r: int = 0,
    ):
        """``params`` / ``cara_params``: numpy or tensor trees in the JAX
        layout (``train.checkpoint.load_model``).  The merge runs in fp32
        on ``device``, then ``quantize`` (None, "int8" or "w8a8")
        quantizes the block kernels, and the floating weights are cast to
        ``dtype`` (the int8 codes stay int8), in the reference's order.
        A mixture of experts (per-token routing), VPT prompts and
        bottleneck adapters cannot fold into the weights and are served
        unmerged whatever ``merge`` says (``cara_tpu/serving.py:113-121``).
        ``tome_r`` > 0 merges that many token pairs a layer
        (``models.tome.tome_forward``); it wants a dense forward, so an
        adapter left unmerged raises (``serving.py:155-180``)."""
        if quantize not in (None, "int8", "w8a8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.device = torch.device(device)
        params = params_from_numpy(params, self.device, torch.float32)
        if cara_params is not None:
            cara_params = params_from_numpy(cara_params, self.device,
                                            torch.float32)
            if merge and not ("router" in cara_params
                              or "prompts" in cara_params
                              or "mlp_down" in cara_params):
                params = merge_cara(params, cara_params, cfg, cara_cfg)
                cara_params = cara_cfg = None
        if quantize is not None:
            # "int8" is weight-only (w8, the reference's legacy name).
            params = quantize_block_weights(
                params, mode="w8a8" if quantize == "w8a8" else "w8")
            if quantize == "w8a8":
                params = column_major_codes(params)
        self.quantize = quantize
        self.cfg = cfg
        self.batch_size = batch_size
        self.buckets = _resolve_buckets(buckets, batch_size)
        self._dtype = dtype
        self._params = map_floating(params, lambda t: t.to(dtype))
        self._cara = (None if cara_params is None
                      else map_floating(cara_params, lambda t: t.to(dtype)))
        self._cara_cfg = cara_cfg
        self.tome_r = int(tome_r)
        if self.tome_r > 0 and cara_params is not None:
            raise ValueError(
                "tome_r requires a dense forward — merge the adapter "
                "first (merge=True; MoE adapters cannot merge and do "
                "not compose with ToMe)")

    @classmethod
    def from_checkpoint(cls, path: str, cfg: ViTConfig,
                        cara_cfg: Optional[CaraConfig] = None, **kw):
        from cara_tpu_torch.train.checkpoint import (
            infer_cara_cfg, load_model)

        params, cara_params, meta = load_model(path)
        if cara_params is not None and cara_cfg is None:
            cara_cfg = infer_cara_cfg(cara_params, meta)
        return cls(params, cfg, cara_params=cara_params, cara_cfg=cara_cfg,
                   **kw)

    @classmethod
    def from_checkpoint_auto(cls, ckpt: str, model: str,
                             num_classes: Optional[int] = None,
                             scale: Optional[float] = None, **kw):
        """Build from a checkpoint, inferring num_classes from the stored
        head and the delta scale / rank / order from its meta; refuses to
        default a missing scale.  A reference ``.pt`` (``models/
        torch_import.py``) records no scale: ``scale`` is then required
        when it carries an adapter."""
        from cara_tpu_torch.config import get_model_config
        from cara_tpu_torch.models import torch_import
        from cara_tpu_torch.train.checkpoint import (
            infer_cara_cfg, load_model)

        if torch_import.is_torch_checkpoint(ckpt):
            params, cara_params, info = torch_import.load_torch_checkpoint(
                ckpt, get_model_config(model))
            meta = ({"cp_order": info["cp_order"]}
                    if cara_params is not None else {})
        else:
            params, cara_params, meta = load_model(ckpt)
        if num_classes is None and "head" in params:
            num_classes = int(params["head"]["kernel"].shape[-1])
        mo = {k: v for k, v in meta.get("model_overrides", {}).items()
              if k != "num_classes"}
        cfg = get_model_config(model, num_classes=num_classes, **mo)
        cara_cfg = None
        if cara_params is not None:
            cara_cfg = infer_cara_cfg(cara_params, meta, scale=scale)
        return cls(params, cfg, cara_params=cara_params, cara_cfg=cara_cfg,
                   **kw)

    def _call(self, chunk: np.ndarray) -> torch.Tensor:
        """Queue one padded chunk's forward; returns the device logits."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                self.device, self._dtype, non_blocking=True)
            if self.tome_r > 0:
                return tome_forward(self._params, x, self.cfg, self.tome_r)
            return vit_forward(self._params, x, self.cfg,
                               cara_params=self._cara,
                               cara_cfg=self._cara_cfg)

    def logits(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, C) -> (N, num_classes) float32; any N."""
        return _dispatch_batched(self._call, images, self.batch_size,
                                 self.buckets)()

    def logits_async(self, images: np.ndarray):
        """Dispatch only; returns a zero-arg fetch() that materializes."""
        return _dispatch_batched(self._call, images, self.batch_size,
                                 self.buckets)

    def warmup(self) -> None:
        """Run every bucket once on zero images (builds the kernels and
        warms the allocator before real traffic)."""
        s = self.cfg.image_size
        for b in self.buckets:
            self.logits(np.zeros((b, s, s, self.cfg.in_chans), np.float32))

    def predict(self, images: np.ndarray) -> np.ndarray:
        return np.argmax(self.logits(images), axis=-1)


def _family(tree) -> str:
    """The adapter family of a factor tree, as JAX's group check names it
    (``cara_tpu/serving.py:345-352``): "lora", "fact_tt" / "fact_tk" or
    "cara"; VPT, SSF, BitFit and bottleneck trees raise JAX's
    ``ValueError``."""
    if lora_lib.is_lora_params(tree):
        return "lora"
    if (vpt_lib.is_vpt_params(tree) or ssf_lib.is_ssf_params(tree)
            or bitfit_lib.is_bitfit_params(tree)
            or adapter_lib.is_adapter_params(tree)):
        raise ValueError(
            "multi-task groups stack low-rank factor trees "
            "(cara/lora/fact); serve VPT/SSF/BitFit/bottleneck-"
            "adapter checkpoints with their own Predictor each")
    return fact_lib.detect_method(tree) or "cara"


def _stack_trees(trees, to_dev):
    """One tree whose leaves stack the tasks' leaves on a new leading
    axis (nested trees walked key by key)."""
    first = trees[0]
    return {k: (_stack_trees([t[k] for t in trees], to_dev)
                if isinstance(first[k], dict)
                else torch.stack([to_dev(t[k]) for t in trees]))
            for k in first}


def _select(tree, tid: int):
    """Task ``tid``'s tree of a stacked tree (views, no copy)."""
    return {k: _select(v, tid) if isinstance(v, dict) else v[tid]
            for k, v in tree.items()}


class MultiTaskPredictor:
    """Serve T task adapters over ONE shared frozen backbone.

    The backbone stays resident once, beside the T stacked adapters and
    heads; a task is an index into the stacks (views, no copy), and its
    delta scale a 0-d tensor that ``vit_forward`` folds into the
    collapsed factors (``v * s``, ``cb * s``) with the kernels at scale
    1, as ``cara_tpu``'s does (``vit.py:663-672``).  The adapters must be
    of one family (CaRA, LoRA, FacT-TT or FacT-TK; ``serving.py:340-416``)
    and share the rank, CaRA's CP order and FacT-TK's core rank; they may
    differ in delta scale, head width and class count (the heads are
    zero-padded to the widest and the logits sliced back)."""

    def __init__(self, params: Dict[str, Any], cfg: ViTConfig,
                 tasks: Dict[str, Dict[str, Any]], *, batch_size: int = 64,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 quantize: Optional[str] = None, buckets="auto"):
        """``tasks``: ordered ``{name: {"cara": factor tree, "head":
        {kernel, bias}, "scale": float, "cp_order": int}}`` (numpy or
        tensor trees).  ``quantize``: "int8" (weight-only) or "w8a8" on
        the shared backbone's block kernels only; the per-task deltas and
        heads stay in ``dtype`` and add on top of the quantized GEMMs."""
        import dataclasses

        if not tasks:
            raise ValueError("no tasks given")
        if quantize not in (None, "int8", "w8a8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if any("router" in t["cara"] for t in tasks.values()):
            raise ValueError(
                "MoE adapter checkpoints cannot join a multi-task group "
                "(the group step stacks plain factor trees); serve them "
                "with their own Predictor")
        families = {_family(t["cara"]) for t in tasks.values()}
        if len(families) > 1:
            raise ValueError(
                "cannot stack adapters of different families "
                f"({sorted(families)}) in one multi-task group (the trees "
                "differ in structure); serve each family in its own group")
        method = families.pop()
        trees = [t["cara"] for t in tasks.values()]
        orders = {4}  # CaRA's alone
        core_ranks = {0}  # FacT-TK's alone
        if method == "lora":
            ranks = {int(np.shape(c["qkv"]["a"])[-1]) for c in trees}
        elif method in ("fact_tt", "fact_tk"):
            ranks = {int(np.shape(c["U"])[-1]) for c in trees}
            if method == "fact_tk":
                core_ranks = {int(np.shape(c["C"])[0]) for c in trees}
        else:
            ranks = {int(np.shape(c["R1"])[0]) for c in trees}
            orders = {int(t.get("cp_order", 4)) for t in tasks.values()}
        if len(ranks) != 1 or len(orders) != 1:
            raise ValueError(
                f"adapters must share CP rank/order to stack; got ranks="
                f"{sorted(ranks)} orders={sorted(orders)}")
        if len(core_ranks) != 1:
            raise ValueError(
                "FacT-TK adapters must share the core rank to stack; got "
                f"{sorted(core_ranks)}")
        self.device = torch.device(device)
        self.names = list(tasks)
        self._tid = {n: i for i, n in enumerate(self.names)}
        self._num_classes = {n: int(np.shape(t["head"]["kernel"])[-1])
                             for n, t in tasks.items()}
        cmax = max(self._num_classes.values())

        def to_dev(a):
            return (a if isinstance(a, torch.Tensor)
                    else torch.from_numpy(np.asarray(a, np.float32))).to(
                        self.device, dtype)

        def padded(a, width):  # zero-pad the class axis to ``width``
            a = to_dev(a)
            return torch.nn.functional.pad(a, (0, width - a.shape[-1]))

        heads = [t["head"] for t in tasks.values()]
        self._hk = torch.stack([padded(h["kernel"], cmax) for h in heads])
        self._hb = torch.stack([padded(h["bias"], cmax) for h in heads])
        self._cara = _stack_trees(trees, to_dev)
        self._scales = torch.tensor([float(t["scale"])
                                     for t in tasks.values()],
                                    dtype=torch.float32, device=self.device)
        base = params_from_numpy({k: v for k, v in params.items()
                                  if k != "head"}, self.device, torch.float32)
        if quantize is not None:
            base = quantize_block_weights(
                base, mode="w8a8" if quantize == "w8a8" else "w8")
            if quantize == "w8a8":
                base = column_major_codes(base)
        self._base = map_floating(base, lambda t: t.to(dtype))
        self.quantize = quantize
        self.cfg = dataclasses.replace(cfg, num_classes=cmax)
        self._cara_cfg = CaraConfig(
            method=method, rank=ranks.pop(), scale=1.0,
            cp_order=orders.pop(), fact_core_rank=core_ranks.pop(),
            weight_dropout=0.1 if method == "cara" else 0.0)
        self.batch_size = batch_size
        self.buckets = _resolve_buckets(buckets, batch_size)
        self._dtype = dtype

    @classmethod
    def from_checkpoints(cls, ckpts: Dict[str, str], model,
                         backbone: Optional[str] = None, **kw):
        """``ckpts``: {task: path} of full and/or adapter-only ``.npz``
        checkpoints; ``model`` a registry name or a :class:`ViTConfig`.
        The shared backbone is the first full checkpoint's, or the npz at
        ``backbone``; every checkpoint must record its delta scale, and
        any recorded model name must be ``model``."""
        from cara_tpu_torch.config import get_model_config
        from cara_tpu_torch.models import npz as npz_lib
        from cara_tpu_torch.train.checkpoint import (
            is_adapter_checkpoint, load_adapter, load_model)

        params = None
        model_names = {}
        tasks: Dict[str, Dict[str, Any]] = {}
        for name, path in ckpts.items():
            if is_adapter_checkpoint(path):
                cara, head, meta = load_adapter(path)
            else:
                full, cara, meta = load_model(path)
                head = full.get("head")
                if params is None:
                    params = full
            if meta.get("model"):
                model_names[name] = meta["model"]
            if cara is None or head is None:
                raise ValueError(f"{path}: need an adapter + head for "
                                 f"task {name!r}")
            if "scale" not in meta:
                raise ValueError(f"{path}: checkpoint records no delta "
                                 "scale — re-export with meta or use "
                                 "single-task Predictor(scale=...)")
            tasks[name] = {"cara": cara, "head": head,
                           "scale": float(meta["scale"]),
                           "cp_order": int(meta.get("cp_order", 4))}
        want = model if isinstance(model, str) else None
        distinct = set(model_names.values()) | ({want} if want else set())
        if len(distinct) > 1:
            raise ValueError(
                f"checkpoints disagree on the backbone model: {model_names}"
                + (f" vs requested {want!r}" if want else "")
                + " — multi-task serving shares ONE backbone")
        cfg = (model if isinstance(model, ViTConfig)
               else get_model_config(model, num_classes=0))
        if params is None:
            if backbone is None:
                raise ValueError(
                    "all checkpoints are adapter-only; pass backbone= "
                    "(the pretrained npz) for the shared frozen weights")
            params = npz_lib.load_npz_backbone(backbone, cfg)
            params = npz_lib.maybe_resize_pos_embed(params, cfg)
        return cls(params, cfg, tasks, **kw)

    def _call(self, chunk: np.ndarray, tid: int) -> torch.Tensor:
        """Queue one padded chunk's forward for task ``tid``."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                self.device, self._dtype, non_blocking=True)
            cara = _select(self._cara, tid)
            p = dict(self._base, head={"kernel": self._hk[tid],
                                       "bias": self._hb[tid]})
            return vit_forward(p, x, self.cfg, cara_params=cara,
                               cara_cfg=self._cara_cfg,
                               scale_override=self._scales[tid]).float()

    def logits_async(self, images: np.ndarray, task: str):
        """Dispatch only; returns a zero-arg fetch() of (N,
        num_classes[task]) float32 logits."""
        tid = self._tid[task]
        fetch = _dispatch_batched(lambda c: self._call(c, tid), images,
                                  self.batch_size, self.buckets)
        nc = self._num_classes[task]
        return lambda: fetch()[:, :nc]

    def logits(self, images: np.ndarray, task: str) -> np.ndarray:
        """(N, H, W, C) -> (N, num_classes[task]) float32; any N."""
        return self.logits_async(images, task)()

    def warmup(self) -> None:
        """Run every bucket once through the first task: the tasks share
        every kernel call, so this warms them all."""
        s = self.cfg.image_size
        for b in self.buckets:
            self.logits(np.zeros((b, s, s, self.cfg.in_chans), np.float32),
                        self.names[0])

    def predict(self, images: np.ndarray, task: str) -> np.ndarray:
        return np.argmax(self.logits(images, task), axis=-1)
