"""Inference / serving path (port of ``cara_tpu/serving.py``, single task).

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
run the dequant-fused int8 kernel (TPU row 18).

``MultiTaskPredictor``, the StableHLO export and ToMe stay in
``cara_tpu`` for now.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from cara_tpu_torch.config import CaraConfig, ViTConfig
from cara_tpu_torch.models.convert import map_floating, params_from_numpy
from cara_tpu_torch.models.merge import merge_cara
from cara_tpu_torch.models.quant import (
    column_major_codes, quantize_block_weights)
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
    """Batched image classifier over a merged (or adapter) CaRA model."""

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
    ):
        """``params`` / ``cara_params``: numpy or tensor trees in the JAX
        layout (``train.checkpoint.load_model``).  The merge runs in fp32
        on ``device``, then ``quantize`` (None, "int8" or "w8a8")
        quantizes the block kernels, and the floating weights are cast to
        ``dtype`` (the int8 codes stay int8), in the reference's order."""
        if quantize not in (None, "int8", "w8a8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.device = torch.device(device)
        params = params_from_numpy(params, self.device, torch.float32)
        if cara_params is not None:
            cara_params = params_from_numpy(cara_params, self.device,
                                            torch.float32)
            if merge:
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
        """Build from an npz checkpoint, inferring num_classes from the
        stored head and the delta scale / rank / order from its meta;
        refuses to default a missing scale."""
        from cara_tpu_torch.config import get_model_config
        from cara_tpu_torch.train.checkpoint import (
            infer_cara_cfg, load_model)

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
