"""HTTP inference server with dynamic micro-batching (port of
``cara_tpu/server.py``).

A daemon that keeps the weights resident on the GPU and coalesces
concurrent requests into padded bucket-sized batches for
:class:`cara_tpu_torch.serving.Predictor`.

Design notes:

* **One collector thread dispatches.**  HTTP handler threads only
  decode, enqueue and wait on a future; the collector thread queues each
  batch's forward on the CUDA stream, and a resolver thread copies the
  logits out (``fetch``), so batch N's compute overlaps batch N-1's copy.
  ``torch.inference_mode`` is thread-local, so the collector enters it
  itself.
* **Bucketed shapes.**  ``Predictor`` pads a batch to the smallest bucket
  that holds it.
* **Latency/throughput knob.**  ``max_wait_ms`` bounds how long the first
  request in a batch waits for co-riders; 0 serves singles immediately.

Run: ``python -m cara_tpu_torch.cli.serve --ckpt vit_cifar_*.npz --port 8000``

    curl -s -X POST --data-binary @cat.jpg localhost:8000/predict
    -> {"class": 3, "classes": [3, 7], "scores": [...], "batched_with": 5}
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from cara_tpu_torch.data.vtab import normalize


def decode_image_bytes(data: bytes, image_size: int) -> np.ndarray:
    """JPEG/PNG bytes -> normalized float32 (H, W, 3), the eval transform
    of the data pipeline (bicubic resize + ImageNet normalize,
    ``image_classification/vtab.py:79-82``)."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB").resize((image_size, image_size), Image.BICUBIC)
        return normalize(np.asarray(im, np.uint8).astype(np.float32) / 255.0)


class _Request:
    __slots__ = ("image", "future", "t_enqueue", "batched_with")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        self.batched_with = 0


class MicroBatcher:
    """Coalesce concurrent single-image requests into device batches.

    Two-stage pipeline: a collector thread drains the queue (the first
    request opens a batch, then up to ``max_batch - 1`` more are awaited
    for at most ``max_wait_ms``) and DISPATCHES the stacked batch through
    ``dispatch_fn`` (``Predictor.logits_async``, which queues the forward
    on the CUDA stream and returns a zero-arg ``fetch``); a resolver
    thread calls ``fetch`` (the copy-out) and resolves each row's future.
    Batch N's compute thus overlaps batch N-1's copy-out.
    ``pipeline_depth`` bounds the dispatched-but-unresolved batches
    (device memory in flight).

    ``max_wait_ms`` is ADAPTIVE: each co-rider arrival rolls the
    collection deadline forward by another ``max_wait_ms``, up to the hard
    ``max_wait_cap_ms`` bound (default ``4 * max_wait_ms``), so a steady
    stream keeps the batch open while an isolated request still leaves
    after the base wait.
    """

    def __init__(self, dispatch_fn, max_batch: int, max_wait_ms: float = 2.0,
                 pipeline_depth: int = 2,
                 max_wait_cap_ms: Optional[float] = None):
        self._dispatch_fn = dispatch_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        if max_wait_cap_ms is None:
            max_wait_cap_ms = 4.0 * max_wait_ms
        self.max_wait_cap = max(max_wait_cap_ms / 1e3, self.max_wait)
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._fetch_q: "queue.Queue" = queue.Queue(
            maxsize=max(1, pipeline_depth - 1))
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "rows": 0,
                      "latency_ms_sum": 0.0, "latency_ms_max": 0.0}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._resolver = threading.Thread(target=self._resolve, daemon=True)
        self._thread.start()
        self._resolver.start()

    def submit(self, image: np.ndarray) -> Future:
        req = _Request(image)
        self._q.put(req)
        return req.future

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)
        self._resolver.join(timeout=5)

    def _collect(self) -> Optional[List[_Request]]:
        head = self._q.get()
        if head is None:
            return None
        batch = [head]
        now = time.perf_counter()
        deadline = now + self.max_wait
        hard_deadline = now + self.max_wait_cap
        while len(batch) < self.max_batch:
            remaining = min(deadline, hard_deadline) - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-post shutdown for the outer loop
                break
            batch.append(nxt)
            deadline = time.perf_counter() + self.max_wait
        return batch

    def _run(self):
        """Collector stage: form a batch, dispatch it, hand off to the
        resolver.  ``torch.inference_mode`` is thread-local, so this
        thread enters it itself."""
        with torch.inference_mode():
            while True:
                batch = self._collect()
                if batch is None:
                    self._fetch_q.put(None)
                    return
                imgs = np.stack([r.image for r in batch])
                try:
                    fetch = self._dispatch_fn(imgs)
                except Exception as exc:  # resolve waiters, keep serving
                    for r in batch:
                        r.future.set_exception(exc)
                    continue
                self._fetch_q.put((batch, fetch))

    def _resolve(self):
        """Resolver stage: copy the results out, resolve the futures."""
        while True:
            item = self._fetch_q.get()
            if item is None:
                return
            batch, fetch = item
            try:
                logits = fetch()
            except Exception as exc:
                for r in batch:
                    r.future.set_exception(exc)
                continue
            now = time.perf_counter()
            with self._lock:
                self.stats["batches"] += 1
                self.stats["requests"] += len(batch)
                self.stats["rows"] += len(batch)
            for r, row in zip(batch, logits):
                r.batched_with = len(batch)
                lat = (now - r.t_enqueue) * 1e3
                with self._lock:
                    self.stats["latency_ms_sum"] += lat
                    self.stats["latency_ms_max"] = max(
                        self.stats["latency_ms_max"], lat)
                r.future.set_result((row, r))

    def snapshot(self) -> dict:
        with self._lock:
            s = dict(self.stats)
        n = max(1, s["requests"])
        s["mean_batch_occupancy"] = s["rows"] / max(1, s["batches"])
        s["mean_latency_ms"] = round(s.pop("latency_ms_sum") / n, 3)
        s["max_latency_ms"] = round(s.pop("latency_ms_max"), 3)
        return s


class InferenceServer:
    """ThreadingHTTPServer wrapping a Predictor + MicroBatcher.

    Endpoints:
      ``POST /predict``  image bytes -> ``{"class", "classes", "scores",
                         "batched_with", "latency_ms"}``; with a
                         :class:`~cara_tpu_torch.serving.MultiTaskPredictor`,
                         ``POST /predict?task=<name>`` routes to that
                         task's batcher (one a task; 400 without ``task``,
                         404 for an unknown one)
      ``GET /healthz``   liveness + model info (+ the served task names)
      ``GET /stats``     batcher counters (occupancy, latency), per task
    """

    def __init__(self, predictor, *, host: str = "127.0.0.1",
                 port: int = 0, max_wait_ms: float = 2.0, top: int = 5,
                 request_timeout_s: float = 120.0,
                 max_wait_cap_ms: Optional[float] = None):
        self._pred = predictor
        self._top = top
        self._timeout = request_timeout_s
        self.batchers = {}
        for t in getattr(predictor, "names", None) or [None]:
            fn = (predictor.logits_async if t is None
                  else (lambda imgs, _t=t: predictor.logits_async(imgs, _t)))
            self.batchers[t] = MicroBatcher(fn, predictor.batch_size,
                                            max_wait_ms,
                                            max_wait_cap_ms=max_wait_cap_ms)
        self.batcher = next(iter(self.batchers.values()))  # default route
        batchers = self.batchers
        image_size = predictor.cfg.image_size
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet access log
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    info = {"status": "ok", "image_size": image_size,
                            "max_batch": outer.batcher.max_batch}
                    if None not in batchers:
                        info["tasks"] = list(batchers)
                    self._json(200, info)
                elif self.path == "/stats":
                    if None in batchers:
                        self._json(200, outer.batcher.snapshot())
                    else:
                        self._json(200, {t: b.snapshot()
                                         for t, b in batchers.items()})
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                from urllib.parse import parse_qs, urlparse

                # The body is read before any answer: an error answer that
                # left it unread could reset the client's connection.
                try:
                    body = self.rfile.read(
                        int(self.headers.get("Content-Length", 0)))
                except ValueError as exc:
                    self._json(400, {"error": f"bad request: {exc}"})
                    return
                url = urlparse(self.path)
                if url.path != "/predict":
                    self._json(404, {"error": f"no route {url.path}"})
                    return
                task = parse_qs(url.query).get("task", [None])[0]
                if None in batchers:  # single-task predictor
                    batcher = batchers[None]
                elif task is None:
                    self._json(400, {"error": "multi-task server: pass "
                                     "?task=<name>", "tasks": list(batchers)})
                    return
                elif task not in batchers:
                    self._json(404, {"error": f"unknown task {task!r}",
                                     "tasks": list(batchers)})
                    return
                else:
                    batcher = batchers[task]
                try:
                    img = decode_image_bytes(body, image_size)
                except Exception as exc:
                    self._json(400, {"error": f"bad image: {exc}"})
                    return
                try:
                    row, req = batcher.submit(img).result(
                        timeout=outer._timeout)
                except TimeoutError:
                    # A bare TimeoutError stringifies to "" — say what
                    # actually happened (typically the first call's kernel
                    # build; start(warmup=True) avoids it).
                    self._json(503, {"error": (
                        f"inference timed out after {outer._timeout:.0f}s "
                        "(kernel build in progress? warm the server or "
                        "raise request_timeout_s)")})
                    return
                except Exception as exc:
                    self._json(500, {"error": str(exc) or repr(exc)})
                    return
                k = min(outer._top, row.shape[-1])
                classes = np.argsort(-row)[:k]
                self._json(200, {
                    "class": int(classes[0]),
                    "classes": classes.tolist(),
                    "scores": [round(float(row[c]), 4) for c in classes],
                    "batched_with": req.batched_with,
                    "latency_ms": round(
                        (time.perf_counter() - req.t_enqueue) * 1e3, 3),
                })

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._serve_thread: Optional[threading.Thread] = None

    def start(self, warmup: bool = True):
        """Serve in a background thread.

        ``warmup=True`` (default) runs every batch bucket once BEFORE
        accepting traffic — the first call builds the CUDA kernels, which
        would otherwise burn the first requests' timeout budget (a
        readiness probe sees the port open only once the model can
        actually answer)."""
        if warmup:
            self._pred.warmup()
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._serve_thread.start()
        return self

    def serve_forever(self):
        self._httpd.serve_forever()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5)
        for b in self.batchers.values():
            b.close()
