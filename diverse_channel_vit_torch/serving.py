"""Inference serving on one device (counterpart of the JAX package's
``serving.py``).

- **Batch buckets**: a request batch is cut into chunks of at most
  ``max_batch`` images, each padded with zero images up to the smallest
  bucket that holds it and trimmed on the way out, so the device sees a few
  fixed batch sizes. Every row of the model is independent of the others,
  so the padding changes no real row.
- **Dynamic micro-batching**: ``submit()`` enqueues one image and returns a
  ``Future``; a collector thread coalesces the queue up to ``max_batch`` (or
  ``max_wait_ms``) and runs one forward per channel subset in the flush.
- **Channel adaptivity at serve time**: the channel subset is part of the
  request (global channel ids into the per-channel tables).
- Latency accounting: per-request wall time (submit -> result ready) feeds a
  bounded window; ``stats.summary()`` reports p50/p95/p99 and throughput.

- Optional int8 serving (``quantization="int8"``): this engine's forwards
  run the fused blocks' MLPs in int8 whatever the model's own setting, which
  stays as it is for other engines and for training. The mode is entered
  around each forward in the thread that runs it (the caller's for
  ``predict``, the collector's for ``submit``).

PyTorch runs eagerly, so there is nothing to compile per bucket; ``warmup``
runs each bucket once (it builds the CUDA kernels on first use).
"""

from __future__ import annotations

import bisect
import contextlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .device import resolve_device
from .ops import fused_block

__all__ = ["ServingEngine", "ServingStats"]


@dataclass
class ServingStats:
    # bounded window: a long-lived server must not grow per-request state
    latencies_s: "deque" = field(default_factory=lambda: deque(maxlen=4096))
    n_images: int = 0
    n_flushes: int = 0
    started: float = field(default_factory=time.perf_counter)

    def record(self, lat_s: float, n: int):
        self.latencies_s.append(lat_s)
        self.n_images += n

    def summary(self) -> dict:
        lats = np.sort(np.asarray(self.latencies_s or [0.0]))
        q = lambda p: float(lats[min(len(lats) - 1, int(p * len(lats)))])
        dt = time.perf_counter() - self.started
        return {
            "p50_ms": q(0.50) * 1e3,
            "p95_ms": q(0.95) * 1e3,
            "p99_ms": q(0.99) * 1e3,
            "imgs_per_sec": self.n_images / dt if dt > 0 else 0.0,
            "n_images": self.n_images,
            "n_flushes": self.n_flushes,
        }


class ServingEngine:
    """Bucketed, dynamically batched inference over one model.

    ``model`` follows the zoo's call signature ``(x, channel_ids) ->
    (out, extra_loss)``; it is moved to ``device`` (the card unless
    ``"cpu"`` is asked for) and put in eval mode. Images go to the device as
    f32; the model casts them to its own compute dtype. ``quantization``
    (``"none"`` or ``"int8"``) pins this engine's forwards to that mode;
    None keeps the model's own (``model.quantization`` of its config).
    """

    def __init__(self, model: torch.nn.Module, *, buckets: Sequence[int] = (1, 4, 16, 64),
                 max_batch: Optional[int] = None, max_wait_ms: float = 2.0,
                 device: Optional[Union[str, torch.device]] = None,
                 quantization: Optional[str] = None):
        if quantization is not None:
            fused_block.check_quantization(quantization)
        self.quantization = quantization
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.buckets = sorted(set(int(b) for b in buckets))
        self.max_batch = int(max_batch or self.buckets[-1])
        if self.max_batch not in self.buckets:
            self.buckets.append(self.max_batch)
            self.buckets.sort()
        self.max_wait_s = max_wait_ms / 1e3
        self.n_forwards = 0  # model calls made, warmup included
        self._cids = {}  # channel subset -> id tensor on the device
        self._lock = threading.Lock()  # one forward at a time
        self._queue: "queue.Queue" = queue.Queue()
        self._collector = None
        self._stop = threading.Event()
        self.stats = ServingStats()

    def _channel_ids(self, cids: Sequence[int]) -> torch.Tensor:
        key = tuple(int(c) for c in cids)
        t = self._cids.get(key)
        if t is None:
            limit = getattr(self.model, "num_total_channels", None)
            if limit is not None and any(not 0 <= c < limit for c in key):
                raise ValueError(f"channel ids {list(key)} out of range [0, {limit})")
            t = self._cids[key] = torch.tensor(key, dtype=torch.long, device=self.device)
        return t

    def _forward(self, chunk: np.ndarray, cids: Sequence[int]) -> np.ndarray:
        cid = self._channel_ids(cids)
        mode = (contextlib.nullcontext() if self.quantization is None
                else fused_block.quantization(self.quantization))
        with self._lock, torch.inference_mode(), mode:
            out, _ = self.model(torch.from_numpy(chunk).to(self.device), cid)
            self.n_forwards += 1
            return out.float().cpu().numpy()

    def warmup(self, cids: Sequence[int], img_shape: Sequence[int]):
        """Run every bucket once for one channel subset."""
        for b in self.buckets:
            self._forward(np.zeros((b, len(cids), *img_shape), np.float32), cids)

    # ---- synchronous batched path --------------------------------------

    def predict(self, images: np.ndarray, cids: Sequence[int]) -> np.ndarray:
        """Run a whole request batch: pad to the bucket, run, trim.

        ``images``: (B, k, H, W) float array whose channel axis matches
        ``cids`` (global channel ids).
        """
        images = np.asarray(images, np.float32)
        if images.ndim != 4 or images.shape[1] != len(cids):
            raise ValueError(f"images {images.shape} do not match {len(cids)} channel ids")
        n = images.shape[0]
        outs = []
        i = 0
        while i < n:
            take = min(n - i, self.max_batch)
            b = self.buckets[bisect.bisect_left(self.buckets, take)]
            chunk = images[i: i + take]
            if take < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - take, *images.shape[1:]), np.float32)]
                )
            outs.append(self._forward(np.ascontiguousarray(chunk), cids)[:take])
            i += take
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    # ---- dynamic micro-batching ----------------------------------------

    def start(self):
        if self._collector is None:
            self._stop.clear()
            self._collector = threading.Thread(target=self._run, daemon=True)
            self._collector.start()
        return self

    def stop(self):
        self._stop.set()
        if self._collector is not None:
            self._collector.join()
            self._collector = None
        # fail any requests still queued — a stranded Future blocks its
        # client forever
        while True:
            try:
                *_, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("serving engine stopped"))

    def submit(self, image: np.ndarray, cids: Sequence[int]) -> Future:
        """Enqueue one (k, H, W) image; the collector coalesces the queue
        into one forward per channel subset per flush."""
        fut: Future = Future()
        self._queue.put((np.asarray(image, np.float32),
                         tuple(int(c) for c in cids), time.perf_counter(), fut))
        return fut

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=left))
                except queue.Empty:
                    break
            # group by channel subset — one forward per distinct subset
            by_cids: dict = {}
            for img, cids, t0, fut in batch:
                by_cids.setdefault(cids, []).append((img, t0, fut))
            for cids, items in by_cids.items():
                try:
                    out = self.predict(np.stack([im for im, _, _ in items]), cids)
                    now = time.perf_counter()
                    for (_, t0, fut), row in zip(items, out):
                        self.stats.record(now - t0, 1)
                        fut.set_result(row)
                except Exception as e:  # surfaced to the caller's Future
                    for _, _, fut in items:
                        fut.set_exception(e)
            self.stats.n_flushes += 1
