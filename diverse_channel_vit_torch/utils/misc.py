"""Small runtime helpers: seeds, meters, timers, device memory (the port's
own copy of the JAX package's ``utils/misc.py``).

Counterpart of the reference's ``utils.py`` support code (``set_seeds`` at
``utils.py:394-401``, AverageMeter/timers at ``utils.py:239-333``).
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch


def set_seeds(seed: int) -> np.random.Generator:
    """Seed the host RNGs and torch's; returns a dedicated numpy Generator
    for the run (the Trainer's ``host_rng``: channel-count draws)."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return np.random.default_rng(seed)


class AverageMeter:
    """Tracks mean of a streaming metric."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0
        self.val = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Timer:
    """Wall-clock timer with ETA support."""

    def __init__(self):
        self.start_time = time.time()
        self.laps: list[float] = []

    def lap(self) -> float:
        now = time.time()
        elapsed = now - (self.start_time + sum(self.laps))
        self.laps.append(elapsed)
        return elapsed

    def elapsed(self) -> float:
        return time.time() - self.start_time

    def eta(self, done: int, total: int) -> float:
        if done == 0:
            return float("inf")
        return self.elapsed() / done * (total - done)


def device_memory_stats() -> dict:
    """Per-card memory use (the reference's GPU memory introspection,
    ``utils.py:47-110``): {device: {bytes_in_use, peak_bytes_in_use,
    bytes_limit}}, empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
