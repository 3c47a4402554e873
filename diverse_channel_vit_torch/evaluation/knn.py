"""Exact nearest-neighbour search on the card (counterpart of the JAX package's
``evaluation/knn.py``, single device).

Replaces ``FaissKNeighbors`` (``morphem/utils.py:8-46``): k = 1, L2
(``IndexFlatL2``) or cosine (normalise + ``IndexFlatIP``). Exact search is a
(Q_block x D) @ (D x N) float32 matmul and an argmax, in query blocks of 1024;
the bank (about 70k x 384 for CHAMMI) is copied to the device once. This is
a plain GEMM, which the JAX package leaves to XLA, so it is ``torch.mm``
here, with TF32 off for the call whatever the process has set.

The neighbour is the row of the highest score, ties going to the lowest
bank index, as ``jax.lax.top_k`` breaks them: ``argmax`` returns the first
maximum (CUDA ``topk`` promises no order among equal values).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device, tf32_off

QUERY_BLOCK = 1024


def _nearest_block(queries: torch.Tensor, bank: torch.Tensor, *, metric: str,
                   bank_sq: Optional[torch.Tensor] = None):
    """queries (Qb, D) x bank (N, D), both f32 (the bank already normalised
    for cosine) -> (scores (Qb, 1), indices (Qb, 1)), higher scores closer."""
    if metric == "cosine":
        q = queries / torch.clamp_min(torch.linalg.vector_norm(queries, dim=1, keepdim=True),
                                      1e-12)
        scores = q @ bank.t()
    elif metric == "l2":
        # -||q - b||^2 = 2 q.b - ||b||^2 (+ ||q||^2, the same for every b)
        scores = 2.0 * (queries @ bank.t()) - bank_sq[None, :]
    else:
        raise ValueError(f"metric must be l2|cosine, got {metric!r}")
    idx = scores.argmax(dim=1, keepdim=True)
    return scores.gather(1, idx), idx


class KNeighbors:
    """FAISS-parity exact 1-nearest-neighbour classifier (the reference's
    only use, ``k = 1``) on ``device``, the card unless ``"cpu"`` is asked
    for."""

    def __init__(self, metric: str = "l2", device: Optional[Union[str, torch.device]] = None):
        self.metric = metric
        self.device = resolve_device(device)
        self._bank: Optional[torch.Tensor] = None
        self._bank_sq: Optional[torch.Tensor] = None
        self._y: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray, y: np.ndarray):
        bank = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(self.device)
        if self.metric == "cosine":
            bank = bank / torch.clamp_min(torch.linalg.vector_norm(bank, dim=1, keepdim=True),
                                          1e-12)
        self._bank = bank
        self._bank_sq = (bank * bank).sum(dim=1) if self.metric == "l2" else None
        self._y = np.asarray(y)
        return self

    def kneighbors(self, X: np.ndarray):
        X = np.ascontiguousarray(X, np.float32)
        all_val, all_idx = [], []
        with tf32_off():
            for s in range(0, X.shape[0], QUERY_BLOCK):
                q = torch.from_numpy(X[s:s + QUERY_BLOCK]).to(self.device)
                vals, idx = _nearest_block(q, self._bank, metric=self.metric,
                                           bank_sq=self._bank_sq)
                all_val.append(vals.cpu().numpy())
                all_idx.append(idx.cpu().numpy())
        if not all_idx:
            return np.zeros((0, 1), np.float32), np.zeros((0, 1), np.int64)
        return np.concatenate(all_val), np.concatenate(all_idx)

    def predict(self, X: np.ndarray) -> np.ndarray:
        _, idx = self.kneighbors(X)
        return self._y[idx[:, 0]]
