"""Train state (counterpart of the JAX package's ``training/state.py``).

The JAX package keeps params, optimizer state and the step in an immutable
flax ``TrainState`` pytree that every jitted step replaces. PyTorch updates in
place: :class:`TrainState` holds the model (its f32 master parameters), the
``torch.optim`` optimizer with its moments, the optimizer's schedules and the
update count, and a step changes all of them where they are. The compute
dtype is bf16 with f32 master parameters, which needs no loss scaling.
"""

from __future__ import annotations

import torch

from .optim import AdamW


class TrainState:
    def __init__(self, model: torch.nn.Module, tx: AdamW):
        self.model = model
        self.tx = tx
        self.params = list(model.parameters())  # each Parameter once
        self.optimizer = tx.init(self.params)
        self.step = 0

    def apply_gradients(self) -> torch.Tensor:
        """One optimizer update from the parameters' ``.grad``; returns the
        gradients' global norm before clipping."""
        norm = self.tx.update(self.optimizer, self.step)
        self.step += 1
        return norm
