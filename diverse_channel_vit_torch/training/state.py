"""Train state (counterpart of the JAX package's ``training/state.py``).

The JAX package keeps params, optimizer state and the step in an immutable
flax ``TrainState`` pytree that every jitted step replaces. PyTorch updates in
place: :class:`TrainState` holds the model (its f32 master parameters), the
``torch.optim`` optimizer with its moments, the optimizer's schedules and the
update count, and a step changes all of them where they are. The compute
dtype is bf16 with f32 master parameters, which needs no loss scaling.

``frozen`` names parameters that stay out of the optimizer
(``training/freeze.py``); MIRO's encoders (``miro_encoders.*``) form a param
group of their own at ``miro_lr_mult`` times the lr, clipped by their own
norm (JAX ``trainer.py:319-335``).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from .miro import MIRO_KEY
from .optim import ScheduledOptimizer, global_norm


class TrainState:
    def __init__(self, model: torch.nn.Module, tx: ScheduledOptimizer, *,
                 frozen: Iterable[str] = (), miro_lr_mult: Optional[float] = None):
        self.model = model
        self.tx = tx
        named = list(model.named_parameters())  # each Parameter once
        self.params = [p for _, p in named]
        self.frozen = set(frozen)
        unknown = self.frozen - {n for n, _ in named}
        if unknown:
            raise KeyError(f"frozen names no parameter of the model: {sorted(unknown)[:6]}")
        live = [(n, p) for n, p in named if n not in self.frozen]
        base = [p for n, p in live if not n.startswith(MIRO_KEY + ".")]
        miro = [p for n, p in live if n.startswith(MIRO_KEY + ".")]
        groups = [{"params": base}]
        if miro:
            groups.append({"params": miro, "lr_mult": 1.0 if miro_lr_mult is None
                           else float(miro_lr_mult)})
        self.optimizer = tx.init(groups)
        self.step = 0

    def zero_grad(self) -> None:
        """Drop every parameter's ``.grad``, frozen ones included (the
        optimizer's ``zero_grad`` would leave theirs to accumulate)."""
        for p in self.params:
            p.grad = None

    def apply_gradients(self) -> torch.Tensor:
        """One optimizer update from the parameters' ``.grad``; returns the
        global norm of every parameter's gradient before clipping, frozen
        ones included (JAX ``optax.global_norm(grads)``,
        ``training/steps.py:333``)."""
        norm = None
        if self.frozen:
            norm = global_norm([p.grad for p in self.params if p.grad is not None])
        opt_norm = self.tx.update(self.optimizer, self.step)
        self.step += 1
        return opt_norm if norm is None else norm
