"""Optimizer factory (counterpart of the JAX package's ``training/optim.py``).

The JAX package builds an optax chain per optimizer name; for ``"adamw"`` it
is ``clip_by_global_norm`` (optional) -> ``scale_by_adam`` ->
``add_scheduled_weight_decay`` -> ``-lr(step)``, so each update is

    p <- p - lr(t) * (m_hat / (sqrt(v_hat) + eps) + wd(t) * p)

with the weight decay following the reference's cosine schedule when
``weight_decay_end`` is set. ``torch.optim.AdamW`` computes the same update
(it scales p by 1 - lr * wd, then subtracts lr times the Adam step, both from
the old p), so :class:`AdamW` drives it and sets the group's ``lr`` and
``weight_decay`` from the schedules before every update. Clipping is optax's
rule (scale by max_norm / norm when norm >= max_norm), not
``clip_grad_norm_``'s, which adds 1e-6 to the norm.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .schedules import Schedule, wd_cosine_schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The f32 L2 norm of all ``tensors`` together (optax ``global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """AdamW with scheduled lr and weight decay and optional clipping by
    global norm. :meth:`init` builds the ``torch.optim.AdamW`` for a list of
    parameters; :meth:`update` clips the gradients, sets the schedules' values
    for update ``step`` (0-based) and steps."""

    def __init__(self, *, lr_schedule: Schedule, wd_schedule: Schedule,
                 betas=(0.9, 0.999), eps: float = 1e-8, clip_grad_norm: Optional[float] = None):
        self.lr_schedule = lr_schedule
        self.wd_schedule = wd_schedule
        self.betas = tuple(float(b) for b in betas)
        self.eps = float(eps)
        self.clip_grad_norm = float(clip_grad_norm) if clip_grad_norm else None

    def init(self, params) -> torch.optim.AdamW:
        """The ``torch.optim.AdamW`` over ``params``: a list of parameters,
        or of param groups ``{"params": [...], "lr_mult": m}``. A group's lr
        is the schedule's times its ``lr_mult`` (1 by default), which scales
        its decoupled decay step too: JAX's ``chain(tx, scale(m))`` partition
        (MIRO's encoders, ``trainer.py:319-335``)."""
        params = list(params)
        if not params or not isinstance(params[0], dict):
            params = [{"params": params}]
        groups = [dict(g, lr_mult=float(g.get("lr_mult", 1.0))) for g in params]
        return torch.optim.AdamW(groups, lr=self.lr_schedule(0), betas=self.betas, eps=self.eps,
                                 weight_decay=self.wd_schedule(0))

    def update(self, opt: torch.optim.AdamW, step: int) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the global norm
        of the optimizer's gradients before clipping. A parameter that got no
        gradient takes a zero one, as in JAX, so its moments and weight decay
        still advance. Each param group clips by its own norm, as each
        partition of an optax ``multi_transform`` runs its own chain."""
        lr, wd = self.lr_schedule(step), self.wd_schedule(step)
        norms = []
        for group in opt.param_groups:
            group["lr"] = lr * group.get("lr_mult", 1.0)
            group["weight_decay"] = wd
            if not group["params"]:
                continue
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in group["params"]]
            norm = global_norm(grads)
            norms.append(norm)
            if self.clip_grad_norm is not None:
                coef = torch.clamp(self.clip_grad_norm / norm, max=1.0)
                for g in grads:
                    g.mul_(coef.to(g.dtype))
        opt.step()
        return norms[0] if len(norms) == 1 else torch.linalg.vector_norm(torch.stack(norms))


def make_optimizer(name: str, opt_params: Dict, *, lr_schedule: Schedule, total_steps: int,
                   clip_grad_norm: Optional[float] = None) -> AdamW:
    """name -> optimizer (``optimizers.py`` parity). ``opt_params`` is the
    reference's ``cfg.optimizer.params`` verbatim, including the
    ``weight_decay_end`` key that switches on the cosine weight-decay
    schedule. Only ``"adamw"`` is ported; ``"sgd"``, ``"adam"`` and
    ``"adamp"`` raise ``NotImplementedError`` (ROADMAP A4)."""
    p = dict(opt_params or {})
    p.pop("lr", None)  # lr comes from the schedule
    name = (name or "adamw").lower()
    if name != "adamw":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (ROADMAP A4); "
                                  "only 'adamw' is")
    if p.get("mu_dtype"):
        raise NotImplementedError("mu_dtype (a bf16 first moment) is not ported yet")
    wd = float(p.pop("weight_decay", 0.0) or 0.0)
    wd_end = p.pop("weight_decay_end", None)
    if wd_end is not None and wd_end > -1:
        wd_fn = wd_cosine_schedule(wd, float(wd_end), total_steps)
    else:
        wd_fn = lambda step: wd  # noqa: E731
    return AdamW(lr_schedule=lr_schedule, wd_schedule=wd_fn,
                 betas=p.get("betas", (0.9, 0.999)), eps=float(p.get("eps", 1e-8)),
                 clip_grad_norm=clip_grad_norm)
