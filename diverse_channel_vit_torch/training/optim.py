"""Optimizer factory (counterpart of the JAX package's ``training/optim.py``).

The JAX package builds an optax chain per optimizer name, after an optional
``clip_by_global_norm``:

- ``"sgd"``: ``add_decayed_weights(wd)`` (torch SGD's coupled L2) ->
  ``trace(momentum, nesterov)`` -> ``-lr(t)``. ``torch.optim.SGD`` (no
  dampening) computes the same update, so :class:`SGD` drives it.
- ``"adam"``: ``add_decayed_weights(wd)`` before the moments (torch Adam's
  coupled L2) -> ``scale_by_adam`` -> ``-lr(t)``: ``torch.optim.Adam``.
- ``"adamw"``: ``scale_by_adam`` -> ``add_scheduled_weight_decay`` ->
  ``-lr(t)``, so each update is
  ``p <- p - lr(t) * (m_hat / (sqrt(v_hat) + eps) + wd(t) * p)``, with the
  weight decay on the reference's cosine schedule when ``weight_decay_end``
  is set. ``torch.optim.AdamW`` computes the same update (it scales p by
  1 - lr * wd, then subtracts lr times the Adam step, both from the old p).
- ``"adamp"``: timm's AdamP (:class:`AdamPOptimizer`), Adam whose step is
  projected onto the tangent space of scale-invariant weights.

Only AdamW's decay follows ``weight_decay_end``; SGD, Adam and AdamP take the
constant ``weight_decay``, as the JAX chains do.

``mu_dtype`` (``"bfloat16"``) keeps Adam's and AdamW's first moment in that
dtype, as optax's ``scale_by_adam(mu_dtype=...)`` does: the new moment is
``(1 - b1) * g + b1 * m`` with ``b1 * m`` a bf16 product (b1 itself rounded
to bf16, 0.8984375 for 0.9, as JAX casts a Python scalar to the array's
dtype) and the sum in f32, the update reads that f32 moment, and the state
keeps it rounded to bf16. No torch optimizer does this, so :class:`LowPrecisionMuAdam` writes
the update with ``torch._foreach_*`` ops. JAX ignores ``mu_dtype`` for SGD
and AdamP, and so does the port.

Every optimizer here is a ``torch.optim.Optimizer``, so its state is its
``state_dict`` (saved by ``training/checkpoint.py``), and every one writes
the parameters in place under ``no_grad``, which moves their version
counters (serving's weight casts key on them, ``models/vit.py``).

AdamP views tensors in the port's layout, which is the PyTorch reference's:
a linear weight's channel view is per output unit, as in timm. The JAX
package views its own layout (a ``Dense`` kernel is (in, out)), so on a
model the two packages may take other projection branches for the same
weights; on the same arrays they agree.

Clipping is optax's rule (scale by max_norm / norm when norm >= max_norm),
not ``clip_grad_norm_``'s, which adds 1e-6 to the norm.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from .schedules import Schedule, wd_cosine_schedule

MU_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together (optax ``global_norm``), as an
    f32 scalar, summed in f64: torch's f32 reductions on the CPU drift by
    about 3e-6 of the norm over a few hundred thousand entries, which the
    clipping coefficient and so every moment would carry; in f64 the CPU and
    the card agree with each other and with XLA's f32 tree sums to f32
    rounding."""
    norms = torch._foreach_norm([t.float() for t in tensors], 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


class LowPrecisionMuAdam(torch.optim.Optimizer):
    """Adam (``decoupled=False``: the decay joins the gradient before the
    moments) or AdamW (``decoupled=True``: ``wd * p`` joins the Adam step)
    with the first moment kept in ``mu_dtype``, computed as optax's
    ``scale_by_adam`` and ``add_decayed_weights`` /
    ``add_scheduled_weight_decay`` chains compute it."""

    def __init__(self, params, *, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool, mu_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.decoupled = decoupled
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            grads = [p.grad.float() for p in params]
            if wd and not self.decoupled:
                grads = torch._foreach_add(grads, params, alpha=wd)
            mus, nus = [], []
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
                # a state_dict load casts the moment to the parameter's dtype:
                # its values are still the low-precision ones
                mus.append(st["exp_avg"].to(self.mu_dtype))
                nus.append(st["exp_avg_sq"])
            t = self.state[params[0]]["step"]
            # (1 - b1) g + b1 m: b1 m a product in mu_dtype, the sum in f32
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            mu = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(mu, [m.float() for m in torch._foreach_mul(mus, b1_mu)])
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1.0 - b2))
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            upd = torch._foreach_div(mu, bc1)
            den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(den, eps)
            torch._foreach_div_(upd, den)
            if wd and self.decoupled:
                torch._foreach_add_(upd, params, alpha=wd)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(params, upd)
            for p, m in zip(params, mu):
                self.state[p]["exp_avg"] = m.to(self.mu_dtype)


class AdamPOptimizer(torch.optim.Optimizer):
    """timm's AdamP (JAX ``training/optim.py`` ``adamp``): Adam's step,
    projected where a weight is scale-invariant, with the decay scaled by
    ``wd_ratio`` where it was projected. A tensor of two or more dimensions
    tries its channel view (one row per first index), then its layer view
    (one row); a view applies when every row's |cos(p, g)| is below
    0.1 / sqrt(row length). The decay is coupled to the step, both from the
    old parameter."""

    def __init__(self, params, *, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, wd_ratio: float = 0.1, nesterov: bool = False):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, wd_ratio=wd_ratio,
                                      nesterov=nesterov))

    @staticmethod
    def _view(p, g, perturb, rows: int, eps: float = 1e-30):
        pv, gv = p.reshape(rows, -1), g.reshape(rows, -1)
        p_norm = torch.linalg.vector_norm(pv, dim=1)
        g_norm = torch.linalg.vector_norm(gv, dim=1)
        cos = (pv * gv).sum(dim=1).abs() / (p_norm * g_norm + eps)
        cond = cos.max() < 0.1 / math.sqrt(pv.shape[1])
        expand = (-1,) + (1,) * (p.ndim - 1)
        p_n = p / (p_norm.reshape(expand) + eps)
        proj = perturb - p_n * (p_n * perturb).reshape(rows, -1).sum(dim=1).reshape(expand)
        return cond, proj

    @classmethod
    def project(cls, p, g, perturb, wd_ratio: float):
        """``(perturb', ratio)``: the channel view's projection, else the
        layer view's, else ``perturb`` unchanged with ratio 1; chosen on the
        device, with no host read."""
        if p.ndim < 2:
            return perturb, torch.ones((), device=p.device)
        cond_c, proj_c = cls._view(p, g, perturb, p.shape[0])
        cond_l, proj_l = cls._view(p, g, perturb, 1)
        out = torch.where(cond_c, proj_c, torch.where(cond_l, proj_l, perturb))
        one = torch.ones((), device=p.device)
        return out, torch.where(cond_c | cond_l, one * wd_ratio, one)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = st["step"]
                g = p.grad
                m = st["exp_avg"].mul_(b1).add_(g * (1.0 - b1))
                v = st["exp_avg_sq"].mul_(b2).add_(g * (1.0 - b2) * g)
                bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
                denom = torch.sqrt(v / bc2) + eps
                if group["nesterov"]:
                    perturb = (b1 * m + (1.0 - b1) * g) / (bc1 * denom)
                else:
                    perturb = (m / bc1) / denom
                perturb, ratio = self.project(p, g, perturb, group["wd_ratio"])
                delta = -lr * perturb
                if wd > 0:
                    delta = delta - (lr * wd) * ratio * p
                p.add_(delta)


class ScheduledOptimizer:
    """An optimizer over a torch one: :meth:`init` builds it for a list of
    parameters or param groups; :meth:`update` clips the gradients, sets the
    schedules' values for update ``step`` (0-based) and steps."""

    def __init__(self, *, lr_schedule: Schedule, wd_schedule: Schedule,
                 clip_grad_norm: Optional[float] = None, **hyper):
        self.lr_schedule = lr_schedule
        self.wd_schedule = wd_schedule
        self.clip_grad_norm = float(clip_grad_norm) if clip_grad_norm else None
        self.hyper = hyper

    def _make(self, groups: List[dict], lr: float, wd: float) -> torch.optim.Optimizer:
        raise NotImplementedError

    def init(self, params) -> torch.optim.Optimizer:
        """The torch optimizer over ``params``: a list of parameters, or of
        param groups ``{"params": [...], "lr_mult": m}``. A group's lr is the
        schedule's times its ``lr_mult`` (1 by default), which scales its
        whole update, decay included: JAX's ``chain(tx, scale(m))``
        partition (MIRO's encoders, ``trainer.py:319-335``)."""
        params = list(params)
        if not params or not isinstance(params[0], dict):
            params = [{"params": params}]
        groups = [dict(g, lr_mult=float(g.get("lr_mult", 1.0))) for g in params]
        return self._make(groups, self.lr_schedule(0), self.wd_schedule(0))

    def update(self, opt: torch.optim.Optimizer, step: int) -> torch.Tensor:
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


class _Adam(ScheduledOptimizer):
    """Adam's moments with scheduled lr and weight decay: the torch optimizer,
    or :class:`LowPrecisionMuAdam` with a ``mu_dtype`` other than f32."""

    decoupled = True
    torch_cls = torch.optim.AdamW

    def __init__(self, *, lr_schedule: Schedule, wd_schedule: Schedule, betas=(0.9, 0.999),
                 eps: float = 1e-8, clip_grad_norm: Optional[float] = None,
                 mu_dtype: Optional[torch.dtype] = None):
        super().__init__(lr_schedule=lr_schedule, wd_schedule=wd_schedule,
                         clip_grad_norm=clip_grad_norm,
                         betas=tuple(float(b) for b in betas), eps=float(eps))
        self.mu_dtype = mu_dtype

    def _make(self, groups, lr, wd):
        if self.mu_dtype not in (None, torch.float32):
            return LowPrecisionMuAdam(groups, lr=lr, weight_decay=wd, decoupled=self.decoupled,
                                      mu_dtype=self.mu_dtype, **self.hyper)
        return self.torch_cls(groups, lr=lr, weight_decay=wd, **self.hyper)


class AdamW(_Adam):
    """AdamW: the decay decoupled from the moments (``torch.optim.AdamW``)."""


class Adam(_Adam):
    """Adam with torch's coupled L2 decay (``torch.optim.Adam``)."""

    decoupled = False
    torch_cls = torch.optim.Adam


class SGD(ScheduledOptimizer):
    """SGD with coupled L2 decay and heavy-ball or Nesterov momentum:
    ``torch.optim.SGD`` without dampening (optax's ``trace``)."""

    def _make(self, groups, lr, wd):
        momentum = float(self.hyper.get("momentum") or 0.0)
        return torch.optim.SGD(groups, lr=lr, weight_decay=wd, momentum=momentum,
                               nesterov=bool(self.hyper.get("nesterov")) and momentum > 0)


class AdamP(ScheduledOptimizer):
    def _make(self, groups, lr, wd):
        return AdamPOptimizer(groups, lr=lr, weight_decay=wd, **self.hyper)


def make_optimizer(name: str, opt_params: Dict, *, lr_schedule: Schedule, total_steps: int,
                   clip_grad_norm: Optional[float] = None) -> ScheduledOptimizer:
    """name -> optimizer (``optimizers.py`` parity): ``"sgd"``, ``"adam"``,
    ``"adamw"`` or ``"adamp"``. ``opt_params`` is the reference's
    ``cfg.optimizer.params`` verbatim, including the ``weight_decay_end``
    key that switches on AdamW's cosine weight-decay schedule and the
    ``mu_dtype`` of Adam's and AdamW's first moment."""
    p = dict(opt_params or {})
    p.pop("lr", None)  # lr comes from the schedule
    name = (name or "adamw").lower()
    wd = float(p.pop("weight_decay", 0.0) or 0.0)
    wd_end = p.pop("weight_decay_end", None)
    if name == "adamw" and wd_end is not None and wd_end > -1:
        wd_fn = wd_cosine_schedule(wd, float(wd_end), total_steps)
    else:
        wd_fn = lambda step: wd  # noqa: E731
    kw = dict(lr_schedule=lr_schedule, wd_schedule=wd_fn, clip_grad_norm=clip_grad_norm)
    betas = p.get("betas", (0.9, 0.999))
    eps = float(p.get("eps", 1e-8))
    if name == "sgd":
        return SGD(**kw, momentum=float(p.get("momentum", 0.0) or 0.0),
                   nesterov=bool(p.get("nesterov", False)))
    if name == "adamp":
        return AdamP(**kw, betas=tuple(float(b) for b in betas), eps=eps,
                     wd_ratio=float(p.get("wd_ratio", 0.1)),
                     nesterov=bool(p.get("nesterov", False)))
    if name not in ("adam", "adamw"):
        raise NotImplementedError(f"Not implemented optimizer: {name}")
    mu = p.get("mu_dtype")
    if mu and str(mu) not in MU_DTYPES:
        raise ValueError(f"mu_dtype={mu!r}: one of {sorted(MU_DTYPES)}")
    return (AdamW if name == "adamw" else Adam)(
        **kw, betas=betas, eps=eps, mu_dtype=MU_DTYPES[str(mu)] if mu else None)
