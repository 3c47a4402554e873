"""LR / weight-decay schedules with timm-parity semantics (counterpart of the
JAX package's ``training/schedules.py``).

Every schedule is a plain function of the global update count (0-based),
returning a Python float; the epoch-granularity behaviour (``t_in_epochs``)
is reproduced by flooring step / steps_per_epoch. The JAX package computes
the same formulas in f32; these compute them in double precision.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

Schedule = Callable[[int], float]


def timm_cosine_schedule(
    base_lr: float,
    *,
    t_initial: int,
    lr_min: float = 0.0,
    cycle_mul: float = 1.0,
    cycle_decay: float = 1.0,
    cycle_limit: int = 1,
    warmup_t: int = 0,
    warmup_lr_init: float = 0.0,
    warmup_prefix: bool = False,
    k_decay: float = 1.0,
    t_in_epochs: bool = True,
    steps_per_epoch: int = 1,
) -> Schedule:
    """timm ``CosineLRScheduler`` as a step -> lr function.

    During warmup lr ramps linearly from ``warmup_lr_init`` to ``base_lr``
    over ``warmup_t`` units; afterwards a cosine from
    ``base_lr * cycle_decay**i`` down to ``lr_min`` per cycle, ``lr_min`` flat
    once ``cycle_limit`` cycles are spent.

    Loop position: with ``t_in_epochs`` the reference steps the scheduler
    before each 1-based epoch, so every update of epoch ``e`` trains at the
    value for ``t = e``, hence ``t = step // steps_per_epoch + 1``. Without
    it the reference steps after update ``n`` (1-based), so update ``n``
    trains at ``value(n - 1)``: ``t = step``.
    """
    warmup_slope = (base_lr - warmup_lr_init) / max(warmup_t, 1)

    def fn(step: int) -> float:
        t = float(step // steps_per_epoch + 1 if t_in_epochs else step)
        if t < warmup_t:
            return warmup_lr_init + t * warmup_slope
        tc = t - (warmup_t if warmup_prefix else 0)
        if cycle_mul == 1.0:
            i = math.floor(tc / t_initial)
            t_i = float(t_initial)
            t_curr = tc - i * t_initial
        else:
            ratio = tc / t_initial * (cycle_mul - 1.0) + 1.0
            i = math.floor(math.log(max(ratio, 1.0)) / math.log(cycle_mul))
            t_start = t_initial * (cycle_mul ** i - 1.0) / (cycle_mul - 1.0)
            t_i = cycle_mul ** i * t_initial
            t_curr = tc - t_start
        if i >= cycle_limit:
            return lr_min
        lr_max = base_lr * cycle_decay ** i
        frac = (t_curr ** k_decay) / (t_i ** k_decay)
        return lr_min + 0.5 * (lr_max - lr_min) * (1.0 + math.cos(math.pi * frac))

    return fn


def timm_multistep_schedule(
    base_lr: float,
    *,
    decay_t: list,
    decay_rate: float = 1.0,
    warmup_t: int = 0,
    warmup_lr_init: float = 0.0,
    t_in_epochs: bool = False,
    steps_per_epoch: int = 1,
    convert_to_batch: bool = False,
) -> Schedule:
    """timm ``MultiStepLRScheduler``, same loop-position convention as the
    cosine schedule. ``convert_to_batch`` turns epoch milestones into update
    counts, as the reference trainer does."""
    milestones = [m * steps_per_epoch if convert_to_batch else m for m in decay_t]
    warmup_slope = (base_lr - warmup_lr_init) / max(warmup_t, 1)

    def fn(step: int) -> float:
        t = float(step // steps_per_epoch + 1 if t_in_epochs else step)
        if t < warmup_t:
            return warmup_lr_init + t * warmup_slope
        return base_lr * decay_rate ** sum(t >= m for m in milestones)

    return fn


def wd_cosine_schedule(base_value: float, final_value: float, total_steps: int) -> Schedule:
    """Effective per-update weight decay, reference-exact: the reference
    builds ``wd[i] = final + 0.5 (base - final)(1 + cos(pi i / total))`` and
    writes ``wd[n - 1]`` into the optimizer after update n, so update i
    (0-based) trains with ``wd[i - 1]`` and update 0 with the base value."""

    def fn(step: int) -> float:
        i = min(max(step - 1, 0), total_steps - 1)
        return final_value + 0.5 * (base_value - final_value) * (
            1.0 + math.cos(math.pi * i / max(total_steps, 1)))

    return fn


# timm knobs accepted for config parity that do not change the schedule's value
_IGNORED_KEYS = {"noise_range_t", "noise_pct", "noise_std", "noise_seed", "initialize"}


def make_lr_schedule(name: str, base_lr: float, params: Dict, *, num_epochs: int,
                     steps_per_epoch: int, convert_to_batch: bool = False) -> Schedule:
    """The reference's ``create_my_scheduler``: ``"cosine"``, ``"multistep"``
    or none."""
    params = {k: v for k, v in dict(params or {}).items() if k not in _IGNORED_KEYS}
    if name in (None, "none", "~", ""):
        return lambda step: float(base_lr)
    if name == "cosine":
        t_initial = params.pop("t_initial", None)
        if t_initial in (None, "FILL_LATER"):
            t_initial = num_epochs  # the trainer fills t_initial with the epoch count
        return timm_cosine_schedule(base_lr, t_initial=int(t_initial),
                                    steps_per_epoch=steps_per_epoch, **params)
    if name == "multistep":
        return timm_multistep_schedule(base_lr, steps_per_epoch=steps_per_epoch,
                                       convert_to_batch=convert_to_batch, **params)
    raise NotImplementedError(f"Not implemented scheduler: {name}")


def swad_schedule(base: Schedule, swa_step0: int, swa_lr: float,
                  anneal_steps: int = 10) -> Schedule:
    """The lr under SWAD (JAX ``trainer.py:273-307``): ``base`` until update
    ``swa_step0`` (the first update past epoch ``swa_start``), then the base
    schedule frozen at its last value and cosine-annealed to ``swa_lr`` over
    ``anneal_steps`` updates (torch ``SWALR``'s default ``anneal_epochs``,
    stepped per batch after the optimizer step), then constant."""
    frozen = base(swa_step0 - 1)

    def fn(step: int) -> float:
        if step < swa_step0:
            return base(min(step, swa_step0 - 1))
        t = min(max((step - swa_step0) / anneal_steps, 0.0), 1.0)
        alpha = 0.5 * (1.0 - math.cos(math.pi * t))
        return (1.0 - alpha) * frozen + alpha * swa_lr

    return fn
