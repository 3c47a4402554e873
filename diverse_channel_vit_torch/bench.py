"""Training-throughput helpers of the port (counterpart of the pieces of the
repository's ``bench.py`` that ``scripts/bench_attn.py`` imports).

DiChaViT-S at JUMP-CP geometry (8 channels at 224^2, patch 16, 1569 tokens,
D = 384, depth 12, 161 classes, bf16 compute), trained with the cosine lr
schedule and AdamW of ``bench.py:58-62`` on one resident synthetic batch:

- :func:`_setup` builds model, train state and batch;
- :func:`_mk_step` makes the train step, all channels or the DCS recipe's
  ``lowest_cosine_prob`` draw of k channels;
- :func:`_measure` times steps on the host clock, ending in a read-back of
  the last loss;
- :func:`flagship_imgs_per_sec` is one all-channel measurement.

The JSON headline of ``bench.py`` (``main``) and its multi-device mesh are
not ported yet (ROADMAP A5, A10). Everything runs on ``cuda`` unless
``device="cpu"`` is given; ``img`` and ``depth`` shrink the model for a CPU
run.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

N_CHANNELS, IMG, CLASSES = 8, 224, 161
DEPTH = 12


def _setup(num_heads: int, batch: int, *, device: Optional[str] = None, img: int = IMG,
           depth: int = DEPTH):
    """``(model, state, data)`` for one geometry: full-width DiChaViT-S (the
    counterpart of ``__graft_entry__._build_flagship(224, 16, 12, 384,
    num_heads, 8, 161, bf16)``) with weights from seed 0, AdamW (weight decay
    0.04) under the cosine lr schedule (4e-4, t_initial 100, warmup_t 10,
    warmup_lr_init 1e-5), and a batch of ``batch`` seeded normal images on
    the device with labels ``arange % 161``."""
    from .config import Config
    from .device import resolve_device
    from .models import build_model
    from .training import TrainState, make_lr_schedule, make_optimizer

    device = resolve_device(device)
    cfg = Config({
        "in_channel_names": [f"ch{i}" for i in range(N_CHANNELS)], "img_size": [img],
        "patch_size": 16, "pretrained_model_name": "small", "depth": depth,
        "num_heads": num_heads, "proxy_loss_lambda": 1e-3, "ortho_loss_v1_lambda": 1e-3,
        "gamma_s": 1.0, "gamma_d": 4.0,
    })
    model = build_model("dichavit", cfg, {"JUMP-CP": list(range(N_CHANNELS))}, CLASSES,
                        device=device, dtype=torch.bfloat16, seed=0)
    lr = make_lr_schedule("cosine", 4e-4, dict(t_initial=100, warmup_t=10, warmup_lr_init=1e-5),
                          num_epochs=100, steps_per_epoch=100)
    tx = make_optimizer("adamw", dict(weight_decay=0.04), lr_schedule=lr, total_steps=10000)
    state = TrainState(model, tx)
    gen = torch.Generator(device=device).manual_seed(2)
    data = {"image": torch.randn((batch, N_CHANNELS, img, img), generator=gen, device=device),
            "label": torch.arange(batch, device=device) % CLASSES}
    return model, state, data


def _mk_step(model, k: Optional[int]):
    """The train step: CE plus the diversity losses (``extra_loss_lambda``
    1), on all channels, or with ``k`` on k channels drawn per step by
    ``lowest_cosine_prob`` at temperature 1000 (``train_scripts.sh:5``)."""
    from .training import make_train_step

    return make_train_step(
        model, channel_ids=range(N_CHANNELS), k=k,
        hcs_method="lowest_cosine_prob" if k else "none", hcs_temp=1000.0,
        loss_type="ce", extra_loss_lambda=1.0)


def _sync(metrics) -> float:
    """Wait for the device: read the loss back to the host."""
    return float(metrics["loss"])


def _measure(state, data, steps, batch: int, iters: int, warmup: int = 3):
    """``(images per second, state)`` over ``iters`` steps after ``warmup``,
    step ``i`` running ``steps[i % len(steps)]``; host clock, ending in a
    read-back of the last loss."""
    metrics = None
    for i in range(warmup):
        state, metrics = steps[i % len(steps)](state, data)
    if warmup:
        _sync(metrics)
    t0 = time.perf_counter()
    for i in range(iters):
        state, metrics = steps[i % len(steps)](state, data)
    _sync(metrics)
    return batch * iters / (time.perf_counter() - t0), state


def flagship_imgs_per_sec(num_heads: int = 6, batch: int = 64, iters: int = 20, *,
                          device: Optional[str] = None, img: int = IMG,
                          depth: int = DEPTH) -> float:
    """Training images per second of the all-channel step on one device."""
    model, state, data = _setup(num_heads, batch, device=device, img=img, depth=depth)
    step = _mk_step(model, None)
    ips, _ = _measure(state, data, [step], batch, iters)
    return ips
