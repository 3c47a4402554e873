"""Train steps of the fused path at non-flagship geometries (counterpart of
``scripts/smoke_geometries.py``).

    python -m diverse_channel_vit_torch.scripts.smoke_geometries

:func:`main` runs the JAX script's five geometries at its batch sizes, in
bf16 with f32 parameters, each for one step and then five timed steps:

- ``chammi12 proxy+TDL ViT-S``: 12 channels at 224^2 (12 * 196 + 1 = 2353
  tokens), the proxy main loss with CDL and TDL, no head, B = 32;
- ``chammi12 DCS k=5``: the same with diverse channel sampling
  (``lowest_cosine_prob``) at k = 5 of 12 (981 tokens), B = 32;
- ``base D=768 jump_cp``: the ``base`` width (D = 768, 12 heads of 64) at
  JUMP-CP geometry (8 channels, 1569 tokens), cross entropy, B = 16;
- ``dh128 jump_cp``: D = 384 in 3 heads of 128, B = 64;
- ``so2sat 18ch p8``: 18 channels at 32^2 with patch 8 (289 tokens), B = 128.

Each prints its loss before and after the timed steps, whether both are
finite, ms per step and images/s, and fails unless both losses are finite.
The model, losses and optimizer are the JAX script's: proxy loss lambda 0.1,
orthogonality (CDL) lambda 1.0, extra loss lambda 1.0, AdamW with weight
decay 0.04 under a cosine lr of 4e-5. Weights come from seed 0 and the
synthetic images (standard normal) from ``seed``, both drawn by numpy and
PyTorch here, not by JAX, so the losses are not the JAX script's numbers.

The JAX script's ``compile_cache.enable()`` and ``donate=True`` have no
counterpart in PyTorch (ROADMAP A6), and its step's ``patch_size`` argument
feeds only a sampler the port has not ported (``lowest_cosine_prob_proj``).
Times are host-clock times over the five steps, read after the last loss,
as the JAX script reads them.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.channel_vit import ChannelVisionTransformer
from ..models.wrappers import ChannelAdaptiveClassifier
from ..ops.dispatch import LAUNCHES
from ..training import TrainState, make_lr_schedule, make_optimizer, make_train_step

NUM_CLASSES = 21
TIMED_STEPS = 5

# the JAX script's __main__, in its order
GEOMETRIES = (
    # CHAMMI-superset geometry: 12 channels -> 12 * 196 + 1 = 2353 tokens
    ("chammi12 proxy+TDL ViT-S", dict(c=12, img=224, dim=384, depth=12, heads=6, batch=32,
                                      loss_type="proxy", with_head=False)),
    # DCS sampling at k = 5 of 12 (981 tokens)
    ("chammi12 DCS k=5", dict(c=12, img=224, dim=384, depth=12, heads=6, batch=32,
                              loss_type="proxy", with_head=False, k=5)),
    # ViT-base width
    ("base D=768 jump_cp", dict(c=8, img=224, dim=768, depth=12, heads=12, batch=16,
                                loss_type="ce", with_head=True)),
    # head width 128
    ("dh128 jump_cp", dict(c=8, img=224, dim=384, depth=12, heads=3, batch=64,
                           loss_type="ce", with_head=True)),
    # So2Sat geometry: 18 channels, 32 x 32, patch 8 -> 18 * 16 + 1 = 289 tokens
    ("so2sat 18ch p8", dict(c=18, img=32, dim=384, depth=12, heads=6, batch=128,
                            loss_type="ce", with_head=True, patch=8)),
)


def smoke(tag: str, *, c: int, img: int, dim: int, depth: int, heads: int, batch: int,
          loss_type: str, with_head: bool, k: Optional[int] = None, patch: int = 16,
          device: Optional[str] = "cuda", seed: int = 1) -> dict:
    """Build the geometry's DiChaViT and train it for 1 + 5 steps on one
    synthetic batch; print the JAX script's report line. Returns ``loss0``,
    ``loss1``, ``ms_per_step``, ``imgs_per_s``, ``steps``, ``launches``, the
    kernel launches of the steps by kernel (``ops.dispatch.LAUNCHES``), and
    on the card ``peak_mem_gb``, the steps' peak device memory."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    backbone = ChannelVisionTransformer(
        num_total_channels=c, img_size=img, patch_size=patch, embed_dim=dim, depth=depth,
        num_heads=heads, proxy_loss_lambda=0.1, ortho_loss_v1_lambda=1.0,
        dtype=torch.bfloat16, generator=gen,
    )
    model = ChannelAdaptiveClassifier(backbone, embed_dim=dim, num_classes=NUM_CLASSES,
                                      with_head=with_head, generator=gen).to(device)
    lr = make_lr_schedule("cosine", 4e-5, dict(t_initial=10, warmup_t=1, warmup_lr_init=1e-6),
                          num_epochs=10, steps_per_epoch=10)
    tx = make_optimizer("adamw", dict(weight_decay=0.04), lr_schedule=lr, total_steps=100)
    state = TrainState(model, tx)
    step = make_train_step(model, channel_ids=range(c), k=k,
                           hcs_method="lowest_cosine_prob" if k else "none",
                           loss_type=loss_type, extra_loss_lambda=1.0)
    rng = np.random.default_rng(seed)
    data = {"image": torch.from_numpy(rng.standard_normal((batch, c, img, img),
                                                          dtype=np.float32)).to(device),
            "label": (torch.arange(batch) % NUM_CLASSES).to(device)}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = dict(LAUNCHES)
    state, m = step(state, data)
    loss0 = float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, m = step(state, data)
    loss1 = float(m["loss"])
    dt = (time.perf_counter() - t0) / TIMED_STEPS
    ok = math.isfinite(loss0) and math.isfinite(loss1)
    print(f"{tag}: loss {loss0:.4f} -> {loss1:.4f} finite={ok} "
          f"{dt * 1e3:.0f} ms/step ({batch / dt:.1f} imgs/s)", flush=True)
    assert ok, tag
    return {"loss0": loss0, "loss1": loss1, "ms_per_step": dt * 1e3, "imgs_per_s": batch / dt,
            "steps": 1 + TIMED_STEPS,
            "launches": {name: LAUNCHES[name] - before[name] for name in LAUNCHES},
            "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == "cuda" else None)}


def main(device: Optional[str] = "cuda", seed: int = 1) -> dict:
    """The JAX script's ``__main__``: every geometry of :data:`GEOMETRIES`
    in order. Returns each one's :func:`smoke` result by tag."""
    return {tag: smoke(tag, **kw, device=device, seed=seed) for tag, kw in GEOMETRIES}


if __name__ == "__main__":
    main()
