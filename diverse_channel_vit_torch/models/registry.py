"""Model registry (counterpart of the JAX package's ``models/registry.py``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from ..device import resolve_device

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def wrap(fn: Callable) -> Callable:
        MODEL_REGISTRY[name] = fn
        return fn

    return wrap


def build_model(name: str, cfg_model, mapper: dict, num_classes: int, *,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.float32, seed: int = 0) -> torch.nn.Module:
    """Build a registered model with weights drawn from ``seed``, on
    ``device`` (the card unless ``"cpu"`` is asked for), in eval mode.
    ``dtype`` is the compute dtype, as in the JAX package."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    device = resolve_device(device)
    icn = cfg_model.get("in_channel_names")
    if isinstance(icn, str):
        raise ValueError(
            f"model.in_channel_names is the unset yaml placeholder {icn!r}; sync it from the "
            "dataset first (cfg.model.in_channel_names = cfg.dataset.in_channel_names)"
        )
    if isinstance(icn, (list, tuple)) and mapper:
        max_id = max((max(ids) for ids in mapper.values() if len(ids)), default=0)
        if max_id >= len(icn):
            raise ValueError(
                f"mapper channel id {max_id} out of range for {len(icn)} "
                "model.in_channel_names"
            )
    generator = torch.Generator().manual_seed(seed)
    model = MODEL_REGISTRY[name](cfg_model, mapper, num_classes, dtype=dtype, generator=generator)
    return model.to(device).eval()
