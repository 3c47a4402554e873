"""Checkpoints (counterpart of the JAX package's ``training/checkpoint.py``).

The JAX package saves its TrainState pytree with Orbax and the bookkeeping
in a ``<name>.meta.json`` beside it. The port saves one ``torch.save`` file
at ``<directory>/<name>``: ``{"model": state_dict, "optimizer": the
torch optimizer's state_dict, "step": the update count}``, the model's
``state_dict`` in the layout ``models/export.params_from_jax`` produces
(the PyTorch reference's), and the same ``<name>.meta.json`` (epoch,
accuracy, config).

A restore copies each saved tensor into the live parameter in place under
``torch.no_grad()``, never through ``p.data``: serving's weight casts
(``models/vit.py`` ``_cached``) key on the tensor's version counter, which
an in-place copy bumps.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import torch


def save_checkpoint(
    directory: str,
    state,
    *,
    epoch: int,
    accuracy: float = 0.0,
    config: Optional[dict] = None,
    name: str = "model_last",
    extra_meta: Optional[dict] = None,
) -> str:
    """Write ``state`` (a ``TrainState``) and its meta.json; returns the
    checkpoint's path. Saves synchronously."""
    path = os.path.abspath(os.path.join(directory, name))
    os.makedirs(directory, exist_ok=True)
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, path)
    meta = {"epoch": int(epoch), "accuracy": float(accuracy), "config": config or {}}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(directory, f"{name}.meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def load_meta(directory: str, name: str = "model_last") -> dict:
    """The sidecar JSON written by :func:`save_checkpoint` ({} if absent)."""
    meta_path = os.path.join(directory, f"{name}.meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_checkpoint(directory: str, state, *, name: str = "model_last") -> Tuple[Any, int]:
    """Restore into ``state`` in place; returns (state, epoch). Every saved
    tensor must match a live one of the same shape, and every live one must
    be saved."""
    path = os.path.abspath(os.path.join(directory, name))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    live = state.model.state_dict(keep_vars=True)
    saved = ckpt["model"]
    if set(saved) != set(live):
        raise KeyError(f"checkpoint {path}: keys differ from the model's: missing "
                       f"{sorted(set(live) - set(saved))[:6]}, unexpected "
                       f"{sorted(set(saved) - set(live))[:6]}")
    with torch.no_grad():
        for key, t in live.items():
            if tuple(t.shape) != tuple(saved[key].shape):
                raise ValueError(f"checkpoint {path}: {key} has shape "
                                 f"{tuple(saved[key].shape)}, the model's {tuple(t.shape)}")
            t.copy_(saved[key])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state, int(load_meta(directory, name).get("epoch", 0))
