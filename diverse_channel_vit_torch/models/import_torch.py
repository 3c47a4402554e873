"""Warm start from a reference checkpoint (the port's own copy of the reader
and ``merge_into_template`` of the JAX package's ``models/import_torch.py``).

The port's modules use the PyTorch reference's parameter layout, so a
reference ``state_dict`` needs no conversion, only reading:

- the reference trainer's checkpoint dict, ``{"model_params": state_dict,
  "epoch", "accuracy", ...}`` (reference ``trainer.py:1292-1306``), or a
  bare ``model.state_dict()``;
- either with ``module.``-prefixed keys (DataParallel / DDP), which are
  dropped as the reference does (``trainer.py:1313-1317``);
- the reference checkpoint pickles its omegaconf config: classes that do not
  import here unpickle as an opaque placeholder, the tensors as tensors.

:func:`merge_into_template` then loads every tensor whose name and shape fit
the model and keeps the model's own init for the others (a new task's head
or proxies of another width), as the JAX package's Trainer does for
``model.pretrained`` (``trainer.py:371-400``).
"""

from __future__ import annotations

import pickle
import types
from typing import Any, Dict, List, Tuple

import torch

__all__ = ["strip_module_prefix", "load_reference_checkpoint", "merge_into_template"]


def strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop the ``module.`` prefix DataParallel / DDP wrappers add."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


class _Opaque:
    """Stand-in for the pickled classes that do not import here."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        pass


def _torch_load_tolerant(path: str):
    """``torch.load`` that survives the reference checkpoint's pickled
    omegaconf config when the library is absent."""

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ModuleNotFoundError, AttributeError):
                return type(name, (_Opaque,), {})

    shim = types.ModuleType("_import_torch_pickle_shim")
    shim.Unpickler = _Unpickler
    shim.load = pickle.load
    shim.loads = pickle.loads
    return torch.load(path, map_location="cpu", pickle_module=shim, weights_only=False)


_WRAPPER_KEYS = {"proxies", "logit_scale", "classifer_head.weight"}


def load_reference_checkpoint(path_or_dict, *, prefix: str = "feature_extractor."
                              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Reference checkpoint (a path or an already loaded dict) -> (the
    port's ``state_dict`` entries, meta). ``meta`` holds the checkpoint's
    ``epoch`` and ``accuracy`` where it has them. As in the JAX reader, a
    state dict without the wrapper's entries (``proxies``, ``logit_scale``,
    ``classifer_head``) is a bare backbone: its keys lose ``prefix``, so it
    fits a bare ``ChannelVisionTransformer`` and no wrapper."""
    obj = path_or_dict
    if isinstance(obj, str):
        obj = _torch_load_tolerant(obj)
    meta: Dict[str, Any] = {}
    sd = obj
    if isinstance(obj, dict) and "model_params" in obj:
        sd = obj["model_params"]
        for k in ("epoch", "accuracy"):
            if obj.get(k) is not None:
                try:
                    meta[k] = float(obj[k]) if k == "accuracy" else int(obj[k])
                except (TypeError, ValueError):
                    pass
    sd = strip_module_prefix(dict(sd))
    if prefix and not any(k.startswith(prefix) for k in sd):
        prefix = ""
    if not any(k.startswith(prefix + "blocks.") for k in sd):
        raise ValueError(f"no '{prefix}blocks.*' entries: not a ChannelVisionTransformer-family "
                         "state dict")
    out = {}
    for k, v in sd.items():
        t = torch.as_tensor(v).detach().to(torch.float32)
        if not _WRAPPER_KEYS & set(sd):
            if prefix and not k.startswith(prefix):
                continue
            k = k[len(prefix):]
        out[k] = t
    return out, meta


def merge_into_template(model: torch.nn.Module, imported: Dict[str, torch.Tensor]
                        ) -> Tuple[List[str], List[str]]:
    """Copy each imported tensor whose name and shape match a parameter or
    buffer of ``model`` into it, in place under ``no_grad`` (which bumps the
    tensor's version, so serving's weight casts are made again); the rest
    keep their fresh init. Returns ``(loaded, kept)``, the names of each."""
    loaded, kept = [], []
    live = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for name, t in live.items():
            src = imported.get(name)
            if src is None or tuple(src.shape) != tuple(t.shape):
                kept.append(name)
                continue
            t.copy_(src)
            loaded.append(name)
    return loaded, kept
