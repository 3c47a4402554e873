"""Dataset registry: name -> Dataset class (per-chunk constructor); the
port's own copy of the JAX package's ``data/registry.py``."""

from __future__ import annotations

from typing import Callable, Dict

DATASET_REGISTRY: Dict[str, Callable] = {}


def register_dataset(name: str):
    """Class decorator: register a dataset under its config name."""
    def wrap(cls):
        DATASET_REGISTRY[name] = cls
        return cls

    return wrap
