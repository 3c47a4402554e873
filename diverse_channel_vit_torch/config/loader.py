"""The attribute-accessible config that the model factories read.

The port's own copy of ``Config`` from the JAX package's
``config/loader.py``. The YAML composition engine around it (config groups,
Hydra-style overrides) waits for the trainer slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Config:
    """A nested attribute-accessible config (a lightweight DictConfig).

    - attribute and item access (``cfg.model.name`` / ``cfg["model"]["name"]``)
    - ``.get(key, default)`` like the reference's OmegaConf usage
    - missing attributes raise AttributeError (typo safety)
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self[k] = v

    def __setitem__(self, key: str, value: Any):
        if isinstance(value, dict):
            value = Config(value)
        self._data[key] = value

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def __getattr__(self, key: str) -> Any:
        # dunder/_data lookups must fail fast (copy and pickle probe them
        # before `_data` exists; recursing through self._data would loop)
        if key == "_data" or (key.startswith("__") and key.endswith("__")):
            raise AttributeError(key)
        try:
            return object.__getattribute__(self, "_data")[key]
        except KeyError as e:
            raise AttributeError(f"Config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any):
        self[key] = value

    def __repr__(self) -> str:
        return f"Config({self._data!r})"
