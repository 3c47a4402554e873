"""Config composition engine (the port's own copy of the JAX package's
``config/loader.py``).

Mirrors the *surface* of the reference's Hydra setup (``config.py``,
``configs/**``, ``main.py:13-14``) without depending on Hydra/omegaconf:

- top-level configs (``chammi_cfg.yaml`` / ``jump_cp_cfg.yaml`` /
  ``so2sat_city_cfg.yaml`` / ``synthetic_cfg.yaml`` / ``cifar10_cfg.yaml``)
  name a default selection per config group
- config groups live in subdirectories (``model/``, ``train/``, ...)
- CLI overrides work like Hydra: ``model=dichavit`` swaps a group,
  ``train.batch_size=64`` sets a key, ``++model.gamma_s=0.5`` force-adds
  a key that is not in the schema (the reference recipes in
  ``train_scripts.sh`` rely on ``++`` heavily)
- a top-level ``overrides:`` mapping applies dotted keys before the CLI's

The YAML files are the port's own tree (:data:`CONFIG_DIR`, under this
package); it equals the JAX package's but for ``hardware.device``, which is
``cuda``. PyYAML is imported where a file or value is parsed, never when
this module is imported.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .schema import SECTION_DEFAULTS

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

GROUPS = [
    "train",
    "model",
    "scheduler",
    "optimizer",
    "dataset",
    "data_chunk",
    "logging",
    "hardware",
    "eval",
    "attn_pooling",
]


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

    # process-pool loader workers receive dataset factories that close over
    # Config sections
    def __getstate__(self) -> Dict[str, Any]:
        return self.to_dict()

    def __setstate__(self, state: Dict[str, Any]):
        object.__setattr__(self, "_data", {})
        for k, v in state.items():
            self[k] = v

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, Config) else copy.deepcopy(v)
        return out

    def merge(self, other):
        items = other.items() if isinstance(other, (dict, Config)) else []
        for k, v in items:
            if isinstance(v, (dict, Config)) and isinstance(self._data.get(k), Config):
                self._data[k].merge(v)
            else:
                self[k] = v.to_dict() if isinstance(v, Config) else v

    def set_dotted(self, dotted: str, value: Any, force: bool = False):
        keys = dotted.split(".")
        node: Config = self
        for k in keys[:-1]:
            if k not in node or not isinstance(node.get(k), Config):
                if not force and k not in node:
                    raise KeyError(f"Unknown config path {dotted!r} (missing {k!r}); "
                                   "use ++ to force-add")
                node[k] = Config()
            node = node[k]
        if not force and keys[-1] not in node:
            raise KeyError(f"Unknown config key {dotted!r}; use ++{dotted}={value} to force-add")
        node[keys[-1]] = value

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"


def _parse_value(raw: str) -> Any:
    import yaml

    try:
        val = yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw
    # YAML 1.1 parses "4e-5" as a string (needs "4.0e-5"); accept it as a float
    if isinstance(val, str):
        try:
            return int(val)
        except ValueError:
            pass
        try:
            return float(val)
        except ValueError:
            pass
    return val


def parse_overrides(tokens: Iterable[str]) -> Tuple[Dict[str, str], List[Tuple[str, Any, bool]]]:
    """Split CLI tokens into group swaps and dotted key overrides.

    Returns (group_selections, [(dotted_key, value, force), ...]).
    """
    groups: Dict[str, str] = {}
    sets: List[Tuple[str, Any, bool]] = []
    for tok in tokens:
        if "=" not in tok:
            raise ValueError(f"Override {tok!r} must look like key=value")
        key, raw = tok.split("=", 1)
        force = key.startswith("++")
        key = key.lstrip("+")
        if key in GROUPS and "." not in key:
            groups[key] = raw
        else:
            sets.append((key, _parse_value(raw), force))
    return groups, sets


def _load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def load_config(
    config_name: str,
    overrides: Optional[Iterable[str]] = None,
    config_dir: Optional[str] = None,
) -> Config:
    """Compose a full config: top-level file + group defaults + CLI overrides."""
    config_dir = config_dir or CONFIG_DIR
    top = _load_yaml(os.path.join(config_dir, f"{config_name}.yaml"))

    selections: Dict[str, str] = dict(top.get("group_defaults", {}))
    group_overrides, sets = parse_overrides(overrides or [])
    selections.update(group_overrides)

    cfg = Config()
    for group in GROUPS:
        sel = selections.get(group)
        section = Config(copy.deepcopy(SECTION_DEFAULTS.get(group, {})))
        if sel in (None, "~", "None", "none") and group == "attn_pooling":
            cfg[group] = None
            continue
        if sel is not None:
            group_path = os.path.join(config_dir, group, f"{sel}.yaml")
            if not os.path.exists(group_path):
                raise FileNotFoundError(f"No config {group}/{sel} at {group_path}")
            section.merge(_load_yaml(group_path))
        cfg[group] = section

    for k, v in top.items():
        if k in ("group_defaults", "overrides"):
            continue
        cfg[k] = v
    if "tag" not in cfg:
        cfg["tag"] = None

    # top-level dotted overrides (like Hydra's per-config sweeper params):
    # applied before the CLI's
    for dotted, value in (top.get("overrides") or {}).items():
        cfg.set_dotted(dotted, value, force=True)

    for dotted, value, force in sets:
        cfg.set_dotted(dotted, value, force=force)
    return cfg
