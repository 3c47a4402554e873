"""The port's config engine and tree (``diverse_channel_vit_torch/config``)
against the JAX package's.

The port keeps its own copy of the YAML tree; it equals the JAX tree but
for ``hardware.device`` (``cuda`` in the port, ``tpu`` in JAX), which every
comparison below maps back before comparing. Composed configs must be equal
as dicts (``to_dict()``) for every top-level config, for the recipes of
``train_scripts.sh`` (group swaps and ``++`` force-adds) and for overrides of
each value type.
"""

import os
import pickle
import shlex

import pytest
import yaml

from diverse_channel_vit_tpu.config import loader as jloader
from diverse_channel_vit_torch.config import loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = ["chammi_cfg", "cifar10_cfg", "jump_cp_cfg", "so2sat_city_cfg", "synthetic_cfg"]


def _as_jax(d: dict) -> dict:
    hw = d.get("hardware") or {}
    if hw.get("device") == "cuda":
        hw["device"] = "tpu"
    return d


def _recipes():
    """(config name, overrides) of each ``python main.py`` line of
    train_scripts.sh, commented examples included."""
    out = []
    with open(os.path.join(REPO, "train_scripts.sh")) as f:
        for line in f:
            line = line.lstrip("# ").strip()
            if not line.startswith("python main.py") or "..." in line:
                continue
            toks = shlex.split(line)[2:]
            name = toks[toks.index("-cn") + 1]
            rest = [t for i, t in enumerate(toks)
                    if t not in ("-m", "-cn") and (i == 0 or toks[i - 1] != "-cn")]
            out.append((name, rest))
    return out


def test_config_dir_is_the_ports_own():
    port = os.path.join(REPO, "diverse_channel_vit_torch")
    assert os.path.commonpath([loader.CONFIG_DIR, port]) == port
    assert os.path.isdir(loader.CONFIG_DIR)


def test_tree_files_equal_jax_but_the_device():
    """Every YAML file of the port's tree parses to the JAX file's content,
    hardware devices mapped back, and no file is missing on either side."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs if f.endswith(".yaml"))

    assert files(loader.CONFIG_DIR) == files(jloader.CONFIG_DIR)
    assert len(files(loader.CONFIG_DIR)) == 47
    for rel in files(loader.CONFIG_DIR):
        with open(os.path.join(loader.CONFIG_DIR, rel)) as f:
            got = yaml.safe_load(f) or {}
        with open(os.path.join(jloader.CONFIG_DIR, rel)) as f:
            want = yaml.safe_load(f) or {}
        if rel.startswith("hardware") and got.get("device") == "cuda":
            got["device"] = "tpu"
        assert got == want, rel


@pytest.mark.parametrize("name", TOP)
def test_top_level_configs_equal_jax(name):
    got = loader.load_config(name).to_dict()
    assert got["hardware"]["device"] == "cuda"
    assert _as_jax(got) == jloader.load_config(name).to_dict()


@pytest.mark.parametrize("recipe", range(len(_recipes())))
def test_train_scripts_recipes_equal_jax(recipe):
    name, overrides = _recipes()[recipe]
    got = loader.load_config(name, overrides).to_dict()
    want = jloader.load_config(name, overrides).to_dict()
    assert _as_jax(got) == want


def test_recipes_were_found():
    names = [n for n, _ in _recipes()]
    assert len(names) >= 6 and {"chammi_cfg", "jump_cp_cfg", "so2sat_city_cfg"} <= set(names)


@pytest.mark.parametrize("overrides", [
    ["model=dichavit", "hardware=cpu", "scheduler=none", "optimizer=adamw_jumpcp"],
    ["train.batch_size=16", "++model.gamma_s=0.5", "++optimizer.params.lr=4e-5",
     "++model.img_size=[32]", "++model.hcs_sampling=lowest_cosine_prob", "++train.debug=True",
     "++eval.batch_size=~", "++data_chunk.chunks=[{synthetic: {train: [0, 1], test: [0, 1]}}]",
     "tag=demo", "++new.nested.key=1.0e-6"],
])
def test_overrides_equal_jax(overrides):
    got = loader.load_config("synthetic_cfg", overrides).to_dict()
    assert _as_jax(got) == jloader.load_config("synthetic_cfg", overrides).to_dict()
    assert loader.parse_overrides(overrides) == jloader.parse_overrides(overrides)


def test_unknown_key_needs_force_and_missing_group_raises():
    with pytest.raises(KeyError, match=r"\+\+"):
        loader.load_config("synthetic_cfg", ["train.no_such_key=1"])
    with pytest.raises(FileNotFoundError):
        loader.load_config("synthetic_cfg", ["model=no_such_model"])


def test_config_pickles_and_reads_like_jax():
    cfg = loader.load_config("jump_cp_cfg", ["++model.gamma_s=0.5"])
    back = pickle.loads(pickle.dumps(cfg))
    assert back.to_dict() == cfg.to_dict()
    assert back.model.gamma_s == 0.5 and back.model.get("missing", 7) == 7
    with pytest.raises(AttributeError):
        back.model.no_such_key
