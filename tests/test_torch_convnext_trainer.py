"""The port's Trainer on ConvNeXt models against the JAX package's Trainer,
on the CPU, on scripts/make_chammi_fixture.py's tree (32², 24 images a
chunk, the 8-channel ``morphem70k_v2`` mapper).

- Two CHAMMI steps each, f32, AdamW at eps 1e-6: ``convnext_base`` on
  ``train.training_chunks=Allen`` (its stem takes the first chunk's 3
  channels, as JAX's does, so it trains on Allen alone) and
  ``shared_convnext`` on every chunk, the trunk cut to depths (1, 1, 1, 1)
  (``convnext_variants.TINY`` set in both packages; the real depth is held
  in tests/test_torch_convnext.py). Both
  Trainers are built from one config; the JAX Trainer's
  ``create_train_state`` is handed a parameter tree drawn by numpy (no flax
  init compiled), which the port's model loads through
  ``models.export.params_from_jax``. The same two mixed batches (the port's
  loader's, equal to JAX's) go through each Trainer's
  ``_train_one_batch_morphem``: the per-chunk losses within rtol 1e-5 and
  the summed gradient's norm within 1e-4, every parameter within lr / 10 of
  JAX's after the two updates.
- Then the CHAMMI eval of the trained ``shared_convnext`` with
  ``eval.umap`` on (each test chunk through its own stem): the embedding
  figures of the three datasets are written beside the kNN results.

XLA's optimisation passes are off while the JAX side compiles (a compile
cost, not a numerical one).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diverse_channel_vit_tpu.models.convnext_variants as jcv
from diverse_channel_vit_tpu import trainer as jtrainer_module
from diverse_channel_vit_tpu.config import load_config as jload_config
import diverse_channel_vit_torch.models.convnext_variants as cv
from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.trainer import Trainer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CUT = dict(depths=(1, 1, 1, 1), dims=(96, 192, 384, 768))
LR = 1e-3
BASE = ["++dataset.img_size=32", "train.dtype=float32", "train.batch_size=6",
        "hardware.num_workers=0", "optimizer.params.eps=1e-6", f"optimizer.params.lr={LR}",
        "scheduler=none", "train.num_epochs=1", "hardware.mesh.data=1"]


@pytest.fixture(autouse=True, scope="module")
def _fast_compiles_two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", opt)
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from scripts.make_chammi_fixture import main as make_fixture

    root = tmp_path_factory.mktemp("chammi")
    make_fixture(str(root), n=24, img=32)
    return str(root)


def _fill(shapes, seed: int):
    """LayerNorm scales 1 + 0.1 N(0, 1), layer scales 0.3 + 0.05 N(0, 1),
    biases 0.05 N(0, 1), the rest N(0, 1) at min(0.5, fan^-1/2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "gamma":
            return (0.3 + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        std = 0.05 if "bias" in name else min(0.5, fan ** -0.5)
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(over):
    """The port's Trainer and JAX's from one config, on one parameter tree."""
    held = {}
    real = jtrainer_module.create_train_state

    def seeded(model, tx, **kw):
        shapes = jax.eval_shape(
            lambda x: model.init({"params": jax.random.key(0)}, x, kw["sample_channel_ids"],
                                 train=False), kw["sample_input"])
        held["params"] = _fill(shapes["params"], seed=2)
        return real(model, tx, **{**kw, "params": held["params"]})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer_module, "create_train_state", seeded)
        jt = jtrainer_module.Trainer(jload_config("chammi_cfg", over))
    pt = Trainer(load_config("chammi_cfg", over), device="cpu")
    pt.model.load_state_dict(params_from_jax(held["params"]), strict=True)
    return pt, jt


@pytest.mark.parametrize("name,extra", [
    ("convnext_base", ["train.training_chunks=Allen"]),
    ("shared_convnext", []),
])
def test_two_chammi_steps_match_jax(name, extra, root, tmp_path, monkeypatch):
    monkeypatch.setattr(jcv, "TINY", CUT)
    monkeypatch.setattr(cv, "TINY", CUT)
    over = BASE + [f"model={name}", f"++dataset.root_dir={root}", f"++eval.root_dir={root}",
                   f"train.checkpoints={tmp_path}", "eval.umap=True",
                   f"eval.feature_dir={tmp_path}/feats/{{FOLDER_NAME}}",
                   f"eval.dest_dir={tmp_path}/results/{{FOLDER_NAME}}", *extra]
    pt, jt = _pair(over)
    depth = sum(len(s.blocks) for s in pt.model.feature_extractor.trunk.stages)
    assert depth == 4
    loader = iter(pt.train_loader)
    batches = [next(loader) for _ in range(2)]
    chunks = set()
    for batch in batches:
        chunks |= set(batch)
        got = pt._train_one_batch_morphem(pt._to_device(batch))
        want = jt._train_one_batch_morphem(jt._to_device(batch))
        assert set(got) == set(want)
        for key, v in want.items():
            np.testing.assert_allclose(got[key], v, rtol=1e-4 if key == "grad_norm" else 1e-5,
                                       err_msg=key)
    assert chunks == ({"Allen"} if extra else {"Allen", "HPA", "CP"})
    final = params_from_jax(jax.device_get(jt.state.params))
    for k, v in pt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), rtol=0, atol=LR / 10, err_msg=k)
    if extra:
        return
    # the CHAMMI eval of the trained model, each test chunk through its own
    # stem, with the embedding figures
    res = pt.evaluate_model(1)
    assert 0.0 <= res["accuracy"] <= 1.0
    written = sorted(os.listdir(tmp_path / "results" / f"epoch1_seed{pt.seed}"))
    for dataset in ("Allen", "HPA", "CP"):
        assert f"{dataset}_pca.png" in written, written
