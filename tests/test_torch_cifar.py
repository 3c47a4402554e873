"""The port's CIFAR data layer and Trainer (``diverse_channel_vit_torch/data/cifar.py``,
``data/transforms.get_channel``) against the JAX package's, on the CPU, on a
pickle fixture that ``diverse_channel_vit_torch.scripts.make_cifar_fixture``
writes (5 train batches of 8 images, 16 test images; nothing is
downloaded).

- Batches: for ``cifar10_cfg`` as composed, the full-RGB chunk and a chunk
  of recompositions (``avg_red_green``, ``zero``, ``blue``) with the
  reference's split json present (a subset of the train and test indices),
  every batch of every loader equals the JAX loader's bit for bit over two
  epochs (images, labels, the ``valid`` mask of the padded eval batch).
- ``get_classes`` for cifar10 (the fixture's ``batches.meta``) and cifar100
  (no tree: the fallback vocabulary) equals JAX's; ``get_channel`` equals
  JAX's for every channel spec on seeded RGB batches.
- The Trainer: ``cifar10_cfg`` cut to the ``test`` preset (depth 2, D = 64),
  f32, the XLA route on the JAX side, the JUMP-CP optimizer (AdamW, eps
  1e-6) at lr 2e-3; the port's Trainer and the JAX Trainer from the same
  initial weights (the JAX ``create_train_state`` handed the port's, so no
  flax init is compiled) train the two steps of one epoch (40 images,
  batch 16, the last partial batch dropped). Step losses within rtol 1e-5
  at step 0 and 1e-4 after (as tests/test_torch_trainer.py holds the
  synthetic config), and the evals equal. ``main`` trains ``cifar10_cfg``
  on the fixture for one epoch on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu import trainer as jtrainer_module
from diverse_channel_vit_tpu.config import load_config as jload_config
from diverse_channel_vit_tpu.data import loaders as jloaders
from diverse_channel_vit_tpu.data import transforms as jtransforms
from diverse_channel_vit_tpu.models.import_torch import load_reference_checkpoint
from diverse_channel_vit_torch import main as port_main
from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.data import loaders, transforms
from diverse_channel_vit_torch.scripts.make_cifar_fixture import main as make_fixture
from diverse_channel_vit_torch.trainer import Trainer

CUTS = ["++model.pretrained_model_name=test", "train.batch_size=16", "eval.batch_size=12",
        "hardware.num_workers=0", "train.num_epochs=1"]
PARITY = CUTS + ["hardware.mesh.data=1", "model.attention_impl=xla", "train.dtype=float32",
                 "optimizer=adamw_jumpcp", "optimizer.params.lr=0.002"]
RECOMPOSED = ["++dataset.in_channel_names=[red,green,blue,avg_red_green,zero]",
              "++data_chunk.chunks=[{cifar10: {train: [3, 4, 2], test: [3, 2]}}]"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cifar"))
    return make_fixture(root)


@pytest.fixture(scope="module")
def split_root(tmp_path_factory):
    """The fixture with the reference's split json: a subset of each file's
    indices for the ``cifar10`` chunk."""
    root = make_fixture(str(tmp_path_factory.mktemp("cifar_split")), seed=1)
    os.makedirs(os.path.join(root, "split"))
    for split, idx in (("train", [0, 3, 5, 8, 13, 21, 22, 30, 31, 34, 38, 39]),
                       ("test", [1, 2, 4, 7, 11, 15])):
        with open(os.path.join(root, "split", f"cifar10_{split}.json"), "w") as f:
            json.dump({"cifar10_idx": idx, "other_idx": [0]}, f)
    return root


def _assert_same_batches(overrides, seed=7):
    got = loaders.get_train_val_test_loaders(load_config("cifar10_cfg", overrides), "cifar10",
                                             seed)
    want = jloaders.get_train_val_test_loaders(jload_config("cifar10_cfg", overrides), "cifar10",
                                               seed)
    assert got[1] is None and want[1] is None  # no valid split in the chunk
    n_batches = 0
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        assert len(a) == len(b) > 0
        for epoch in (1, 2):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            ba, bb = list(a), list(b)
            assert len(ba) == len(bb) == len(a)
            for x, y in zip(ba, bb):
                assert sorted(x) == sorted(y)
                for key in x:
                    assert x[key].dtype == y[key].dtype, key
                    assert np.array_equal(x[key], y[key]), (epoch, key)
                n_batches += 1
    for ld in (*got[::2], *want[::2]):
        ld.close()
    return got, n_batches


@pytest.mark.parametrize("recomposed", [False, True], ids=["rgb", "recomposed"])
def test_cifar_batches_equal_jax(cifar_root, recomposed):
    over = [f"++dataset.root_dir={cifar_root}", "train.batch_size=16", "eval.batch_size=12"]
    (train, _, test), n = _assert_same_batches(over + (RECOMPOSED if recomposed else []))
    assert len(train) == 2 and len(test) == 2 and n == 8  # 40 images; 16 padded to 24
    assert next(iter(train))["image"].shape == (16, 3, 32, 32)
    assert next(iter(test))["image"].shape == (12, 3 if not recomposed else 2, 32, 32)


def test_cifar_split_json_batches_equal_jax(split_root):
    over = [f"++dataset.root_dir={split_root}", "train.batch_size=4", "eval.batch_size=4"]
    (train, _, test), _ = _assert_same_batches(over + RECOMPOSED)
    assert len(train.dataset) == 12 and len(test.dataset) == 6


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
def test_cifar_get_classes_equal_jax(cifar_root, dataset):
    got = loaders.get_classes(dataset, root_dir=cifar_root)
    assert got == jloaders.get_classes(dataset, root_dir=cifar_root)
    assert len(got[0]) == (10 if dataset == "cifar10" else 100)


def test_get_channel_equals_jax():
    x = np.random.default_rng(3).normal(size=(4, 3, 8, 8)).astype(np.float32)
    for spec in (["red", "green", "blue"], ["blue", "green", "red"], ["green"],
                 ["avg_red_green", "zero"], ["avg_red_green_blue", "blue", "zero"]):
        got, want = (m.get_channel("cifar10", spec, x) for m in (transforms, jtransforms))
        assert got.dtype == want.dtype and np.array_equal(got, want), spec
    for m in (transforms, jtransforms):
        with pytest.raises(ValueError):
            m.get_channel("cifar100", ["max_red_green"], x)


@pytest.fixture(scope="module")
def trainer_pair(cifar_root, tmp_path_factory):
    """The port's Trainer, then the JAX Trainer of the same config started
    from the port's initial weights; one epoch each, each step's loss
    recorded."""
    over = PARITY + [f"++dataset.root_dir={cifar_root}",
                     f"train.checkpoints={tmp_path_factory.mktemp('cifar_run')}"]
    pt = Trainer(load_config("cifar10_cfg", over), device="cpu")
    params = load_reference_checkpoint(
        {k: v.detach().numpy().copy() for k, v in pt.model.state_dict().items()})[0]
    real = jtrainer_module.create_train_state
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer_module, "create_train_state",
                   lambda model, tx, **kw: real(model, tx, **{**kw, "params": params}))
        jt = jtrainer_module.Trainer(jload_config("cifar10_cfg", over))
    runs = {}
    for name, t in (("jax", jt), ("port", pt)):
        losses = []
        make = t._get_train_step

        def get(*a, make=make, losses=losses, **kw):
            step = make(*a, **kw)

            def recorded(state, batch, *rest):
                state, m = step(state, batch, *rest)
                losses.append(float(m["loss"]))
                return state, m

            return recorded

        t._get_train_step = get
        t.train_one_epoch(1)
        runs[name] = dict(losses=losses, eval=t.eval_regular(1))
    return pt, runs


def test_cifar_trainer_steps_match_jax(trainer_pair):
    pt, runs = trainer_pair
    lj, lp = runs["jax"]["losses"], runs["port"]["losses"]
    assert len(lp) == len(lj) == 2 == pt.updates_per_epoch
    np.testing.assert_allclose(lp[0], lj[0], rtol=1e-5)
    np.testing.assert_allclose(lp[1:], lj[1:], rtol=1e-4)
    assert pt.num_classes == 10 and pt.model.classifer_head is not None


def test_cifar_trainer_eval_equals_jax(trainer_pair):
    _, runs = trainer_pair
    assert runs["port"]["eval"] == runs["jax"]["eval"]
    assert set(runs["port"]["eval"]) == {"test/accuracy", "accuracy"}


def test_main_trains_cifar10_from_local_pickles(cifar_root, tmp_path):
    best = port_main.main(["-cn", "cifar10_cfg", *CUTS, f"++dataset.root_dir={cifar_root}",
                           "eval.skip_eval_first_epoch=True", "train.save_model=none",
                           f"train.checkpoints={tmp_path}", "++hardware.device=cpu"])
    assert 0.0 <= best <= 1.0
