"""The port's data layer (``diverse_channel_vit_torch/data``) against the JAX
package's: for the same config and seed, every batch of every loader equals
the JAX one bit for bit (``np.array_equal`` on images, labels and the
``valid`` mask) over two epochs (``set_epoch``), for

- the synthetic dataset, ``easy`` and ``hard``, serially, on a thread pool
  and on spawned worker processes (against the JAX loader run serially);
- a JUMP-CP fixture (parquet index and plate maps, per-cell ``.npy``
  crops): the host-augmented train split, the raw crops of the
  ``device_augment`` path, valid and test;
- a So2Sat fixture (three h5 files): train, valid and the three test
  channel subsets;

each eval loader padding its last batch (``pad_last``) with a ``valid``
mask; and ``get_classes`` (CIFAR's without a tree: the fallback
vocabulary). CHAMMI's loaders are held in tests/test_torch_chammi_data.py,
CIFAR's in tests/test_torch_cifar.py.
"""

import pickle

import numpy as np
import pandas as pd
import pytest

from diverse_channel_vit_tpu.config import load_config as jload_config
from diverse_channel_vit_tpu.data import loaders as jloaders
from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.data import loaders


def _loader_list(tr, va, te):
    out = [("train", tr)]
    if va is not None:
        out.append(("valid", va))
    tests = te if isinstance(te, dict) else {"test": te}
    return out + sorted(tests.items())


def _assert_same_batches(name, overrides, chunk, seed=7, jax_overrides=None):
    """Both packages' loaders for one config (``jax_overrides`` for the JAX
    side where given): equal lengths, and equal batches over epochs 1 and
    2. Returns the port's loaders."""
    got = loaders.get_train_val_test_loaders(load_config(name, overrides), chunk, seed)
    want = jloaders.get_train_val_test_loaders(
        jload_config(name, overrides if jax_overrides is None else jax_overrides), chunk, seed)
    got, want = _loader_list(*got), _loader_list(*want)
    assert [s for s, _ in got] == [s for s, _ in want]
    n_batches = 0
    for (split, a), (_, b) in zip(got, want):
        assert len(a) == len(b), split
        for epoch in (1, 2):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            ba, bb = list(a), list(b)
            assert len(ba) == len(bb) == len(a), (split, epoch)
            for x, y in zip(ba, bb):
                assert sorted(x) == sorted(y)
                for key in x:
                    assert x[key].dtype == y[key].dtype, (split, key)
                    assert np.array_equal(x[key], y[key]), (split, epoch, key)
                n_batches += 1
    for _, ld in got:
        ld.close()
    for _, ld in want:
        ld.close()
    assert n_batches > 0
    return dict(got)


SYNTH = ["dataset.num_train_samples=40", "dataset.num_eval_samples=21", "train.batch_size=8",
         "eval.batch_size=8"]


@pytest.mark.parametrize("extra", [
    ["hardware.num_workers=0"],
    ["hardware.num_workers=2", "++dataset.difficulty=hard", "++dataset.hard_patch=8"],
    ["hardware.num_workers=2", "hardware.worker_processes=True"],
], ids=["easy-serial", "hard-threads", "easy-processes"])
def test_synthetic_batches_equal_jax(extra):
    # the JAX side loads serially: its batches do not depend on the worker
    # mode, and its spawned workers would each import JAX
    lds = _assert_same_batches("synthetic_cfg", SYNTH + extra, "synthetic",
                               jax_overrides=SYNTH + [e for e in extra if "hardware" not in e])
    last = list(lds["valid"])[-1]  # 21 = 2 * 8 + 5: the last batch is padded
    assert last["valid"].tolist() == [True] * 5 + [False] * 3
    assert np.array_equal(last["image"][5:], np.repeat(last["image"][4:5], 3, axis=0))


@pytest.fixture(scope="module")
def jumpcp_root(tmp_path_factory):
    """The fixture layout of tests/test_regular_e2e.py: 40 cells, 8 x 64 x 64
    crops, 3 labelled wells."""
    root = tmp_path_factory.mktemp("jumpcp")
    (root / "jumpcp" / "platemap_and_metadata").mkdir(parents=True)
    (root / "imgs").mkdir()
    rng = np.random.default_rng(0)
    wells = [f"A{j:02d}" for j in range(1, 9)]
    protos = rng.normal(0, 1, size=(3, 8, 1, 1))
    paths, locs = [], []
    for i in range(40):
        img = protos[i % 3] + rng.normal(0, 0.3, (8, 64, 64))
        np.save(root / f"imgs/c{i}.npy", img.astype(np.float32))
        paths.append(f"s3://insitro-research-2023-context-vit/imgs/c{i}.npy")
        locs.append(wells[i % 4])  # the fourth well is unlabelled: filtered out
    pd.DataFrame({"path": paths, "ID": range(40), "well_loc": locs}).to_parquet(
        root / "jumpcp" / "BR00116991.pq")
    pm = root / "jumpcp" / "platemap_and_metadata"
    for pert, col in [("compound", "target"), ("crispr", "gene"), ("orf", "gene")]:
        pd.DataFrame({"broad_sample": [f"s{k}" for k in range(3)],
                      "well_position": wells[:3]}).to_parquet(
            pm / f"JUMP-Target-1_{pert}_platemap.tsv")
        pd.DataFrame({"broad_sample": [f"s{k}" for k in range(3)],
                      col: [f"t{k}" for k in range(3)]}).to_parquet(
            pm / f"JUMP-Target-1_{pert}_metadata.tsv")
    return str(root) + "/"


@pytest.mark.parametrize("device_augment", [False, True])
def test_jumpcp_batches_equal_jax(jumpcp_root, device_augment):
    lds = _assert_same_batches("jump_cp_cfg", [
        f"++dataset.root_dir={jumpcp_root}", "++dataset.img_size=32", "train.batch_size=4",
        "eval.batch_size=4", "hardware.num_workers=0",
        f"++train.device_augment={device_augment}"], "jump_cp")
    assert lds["train"].dataset.device_augment == device_augment
    img = next(iter(lds["train"]))["image"]
    assert img.shape == ((4, 8, 64, 64) if device_augment else (4, 8, 32, 32))


@pytest.fixture(scope="module")
def so2sat_root(tmp_path_factory):
    import h5py

    root = tmp_path_factory.mktemp("so2sat")
    rng = np.random.default_rng(0)
    for split, n in [("training.h5", 24), ("validation.h5", 10), ("testing.h5", 9)]:
        with h5py.File(root / split, "w") as f:
            labels = rng.integers(0, 17, n)
            full = rng.normal(0, 0.5, (n, 32, 32, 18))
            f["sen1"] = full[..., :8].astype(np.float32)
            f["sen2"] = full[..., 8:].astype(np.float32)
            onehot = np.zeros((n, 17), np.uint8)
            onehot[np.arange(n), labels] = 1
            f["label"] = onehot
    return str(root)


def test_so2sat_batches_equal_jax(so2sat_root):
    lds = _assert_same_batches("so2sat_city_cfg", [
        f"++dataset.root_dir={so2sat_root}", "train.batch_size=8", "eval.batch_size=4",
        "hardware.num_workers=2"], "so2sat_city")
    assert sorted(lds) == ["test_1", "test_2", "test_full", "train", "valid"]
    assert next(iter(lds["test_2"]))["image"].shape == (4, 10, 32, 32)


@pytest.mark.parametrize("dataset", ["so2sat_city", "jump_cp", "synthetic", "Allen", "HPA", "CP",
                                     "morphem70k", "cifar10", "cifar100"])
def test_get_classes_equal_jax(dataset):
    kw = dict(file_name="morphem70k_v2.csv")
    assert loaders.get_classes(dataset, **kw) == jloaders.get_classes(dataset, **kw)


@pytest.mark.parametrize("name", ["morphem70k", "cifar10", "cifar100"])
def test_formerly_refused_datasets_build_as_jax(name, tmp_path):
    """CHAMMI's split builds since the CHAMMI port, CIFAR's since the CIFAR
    port (each raised before): a chunk's train and eval datasets equal the
    JAX package's, example for example (tests/test_torch_chammi_data.py and
    tests/test_torch_cifar.py hold the loaders). CIFAR reads the pickle
    fixture of ``make_cifar_fixture`` (cifar100 as the cifar-100-python
    layout of the same arrays) through a recomposed channel list."""
    import os
    import shutil
    import sys

    if name == "morphem70k":
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        from scripts.make_chammi_fixture import main as make_fixture

        make_fixture(str(tmp_path), n=8, img=32)
        config, chunk, sizes = "chammi_cfg", "HPA", (4, 8)
        over = [f"++dataset.root_dir={tmp_path}", "++dataset.img_size=24"]
    else:
        from diverse_channel_vit_torch.scripts.make_cifar_fixture import main as make_fixture

        make_fixture(str(tmp_path), n_per_batch=2, n_test=3)
        config, chunk, sizes = "cifar10_cfg", [2, 0, 1], (10, 3)
        over = [f"++dataset.root_dir={tmp_path}", f"++dataset.name={name}",
                "++dataset.in_channel_names=[red,avg_green_blue,zero]"]
        if name == "cifar100":  # one train and one test pickle, fine labels
            base = tmp_path / "cifar-10-batches-py"
            new = tmp_path / "cifar-100-python"
            new.mkdir()
            for split, files in (("train", [f"data_batch_{i}" for i in range(1, 6)]),
                                 ("test", ["test_batch"])):
                data, labels = [], []
                for f in files:
                    with open(base / f, "rb") as fh:
                        d = pickle.load(fh)
                    data.append(d[b"data"])
                    labels += d[b"labels"]
                with open(new / split, "wb") as fh:
                    pickle.dump({b"data": np.concatenate(data), b"fine_labels": labels}, fh)
            shutil.rmtree(base)
    for is_train in (True, False):
        args = (name, load_config(config, over).dataset, chunk, "train", is_train, 0)
        ds = loaders._build_split(*args)
        jds = jloaders._build_split(args[0], jload_config(config, over).dataset, *args[2:])
        assert len(ds) == len(jds) == sizes[0 if is_train else 1]
        for i in range(len(ds)):
            a = ds.get_example(i, rng=np.random.default_rng(i))
            b = jds.get_example(i, rng=np.random.default_rng(i))
            assert a["label"] == b["label"] and np.array_equal(a["image"], b["image"])


def test_prefetch_raises_the_producers_error_and_stops_early():
    def bad():
        yield 1
        raise OSError("disk gone")

    it = loaders.prefetch(bad())
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    it = loaders.prefetch(iter(range(100)), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()  # the producer thread stops instead of blocking on a full queue
