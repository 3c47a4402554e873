"""The port's CHAMMI data layer against the JAX package's, on the CPU.

- ``fold_channels`` on uint8 and uint16 tapes, bit for bit.
- The native fused fold + crop + resize + normalize: the port's build equals
  the JAX package's build bit for bit (same source, same ``-march=native``
  flags on the same host), and the numpy plain version within 2e-5, as
  tests/test_native.py holds the JAX op; a missing compiler raises, where
  the JAX package falls back to numpy. Skipped only where no ``c++`` exists.
- ``SingleCellDataset`` train and eval examples equal JAX's bit for bit, at
  ``tps_prob`` 0 (the native path) and 1 (the TPS path), read from the TIFFs
  and from the packed blob (which JAX reads from the TIFFs).
- ``MixedChunkLoader`` (through ``make_random_instance_train_loader``): the
  quotas and two epochs of batches equal JAX's, for the 8- and 12-channel
  datasets and the ``training_chunks`` subset Allen_HPA, and the chunks'
  eval loaders too.

(``build_mapper`` is held against JAX's in tests/test_torch_trainer.py,
which imports the JAX Trainer anyway.)

The fixture is scripts/make_chammi_fixture.py's tree at 32², 24 images a
chunk.
"""

import os
import shutil
import sys

import numpy as np
import pytest

from diverse_channel_vit_tpu.config import load_config as jload_config
from diverse_channel_vit_tpu.data import loaders as jloaders
from diverse_channel_vit_tpu.data import morphem70k as jm
from diverse_channel_vit_torch import native, trainer
from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.data import loaders, morphem70k as pm
from diverse_channel_vit_torch.data.normalization import get_mean_std_dataset

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HAVE_CXX = shutil.which("c++") is not None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from scripts.make_chammi_fixture import main as make_fixture

    root = tmp_path_factory.mktemp("chammi")
    make_fixture(str(root), n=24, img=32)
    return str(root)


@pytest.fixture(scope="module")
def packed_root(root, tmp_path_factory):
    from scripts.pack_chammi import main as pack

    packed = str(tmp_path_factory.mktemp("chammi_packed") / "root")
    shutil.copytree(root, packed)
    pack(packed)
    return packed


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_fold_channels_equal_jax(dtype):
    rng = np.random.default_rng(0)
    tape = rng.integers(0, np.iinfo(dtype).max, size=(9, 7 * 4)).astype(dtype)
    got, want = pm.fold_channels(tape, 7), jm.fold_channels(tape, 7)
    assert got.shape == (4, 9, 7) and got.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.skipif(not HAVE_CXX, reason="no C++ compiler on this host")
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_native_op_equals_jax_build_and_plain_version(dtype):
    from diverse_channel_vit_tpu.data.transforms import _bilinear_resize
    from diverse_channel_vit_tpu.native import fold_crop_resize_normalize as jfold
    from diverse_channel_vit_tpu.native import get_lib

    assert get_lib() is not None  # the JAX build, on the same compiler
    rng = np.random.default_rng(1)
    h, w, c = 37, 29, 3
    tape = rng.integers(0, np.iinfo(dtype).max, size=(h, w * c)).astype(dtype)
    mean = rng.random(c).astype(np.float32)
    std = (rng.random(c) + 0.5).astype(np.float32)
    for crop, out_hw in [((5, 3, 25, 21), 16), ((0, 0, 37, 29), 40), ((10, 2, 7, 26), 24)]:
        got = native.fold_crop_resize_normalize(tape, w, crop, out_hw, mean, std)
        assert got.shape == (c, out_hw, out_hw) and got.dtype == np.float32
        assert np.array_equal(got, jfold(tape, w, crop, out_hw, mean, std))
        top, left, ch_, cw = crop
        plain = pm._bilinear_resize(pm.fold_channels(tape, w)[:, top:top + ch_, left:left + cw],
                                    out_hw, out_hw)
        plain = (plain - mean[:, None, None]) / std[:, None, None]
        np.testing.assert_allclose(got, plain, atol=2e-5, rtol=0)
        jplain = _bilinear_resize(jm.fold_channels(tape, w)[:, top:top + ch_, left:left + cw],
                                  out_hw, out_hw)
        assert np.array_equal(plain, (jplain - mean[:, None, None]) / std[:, None, None])


def test_native_build_raises_without_a_compiler(monkeypatch, tmp_path):
    """No fallback: where the compiler is missing, the op raises naming it."""
    monkeypatch.setattr(native, "_fn", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    tape = np.zeros((4, 12), np.uint8)
    with pytest.raises(RuntimeError, match="'c\\+\\+' not found"):
        native.fold_crop_resize_normalize(tape, 4, (0, 0, 4, 4), 4, [0.0] * 3, [1.0] * 3)
    with pytest.raises(TypeError, match="uint8 or uint16"):
        native.fold_crop_resize_normalize(tape.astype(np.float32), 4, (0, 0, 4, 4), 4,
                                          [0.0] * 3, [1.0] * 3)


def _examples(ds, seed=5):
    return [ds.get_example(i, rng=np.random.default_rng((seed, 1, i))) for i in range(len(ds))]


@pytest.mark.parametrize("tps_prob", [0.0, 1.0])
@pytest.mark.parametrize("packed", [False, True])
def test_single_cell_examples_equal_jax(root, packed_root, tps_prob, packed):
    if tps_prob == 0.0 and not HAVE_CXX:
        pytest.skip("the native path needs a C++ compiler")
    for chunk in ("Allen", "HPA", "CP"):
        for is_train in (True, False):
            kw = dict(file_name="morphem70k_v2.csv", chunk_name=chunk, is_train=is_train,
                      img_size=24, tps_prob=tps_prob)
            ds = pm.SingleCellDataset(packed_root if packed else root, **kw)
            assert (ds._pack is not None) == packed
            jds = jm.SingleCellDataset(root, **kw)
            assert len(ds) == len(jds) == (12 if is_train else 24)
            for got, want in zip(_examples(ds), _examples(jds)):
                assert got["label"] == want["label"]
                assert got["image"].shape == (len(ds.mean_stds[chunk][0]), 24, 24)
                assert np.array_equal(got["image"], want["image"]), (chunk, is_train)


def test_plain_train_view_is_the_jax_numpy_path(root):
    """The native op's plain version in the train view equals the JAX
    package's numpy path (the one it takes without a toolchain)."""
    ds = pm.SingleCellDataset(root, file_name="morphem70k_v2.csv", chunk_name="CP",
                              is_train=True, img_size=24)
    mean, std = get_mean_std_dataset("morphem70k")["CP"]
    tape = ds._read(0)
    crop = (2, 3, 27, 28)
    got = pm.plain_train_view(np.random.default_rng(3), tape, 32, crop, 24, mean, std)
    from diverse_channel_vit_tpu.data.normalization import normalize_chw
    from diverse_channel_vit_tpu.data.transforms import _bilinear_resize, hflip

    out = _bilinear_resize(jm.fold_channels(tape, 32)[:, 2:29, 3:31], 24, 24)
    flip = np.random.default_rng(3).random() < 0.5
    want = normalize_chw(hflip(out) if flip else out, mean, std)
    assert np.array_equal(got, want)


MIXED = [
    ("morphem70k_v2", ["train.tps_prob=0.5"], None),
    ("morphem70k_v2_12channels", [], None),
    ("morphem70k_v2_12channels", ["train.training_chunks=Allen_HPA"], ["Allen", "HPA"]),
]


@pytest.mark.parametrize("dataset,over,chunks", MIXED,
                         ids=["v2-tps", "v2_12channels", "v2_12channels-Allen_HPA"])
def test_mixed_chunk_loader_equals_jax(root, dataset, over, chunks):
    if not HAVE_CXX:
        pytest.skip("the native path needs a C++ compiler")
    args = [f"dataset={dataset}", f"++dataset.root_dir={root}", "++dataset.img_size=24",
            "train.batch_size=12", "eval.batch_size=10", "hardware.num_workers=2", *over]
    cfg, jcfg = load_config("chammi_cfg", args), jload_config("chammi_cfg", args)
    assert trainer.training_chunk_list(cfg) == chunks
    got = loaders.make_random_instance_train_loader(cfg, 11, training_chunks=chunks)
    want = jloaders.make_random_instance_train_loader(jcfg, 11, training_chunks=chunks)
    assert got.quotas == want.quotas and sum(got.quotas.values()) == 12
    assert list(got.quotas) == (chunks or ["Allen", "HPA", "CP"])
    assert len(got) == len(want) > 0
    for epoch in (1, 2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        a, b = list(got), list(want)
        assert len(a) == len(b) == len(got)
        for x, y in zip(a, b):
            assert list(x) == list(y)
            for chunk in x:
                assert sorted(x[chunk]) == sorted(y[chunk]) == ["image", "label", "valid"]
                for key in x[chunk]:
                    assert np.array_equal(x[chunk][key], y[chunk][key]), (epoch, chunk, key)
    labels = np.concatenate([b["label"] for b in a[0].values()])
    assert labels.min() >= 0 and labels.max() < (10 if chunks else 14)
    got.close()
    # each chunk's eval loader: every row of the chunk, the last batch padded
    for chunk in chunks or ["CP"]:
        _, _, te = loaders.get_train_val_test_loaders(cfg, chunk, 11, with_train=False)
        _, _, jte = jloaders.get_train_val_test_loaders(jcfg, chunk, 11)
        assert len(te.dataset) == 24
        for x, y in zip(te, jte):
            for key in ("image", "label", "valid"):
                assert np.array_equal(x[key], y[key]), (chunk, key)
