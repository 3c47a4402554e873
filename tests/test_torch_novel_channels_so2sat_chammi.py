"""The port's novel-channel evaluation against the JAX package's on the
CPU, continued from tests/test_torch_novel_channels.py (same cuts, same
weights rule: the port's Trainer trains an epoch, the JAX Trainer, built
from the port's initial weights, takes its trained ones):

- So2Sat: the recipe of ``train_scripts.sh:23`` (ChannelViT, zero, the
  subset sweep) on the So2Sat fixture of tests/test_torch_data.py (h5py):
  ``evaluate_model`` equal, keys ``test_1/zero``, ``test_2/zero``,
  ``test_full/zero``, ``valid``, the sweep over ``test_1``'s 8 channels and
  their 8 subsets of 7, and ``accuracy``.
- CHAMMI on a chunk subset: the recipe of ``train_scripts.sh:8`` with
  ``train.training_chunks=Allen_HPA`` and the strategies zero, avg_2 and
  replicate on the ``scripts/make_chammi_fixture.py`` fixture at 32²,
  patch 8: CP's features (all five of its channels novel) per strategy
  within rel 1e-4 of max|feature| of JAX's, different between zero and
  avg_2; a dynamic strategy raises on CP in both; ``evaluate_model``
  equal, keys ``{strategy}/...`` and ``accuracy`` the first strategy's.

torch runs on one thread here: the suite runs files side by side.
"""

import sys

import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.evaluation import morphem_eval as jmorphem_eval
from diverse_channel_vit_torch.evaluation import morphem_eval
from test_torch_data import so2sat_root  # noqa: F401  (a module fixture)
from test_torch_novel_channels import CUTS, LOGITS_REL, REPO, _pair, _recipe, _rel, _train_and_carry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_so2sat_recipe_eval_equals_jax(so2sat_root, tmp_path):  # noqa: F811
    name, over = _recipe(23)
    assert name == "so2sat_city_cfg" and "model=channelvit_adapt" in over
    pt, jt = _pair(name, over + CUTS + [f"++dataset.root_dir={so2sat_root}",
                                        "++train.batch_size=8", f"++train.checkpoints={tmp_path}"])
    _train_and_carry(pt, jt)
    got, want = pt.evaluate_model(1), jt.evaluate_model(1)
    assert set(got) == {"valid/accuracy", "test_1/zero/accuracy", "test_2/zero/accuracy",
                        "test_full/zero/accuracy", "accuracy", "subset_8/mean", "subset_8/std",
                        "subset_7/mean", "subset_7/std"}
    assert got == want


def test_chammi_subset_strategies_equal_jax(tmp_path):
    sys.path.insert(0, REPO)
    from scripts.make_chammi_fixture import main as make_fixture

    make_fixture(str(tmp_path), n=24, img=32)
    name, over = _recipe(8)
    assert name == "chammi_cfg"
    strategies = ["zero", "avg_2", "replicate"]
    pt, jt = _pair(name, over + CUTS + [
        "++train.training_chunks=Allen_HPA", f"++model.new_channel_inits=[{','.join(strategies)}]",
        "++model.patch_size=8", "++train.batch_size=12", f"++dataset.root_dir={tmp_path}",
        f"++eval.root_dir={tmp_path}", f"++eval.feature_dir={tmp_path}/feat/{{FOLDER_NAME}}",
        f"++eval.dest_dir={tmp_path}/res/{{FOLDER_NAME}}", f"++train.checkpoints={tmp_path}"])
    assert pt.num_classes == 10  # Allen's 6 and HPA's 4 classes
    _train_and_carry(pt, jt)
    feats = {}
    for s in strategies:
        got = morphem_eval.extract_features(pt, "CP", pt.test_loaders["CP"], s)
        want = jmorphem_eval.extract_features(jt, "CP", jt.test_loaders["CP"], s)
        assert got.shape == want.shape == (24, 64)
        assert _rel(got, want) <= LOGITS_REL, s
        feats[s] = got
    assert np.abs(feats["zero"] - feats["avg_2"]).max() > 1e-3
    for fn, t in ((morphem_eval.extract_features, pt), (jmorphem_eval.extract_features, jt)):
        with pytest.raises(ValueError, match="Invalid new_channel_init"):
            fn(t, "CP", t.test_loaders["CP"], "dynamic_input_corr_1")
    got, want = pt.evaluate_model(1), jt.evaluate_model(1)
    assert set(got) == set(want) and "zero/knn_cosine/chammi_score" in got
    assert got["accuracy"] == got["zero/accuracy"]
    assert got == want
