"""The other two JUMP-CP and So2Sat recipes of ``train_scripts.sh`` through
the port's Trainer against the JAX Trainer's, on the CPU, as
tests/test_torch_novel_channels.py holds ``:11`` (same cuts, same weights
rule: the port's Trainer builds and trains an epoch, the JAX Trainer, built
from the port's initial weights, takes its trained ones): ``:14``
(DiChaViT on So2Sat, the ``zero`` strategy on ``test_1``, ``test_2`` and
``test_full``, no sweep) and ``:20`` (ChannelViT on JUMP-CP, ``zero`` and
the channel-subset sweep), as written, on the fixtures of
tests/test_torch_data.py (So2Sat's needs h5py). ``evaluate_model`` of both
Trainers equal, keys and values.

torch runs on one thread here: the suite runs files side by side.
"""

import pytest
import torch

from test_torch_data import jumpcp_root, so2sat_root  # noqa: F401  (module fixtures)
from test_torch_novel_channels import CUTS, _pair, _recipe, _train_and_carry

SWEEP = {f"subset_{n}/{s}" for n in (8, 7) for s in ("mean", "std")}
KEYS = {
    14: {"valid/accuracy", "test_1/zero/accuracy", "test_2/zero/accuracy",
         "test_full/zero/accuracy", "accuracy"},
    20: {"valid/accuracy", "test/zero/accuracy", "accuracy"} | SWEEP,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("line", sorted(KEYS))
def test_recipe_eval_equals_jax(line, request, tmp_path):
    name, over = _recipe(line)
    so2sat = name == "so2sat_city_cfg"
    root = request.getfixturevalue("so2sat_root" if so2sat else "jumpcp_root")
    pt, jt = _pair(name, over + CUTS + [f"++dataset.root_dir={root}",
                                        f"++train.batch_size={8 if so2sat else 6}",
                                        f"++train.checkpoints={tmp_path}"])
    assert pt.cfg.model.new_channel_inits == ["zero"]
    _train_and_carry(pt, jt)
    got, want = pt.evaluate_model(1), jt.evaluate_model(1)
    assert set(got) == KEYS[line]
    assert got == want
