"""The port's novel-channel evaluation against the JAX package's, on the CPU
(So2Sat and CHAMMI on a chunk subset: tests/test_torch_novel_channels_so2sat_chammi.py).

- Strategy tables: ``synthesis_plan`` and ``synthesize_rows`` of
  ``diverse_channel_vit_torch/ops/novel_channels.py`` equal JAX's for every
  strategy of ``STATIC_STRATEGIES`` on seeded tables (2-D and 4-D), over
  CHAMMI's two mappers and several training-chunk subsets (the
  ``_not_in_chunk`` banks, ``random_input_corr`` from equal-seeded
  generators); both raise the same error for ``fixed_input_corr`` without a
  channel map and for an unknown strategy.
- ``dynamic_input_corr`` variants 1-6 on seeded numpy inputs (5 and 6
  through each package's patch projection): the rows that pick a trained
  channel equal JAX's exactly, the weighted ones (4, 5) within rtol 1e-5
  (f32 sums in other orders); a vote tie goes to the lowest channel in both.
- The JUMP-CP Trainer: the recipe of ``train_scripts.sh:11`` as written
  (read from the file) on the JUMP-CP fixture of tests/test_torch_data.py,
  cut to the ``test`` preset (depth 2, D = 64) at 32², f32, the XLA route on
  the JAX side, one epoch of batches of 6 (:data:`CUTS`). The port's Trainer
  builds and trains the epoch; the JAX Trainer is built from the port's
  initial weights (its ``create_train_state`` handed them, so no flax init
  is compiled) and then given the port's trained weights. Both
  ``evaluate_model`` results are equal, keys and values. Then a mapper
  whose test split holds two channels train lacks, under every static
  strategy and two dynamic ones (the exemplar banks equal, the host
  generator left in the same state); and a (C, D) and a (B, C, D) override
  through the eval forward against JAX's ``make_eval_step``, rel 1e-4 of
  max|logit| (as tests/test_torch_model.py holds f32 logits).

torch runs on one thread here: the suite runs files side by side.
"""

import os
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu import trainer as jtrainer_module
from diverse_channel_vit_tpu.config import load_config as jload_config
from diverse_channel_vit_tpu.models.import_torch import load_reference_checkpoint
from diverse_channel_vit_tpu.ops import novel_channels as jnc
from diverse_channel_vit_tpu.ops.patch_embed import per_channel_patch_embed as j_patch_embed
from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.ops import novel_channels as nc
from diverse_channel_vit_torch.ops.patch_embed import per_channel_patch_embed
from diverse_channel_vit_torch.trainer import Trainer
from test_torch_data import jumpcp_root  # noqa: F401  (a module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPPERS = {
    "v2": {"Allen": [5, 2, 6], "HPA": [3, 6, 5, 0], "CP": [5, 0, 7, 1, 4]},
    "12": {"Allen": [0, 1, 2], "HPA": [3, 4, 5, 6], "CP": [7, 8, 9, 10, 11]},
}
CASES = [(m, chunk, tc) for m in MAPPERS for tc in ("Allen_HPA", "HPA_CP", "Allen")
         for chunk in ("Allen", "HPA", "CP")]
LOGITS_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("strategy", nc.STATIC_STRATEGIES)
def test_strategy_tables_equal_jax(strategy):
    assert nc.STATIC_STRATEGIES == jnc.STATIC_STRATEGIES
    rng = np.random.default_rng(0)
    table = rng.normal(size=(12, 16)).astype(np.float32)
    bank4 = rng.normal(size=(12, 2, 3, 3)).astype(np.float32)
    for m, chunk, tc in CASES:
        mapper = MAPPERS[m]
        assert nc.flatten_training_channels(mapper, tc) == jnc.flatten_training_channels(
            mapper, tc)
        kw = dict(channel_map={c: mapper[tc.split("_")[0]][0] for c in range(12)})
        if strategy == "random_input_corr":
            kw = dict(rng=np.random.default_rng(7)), dict(rng=np.random.default_rng(7))
        else:
            kw = kw, kw
        plan = nc.synthesis_plan(mapper, chunk, tc, strategy, **kw[0])
        assert plan == jnc.synthesis_plan(mapper, chunk, tc, strategy, **kw[1])
        for t in (table, bank4):
            got = nc.synthesize_rows(torch.from_numpy(t), plan)
            want = np.asarray(jnc.synthesize_rows(jnp.asarray(t), plan))
            assert got.shape == want.shape == (len(mapper[chunk]),) + t.shape[1:]
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{m} {chunk} {tc}")
    # a novel channel under fixed_input_corr with no map, or an unknown
    # strategy: the same error in both
    for bad in ("fixed_input_corr", "no_such_strategy"):
        errs = []
        for mod in (nc, jnc):
            with pytest.raises(ValueError) as err:
                mod.synthesis_plan(MAPPERS["12"], "CP", "Allen_HPA", bad)
            errs.append(str(err.value))
        assert errs[0] == errs[1]


def _dynamic_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(5, 4, 16, 16)).astype(np.float32)
    bank = rng.normal(size=(6, 3, 16, 16)).astype(np.float32)  # 6 exemplars, 3 channels
    emb = rng.normal(size=(12, 24)).astype(np.float32)
    kernel = rng.normal(size=(64, 24)).astype(np.float32)  # patch 8
    return x, bank, emb, kernel


def _jax_dynamic(variant, x, chs, bank, emb, tcs, kernel):
    """JAX's ``dynamic_input_corr`` for each channel position of ``chs``,
    jitted (one compile in place of an eager compile per op), the patch
    projection from ``kernel`` (patch 8)."""
    def fn(x, bank, emb, kernel):
        proj = lambda v: j_patch_embed(v, kernel, None, patch_size=8)  # noqa: E731
        return [jnc.dynamic_input_corr(variant, x, ch, bank, emb, tcs, proj_fn=proj)
                for ch in chs]

    return [np.asarray(a) for a in jax.jit(fn)(x, bank, emb, kernel)]


def _port_dynamic(variant, x, ch, bank, emb, tcs, kernel):
    kt = torch.from_numpy(kernel)
    proj = lambda v: per_channel_patch_embed(v, kt, None, patch_size=8)  # noqa: E731
    return nc.dynamic_input_corr(variant, torch.from_numpy(x), ch, torch.from_numpy(bank),
                                 torch.from_numpy(emb), tcs, proj_fn=proj).numpy()


@pytest.mark.parametrize("variant", [1, 2, 3, 4, 5, 6])
def test_dynamic_input_corr_equals_jax(variant):
    x, bank, emb, kernel = _dynamic_inputs()
    tcs = [9, 2, 5]
    chs = (0, 3)
    for ch, want in zip(chs, _jax_dynamic(variant, x, chs, bank, emb, tcs, kernel)):
        got = _port_dynamic(variant, x, ch, bank, emb, tcs, kernel)
        assert got.shape == want.shape == (5, 24)
        if variant in (4, 5):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:  # a trained channel's row, the same one
            np.testing.assert_array_equal(got, want)
            assert all(any(np.array_equal(r, emb[c]) for c in tcs) for r in got)


def test_dynamic_vote_ties_go_to_the_lowest_channel():
    """Two exemplars, each matching the image best in another channel: the
    vote is 1 to 1, and both packages take the lower channel (variants 1
    and 6); a variant out of range raises in both."""
    rng = np.random.default_rng(1)
    img = rng.normal(size=(16, 16)).astype(np.float32)
    bank = rng.normal(size=(2, 3, 16, 16)).astype(np.float32) * 1e-3
    bank[0, 2] = img
    bank[1, 1] = img
    x = np.stack([img, img])[:, None]  # (2, 1, 16, 16)
    emb = rng.normal(size=(4, 8)).astype(np.float32)
    tcs = [3, 0, 2]
    kernel = np.eye(64, 8, dtype=np.float32)
    for variant in (1, 6):
        got = _port_dynamic(variant, x, 0, bank, emb, tcs, kernel)
        (want,) = _jax_dynamic(variant, x, (0,), bank, emb, tcs, kernel)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.stack([emb[0], emb[0]]))  # tcs[1], not tcs[2]
    for mod, arr in ((nc, torch.from_numpy), (jnc, jnp.asarray)):
        with pytest.raises(ValueError, match="variant 7"):
            mod.dynamic_input_corr(7, arr(x), 0, arr(bank), arr(emb), tcs)


# -- the Trainers ------------------------------------------------------------

CUTS = ["++model.pretrained_model_name=test", "++dataset.img_size=32", "++model.img_size=[32]",
        "++train.num_epochs=1", "++eval.batch_size=4", "++hardware.num_workers=0",
        "++hardware.mesh.data=1", "++model.attention_impl=xla", "++train.dtype=float32",
        "++train.save_model=none"]


def _recipe(line: int):
    """``train_scripts.sh`` at ``line``: the config name and the overrides as
    written, less the hydra ``-m`` flag and the tag."""
    with open(os.path.join(REPO, "train_scripts.sh")) as f:
        args = shlex.split(f.read().splitlines()[line - 1])
    assert args[:3] == ["python", "main.py", "-m"]
    i = args.index("-cn")
    return args[i + 1], [a for a in args[i + 2:] if not a.startswith("tag=")]


def _jax_params(model):
    return load_reference_checkpoint(
        {k: v.detach().numpy().copy() for k, v in model.state_dict().items()})[0]


def _pair(name, over):
    """The port's Trainer, then the JAX Trainer of the same config started
    from the port's initial weights."""
    pt = Trainer(load_config(name, over), device="cpu")
    params = _jax_params(pt.model)
    real = jtrainer_module.create_train_state
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer_module, "create_train_state",
                   lambda model, tx, **kw: real(model, tx, **{**kw, "params": params}))
        jt = jtrainer_module.Trainer(jload_config(name, over))
    return pt, jt


def _train_and_carry(pt, jt):
    """One epoch of the port's Trainer, finite; the JAX Trainer takes the
    trained weights."""
    metrics = pt.train_one_epoch(1)
    assert metrics and all(np.isfinite(v) for v in metrics.values()), metrics
    jt.state = jt.state.replace(params=_jax_params(pt.model))


@pytest.fixture(scope="module")
def jumpcp(jumpcp_root, tmp_path_factory):  # noqa: F811
    name, over = _recipe(11)
    assert name == "jump_cp_cfg" and "++eval.eval_subset_channels=True" in over
    tmp = tmp_path_factory.mktemp("jumpcp_run")
    pt, jt = _pair(name, over + CUTS + [f"++dataset.root_dir={jumpcp_root}",
                                        "++train.batch_size=6", f"++train.checkpoints={tmp}"])
    _train_and_carry(pt, jt)
    return pt, jt


def test_jumpcp_recipe_eval_equals_jax(jumpcp):
    pt, jt = jumpcp
    assert pt.cfg.model.new_channel_inits == ["zero"] and pt.hcs_enabled
    got, want = pt.evaluate_model(1), jt.evaluate_model(1)
    assert set(got) == {"valid/accuracy", "test/zero/accuracy", "accuracy", "subset_8/mean",
                        "subset_8/std", "subset_7/mean", "subset_7/std"}
    assert got == want
    assert pt.eval_counts["test"][1] == len(pt.test_loader.dataset) > 0


# every static strategy but fixed_input_corr (which needs a channel map the
# Trainer never has); of the dynamic ones a vote on pixels and a weighted
# sum on patch projections (test_dynamic_input_corr_equals_jax holds all six)
STRATEGIES = [s for s in nc.STATIC_STRATEGIES if s != "fixed_input_corr"] + [
    "dynamic_input_corr_1", "dynamic_input_corr_5"]


def test_jumpcp_novel_channels_under_every_strategy_equal_jax(jumpcp):
    """Train holds channels 0-5 of 8: the test split's channels 6 and 7 are
    novel, so each strategy gives them other rows."""
    pt, jt = jumpcp
    mapper = {"train": list(range(6)), "valid": list(range(8)), "test": list(range(8))}
    for t, loader in ((pt, pt.train_loader), (jt, jt.train_loaders["jump_cp"])):
        t.mapper = dict(mapper)
        t.cfg.model.new_channel_inits = list(STRATEGIES)
        t.host_rng = np.random.default_rng(3)
        loader.set_epoch(5)
    got, want = pt.eval_regular(1), jt.eval_regular(1)
    assert set(got) == {"valid/accuracy", "accuracy"} | {f"test/{s}/accuracy"
                                                        for s in STRATEGIES}
    assert got == want
    np.testing.assert_array_equal(pt._dyn_bank.numpy(), np.asarray(jt._dyn_bank))
    assert pt._dyn_bank.shape[:2] == (6, 6)  # 6 exemplars of train's 6 channels
    assert pt.host_rng.integers(1, 9, 16).tolist() == jt.host_rng.integers(1, 9, 16).tolist()
    tables = {s: pt._synthesis_override("test", s) for s in ("zero", "avg_2", "replicate")}
    assert not torch.equal(tables["zero"][6:], tables["avg_2"][6:])
    assert torch.equal(tables["zero"][:6], tables["avg_2"][:6])
    for t in (pt, jt):
        with pytest.raises(ValueError, match="channel_map"):
            t._synthesis_override("test", "fixed_input_corr")


def test_override_through_the_forward_equals_jax(jumpcp):
    pt, jt = jumpcp
    rng = np.random.default_rng(2)
    # the eval batches' shape (the JUMP-CP crops are 64², resized to no grid
    # size at eval): the JAX eval step compiled for both override kinds
    x = rng.normal(size=(4, 8, 64, 64)).astype(np.float32)
    cids = np.arange(8)
    for override in (rng.normal(size=(8, 64)), rng.normal(size=(4, 8, 64))):
        override = override.astype(np.float32)
        got = pt._eval_step(torch.from_numpy(x), torch.from_numpy(cids),
                            torch.from_numpy(override))
        want = jt._get_eval_step(None)(jt.state.params, jnp.asarray(x), jnp.asarray(cids),
                                       jnp.asarray(override))
        plain = pt._eval_step(torch.from_numpy(x), torch.from_numpy(cids))
        assert _rel(got, want) <= LOGITS_REL and _rel(got, plain) > 1e-3
    # the table's own rows as a (C, D) override: the plain forward's logits
    table = pt.model.feature_extractor.patch_embed.channel_embed.weight.detach()
    same = pt._eval_step(torch.from_numpy(x), torch.from_numpy(cids), table[:8].clone())
    assert torch.equal(same, plain)
