"""CHAMMI's evaluation and entry point in the port against the JAX
package's, on the CPU.

- The benchmark: the same seeded features through both ``run_benchmark``s
  on the fixture's ``enriched_meta.csv``, kNN with cosine and l2: every
  per-task accuracy and macro F1, and the CHAMMI score, equal. A case with
  duplicated bank rows pins ties to the lowest bank index, as
  ``jax.lax.top_k`` breaks them.
- ``channelvit_adapt``: the same parameter tree as JAX's and logits within
  rel 1e-4 (f32, the bound tests/test_torch_model.py holds DiChaViT to).
- The port's ``main`` with the overrides of ``train_scripts.sh:8``
  (DiChaViT) and ``:17`` (ChannelViT), cut to the test preset at 32², one
  epoch and the eval: the CHAMMI score and ``accuracy``, finite per-chunk
  losses, the label checks of tests/test_chammi_e2e.py, ``model_last``, and
  the k draws equal to ``default_rng(seed)``'s, drawn per chunk.

The fixture is scripts/make_chammi_fixture.py's tree at 32², 24 images a
chunk. The accumulated step is in tests/test_torch_chammi.py.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.config import load_config as jload_config
from diverse_channel_vit_tpu.evaluation import KNeighbors as JKNeighbors
from diverse_channel_vit_tpu.evaluation import benchmark as jbench
from diverse_channel_vit_tpu.models import build_model as jbuild_model
from diverse_channel_vit_tpu.models.import_torch import load_reference_checkpoint
from diverse_channel_vit_torch import main as port_main
from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.evaluation import KNeighbors, benchmark, morphem_eval
from diverse_channel_vit_torch.models import build_model
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.trainer import Trainer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = ["dataset=morphem70k_v2_12channels", "++dataset.img_size=32", "++model.img_size=[32]",
        "++model.patch_size=8", "++model.pretrained_model_name=test",
        "++model.attention_impl=xla", "++model.temperature=0.07",
        "++model.proxy_loss_lambda=0.1", "++model.ortho_loss_v1_lambda=1"]
@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from scripts.make_chammi_fixture import main as make_fixture

    root = tmp_path_factory.mktemp("chammi")
    make_fixture(str(root), n=24, img=32)
    return str(root)


def _model_cfgs(name, over=()):
    args = TINY + [f"model={name}", *over]
    cfg, jcfg = load_config("chammi_cfg", args), jload_config("chammi_cfg", args)
    for c in (cfg, jcfg):
        c.model.in_channel_names = c.dataset.in_channel_names
    return cfg, jcfg


def _start(name, cfg, mapper, num_classes, rng):
    """The port's model from its seed, LayerNorm affines and biases moved
    off 1 / 0 so they count, and the same weights as a JAX parameter tree
    (the JAX package's reference-checkpoint importer: no flax init to
    compile)."""
    model = build_model(name, cfg.model, mapper, num_classes, device="cpu")
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("bias", "norm1.weight", "norm2.weight", "norm.weight")):
                v += torch.from_numpy(0.05 * rng.normal(size=tuple(v.shape)).astype(np.float32))
    sd = model.state_dict()
    params, _ = load_reference_checkpoint({k: v.numpy().copy() for k, v in sd.items()})
    carried = params_from_jax(params)
    assert sorted(carried) == sorted(sd)
    assert all(torch.equal(carried[k], sd[k]) for k in sd)
    return model, params


def _write_features(root, feature_dir, rng, dim=16, duplicate=False):
    for chunk in ("Allen", "HPA", "CP"):
        n = sum(1 for _ in open(os.path.join(root, chunk, "enriched_meta.csv"))) - 1
        feats = rng.normal(size=(n, dim)).astype(np.float32)
        if duplicate:  # rows 2j and 2j + 1 equal: their labels differ
            feats[1::2] = feats[0::2]
        os.makedirs(os.path.join(feature_dir, chunk), exist_ok=True)
        np.save(os.path.join(feature_dir, chunk, "features.npy"), feats)


@pytest.mark.parametrize("duplicate", [False, True], ids=["seeded", "duplicated_rows"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_benchmark_scores_equal_jax(root, tmp_path, metric, duplicate):
    feature_dir = str(tmp_path / "feat")
    _write_features(root, feature_dir, np.random.default_rng(3), duplicate=duplicate)
    kw = dict(root_dir=root, feature_dir=feature_dir, feature_file="features.npy",
              classifier="knn", knn_metric=metric)
    got = benchmark.run_benchmark(dest_dir=str(tmp_path / "port"), device="cpu", **kw)
    want = jbench.run_benchmark(dest_dir=str(tmp_path / "jax"), **kw)
    assert len(got) == 9  # Allen T1-2, HPA T1-3, CP T1-4
    assert got[["dataset", "task"]].values.tolist() == want[["dataset", "task"]].values.tolist()
    assert got["accuracy"].tolist() == want["accuracy"].tolist()
    assert got["f1_score_macro"].tolist() == want["f1_score_macro"].tolist()
    score = benchmark.chammi_score(got)
    assert score == jbench.chammi_score(want) and 0.0 <= score <= 1.0


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_knn_ties_go_to_the_lowest_index(metric):
    bank = np.array([[0.0, 1.0], [1.0, 0.5], [1.0, 0.5], [1.0, 0.5]], np.float32)
    y = np.array([3, 5, 7, 9])
    q = np.array([[2.0, 1.0], [0.0, 3.0]], np.float32)
    got = KNeighbors(metric=metric, device="cpu").fit(bank, y)
    want = JKNeighbors(metric=metric).fit(bank, y)
    assert got.kneighbors(q)[1].tolist() == want.kneighbors(q)[1].tolist() == [[1], [0]]
    assert got.predict(q).tolist() == [5, 3]


def test_channelvit_adapt_matches_jax():
    cfg, jcfg = _model_cfgs("channelvit_adapt")
    mapper = {"train": list(range(8))}
    jmodel = jbuild_model("channelvit_adapt", jcfg.model, mapper, 5, dtype=jnp.float32)
    jtree = jax.eval_shape(lambda x: jmodel.init({"params": jax.random.key(0)}, x,
                                                 jnp.arange(8), train=False),
                           jnp.zeros((1, 8, 32, 32), jnp.float32))["params"]
    model, params = _start("channelvit_adapt", cfg, mapper, 5, np.random.default_rng(1))
    # the same parameter tree as JAX's channelvit_adapt, and as the port's dichavit
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(jtree)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.shape(a) == b.shape, params, jtree))
    assert (sorted(build_model("dichavit", cfg.model, mapper, 5, device="cpu").state_dict())
            == sorted(model.state_dict()))
    x = np.random.default_rng(2).normal(size=(2, 5, 32, 32)).astype(np.float32)
    ids = [0, 2, 3, 5, 7]
    want, _ = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, jnp.asarray(ids),
                                                train=False))(params, jnp.asarray(x))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x), torch.tensor(ids))
    assert got.shape == (2, 5)
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) <= 1e-4
    with pytest.raises(KeyError):  # a name that no package registers
        build_model("no_such_model", cfg.model, mapper, 5, device="cpu")


# train_scripts.sh:8 (DiChaViT) and :17 (ChannelViT), the hydra -m flag and
# the tag aside
RECIPES = {
    "dichavit": [
        "model=dichavit", "++model.enable_sample=True", "++model.pretrained_model_name=small",
        "dataset=morphem70k_v2_12channels", "++optimizer.params.lr=0.00004",
        "++model.temperature=0.07", "++train.num_epochs=60", "++train.save_model=last",
        "++model.new_channel_inits=[zero]", "++train.batch_size=64", "++eval.batch_size=256",
        "++train.debug=False", "++eval.every_n_epochs=6", "++eval.skip_eval_first_epoch=True",
        "++train.tps_prob=0.2", "++model.orthogonal_channel_emb_init=True",
        "++train.extra_loss_lambda=1", "++model.proxy_loss_lambda=0.1",
        "++model.ortho_loss_v1_lambda=1", "++model.gamma_s=0.5", "++model.gamma_d=2",
        "++model.reverse_pos_pairs=True", "++train.seed=2025",
        "++model.hcs_sampling=lowest_cosine_prob"],
    "channelvit_adapt": [
        "model=channelvit_adapt", "++model.enable_sample=True",
        "++model.pretrained_model_name=small", "dataset=morphem70k_v2_12channels",
        "++optimizer.params.lr=0.00004", "++model.temperature=0.07", "++train.num_epochs=60",
        "++train.save_model=last", "++model.new_channel_inits=[zero]", "++train.batch_size=64",
        "++eval.batch_size=256", "++train.debug=False", "++eval.every_n_epochs=6",
        "++eval.skip_eval_first_epoch=True", "++train.seed=215579", "++train.tps_prob=0.2"],
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_main_runs_the_chammi_recipe(root, tmp_path, recipe, monkeypatch):
    over = RECIPES[recipe] + [
        "++model.pretrained_model_name=test", "++dataset.img_size=32", "++model.img_size=[32]",
        "++model.patch_size=8", "++train.num_epochs=1", "++train.batch_size=12",
        "++eval.batch_size=16", "++hardware.num_workers=0", "++hardware.device=cpu",
        f"++dataset.root_dir={root}", f"++eval.root_dir={root}",
        f"++eval.feature_dir={tmp_path}/feat/{{FOLDER_NAME}}",
        f"++eval.dest_dir={tmp_path}/res/{{FOLDER_NAME}}", f"++train.checkpoints={tmp_path}/ck"]
    seen = {}
    train, epoch, draw, evaluate = (Trainer.train, Trainer.train_one_epoch, Trainer._draw_k,
                                    Trainer.evaluate_model)

    def spy_train(t):
        seen["trainer"] = t
        return train(t)

    def spy_epoch(t, e):
        seen["epoch"] = epoch(t, e)
        return seen["epoch"]

    def spy_draw(t, c):
        seen.setdefault("draws", []).append((c, draw(t, c)))
        return seen["draws"][-1][1]

    def spy_eval(t, e):
        seen["eval"] = evaluate(t, e)
        return seen["eval"]

    extract = morphem_eval.extract_features

    def spy_extract(t, chunk, loader, *strategy):
        feats = extract(t, chunk, loader, *strategy)
        seen.setdefault("rows", {})[chunk] = len(feats)
        return feats

    for name, fn in (("train", spy_train), ("train_one_epoch", spy_epoch),
                     ("_draw_k", spy_draw), ("evaluate_model", spy_eval)):
        monkeypatch.setattr(Trainer, name, fn)
    monkeypatch.setattr(morphem_eval, "extract_features", spy_extract)
    best = port_main.main(["-cn", "chammi_cfg", *over])
    t = seen["trainer"]
    assert t.loss_type == "proxy" and t.model.classifer_head is None
    assert t.model.feature_extractor.patch_embed.channel_embed.weight.shape[0] == 12
    assert t.train_loader.quotas == {"Allen": 4, "HPA": 4, "CP": 4}
    assert t.updates_per_epoch == len(t.train_loader) == 3
    for k in ("Allen/loss", "HPA/loss", "CP/loss", "grad_norm"):
        assert np.isfinite(seen["epoch"][k]), (k, seen["epoch"])
    # the mixed loader's labels: the global 14-class vocabulary, Allen at 4..9
    batch = next(iter(t.train_loader))
    labels = np.concatenate([b["label"] for b in batch.values()])
    assert labels.min() >= 0 and labels.max() <= 13
    assert batch["Allen"]["label"].min() >= 4 and batch["Allen"]["label"].max() <= 9
    res = seen["eval"]
    assert 0.0 <= res["knn_cosine/chammi_score"] <= 1.0
    assert res["accuracy"] == res["knn_cosine/chammi_score"] == best
    assert len([k for k in res if k.endswith("/acc")]) == 9
    assert seen["rows"] == {"Allen": 24, "HPA": 24, "CP": 24}
    assert os.listdir(f"{tmp_path}/res") == [f"epoch1_seed{t.seed}"]
    assert os.listdir(f"{tmp_path}/feat") == []  # eval.clean_up
    assert os.path.exists(os.path.join(t.checkpoints, "model_last"))
    # one k draw per chunk, in the batch's order, from default_rng(seed)
    seed = int(next(o for o in over if o.startswith("++train.seed=")).split("=")[1])
    rng = np.random.default_rng(seed)
    assert [c for c, _ in seen["draws"]] == [3, 4, 5] * 3
    assert [k for _, k in seen["draws"]] == [int(rng.integers(1, c + 1)) for c in [3, 4, 5] * 3]
