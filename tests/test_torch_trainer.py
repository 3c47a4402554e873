"""The port's Trainer and CLI (``diverse_channel_vit_torch/trainer.py``,
``main.py``) against the JAX package's, on the CPU.

- Parity, f32: the JAX Trainer at the JAX e2e tests' tiny geometry
  (``synthetic_cfg``, 32², patch 8, the ``test`` preset, the XLA route),
  with CE + CDL + TDL, built once for the module; the port's Trainer from
  the same config on the CPU, its weights carried over from the JAX
  Trainer's initial ``state.params`` (``params_from_jax``, copied in place).
  One epoch of 4 steps and the eval on each, with the JUMP-CP optimizer
  (AdamW, eps 1e-6, cosine weight decay) at lr 2e-3. The attention's key
  bias has no true gradient (softmax is shift-invariant per query), so its
  gradient is f32 noise on both sides; AdamW's eps 1e-6 keeps that noise from
  moving it, where the default config's eps 1e-8 would turn it into steps of
  about lr of either sign (tests/test_torch_training.py takes eps 1e-6 too).
  Step losses (recorded by
  wrapping each side's step functions) within rtol 1e-5 at step 0 and 1e-4
  after, as tests/test_torch_training.py holds the step; the lr after the
  epoch within rtol 5e-6 (f32 against double schedules); equal eval
  accuracies; every final parameter within atol lr / 10 of JAX's (an Adam
  update moves an entry by about lr).
- End to end, bf16: ``main([...])`` for 2 epochs learns the separable
  synthetic task (best accuracy > 0.3, as JAX ``tests/test_e2e.py``
  asserts), writes ``model_last`` and its meta.json, and a Trainer resumed
  from it starts at epoch 3 with the saved parameters and optimizer moments.
  It trains at the synthetic config's own sizes (512 images, batch 32: 16
  steps an epoch; one eval, after the last epoch): at the JAX test's 64 images (4 steps an epoch) whether
  2 epochs pass 0.3 turns on the initial weights, in both packages.
- The DCS channel-count draws equal JAX ``Trainer._draw_k``'s sequence.
- Every key the Trainer does not honour raises ``NotImplementedError``
  naming its ROADMAP item; the keys it refused before the CHAMMI port follow
  JAX (CHAMMI trains; ``tps_prob`` and ``training_chunks`` are ignored off
  CHAMMI), and so do those it refused before the novel-channel port
  (``model.new_channel_inits``, ``eval.eval_subset_channels``: the parity
  run's evals with the key equal JAX's; CHAMMI on a chunk subset builds
  JAX's mixed loader); ``build_mapper`` equals JAX's. The runtime keys it
  refused before the runtime port (SWA/SWAD, MIRO, freezing, ``pretrained``,
  ``plot_attn``, ``profile_dir``, ``max_host_rss_gb``) build a Trainer that
  takes them up; ``model.pretrained`` for a ConvNeXt trunk raises (A9).
- SWA and SWAD: the lr per update and the averages equal the JAX Trainer's
  schedule and ``_swa_update``, and the model adopts the average.
- ``train.log_memory`` logs JAX's memory keys (ROADMAP C6).
- Devices: with the device unset the Trainer and ``main`` run on the card,
  so they raise without one.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.config import load_config as jload_config
from diverse_channel_vit_tpu.trainer import Trainer as JTrainer
from diverse_channel_vit_tpu.utils.misc import set_seeds as jset_seeds
from diverse_channel_vit_torch import main as port_main
from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.trainer import Trainer

TINY = ["train.num_epochs=2", "train.batch_size=16", "++dataset.num_train_samples=64",
        "++dataset.num_eval_samples=32", "hardware.num_workers=0", "hardware.mesh.data=1",
        "model.attention_impl=xla"]
# the eval batch of 24 pads the 32 eval images' second batch with 16 rows
PARITY = TINY + ["optimizer=adamw_jumpcp", "optimizer.params.lr=0.002", "train.dtype=float32",
                 "eval.batch_size=24", "train.extra_loss_lambda=1.0",
                 "++model.proxy_loss_lambda=0.1", "++model.ortho_loss_v1_lambda=1.0"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The port's side on two threads: the suite runs files side by side, and
    torch's default of a thread a core oversubscribes the host (and is no
    faster at these sizes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _record_losses(trainer, losses):
    """Wrap the trainer's step factory so every step appends its loss."""
    make = trainer._get_train_step

    def get(*a, **kw):
        step = make(*a, **kw)

        def recorded(state, batch, *rest):
            state, m = step(state, batch, *rest)
            losses.append(float(m["loss"]))
            return state, m

        return recorded

    trainer._get_train_step = get


@pytest.fixture(scope="module")
def parity_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    over = PARITY + [f"train.checkpoints={tmp}"]
    jt = JTrainer(jload_config("synthetic_cfg", over))
    pt = Trainer(load_config("synthetic_cfg", over), device="cpu")
    pt.model.load_state_dict(params_from_jax(jt.state.params))  # in place, under no_grad
    runs = {}
    for name, t in (("jax", jt), ("port", pt)):
        losses = []
        _record_losses(t, losses)
        metrics = t.train_one_epoch(1)
        runs[name] = dict(losses=losses, lr=float(t.lr_schedule(t.state.step)),
                          eval=t.eval_regular(1), metrics=metrics)
    return jt, pt, runs


def test_parity_f32_losses_and_lr(parity_run):
    _, pt, runs = parity_run
    lj, lp = runs["jax"]["losses"], runs["port"]["losses"]
    assert len(lj) == len(lp) == 4 == pt.updates_per_epoch
    np.testing.assert_allclose(lp[0], lj[0], rtol=1e-5)
    np.testing.assert_allclose(lp[1:], lj[1:], rtol=1e-4)
    np.testing.assert_allclose(runs["port"]["lr"], runs["jax"]["lr"], rtol=5e-6)
    assert runs["port"]["metrics"]["extra_loss"] > 0  # CDL and TDL are on


def test_parity_f32_eval_and_parameters(parity_run):
    jt, pt, runs = parity_run
    assert runs["port"]["eval"] == runs["jax"]["eval"]
    assert set(runs["port"]["eval"]) == {"valid/accuracy", "test/accuracy", "accuracy"}
    assert pt.eval_counts["valid"][1] == 32
    lr = max(pt.lr_schedule(s) for s in range(pt.updates_per_epoch))
    want = params_from_jax(jt.state.params)
    got = pt.model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=lr / 10, rtol=0, err_msg=k)


def test_log_memory_keys_equal_jax(parity_run, monkeypatch):
    """``train.log_memory`` (ROADMAP C6): one epoch of each Trainer's
    ``train()`` logs JAX's memory keys (JAX ``trainer.py:835-853``), here on
    the CPU only ``mem/host_rss_mb`` (a card adds ``mem/hbm_mb`` and
    ``mem/hbm_peak_mb``), a positive MB count. The epoch and the evals
    replay the fixture's, which already ran them."""
    _, _, runs = parity_run
    logged = {}
    for name, t in zip(("jax", "port"), parity_run[:2]):
        msgs = logged[name] = []
        monkeypatch.setattr(t, "train_one_epoch", lambda epoch, runs=runs[name], **kw: dict(
            runs["metrics"]))
        monkeypatch.setattr(t, "evaluate_model", lambda epoch, runs=runs[name]: dict(runs["eval"]))
        monkeypatch.setattr(t, "total_epochs", 1)
        monkeypatch.setattr(t.logger, "info", lambda msg, *a, msgs=msgs, **kw: msgs.append(msg))
        saved = (t.cfg.train.get("log_memory"), t.cfg.train.save_model)
        t.cfg.train.log_memory, t.cfg.train.save_model = True, "none"
        try:
            t.train()
        finally:
            t.cfg.train.log_memory, t.cfg.train.save_model = saved
    keys = {n: {k for m in msgs if isinstance(m, dict) for k in m if k.startswith("mem/")}
            for n, msgs in logged.items()}
    assert keys["port"] == keys["jax"] == {"mem/host_rss_mb"}
    rss = [m["mem/host_rss_mb"] for m in logged["port"]
           if isinstance(m, dict) and "mem/host_rss_mb" in m]
    assert len(rss) == 1 and rss[0] > 0


def _find(root, name):
    for d, _, files in os.walk(root):
        if name in files:
            return os.path.join(d, name)
    raise AssertionError(f"{name} not written under {root}")


def test_main_trains_checkpoints_and_resumes_bf16(tmp_path):
    over = ["train.num_epochs=2", "optimizer.params.lr=0.002", "scheduler=none",
            "hardware.num_workers=0", "eval.skip_eval_first_epoch=True", "eval.every_n_epochs=2",
            f"train.checkpoints={tmp_path}", "++hardware.device=cpu"]
    best = port_main.main(["-cn", "synthetic_cfg", *over])
    assert best > 0.3  # separable synthetic data: well above 1/10 chance
    path = _find(tmp_path, "model_last")
    assert os.path.exists(path + ".meta.json")
    saved = torch.load(path, weights_only=True)
    t2 = Trainer(load_config("synthetic_cfg", over + [
        "train.resume_train=True", f"train.resume_model={path}"]))
    assert t2.start_epoch == 3 and t2.state.step == saved["step"] == 32
    assert t2.dtype == torch.bfloat16
    live = t2.model.state_dict()
    for k, v in saved["model"].items():
        assert torch.equal(live[k], v), k
    moments = t2.state.optimizer.state_dict()["state"]
    for i, s in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[i][key], s[key]), (i, key)


def test_dcs_k_draws_equal_jax(tmp_path):
    seed = 777
    over = TINY + [f"train.seed={seed}", "model.enable_sample=True",
                   "model.hcs_sampling=lowest_cosine_prob", "model.hcs_sampling_temp=1000",
                   f"train.checkpoints={tmp_path}"]
    t = Trainer(load_config("synthetic_cfg", over), device="cpu")
    draws = []
    draw = t._draw_k
    t._draw_k = lambda c: draws.append(draw(c)) or draws[-1]
    t.train_one_epoch(1)
    t.train_one_epoch(2)
    stub = types.SimpleNamespace(hcs_enabled=True, host_rng=jset_seeds(seed))
    assert draws == [JTrainer._draw_k(stub, 8) for _ in range(len(draws))]
    # a k = 8 step trains on every channel and reports no sampled subset
    assert len(draws) == 8 and sum(t.channel_counter.values()) == sum(k for k in draws if k < 8)


REFUSED = [
    ("chammi_cfg", ["eval.umap=True"], "ROADMAP A7"),
    ("cifar10_cfg", [], "ROADMAP A6"),
    ("synthetic_cfg", ["train.ssl=True"], "ROADMAP A6"),
    ("synthetic_cfg", ["model.name=convnext_base", "model.pretrained=/nonexistent.pth"],
     "ROADMAP A9"),
    ("synthetic_cfg", ["hardware.mesh.data=2"], "ROADMAP A10"),
    ("synthetic_cfg", ["hardware.mesh.model=2"], "ROADMAP A10"),
    ("synthetic_cfg", ["hardware.zero1=True"], "ROADMAP A10"),
    ("synthetic_cfg", ["hardware.zero3=True"], "ROADMAP A10"),
    ("synthetic_cfg", ["model.fused_block=False"], "ROADMAP A6"),
    ("synthetic_cfg", ["attn_pooling=param1"], "ROADMAP A8"),
    ("synthetic_cfg", ["model.enable_sample=True", "model.hcs_sampling=hcs_per_sample"],
     "ROADMAP A4"),
    ("synthetic_cfg", ["train.adaptive_interface_epochs=2"], "adaptive_interface_epochs"),
]


@pytest.mark.parametrize("name,over,match", REFUSED,
                         ids=[f"{n}-{'-'.join(o) or 'default'}" for n, o, _ in REFUSED])
def test_unported_keys_raise(name, over, match, tmp_path):
    cfg = load_config(name, TINY + over + [f"train.checkpoints={tmp_path}"])
    with pytest.raises(NotImplementedError, match=match):
        Trainer(cfg, device="cpu")


# keys the Trainer refused before the runtime port and now honours: each
# builds a Trainer that takes it up (tests/test_torch_runtime.py and
# tests/test_torch_preemption.py hold what each does against JAX)
RUNTIME_KEYS = [
    ("synthetic_cfg", ["train.swa=True"], lambda t: t.swa and t.swa_params is None),
    ("synthetic_cfg", ["train.swad=True"],
     lambda t: t.swad and t.lr_schedule(10**6) == pytest.approx(0.05)),
    ("synthetic_cfg", ["train.miro=True"],
     lambda t: t.miro_pre is not None and len(t.model.miro_encoders) == 2),
    ("synthetic_cfg", ["model.freeze_other=True"], lambda t: bool(t.state.frozen)),
    ("synthetic_cfg", ["model.unfreeze_last_n_layers=2"], lambda t: t.state.frozen == {
        "feature_extractor.cls_token", "feature_extractor.pos_embed"}),
    ("synthetic_cfg", ["model.pretrained=True"], lambda t: True),
    ("synthetic_cfg", ["train.plot_attn=True"], lambda t: True),
    ("synthetic_cfg", ["train.profile_dir=/nonexistent"], lambda t: True),
    ("synthetic_cfg", ["train.max_host_rss_gb=8"], lambda t: not t._should_recycle(1)),
]


@pytest.mark.parametrize("name,over,taken", RUNTIME_KEYS,
                         ids=[f"{n}-{'-'.join(o)}" for n, o, _ in RUNTIME_KEYS])
def test_formerly_refused_runtime_keys_build(name, over, taken, tmp_path):
    """The Trainer builds with each key and takes it up: ``pretrained=True``
    without ``pretrained_ckpt`` names no file and loads nothing (JAX
    ``trainer.py:352-357``); an 8 GB cap is above this process's RSS; with
    both of the test preset's blocks trainable, ``unfreeze_last_n_layers=2``
    freezes the tokens' tables alone (JAX's labels: neither interface, block
    nor head)."""
    cfg = load_config(name, TINY + over + [f"train.checkpoints={tmp_path}"])
    assert taken(Trainer(cfg, device="cpu"))


# keys the Trainer refused before the CHAMMI port and now honours (CHAMMI) or
# ignores as JAX does (tps_prob and training_chunks off CHAMMI), and those it
# refused before the novel-channel port (the strategies, the subset sweep)
HONOURED = [
    ("chammi_cfg", []),
    ("chammi_cfg", ["train.training_chunks=Allen_HPA", "model.new_channel_inits=[zero]"]),
    ("synthetic_cfg", ["train.tps_prob=0.2"]),
    ("synthetic_cfg", ["train.training_chunks=Allen_HPA"]),
    ("synthetic_cfg", ["model.new_channel_inits=[zero]"]),
    ("synthetic_cfg", ["eval.eval_subset_channels=True"]),
]


@pytest.mark.parametrize("name,over", HONOURED,
                         ids=[f"{n}-{'-'.join(o) or 'default'}" for n, o in HONOURED])
def test_formerly_refused_keys_follow_jax(name, over, tmp_path, request):
    """The Trainer builds with each key. CHAMMI: the mapper, the mixed
    loader's quotas over the training chunks and the class count equal
    JAX's (tests/test_torch_novel_channels_so2sat_chammi.py holds the
    strategies' eval). The novel-channel keys off CHAMMI: the eval of the
    parity run's two Trainers with the key set is equal, keys and values.
    ``tps_prob`` and ``training_chunks`` off CHAMMI: the loaders are those
    of a run without them."""
    import sys

    from diverse_channel_vit_tpu.data import loaders as jloaders

    args = TINY + over + [f"train.checkpoints={tmp_path}"]
    if name == "chammi_cfg":
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        from scripts.make_chammi_fixture import main as make_fixture

        make_fixture(str(tmp_path), n=24, img=32)
        args += [f"++dataset.root_dir={tmp_path}", "++dataset.img_size=32",
                 "++model.img_size=[32]", "++model.patch_size=8",
                 "++model.pretrained_model_name=test"]
    cfg, jcfg = load_config(name, args), jload_config(name, args)
    t = Trainer(cfg, device="cpu")
    if name == "chammi_cfg":
        # the mixed loader, the proxy loss over the global classes, no head
        assert t.mapper == JTrainer._build_mapper(types.SimpleNamespace(
            cfg=jcfg, dataset_name="morphem70k"))
        subset = ["Allen", "HPA"] if over else None
        mixed = jloaders.make_random_instance_train_loader(jcfg, t.seed, training_chunks=subset)
        assert t.train_loader.quotas == mixed.quotas
        assert sorted(mixed.quotas) == sorted(subset or t.mapper)
        assert t.updates_per_epoch == len(mixed) == (1 if over else 2)
        assert t.loss_type == "proxy" and t.num_classes == (10 if over else 14)
        assert t.model.classifer_head is None and sorted(t.test_loaders) == ["Allen", "CP", "HPA"]
        return
    if "tps_prob" not in over[0] and "training_chunks" not in over[0]:
        key, value = over[0].split("=")
        section, field = key.split(".")
        jt, pt, runs = request.getfixturevalue("parity_run")
        evals = {}
        for side, tr in (("jax", jt), ("port", pt)):
            sec = getattr(tr.cfg, section)
            saved = sec.get(field)
            setattr(sec, field, ["zero"] if field == "new_channel_inits" else True)
            try:
                evals[side] = tr.evaluate_model(1)
            finally:
                setattr(sec, field, saved)
        assert evals["port"] == evals["jax"]
        assert set(evals["port"]) - set(runs["port"]["eval"]) == (
            {"test/zero/accuracy"} if field == "new_channel_inits" else
            {f"subset_{n}/{s}" for n in (8, 7) for s in ("mean", "std")})
        return
    # off CHAMMI, JAX resets training_chunks (trainer.py:578-580) and no
    # dataset reads tps_prob: the same loaders and batches as without the key
    JTrainer._build_mapper(types.SimpleNamespace(cfg=jcfg, dataset_name="synthetic"))
    assert cfg.train.training_chunks == jcfg.train.training_chunks == "train"
    plain = Trainer(load_config(name, TINY + [f"train.checkpoints={tmp_path}"]), device="cpu")
    for a, b in zip(t.train_loader, plain.train_loader):
        assert np.array_equal(a["image"], b["image"]) and np.array_equal(a["label"], b["label"])


@pytest.mark.parametrize("dataset", ["morphem70k_v2", "morphem70k_v2_12channels", "synthetic"])
def test_build_mapper_equals_jax(dataset):
    from diverse_channel_vit_tpu.trainer import build_mapper as jbuild_mapper
    from diverse_channel_vit_torch.trainer import build_mapper

    name = "synthetic_cfg" if dataset == "synthetic" else "chammi_cfg"
    args = [] if dataset == "synthetic" else [f"dataset={dataset}"]
    assert build_mapper(load_config(name, args)) == jbuild_mapper(jload_config(name, args))


@pytest.mark.parametrize("key", ["swa", "swad"])
def test_swa_and_swad_equal_jax(key, tmp_path):
    """SWA (averaged once an epoch past ``swa_start``) and SWAD (once a
    batch, under its frozen-then-cosine lr): the port's lr per update equals
    the JAX Trainer's schedule (rtol 5e-6, f32 against double), its count of
    updates and its average equal JAX ``Trainer._swa_update`` replayed on
    the port's parameters at each update (atol 1e-7: the same f32
    arithmetic), and the model adopts the average at the end of the run.
    The JAX Trainer starts from the port's weights (no flax init) and
    trains nothing: its schedule and its averaging are what is held."""
    from diverse_channel_vit_tpu import trainer as jtm
    from diverse_channel_vit_tpu.models.import_torch import load_reference_checkpoint

    over = PARITY + [f"++train.{key}=True", "++train.swa_start=1", "train.num_epochs=3",
                     "++eval.only_eval_first_and_last=True", "++train.swa_lr=0.01",
                     f"train.checkpoints={tmp_path}"]
    pt = Trainer(load_config("synthetic_cfg", over), device="cpu")

    def jparams():
        return load_reference_checkpoint(
            {k: v.detach().numpy().copy() for k, v in pt.model.state_dict().items()})[0]

    real = jtm.create_train_state
    params0 = jparams()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtm, "create_train_state",
                   lambda model, tx, **kw: real(model, tx, **{**kw, "params": params0}))
        jt = jtm.Trainer(jload_config("synthetic_cfg", over))
    n = pt.total_epochs * pt.updates_per_epoch
    np.testing.assert_allclose([pt.lr_schedule(s) for s in range(n + 3)],
                               [float(jt.lr_schedule(s)) for s in range(n + 3)], rtol=5e-6)
    stub = types.SimpleNamespace(swa_n=0, swa_params=None, state=None)
    update = pt._swa_update

    def replay():
        update()
        stub.state = types.SimpleNamespace(params=jparams())
        JTrainer._swa_update(stub)

    pt._swa_update = replay
    pt.train()
    assert pt.swa_n == stub.swa_n == (2 if key == "swa" else 2 * pt.updates_per_epoch)
    names = [name for name, _ in pt.model.named_parameters()]
    want = params_from_jax(jax.device_get(stub.swa_params))
    for name, avg in zip(names, pt.swa_params):
        np.testing.assert_allclose(avg.numpy(), want[name].numpy(), rtol=0, atol=1e-7,
                                   err_msg=name)
        assert torch.equal(dict(pt.model.named_parameters())[name].detach(), avg), name


def test_save_model_best_raises_as_jax(tmp_path):
    t = Trainer(load_config("synthetic_cfg", TINY + [
        "train.save_model=best", "train.num_epochs=1", "dataset.num_train_samples=16",
        "eval.skip_eval_first_epoch=True", f"train.checkpoints={tmp_path}"]), device="cpu")
    with pytest.raises(NotImplementedError, match="save_model='best'"):
        t.train()


def test_device_defaults_to_the_card(tmp_path):
    over = TINY + [f"train.checkpoints={tmp_path}"]
    cfg = load_config("synthetic_cfg", over)
    assert cfg.hardware.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main.main(["-cn", "synthetic_cfg", *over])
    with pytest.raises(ValueError, match="hardware.device='tpu'"):
        Trainer(load_config("synthetic_cfg", over + ["hardware.device=tpu"]))
