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
  takes them up, and so do ``attn_pooling`` and the four baseline models
  refused before the baselines' port; ``model.fused_block: false`` (refused
  before too) trains its bf16 step unfused, as JAX's under
  ``set_fused_block(False)``; the six ConvNeXt models (refused before their
  port) build, ``model.pretrained`` loads a timm checkpoint into one,
  CHAMMI's ``eval.umap`` passes, MIRO on a ConvNeXt model raises (A9) and
  ``plot_attn`` there ``ValueError``; a model name no package knows keeps
  the registry's ``KeyError`` (C9).
- SWA and SWAD: the lr per update and the averages equal the JAX Trainer's
  schedule and ``_swa_update``, and the model adopts the average.
- ``train.log_memory`` logs JAX's memory keys (ROADMAP C6).
- Devices: with the device unset the Trainer and ``main`` run on the card,
  so they raise without one.
"""

import os
import signal
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
from diverse_channel_vit_torch.trainer import Trainer, check_supported

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
    ("synthetic_cfg", ["train.ssl=True"], "ROADMAP A6"),
    ("synthetic_cfg", ["model=shared_convnext", "train.miro=True"], "ROADMAP A9"),
    ("synthetic_cfg", ["hardware.mesh.data=2"], "ROADMAP A10"),
    ("synthetic_cfg", ["hardware.mesh.model=2"], "ROADMAP A10"),
    ("synthetic_cfg", ["hardware.zero1=True"], "ROADMAP A10"),
    ("synthetic_cfg", ["hardware.zero3=True"], "ROADMAP A10"),
    ("synthetic_cfg", ["train.adaptive_interface_epochs=2"], "adaptive_interface_epochs"),
]


@pytest.mark.parametrize("name,over,match", REFUSED,
                         ids=[f"{n}-{'-'.join(o) or 'default'}" for n, o, _ in REFUSED])
def test_unported_keys_raise(name, over, match, tmp_path):
    cfg = load_config(name, TINY + over + [f"train.checkpoints={tmp_path}"])
    with pytest.raises(NotImplementedError, match=match):
        Trainer(cfg, device="cpu")


def test_a_model_name_no_package_knows_keeps_the_registry_error(tmp_path):
    cfg = load_config("synthetic_cfg", TINY + ["model.name=no_such_model",
                                               f"train.checkpoints={tmp_path}"])
    with pytest.raises(KeyError, match="Unknown model"):
        Trainer(cfg, device="cpu")


# keys the Trainer refused before the runtime port, and those it or the
# factory refused before the samplers, the optimizers, PPT and HCS dropout
# were ported, and now honours: each builds a Trainer that takes it up
# (tests/test_torch_runtime.py, tests/test_torch_preemption.py,
# tests/test_torch_samplers.py, tests/test_torch_optimizers.py and
# tests/test_torch_ppt.py hold what each does against JAX)
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
    ("synthetic_cfg", ["model.enable_sample=True", "model.hcs_sampling=hcs_per_sample"],
     lambda t: t.hcs_method == "hcs_per_sample" and t._hcs_feature_fn() is None),
    ("synthetic_cfg", ["model.enable_sample=True",
                       "model.hcs_sampling=lowest_cosine_prob_resnet34"],
     lambda t: t._hcs_feature_fn()(torch.zeros(1, 2, 32, 32)).shape == (1, 2, 512)),
    ("synthetic_cfg", ["optimizer=sgd"], lambda t: isinstance(t.state.optimizer,
                                                              torch.optim.SGD)),
    ("synthetic_cfg", ["optimizer=adam"], lambda t: isinstance(t.state.optimizer,
                                                               torch.optim.Adam)),
    ("synthetic_cfg", ["optimizer.name=adamp"],
     lambda t: type(t.state.optimizer).__name__ == "AdamPOptimizer"),
    ("synthetic_cfg", ["++optimizer.params.mu_dtype=bfloat16"],
     lambda t: t.state.optimizer.mu_dtype == torch.bfloat16),
    ("synthetic_cfg", ["model.block_type=block_v2", "model.dropout_tokens_hcs=token_pruning"],
     lambda t: all(type(b).__name__ == "BlockV2" for b in t.model.feature_extractor.blocks)),
    ("synthetic_cfg", ["model.dropout_tokens_hcs=channel", "++model.token_keep_channels=3"],
     lambda t: t.model.feature_extractor.keep_channels(8) == 3),
    # refused before the baselines were ported: attn_pooling goes to the
    # factories that take it (DiChaViT's does not, as JAX's build_model
    # passes it), and the four baseline models build
    ("synthetic_cfg", ["attn_pooling=param1"],
     lambda t: not hasattr(t.model.feature_extractor, "attn_pooling")),
    ("synthetic_cfg", ["model=depthwisevit_adapt", "model.pooling_channel_type=attention",
                       "attn_pooling=param1"],
     lambda t: t.model.feature_extractor.attn_pooling.depth == 1),
    *(("synthetic_cfg", [f"model={m}"], lambda t, c=c: type(t.model.feature_extractor).__name__
       == c) for m, c in (("vit_adapt", "SlicedPatchVisionTransformer"),
                          ("depthwisevit_adapt", "DepthwiseViT"),
                          ("hypervit_adapt", "HyperNetViT"),
                          ("templatemixingvit", "TemplateMixingViT"))),
    # refused before the ConvNeXt family was ported: every model builds by its
    # yaml file (the model names are their name: keys; sliceparam and
    # template_mixing_conv are named otherwise), freeze_other labels it as
    # JAX does (tests/test_torch_convnext.py holds them against JAX)
    *(("synthetic_cfg", [f"model={m}"], lambda t, c=c: type(t.model.feature_extractor).__name__
       == c) for m, c in (("convnext_base", "ConvNeXtBase"),
                          ("shared_convnext", "SharedConvNeXt"),
                          ("sliceparam", "SliceParamConvNeXt"),
                          ("template_mixing_conv", "TemplateMixingConvNeXt"),
                          ("hyperconvnext", "HyperConvNeXt"),
                          ("depthwiseconvnext", "DepthwiseConvNeXt"))),
    ("synthetic_cfg", ["model=convnext_base", "++model.is_conv_small=True",
                       "++model.drop_path_rate=0.1"],
     lambda t: [len(s.blocks) for s in t.model.feature_extractor.trunk.stages] == [3, 3, 8, 2]
     and t.model.feature_extractor.trunk.blocks[-1].drop_path == pytest.approx(0.1)),
    ("synthetic_cfg", ["model=shared_convnext", "model.freeze_other=True"],
     lambda t: "feature_extractor.stem_conv_train" not in t.state.frozen
     and "feature_extractor.trunk.stages.0.blocks.0.conv_dw.weight" in t.state.frozen),
]


@pytest.mark.parametrize("name,over,taken", RUNTIME_KEYS,
                         ids=[f"{n}-{'-'.join(o)}" for n, o, _ in RUNTIME_KEYS])
def test_formerly_refused_runtime_keys_build(name, over, taken, tmp_path):
    """The Trainer builds with each key and takes it up: ``pretrained=True``
    without ``pretrained_ckpt`` names no file and loads nothing (JAX
    ``trainer.py:352-357``); an 8 GB cap is above this process's RSS; with
    both of the test preset's blocks trainable, ``unfreeze_last_n_layers=2``
    freezes the tokens' tables alone (JAX's labels: neither interface, block
    nor head); the ``_resnet34`` sampler gets its frozen scorer (random
    init: no ``model.resnet34_ckpt``), each optimizer name its torch
    optimizer, ``block_v2`` PPT blocks and ``token_keep_channels`` the
    model's kc; ``attn_pooling`` the depthwise model's channel pooling (and
    not DiChaViT, whose factory does not take it), each baseline model its
    backbone (tests/test_torch_zoo.py holds them against JAX)."""
    cfg = load_config(name, TINY + over + [f"train.checkpoints={tmp_path}"])
    assert taken(Trainer(cfg, device="cpu"))


def test_chammi_umap_and_convnext_plot_attn(tmp_path):
    """``eval.umap`` on CHAMMI (refused before the embedding figures were
    ported) passes ``check_supported``; ``train.plot_attn`` on a ConvNeXt
    model, which has no attention, raises ``ValueError``."""
    check_supported(load_config("chammi_cfg", ["eval.umap=True"]))
    with pytest.raises(ValueError, match="no attention"):
        Trainer(load_config("synthetic_cfg", TINY + ["model=convnext_base",
                                                     "train.plot_attn=True",
                                                     f"train.checkpoints={tmp_path}"]),
                device="cpu")


def test_convnext_pretrained_loads_a_timm_checkpoint(tmp_path):
    """``model.pretrained`` for a ConvNeXt model (refused before the port):
    a timm ``convnext_tiny`` state dict on disk loads into the trunk, and the
    stem widens from 3 to the 8 channels by ``pretrained_pad_random``, as
    JAX's ``apply_pretrained_convnext`` does (tests/test_torch_convnext.py
    holds it against JAX); ``pretrained_pad_avg`` cannot fill 8 channels
    from 3 (JAX averages an empty window into NaN) and raises."""
    from test_torch_convnext import _timm_state

    sd = _timm_state(np.random.default_rng(0))
    path = str(tmp_path / "convnext_tiny.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    over = TINY + ["model=convnext_base", f"model.pretrained={path}",
                   f"train.checkpoints={tmp_path}"]
    t = Trainer(load_config("synthetic_cfg", over + [
        "model.init_first_layer=pretrained_pad_random"]), device="cpu")
    fe = t.model.feature_extractor
    assert torch.equal(fe.trunk.stages[2].blocks[8].mlp.fc1.weight,
                       sd["stages.2.blocks.8.mlp.fc1.weight"])
    assert fe.stem_conv.shape == (96, 8, 4, 4)
    assert torch.equal(fe.stem_conv[:, :3], sd["stem.0.weight"])
    assert torch.equal(fe.stem_bias, sd["stem.0.bias"])
    with pytest.raises(ValueError, match="pretrained_pad_random"):
        Trainer(load_config("synthetic_cfg", over + [
            "model.init_first_layer=pretrained_pad_avg"]), device="cpu")


def test_fused_block_false_step_matches_jax(tmp_path, monkeypatch):
    """``model.fused_block: false`` (refused before): JAX turns the fused
    route off for the process from the key (``set_fused_block``), the port
    per block. In bf16 at a width the fused route takes (``synthetic_cfg``,
    D = 128 in 2 heads of 64, depth 2, ``attention_impl`` auto: block 0 on
    the fused route unless the key is off, block 1 the readout), the port's
    Trainer with the key calls neither fused wrapper in a train step, where
    the same model without it calls both; and the step's loss equals the JAX
    bf16 step's under ``set_fused_block(False)`` from the same weights
    within 1e-2 relative, each gradient the JAX f32 step's within 3e-2 of
    its max|g| and the JAX bf16 step's within 3e-2 plus that step's own
    distance from f32, both on the f32 max|g| (JAX sums bias gradients in
    bf16: the patch bias lands about 50% of max|g| from f32 at this size),
    the bounds tests/test_torch_training.py holds a bf16 step to."""
    from diverse_channel_vit_tpu.models import build_model as jbuild_model
    from diverse_channel_vit_tpu.models.import_torch import load_reference_checkpoint
    from diverse_channel_vit_tpu.ops import fused_block as jfb
    from diverse_channel_vit_tpu.training.steps import make_grad_step as jmake_grad_step
    from diverse_channel_vit_torch.ops import fused_block as fb
    from diverse_channel_vit_torch.training import make_grad_step

    over = [o for o in TINY if "attention_impl" not in o] + [
        "++model.embed_dim=128", "++model.num_heads=2", f"train.checkpoints={tmp_path}"]
    calls = []
    for name in ("attend_project", "ln_mlp"):
        real = getattr(fb, name)
        monkeypatch.setattr(fb, name, lambda *a, real=real, name=name, **kw:
                            calls.append(name) or real(*a, **kw))
    batch = None
    for key in (True, False):
        pt = Trainer(load_config("synthetic_cfg", over + [f"model.fused_block={key}"]),
                     device="cpu")
        assert pt.dtype == torch.bfloat16
        if batch is None:
            raw = next(iter(pt.train_loader))
            batch = {"image": raw["image"], "label": raw["label"]}
        pt.model.zero_grad(set_to_none=True)
        step = make_grad_step(pt.model, channel_ids=range(8), loss_type="ce",
                              extra_loss_lambda=pt.extra_loss_lambda)
        del calls[:]
        m = step({k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(set(calls)) == ([] if not key else ["attend_project", "ln_mlp"]), key
    params = load_reference_checkpoint(
        {k: v.detach().numpy().copy() for k, v in pt.model.state_dict().items()})[0]
    jcfg = jload_config("synthetic_cfg", over + ["model.fused_block=False"])
    jcfg.model.in_channel_names = jcfg.dataset.in_channel_names
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    saved = jfb.FUSED_BLOCK_DEFAULT
    jfb.set_fused_block(False)
    try:
        want = {}
        for dtype in (jax.numpy.bfloat16, jax.numpy.float32):
            jmodel = jbuild_model("dichavit", jcfg.model, pt.mapper, pt.num_classes, dtype=dtype)
            grads, jm = jmake_grad_step(jmodel, channel_ids=range(8), loss_type="ce",
                                        extra_loss_lambda=pt.extra_loss_lambda)(
                params, jbatch, jax.random.key(0))
            want[dtype] = (float(jm["loss"]), params_from_jax(jax.device_get(grads)))
    finally:
        jfb.set_fused_block(saved)
    loss16, want16 = want[jax.numpy.bfloat16]
    _, want32 = want[jax.numpy.float32]
    assert abs(float(m["loss"]) - loss16) <= 1e-2 * abs(loss16)

    for name, p in pt.model.named_parameters():
        w16, w32 = want16[name].numpy(), want32[name].numpy()
        g = np.zeros_like(w32) if p.grad is None else p.grad.numpy()
        scale = max(np.abs(w32).max(), 1e-12)  # every distance on the f32 gradient's scale
        d32, d16, jax16 = (np.abs(a - b).max() / scale for a, b in ((g, w32), (g, w16),
                                                                      (w16, w32)))
        assert d32 <= 3e-2 and d16 <= 3e-2 + jax16, (name, d32, d16, jax16)


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


@pytest.mark.parametrize("found", ["default", "handler"])
def test_a_train_that_raises_restores_sigterm(found, tmp_path):
    """ROADMAP C7: ``Trainer.train`` installs its preemption guard on
    SIGTERM and must restore the handler it found on every way out, an
    exception included; before the repair a raise left the guard installed,
    so SIGTERM only set a flag nobody polled (and the JAX package's
    tests/test_preemption.py, later on the same worker, failed)."""
    before = signal.getsignal(signal.SIGTERM)
    if found == "handler":
        signal.signal(signal.SIGTERM, lambda signum, frame: None)
    try:
        want = signal.getsignal(signal.SIGTERM)
        t = Trainer(load_config("synthetic_cfg", TINY + [
            "train.save_model=best", "train.num_epochs=1", "dataset.num_train_samples=16",
            "eval.skip_eval_first_epoch=True", f"train.checkpoints={tmp_path}"]), device="cpu")
        with pytest.raises(NotImplementedError, match="save_model='best'"):
            t.train()
        assert signal.getsignal(signal.SIGTERM) is want
    finally:
        signal.signal(signal.SIGTERM, before)


def test_sigterm_is_default_after_save_model_best_raises(tmp_path):
    """The interaction the suite hit: test_save_model_best_raises_as_jax's
    case, then SIGTERM's handler is the default again, as the JAX package's
    tests/test_preemption.py expects when it runs next on the worker."""
    test_save_model_best_raises_as_jax(tmp_path)
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_main_runs_the_new_training_knobs(tmp_path):
    """``main`` with the keys of this port's last training knobs together,
    as chip_smoke.py runs them on the card: the ResNet-34 sampler (random
    init), Adam, PPT blocks with token pruning, one short epoch to its end
    with finite losses."""
    best = port_main.main([
        "-cn", "synthetic_cfg", *TINY, "train.num_epochs=1", "++hardware.device=cpu",
        "++model.enable_sample=True", "++model.hcs_sampling=lowest_cosine_prob_resnet34",
        "optimizer=adam", "++model.block_type=block_v2",
        "++model.dropout_tokens_hcs=token_pruning", f"train.checkpoints={tmp_path}"])
    assert np.isfinite(best)


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
