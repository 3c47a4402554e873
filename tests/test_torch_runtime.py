"""The port's Trainer runtime against the JAX package, on the CPU: freezing,
MIRO, DropPath and the warm start from a reference checkpoint.

Geometry: ``synthetic_cfg`` cut to the ``test`` preset at depth 3 (D = 64, 2
heads, 8 channels at 32², patch 8: 129 tokens), f32, the JUMP-CP optimizer
(AdamW, eps 1e-6, cosine weight decay) at lr 2e-3 with clipping at global
norm 1 (the runs' gradients reach about 3.5, so every step clips), 48 images
in 3 steps of 16. The port side is the port's Trainer from each config (its
wiring of the keys is what is under test), or for DropPath the port's train
step; the JAX side is the JAX package's jitted ``make_grad_step`` from the
port's initial weights (carried with JAX's ``load_reference_checkpoint``),
``optax.global_norm`` of the gradients (the train step's logged
``grad_norm``, JAX ``training/steps.py:333``) and the optimizer that the JAX
Trainer builds for the key (``training/freeze.masked_optimizer``, MIRO's
``multi_transform``, ``trainer.py:319-335`` and ``:401-414``), applied with
optax. The JAX Trainer itself is not built here: its import (orbax) alone
would take a quarter of this file's time. The DropPath steps and the two
freezing runs share one compiled gradient function, DropPath (rate 0.3) on
with fixed per-sample masks: JAX's ``DropPath.__call__`` patched to apply
them while it is traced, the port's draw patched to return them.

Tolerances. f32 single steps hold to 1e-5 relative (losses, ``grad_norm``);
parameters after 3 steps to 2e-5 absolute (an Adam update moves an entry by
about lr = 2e-3, so this is 1% of one step: reduction orders differ between
XLA and torch). MIRO's loss: JAX's f32 ``jnp.mean`` over the 16 x 129 x 64
elements of each tap drifts by about 3e-5 relative (its constant log-var
term alone reads -3.4537773 where the exact value is -3.4538777), so the
port's loss is held to JAX's at 1e-4, and at step 0 (live and pre-featurizer
taps equal, so the loss is the log-var term alone) to its exact value at
2e-6. Frozen parameters must be bit for bit unchanged.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diverse_channel_vit_tpu.config import load_config as jload_config
from diverse_channel_vit_tpu.models import build_model as jbuild_model
from diverse_channel_vit_tpu.models import vit as jvit
from diverse_channel_vit_tpu.models.export import save_reference_checkpoint
from diverse_channel_vit_tpu.models.import_torch import (load_reference_checkpoint as
                                                         jload_reference,
                                                         merge_into_template as jmerge)
from diverse_channel_vit_tpu.training import freeze as jfreeze
from diverse_channel_vit_tpu.training import miro as jmiro
from diverse_channel_vit_tpu.training import schedules as jsched
from diverse_channel_vit_tpu.training.optim import make_optimizer as jmake_optimizer
from diverse_channel_vit_tpu.training.steps import make_grad_step as jmake_grad_step
from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.models import ChannelVisionTransformer, build_model
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.models.import_torch import load_reference_checkpoint
from diverse_channel_vit_torch.trainer import Trainer
from diverse_channel_vit_torch.training import (TrainState, make_lr_schedule, make_optimizer,
                                                make_train_step)
from diverse_channel_vit_torch.training.freeze import build_trainable_labels
from diverse_channel_vit_torch.training.miro import init_encoders, miro_vlb

BASE = ["train.num_epochs=1", "train.batch_size=16", "++dataset.num_train_samples=48",
        "++dataset.num_eval_samples=16", "hardware.num_workers=0", "hardware.mesh.data=1",
        "model.attention_impl=xla", "optimizer=adamw_jumpcp", "optimizer.params.lr=0.002",
        "train.dtype=float32", "++model.depth=3", "++train.clip_grad_norm=1.0",
        "eval.skip_eval_first_epoch=True"]
CIDS = list(range(8))
MAPPER = {"train": CIDS, "valid": CIDS, "test": CIDS}  # the synthetic config's
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _jax_params(model):
    """The port model's weights (MIRO's encoders left out) as the JAX
    package's param tree."""
    sd = {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()
          if not k.startswith("miro_encoders.")}
    return dict(jload_reference(sd)[0])


def _trainer(tmp_path, over=()):
    return Trainer(load_config("synthetic_cfg", BASE + list(over) +
                               [f"train.checkpoints={tmp_path}"]), device="cpu")


def _jax_model(depth=3, num_classes=10, over=()):
    jcfg = jload_config("synthetic_cfg", BASE + [f"++model.depth={depth}", *over])
    jcfg.model.in_channel_names = jcfg.dataset.in_channel_names
    return jbuild_model(jcfg.model.name, jcfg.model, MAPPER, num_classes, dtype=jnp.float32)


def _jax_tx(pt):
    """The JAX optimizer for the port Trainer's config, as the JAX Trainer
    builds it before the key's wrapping (``trainer.py:256-317``)."""
    cfg = pt.cfg
    opt = dict(cfg.optimizer.params.to_dict())
    lr = jsched.make_lr_schedule(cfg.scheduler.name, float(opt["lr"]),
                                 cfg.scheduler.params.to_dict(), num_epochs=pt.total_epochs,
                                 steps_per_epoch=pt.updates_per_epoch)
    return jmake_optimizer(cfg.optimizer.name, opt, lr_schedule=lr,
                           total_steps=pt.total_epochs * pt.updates_per_epoch,
                           clip_grad_norm=cfg.train.clip_grad_norm)


def _batches(pt):
    pt.train_loader.set_epoch(1)
    return [{"image": b["image"], "label": b["label"]} for b in pt.train_loader]


def _port_epoch(pt):
    """The port Trainer's epoch 1, each step's metrics recorded."""
    steps = []
    run = pt._train_one_batch_regular

    def record(batch):
        out = run(batch)
        steps.append(out)
        return out

    pt._train_one_batch_regular = record
    pt.train_one_epoch(1)
    return steps


def _jax_run(grad_step, tx, params, batches):
    """JAX's train step around its jitted gradient: the gradients' global
    norm, then the optimizer's update (``make_train_step``), jitted too."""
    opt_state = tx.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.global_norm(grads), optax.apply_updates(params, updates), opt_state

    steps = []
    for i, b in enumerate(batches):
        grads, metrics = grad_step(params, {"image": jnp.asarray(b["image"]),
                                            "label": jnp.asarray(b["label"])},
                                   jax.random.key(i))
        metrics = {k: float(v) for k, v in metrics.items()}
        norm, params, opt_state = update(grads, opt_state, params)
        metrics["grad_norm"] = float(norm)
        steps.append(metrics)
    return steps, params


def _hold_steps(got, want, keys=("loss", "main_loss", "grad_norm")):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=f"step {i} {k}")


def _hold_params(model, jparams, skip=()):
    want = params_from_jax(jax.device_get(jparams))
    live = model.state_dict()
    for k, v in want.items():
        if k not in skip:
            np.testing.assert_allclose(live[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)


DP_RATE = 0.3
DROP = [f"++model.drop_path_rate={DP_RATE}"]  # blocks at 0, 0.15, 0.3


def _drop_masks(batch):
    """Fixed per-sample masks for blocks 1 and 2 (block 0's rate is 0), some
    samples dropped in each."""
    rng = np.random.default_rng(11)
    masks = {}
    for blk in (1, 2):
        for name in ("drop_path1", "drop_path2"):
            m = rng.random(batch) < 1.0 - DP_RATE * blk / 2
            m[0], m[1] = False, True
            masks[f"block_{blk}", name] = m
    return masks


MASKS = _drop_masks(16)
# the same masks as the port's draw_drop_path list
PORT_MASKS = [None] + [tuple(torch.from_numpy(MASKS[f"block_{b}", n])
                             for n in ("drop_path1", "drop_path2")) for b in (1, 2)]


@pytest.fixture(scope="module")
def base_grad_step():
    """One compiled JAX gradient function of the depth-3 model with DropPath
    at ``DP_RATE`` (CE, no sampling), its ``DropPath.__call__`` patched to
    apply :data:`MASKS` while it is traced; shared by the DropPath steps and
    the configurations that change only the optimizer."""

    def fixed(self, x, *, train, rate_override=None):
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        m = jnp.asarray(MASKS[self.parent.name, self.name]).reshape(
            (x.shape[0],) + (1,) * (x.ndim - 1))
        return jnp.where(m, x / keep, 0.0).astype(x.dtype)

    grad_step = jax.jit(jmake_grad_step(_jax_model(over=DROP), channel_ids=CIDS,
                                        loss_type="ce"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvit.DropPath, "__call__", fixed)
        grad_step(*_jax_params_and_batch())  # traced here, with the masks
    return grad_step


def _jax_params_and_batch():
    cfg = load_config("synthetic_cfg", BASE + DROP)
    cfg.model.in_channel_names = cfg.dataset.in_channel_names
    model = build_model("dichavit", cfg.model, MAPPER, 10, device="cpu")
    x = np.zeros((16, 8, 32, 32), np.float32)
    return (_jax_params(model), {"image": jnp.asarray(x), "label": jnp.zeros(16, jnp.int32)},
            jax.random.key(0))


# --------------------------------------------------------------------- freeze

FREEZE_CASES = [dict(freeze_other=True), dict(unfreeze_last_n_layers=0),
                dict(unfreeze_last_n_layers=2),
                dict(unfreeze_last_n_layers=1, unfreeze_first_layer=False),
                dict(freeze_other=True, unfreeze_last_n_layers=1)]


@pytest.mark.parametrize("kw", FREEZE_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in
                                                                      kw.items()))
def test_freeze_labels_equal_jax(kw):
    """The port's labels by its own parameter names equal JAX's
    ``build_trainable_labels`` on the same model, carried through
    ``params_from_jax`` (a label tree of 1 = train, 0 = freeze)."""
    cfg = load_config("synthetic_cfg", BASE)
    cfg.model.in_channel_names = cfg.dataset.in_channel_names
    model = build_model("dichavit", cfg.model, {"train": CIDS}, 10, device="cpu")
    params = _jax_params(model)
    jlabels = jfreeze.build_trainable_labels(params, **kw)
    as_num = jax.tree_util.tree_map(
        lambda lab, p: np.full(np.shape(p), lab == "train", np.float32), jlabels, params)
    want = params_from_jax(as_num)
    got = build_trainable_labels(model.named_parameters(), **kw)
    assert set(got) <= set(want)
    for name, label in got.items():
        assert {float(v) for v in want[name].unique()} == {1.0 if label == "train" else 0.0}, name
    assert "freeze" in got.values() and "train" in got.values()


@pytest.mark.parametrize("over", [["++model.unfreeze_last_n_layers=2"],
                                  ["++model.freeze_other=True"]], ids=["last2", "freeze_other"])
def test_frozen_steps_equal_jax(over, base_grad_step, tmp_path, monkeypatch):
    """Three steps through the port's Trainer with the key against JAX's
    step with ``masked_optimizer``: the losses and the logged ``grad_norm``
    (every gradient, frozen ones included) equal JAX's, every trained
    parameter within the tolerance, every frozen one unchanged. DropPath is
    on, with the masks of the shared gradient function (the port's draw
    patched to give them)."""
    grad_step = base_grad_step
    monkeypatch.setattr(ChannelVisionTransformer, "draw_drop_path",
                        lambda self, batch, generator=None, device=None: PORT_MASKS)
    pt = _trainer(tmp_path, over + DROP)
    assert pt.state.frozen
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    params = _jax_params(pt.model)
    labels = jfreeze.build_trainable_labels(
        params, freeze_other=bool(pt.cfg.model.get("freeze_other")),
        unfreeze_last_n_layers=int(pt.cfg.model.get("unfreeze_last_n_layers")),
        unfreeze_first_layer=True)
    tx = jfreeze.masked_optimizer(_jax_tx(pt), labels, unfreeze_last_n_layers=max(
        0, int(pt.cfg.model.get("unfreeze_last_n_layers"))))
    want, jparams = _jax_run(grad_step, tx, params, _batches(pt))
    got = _port_epoch(pt)
    _hold_steps(got, want)
    _hold_params(pt.model, jparams)
    after = pt.model.state_dict()
    for name in pt.state.frozen:
        assert torch.equal(after[name], before[name]), name
    moved = [n for n in after if n not in pt.state.frozen and not torch.equal(after[n],
                                                                               before[n])]
    assert moved and not any(pt.state.optimizer.state.get(p) for n, p in
                             pt.model.named_parameters() if n in pt.state.frozen)


# ----------------------------------------------------------------------- MIRO


@pytest.fixture(scope="module")
def miro_runs(tmp_path_factory):
    """The port's Trainer with MIRO (miro_lr_mult 10, miro_ld 0.01) against
    JAX's MIRO step with the encoders' ``multi_transform`` partition."""
    pt = _trainer(tmp_path_factory.mktemp("miro"), ["++train.miro=True", "++model.depth=2"])
    jmodel = _jax_model(depth=2)
    params = _jax_params(pt.model)
    pre = jax.tree_util.tree_map(jnp.copy, params)
    sample = jnp.zeros((2, 8, 32, 32), jnp.float32)
    encoders = jmiro.init_encoders(jmodel, params, sample, jnp.asarray(CIDS))
    params[jmiro.MIRO_KEY] = encoders
    base = _jax_tx(pt)
    mult = float(pt.cfg.train.get("miro_lr_mult", 10.0) or 10.0)
    tx = optax.multi_transform(
        {"base": base, "miro": optax.chain(base, optax.scale(mult))},
        lambda p: jax.tree_util.tree_map_with_path(
            lambda path, _: "miro" if any(getattr(k, "key", None) == jmiro.MIRO_KEY
                                          for k in path) else "base", p))
    grad_step = jax.jit(jmake_grad_step(jmodel, channel_ids=CIDS, loss_type="ce",
                                        miro_pre_params=pre, miro_ld=pt.miro_ld))
    batches = _batches(pt)
    model0 = copy.deepcopy(pt.model)
    want, jparams = _jax_run(grad_step, tx, params, batches)
    got = _port_epoch(pt)
    return pt, jmodel, pre, encoders, model0, batches, want, jparams, got


def test_miro_taps_and_encoders_equal_jax(miro_runs):
    """Tap names and shapes (the MIRO runs are at depth 2): every block's
    output at the 129 tokens, the last block's included (JAX's capture turns the CLS-only readout off);
    the encoders' initial biases and shapes equal JAX's ``init_encoders``."""
    pt, jmodel, pre, encoders, model0, batches, *_ = miro_runs
    x = batches[0]["image"][:2]
    _, _, jtaps = jax.eval_shape(
        lambda p, xx: jmiro.forward_with_taps(jmodel, p, xx, jnp.asarray(CIDS), train=True,
                                              rngs={"dropout": jax.random.key(0)}), pre, x)
    taps = {}
    model0.train()
    with torch.no_grad():
        model0(torch.from_numpy(x), torch.tensor(CIDS), taps=taps)
    assert list(jtaps) == [f"backbone/block_{i}/__call__/[0]" for i in range(2)]
    assert {k: tuple(v.shape) for k, v in taps.items()} == {
        f"block_{i}": tuple(jtaps[f"backbone/block_{i}/__call__/[0]"].shape) for i in range(2)}
    assert all(tuple(v.shape) == (2, 129, 64) for v in taps.values())
    fresh = init_encoders(model0)
    for i in range(2):
        np.testing.assert_array_equal(fresh[f"block_{i}"].detach().numpy(),
                                      np.asarray(encoders[f"backbone/block_{i}/__call__/[0]"]))


def test_miro_vlb_equals_jax():
    rng = np.random.default_rng(3)
    names = [f"block_{i}" for i in (0, 1, 10, 2)]
    feats = {n: rng.normal(size=(2, 5, 8)).astype(np.float32) for n in names}
    pre = {n: rng.normal(size=(2, 5, 8)).astype(np.float32) for n in names}
    enc = {n: rng.normal(size=(1, 1, 8)).astype(np.float32) for n in names}
    want = float(jmiro.miro_vlb({k: jnp.asarray(v) for k, v in enc.items()},
                                {k: jnp.asarray(v) for k, v in feats.items()},
                                {k: jnp.asarray(v) for k, v in pre.items()}))
    t = {k: torch.from_numpy(v) for k, v in enc.items()}
    got = miro_vlb(t, {k: torch.from_numpy(v) for k, v in feats.items()},
                   {k: torch.from_numpy(v) for k, v in pre.items()})
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_miro_steps_equal_jax(miro_runs):
    """Three MIRO steps: main loss, ``grad_norm`` (the encoders' gradients
    included) and every parameter, encoders included (their lr 10 times the
    others', clipped by their own norm), against JAX; ``miro_loss`` to JAX's
    and at step 0 to its exact value (see the module docstring)."""
    pt, jmodel, pre, *_, batches, want, jparams, got = miro_runs
    _hold_steps(got, want, keys=("main_loss", "grad_norm"))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["miro_loss"], w["miro_loss"], rtol=1e-4)
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
    _hold_params(pt.model, jparams)
    # step 0's miro_loss exactly: pre and live taps are equal, so the loss
    # is 2 taps x log(softplus(b0) + 1e-5) / 2
    b0 = float(np.log(np.exp(0.1 - 1e-5) - 1.0))
    var = np.log1p(np.exp(np.float32(b0).astype(np.float64))) + 1e-5
    np.testing.assert_allclose(got[0]["miro_loss"], np.log(var), rtol=2e-6)
    assert got[-1]["miro_loss"] > got[0]["miro_loss"]  # the live model moved off pre
    moved = pt.model.miro_encoders["block_0"].detach().numpy()
    assert not np.allclose(moved, b0)


# ------------------------------------------------------------------- DropPath


def test_drop_path_steps_equal_jax(base_grad_step):
    """Three f32 steps with ``drop_path_rate`` 0.3 (blocks at 0, 0.15, 0.3;
    block 2 is the CLS-only readout) and the same per-sample masks: JAX's
    ``DropPath.__call__`` patched to take them, the port's step given them
    as ``draws["drop_path"]``."""
    cfg = load_config("synthetic_cfg", BASE + DROP)
    cfg.model.in_channel_names = cfg.dataset.in_channel_names
    mapper = MAPPER
    model = build_model("dichavit", cfg.model, mapper, 10, device="cpu", seed=5)
    assert [b.drop_path for b in model.feature_extractor.blocks] == [0.0, 0.15, 0.3]
    params = _jax_params(model)
    lr = make_lr_schedule("none", 2e-3, {}, num_epochs=1, steps_per_epoch=3)
    opt = dict(lr=2e-3, betas=[0.9, 0.999], eps=1e-6, weight_decay=0.04, weight_decay_end=0.4)
    tx = jmake_optimizer("adamw", dict(opt), total_steps=3, clip_grad_norm=1.0,
                         lr_schedule=jsched.make_lr_schedule("none", 2e-3, {}, num_epochs=1,
                                                             steps_per_epoch=3))
    rng = np.random.default_rng(2)
    batches = [{"image": rng.normal(size=(16, 8, 32, 32)).astype(np.float32),
                "label": rng.integers(0, 10, 16)} for _ in range(3)]
    want, jparams = _jax_run(base_grad_step, tx, params, batches)
    state = TrainState(model, make_optimizer("adamw", dict(opt), lr_schedule=lr, total_steps=3,
                                             clip_grad_norm=1.0))
    step = make_train_step(model, channel_ids=CIDS)
    draws = {"drop_path": PORT_MASKS}
    got = []
    for b in batches:
        state, m = step(state, {"image": torch.from_numpy(b["image"]),
                                "label": torch.from_numpy(b["label"])}, draws)
        got.append({k: float(v) for k, v in m.items()})
    _hold_steps(got, want)
    _hold_params(model, jparams)
    # the masks matter: without them the step draws its own and trains apart
    model2 = build_model("dichavit", cfg.model, mapper, 10, device="cpu", seed=5)
    state2 = TrainState(model2, make_optimizer("adamw", dict(opt), lr_schedule=lr,
                                               total_steps=3, clip_grad_norm=1.0))
    _, m2 = make_train_step(model2, channel_ids=CIDS)(state2, {
        "image": torch.from_numpy(batches[0]["image"]),
        "label": torch.from_numpy(batches[0]["label"])})
    assert float(m2["loss"]) != got[0]["loss"]


def test_drop_path_fused_route_equals_unfused_bf16():
    """In bf16 the blocks take the fused route (``attend_project`` without
    ``x_res``, ``ln_mlp`` with ``residual=False``, the masked branches added
    after): a train forward and backward with the same masks equal the
    unfused route's (``attention_impl: xla``) within bf16 rounding."""
    cfg = load_config("synthetic_cfg", BASE + [f"++model.drop_path_rate={DP_RATE}"])
    cfg.model.in_channel_names = cfg.dataset.in_channel_names
    cfg.model.embed_dim, cfg.model.num_heads = 128, 2
    out = {}
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(4, 8, 32, 32))
                         .astype(np.float32))
    for impl in ("auto", "xla"):
        cfg.model.attention_impl = impl
        model = build_model("dichavit", cfg.model, {"train": CIDS}, 10, device="cpu",
                            dtype=torch.bfloat16, seed=1).train()
        masks = model.feature_extractor.draw_drop_path(4, torch.Generator().manual_seed(0))
        assert masks[0] is None and not all(bool(m.all()) for pair in masks[1:] for m in pair)
        logits, _ = model(x, torch.tensor(CIDS), drop_path=masks)
        logits.float().sum().backward()
        out[impl] = (logits.float().detach(), model.feature_extractor.blocks[1].mlp.fc1.weight
                     .grad.clone())
    (la, ga), (lx, gx) = out["auto"], out["xla"]
    assert (la - lx).abs().max() <= 2e-2 * lx.abs().max()
    assert (ga - gx).abs().max() <= 5e-2 * gx.abs().max()


# ----------------------------------------------------------------- pretrained


def test_pretrained_warm_start_equals_jax(tmp_path):
    """``model.pretrained``: a reference checkpoint written by JAX's
    ``save_reference_checkpoint`` from a model with a head of another width
    (7 classes, the synthetic config's 10), read by the port's Trainer and by
    JAX's ``load_reference_checkpoint`` + ``merge_into_template``: equal
    tensors; the head and proxies keep the fresh init; a checkpoint of
    another width fits nothing and raises ``ValueError``."""
    cfg = load_config("synthetic_cfg", BASE)
    cfg.model.in_channel_names = cfg.dataset.in_channel_names
    mapper = MAPPER
    src = build_model("dichavit", cfg.model, mapper, 7, device="cpu", seed=9)
    path = str(tmp_path / "ref.pth")
    save_reference_checkpoint(path, _jax_params(src), epoch=4, accuracy=0.5)
    fresh = _trainer(tmp_path / "a")
    warm = _trainer(tmp_path / "b", [f"++model.pretrained={path}"])
    merged, loaded, kept = jmerge(_jax_params(fresh.model), jload_reference(path)[0])
    assert loaded and kept
    want = params_from_jax(merged)
    got = warm.model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k in ("proxies", "classifer_head.weight", "classifer_head.bias"):
        assert torch.equal(got[k], fresh.model.state_dict()[k])
    assert torch.equal(got["feature_extractor.blocks.2.attn.qkv.weight"],
                       src.state_dict()["feature_extractor.blocks.2.attn.qkv.weight"])
    sd, meta = load_reference_checkpoint(path)
    assert meta == {"epoch": 4, "accuracy": 0.5} and "proxies" in sd
    # pretrained=True names the file through pretrained_ckpt (JAX trainer.py:352-357)
    also = _trainer(tmp_path / "c", ["++model.pretrained=True", f"++model.pretrained_ckpt={path}"])
    assert torch.equal(also.model.state_dict()["feature_extractor.pos_embed"], got[
        "feature_extractor.pos_embed"])
    cfg.model.embed_dim = 128
    other = build_model("dichavit", cfg.model, mapper, 7, device="cpu", seed=9)
    path2 = str(tmp_path / "other.pth")
    save_reference_checkpoint(path2, _jax_params(other))
    with pytest.raises(ValueError, match="no tensor of the checkpoint fits"):
        _trainer(tmp_path / "d", [f"++model.pretrained={path2}"])
