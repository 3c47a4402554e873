"""The ``base`` width (DiChaViT-B: D = 768 in 12 heads of 64, MLP 3072)
against the JAX package, and the port's geometry smoke script.

- A base-width DiChaViT at depth 2 (block 0 a full block, block 1 the CLS
  readout), two channels at 32^2 with patch 16 (N = 9 tokens), 5 classes,
  B = 2, with CE + CDL + TDL. The JAX model is initialised from a key, its
  biases and LayerNorm affines moved off 0 and 1, and the port's model is
  built from the same tree through ``params_from_jax``.
  - bf16 logits: rel <= 3e-2 (both packages round in bf16 at slightly other
    points, as tests/test_torch_model.py holds the 384-wide logits).
  - Three f32 AdamW steps through each package's ``make_train_step``: the
    losses within rtol 1e-5 at step 0 and 1e-4 after, and every step-0
    gradient within 1e-4 of max|g| of the JAX one (the same f32 arithmetic
    in other orders, the bounds of tests/test_torch_training.py); the
    gradients' global norm, a sum over 14M squares at this width, within
    rtol 1e-4 at every step.
- ``scripts/smoke_geometries.smoke`` on the CPU at a tiny geometry (depth
  1, D = 128, two heads, B = 2), with and without channel sampling: two
  finite losses, no kernel launched; without a card the script's default
  device raises.

torch is pinned to one thread in each test (the driver runs the suite on
several workers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.models import channel_vit as jcv
from diverse_channel_vit_tpu.models.wrappers import ChannelAdaptiveClassifier as JClassifier
from diverse_channel_vit_tpu.training import create_train_state
from diverse_channel_vit_tpu.training import make_optimizer as j_make_optimizer
from diverse_channel_vit_tpu.training import schedules as jsched
from diverse_channel_vit_tpu.training.steps import _loss_and_metrics as j_loss_and_metrics
from diverse_channel_vit_tpu.training.steps import make_train_step as j_make_train_step
from diverse_channel_vit_torch.models.channel_vit import SIZE_PRESETS, ChannelVisionTransformer
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.models.wrappers import ChannelAdaptiveClassifier
from diverse_channel_vit_torch.scripts import smoke_geometries
from diverse_channel_vit_torch.training import (
    TrainState,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

BASE = SIZE_PRESETS["base"]
C, IMG, P, DEPTH, NC, BATCH = 2, 32, 16, 2, 5, 2
D, H = BASE["embed_dim"], BASE["num_heads"]
IDS = [0, 1]
LOSS_KW = dict(proxy_loss_lambda=1e-3, ortho_loss_v1_lambda=1e-3, gamma_s=1.0, gamma_d=4.0)
OPT = dict(lr=1e-3, betas=[0.9, 0.999], eps=1e-6, weight_decay=0.04, weight_decay_end=0.4)
LR_PARAMS = dict(t_initial=4, lr_min=1e-6, warmup_t=0)
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(dtype):
    bb = jcv.ChannelVisionTransformer(num_total_channels=C, img_size=IMG, patch_size=P,
                                      embed_dim=D, depth=DEPTH, num_heads=H, dtype=dtype,
                                      **LOSS_KW)
    return JClassifier(backbone=bb, embed_dim=D, num_classes=NC, with_head=True)


def _port_model(dtype, state_dict):
    bb = ChannelVisionTransformer(C, IMG, P, D, DEPTH, H, dtype=dtype, **LOSS_KW)
    model = ChannelAdaptiveClassifier(bb, D, NC, with_head=True)
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module")
def start():
    assert (D, H, BASE["depth"]) == (768, 12, 12)  # the preset the JAX factory mirrors
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(BATCH, C, IMG, IMG)).astype(np.float32) for _ in range(3)]
    ys = [rng.integers(0, NC, size=BATCH) for _ in range(3)]
    model = _jax_model(jnp.float32)
    params = jax.jit(lambda x: model.init({"params": jax.random.key(0)}, x, jnp.asarray(IDS),
                                          train=False))(jnp.asarray(xs[0]))["params"]
    # LayerNorm affines and biases start at 1/0: move them off so they count
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    moved = [
        np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)
        if any(getattr(k, "key", "") in ("bias", "scale", "proj_bias") for k in path)
        else np.asarray(a)
        for path, a in leaves
    ]
    return xs, ys, jax.tree_util.tree_unflatten(tree, moved)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_base_logits_bf16_match_jax(start):
    xs, _, params = start
    jmodel = _jax_model(jnp.bfloat16)
    want, _ = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, jnp.asarray(IDS),
                                                train=False))(params, jnp.asarray(xs[0]))
    model = _port_model(torch.bfloat16, params_from_jax(params)).eval()
    with torch.no_grad():
        got, _ = model(torch.from_numpy(xs[0]), torch.tensor(IDS))
    assert got.shape == (BATCH, NC)
    assert _rel(got.float().numpy(), want) <= 3e-2


def test_base_three_train_steps_f32_match_jax(start):
    xs, ys, params = start
    jmodel = _jax_model(jnp.float32)

    def jloss(p):
        return j_loss_and_metrics(jmodel, p, jnp.asarray(xs[0]), jnp.asarray(IDS),
                                  jnp.asarray(ys[0]), jax.random.key(0), loss_type="ce",
                                  extra_loss_lambda=1.0, learnable_temp=False,
                                  temperature=0.11111)

    _, jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want_grads = params_from_jax(jax.device_get(jgrads))
    jtx = j_make_optimizer("adamw", dict(OPT), total_steps=3, lr_schedule=jsched.make_lr_schedule(
        "cosine", LR, dict(LR_PARAMS), num_epochs=4, steps_per_epoch=1))
    jstate = create_train_state(jmodel, jtx, rng=jax.random.key(1), sample_input=None,
                                sample_channel_ids=None, params=params)
    jstep = j_make_train_step(jmodel, channel_ids=IDS, loss_type="ce", extra_loss_lambda=1.0,
                              donate=False)

    model = _port_model(torch.float32, params_from_jax(params))
    tx = make_optimizer("adamw", dict(OPT), total_steps=3, lr_schedule=make_lr_schedule(
        "cosine", LR, dict(LR_PARAMS), num_epochs=4, steps_per_epoch=1))
    state = TrainState(model, tx)
    step = make_train_step(model, channel_ids=IDS, loss_type="ce", extra_loss_lambda=1.0)
    got, want = [], []
    for t in range(3):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(xs[t]), "label": jnp.asarray(ys[t])},
                           jax.random.key(t))
        state, m = step(state, {"image": torch.from_numpy(xs[t]),
                                "label": torch.from_numpy(ys[t])})
        if t == 0:
            for name, p in model.named_parameters():
                w = want_grads[name].numpy()
                scale = np.abs(w).max()
                if not scale:  # the class proxies: unused by the CE loss
                    assert not p.grad.abs().max(), name
                    continue
                assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * scale, name
        want.append([float(jm[k]) for k in ("loss", "main_loss", "extra_loss", "grad_norm")])
        got.append([float(m[k]) for k in ("loss", "main_loss", "extra_loss", "grad_norm")])
    assert float(m["extra_loss"]) > 0  # CDL and TDL are on
    np.testing.assert_allclose(np.asarray(got)[0, :3], np.asarray(want)[0, :3], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("k", [None, 2])
def test_smoke_geometry_runs_on_the_cpu(k):
    """The script's ``smoke`` at a tiny geometry: 1 + 5 steps, two finite
    losses (the script asserts them), no kernel launched on the CPU."""
    c = 3 if k else 2
    r = smoke_geometries.smoke("tiny", c=c, img=32, dim=128, depth=1, heads=2, batch=2,
                               loss_type="proxy" if k else "ce", with_head=not k, k=k,
                               device="cpu")
    assert np.isfinite(r["loss0"]) and np.isfinite(r["loss1"])
    assert r["steps"] == 6 and r["ms_per_step"] > 0 and r["peak_mem_gb"] is None
    assert not any(r["launches"].values())


def test_smoke_geometries_are_the_jax_scripts():
    """The five geometries of the JAX script's ``__main__``, in its order,
    at its batch sizes; the script runs on the card unless told otherwise."""
    tags = [t for t, _ in smoke_geometries.GEOMETRIES]
    assert tags == ["chammi12 proxy+TDL ViT-S", "chammi12 DCS k=5", "base D=768 jump_cp",
                    "dh128 jump_cp", "so2sat 18ch p8"]
    geo = dict(smoke_geometries.GEOMETRIES)
    assert [geo[t]["batch"] for t in tags] == [32, 32, 16, 64, 128]
    assert geo["base D=768 jump_cp"]["dim"] == D and geo["base D=768 jump_cp"]["heads"] == H
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            smoke_geometries.smoke("tiny", c=2, img=32, dim=128, depth=1, heads=2, batch=2,
                                   loss_type="ce", with_head=True)
