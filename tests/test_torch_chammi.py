"""CHAMMI's accumulated step in the port against the JAX package's, on the
CPU: three mixed batches (Allen 3, HPA 4 and CP 5 of the 12 channels, two
images each) through a tiny DiChaViT (the ``test`` preset at 32², patch 8,
f32, the XLA route on the JAX side) with the proxy loss over 14 proxies,
CDL/TDL, ``proxy_loss_lambda`` and ``ortho_loss_v1_lambda``, and AdamW at
eps 1e-6 (the key bias has no true gradient, tests/test_torch_trainer.py).
JAX: ``make_grad_step`` per chunk, ``tree_add``, ``make_apply_step``; the
port: its ``make_grad_step`` per chunk into ``.grad`` and one
``apply_gradients``, from the same weights (the port's seeded model, carried
to JAX by the JAX package's reference-checkpoint importer). Per-chunk losses
within rtol 1e-5 at step 0 and 1e-4 after, the summed gradient's norm within
rtol 1e-4, every parameter within lr / 10 of JAX's after the three updates.

The benchmark, ``channelvit_adapt`` and ``main`` on a CHAMMI fixture are in
tests/test_torch_chammi_eval.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.config import load_config as jload_config
from diverse_channel_vit_tpu.models import build_model as jbuild_model
from diverse_channel_vit_tpu.models.import_torch import load_reference_checkpoint
from diverse_channel_vit_tpu.training import create_train_state
from diverse_channel_vit_tpu.training import make_optimizer as j_make_optimizer
from diverse_channel_vit_tpu.training.steps import make_apply_step, tree_add
from diverse_channel_vit_tpu.training.steps import make_grad_step as j_make_grad_step
from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.models import build_model
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.trainer import build_mapper
from diverse_channel_vit_torch.training import TrainState, make_grad_step, make_optimizer

TINY = ["dataset=morphem70k_v2_12channels", "++dataset.img_size=32", "++model.img_size=[32]",
        "++model.patch_size=8", "++model.pretrained_model_name=test",
        "++model.attention_impl=xla", "++model.temperature=0.07",
        "++model.proxy_loss_lambda=0.1", "++model.ortho_loss_v1_lambda=1"]
OPT = dict(lr=1e-3, betas=[0.9, 0.999], eps=1e-6, weight_decay=0.05)
LR = OPT["lr"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


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


def test_three_accumulated_proxy_steps_f32_match_jax():
    cfg, jcfg = _model_cfgs("dichavit")
    mapper = build_mapper(cfg)
    assert "Allen" in mapper
    rng = np.random.default_rng(0)
    jmodel = jbuild_model("dichavit", jcfg.model, mapper, 14, dtype=jnp.float32)
    model, params = _start("dichavit", cfg, mapper, 14, rng)
    assert model.classifer_head is None and model.proxies.shape == (14, 64)
    batches = [{c: {"image": rng.normal(size=(2, len(ids), 32, 32)).astype(np.float32),
                    "label": rng.integers(0, 14, size=2)} for c, ids in mapper.items()}
               for _ in range(3)]
    lr = lambda step: LR  # noqa: E731
    jtx = j_make_optimizer("adamw", dict(OPT), lr_schedule=lr, total_steps=3)
    jstate = create_train_state(jmodel, jtx, rng=jax.random.key(1), sample_input=None,
                                sample_channel_ids=None, params=params)
    kw = dict(loss_type="proxy", extra_loss_lambda=1.0, temperature=0.07)
    jgrad = {c: j_make_grad_step(jmodel, channel_ids=ids, **kw) for c, ids in mapper.items()}
    japply = make_apply_step(donate=False)

    state = TrainState(model, make_optimizer("adamw", dict(OPT), lr_schedule=lr, total_steps=3))
    grad = {c: make_grad_step(model, channel_ids=ids, **kw) for c, ids in mapper.items()}
    got, want = [], []
    for t, batch in enumerate(batches):
        grads, row = None, []
        for ci, (chunk, sub) in enumerate(batch.items()):
            g, m = jgrad[chunk](jstate.params, jax.tree_util.tree_map(jnp.asarray, sub),
                                jax.random.key(10 * t + ci))
            grads = g if grads is None else tree_add(grads, g)
            row += [float(m["loss"]), float(m["main_loss"]), float(m["extra_loss"])]
        jstate, gnorm = japply(jstate, grads)
        want.append(row + [float(gnorm)])
        state.optimizer.zero_grad(set_to_none=True)
        row = []
        for chunk, sub in batch.items():
            m = grad[chunk]({"image": torch.from_numpy(sub["image"]),
                             "label": torch.from_numpy(sub["label"])})
            assert "grad_norm" not in m
            row += [float(m["loss"]), float(m["main_loss"]), float(m["extra_loss"])]
        got.append(row + [float(state.apply_gradients())])
    assert state.step == 3 and all(v > 0 for v in got[0][2:9:3])  # CDL and TDL are on
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got)[:, :9], np.asarray(want)[:, :9], rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got)[:, 9], np.asarray(want)[:, 9], rtol=1e-4)
    final = params_from_jax(jax.device_get(jstate.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=LR / 10, rtol=0,
                                   err_msg=k)
