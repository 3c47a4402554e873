"""The port's training path against the JAX package's.

- Schedules: the timm cosine and multistep lr schedules and the cosine
  weight-decay schedule, at many steps, against the JAX functions. JAX
  computes them in f32 and the port in double precision; the cosine and the
  k_decay power carry the f32 rounding to about 1e-6: rtol 5e-6.
- AdamW: three updates of random parameters with the cosine weight decay and
  clipping by global norm, against the optax chain of ``make_optimizer``
  (``scale_by_adam`` -> ``add_scheduled_weight_decay`` -> ``-lr``). Same f32
  arithmetic in another order: rtol 1e-5 on parameters and norms.
- The slice as a whole: the tiny DiChaViT of tests/test_torch_model.py (7 of
  8 channels at 48^2, so N = 64 tokens, D = 128, 2 heads, depth 3, 5 classes,
  B = 2) with CE + CDL + TDL, starts from the same ``params_from_jax``
  weights in both packages and takes three AdamW steps through each
  package's ``make_train_step``.
  - f32, against the unfused JAX route: loss rtol 1e-5 at step 0 and 1e-4
    after (the bounds tests/test_trajectory_parity.py holds the JAX step to
    against torch); final parameters within atol lr / 10 (an Adam step moves
    an entry by at most about lr, and the two gradients agree to f32
    rounding).
  - bf16 with ``fused_block.FORCE_ON_CPU``, against the fused JAX route whose
    attend_project and ln_mlp backward kernels run in interpret mode: the
    step-0 loss within rel 3e-2 of the JAX one, and every parameter's
    gradient within rel 3e-2 (max|diff| / max|ref|) of the JAX f32 gradient
    and within 3e-2 plus the JAX bf16 route's own distance from that f32
    gradient of the JAX bf16 one. The second bound widens only where the
    JAX route itself strays: it sums the patch-embedding and last-block qkv
    bias gradients in bf16, 4.1% and 3.4% from f32 at this size, where the
    port's sums stay within 1% (ROADMAP C). Elsewhere both sides round in
    bf16 at slightly different points through three blocks, as
    tests/test_torch_model.py holds the logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diverse_channel_vit_tpu.models import channel_vit as jcv
from diverse_channel_vit_tpu.models.wrappers import ChannelAdaptiveClassifier as JClassifier
from diverse_channel_vit_tpu.ops import fused_block as jfb
from diverse_channel_vit_tpu.ops import token_pruning as jtp
from diverse_channel_vit_tpu.training import create_train_state
from diverse_channel_vit_tpu.training import make_optimizer as j_make_optimizer
from diverse_channel_vit_tpu.training import schedules as jsched
from diverse_channel_vit_tpu.training.steps import _loss_and_metrics as j_loss_and_metrics
from diverse_channel_vit_tpu.training.steps import make_train_step as j_make_train_step
from diverse_channel_vit_torch.models.channel_vit import ChannelVisionTransformer
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.models.wrappers import ChannelAdaptiveClassifier
from diverse_channel_vit_torch.training import (
    TrainState,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    wd_cosine_schedule,
)

STEPS = np.arange(0, 400, 7)


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


@pytest.mark.parametrize("name,params,spe", [
    ("cosine", dict(t_initial=10, lr_min=1e-6, cycle_decay=0.5, warmup_t=3,
                    warmup_lr_init=1e-5), 13),
    ("cosine", dict(t_initial=20, warmup_t=2, warmup_lr_init=1e-5, t_in_epochs=False), 1),
    ("cosine", dict(t_initial=5, cycle_mul=2.0, cycle_limit=3, cycle_decay=0.5, k_decay=1.5,
                    warmup_t=2, warmup_prefix=True), 9),
    ("multistep", dict(decay_t=[3, 6, 8], decay_rate=0.2, warmup_t=1), 11),
    ("none", {}, 1),
])
def test_lr_schedules_match_jax(name, params, spe):
    kw = dict(num_epochs=10, steps_per_epoch=spe, convert_to_batch=name == "multistep")
    got = make_lr_schedule(name, 2.5e-4, dict(params), **kw)
    want = jsched.make_lr_schedule(name, 2.5e-4, dict(params), **kw)
    np.testing.assert_allclose([got(int(s)) for s in STEPS],
                               [float(want(int(s))) for s in STEPS], rtol=5e-6)


def test_wd_schedule_matches_jax():
    got, want = wd_cosine_schedule(0.04, 0.4, 300), jsched.wd_cosine_schedule(0.04, 0.4, 300)
    np.testing.assert_allclose([got(int(s)) for s in STEPS],
                               [float(want(int(s))) for s in STEPS], rtol=5e-6)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_matches_optax_chain(clip):
    rng = np.random.default_rng(0)
    shapes = [(6, 5), (5,), (3, 2, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
    opt_params = dict(lr=2.5e-4, betas=[0.9, 0.999], eps=1e-6, weight_decay=0.04,
                      weight_decay_end=0.4)
    lr_kw = dict(num_epochs=5, steps_per_epoch=2)
    lr_p = dict(t_initial=5, warmup_t=1, warmup_lr_init=1e-5)

    jtx = j_make_optimizer("adamw", dict(opt_params), total_steps=6, clip_grad_norm=clip,
                           lr_schedule=jsched.make_lr_schedule("cosine", 1e-2, lr_p, **lr_kw))
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tx = make_optimizer("adamw", dict(opt_params), total_steps=6, clip_grad_norm=clip,
                        lr_schedule=make_lr_schedule("cosine", 1e-2, lr_p, **lr_kw))
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = tx.init(tp)
    for step, g in enumerate(grads):
        jg = [jnp.asarray(a) for a in g]
        want_norm = float(optax.global_norm(jg))
        upd, jstate = jtx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        norm = tx.update(opt, step)
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-5)
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "adam", "adamp"])
def test_optimizers_not_ported_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer(name, {}, lr_schedule=lambda s: 1e-3, total_steps=1)


def test_channel_sampling_raises_until_ported():
    """DCS is ported (tests/test_torch_sampling.py); the samplers that are
    not yet raise when the step is made."""
    for method in ("lowest_cosine_prob_proj", "lowest_cosine_prob_resnet34", "hcs_per_sample"):
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            make_train_step(torch.nn.Linear(1, 1), channel_ids=range(8), k=3, hcs_method=method)


@pytest.mark.parametrize("key", ["drop_path_rate", "drop_rate", "attn_drop_rate"])
def test_dropout_and_drop_path_are_refused(key):
    """DropPath (``drop_path_rate`` > 0) was refused until it was ported; now
    the factory builds it, its rate rising linearly over the blocks (JAX
    ``models/channel_vit.py:263``), and an eval forward gives the logits of
    a model without it (DropPath acts in training only;
    tests/test_torch_runtime.py holds its train steps against JAX). No JAX
    factory reads ``drop_rate`` or ``attn_drop_rate`` (JAX
    ``models/dichavit.py``), so JAX trains such a config without dropout:
    the port ignores both too, and a build with either at 0.1 gives the same
    logits as one without (ROADMAP C4)."""
    from diverse_channel_vit_torch.config import Config
    from diverse_channel_vit_torch.models import build_model

    def model(**extra):
        cfg = Config({"in_channel_names": ["a", "b"], "img_size": [IMG], "patch_size": P,
                      "pretrained_model_name": "test", **extra})
        return build_model("dichavit", cfg, {"x": [0, 1]}, NC, device="cpu", seed=0)

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 2, IMG, IMG))
                         .astype(np.float32))
    if key == "drop_path_rate":
        m = model(**{key: 0.1})
        depth = len(m.feature_extractor.blocks)
        assert [b.drop_path for b in m.feature_extractor.blocks] == [
            0.1 * i / max(depth - 1, 1) for i in range(depth)]
        got, want = (mm.eval()(x, torch.arange(2))[0] for mm in (m, model()))
        assert torch.equal(got, want)
        return
    got, want = (m.train()(x, torch.arange(2))[0] for m in (model(**{key: 0.1}), model()))
    assert torch.equal(got, want)


@pytest.mark.parametrize("key,value", [("dropout_tokens_hcs", "channel"),
                                       ("dropout_tokens_hcs", "random"),
                                       ("token_keep_channels", 4)])
def test_hcs_token_dropout_is_refused(key, value):
    """The JAX factory reads ``dropout_tokens_hcs`` and
    ``token_keep_channels`` (JAX ``models/dichavit.py:52,54``) and drops
    tokens or whole channels in training; until that is ported the port's
    factory refuses both (ROADMAP C2, A8.4)."""
    from diverse_channel_vit_torch.config import Config
    from diverse_channel_vit_torch.models import build_model

    cfg = Config({"in_channel_names": ["a", "b"], "img_size": [IMG], "patch_size": P,
                  "pretrained_model_name": "test", key: value})
    with pytest.raises(NotImplementedError, match="ROADMAP A8.4"):
        build_model("dichavit", cfg, {"x": [0, 1]}, NC, device="cpu")


def test_train_step_after_an_inference_forward():
    """Serving and training one model in one process: tables cached by an
    inference-mode forward must not reach the train step's autograd."""
    bb = ChannelVisionTransformer(8, 48, 16, 64, 1, 2, **LOSS_KW)
    model = ChannelAdaptiveClassifier(bb, 64, 3, with_head=True)
    x = torch.randn(2, 5, 48, 48)  # 5 channels: a pos-embed resample (C > 1)
    with torch.inference_mode():
        model.eval()(x, torch.arange(5))
    state = TrainState(model, make_optimizer("adamw", {}, lr_schedule=lambda s: 1e-3,
                                                    total_steps=1))
    step = make_train_step(model, channel_ids=range(5), extra_loss_lambda=1.0)
    _, m = step(state, {"image": x, "label": torch.tensor([0, 2])})
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


# --- the slice as a whole -------------------------------------------------

C, IMG, P, D, H, DEPTH, NC, BATCH = 8, 48, 16, 128, 2, 3, 5, 2
IDS = [0, 1, 2, 4, 5, 6, 7]  # 7 channels: N = 1 + 7 * 9 = 64 tokens
LOSS_KW = dict(proxy_loss_lambda=1e-3, ortho_loss_v1_lambda=1e-3, gamma_s=1.0, gamma_d=4.0)
OPT = dict(lr=1e-3, betas=[0.9, 0.999], eps=1e-6, weight_decay=0.04, weight_decay_end=0.4)
LR_PARAMS = dict(t_initial=4, lr_min=1e-6, warmup_t=0)
LR = 1e-3


# the slice's head width at a tiny size: 2 heads of 128 (D = 256), depth 2
DH128 = dict(d=256, h=2, depth=2)


def _jax_model(dtype, d=D, h=H, depth=DEPTH, **kw):
    bb = jcv.ChannelVisionTransformer(num_total_channels=C, img_size=IMG, patch_size=P,
                                      embed_dim=d, depth=depth, num_heads=h, dtype=dtype,
                                      **LOSS_KW, **kw)
    return JClassifier(backbone=bb, embed_dim=d, num_classes=NC, with_head=True)


def _port_model(dtype, state_dict, d=D, h=H, depth=DEPTH, **kw):
    bb = ChannelVisionTransformer(C, IMG, P, d, depth, h, dtype=dtype, **LOSS_KW, **kw)
    model = ChannelAdaptiveClassifier(bb, d, NC, with_head=True)
    model.load_state_dict(state_dict, strict=True)
    return model


def _start(**geom):
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(BATCH, len(IDS), IMG, IMG)).astype(np.float32) for _ in range(3)]
    ys = [rng.integers(0, NC, size=BATCH) for _ in range(3)]
    model = _jax_model(jnp.float32, **geom)

    def init(x):
        return model.init({"params": jax.random.key(0)}, x, jnp.asarray(IDS), train=False)

    # jitted: eager flax takes several times longer on the CPU
    params = jax.jit(init)(jnp.asarray(xs[0]))["params"]
    # LayerNorm affines and biases start at 1/0: move them off so they count
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    moved = [
        np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)
        if any(getattr(k, "key", "") in ("bias", "scale", "proj_bias") for k in path)
        else np.asarray(a)
        for path, a in leaves
    ]
    return xs, ys, jax.tree_util.tree_unflatten(tree, moved)


@pytest.fixture(scope="module")
def start():
    return _start()


@pytest.fixture(scope="module")
def start_dh128():
    return _start(**DH128)


def _jax_lr():
    return jsched.make_lr_schedule("cosine", LR, dict(LR_PARAMS), num_epochs=4,
                                   steps_per_epoch=1)


def _port_lr():
    return make_lr_schedule("cosine", LR, dict(LR_PARAMS), num_epochs=4, steps_per_epoch=1)


def test_three_train_steps_f32_match_jax(start, monkeypatch):
    _three_steps_f32(start, None, monkeypatch)


def test_three_train_steps_frozen_channel_emb_f32_match_jax(start, monkeypatch):
    """``freeze_channel_emb``: JAX stops the channel-embedding table's
    gradient (JAX ``models/channel_vit.py:172-173``), so neither CE nor CDL
    trains it and AdamW's weight decay alone moves it. Three steps as
    test_three_train_steps_f32_match_jax, and the table's update against the
    JAX one within a few f32 ulps of the table (the decay moves an entry by
    about lr * wd * |p|, 1e-6, where a trained entry would move by about lr,
    1e-3). The factory passes the key on (ROADMAP C1)."""
    from diverse_channel_vit_torch.config import Config
    from diverse_channel_vit_torch.models import build_model

    _three_steps_f32(start, None, monkeypatch, freeze_channel_emb=True)
    cfg = Config({"in_channel_names": ["a", "b"], "img_size": [IMG], "patch_size": P,
                  "pretrained_model_name": "test", "freeze_channel_emb": True})
    model = build_model("dichavit", cfg, {"x": [0, 1]}, NC, device="cpu")
    assert model.feature_extractor.freeze_channel_emb


def test_three_evit_train_steps_f32_match_jax(start, monkeypatch):
    """keep_rate 0.7: at depth 3 every block is an EViT block (layers 0, 1
    and 2 keep 1 + 44, 1 + 30 and 1 + 21 of the 64 tokens), with the
    attention's backward in ``flash_packed_bwd``; both packages must keep
    the same tokens at every step (the JAX side's choice read by wrapping its
    ``topk_token_select``; with these seeds the f32 boundary gaps exceed the
    rounding noise) before the losses and parameters are compared, to the
    bounds of the dense case."""
    _three_steps_f32(start, 0.7, monkeypatch)


def _three_steps_f32(start, keep_rate, monkeypatch, **kw):
    xs, ys, params = start
    jax_kept = []
    real = jtp.topk_token_select

    def spy(x, scores, keep):
        jax.debug.callback(lambda i: jax_kept.append(np.asarray(i)),
                           jax.lax.top_k(scores, keep)[1])
        return real(x, scores, keep)

    monkeypatch.setattr(jtp, "topk_token_select", spy)
    jmodel = _jax_model(jnp.float32, keep_rate=keep_rate, **kw)
    jtx = j_make_optimizer("adamw", dict(OPT), lr_schedule=_jax_lr(), total_steps=3)
    jstate = create_train_state(jmodel, jtx, rng=jax.random.key(1), sample_input=None,
                                sample_channel_ids=None, params=params)
    jstep = j_make_train_step(jmodel, channel_ids=IDS, loss_type="ce", extra_loss_lambda=1.0,
                              donate=False)
    model = _port_model(torch.float32, params_from_jax(params), keep_rate=keep_rate, **kw)
    state = TrainState(model, make_optimizer("adamw", dict(OPT), lr_schedule=_port_lr(),
                                                    total_steps=3))
    step = make_train_step(model, channel_ids=IDS, loss_type="ce", extra_loss_lambda=1.0)
    got, want = [], []
    for t in range(3):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(xs[t]), "label": jnp.asarray(ys[t])},
                           jax.random.key(t))
        state, m = step(state, {"image": torch.from_numpy(xs[t]),
                                "label": torch.from_numpy(ys[t])})
        if keep_rate is not None:
            jax.effects_barrier()
            kept = [blk.evit_kept.numpy() for blk in model.feature_extractor.blocks]
            assert [k.shape[1] for k in kept] == [44, 30, 21]
            for mine, theirs in zip(kept, jax_kept[-3:]):
                np.testing.assert_array_equal(mine, theirs)
        want.append([float(jm[k]) for k in ("loss", "main_loss", "extra_loss", "grad_norm")])
        got.append([float(m[k]) for k in ("loss", "main_loss", "extra_loss", "grad_norm")])
    assert float(m["extra_loss"]) > 0  # CDL and TDL are on
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = params_from_jax(jax.device_get(jstate.params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), rtol=0, atol=LR / 10,
                                   err_msg=name)
    assert state.step == 3
    if kw.get("freeze_channel_emb"):
        name = "feature_extractor.patch_embed.channel_embed.weight"
        first = params_from_jax(params)[name].numpy()
        mine = model.state_dict()[name].numpy() - first
        theirs = final[name].numpy() - first
        assert 0 < np.abs(theirs).max() < LR / 100  # decay alone
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=3e-8)


@pytest.mark.parametrize("learnable_temp", [False, True])
def test_proxy_main_loss_matches_jax(start, learnable_temp):
    """The proxy main loss of the head-less (CHAMMI-style) model, f32: the
    loss, main loss and accuracy of ``_loss_and_metrics`` against the JAX
    function's at rtol 1e-5, and every parameter's gradient within rel 1e-4
    (max|diff| / max|ref|) of ``jax.grad`` through it."""
    from diverse_channel_vit_torch.training.steps import _loss_and_metrics

    xs, ys, _ = start
    bb = jcv.ChannelVisionTransformer(num_total_channels=C, img_size=IMG, patch_size=P,
                                      embed_dim=D, depth=DEPTH, num_heads=H, **LOSS_KW)
    jmodel = JClassifier(backbone=bb, embed_dim=D, num_classes=NC, with_head=False,
                         learnable_temp=learnable_temp)
    x, y = jnp.asarray(xs[0]), jnp.asarray(ys[0])
    # jitted, init and gradient: eager flax takes several times longer on the CPU
    params = jax.jit(lambda x: jmodel.init({"params": jax.random.key(2)}, x, jnp.asarray(IDS),
                                           train=False)["params"])(x)
    kw = dict(loss_type="proxy", extra_loss_lambda=1.0, learnable_temp=learnable_temp,
              temperature=0.11111)
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_and_metrics(jmodel, p, x, jnp.asarray(IDS), y, jax.random.key(0), **kw),
        has_aux=True))(params)
    model = ChannelAdaptiveClassifier(
        ChannelVisionTransformer(C, IMG, P, D, DEPTH, H, **LOSS_KW), D, NC, with_head=False,
        learnable_temp=learnable_temp)
    model.load_state_dict(params_from_jax(params), strict=True)
    total, m = _loss_and_metrics(model.train(), torch.from_numpy(xs[0]), torch.tensor(IDS),
                                 torch.from_numpy(ys[0]), **kw)
    total.backward()
    for k in ("loss", "main_loss", "acc"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want = params_from_jax(jax.device_get(jg))
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        assert np.abs(ref).max() > 0, name
        rel = np.abs(p.grad.numpy() - ref).max() / np.abs(ref).max()
        assert rel <= 1e-4, (name, rel)


def test_train_step_grads_bf16_match_fused_jax(start, monkeypatch, geom=None):
    geom = geom or {}
    xs, ys, params = start
    calls = []
    real = jfb._ln_mlp_bwd_impl
    monkeypatch.setattr(jfb, "_ln_mlp_bwd_impl", lambda *a: calls.append(1) or real(*a))

    def jax_grads(dtype):
        jmodel = _jax_model(dtype, **geom)

        def jloss(p):
            return j_loss_and_metrics(jmodel, p, jnp.asarray(xs[0]), jnp.asarray(IDS),
                                      jnp.asarray(ys[0]), jax.random.key(0), loss_type="ce",
                                      extra_loss_lambda=1.0, learnable_temp=False,
                                      temperature=0.11111)

        (loss, _), g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
        return float(loss), params_from_jax(jax.device_get(g))

    _, want32 = jax_grads(jnp.float32)  # the unfused route
    monkeypatch.setattr(jfb, "FORCE_ON_CPU", True)
    want_loss, want16 = jax_grads(jnp.bfloat16)
    # the fused JAX route ran its ln_mlp backward kernel for every block but
    # the readout
    assert len(calls) == geom.get("depth", DEPTH) - 1

    model = _port_model(torch.bfloat16, params_from_jax(params), **geom)
    state = TrainState(model, make_optimizer("adamw", dict(OPT), lr_schedule=_port_lr(),
                                                    total_steps=3))
    step = make_train_step(model, channel_ids=IDS, loss_type="ce", extra_loss_lambda=1.0)
    _, m = step(state, {"image": torch.from_numpy(xs[0]), "label": torch.from_numpy(ys[0])})
    assert abs(float(m["loss"]) - want_loss) <= 3e-2 * abs(want_loss)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    for name, p in model.named_parameters():
        g, w16, w32 = p.grad.numpy(), want16[name].numpy(), want32[name].numpy()
        if not np.abs(w32).max():  # the class proxies: unused by the CE loss
            assert not np.abs(g).max() and not np.abs(w16).max(), name
            continue
        assert rel(g, w32) <= 3e-2, (name, rel(g, w32))
        assert rel(g, w16) <= 3e-2 + rel(w16, w32), (name, rel(g, w16), rel(w16, w32))


def test_train_step_grads_bf16_match_fused_jax_dh128(start_dh128, monkeypatch):
    """The slice's shape at a tiny size, 2 heads of 128 (D = 256) at depth 2
    (block 0 fused, block 1 the readout), from the same ``params_from_jax``
    weights: one bf16 step's loss and every gradient against the fused JAX
    route, whose attend_project kernels run at head width 128 in interpret
    mode, to the bounds of test_train_step_grads_bf16_match_fused_jax."""
    test_train_step_grads_bf16_match_fused_jax(start_dh128, monkeypatch, geom=DH128)
