"""The port's ``_proj``, ``_resnet34`` and ``hcs_per_sample`` channel samplers
against the JAX package's, on the CPU.

Geometry: the ``test`` preset at depth 2 (D = 64, 2 heads), 8 channels at
32² with patch 8 (16 patches a channel), B = 4, k = 4, f32, the XLA route on
the JAX side; CE + CDL + TDL. torch and JAX draw different random streams,
so JAX's draws are handed to the port's seams (tests/test_torch_sampling.py
does the same for the other methods): the step samples with the first of
its key's three parts; ``dcs_select`` splits that into the anchor's key and
the noise's; ``hcs_per_sample`` draws row i's noise from the i-th of
``split(key, B)``.

- ``_select_channels``: the same channels in the same order for several
  keys, the same gathered images, and for ``hcs_per_sample`` the same
  (B, k, D) channel-embedding override (exact: the same f32 scores and
  noise, a top-k with no ties at these seeds).
- The ResNet-34 scorer: one torchvision-layout state dict made with numpy,
  loaded into both packages (``load_torch_resnet_state``):
  ``per_channel_features`` within 1e-4 relative (max|diff| / max|ref|).
- Three train steps with each sampler through each package's
  ``make_train_step`` (AdamW, lr 1e-3, eps 1e-6) from the same weights:
  the sampled channels equal, losses within 1e-5 relative and parameters
  within 2e-5 absolute, the bounds of tests/test_torch_runtime.py (2% of an
  Adam step here: the steps of entries whose gradient is near eps carry
  the two packages' f32 gradient noise, which moves between runs by up to
  about 1e-5 at lr 2e-3). For
  ``hcs_per_sample`` the channel-embedding table trains through the
  override's gather in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.models import channel_vit as jcv
from diverse_channel_vit_tpu.models import resnet as jresnet
from diverse_channel_vit_tpu.models.import_torch import load_reference_checkpoint as jload_reference
from diverse_channel_vit_tpu.models.wrappers import ChannelAdaptiveClassifier as JClassifier
from diverse_channel_vit_tpu.training import create_train_state
from diverse_channel_vit_tpu.training import make_optimizer as j_make_optimizer
from diverse_channel_vit_tpu.training.steps import _select_channels as j_select_channels
from diverse_channel_vit_tpu.training.steps import make_train_step as j_make_train_step
from diverse_channel_vit_torch.models.channel_vit import ChannelVisionTransformer
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.models.resnet import (RESNET34_LAYERS, ResNetFeatures,
                                                     load_torch_resnet_state,
                                                     per_channel_features)
from diverse_channel_vit_torch.models.wrappers import ChannelAdaptiveClassifier
from diverse_channel_vit_torch.training import TrainState, make_optimizer, make_train_step
from diverse_channel_vit_torch.training.steps import _select_channels

C, IMG, P, D, H, DEPTH, NC, B, K = 8, 32, 8, 64, 2, 2, 5, 4, 4
TEMP = 0.1
LOSS_KW = dict(proxy_loss_lambda=1e-3, ortho_loss_v1_lambda=1e-3, gamma_s=1.0, gamma_d=4.0)
OPT = dict(lr=1e-3, betas=[0.9, 0.999], eps=1e-6, weight_decay=0.04, weight_decay_end=0.4)
METHODS = ["lowest_cosine_prob_proj", "lowest_cosine_prob_resnet34", "hcs_per_sample"]
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5


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


def _jax_model():
    bb = jcv.ChannelVisionTransformer(num_total_channels=C, img_size=IMG, patch_size=P,
                                      embed_dim=D, depth=DEPTH, num_heads=H,
                                      attention_impl="xla", **LOSS_KW)
    return JClassifier(backbone=bb, embed_dim=D, num_classes=NC, with_head=True)


def _port_model(params):
    bb = ChannelVisionTransformer(C, IMG, P, D, DEPTH, H, **LOSS_KW)
    model = ChannelAdaptiveClassifier(bb, D, NC, with_head=True)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _resnet_state(rng):
    """A torchvision-layout ResNet-34 state dict made with numpy: He-normal
    convolutions, BatchNorms near identity with statistics of their own."""
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = (rng.normal(size=(o, i, k, k)) * np.sqrt(2 / (o * k * k))
                                ).astype(np.float32)

    def bn(name, c):
        sd[name + ".weight"] = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
        sd[name + ".bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        sd[name + ".running_mean"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        sd[name + ".running_var"] = rng.uniform(0.5, 1.5, size=c).astype(np.float32)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (n, cout) in enumerate(zip(RESNET34_LAYERS, (64, 128, 256, 512))):
        for bi in range(n):
            t = f"layer{li + 1}.{bi}"
            conv(t + ".conv1", cout, cin, 3)
            bn(t + ".bn1", cout)
            conv(t + ".conv2", cout, cout, 3)
            bn(t + ".bn2", cout)
            if li > 0 and bi == 0:
                conv(t + ".downsample.0", cout, cin, 1)
                bn(t + ".downsample.1", cout)
            cin = cout
    sd["fc.weight"] = np.zeros((10, 512), np.float32)  # ignored by both
    return sd


@pytest.fixture(scope="module")
def start():
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(B, C, IMG, IMG)).astype(np.float32) for _ in range(3)]
    ys = [rng.integers(0, NC, size=B) for _ in range(3)]
    jmodel = _jax_model()
    # the port's init from a seed, carried to JAX's tree (no flax init compiled)
    bb = ChannelVisionTransformer(C, IMG, P, D, DEPTH, H, **LOSS_KW,
                                  generator=torch.Generator().manual_seed(0))
    sd = ChannelAdaptiveClassifier(bb, D, NC, with_head=True).state_dict()
    params = dict(jload_reference({k: v.numpy() for k, v in sd.items()})[0])
    rsd = _resnet_state(rng)
    jnet = jresnet.ResNetFeatures(layers=jresnet.RESNET34_LAYERS)
    # the tree's shapes alone (no init compiled): every leaf is loaded
    shapes = jax.eval_shape(jnet.init, jax.random.key(1), jnp.zeros((1, 3, 32, 32)))
    jp = jresnet.load_torch_resnet_state(shapes["params"], rsd)

    def jfeat(x):  # eager: the train step traces it into its own jit
        return jresnet.per_channel_features(lambda im: jnet.apply({"params": jp}, im), x)

    net = load_torch_resnet_state(ResNetFeatures(RESNET34_LAYERS), rsd)
    return dict(xs=xs, ys=ys, jmodel=jmodel, params=params, jfeat=jfeat,
                feat=lambda x: per_channel_features(net, x))


def jax_draws(key, method):
    """The draws JAX's step makes from its sampling key, as the port's
    seams take them."""
    if method == "hcs_per_sample":
        keys = jax.random.split(key, B)
        return {"gumbel": torch.from_numpy(np.stack(
            [np.asarray(jax.random.gumbel(k, (C,))) for k in keys]))}
    k_anchor, k_sample = jax.random.split(key)
    return {"anchor": torch.tensor(int(jax.random.randint(k_anchor, (), 0, C))),
            "gumbel": torch.from_numpy(np.array(jax.random.gumbel(k_sample, (C,))))}


def test_resnet34_features_match_jax(start):
    x = start["xs"][0]
    want = np.asarray(start["jfeat"](jnp.asarray(x)))
    got = start["feat"](torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, C, 512)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("method", METHODS)
def test_select_channels_match_jax(start, method):
    params = start["params"]
    model = _port_model(params)
    cids = torch.arange(C)
    seen = set()
    for seed in range(3):
        key = jax.random.key(seed)
        x = start["xs"][seed]
        jx, jc, jo = j_select_channels(params, jnp.asarray(x), jnp.arange(C), key, k=K,
                                       method=method, temp=TEMP, patch_size=P,
                                       feature_fn=start["jfeat"])
        px, pc, po = _select_channels(model, torch.from_numpy(x), cids, k=K, method=method,
                                      temp=TEMP, generator=None, draws=jax_draws(key, method),
                                      feature_fn=start["feat"])
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
        assert (po is None) == (jo is None) == (method != "hcs_per_sample")
        if po is not None:
            assert po.shape == (B, K, D) and po.requires_grad
            np.testing.assert_array_equal(po.detach().numpy(), np.asarray(jo))
        seen.add(tuple(pc.tolist()))
    assert len(seen) > 1  # the draws matter


def test_resnet34_sampler_needs_its_scorer(start):
    model = _port_model(start["params"])
    with pytest.raises(ValueError, match="resnet34"):
        _select_channels(model, torch.from_numpy(start["xs"][0]), torch.arange(C), k=K,
                         method="lowest_cosine_prob_resnet34", temp=TEMP, generator=None,
                         draws=None)


@pytest.mark.parametrize("method", METHODS)
def test_three_sampler_steps_match_jax(start, method):
    xs, ys, params, jmodel = start["xs"], start["ys"], start["params"], start["jmodel"]
    lr_fn = lambda s: OPT["lr"]  # noqa: E731
    jtx = j_make_optimizer("adamw", dict(OPT), lr_schedule=lr_fn, total_steps=3)
    jstate = create_train_state(jmodel, jtx, rng=jax.random.key(1), sample_input=None,
                                sample_channel_ids=None, params=params)
    jstep = j_make_train_step(jmodel, channel_ids=range(C), k=K, hcs_method=method,
                              hcs_temp=TEMP, patch_size=P, loss_type="ce",
                              extra_loss_lambda=1.0, donate=False, feature_fn=start["jfeat"])
    model = _port_model(params)
    state = TrainState(model, make_optimizer("adamw", dict(OPT), lr_schedule=lr_fn,
                                             total_steps=3))
    step = make_train_step(model, channel_ids=range(C), k=K, hcs_method=method, hcs_temp=TEMP,
                           loss_type="ce", extra_loss_lambda=1.0, feature_fn=start["feat"])
    names = ("loss", "main_loss", "extra_loss", "grad_norm")
    for t in range(3):
        key = jax.random.key(20 + t)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(xs[t]), "label": jnp.asarray(ys[t])},
                           key)
        draws = jax_draws(jax.random.split(key, 3)[0], method)
        state, m = step(state, {"image": torch.from_numpy(xs[t]),
                                "label": torch.from_numpy(ys[t])}, draws=draws)
        np.testing.assert_array_equal(m["sampled_channels"].numpy(),
                                      np.asarray(jm["sampled_channels"]))
        np.testing.assert_allclose([float(m[n]) for n in names],
                                   [float(jm[n]) for n in names], rtol=LOSS_RTOL)
    final = params_from_jax(jax.device_get(jstate.params))
    first = params_from_jax(params)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
    table = "feature_extractor.patch_embed.channel_embed.weight"
    moved = np.abs(model.state_dict()[table].numpy() - first[table].numpy()).max()
    assert moved > OPT["lr"] / 2  # trained (by CDL, or through the override), not decay alone
