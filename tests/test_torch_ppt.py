"""The port's PPT blocks (``block_type="block_v2"``) and HCS token and
channel dropout (``dropout_tokens_hcs``) against the JAX package's, on the
CPU.

Geometry: the ``test`` preset at depth 2 (D = 64, 2 heads), 8 channels at
32² with patch 8 (16 patches a channel, 129 tokens), B = 2, f32, the XLA
route on the JAX side; CE + CDL + TDL. The weights are the port's init from
a seed, carried to JAX's tree (``load_reference_checkpoint``); PPT blocks
take :class:`Block`'s parameter names in both packages.

- ``AttentionWithScores``: the output and the significance scores against
  JAX's module (rtol 1e-5), and the scores against the dense oracle
  ``ppt_significance_scores`` of both packages (rtol 1e-5).
- ``BlockV2`` with token pruning (64 of 128 tokens) and channel pruning (4
  of 8 channels) against JAX's, rtol 1e-5 (atol 1e-6).
- The ``block_v2`` backbone with ``token_pruning`` (blocks keep 64 and 32
  tokens at kc = 4) and with ``channel_pruning`` (block 0 keeps 4
  channels): the eval logits within rtol 1e-5, and one training loss and
  every parameter's gradient within 1e-5 relative and 1e-4 of max|g| (the
  proxy-loss test's f32 bound, tests/test_torch_training.py).
- HCS dropout, all four ``dropout_tokens_hcs`` values at
  ``token_keep_channels`` 3: JAX's drawn indices (read by wrapping its
  ``random_token_drop`` / ``random_channel_drop``) handed to the port's
  ``token_drop`` seam; for ``random`` and ``channel`` one training loss and
  every gradient as above, for their ``_random50`` aliases the training
  forward's logits and diversity loss within rtol 1e-5. The eval forward
  drops nothing; the port's own draws keep kc channels' worth, kc = ceil(8
  / 2) when unset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.models import channel_vit as jcv
from diverse_channel_vit_tpu.models import vit as jvit
from diverse_channel_vit_tpu.models.import_torch import load_reference_checkpoint as jload_reference
from diverse_channel_vit_tpu.models.wrappers import ChannelAdaptiveClassifier as JClassifier
from diverse_channel_vit_tpu.ops import token_pruning as jtp
from diverse_channel_vit_tpu.training.steps import _loss_and_metrics as j_loss_and_metrics
from diverse_channel_vit_torch.models.channel_vit import ChannelVisionTransformer
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.models.wrappers import ChannelAdaptiveClassifier
from diverse_channel_vit_torch.ops import token_pruning as tp
from diverse_channel_vit_torch.training.steps import _loss_and_metrics

C, IMG, P, D, H, DEPTH, NC, B = 8, 32, 8, 64, 2, 2, 5, 2
N = 1 + C * (IMG // P) ** 2  # 129
LOSS_KW = dict(proxy_loss_lambda=1e-3, ortho_loss_v1_lambda=1e-3, gamma_s=1.0, gamma_d=4.0)
STEP_KW = dict(loss_type="ce", extra_loss_lambda=1.0, learnable_temp=False, temperature=0.11111)


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


def _port(**kw):
    bb = ChannelVisionTransformer(C, IMG, P, D, DEPTH, H, **LOSS_KW, **kw,
                                  generator=torch.Generator().manual_seed(0))
    return ChannelAdaptiveClassifier(bb, D, NC, with_head=True)


def _jax(**kw):
    bb = jcv.ChannelVisionTransformer(num_total_channels=C, img_size=IMG, patch_size=P,
                                      embed_dim=D, depth=DEPTH, num_heads=H,
                                      attention_impl="xla", **LOSS_KW, **kw)
    return JClassifier(backbone=bb, embed_dim=D, num_classes=NC, with_head=True)


@pytest.fixture(scope="module")
def start():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, C, IMG, IMG)).astype(np.float32)
    y = rng.integers(0, NC, size=B)
    sd = _port().state_dict()
    params = dict(jload_reference({k: v.numpy() for k, v in sd.items()})[0])
    return dict(x=x, y=y, sd=sd, params=params)


def _block(start, i=0):
    model = _port(block_type="block_v2")
    model.load_state_dict(start["sd"])
    return model.feature_extractor.blocks[i], start["params"]["backbone"][f"block_{i}"]


def _grid(seed=1):
    return np.random.default_rng(seed).normal(size=(B, N, D)).astype(np.float32)


def test_attention_with_scores_matches_jax_and_the_dense_oracle(start):
    blk, jparams = _block(start)
    y = _grid()
    out, scores = blk.attn(torch.from_numpy(y))
    jout, jscores = jvit.AttentionWithScores(num_heads=H, impl="xla").apply(
        {"params": jparams["attn"]}, jnp.asarray(y), train=False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5)
    assert scores.shape == (B, N - 1) and not scores.requires_grad
    # the dense oracle of both packages on this attention's probabilities
    q, k, v = (t.detach() for t in blk.attn.project_qkv(torch.from_numpy(y)))
    qh, kh, vh = (t.reshape(B, N, H, D // H).transpose(1, 2) for t in (q, k, v))
    probs = torch.softmax(qh @ kh.transpose(-1, -2) * blk.attn.scale, dim=-1)
    dense = tp.ppt_significance_scores(probs, vh)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jtp.ppt_significance_scores(
        jnp.asarray(probs.numpy()), jnp.asarray(vh.numpy()))), rtol=1e-5)
    np.testing.assert_allclose(scores.numpy(), dense.numpy(), rtol=1e-5)


@pytest.mark.parametrize("pruning,keep", [("token_pruning", 64), ("channel_pruning", 4)])
def test_block_v2_prunes_as_jax(start, pruning, keep):
    blk, jparams = _block(start)
    x = _grid(2)
    kw = dict(keep_tokens=keep) if pruning == "token_pruning" else dict(keep_channels=keep)
    got = blk(torch.from_numpy(x), pruning=pruning, nc=C, **kw)
    want = jvit.BlockV2(num_heads=H, pruning_method=pruning, nc=C, attention_impl="xla",
                        **kw).apply({"params": jparams}, jnp.asarray(x), train=False)
    rows = 1 + (keep if pruning == "token_pruning" else keep * (N - 1) // C)
    assert got.shape == want.shape == (B, rows, D)
    assert blk.kept.shape == ((B, keep) if pruning == "token_pruning" else (keep,))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the seam: forcing the kept indices gives the same block
    blk.forced = blk.kept.clone()
    assert torch.equal(blk(torch.from_numpy(x), pruning=pruning, nc=C, **kw), got)


def _grads_close(model, jgrads):
    want = params_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        g = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        scale = np.abs(ref).max()
        if not scale:  # the class proxies: unused by the CE loss
            assert not np.abs(g).max(), name
            continue
        err = np.abs(g - ref).max()
        assert err <= 1e-4 * scale, (name, err, scale)


def _loss_and_grads(start, kw, token_drop=None, spy=None):
    """One training loss and its gradients in both packages: JAX's jitted
    ``_loss_and_metrics`` (its HCS draws read through ``spy``), then the
    port's with those draws."""
    jmodel, params = _jax(**kw), start["params"]
    x, y = start["x"], start["y"]

    def jloss(p):
        return j_loss_and_metrics(jmodel, p, jnp.asarray(x), jnp.arange(C), jnp.asarray(y),
                                  jax.random.key(3), **STEP_KW)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    jax.effects_barrier()
    model = _port(**kw)
    model.load_state_dict(start["sd"])
    total, m = _loss_and_metrics(model.train(), torch.from_numpy(x), torch.arange(C),
                                 torch.from_numpy(y), **STEP_KW,
                                 token_drop=None if spy is None else spy[-1])
    total.backward()
    np.testing.assert_allclose([float(total.detach()), float(m["extra_loss"])],
                               [float(jl), float(jm["extra_loss"])], rtol=1e-5)
    _grads_close(model, jg)
    return model


@pytest.mark.parametrize("pruning", ["token_pruning", "channel_pruning"])
def test_block_v2_backbone_forward_and_grad_step_match_jax(start, pruning):
    kw = dict(block_type="block_v2", dropout_tokens_hcs=pruning, token_keep_channels=4)
    model = _loss_and_grads(start, kw)
    kept = [blk.kept for blk in model.feature_extractor.blocks]
    if pruning == "token_pruning":  # max(1, cur_n * kc // c) at each block
        assert [k.shape[1] for k in kept] == [64, 32]
    else:  # block 0 only
        assert kept[0].shape == (4,) and kept[1] is None
    x = torch.from_numpy(start["x"])
    got = model.eval()(x, torch.arange(C))[0]
    jmodel = _jax(**kw)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, jnp.arange(C), train=False)[0])(
        start["params"], jnp.asarray(start["x"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _spy(monkeypatch):
    """Wrap JAX's random drops to record the indices each draws."""
    seen = []
    real_t, real_c = jtp.random_token_drop, jtp.random_channel_drop

    def record(idx):
        jax.debug.callback(lambda i: seen.append(torch.from_numpy(np.array(i))), idx)

    def token(key, x, keep):
        record(jnp.sort(jtp.uniform_subset(key, x.shape[1] - 1, keep)))
        return real_t(key, x, keep)

    def channel(key, x, nc, keep):
        record(jnp.sort(jtp.uniform_subset(key, nc, keep)))
        return real_c(key, x, nc, keep)

    monkeypatch.setattr(jtp, "random_token_drop", token)
    monkeypatch.setattr(jtp, "random_channel_drop", channel)
    return seen


def _port_with(kw, start):
    model = _port(**kw)
    model.load_state_dict(start["sd"])
    return model


@pytest.mark.parametrize("mode", ["token_random50", "channel_random50"])
def test_hcs_dropout_forward_matches_jax(start, mode, monkeypatch):
    """The ``_random50`` aliases (``random`` and ``channel`` take the
    gradient test below, which holds their forward too)."""
    seen = _spy(monkeypatch)
    kw = dict(dropout_tokens_hcs=mode, token_keep_channels=3)
    jmodel, params, x = _jax(**kw), start["params"], jnp.asarray(start["x"])
    jout, jextra = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, jnp.arange(C), train=True, rngs={"dropout": jax.random.key(5)}))(
        params, x)
    jax.effects_barrier()
    (idx,) = seen
    assert idx.shape == ((3,) if "channel" in mode else (3 * (N - 1) // C,))
    out, extra = _port_with(kw, start).train()(torch.from_numpy(start["x"]), torch.arange(C),
                                               token_drop=idx.long())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(extra.detach()), float(jextra), rtol=1e-5)


@pytest.mark.parametrize("mode", ["random", "channel"])
def test_hcs_dropout_grad_step_matches_jax(start, mode, monkeypatch):
    seen = _spy(monkeypatch)
    kw = dict(dropout_tokens_hcs=mode, token_keep_channels=3)
    _loss_and_grads(start, kw, spy=seen)
    (idx,) = seen
    assert idx.shape == ((3,) if mode == "channel" else (3 * (N - 1) // C,))
    # the eval forward drops nothing: the model without the key
    model, plain = _port_with(kw, start), _port_with({}, start)
    xt = torch.from_numpy(start["x"])
    with torch.no_grad():
        assert torch.equal(model.eval()(xt, torch.arange(C))[0],
                           plain.eval()(xt, torch.arange(C))[0])


@pytest.mark.parametrize("mode", ["random", "token_random50", "channel", "channel_random50"])
def test_hcs_dropout_draws_keep_kc(mode):
    """A draw from a generator keeps kc channels' worth, sorted; kc is
    ``token_keep_channels`` or, unset, ceil(C / 2) (JAX
    ``models/channel_vit.py:214``)."""
    hw = (IMG // P) ** 2
    for kc, want in ((3, 3), (None, 4)):
        fe = _port(dropout_tokens_hcs=mode, token_keep_channels=kc).feature_extractor
        drawn = fe.draw_token_drop(C, hw, torch.Generator().manual_seed(0))
        assert drawn.shape == ((want,) if "channel" in mode else (want * hw,))
        assert torch.equal(drawn, drawn.sort().values) and len(set(drawn.tolist())) == drawn.numel()
