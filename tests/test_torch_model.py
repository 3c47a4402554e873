"""The port's DiChaViT forward against the JAX package's, same weights.

A ChannelAdaptiveClassifier over 8 channels at 48^2, patch 16, D = 128, 2
heads, depth 3, is initialised in JAX; its parameter tree goes to the port
through ``models.export.params_from_jax``. Requests of k = 7 channel ids give
N = 1 + 7*9 = 64 tokens, a multiple of 8, so in bf16 with
``fused_block.FORCE_ON_CPU`` the JAX model really takes its fused route
(``attend_project`` + ``ln_mlp`` Pallas kernels in interpret mode) for blocks
0-1 and the CLS readout for block 2; k = 3 gives N = 28 and the JAX unfused
route. Every request resamples the positional table (C > 1).

Tolerances: f32 against the unfused JAX path, rel <= 1e-4 (the same
arithmetic in other summation orders, LayerNorm variance by another
formula). bf16 against the JAX path, rel <= 3e-2, as
tests/test_fused_block.py holds the fused block to the unfused one: bf16
rounding at slightly different points through three blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diverse_channel_vit_tpu.models import channel_vit as jcv
from diverse_channel_vit_tpu.models.wrappers import ChannelAdaptiveClassifier as JClassifier
from diverse_channel_vit_tpu.ops import activations as jact
from diverse_channel_vit_tpu.ops import fused_block as jfb
from diverse_channel_vit_tpu.ops.patch_embed import per_channel_patch_embed as j_patch_embed
from diverse_channel_vit_torch.config import Config
from diverse_channel_vit_torch.models import build_model
from diverse_channel_vit_torch.models.channel_vit import (
    ChannelVisionTransformer,
    interpolate_pos_embed,
)
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.models.vit import _wb
from diverse_channel_vit_torch.models.wrappers import ChannelAdaptiveClassifier
from diverse_channel_vit_torch.ops import activations, fused_block
from diverse_channel_vit_torch.ops.patch_embed import per_channel_patch_embed

C, IMG, P, D, H, DEPTH, NC = 8, 48, 16, 128, 2, 3, 5
SUBSETS = {"k7": [0, 1, 2, 4, 5, 6, 7], "k3": [1, 4, 6]}


def _jax_model(dtype):
    bb = jcv.ChannelVisionTransformer(
        num_total_channels=C, img_size=IMG, patch_size=P, embed_dim=D, depth=DEPTH,
        num_heads=H, proxy_loss_lambda=1e-3, dtype=dtype,
    )
    return JClassifier(backbone=bb, embed_dim=D, num_classes=NC, with_head=True)


def _port_model(dtype, state_dict, **kw):
    bb = ChannelVisionTransformer(C, IMG, P, D, DEPTH, H, proxy_loss_lambda=1e-3, dtype=dtype,
                                  **kw)
    model = ChannelAdaptiveClassifier(bb, D, NC, with_head=True).eval()
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, C, IMG, IMG)).astype(np.float32)
    params = _jax_model(jnp.float32).init(
        {"params": jax.random.key(0)}, jnp.asarray(x[:, :7]), jnp.arange(7), train=False
    )["params"]
    # LayerNorm affines and biases start at 1/0: move them off so they count
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    moved = [
        np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)
        if any(getattr(k, "key", "") in ("bias", "scale", "proj_bias") for k in path)
        else np.asarray(a)
        for path, a in leaves
    ]
    params = jax.tree_util.tree_unflatten(tree, moved)
    return x, params, params_from_jax(params)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _logits(setup, jdtype, tdtype, ids, **kw):
    x, params, sd = setup
    xs = x[:, : len(ids)]
    want, _ = _jax_model(jdtype).apply(
        {"params": params}, jnp.asarray(xs), jnp.asarray(ids), train=False
    )
    with torch.no_grad():
        got, extra = _port_model(tdtype, sd, **kw)(torch.from_numpy(xs), torch.tensor(ids))
    assert got.dtype == torch.float32 and got.shape == (2, NC) and float(extra) == 0.0
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("subset", sorted(SUBSETS))
def test_logits_f32_match_unfused_jax(setup, subset):
    got, want = _logits(setup, jnp.float32, torch.float32, SUBSETS[subset])
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("subset", sorted(SUBSETS))
def test_logits_bf16_match_jax(setup, subset, monkeypatch):
    calls = []
    real = jfb.ln_mlp_sharded
    monkeypatch.setattr(jfb, "ln_mlp_sharded", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(jfb, "FORCE_ON_CPU", True)
    got, want = _logits(setup, jnp.bfloat16, torch.bfloat16, SUBSETS[subset])
    # the fused JAX route ran for every block but the CLS readout
    assert len(calls) == (DEPTH - 1 if subset == "k7" else 0)
    assert _rel(got, want) <= 3e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax_dh128(dtype, monkeypatch):
    """The slice's head width at a tiny size: 2 heads of 128 (D = 256),
    depth 2, the same 48^2 images and k = 7 request (N = 64), weights from
    the JAX init through ``params_from_jax`` (the parameter tree does not
    depend on the head count). bf16 with ``FORCE_ON_CPU``: block 0 takes the
    fused route in both packages (the JAX attend_project kernel in interpret
    mode at head width 128), block 1 the readout; rel 3e-2 as
    test_logits_bf16_match_jax. f32 against the unfused JAX route, rel 1e-4
    as test_logits_f32_match_unfused_jax."""
    d, depth, ids = 256, 2, SUBSETS["k7"]
    x = np.random.default_rng(0).normal(size=(2, len(ids), IMG, IMG)).astype(np.float32)

    def jmodel(jdtype):
        bb = jcv.ChannelVisionTransformer(num_total_channels=C, img_size=IMG, patch_size=P,
                                          embed_dim=d, depth=depth, num_heads=H,
                                          proxy_loss_lambda=1e-3, dtype=jdtype)
        return JClassifier(backbone=bb, embed_dim=d, num_classes=NC, with_head=True)

    init = jax.jit(lambda xx: jmodel(jnp.float32).init(
        {"params": jax.random.key(3)}, xx, jnp.asarray(ids), train=False))
    params = init(jnp.asarray(x))["params"]
    calls = _count_fused_calls(monkeypatch)
    monkeypatch.setattr(jfb, "FORCE_ON_CPU", True)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                            torch.float32)
    want, _ = jax.jit(lambda p, xx: jmodel(jdt).apply({"params": p}, xx, jnp.asarray(ids),
                                                      train=False))(params, jnp.asarray(x))
    model = ChannelAdaptiveClassifier(
        ChannelVisionTransformer(C, IMG, P, d, depth, H, proxy_loss_lambda=1e-3, dtype=tdt),
        d, NC, with_head=True).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x), torch.tensor(ids))
    fused = int(dtype == "bfloat16")
    assert calls == {"jax": fused, "port": fused}
    assert _rel(got.numpy(), want) <= (3e-2 if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("side,h0,channels", [(3, 3, 7), (14, 14, 8), (14, 14, 1), (6, 4, 2)])
def test_interpolate_pos_embed(side, h0, channels):
    """Against the JAX tables, and against torch's own bicubic resample at
    the same scale factor (the reference's formula)."""
    rng = np.random.default_rng(side + h0)
    pos = rng.normal(size=(1, side * side + 1, 16)).astype(np.float32)
    got = interpolate_pos_embed(torch.from_numpy(pos), h0, h0, num_channels=channels)
    want = jcv.interpolate_pos_embed(jnp.asarray(pos), h0, h0, num_channels=channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if channels == 1 and h0 == side:
        assert torch.equal(got, torch.from_numpy(pos))  # the one skipped case
        return
    grid = torch.from_numpy(pos[:, 1:]).reshape(1, side, side, 16).permute(0, 3, 1, 2)
    s = (h0 + 0.1) / side
    ref = F.interpolate(grid, scale_factor=(s, s), mode="bicubic", align_corners=False)
    np.testing.assert_allclose(got[0, 1:].numpy(), ref[0].permute(1, 2, 0).reshape(-1, 16),
                               rtol=1e-5, atol=1e-5)


def test_patch_embed_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    k = rng.normal(size=(P * P, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    got = per_channel_patch_embed(torch.from_numpy(x), torch.from_numpy(k),
                                  torch.from_numpy(b), patch_size=P)
    want = j_patch_embed(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), patch_size=P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("exact", [False, True])
def test_gelu_matches_jax(exact):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    got = activations.gelu(torch.from_numpy(x), exact=exact)
    want = jax.nn.gelu(jnp.asarray(x), approximate=not exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_weight_casts_are_reused_until_a_parameter_changes():
    """Without autograd a block casts its f32 weights to bf16 once and reuses
    the copies; an in-place update of a weight makes the next forward cast
    again, so the output follows the parameter (equal to a forward with
    autograd on, which casts at every use)."""
    torch.manual_seed(0)
    bb = ChannelVisionTransformer(C, IMG, P, D, 2, H, dtype=torch.bfloat16)
    model = ChannelAdaptiveClassifier(bb, D, NC, with_head=True).eval()
    x, ids = torch.randn(2, 7, IMG, IMG), torch.tensor(SUBSETS["k7"])
    qkv = bb.blocks[0].attn.qkv
    with torch.inference_mode():
        first = model(x, ids)[0]
        w0 = _wb(qkv, torch.bfloat16)[0]
        assert torch.equal(model(x, ids)[0], first)
        assert _wb(qkv, torch.bfloat16)[0] is w0
    with torch.no_grad():
        qkv.weight.mul_(2.0)
    with torch.inference_mode():
        changed = model(x, ids)[0]
        w1 = _wb(qkv, torch.bfloat16)[0]
    assert w1 is not w0 and torch.equal(w1, qkv.weight.detach().to(torch.bfloat16))
    assert not torch.equal(changed, first)
    assert torch.equal(changed, model(x, ids)[0].detach())


def _count_fused_calls(monkeypatch):
    """Count the blocks that take the fused route, in both packages."""
    calls = {"jax": 0, "port": 0}
    real_j, real_p = jfb.ln_mlp_sharded, fused_block.ln_mlp

    def j_spy(*a):
        calls["jax"] += 1
        return real_j(*a)

    def p_spy(*a, **kw):
        calls["port"] += 1
        return real_p(*a, **kw)

    monkeypatch.setattr(jfb, "ln_mlp_sharded", j_spy)
    monkeypatch.setattr(fused_block, "ln_mlp", p_spy)
    return calls


def test_gelu_exact_refuses_the_fused_route(setup, monkeypatch):
    """``gelu_exact`` (the reference's erf GELU) takes the unfused route in
    both packages, even in bf16 with the fused kernels allowed
    (``FORCE_ON_CPU``), and the bf16 logits match the JAX ones (rel 3e-2, as
    test_logits_bf16_match_jax). The JAX flag is process-wide, so it is set
    for the call and restored after."""
    calls = _count_fused_calls(monkeypatch)
    monkeypatch.setattr(jfb, "FORCE_ON_CPU", True)
    jact.set_gelu_exact(True)
    try:
        got, want = _logits(setup, jnp.bfloat16, torch.bfloat16, SUBSETS["k7"], gelu_exact=True)
    finally:
        jact.set_gelu_exact(False)
    assert calls == {"jax": 0, "port": 0}
    assert _rel(got, want) <= 3e-2
    cfg = Config({"in_channel_names": [f"c{i}" for i in range(C)], "img_size": [IMG],
                  "patch_size": P, "pretrained_model_name": "test", "gelu_exact": True})
    model = build_model("dichavit", cfg, {"JUMP-CP": list(range(C))}, NC, device="cpu")
    assert all(blk.gelu_exact for blk in model.feature_extractor.blocks)


@pytest.mark.parametrize("subset", sorted(SUBSETS))
def test_gelu_exact_logits_f32_match_jax(setup, subset):
    """f32, erf GELU: rel 1e-4, as test_logits_f32_match_unfused_jax (the
    erf and tanh forms differ by up to 3e-4 absolute, so the tanh model
    would miss)."""
    jact.set_gelu_exact(True)
    try:
        got, want = _logits(setup, jnp.float32, torch.float32, SUBSETS[subset], gelu_exact=True)
    finally:
        jact.set_gelu_exact(False)
    assert _rel(got, want) <= 1e-4


def test_width_192_takes_the_unfused_route(monkeypatch):
    """The ``tiny`` preset's width, D = 192 with 3 heads of 64, is not a
    multiple of 128: both packages run it unfused (the port's attention
    through ``flash_attention_packed``), in bf16 with the fused kernels
    allowed. Logits rel 3e-2 in bf16 (as test_logits_bf16_match_jax)."""
    d, h = 192, 3
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, IMG, IMG)).astype(np.float32)
    ids = SUBSETS["k7"]
    bb = jcv.ChannelVisionTransformer(num_total_channels=C, img_size=IMG, patch_size=P,
                                      embed_dim=d, depth=DEPTH, num_heads=h,
                                      proxy_loss_lambda=1e-3, dtype=jnp.bfloat16)
    jmodel = JClassifier(backbone=bb, embed_dim=d, num_classes=NC, with_head=True)
    params = jax.jit(lambda xx: jmodel.init({"params": jax.random.key(1)}, xx,
                                            jnp.asarray(ids), train=False))(jnp.asarray(x))
    params = params["params"]
    calls = _count_fused_calls(monkeypatch)
    monkeypatch.setattr(jfb, "FORCE_ON_CPU", True)
    want, _ = jax.jit(lambda p, xx: jmodel.apply({"params": p}, xx, jnp.asarray(ids),
                                                 train=False))(params, jnp.asarray(x))
    model = ChannelAdaptiveClassifier(
        ChannelVisionTransformer(C, IMG, P, d, DEPTH, h, proxy_loss_lambda=1e-3,
                                 dtype=torch.bfloat16), d, NC, with_head=True).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x), torch.tensor(ids))
    assert calls == {"jax": 0, "port": 0}
    assert _rel(got.numpy(), want) <= 3e-2


@pytest.mark.parametrize("impl,n", [("auto", 64), ("auto", 8192), ("auto", 8256),
                                    ("pallas", 8256), ("xla", 64), ("pallas", 64)])
def test_route_gate_matches_jax_fused_ok(impl, n, monkeypatch):
    """The port's route gate against the JAX ``Block._fused_ok``
    (``models/vit.py:605-625``) on one bf16 block of width 128 with 2 heads,
    the fused kernels allowed (``FORCE_ON_CPU``): ``attention_impl`` ``xla``
    and a grid past ``MAX_SINGLE_PASS_N`` = 8192 tokens take the unfused
    route in both (ROADMAP C3). Then a port block at N = 64 routes as its
    gate says, and the factory passes ``attention_impl`` on."""
    from diverse_channel_vit_tpu.models import vit as jvit
    from diverse_channel_vit_torch.models.vit import Block, fused_route_ok

    monkeypatch.setattr(jfb, "FORCE_ON_CPU", True)
    want = jvit.Block(num_heads=2, attention_impl=impl, dtype=jnp.bfloat16)._fused_ok(
        jnp.zeros((1, n, 128), jnp.bfloat16), train=False)
    got = fused_route_ok(torch.zeros(1, n, 128), torch.bfloat16, 2, False, impl)
    assert got == bool(want)
    if n == 64:
        calls = _count_fused_calls(monkeypatch)
        blk = Block(128, 2, dtype=torch.bfloat16, attention_impl=impl).eval()
        with torch.no_grad():
            blk(torch.randn(1, n, 128).to(torch.bfloat16))
        assert calls["port"] == int(got)
        cfg = Config({"in_channel_names": [f"c{i}" for i in range(C)], "img_size": [IMG],
                      "patch_size": P, "pretrained_model_name": "test",
                      "attention_impl": impl})
        model = build_model("dichavit", cfg, {"JUMP-CP": list(range(C))}, NC, device="cpu")
        assert {blk.attention_impl for blk in model.feature_extractor.blocks} == {impl}
