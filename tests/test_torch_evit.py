"""EViT token pruning in the port against the JAX package's.

- ``topk_token_select`` against the JAX function: the same tokens, gathered
  in the same order (exact: a gather of distinct scores).
- ``Block.evit`` against the JAX ``BlockEViT`` (f32, its attention on the
  XLA path, as the JAX package's own EViT tests run it; the Pallas kernels
  are held to the port's in tests/test_torch_attention.py), on an unpadded
  grid and on one padded
  with zero rows and ``valid_len``: the output, the kept tokens and the
  gradients of the input and of every parameter. The parameters are the
  plain block's, carried by the exporter's block mapping.
- The EViT DiChaViT (keep_rate 0.7, depth 4, so layers 1, 2 and 3 prune and
  the last block is an EViT block with no CLS readout) against the JAX model
  from the same ``params_from_jax`` weights, which load with
  ``strict=True``: 7 of 8 channels at 48^2 give N = 64 tokens, pruned to
  1 + 44, 1 + 30 and 1 + 21; the port pads each pruned grid to 64 again,
  the JAX package on the CPU does not pad.

Top-k near-ties: neighbouring CLS-attention scores can differ by less than
the rounding noise between XLA's and torch's products, and then the two
packages keep different boundary tokens. The one-block test asserts that
both kept the same tokens in the same order before it compares values (the
JAX side's choice is read by wrapping its ``topk_token_select``). The
logits test forces the JAX side's kept tokens on the port at every pruning
layer (``Block.evit_forced``), so the values it compares come from the same
tokens whatever the noise, and asserts that the port's own choice on the
same grid keeps the same set in every image whose boundary gap (the
keep-th largest score less the next) exceeds ``MARGIN``: there no rounding
noise between the two packages can reorder the boundary.

Tolerances, max|port - jax| <= tol * max|jax|: f32 1e-5 for one block and
1e-4 for the logits after four (the same f32 arithmetic in other orders, as
tests/test_torch_model.py holds the dense model); bf16 logits 3e-2 (bf16
rounding at slightly different points through four blocks, as there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.models import channel_vit as jcv
from diverse_channel_vit_tpu.models.vit import BlockEViT as JBlockEViT
from diverse_channel_vit_tpu.models.wrappers import ChannelAdaptiveClassifier as JClassifier
from diverse_channel_vit_tpu.ops import fused_block as jfb
from diverse_channel_vit_tpu.ops import token_pruning as jtp
from diverse_channel_vit_torch.config import Config
from diverse_channel_vit_torch.models import build_model
from diverse_channel_vit_torch.models import vit as tvit
from diverse_channel_vit_torch.models.channel_vit import ChannelVisionTransformer
from diverse_channel_vit_torch.models.export import _block_state, params_from_jax
from diverse_channel_vit_torch.models.vit import Block
from diverse_channel_vit_torch.models.wrappers import ChannelAdaptiveClassifier
from diverse_channel_vit_torch.ops.token_pruning import topk_token_select

C, IMG, P, D, H, DEPTH, NC, KEEP = 8, 48, 16, 128, 2, 4, 5, 0.7
IDS = [0, 1, 2, 4, 5, 6, 7]  # N = 1 + 7 * 9 = 64 tokens
SEED = 5  # the kept sets agree in bf16 (seeds 2, 3 and 7 flip a boundary token)
# Boundary gaps above which the two packages' kept sets must agree. The CLS
# scores are head-mean attention probabilities of order 1/64; between the
# packages, on the same grid, they differ by at most 7.5e-9 in f32 and
# 2.3e-5 in bf16 (bf16 rounding at other points through up to three
# blocks), while the gaps at this seed run from 1.8e-5 to 1.4e-4. A gap
# above MARGIN exceeds twice that noise by a factor of two or more.
MARGIN = {"float32": 1e-6, "bfloat16": 1e-4}


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


class _Kept(list):
    """The JAX side's kept indices, one (B, keep) array per pruning block, and
    in ``scores`` the (B, N - 1) scores each block chose them by."""

    def __init__(self):
        super().__init__()
        self.scores = []

    def clear(self):
        super().clear()
        self.scores.clear()


@pytest.fixture
def jax_kept(monkeypatch):
    """The JAX side's kept indices (and scores), as :class:`_Kept`."""
    kept = _Kept()
    real = jtp.topk_token_select

    def record(idx, scores):
        kept.append(np.asarray(idx))
        kept.scores.append(np.asarray(scores, np.float32))

    def spy(x, scores, keep):
        # ordered: the host may run unordered callbacks in any order, and
        # the list's order is the blocks'
        jax.debug.callback(record, jax.lax.top_k(scores, keep)[1], scores, ordered=True)
        return real(x, scores, keep)

    monkeypatch.setattr(jtp, "topk_token_select", spy)
    return kept


def test_topk_token_select_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 41, 16)).astype(np.float32)
    scores = rng.permutation(120).reshape(3, 40).astype(np.float32) / 120  # distinct
    got, idx = topk_token_select(torch.from_numpy(x), torch.from_numpy(scores), 17)
    want = jtp.topk_token_select(jnp.asarray(x), jnp.asarray(scores), 17)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jax.lax.top_k(scores, 17)[1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pad", [0, 64])
def test_block_evit_matches_jax(pad, jax_kept):
    b, n = 2, 64
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, n, D)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (0, pad), (0, 0)))
    valid_len = n if pad else None
    jblk = JBlockEViT(num_heads=H, keep_rate=KEEP, attention_impl="xla")
    params = jax.jit(lambda xx: jblk.init({"params": jax.random.key(0)}, xx, train=False,
                                          valid_len=valid_len))(jnp.asarray(xp))["params"]
    params = jax.tree_util.tree_map(  # move LayerNorm affines and biases off 1/0
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32)
        if a.ndim == 1 else a, params)
    jax_kept.clear()  # init ran the block too
    (want, want_valid), vjp = jax.vjp(
        jax.jit(lambda p, xx: jblk.apply({"params": p}, xx, train=False, valid_len=valid_len)),
        params, jnp.asarray(xp))
    keep = int(KEEP * (n - 1))
    cot = rng.normal(size=(b, 1 + keep, D)).astype(np.float32)
    jg_params, jg_x = vjp((jnp.asarray(cot), None))
    jax.effects_barrier()

    state = {}
    _block_state(state, "", jax.device_get(params))
    blk = Block(D, H)
    blk.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    tx = torch.from_numpy(xp).requires_grad_()
    got, got_valid = blk.evit(tx, KEEP, valid_len)
    assert got_valid is None and want_valid is None
    np.testing.assert_array_equal(blk.evit_kept.numpy(), jax_kept[0])
    assert got.shape == (b, 1 + keep, D)
    assert _rel(got.detach(), want) <= 1e-5
    got.backward(torch.from_numpy(cot))
    assert _rel(tx.grad, jg_x) <= 1e-5
    assert not tx.grad[:, n:].any()  # padded rows feed nothing
    grads = {}
    _block_state(grads, "", jax.device_get(jg_params))
    for name, p in blk.named_parameters():
        assert _rel(p.grad, grads[name]) <= 1e-5, name


def _jax_model(dtype, impl="auto"):
    bb = jcv.ChannelVisionTransformer(num_total_channels=C, img_size=IMG, patch_size=P,
                                      embed_dim=D, depth=DEPTH, num_heads=H, keep_rate=KEEP,
                                      attention_impl=impl, dtype=dtype)
    return JClassifier(backbone=bb, embed_dim=D, num_classes=NC, with_head=True)


@pytest.fixture(scope="module")
def evit_setup():
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(2, len(IDS), IMG, IMG)).astype(np.float32)
    params = jax.jit(lambda xx: _jax_model(jnp.float32).init(
        {"params": jax.random.key(0)}, xx, jnp.asarray(IDS), train=False))(jnp.asarray(x))["params"]
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    moved = [  # LayerNorm affines and biases start at 1/0: move them off so they count
        np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)
        if any(getattr(k, "key", "") in ("bias", "scale", "proj_bias") for k in path)
        else np.asarray(a)
        for path, a in leaves
    ]
    params = jax.tree_util.tree_unflatten(tree, moved)
    return x, params, params_from_jax(params)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_evit_logits_match_jax(evit_setup, dtype, tol, jax_kept, monkeypatch):
    """f32 against the JAX model's XLA attention. bf16: with ``FORCE_ON_CPU``
    the JAX model takes its fused route for block 0 (as the port does) and
    its Pallas flash kernels, in interpret mode, for the EViT blocks. The
    port keeps the JAX side's tokens at every pruning layer; its own choice
    must match wherever the boundary gap exceeds ``MARGIN``."""
    x, params, sd = evit_setup
    monkeypatch.setattr(jfb, "FORCE_ON_CPU", True)
    jax_kept.clear()
    impl = "pallas" if dtype == "bfloat16" else "auto"
    want, _ = jax.jit(lambda p, xx: _jax_model(getattr(jnp, dtype), impl).apply(
        {"params": p}, xx, jnp.asarray(IDS), train=False))(params, jnp.asarray(x))
    jax.effects_barrier()
    assert len(jax_kept) == 3
    bb = ChannelVisionTransformer(C, IMG, P, D, DEPTH, H, keep_rate=KEEP,
                                  dtype=getattr(torch, dtype))
    model = ChannelAdaptiveClassifier(bb, D, NC, with_head=True).eval()
    model.load_state_dict(sd, strict=True)
    pruning = bb.blocks[1:]
    for blk, idx in zip(pruning, jax_kept):
        blk.evit_forced = torch.from_numpy(np.asarray(idx, np.int64))
    scores = []  # the port's scores at each pruning block
    real = tvit.topk_token_select

    def spy(xx, s, keep):
        scores.append(s.float())
        return real(xx, s, keep)

    monkeypatch.setattr(tvit, "topk_token_select", spy)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x), torch.tensor(IDS))
    assert [blk.evit_kept.shape[1] for blk in pruning] == [44, 30, 21]
    checked = 0
    for blk, theirs, s in zip(pruning, jax_kept, scores):
        keep = theirs.shape[1]
        top = torch.topk(s, keep + 1, dim=1).values
        for b, gap in enumerate((top[:, keep - 1] - top[:, keep]).tolist()):
            if gap > MARGIN[dtype]:
                checked += 1
                assert set(blk.evit_kept[b].tolist()) == set(theirs[b].tolist()), (b, gap)
    assert checked > 0
    assert _rel(got, want) <= tol


def test_keep_rate_is_a_run_time_knob():
    """Setting the backbone's ``keep_rate`` on a dense model gives the model
    built with it (the JAX serve script clones a dense module with it)."""
    cfg = {"in_channel_names": [f"c{i}" for i in range(C)], "img_size": [IMG], "patch_size": P,
           "pretrained_model_name": "test", "embed_dim": D, "depth": DEPTH, "num_heads": H}
    x, ids = torch.randn(2, 7, IMG, IMG), torch.tensor(IDS)
    dense = build_model("dichavit", Config(cfg), {"x": list(range(C))}, NC, device="cpu")
    pruned = build_model("dichavit", Config({**cfg, "keep_rate": KEEP}), {"x": list(range(C))},
                         NC, device="cpu")
    with torch.no_grad():
        before = dense(x, ids)[0]
        dense.feature_extractor.keep_rate = KEEP
        after = dense(x, ids)[0]
        assert torch.equal(after, pruned(x, ids)[0])
    assert not torch.equal(after, before)
