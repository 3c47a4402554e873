"""The port's JUMP-CP train augmentation (``ops/augment.py``) against the JAX
package's, op by op and as a whole.

The port's ops take their random parameters as ``draws``; the test makes
them by replaying the JAX function's own key splits (JAX
``ops/augment.py:129``: ``split(key, 4B)`` into four keys a sample; pad
:40, crop :49, flip :57 on keys 0-2, CoarseDropout :104 on key 3, Defocus
:91 on ``fold_in(key, 7)`` :137), so both sides augment alike. f32
throughout: the gathers, flips and masks are exact, the Defocus sums the
same products in another order, a few f32 ulps apart: atol 1e-6 on values
in [0, 2) (at most about 8 ulps there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.ops import augment as jaug
from diverse_channel_vit_torch.ops import augment as aug

B, C, H, W, SIZE, PAD = 6, 3, 40, 36, 32, 44
ATOL = 1e-6


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


def _imgs(seed=0):
    return np.random.default_rng(seed).uniform(0, 2, (B, C, H, W)).astype(np.float32)


def jax_draws(key, b, h, w, *, img_size=SIZE, pad_to=PAD):
    """The draws ``jumpcp_train_augment`` makes from ``key``, as the port's
    ``draws`` dict."""
    keys = jax.random.split(key, b * 4).reshape(b, 4)
    ph, pw = max(0, pad_to - h), max(0, pad_to - w)
    hp, wp = h + ph, w + pw
    d = {k: [] for k in ("pad_top", "pad_left", "crop_top", "crop_left", "flip_apply",
                         "flip_choice", "hole_top", "hole_left", "hole_apply")}
    for i in range(b):
        ks = keys[i]
        if ph or pw:
            k1, k2 = jax.random.split(ks[0])
            d["pad_top"].append(int(jax.random.randint(k1, (), 0, ph + 1)))
            d["pad_left"].append(int(jax.random.randint(k2, (), 0, pw + 1)))
        else:
            d["pad_top"].append(0)
            d["pad_left"].append(0)
        k1, k2 = jax.random.split(ks[1])
        d["crop_top"].append(int(jax.random.randint(k1, (), 0, hp - img_size + 1)))
        d["crop_left"].append(int(jax.random.randint(k2, (), 0, wp - img_size + 1)))
        k1, k2 = jax.random.split(ks[2])
        d["flip_apply"].append(bool(jax.random.uniform(k1) <= 0.5))
        d["flip_choice"].append(int(jax.random.randint(k2, (), 0, 5)))
        ky, kx, kp = jax.random.split(ks[3], 3)
        hmax = max(1, img_size - 10)
        d["hole_top"].append(np.asarray(jax.random.randint(ky, (10,), 0, hmax)))
        d["hole_left"].append(np.asarray(jax.random.randint(kx, (10,), 0, hmax)))
        d["hole_apply"].append(bool(jax.random.uniform(kp) <= 0.5))
    kp, kr = jax.random.split(jax.random.fold_in(key, 7))
    d = {k: torch.tensor(np.asarray(v)) for k, v in d.items()}
    d["defocus_radius"] = torch.tensor(np.asarray(jax.random.randint(kr, (b,), 0, 3))) + 1
    d["defocus_apply"] = torch.tensor(np.asarray(jax.random.uniform(kp, (b,)) <= 0.5))
    return d


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_pipeline_matches_jax():
    x = _imgs()
    mean, std = [0.5, 1.0, 1.5], [0.5, 1.0, 2.0]
    key = jax.random.key(3)
    want = jaug.jumpcp_train_augment(key, jnp.asarray(x), jnp.asarray(mean), jnp.asarray(std),
                                     img_size=SIZE, pad_to=PAD)
    d = jax_draws(key, B, H, W)
    # the draws exercise every branch: some samples flipped, blurred, holed
    assert 0 < int(d["flip_apply"].sum()) < B or 0 < int(d["defocus_apply"].sum()) < B
    got = aug.jumpcp_train_augment(None, torch.from_numpy(x), mean, std, img_size=SIZE,
                                   pad_to=PAD, draws=d)
    assert got.dtype == torch.float32 and got.shape == (B, C, SIZE, SIZE)
    _close(got, want)


def test_pad_and_crop_match_jax():
    x = _imgs(1)
    d = jax_draws(jax.random.key(5), B, H, W)
    keys = jax.random.split(jax.random.key(5), B * 4).reshape(B, 4)
    want = jax.vmap(lambda img, ks: jaug.random_crop(ks[1], jaug.pad_random(ks[0], img, PAD),
                                                     SIZE))(jnp.asarray(x), keys)
    got = aug.pad_crop(torch.from_numpy(x), d["pad_top"], d["pad_left"], d["crop_top"],
                       d["crop_left"], img_size=SIZE, pad_to=PAD)
    _close(got, want)
    # an image already pad_to wide is cropped, not padded
    big = np.random.default_rng(2).normal(size=(B, C, PAD, PAD)).astype(np.float32)
    d = jax_draws(jax.random.key(6), B, PAD, PAD)
    keys = jax.random.split(jax.random.key(6), B * 4).reshape(B, 4)
    want = jax.vmap(lambda img, ks: jaug.random_crop(ks[1], jaug.pad_random(ks[0], img, PAD),
                                                     SIZE))(jnp.asarray(big), keys)
    got = aug.pad_crop(torch.from_numpy(big), d["pad_top"], d["pad_left"], d["crop_top"],
                       d["crop_left"], img_size=SIZE, pad_to=PAD)
    _close(got, want)


@pytest.mark.parametrize("choice", range(5))
def test_flip_rotate_matches_jax(choice):
    x = _imgs(2)[:, :, :SIZE, :SIZE]
    apply = np.array([True, False, True, True, False, True])
    want = np.stack([np.asarray(jax.lax.switch(choice, [
        lambda t: jnp.flip(t, 2), lambda t: jnp.flip(t, 1), lambda t: jnp.rot90(t, 1, (1, 2)),
        lambda t: jnp.rot90(t, 2, (1, 2)), lambda t: jnp.rot90(t, 3, (1, 2))],
        jnp.asarray(img))) if a else img for img, a in zip(x, apply)])
    got = aug.flip_rotate_one_of(torch.from_numpy(x), torch.from_numpy(apply),
                                 torch.full((B,), choice))
    _close(got, want)


def test_defocus_matches_jax():
    x = _imgs(3)[:, :, :SIZE, :SIZE]
    key = jax.random.key(9)
    want = jaug.defocus_batch(key, jnp.asarray(x))
    kp, kr = jax.random.split(key)
    radius = torch.as_tensor(np.asarray(jax.random.randint(kr, (B,), 0, 3))) + 1
    apply = torch.as_tensor(np.asarray(jax.random.uniform(kp, (B,)) <= 0.5))
    got = aug.defocus(torch.from_numpy(x), radius, apply)
    _close(got, want)
    # every radius, every sample blurred
    for r in (1, 2, 3):
        want = jaug.defocus_batch(key, jnp.asarray(x), radii=(r,), p=1.0)
        got = aug.defocus(torch.from_numpy(x), torch.full((B,), r), torch.ones(B, dtype=bool))
        _close(got, want)


def test_coarse_dropout_matches_jax():
    x = _imgs(4)[:, :, :SIZE, :SIZE]
    keys = jax.random.split(jax.random.key(11), B)
    want = jax.vmap(lambda img, k: jaug.coarse_dropout(k, img, 10, 10, 10, p=1.0))(
        jnp.asarray(x), keys)
    tops, lefts = [], []
    for k in keys:
        ky, kx, _ = jax.random.split(k, 3)
        tops.append(np.asarray(jax.random.randint(ky, (10,), 0, SIZE - 10)))
        lefts.append(np.asarray(jax.random.randint(kx, (10,), 0, SIZE - 10)))
    got = aug.coarse_dropout(torch.from_numpy(x), torch.as_tensor(np.stack(tops)),
                             torch.as_tensor(np.stack(lefts)), torch.ones(B, dtype=bool))
    _close(got, want)
    assert (got == 0).any()


def test_own_draws_stay_in_range():
    g = torch.Generator().manual_seed(0)
    n = 4096
    d = aug.make_draws(g, n, H, W, img_size=SIZE, pad_to=PAD)
    ranges = {"pad_top": (0, PAD - H), "pad_left": (0, PAD - W),
              "crop_top": (0, PAD - SIZE), "crop_left": (0, PAD - SIZE),
              "flip_choice": (0, 4), "defocus_radius": (1, 3),
              "hole_top": (0, SIZE - 11), "hole_left": (0, SIZE - 11)}
    for k, (lo, hi) in ranges.items():
        assert int(d[k].min()) == lo and int(d[k].max()) == hi, k
    for k in ("flip_apply", "defocus_apply", "hole_apply"):
        assert d[k].dtype == torch.bool and 0.45 < float(d[k].float().mean()) < 0.55, k
    assert d["hole_top"].shape == (n, 10)
    out = aug.jumpcp_train_augment(g, torch.from_numpy(_imgs()), [0.0] * C, [1.0] * C,
                                   img_size=SIZE, pad_to=PAD)
    assert out.shape == (B, C, SIZE, SIZE) and torch.isfinite(out).all()
