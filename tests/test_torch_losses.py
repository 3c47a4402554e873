"""The port's losses against the JAX package's, values and gradients.

The same numpy inputs, made from a seed, go to ``ops/losses.py`` of both
packages; gradients are taken by ``jax.grad`` and by torch autograd with
respect to every float input. Both compute in f32 in other summation orders:
rtol 1e-5 with a small atol for entries near 0 (1e-6 of the largest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.ops import losses as jl
from diverse_channel_vit_torch.ops import losses as tl


def _close(got, want):
    got = torch.as_tensor(got).detach().numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * float(np.abs(want).max()))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_()


@pytest.mark.parametrize("soft", [False, True])
def test_cross_entropy_loss(soft):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, size=6)
    if soft:
        labels = rng.dirichlet(np.ones(5), size=6).astype(np.float32)
    want, gw = jax.value_and_grad(jl.cross_entropy_loss)(jnp.asarray(logits), jnp.asarray(labels))
    tlog = _t(logits)
    got = tl.cross_entropy_loss(tlog, torch.from_numpy(labels))
    got.backward()
    _close(got, want)
    _close(tlog.grad, gw)


@pytest.mark.parametrize("eye_labels,scale", [(True, 3.0), (False, 3.0), (False, 1.7)])
def test_proxy_loss(eye_labels, scale):
    """``eye_labels`` is the CDL call (probability labels, one proxy per
    channel); int labels are the proxy main loss."""
    rng = np.random.default_rng(1)
    k = 5
    proxies = rng.normal(size=(k, 16)).astype(np.float32) / 8
    emb = rng.normal(size=(k if eye_labels else 7, 16)).astype(np.float32)
    labels = np.eye(k, dtype=np.float32) if eye_labels else rng.integers(0, k, size=7)
    want, (gp, ge) = jax.value_and_grad(jl.proxy_loss, argnums=(0, 1))(
        jnp.asarray(proxies), jnp.asarray(emb), jnp.asarray(labels), scale)
    tp, te = _t(proxies), _t(emb)
    got = tl.proxy_loss(tp, te, torch.from_numpy(labels), scale)
    got.backward()
    _close(got, want)
    _close(tp.grad, gp)
    _close(te.grad, ge)


@pytest.mark.parametrize("mask", [None, "channels", "per_sample"])
@pytest.mark.parametrize("reverse_pos_pairs,use_square", [(False, False), (True, True),
                                                          (False, True)])
def test_orthogonal_projection_loss(mask, reverse_pos_pairs, use_square):
    rng = np.random.default_rng(2)
    b, c, n, d = 3, 4, 9, 16
    feats = rng.normal(size=(b, c, n, d)).astype(np.float32)
    # correlated tokens within a channel so the positive and negative sums differ
    feats += rng.normal(size=(b, c, 1, d)).astype(np.float32)
    channel_mask = {None: None, "channels": np.array([True, False, True, True]),
                    "per_sample": rng.random((b, c)) > 0.3}[mask]
    kw = dict(gamma_s=1.0, gamma_d=4.0, reverse_pos_pairs=reverse_pos_pairs,
              use_square=use_square)

    def jfn(f):
        cm = None if channel_mask is None else jnp.asarray(channel_mask)
        return jl.orthogonal_projection_loss(f, channel_mask=cm, **kw)

    want, gw = jax.value_and_grad(jfn)(jnp.asarray(feats))
    tf = _t(feats)
    got = tl.orthogonal_projection_loss(
        tf, channel_mask=None if channel_mask is None else torch.from_numpy(channel_mask), **kw)
    got.backward()
    _close(got, want)
    _close(tf.grad, gw)


def test_orthogonal_projection_loss_matches_dense_formula():
    """The sum identity against the JAX package's literal O(N^2 D) form."""
    rng = np.random.default_rng(3)
    b, c, n, d = 2, 3, 5, 8
    feats = rng.normal(size=(b, c, n, d)).astype(np.float32)
    labels = jnp.repeat(jnp.arange(c), n)
    want = jl.orthogonal_projection_loss_dense(jnp.asarray(feats.reshape(b, c * n, d)), labels,
                                               1.0, 4.0, False, False)
    got = tl.orthogonal_projection_loss(torch.from_numpy(feats), 1.0, 4.0, False, False)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
