"""The port's ``flash_attention_packed`` (B5 forward, B6 backward) against the
JAX package's.

On the CPU the port's wrappers run their plain versions, at head width 64
and 128. The JAX side runs
two ways: ``flash_attention_packed``, whose Pallas kernels
``_packed_fwd_kernel`` and ``_packed_bwd_kernel`` run in interpret mode
(``attention.INTERPRET`` is set for the session by tests/conftest.py), and
``multi_head_attention_packed(impl="xla")``, the XLA einsum path. The same
numpy inputs, made from a seed, go to both; keys at or past ``valid_len``
are masked (None: every key valid). Values, and gradients of q, k and v by
``jax.vjp`` against autograd through ``FlashPackedFn``.

Tolerances, max|port - jax| <= tol * max|jax| per output: in f32 both sides
compute the same f32 arithmetic in other orders (the XLA path normalises P
before the product, the kernels after), tol 1e-5. In bf16 both round P and
dS to bf16 before their products, at slightly different values, so an output
may land a bf16 ulp or two (2^-7 relative) apart: tol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.ops import attention as jat
from diverse_channel_vit_torch.ops import attention as at

B, N = 2, 128
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)), t


def _inputs(heads, dtype, seed, dh=64):
    rng = np.random.default_rng(seed)
    d = dh * heads
    return [_pair(rng.normal(size=(B, N, d)), dtype) for _ in range(4)]  # q, k, v, do


def _jax_fn(impl, heads, valid_len):
    if impl == "pallas":
        return lambda q, k, v: jat.flash_attention_packed(q, k, v, heads, valid_len=valid_len)
    return lambda q, k, v: jat.multi_head_attention_packed(q, k, v, heads, impl="xla",
                                                           valid_len=valid_len)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("heads,valid_len", [(2, None), (2, N - 19), (6, N - 75)])
def test_flash_packed_matches_jax(dtype, impl, heads, valid_len, dh=64):
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(heads, dtype, 7 + heads, dh)
    want, vjp = jax.vjp(jax.jit(_jax_fn(impl, heads, valid_len)), jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    got = at.flash_attention_packed(*leaves, heads, valid_len=valid_len)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _rel(got.detach(), want) <= TOL[dtype]
    got.backward(tdo)
    for name, g, w in zip("qkv", (t.grad for t in leaves), vjp(jdo)):
        assert g.dtype == tq.dtype, name
        assert _rel(g, w) <= TOL[dtype], name
        if name != "q" and valid_len is not None:  # padded keys get exact zeros
            assert not g[:, valid_len:].any(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("heads,valid_len", [(1, None), (3, N - 19)])
def test_flash_packed_matches_jax_dh128(dtype, impl, heads, valid_len):
    """Head width 128 (the small_tpu preset's): one head, and 3 heads with
    padded keys."""
    test_flash_packed_matches_jax(dtype, impl, heads, valid_len, dh=128)


def test_flash_packed_plain_is_pallas_kernel_on_views_of_one_qkv():
    """The plain versions take q, k and v as the thirds of one packed qkv
    tensor (strided views, as the model passes them) and give the Pallas
    kernels' values; the backward's three gradients match the TPU backward
    kernel ``_packed_bwd_impl`` called directly."""
    heads, n_valid, dt = 6, N - 40, "bfloat16"
    rng = np.random.default_rng(3)
    jqkv, tqkv = _pair(rng.normal(size=(B, N, 3 * 64 * heads)), dt)
    jdo, tdo = _pair(rng.normal(size=(B, N, 64 * heads)), dt)
    d = 64 * heads
    jq, jk, jv = (jqkv[..., i * d:(i + 1) * d] for i in range(3))
    tq, tk, tv = tqkv.split(d, dim=-1)
    assert not tq.is_contiguous()
    scale = 64 ** -0.5
    jo = jat._packed_fwd_impl(jq, jk, jv, heads, scale, n_valid, 128)
    o, lse = at.flash_packed_fwd_plain(tq, tk, tv, heads, scale, n_valid, need_lse=True)
    assert _rel(o, jo) <= TOL[dt]
    want = jat._packed_bwd_impl(jq, jk, jv, jo, jdo, heads, scale, n_valid)
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(tq.dtype)
    got = at.flash_packed_bwd_plain(tq, tk, tv, to, tdo, lse, heads, scale, n_valid)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) <= TOL[dt], name


def test_flash_packed_backward_is_the_forward_gradient():
    """In f32 the hand-written backward (from the forward's log-sum-exp)
    equals autograd through the plain forward's own arithmetic, rel 1e-5."""
    heads, n_valid = 2, N - 3
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, N, 128)).astype(np.float32))
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    at.flash_packed_fwd_plain(*leaves, heads, 0.125, n_valid)[0].backward(do)
    o, lse = at.flash_packed_fwd_plain(q, k, v, heads, 0.125, n_valid, need_lse=True)
    for name, g, w in zip("qkv", at.flash_packed_bwd_plain(q, k, v, o, do, lse, heads, 0.125,
                                                           n_valid), leaves):
        assert _rel(g, w.grad) <= 1e-5, name
