"""The port's fused-block backward passes against the JAX package's.

On the CPU the port's wrappers run their plain versions; the JAX functions
run their Pallas kernels in interpret mode (``attention.INTERPRET`` is set
for the session by tests/conftest.py). The same numpy inputs, made from a
seed, go to both; weights go to the port in ``nn.Linear`` layout, the
transpose of the JAX layout. Keys at or past ``n_valid`` are masked.

- The plain backwards against ``_ap_bwd_impl`` and ``_ln_mlp_bwd_impl``, every
  output.
- The autograd Functions (``attend_project`` and ``ln_mlp`` with gradients
  on) against ``jax.grad`` through the JAX custom VJPs, every input.
- ``attend_project`` at head width 64 (D = 128, 2 heads) and 128 (D = 256,
  2 heads, the ``small_tpu`` preset's head width); ``ln_mlp``'s backward
  also at the ``base`` preset's widths (D = 768, hidden 3072).

Tolerances, max|port - jax| <= tol * max|jax| per output: in f32 both sides
compute the same f32 arithmetic in other orders, tol 1e-5. In bf16 both
round at the same points, so an output may land a bf16 ulp or two (2^-7
relative) apart: tol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.ops import fused_block as jfb
from diverse_channel_vit_torch.ops import fused_block as fb

B, N, D, H = 2, 128, 128, 2
N_VALID = N - 19
SCALE = (D // H) ** -0.5
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)), t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_project_bwd_plain_matches_pallas_kernel(dtype, d=D):
    rng = np.random.default_rng(11)
    scale = (d // H) ** -0.5
    jqkv, tqkv = _pair(rng.normal(size=(B, N, 3 * d)), dtype)
    jwp, twp = _pair(0.2 * rng.normal(size=(d, d)), dtype)  # JAX layout (D, D_out)
    jbp, tbp = _pair(0.2 * rng.normal(size=(d,)), dtype)
    jdxo, tdxo = _pair(rng.normal(size=(B, N, d)), dtype)
    # the forward's o from the Pallas kernel feeds both backwards; lse from the port's
    jo, _ = jfb._ap_fwd_impl(jqkv, None, jwp, jbp, H, scale, N_VALID, jfb._pick_block_fwd(N),
                             False)
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(tqkv.dtype)
    _, tlse, _ = fb.attend_project_fwd_plain(tqkv, None, twp.t(), tbp, H, scale, N_VALID,
                                             need_o=True)
    dq, dk, dv, dwp, dbp, db3 = jfb._ap_bwd_impl(jqkv, jo, jwp, jdxo, H, scale, N_VALID)
    dqkv, got_dwp, got_dbp, got_db = fb.attend_project_bwd(
        tqkv, to, tlse, twp.t().contiguous(), tdxo, H, scale, N_VALID)
    assert dqkv.dtype == tqkv.dtype and got_dwp.dtype == torch.float32
    for got, want in ((dqkv[..., :d], dq), (dqkv[..., d:2 * d], dk), (dqkv[..., 2 * d:], dv),
                      (got_dwp.t(), dwp), (got_dbp, dbp), (got_db, db3)):
        assert _rel(got, want) <= TOL[dtype]
    # padded key rows: exact zeros in dk and dv
    assert torch.count_nonzero(dqkv[:, N_VALID:, d:]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_project_bwd_plain_matches_pallas_kernel_dh128(dtype):
    """2 heads of 128 (D = 256)."""
    test_attend_project_bwd_plain_matches_pallas_kernel(dtype, d=2 * D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_ln_mlp_bwd_plain_matches_pallas_kernel(dtype, residual, d=D, grid=(B, N)):
    rng = np.random.default_rng(12)
    jx, tx = _pair(rng.normal(size=(*grid, d)), dtype)
    scale = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    jw1, tw1 = _pair(0.05 * rng.normal(size=(d, 4 * d)), dtype)
    jb1, tb1 = _pair(0.05 * rng.normal(size=(4 * d,)), dtype)
    jw2, tw2 = _pair(0.05 * rng.normal(size=(4 * d, d)), dtype)
    jdo, tdo = _pair(rng.normal(size=(*grid, d)), dtype)
    want = jfb._ln_mlp_bwd_impl(jx, jnp.asarray(scale), jnp.asarray(bias), jw1, jb1, jw2, jdo,
                                residual)
    got = fb.ln_mlp_bwd(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                        tw1.t().contiguous(), tb1, tw2.t().contiguous(), tdo, residual)
    assert got[0].dtype == tx.dtype and all(g.dtype == torch.float32 for g in got[1:])
    # dw1 and dw2 are in nn.Linear layout, the transpose of the JAX one
    got = (got[0], got[1].t(), got[2], got[3].t(), *got[4:])
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2", "ds", "db"), got, want):
        assert _rel(g, w) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_ln_mlp_bwd_plain_matches_pallas_kernel_d768(dtype, residual):
    """The base preset's widths, D = 768 and hidden 3072, on 120 rows (one
    ragged row block), every output, at the tolerances above."""
    test_ln_mlp_bwd_plain_matches_pallas_kernel(dtype, residual, d=768, grid=(1, 120))


def _cotangent(rng, shape, dtype):
    """A cotangent whose values the output dtype holds exactly, so that
    jnp.sum(out.astype(f32) * g) hands the same cotangent to both sides."""
    return _pair(rng.normal(size=shape), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_attend_project_function_matches_jax_grad(dtype, with_residual, d=D):
    rng = np.random.default_rng(13)
    names = ("y", "w", "b", "wp", "bp", "x")
    s = 0.2 * (D / d) ** 0.5  # the same score scale at every width
    arrs = dict(y=rng.normal(size=(B, N, d)), w=s * rng.normal(size=(d, 3 * d)),
                b=0.2 * rng.normal(size=(3 * d,)), wp=s * rng.normal(size=(d, d)),
                bp=0.2 * rng.normal(size=(d,)), x=rng.normal(size=(B, N, d)))
    pairs = {k: _pair(v, dtype) for k, v in arrs.items()}
    jg, tg = _cotangent(rng, (B, N, d), dtype)

    def jloss(y, w, b, wp, bp, x):
        out = jfb.attend_project(y, w, b, wp, bp, x if with_residual else None, H,
                                 valid_len=N_VALID)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(jloss, argnums=tuple(range(6)))(*(pairs[k][0] for k in names))
    t = {k: pairs[k][1].clone().requires_grad_() for k in names}
    # the port's weights are in nn.Linear layout
    tw, twp = t["w"].t(), t["wp"].t()
    out = fb.attend_project(t["y"], tw, t["b"], twp, t["bp"],
                            t["x"] if with_residual else None, H, valid_len=N_VALID)
    out.backward(tg)
    for k, w in zip(names, want):
        if k == "x" and not with_residual:
            assert t[k].grad is None
            continue
        assert t[k].grad.dtype == t[k].dtype
        assert _rel(t[k].grad, w) <= TOL[dtype], k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_attend_project_function_matches_jax_grad_dh128(dtype, with_residual):
    """2 heads of 128 (D = 256)."""
    test_attend_project_function_matches_jax_grad(dtype, with_residual, d=2 * D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_ln_mlp_function_matches_jax_grad(dtype, residual):
    rng = np.random.default_rng(14)
    names = ("x", "s", "bi", "w1", "b1", "w2", "b2")
    pairs = dict(
        x=_pair(rng.normal(size=(B, N, D)), dtype),
        s=_pair(1.0 + 0.1 * rng.normal(size=(D,)), "float32"),
        bi=_pair(0.1 * rng.normal(size=(D,)), "float32"),
        w1=_pair(0.05 * rng.normal(size=(D, 4 * D)), dtype),
        b1=_pair(0.05 * rng.normal(size=(4 * D,)), dtype),
        w2=_pair(0.05 * rng.normal(size=(4 * D, D)), dtype),
        b2=_pair(0.05 * rng.normal(size=(D,)), dtype),
    )
    jg, tg = _cotangent(rng, (B, N, D), dtype)

    def jloss(*a):
        out = jfb.ln_mlp(*a, residual)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(jloss, argnums=tuple(range(7)))(*(pairs[k][0] for k in names))
    t = {k: pairs[k][1].clone().requires_grad_() for k in names}
    out = fb.ln_mlp(t["x"], t["s"], t["bi"], t["w1"].t(), t["b1"], t["w2"].t(), t["b2"],
                    residual)
    out.backward(tg)
    for k, w in zip(names, want):
        assert t[k].grad.dtype == t[k].dtype
        assert _rel(t[k].grad, w) <= TOL[dtype], k


def test_backward_route_follows_the_forward(monkeypatch):
    """A backward takes the route its forward took; on CPU tensors that is
    the plain version, and no kernel launch is counted."""
    calls = []
    real = fb.ln_mlp_bwd_plain
    monkeypatch.setattr(fb, "ln_mlp_bwd_plain", lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(15)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()
    before = dict(fb.LAUNCHES)
    out = fb.ln_mlp(t(1, 64, 64), t(64), t(64), t(256, 64), t(256), t(64, 256), t(64), True)
    out.sum().backward()
    assert calls == [1] and fb.LAUNCHES == before
    with torch.no_grad():  # no gradient wanted: no Function, no saved tensors
        assert fb.ln_mlp(t(1, 64, 64), t(64), t(64), t(256, 64), t(256), t(64, 256),
                         t(64)).grad_fn is None
