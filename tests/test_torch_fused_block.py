"""The port's fused-block ops against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX functions
run their Pallas kernels in interpret mode (``attention.INTERPRET`` is set
for the session by tests/conftest.py). The same numpy inputs, made from a
seed, go to both. Weights go to the port in ``nn.Linear`` layout, the
transpose of the JAX functions' layout.

Tolerances: in f32 both sides compute the same f32 arithmetic in other
orders, rel <= 1e-5 (as tests/test_fused_block.py holds the kernel to its XLA
composition). In bf16 both round at the same points, so an output may land a
bf16 ulp or two (2^-7 relative) apart: rel <= 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.ops import fused_block as jfb
from diverse_channel_vit_torch.ops import fused_block as fb
from diverse_channel_vit_torch.ops import kernels

B, N, D, H = 2, 128, 128, 2
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)), t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_ln_mlp_plain_matches_pallas_kernel(dtype, residual):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(D,))).astype(np.float32)
    w1 = (0.05 * rng.normal(size=(D, 4 * D))).astype(np.float32)
    b1 = (0.05 * rng.normal(size=(4 * D,))).astype(np.float32)
    w2 = (0.05 * rng.normal(size=(4 * D, D))).astype(np.float32)
    b2 = (0.05 * rng.normal(size=(D,))).astype(np.float32)

    jx, tx = _pair(x, dtype)
    (jw1, tw1), (jb1, tb1) = _pair(w1, dtype), _pair(b1, dtype)
    (jw2, tw2), (jb2, tb2) = _pair(w2, dtype), _pair(b2, dtype)
    want = jfb.ln_mlp(jx, jnp.asarray(scale), jnp.asarray(bias), jw1, jb1, jw2, jb2, residual)
    got = fb.ln_mlp(tx, torch.from_numpy(scale), torch.from_numpy(bias), tw1.t().contiguous(),
                    tb1, tw2.t().contiguous(), tb2, residual)
    assert got.dtype == tx.dtype and got.shape == (B, N, D)
    assert _rel(got, want) <= TOL[dtype]


def _attend_inputs(dtype):
    rng = np.random.default_rng(7)
    arrs = dict(
        y=rng.normal(size=(B, N, D)), x=rng.normal(size=(B, N, D)),
        w=0.2 * rng.normal(size=(D, 3 * D)), b=0.2 * rng.normal(size=(3 * D,)),
        wp=0.2 * rng.normal(size=(D, D)), bp=0.2 * rng.normal(size=(D,)),
    )
    return {k: _pair(v.astype(np.float32), dtype) for k, v in arrs.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_attend_project_plain_matches_pallas_kernel(dtype, with_residual):
    a = _attend_inputs(dtype)
    valid = N - 3  # padded keys are masked
    want = jfb.attend_project(a["y"][0], a["w"][0], a["b"][0], a["wp"][0], a["bp"][0],
                              a["x"][0] if with_residual else None, H, valid_len=valid)
    got = fb.attend_project(a["y"][1], a["w"][1].t().contiguous(), a["b"][1],
                            a["wp"][1].t().contiguous(), a["bp"][1],
                            a["x"][1] if with_residual else None, H, valid_len=valid)
    assert got.shape == (B, N, D)
    assert _rel(got, want) <= TOL[dtype]


def test_attend_project_fwd_o_matches_pallas_kernel():
    """The optional head-concatenated output ``o`` (kept for a backward)."""
    a = _attend_inputs("float32")
    jqkv = jfb._project(a["y"][0], a["w"][0], a["b"][0])
    want_o, want_xo = jfb._ap_fwd_impl(jqkv, a["x"][0], a["wp"][0], a["bp"][0], H, 0.125,
                                       100, jfb._pick_block_fwd(N), True)
    tqkv = fb.project(a["y"][1], a["w"][1].t().contiguous(), a["b"][1])
    got_o, got_lse, got_xo = fb.attend_project_fwd(tqkv, a["x"][1], a["wp"][1].t().contiguous(),
                                                   a["bp"][1], H, 0.125, 100, need_o=True)
    assert _rel(got_o, want_o) <= 1e-5
    assert _rel(got_xo, want_xo) <= 1e-5
    assert got_lse.shape == (B, H, N) and got_lse.dtype == torch.float32
    o_none, lse_none, _ = fb.attend_project_fwd(tqkv, a["x"][1], a["wp"][1].t().contiguous(),
                                                a["bp"][1], H, 0.125, 100)
    assert o_none is None and lse_none is None


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    before = dict(fb.LAUNCHES)
    args = (t(1, 64, 64), t(64), t(64), t(256, 64), t(256), t(64, 256), t(64), True)
    assert torch.equal(fb.ln_mlp(*args), fb.ln_mlp_plain(*args))
    qkv_args = (t(1, 64, 192), t(1, 64, 64), t(64, 64), t(64), 1, 0.125, 50)
    assert torch.equal(fb.attend_project_fwd(*qkv_args)[2],
                       fb.attend_project_fwd_plain(*qkv_args)[2])
    assert fb.LAUNCHES == before


def test_no_kernel_for_other_devices():
    x = torch.empty(1, 64, 384, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fb.ln_mlp(x, x[0, 0], x[0, 0], x, x, x, x)


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.function("ln_mlp")
