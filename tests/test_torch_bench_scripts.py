"""The port's kernel benchmark scripts (``diverse_channel_vit_torch/scripts/``)
against the JAX scripts they mirror (``scripts/bench_attn.py``,
``scripts/bench_block_fusion.py``, ``scripts/bench_int8_lnmlp.py``).

The JAX scripts are loaded by path with ``importlib``. Their Pallas
prototypes run on the CPU in interpret mode, set at run time and restored in
a ``finally``: the scripts' module attribute ``pl`` is replaced by a
namespace whose ``pallas_call`` passes ``interpret=True`` (S1, S2), S2's
module constants ``N``, ``H`` and ``SM`` are set to the test's geometry, and
S3 reads ``attention.INTERPRET``, which tests/conftest.py sets. Their
persistent-compile-cache call at import is a no-op while they load. No file
is edited.

The same numpy inputs, made from a seed and rounded to bf16 on both sides,
go to the JAX function and to the port's plain version (on the CPU every
wrapper runs its plain version). Weights go to the port in ``nn.Linear``
layout, the transpose of the JAX layout.

Tolerances. bf16 outputs: max|port - jax| <= 2e-2 * max|jax|. Both sides
round at the same points (P and dS to bf16 before their products, each
output once) but sum in other orders, and S1's JAX kernel accumulates dk and
dv block by block, so an output may land a bf16 ulp or two (2^-7 relative)
apart. int8 codes: at most a 1e-2 share may differ (a value within f32 noise
of a .5 tie rounds the other way), as in tests/test_torch_int8.py; the weight
codes of ``quant_w``, eager on both sides, are held equal.

Each port script also runs its experiments once on the CPU route at a tiny
size, through the functions its command line calls.
"""

import functools
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from diverse_channel_vit_tpu import compile_cache
from diverse_channel_vit_torch.ops.dispatch import LAUNCHES
from diverse_channel_vit_torch.scripts import bench_attn as s1
from diverse_channel_vit_torch.scripts import bench_block_fusion as s2
from diverse_channel_vit_torch.scripts import bench_int8_lnmlp as s3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-2
MAX_CODE_FLIPS = 1e-2
# the geometry of the attention cases: two heads of 64, ragged key mask
B, N, D, H, N_VALID = 1, 128, 128, 2, 100
SM = (D // H) ** -0.5


@functools.lru_cache(maxsize=None)
def _jax_script(name: str):
    """Load ``scripts/<name>.py`` as a module of its own, its compile-cache
    call a no-op and ``sys.path`` restored afterwards."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    enable, path = compile_cache.enable, list(sys.path)
    compile_cache.enable = lambda *a, **k: None
    try:
        spec.loader.exec_module(mod)
    finally:
        compile_cache.enable = enable
        sys.path[:] = path
    return mod


def _interpreted_pl():
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return ns


def _set(mod, **attrs):
    """Set module attributes; returns the old values for :func:`_restore`."""
    old = {k: getattr(mod, k) for k in attrs}
    for k, v in attrs.items():
        setattr(mod, k, v)
    return old


def _restore(mod, old):
    for k, v in old.items():
        setattr(mod, k, v)


def _bf16_pair(rng, *shape, scale=1.0):
    """The same bf16 values as a JAX array and a torch tensor."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _close(got, want):
    got, want = np.asarray(got.float()), np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) <= TOL * float(np.abs(want).max())


@pytest.mark.parametrize("variant", ["pair_staged", "pair_batched"])
def test_bwd_call_plain_matches_jax(variant):
    """S1: the port's plain ``bwd_call`` against ``_bwd_call`` in interpret
    mode, two query blocks of 64 so dk and dv accumulate across blocks."""
    mod = _jax_script("bench_attn")
    rng = np.random.default_rng(0)
    pairs = [_bf16_pair(rng, B, N, D) for _ in range(5)]
    old = _set(mod, pl=_interpreted_pl())
    try:
        want = mod._bwd_call(*(p[0] for p in pairs), H, SM, N_VALID, 64, variant)
    finally:
        _restore(mod, old)
    got = s1.bwd_call(*(p[1] for p in pairs), H, SM, N_VALID, variant)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and _close(g, w), name
    assert torch.count_nonzero(got[1][:, N_VALID:]) == 0
    assert torch.count_nonzero(got[2][:, N_VALID:]) == 0


def test_qkv_flash_fwd_plain_matches_jax():
    """S2: the port's plain ``qkv_flash_fwd`` against the JAX one in
    interpret mode, its module constants set to this geometry."""
    mod = _jax_script("bench_block_fusion")
    jq, tq = _bf16_pair(np.random.default_rng(1), B, N, 3 * D)
    old = _set(mod, pl=_interpreted_pl(), N=N_VALID, H=H, SM=SM)
    try:
        want = mod.qkv_flash_fwd(jq, 64)
    finally:
        _restore(mod, old)
    got = s2.qkv_flash_fwd(tq, H, SM, N_VALID)
    assert got.dtype == torch.bfloat16 and _close(got, want)


def test_block_v0_matches_jax():
    """One v0 block of the fusion benchmark (LayerNorm, three GEMMs,
    ``flash_attention_packed``, proj, MLP) against the JAX script's, whose
    flash kernel runs in interpret mode."""
    mod = _jax_script("bench_block_fusion")
    rng = np.random.default_rng(2)
    jx, tx = _bf16_pair(rng, B, N, D)
    jp = mod.make_params(jax.random.key(3), fused_qkv=False)
    tp = {}
    for k, v in jp.items():
        t = torch.from_numpy(np.array(jnp.asarray(v, jnp.float32))).to(
            torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        tp[k] = t.t().contiguous() if t.ndim == 2 else t
    # the JAX script's weights are D = 384 wide; cut this block to D
    jp = {k: (v[:D, :D] if k in ("wq", "wk", "wv", "proj_w") else
              v[:D, :4 * D] if k == "fc1_w" else v[:4 * D, :D] if k == "fc2_w" else
              v[:4 * D] if k == "fc1_b" else v[:D]) for k, v in jp.items()}
    tp = {k: (v[:D, :D] if k in ("wq", "wk", "wv", "proj_w") else
              v[:4 * D, :D] if k == "fc1_w" else v[:D, :4 * D] if k == "fc2_w" else
              v[:4 * D] if k == "fc1_b" else v[:D]).contiguous() for k, v in tp.items()}
    old = _set(mod, N=N_VALID, H=H, SM=SM)
    try:
        want = mod.block_v0(jp, jx)
    finally:
        _restore(mod, old)
    got = s2.block_v0(tp, tx, heads=H, n_valid=N_VALID)
    assert _close(got, want)


def test_int8_ln_mlp_plain_matches_jax():
    """S3: the port's plain ``int8_ln_mlp`` against the JAX prototype's
    kernel in interpret mode, each side's weights from its own
    ``quant_w``."""
    mod = _jax_script("bench_int8_lnmlp")
    d, hid = 384, 1536
    rng = np.random.default_rng(4)
    jx, tx = _bf16_pair(rng, 1, 64, d)
    jw1, tw1 = _bf16_pair(rng, d, hid, scale=0.05)
    jw2, tw2 = _bf16_pair(rng, hid, d, scale=0.05)
    jb1, tb1 = _bf16_pair(rng, hid, scale=0.1)
    jb2, tb2 = _bf16_pair(rng, d, scale=0.1)
    s = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    jw1q, js1 = mod.quant_w(jw1)
    jw2q, js2 = mod.quant_w(jw2)
    w1q, s1c = s3.quant_w(tw1.t())
    w2q, s2c = s3.quant_w(tw2.t())
    for got, want in ((w1q, jw1q), (w2q, jw2q)):
        flips = (got.t().numpy() != np.asarray(want)).mean()
        assert flips <= MAX_CODE_FLIPS
        assert flips == 0.0  # eager true division on both sides
    for got, want in ((s1c, js1), (s2c, js2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    for residual in (True, False):
        want = mod.int8_ln_mlp(jx, jnp.asarray(s), jnp.asarray(b), jw1q, js1, jb1, jw2q, js2,
                               jb2, residual)
        got = s3.int8_ln_mlp(tx, torch.from_numpy(s), torch.from_numpy(b), w1q, s1c, tb1, w2q,
                             s2c, tb2, residual)
        assert got.dtype == torch.bfloat16 and _close(got, want), residual


@pytest.fixture
def one_thread():
    """Run torch on one CPU thread inside the test (restored after): the
    scripts' many small ops on a machine whose cores are taken by other
    test workers otherwise wait on an oversubscribed thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_bench_attn_runs_on_the_cpu(capsys, one_thread):
    before = dict(LAUNCHES)
    tiny = ["--batch", "1", "--n", "100", "--dim", "128", "--heads", "2"]
    for exp in ("chain", "bwd-variants"):
        s1.main([exp, *tiny], device="cpu")
    for exp in (s1.exp_step, s1.exp_small_k):
        exp(s1.parse_args(["step", "--batch", "2"]), device="cpu", iters=2, img=16, depth=2)
    out = capsys.readouterr().out
    for line in ("attend_project fwd B=1 N=100 dh=64", "attend_project fwd+bwd",
                 "bwd pair_staged tile=64 B=1 N=128 dh=64", "bwd pair_batched",
                 "numerics max |staged - batched| dq/dk/dv: [0.0, 0.0, 0.0]",
                 "train step batch=2 heads=6:", "k=2 batch=2:", "k=4 batch=2:"):
        assert line in out, line
    assert dict(LAUNCHES) == before  # the CPU route launches no kernel
    with pytest.raises(SystemExit):
        s1.parse_args(["smap"])  # waits for the multi-GPU port


def test_bench_block_fusion_runs_on_the_cpu(capsys, one_thread):
    s2.main("cpu", b=1, n=N_VALID, n_pad=N, d=D, heads=H, layers=2)
    out = capsys.readouterr().out
    for line in ("v0 3D (shipped math) fwd ", "v0 3D (shipped math) fwd+bwd",
                 "v1 2D-flattened fwd ", "v1 2D-flattened fwd+bwd",
                 "v2 fused-qkv lane-sliced fwd", "v3 fused ln_qkv+flash_qkv+ln_mlp: not run",
                 "v2 vs v1 max abs diff: 0.0"):
        assert line in out, line


def test_bench_int8_lnmlp_runs_on_the_cpu(capsys, one_thread):
    s3.main("cpu", b=1, n=64, hid=512)
    out = capsys.readouterr().out
    for line in ("one-layer max abs err bf16-vs-int8:", "bf16 ln_mlp fwd:", "int8 ln_mlp fwd:",
                 "speedup:"):
        assert line in out, line
