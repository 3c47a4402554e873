"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test skips. On a machine with a
card and without JAX, run them with the repository conftest (which imports
JAX) left out:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Tolerance: kernel and plain version are both bf16 and round at the same
points, but sum in other orders and the kernel's online softmax rounds P
against a running maximum, so an output may land a bf16 ulp or two (2^-7
relative) apart: max|kernel - plain| <= 2e-2 * max|plain|. Output biases are
drawn at the residual's scale, so a dropped or misplaced bias moves the output
far past that; the cases with no residual and zero output bias let the
kernel's products alone set max|plain|. The backward kernels B2 and B4 are
held the same way, every output, and B2's padded key rows must come out with
dk = dv = 0 exactly; the autograd Functions' gradients through the kernels
are held against the same Functions under ``plain_versions()``.
"""

import contextlib

import pytest
import torch

from diverse_channel_vit_torch.ops import fused_block as fb

pytestmark = pytest.mark.gpu

TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.parametrize("batch,n,heads,n_valid,residual,d_out,bias", [
    (2, 64, 6, 64, True, 384, 1.0),      # one tile, nothing masked
    (2, 128, 6, 100, False, 384, 1.0),   # ragged last key tile, no residual
    (3, 640, 6, 589, True, 384, 1.0),    # the k=3 channel-subset grid
    (1, 192, 2, 129, True, 128, 1.0),    # two heads, D = 128
    (2, 128, 4, 1, True, 256, 1.0),      # only the CLS key is valid
    (2, 1600, 6, 1569, False, 384, 0.0),  # the flagship grid, products alone
])
def test_attend_project_kernel_matches_plain(gen, batch, n, heads, n_valid, residual, d_out,
                                             bias):
    d = heads * 64
    qkv = _rnd(gen, batch, n, 3 * d)
    x_res = _rnd(gen, batch, n, d_out) if residual else None
    wp, bp = _rnd(gen, d_out, d, scale=d ** -0.5), _rnd(gen, d_out, scale=bias)
    args = (qkv, x_res, wp, bp, heads, 0.125, n_valid)
    before = fb.LAUNCHES["attend_project_fwd"]
    o_k, lse_k, xo_k = fb.attend_project_fwd(*args, need_o=True)
    o_p, lse_p, xo_p = fb.attend_project_fwd_plain(*args, need_o=True)
    assert fb.LAUNCHES["attend_project_fwd"] == before + 1
    assert _rel(xo_k, xo_p) <= TOL
    assert _rel(o_k, o_p) <= TOL
    assert _rel(lse_k, lse_p) <= 1e-5  # f32 statistics of the same scores
    o_none, lse_none, xo_again = fb.attend_project_fwd(*args)
    assert o_none is None and lse_none is None and torch.equal(xo_again, xo_k)


@pytest.mark.parametrize("shape,residual,bias", [
    ((2, 64, 384), True, 1.0),
    ((3, 640, 384), False, 1.0),
    ((1, 100, 384), True, 1.0),   # a ragged last row tile
    ((2, 640, 384), False, 0.0),  # the MLP's products alone
])
def test_ln_mlp_kernel_matches_plain(gen, shape, residual, bias):
    d, hid = 384, 1536
    x = _rnd(gen, *shape)
    s = _rnd(gen, d, scale=0.1, dtype=torch.float32) + 1.0
    b = _rnd(gen, d, scale=0.1, dtype=torch.float32)
    w1, b1 = _rnd(gen, hid, d, scale=d ** -0.5), _rnd(gen, hid)
    w2, b2 = _rnd(gen, d, hid, scale=hid ** -0.5), _rnd(gen, d, scale=bias)
    before = fb.LAUNCHES["ln_mlp_fwd"]
    got = fb.ln_mlp(x, s, b, w1, b1, w2, b2, residual)
    assert fb.LAUNCHES["ln_mlp_fwd"] == before + 1
    assert _rel(got, fb.ln_mlp_plain(x, s, b, w1, b1, w2, b2, residual)) <= TOL


def test_kernel_wrappers_raise_on_what_they_do_not_take(gen):
    qkv = _rnd(gen, 1, 64, 3 * 384)
    wp, bp = _rnd(gen, 384, 384), _rnd(gen, 384)
    with pytest.raises(ValueError):  # f32 input
        fb.attend_project_fwd(qkv.float(), None, wp, bp, 6, 0.125, 64)
    with pytest.raises(ValueError):  # N not a multiple of 64
        fb.attend_project_fwd(qkv[:, :60].contiguous(), None, wp, bp, 6, 0.125, 60)
    with pytest.raises(NotImplementedError):  # head width 128
        fb.attend_project_fwd(qkv, None, wp, bp, 3, 0.125, 64)
    x = _rnd(gen, 1, 64, 256)
    w1, w2 = _rnd(gen, 1024, 256), _rnd(gen, 256, 1024)
    with pytest.raises(NotImplementedError):  # D = 256
        fb.ln_mlp(x, torch.ones(256, device="cuda"), torch.zeros(256, device="cuda"),
                  w1, _rnd(gen, 1024), w2, _rnd(gen, 256))


@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (1, 64, 6, 64),      # B = 1, one tile, nothing masked
    (2, 640, 6, 70),     # n_valid far below N: 8 of 10 key tiles wholly padded
    (3, 640, 6, 589),    # B = 3, the k = 3 channel-subset grid
    (1, 192, 2, 129),    # two heads, D = 128
    (2, 1600, 6, 1569),  # the flagship grid
])
def test_attend_project_bwd_kernel_matches_plain(gen, batch, n, heads, n_valid):
    d = heads * 64
    qkv, x_res = _rnd(gen, batch, n, 3 * d), _rnd(gen, batch, n, d)
    wp, bp = _rnd(gen, d, d, scale=d ** -0.5), _rnd(gen, d)
    o, lse, _ = fb.attend_project_fwd(qkv, x_res, wp, bp, heads, 0.125, n_valid, need_o=True)
    dxo = _rnd(gen, batch, n, d)
    args = (qkv, o, lse, wp, dxo, heads, 0.125, n_valid)
    before = fb.LAUNCHES["attend_project_bwd"]
    got = fb.attend_project_bwd(*args)
    assert fb.LAUNCHES["attend_project_bwd"] == before + 1
    want = fb.attend_project_bwd_plain(*args)
    for name, g, w in zip(("dqkv", "dwp", "dbp", "db_qkv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= TOL, name
    for j in range(3):  # dq, dk and dv each on its own scale
        assert _rel(got[0][..., j * d:(j + 1) * d], want[0][..., j * d:(j + 1) * d]) <= TOL
    assert torch.count_nonzero(got[0][:, n_valid:, d:]) == 0


@pytest.mark.parametrize("shape,residual", [
    ((1, 64, 384), True),
    ((3, 640, 384), False),
    ((1, 100, 384), True),   # a ragged last row tile
    ((2, 1600, 384), False),
])
def test_ln_mlp_bwd_kernel_matches_plain(gen, shape, residual):
    d, hid = 384, 1536
    x, do = _rnd(gen, *shape), _rnd(gen, *shape)
    s = _rnd(gen, d, scale=0.1, dtype=torch.float32) + 1.0
    b = _rnd(gen, d, scale=0.1, dtype=torch.float32)
    w1, b1 = _rnd(gen, hid, d, scale=d ** -0.5), _rnd(gen, hid)
    w2 = _rnd(gen, d, hid, scale=hid ** -0.5)
    args = (x, s, b, w1, b1, w2, do, residual)
    before = fb.LAUNCHES["ln_mlp_bwd"]
    got = fb.ln_mlp_bwd(*args)
    assert fb.LAUNCHES["ln_mlp_bwd"] == before + 1
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2", "ds", "db"), got,
                          fb.ln_mlp_bwd_plain(*args)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= TOL, name


def _grads(fn, inputs, cotangent, plain):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    with fb.plain_versions() if plain else contextlib.nullcontext():
        out = fn(*leaves)
        out.backward(cotangent)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("with_residual", [False, True])
def test_attend_project_function_grads_match_plain_route(gen, with_residual):
    """Gradients of every input through AttendProjectFn: the kernel route
    (B1 forward, B2 backward) against the plain route, on the card."""
    b, n, d, heads, n_valid = 2, 640, 384, 6, 589
    inputs = [_rnd(gen, b, n, d), _rnd(gen, 3 * d, d, scale=d ** -0.5), _rnd(gen, 3 * d),
              _rnd(gen, d, d, scale=d ** -0.5), _rnd(gen, d), _rnd(gen, b, n, d)]

    def fn(y, w, bq, wp, bp, x):
        return fb.attend_project(y, w, bq, wp, bp, x if with_residual else None, heads,
                                 valid_len=n_valid)

    cot = _rnd(gen, b, n, d)
    before = dict(fb.LAUNCHES)
    got = _grads(fn, inputs, cot, plain=False)
    assert fb.LAUNCHES["attend_project_fwd"] == before["attend_project_fwd"] + 1
    assert fb.LAUNCHES["attend_project_bwd"] == before["attend_project_bwd"] + 1
    want = _grads(fn, inputs, cot, plain=True)
    assert fb.LAUNCHES["attend_project_bwd"] == before["attend_project_bwd"] + 1
    for name, g, w in zip(("y", "w_qkv", "b_qkv", "wp", "bp", "x_res"), got, want):
        if name == "x_res" and not with_residual:
            assert g is None and w is None
            continue
        assert _rel(g, w) <= TOL, name


@pytest.mark.parametrize("residual", [False, True])
def test_ln_mlp_function_grads_match_plain_route(gen, residual):
    """Gradients of every input through LnMlpFn: the kernel route (B3
    forward, B4 backward) against the plain route, on the card."""
    d, hid = 384, 1536
    inputs = [_rnd(gen, 2, 640, d), _rnd(gen, d, scale=0.1, dtype=torch.float32) + 1.0,
              _rnd(gen, d, scale=0.1, dtype=torch.float32), _rnd(gen, hid, d, scale=d ** -0.5),
              _rnd(gen, hid), _rnd(gen, d, hid, scale=hid ** -0.5), _rnd(gen, d)]

    def fn(*a):
        return fb.ln_mlp(*a, residual)

    cot = _rnd(gen, 2, 640, d)
    before = fb.LAUNCHES["ln_mlp_bwd"]
    got = _grads(fn, inputs, cot, plain=False)
    assert fb.LAUNCHES["ln_mlp_bwd"] == before + 1
    want = _grads(fn, inputs, cot, plain=True)
    assert fb.LAUNCHES["ln_mlp_bwd"] == before + 1
    for name, g, w in zip(("x", "scale", "bias", "w1", "b1", "w2", "b2"), got, want):
        assert g.dtype == w.dtype and _rel(g, w) <= TOL, name


def test_backward_wrappers_raise_on_what_they_do_not_take(gen):
    qkv = _rnd(gen, 1, 64, 3 * 384)
    o, do = _rnd(gen, 1, 64, 384), _rnd(gen, 1, 64, 384)
    lse = torch.zeros(1, 6, 64, device="cuda")
    wp = _rnd(gen, 384, 384)
    with pytest.raises(ValueError):  # f32 dxo
        fb.attend_project_bwd(qkv, o, lse, wp, do.float(), 6, 0.125, 64)
    with pytest.raises(ValueError):  # N not a multiple of 64
        fb.attend_project_bwd(qkv[:, :60].contiguous(), o[:, :60].contiguous(),
                              lse[..., :60].contiguous(), wp, do[:, :60].contiguous(), 6,
                              0.125, 60)
    with pytest.raises(NotImplementedError):  # head width 128
        fb.attend_project_bwd(qkv, o, lse[:, :3].contiguous(), wp, do, 3, 0.125, 64)
    x = _rnd(gen, 1, 64, 256)
    with pytest.raises(NotImplementedError):  # D = 256
        fb.ln_mlp_bwd(x, torch.ones(256, device="cuda"), torch.zeros(256, device="cuda"),
                      _rnd(gen, 1024, 256), _rnd(gen, 1024), _rnd(gen, 256, 1024), x)
