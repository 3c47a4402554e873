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
kernel's products alone set max|plain|. B3 and B4 are also held at the
recipe's and EViT's grids and with a half-full last 128-row tile, B1 and B2
at D = 768 and with one head (D_out = 64). The
backward kernels B2 and B4 are held the same way, every output, B2's padded
key rows must come out with dk = dv = 0 exactly, and two B2 calls, as two B4
calls, on the same inputs must agree bit for bit; the autograd Functions' gradients
through the kernels are held against the same Functions under
``plain_versions()``. B5 and B6
(``flash_attention_packed``) are held the same way, on q, k and v given as
the strided thirds of one packed qkv tensor, as the model passes them, and
as tensors of their own (``bench_block_fusion``'s layout, and a mix of row
strides); two B6 calls on the same inputs must agree bit for bit.

The benchmark scripts' kernels (``diverse_channel_vit_torch/scripts/``) are
held the same way against their plain versions and against their package
siblings on the same inputs: S1 (``bwd_call``) in both schedules, bit for
bit, with padded key rows exactly 0, bit for bit against B6 given B5's lse
(its statistics pass recomputes that lse with B5's instructions) and across
two calls; S2 (``qkv_flash_fwd``) against B5 on the three views of the same
qkv, bit for bit (one kernel, two maps); S3 (``int8_ln_mlp``) against B7 on
the same weight codes and scales, outputs and hidden codes, bit for bit. B7
and B8 (the int8 ``ln_mlp``) are also held bit for bit across two calls, B8
at a ragged last row tile with padding rows, and B8's recomputed h against
B7's, bit for bit. The public
``attend_project`` and ``flash_attention_packed`` pad an N that is not a
multiple of 64 and are held at N = 1569 against the plain route, forward and
gradient.
"""

import contextlib

import pytest
import torch

from diverse_channel_vit_torch.ops import attention as at
from diverse_channel_vit_torch.ops import fused_block as fb
from diverse_channel_vit_torch.scripts import bench_attn as s1
from diverse_channel_vit_torch.scripts import bench_block_fusion as s2
from diverse_channel_vit_torch.scripts import bench_int8_lnmlp as s3

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
    (2, 768, 6, 768, True, 384, 1.0),    # the EViT grid after layer 6: no mask
    (2, 192, 6, 150, True, 384, 1.0),    # N = 192, a ragged last key tile, 6 heads
    (2, 640, 12, 589, True, 768, 1.0),   # D = 768: 12 heads
    (2, 640, 12, 589, False, 768, 0.0),  # the same, products alone
    (2, 128, 1, 100, True, 64, 1.0),     # one head, D_out = 64: half a Wp box
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
    ((4, 768, 384), True, 1.0),   # the EViT grid after layer 6
    ((3, 64, 384), True, 1.0),    # M = 192: a last 128-row tile half full
    ((3, 64, 384), False, 0.0),   # the same, products alone
    ((4, 256, 384), True, 1.0),   # the recipe's smallest grid (k = 1)
    ((2, 1152, 384), False, 1.0),  # the EViT grid after layer 3
    ((2, 1600, 384), True, 1.0),  # the flagship grid
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
    (2, 768, 6, 768),    # the EViT grid after layer 6: no mask
    (1, 192, 6, 150),    # B N = 192 rows: the row pass's last 128-row block half full
    (2, 640, 12, 589),   # D = 768
    (2, 128, 1, 100),    # one head, D = D_out = 64: half-empty 128-column tiles
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
    ((4, 768, 384), True),   # the EViT grid after layer 6
    ((3, 64, 384), True),    # M = 192: a last 128-row tile half full
    ((3, 64, 384), False),
    ((4, 256, 384), False),  # the recipe's smallest grid (k = 1)
    ((2, 1152, 384), True),  # the EViT grid after layer 3
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


@pytest.mark.parametrize("shape", [(3, 64, 384), (8, 1600, 384)])
def test_ln_mlp_bwd_kernel_is_bit_identical_across_calls(gen, shape):
    """B4 sums every partial in a fixed order and uses no atomics: two calls
    on the same inputs agree bit for bit, every output."""
    d, hid = 384, 1536
    x, do = _rnd(gen, *shape), _rnd(gen, *shape)
    s = _rnd(gen, d, scale=0.1, dtype=torch.float32) + 1.0
    b = _rnd(gen, d, scale=0.1, dtype=torch.float32)
    args = (x, s, b, _rnd(gen, hid, d, scale=d ** -0.5), _rnd(gen, hid),
            _rnd(gen, d, hid, scale=hid ** -0.5), do, True)
    first = fb.ln_mlp_bwd(*args)
    second = fb.ln_mlp_bwd(*args)
    for name, g1, g2 in zip(("dx", "dw1", "db1", "dw2", "db2", "ds", "db"), first, second):
        assert torch.equal(g1, g2), name


@pytest.mark.parametrize("batch,n,heads", [(3, 64, 6), (8, 1600, 6)])
def test_attend_project_bwd_kernel_is_bit_identical_across_calls(gen, batch, n, heads):
    """B2 sums every partial in a fixed order and uses no atomics: two calls
    on the same inputs agree bit for bit, every output."""
    d, n_valid = heads * 64, n - n // 50
    qkv, x_res = _rnd(gen, batch, n, 3 * d), _rnd(gen, batch, n, d)
    wp, bp = _rnd(gen, d, d, scale=d ** -0.5), _rnd(gen, d)
    o, lse, _ = fb.attend_project_fwd(qkv, x_res, wp, bp, heads, 0.125, n_valid, need_o=True)
    args = (qkv, o, lse, wp, _rnd(gen, batch, n, d), heads, 0.125, n_valid)
    first = fb.attend_project_bwd(*args)
    second = fb.attend_project_bwd(*args)
    for name, g1, g2 in zip(("dqkv", "dwp", "dbp", "db_qkv"), first, second):
        assert torch.equal(g1, g2), name


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


@pytest.mark.parametrize("residual,grid", [
    (False, (2, 640)),
    (True, (2, 640)),
    (True, (3, 64)),    # M = 192: a ragged last 128-row tile
    (False, (2, 256)),  # the recipe's smallest grid
])
def test_ln_mlp_function_grads_match_plain_route(gen, residual, grid):
    """Gradients of every input through LnMlpFn: the kernel route (B3
    forward, B4 backward) against the plain route, on the card."""
    d, hid = 384, 1536
    inputs = [_rnd(gen, *grid, d), _rnd(gen, d, scale=0.1, dtype=torch.float32) + 1.0,
              _rnd(gen, d, scale=0.1, dtype=torch.float32), _rnd(gen, hid, d, scale=d ** -0.5),
              _rnd(gen, hid), _rnd(gen, d, hid, scale=hid ** -0.5), _rnd(gen, d)]

    def fn(*a):
        return fb.ln_mlp(*a, residual)

    cot = _rnd(gen, *grid, d)
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


@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (1, 64, 6, 64),      # one tile, nothing masked
    (2, 640, 6, 70),     # n_valid far below N: 8 of 10 key tiles wholly padded
    (2, 128, 2, 100),    # two heads, a ragged last key tile
    (3, 576, 6, 537),    # the EViT grid after layer 9
    (2, 1152, 6, 1098),  # the EViT grid after layer 3
    (2, 1600, 6, 1569),  # the flagship grid
    (2, 640, 12, 589),   # D = 768: 12 heads (the base preset's width)
    (2, 768, 12, 768),   # 12 heads, nothing masked
])
def test_flash_packed_kernels_match_plain(gen, batch, n, heads, n_valid):
    d = heads * 64
    q, k, v = _rnd(gen, batch, n, 3 * d).split(d, dim=-1)
    before = dict(fb.LAUNCHES)
    o, lse = at.flash_packed_fwd(q, k, v, heads, 0.125, n_valid, need_lse=True)
    assert fb.LAUNCHES["flash_packed_fwd"] == before["flash_packed_fwd"] + 1
    o_p, lse_p = at.flash_packed_fwd_plain(q, k, v, heads, 0.125, n_valid, need_lse=True)
    assert _rel(o, o_p) <= TOL
    assert _rel(lse, lse_p) <= 1e-5  # f32 statistics of the same scores
    assert at.flash_packed_fwd(q, k, v, heads, 0.125, n_valid)[1] is None
    do = _rnd(gen, batch, n, d)
    got = at.flash_packed_bwd(q, k, v, o, do, lse, heads, 0.125, n_valid)
    assert fb.LAUNCHES["flash_packed_bwd"] == before["flash_packed_bwd"] + 1
    for name, g, w in zip("qkv", got, at.flash_packed_bwd_plain(q, k, v, o, do, lse, heads,
                                                                 0.125, n_valid)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= TOL, name
    assert torch.count_nonzero(got[1][:, n_valid:]) == 0
    assert torch.count_nonzero(got[2][:, n_valid:]) == 0


def _qkv_views(gen, layout, batch, n, d):
    """q, k and v of one layout: "separate", three contiguous tensors
    (bench_block_fusion's); "mixed", q contiguous and k, v the halves of one
    (B, N, 2D) tensor, so that each has a row stride of its own."""
    if layout == "separate":
        return tuple(_rnd(gen, batch, n, d) for _ in range(3))
    return (_rnd(gen, batch, n, d), *_rnd(gen, batch, n, 2 * d).split(d, dim=-1))


@pytest.mark.parametrize("layout", ["separate", "mixed"])
@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (2, 128, 2, 100),    # two heads, a ragged last key tile
    (2, 1152, 6, 1098),  # the EViT grid after layer 3
    (2, 640, 12, 589),   # 12 heads
])
def test_flash_packed_kernels_match_plain_on_other_layouts(gen, layout, batch, n, heads,
                                                          n_valid):
    d = heads * 64
    q, k, v = _qkv_views(gen, layout, batch, n, d)
    o, lse = at.flash_packed_fwd(q, k, v, heads, 0.125, n_valid, need_lse=True)
    o_p, lse_p = at.flash_packed_fwd_plain(q, k, v, heads, 0.125, n_valid, need_lse=True)
    assert _rel(o, o_p) <= TOL
    assert _rel(lse, lse_p) <= 1e-5
    do = _rnd(gen, batch, n, d)
    got = at.flash_packed_bwd(q, k, v, o, do, lse, heads, 0.125, n_valid)
    for name, g, w in zip("qkv", got, at.flash_packed_bwd_plain(q, k, v, o, do, lse, heads,
                                                                 0.125, n_valid)):
        assert _rel(g, w) <= TOL, name
    assert torch.count_nonzero(got[1][:, n_valid:]) == 0
    assert torch.count_nonzero(got[2][:, n_valid:]) == 0


@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (2, 1600, 6, 1569),  # the flagship grid
    (3, 576, 6, 537),    # the EViT grid after layer 9
])
def test_flash_packed_bwd_kernel_is_bit_identical_across_calls(gen, batch, n, heads, n_valid):
    """B6 sums in a fixed order and uses no atomics: two calls on the same
    inputs agree bit for bit, dq, dk and dv."""
    d = heads * 64
    q, k, v = _rnd(gen, batch, n, 3 * d).split(d, dim=-1)
    o, lse = at.flash_packed_fwd(q, k, v, heads, 0.125, n_valid, need_lse=True)
    args = (q, k, v, o, _rnd(gen, batch, n, d), lse, heads, 0.125, n_valid)
    first = at.flash_packed_bwd(*args)
    second = at.flash_packed_bwd(*args)
    for name, g1, g2 in zip("qkv", first, second):
        assert torch.equal(g1, g2), name


@pytest.mark.parametrize("n_valid", [589, 640])
def test_flash_packed_function_grads_match_plain_route(gen, n_valid):
    """Gradients of the packed qkv through FlashPackedFn (B5 forward, B6
    backward): the kernel route against the plain route, on the card."""
    b, n, d, heads = 2, 640, 384, 6

    def fn(qkv):
        return at.flash_attention_packed(*qkv.split(d, dim=-1), heads, valid_len=n_valid)

    qkv, cot = _rnd(gen, b, n, 3 * d), _rnd(gen, b, n, d)
    before = dict(fb.LAUNCHES)
    (got,) = _grads(fn, [qkv], cot, plain=False)
    assert fb.LAUNCHES["flash_packed_fwd"] == before["flash_packed_fwd"] + 1
    assert fb.LAUNCHES["flash_packed_bwd"] == before["flash_packed_bwd"] + 1
    (want,) = _grads(fn, [qkv], cot, plain=True)
    assert fb.LAUNCHES["flash_packed_bwd"] == before["flash_packed_bwd"] + 1
    for j, name in enumerate("qkv"):
        assert _rel(got[..., j * d:(j + 1) * d], want[..., j * d:(j + 1) * d]) <= TOL, name


def test_flash_packed_wrappers_raise_on_what_they_do_not_take(gen):
    q, k, v = _rnd(gen, 1, 64, 3 * 384).split(384, dim=-1)
    with pytest.raises(NotImplementedError, match="B5"):  # f32
        at.flash_packed_fwd(q.float(), k.float(), v.float(), 6, 0.125, 64)
    with pytest.raises(NotImplementedError, match="B5"):  # head width 128
        at.flash_packed_fwd(q, k, v, 3, 0.125, 64)
    with pytest.raises(NotImplementedError, match="B5"):  # N not a multiple of 64
        at.flash_packed_fwd(q[:, :60], k[:, :60], v[:, :60], 6, 0.125, 60)
    qt = _rnd(gen, 1, 384, 64).transpose(1, 2)  # columns not contiguous
    with pytest.raises(NotImplementedError, match="B5"):
        at.flash_packed_fwd(qt, k, v, 6, 0.125, 64)
    o, lse = at.flash_packed_fwd(q, k, v, 6, 0.125, 64, need_lse=True)
    with pytest.raises(NotImplementedError, match="B5"):  # f32 backward
        at.flash_packed_bwd(q.float(), k.float(), v.float(), o.float(), o.float(), lse, 6,
                            0.125, 64)
    with pytest.raises(NotImplementedError, match="B5"):
        at.flash_packed_bwd(qt, k, v, o, o, lse, 6, 0.125, 64)


def _mlp_inputs(gen, shape, bias=1.0):
    d, hid = 384, 1536
    x = _rnd(gen, *shape)
    s = _rnd(gen, d, scale=0.1, dtype=torch.float32) + 1.0
    b = _rnd(gen, d, scale=0.1, dtype=torch.float32)
    w1, b1 = _rnd(gen, hid, d, scale=d ** -0.5), _rnd(gen, hid)
    w2, b2 = _rnd(gen, d, hid, scale=hid ** -0.5), _rnd(gen, d, scale=bias)
    return x, s, b, w1, b1, w2, b2


# int8 codes that differ between kernel and plain version: a value within f32
# noise of a .5 tie may round the other way (the LayerNorm sums in another
# order; the plain version's tanh comes from another library build, which
# GELU' amplifies where tanh saturates). A wrong scale or product would flip
# most codes.
MAX_CODE_FLIPS = 1e-2


@pytest.mark.parametrize("shape,residual,bias", [
    ((1, 64, 384), True, 1.0),
    ((3, 640, 384), False, 1.0),
    ((1, 100, 384), True, 1.0),   # a ragged last row tile
    ((2, 1600, 384), False, 0.0),  # the flagship grid, products alone
])
def test_ln_mlp_q_kernels_match_plain(gen, shape, residual, bias):
    """B7 and B8 (the int8 ln_mlp) against their plain versions, every
    output and the codes of their last int8 product."""
    x, s, b, w1, b1, w2, b2 = _mlp_inputs(gen, shape, bias)
    do = _rnd(gen, *shape)
    w1q, s1c, w2q, s2c, w1r, s1r, w2r, s2r = fb.quantize_mlp_weights(w1, w2, backward=True)
    fwd = (x, s, b, w1q, s1c, b1, w2q, s2c, b2, residual)
    before = dict(fb.LAUNCHES)
    out, codes = fb.ln_mlp_q_fwd(*fwd, with_codes=True)
    assert fb.LAUNCHES["ln_mlp_q_fwd"] == before["ln_mlp_q_fwd"] + 1
    out_p, codes_p = fb.ln_mlp_q_plain(*fwd, with_codes=True)
    assert _rel(out, out_p) <= TOL
    assert (codes != codes_p).float().mean().item() <= MAX_CODE_FLIPS
    bwd = (x, s, b, w1q, s1c, b1, w1r, s1r, w2r, s2r, do, residual)
    got = fb.ln_mlp_q_bwd(*bwd, with_codes=True)
    assert fb.LAUNCHES["ln_mlp_q_bwd"] == before["ln_mlp_q_bwd"] + 1
    want = fb.ln_mlp_q_bwd_plain(*bwd, with_codes=True)
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2", "ds", "db"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= TOL, name
    assert (got[7] != want[7]).float().mean().item() <= MAX_CODE_FLIPS
    # the int8 path is not the bf16 one
    assert not torch.equal(out, fb.ln_mlp(x, s, b, w1, b1, w2, b2, residual))


@pytest.mark.parametrize("residual", [False, True])
def test_ln_mlp_int8_function_grads_match_plain_route(gen, residual):
    """Gradients of every input through LnMlpFn with ``quantized``: the
    kernel route (B7 forward, B8 backward) against the plain route."""
    inputs = list(_mlp_inputs(gen, (2, 640, 384)))

    def fn(*a):
        return fb.ln_mlp(*a, residual, quantized=True)

    cot = _rnd(gen, 2, 640, 384)
    before = dict(fb.LAUNCHES)
    got = _grads(fn, inputs, cot, plain=False)
    assert fb.LAUNCHES["ln_mlp_q_fwd"] == before["ln_mlp_q_fwd"] + 1
    assert fb.LAUNCHES["ln_mlp_q_bwd"] == before["ln_mlp_q_bwd"] + 1
    assert fb.LAUNCHES["ln_mlp_fwd"] == before["ln_mlp_fwd"]
    want = _grads(fn, inputs, cot, plain=True)
    assert fb.LAUNCHES["ln_mlp_q_bwd"] == before["ln_mlp_q_bwd"] + 1
    for name, g, w in zip(("x", "scale", "bias", "w1", "b1", "w2", "b2"), got, want):
        assert g.dtype == w.dtype and _rel(g, w) <= TOL, name


def test_ln_mlp_q_wrappers_raise_on_what_they_do_not_take(gen):
    x, s, b, w1, b1, w2, b2 = _mlp_inputs(gen, (1, 64, 384))
    w1q, s1c, w2q, s2c, w1r, s1r, w2r, s2r = fb.quantize_mlp_weights(w1, w2, backward=True)
    with pytest.raises(ValueError):  # bf16 weights where int8 codes are taken
        fb.ln_mlp_q_fwd(x, s, b, w1, s1c, b1, w2q, s2c, b2)
    with pytest.raises(ValueError):  # w1r in the forward copy's layout
        fb.ln_mlp_q_bwd(x, s, b, w1q, s1c, b1, w1q, s1r, w2r, s2r, x)
    with pytest.raises(ValueError):  # f32 input
        fb.ln_mlp_q_fwd(x.float(), s, b, w1q, s1c, b1, w2q, s2c, b2)
    x2 = _rnd(gen, 1, 64, 256)
    q = fb.quantize_mlp_weights(_rnd(gen, 1024, 256), _rnd(gen, 256, 1024))
    with pytest.raises(NotImplementedError):  # D = 256
        fb.ln_mlp_q_fwd(x2, torch.ones(256, device="cuda"), torch.zeros(256, device="cuda"),
                        q[0], q[1], _rnd(gen, 1024), q[2], q[3], _rnd(gen, 256))
    # hidden widths the kernels do not tile: B7 takes multiples of 128, B8 of 384
    q = fb.quantize_mlp_weights(_rnd(gen, 1600, 384), _rnd(gen, 384, 1600))
    with pytest.raises(ValueError):
        fb.ln_mlp_q_fwd(x, s, b, q[0], q[1], _rnd(gen, 1600), q[2], q[3], b2)
    q = fb.quantize_mlp_weights(_rnd(gen, 1280, 384), _rnd(gen, 384, 1280), backward=True)
    fb.ln_mlp_q_fwd(x, s, b, q[0], q[1], _rnd(gen, 1280), q[2], q[3], b2)
    with pytest.raises(ValueError):
        fb.ln_mlp_q_bwd(x, s, b, q[0], q[1], _rnd(gen, 1280), q[4], q[5], q[6], q[7], x)


def _q_args(gen, shape, bias=1.0):
    """(B7's, B8's) arguments before ``residual``, from one draw."""
    x, s, b, w1, b1, w2, b2 = _mlp_inputs(gen, shape, bias)
    w1q, s1c, w2q, s2c, w1r, s1r, w2r, s2r = fb.quantize_mlp_weights(w1, w2, backward=True)
    return ((x, s, b, w1q, s1c, b1, w2q, s2c, b2),
            (x, s, b, w1q, s1c, b1, w1r, s1r, w2r, s2r, _rnd(gen, *shape)))


Q_BWD_NAMES = ("dx", "dw1", "db1", "dw2", "db2", "ds", "db", "codes", "h")


@pytest.mark.parametrize("shape", [(1, 100, 384), (8, 1600, 384)])
def test_ln_mlp_q_kernels_are_bit_identical_across_calls(gen, shape):
    """B7 and B8 round and sum every value in an order fixed by the shapes
    and use no atomics: two calls on the same inputs agree bit for bit, every
    output, code and check output. B7 with ``with_h`` runs its instantiation
    that also stores h; its output and codes are the main path's."""
    fwd, bwd = _q_args(gen, shape)
    first, again = (fb.ln_mlp_q_fwd(*fwd, True, with_codes=True) for _ in range(2))
    for name, g1, g2 in zip(("out", "codes"), first, again):
        assert torch.equal(g1, g2), name
    checked, again = (fb.ln_mlp_q_fwd(*fwd, True, with_codes=True, with_h=True) for _ in range(2))
    for name, g1, g2, g3 in zip(("out", "codes", "h"), checked, again, first + (None,)):
        assert torch.equal(g1, g2), name
        assert g3 is None or torch.equal(g1, g3), name
    first, again = (fb.ln_mlp_q_bwd(*bwd, True, with_codes=True, with_h=True) for _ in range(2))
    for name, g1, g2 in zip(Q_BWD_NAMES, first, again):
        assert torch.equal(g1, g2), name


@pytest.mark.parametrize("shape", [(1, 100, 384), (3, 1569, 384)])
def test_ln_mlp_q_bwd_kernel_matches_plain_at_a_ragged_last_tile(gen, shape):
    """B8 with the residual fused where M is a multiple of neither 64 nor 128,
    so the last row tile of every GEMM runs past the end, and with the last
    rows of each image zero, as the model's padding tokens are: every output
    within TOL of the plain version, dx on the padding rows, on the other
    rows and on the last 64-row tile each on its own scale, and the codes of
    the dy GEMM."""
    _, bwd = _q_args(gen, shape)
    n_pad = shape[1] // 16
    x = bwd[0].clone()
    x[:, -n_pad:] = 0
    bwd = (x,) + bwd[1:]
    before = fb.LAUNCHES["ln_mlp_q_bwd"]
    got = fb.ln_mlp_q_bwd(*bwd, True, with_codes=True)
    assert fb.LAUNCHES["ln_mlp_q_bwd"] == before + 1
    want = fb.ln_mlp_q_bwd_plain(*bwd, True, with_codes=True)
    for name, g, w in zip(Q_BWD_NAMES, got[:7], want[:7]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= TOL, name
    pad = torch.zeros(shape[:2], dtype=torch.bool, device="cuda")
    pad[:, -n_pad:] = True
    dx, dx_p = got[0], want[0]
    assert _rel(dx[pad], dx_p[pad]) <= TOL
    assert _rel(dx[~pad], dx_p[~pad]) <= TOL
    tail = (shape[0] * shape[1]) % 64
    assert _rel(dx.reshape(-1, 384)[-tail:], dx_p.reshape(-1, 384)[-tail:]) <= TOL
    assert (got[7] != want[7]).float().mean().item() <= MAX_CODE_FLIPS


def test_ln_mlp_q_gelu_facts_hold_on_every_float(gen):
    """B7's first pass takes a row's max|h| from GELU of the row's largest
    input once that reaches 0.3 (csrc/int8.cuh, kGeluPosDominates). So the
    library's own GELU must be non-decreasing over every non-negative float
    and, over every negative float, smaller in magnitude than at 0.3."""
    facts = fb.gelu_facts("cuda")
    assert facts["finite"] and facts["steps_down"] == 0, facts
    assert facts["neg_max"] < facts["at_bound"], facts


@pytest.mark.parametrize("shape,residual", [((1, 100, 384), True), ((2, 1600, 384), False)])
def test_ln_mlp_q_bwd_recompute_is_the_forward(gen, shape, residual):
    """B8 recomputes the forward's int8 fc1: its h (the bf16 operand of dW2,
    returned with ``with_h``) equals B7's h rounded to bf16 (the h that B7
    quantises into the codes fc2 reads), bit for bit, so the LayerNorm, the
    y codes, the int8 sums, the dequantisation and the GELU are the
    forward's; both are within TOL of the plain version's h."""
    fwd, bwd = _q_args(gen, shape)
    h7 = fb.ln_mlp_q_fwd(*fwd, residual, with_h=True)[1]
    h8 = fb.ln_mlp_q_bwd(*bwd, residual, with_h=True)[7]
    assert h8.shape == (shape[0] * shape[1], 1536) and h8.dtype == torch.bfloat16
    assert torch.equal(h7, h8)
    assert _rel(h8, fb.ln_mlp_q_plain(*fwd, residual, with_h=True)[1]) <= TOL


@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (1, 128, 2, 100),    # two heads, a ragged last key tile
    (2, 640, 6, 589),    # the k=3 channel-subset grid: one wholly padded key tile
    (2, 1664, 6, 1569),  # the benchmark's grid
])
def test_bwd_call_kernel_matches_plain(gen, batch, n, heads, n_valid):
    """S1 in both schedules against its plain version; the two schedules
    agree bit for bit, and padded key rows get dk = dv = 0 exactly."""
    d = heads * 64
    q, k, v, o, do = (_rnd(gen, batch, n, d) for _ in range(5))
    args = (q, k, v, o, do, heads, 0.125, n_valid)
    want = s1.bwd_call_plain(*args)
    got = {}
    for variant in s1.VARIANTS:
        before = fb.LAUNCHES["bwd_call"]
        got[variant] = s1.bwd_call(*args, variant)
        assert fb.LAUNCHES["bwd_call"] == before + 1
        for name, g, w in zip(("dq", "dk", "dv"), got[variant], want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert _rel(g, w) <= TOL, (variant, name)
        assert torch.count_nonzero(got[variant][1][:, n_valid:]) == 0
        assert torch.count_nonzero(got[variant][2][:, n_valid:]) == 0
    for a, b in zip(got["pair_staged"], got["pair_batched"]):
        assert torch.equal(a, b)


S1_GRIDS = [
    (1, 128, 2, 100),    # two heads, a ragged last key tile
    (2, 640, 6, 589),    # one wholly padded key tile
    (2, 1664, 6, 1569),  # the benchmark's grid
]


@pytest.mark.parametrize("batch,n,heads,n_valid", S1_GRIDS)
def test_bwd_call_kernel_matches_b6_given_b5_lse(gen, batch, n, heads, n_valid):
    """S1 (pair_staged) against B6 (flash_packed_bwd) fed the lse of B5
    (flash_packed_fwd) on the same q, k, v, o and do: S1's statistics pass
    recomputes that lse with B5's instructions and then runs B6's passes, so
    dq, dk and dv agree bit for bit."""
    d = heads * 64
    q, k, v, o, do = (_rnd(gen, batch, n, d) for _ in range(5))
    lse = at.flash_packed_fwd(q, k, v, heads, 0.125, n_valid, need_lse=True)[1]
    want = at.flash_packed_bwd(q, k, v, o, do, lse, heads, 0.125, n_valid)
    got = s1.bwd_call(q, k, v, o, do, heads, 0.125, n_valid, "pair_staged")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("batch,n,heads,n_valid", S1_GRIDS)
def test_bwd_call_kernel_is_bit_identical_across_calls(gen, batch, n, heads, n_valid):
    """Two S1 calls on the same inputs, in each schedule, agree bit for bit
    (every reduction in a fixed order, no atomics)."""
    d = heads * 64
    args = tuple(_rnd(gen, batch, n, d) for _ in range(5)) + (heads, 0.125, n_valid)
    for variant in s1.VARIANTS:
        first = s1.bwd_call(*args, variant)
        again = s1.bwd_call(*args, variant)
        for name, a, b in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, b), (variant, name)


@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (1, 128, 2, 128),    # nothing masked
    (2, 640, 6, 589),
    (2, 1664, 6, 1569),  # the benchmark's grid
])
def test_qkv_flash_kernel_matches_plain_and_b5(gen, batch, n, heads, n_valid):
    """S2 against its plain version, and against B5 (flash_packed_fwd) on the
    three column blocks of the same qkv: S2 is B5's kernel on one packed qkv
    map at column offsets 0, D and 2D, so the two agree bit for bit."""
    d = heads * 64
    qkv = _rnd(gen, batch, n, 3 * d)
    before = fb.LAUNCHES["qkv_flash_fwd"]
    o = s2.qkv_flash_fwd(qkv, heads, 0.125, n_valid)
    assert fb.LAUNCHES["qkv_flash_fwd"] == before + 1
    assert o.shape == (batch, n, d) and o.dtype == qkv.dtype
    plain = s2.qkv_flash_fwd_plain(qkv, heads, 0.125, n_valid)
    b5 = at.flash_packed_fwd(*qkv.split(d, dim=-1), heads, 0.125, n_valid)[0]
    assert _rel(o, plain) <= TOL
    assert _rel(b5, plain) <= TOL
    assert torch.equal(o, b5)


@pytest.mark.parametrize("shape,residual,bias", [
    ((1, 64, 384), True, 1.0),
    ((1, 100, 384), True, 1.0),    # a ragged last row tile
    ((3, 640, 384), False, 1.0),
    ((2, 1600, 384), False, 0.0),  # the benchmark's grid, products alone
])
def test_int8_ln_mlp_kernel_matches_plain_and_b7(gen, shape, residual, bias):
    """S3 against its plain version (output, and the hidden codes fc2 read),
    and against B7 (ln_mlp_q_fwd) on the same weight codes and scales."""
    x, s, b, w1, b1, w2, b2 = _mlp_inputs(gen, shape, bias)
    w1q, sc1 = s3.quant_w(w1)
    w2q, sc2 = s3.quant_w(w2)
    args = (x, s, b, w1q, sc1, b1, w2q, sc2, b2, residual)
    before = fb.LAUNCHES["int8_ln_mlp"]
    out, codes = s3.int8_ln_mlp(*args, with_codes=True)
    assert fb.LAUNCHES["int8_ln_mlp"] == before + 1
    out_p, codes_p = s3.int8_ln_mlp_plain(*args, with_codes=True)
    assert _rel(out, out_p) <= TOL
    assert (codes != codes_p).float().mean().item() <= MAX_CODE_FLIPS
    # B7's instructions on the same codes and scales: the same codes and outputs
    out7, codes7 = fb.ln_mlp_q_fwd(*args, with_codes=True)
    assert torch.equal(codes, codes7) and torch.equal(out, out7)


@pytest.mark.parametrize("op", ["attend_project", "flash_attention_packed"])
def test_public_ops_pad_an_unpadded_grid(gen, op):
    """attend_project and flash_attention_packed at N = 1569 (not a multiple
    of 64) on the card: padded inside, the first N rows returned, forward
    and gradients against the plain route."""
    b, n, d, heads = 2, 1569, 384, 6
    if op == "attend_project":
        inputs = [_rnd(gen, b, n, d), _rnd(gen, 3 * d, d, scale=d ** -0.5), _rnd(gen, 3 * d),
                  _rnd(gen, d, d, scale=d ** -0.5), _rnd(gen, d), _rnd(gen, b, n, d)]

        def fn(y, w, bq, wp, bp, x):
            return fb.attend_project(y, w, bq, wp, bp, x, heads)
    else:
        inputs = [_rnd(gen, b, n, 3 * d)]

        def fn(qkv):
            return at.flash_attention_packed(*qkv.split(d, dim=-1), heads)

    with torch.no_grad():
        out = fn(*inputs)
        with fb.plain_versions():
            ref = fn(*inputs)
    assert out.shape == (b, n, d)
    assert _rel(out, ref) <= TOL
    cot = _rnd(gen, b, n, d)
    got = _grads(fn, inputs, cot, plain=False)
    want = _grads(fn, inputs, cot, plain=True)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == inputs[i].shape and _rel(g, w) <= TOL, i


def test_bench_script_wrappers_raise_on_what_they_do_not_take(gen):
    q, k, v, o, do = (_rnd(gen, 1, 64, 384) for _ in range(5))
    with pytest.raises(NotImplementedError, match="S1"):  # f32
        s1.bwd_call(q.float(), k.float(), v.float(), o.float(), do.float(), 6, 0.125, 64)
    with pytest.raises(NotImplementedError, match="S1"):  # head width 128
        s1.bwd_call(q, k, v, o, do, 3, 0.125, 64)
    with pytest.raises(NotImplementedError, match="S1"):  # an odd head count in pairs
        q5, k5, v5, o5, do5 = (_rnd(gen, 1, 64, 320) for _ in range(5))
        s1.bwd_call(q5, k5, v5, o5, do5, 5, 0.125, 64, "pair_batched")
    with pytest.raises(ValueError):
        s1.bwd_call(q, k, v, o, do, 6, 0.125, 64, "pair_unknown")
    qkv = _rnd(gen, 1, 64, 3 * 384)
    with pytest.raises(NotImplementedError, match="S2"):  # f32
        s2.qkv_flash_fwd(qkv.float(), 6, 0.125, 64)
    with pytest.raises(NotImplementedError, match="S2"):  # head width 128
        s2.qkv_flash_fwd(qkv, 3, 0.125, 64)
    x, s, b, w1, b1, w2, b2 = _mlp_inputs(gen, (1, 64, 384))
    w1q, sc1 = s3.quant_w(w1)
    w2q, sc2 = s3.quant_w(w2)
    with pytest.raises(NotImplementedError, match="S3"):  # f32 input
        s3.int8_ln_mlp(x.float(), s, b, w1q, sc1, b1, w2q, sc2, b2)
    x2 = _rnd(gen, 1, 64, 256)
    c1, t1 = s3.quant_w(_rnd(gen, 1024, 256))
    c2, t2 = s3.quant_w(_rnd(gen, 256, 1024))
    with pytest.raises(NotImplementedError, match="S3"):  # D = 256
        s3.int8_ln_mlp(x2, torch.ones(256, device="cuda"), torch.zeros(256, device="cuda"),
                       c1, t1, _rnd(gen, 1024), c2, t2, _rnd(gen, 256))
