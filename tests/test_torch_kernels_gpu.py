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
recipe's and EViT's grids and with a half-full last 128-row tile, and at
the base preset's D = 768 (GEMMs on 128 x 256 tiles in clusters; at D = 384
their outputs are pinned by sha256 on fixed inputs), there also at the
tiles' edges: fewer rows than one wave, row counts no multiple of 128,
hidden widths no multiple of 256 (B3 at 2112, B4 at 1152); B1 and B2 at D = 768
and with one head (D_out = 64); B1 (attention, then the projection GEMM)
also at output widths no multiple of 256, ragged n_valid and the EViT grid,
two calls bit for bit, and its xo, o and lse against those of the one-launch
kernel it replaced, pinned by sha256 as B3's at D = 768 are. The
backward kernels B2 and B4 are held the same way, every output, B2's padded
key rows must come out with dk = dv = 0 exactly, and two B2 calls, as two B4
calls, on the same inputs must agree bit for bit; the autograd Functions' gradients
through the kernels are held against the same Functions under
``plain_versions()``. B5 and B6
(``flash_attention_packed``) are held the same way, on q, k and v given as
the strided thirds of one packed qkv tensor, as the model passes them, and
as tensors of their own (``bench_block_fusion``'s layout, and a mix of row
strides); two B6 calls on the same inputs must agree bit for bit. B5 and
B6 in f32 (csrc/flash_f32.cuh, 3xTF32 products, P kept in f32; an f32
model's route) are held against their plain versions in full f32, TF32
off: o within 2e-5 of max|o|, lse within 1e-5, dq, dk and dv within 1e-4
of each max|g| (f32 sums in other orders; one TF32 pass would miss o by
about 1e-3), padded key rows exactly 0 and two B6 calls bit for bit, at
head widths 64 and 128 on the grids above, the DCS recipe's k = 1 grid and
PPT's, through ``FlashPackedFn`` on PPT's unpadded grids, and at B = 2 with
image 1's rows 10^4 times image 0's (image 0 held at its own scale: no
tile reads the next image's rows); float16 still raises (ROADMAP B.5), as does
head width 192 (B.3).

The benchmark scripts' kernels (``diverse_channel_vit_torch/scripts/``) are
held the same way against their plain versions and against their package
siblings on the same inputs: S1 (``bwd_call``) in both schedules, bit for
bit, with padded key rows exactly 0, bit for bit against B6 given B5's lse
(its statistics pass recomputes that lse with B5's instructions) and across
two calls; S2 (``qkv_flash_fwd``) against B5 on the three views of the same
qkv, bit for bit (one kernel, two maps); S3 (``int8_ln_mlp``, B7's kernel)
against B7 on the same weight codes and scales, outputs and hidden codes,
bit for bit. The attention kernels (B1, B2, B5, B6, S1, S2) are held at head
width 128 too (the ``_dh128`` tests: 3 heads at D = 384, one head, 6 heads
at D = 768, ragged last key tiles and the EViT grids; S1's ``pair_batched``
with an odd head count), and refuse head width 192. B2 and B6 launch on a
thread that has made no CUDA call yet. B7
and B8 (the int8 ``ln_mlp``) are also held bit for bit across two calls, B8
at a ragged last row tile with padding rows, and B8's recomputed h against
B7's, bit for bit, at D = 384 and at D = 768 (a cluster of two blocks per
64 rows); at D = 384 their outputs are pinned by sha256 as B3's and B4's
are, and the base preset in int8 launches them at D = 768. The public
``attend_project`` and ``flash_attention_packed`` pad an N that is not a
multiple of 64 and are held at N = 1569 against the plain route, forward and
gradient. B1-B4 are held at the paper's baselines' grid (N = 256, n_valid
197) and at the smaller geometries' (64, 17) and (64, 49); each baseline
model's forward and one train step through the kernels against the same
model under ``plain_versions()`` (logits and gradients within 5e-2 of their
max, ``chip_smoke.py``'s limits).
"""

import contextlib
import hashlib
import threading

import numpy as np
import pytest
import torch

from diverse_channel_vit_torch.device import tf32_off
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
    # at 12 heads: output widths that are no multiple of the projection
    # GEMM's 256-column tile, a ragged last key tile and the EViT grid after
    # layer 3
    (2, 640, 12, 589, True, 384, 1.0),   # D_out = 384: the second tile half empty
    (2, 128, 12, 100, True, 64, 1.0),    # D_out = 64: a quarter of one tile
    (2, 192, 12, 150, True, 768, 1.0),   # ragged n_valid, N = 192
    (2, 1152, 12, 1098, True, 768, 1.0),  # the EViT grid after layer 3
    (2, 192, 8, 150, False, 512, 1.0),   # 8 heads
    (2, 832, 6, 785, True, 384, 1.0),    # HCS dropout and k = 4 of 8 channels: 785 in 832
])
def test_attend_project_kernel_matches_plain(gen, batch, n, heads, n_valid, residual, d_out,
                                             bias, dh=64):
    d = heads * dh
    qkv = _rnd(gen, batch, n, 3 * d)
    x_res = _rnd(gen, batch, n, d_out) if residual else None
    wp, bp = _rnd(gen, d_out, d, scale=d ** -0.5), _rnd(gen, d_out, scale=bias)
    args = (qkv, x_res, wp, bp, heads, dh ** -0.5, n_valid)
    before = fb.LAUNCHES["attend_project_fwd"]
    o_k, lse_k, xo_k = fb.attend_project_fwd(*args, need_o=True)
    o_p, lse_p, xo_p = fb.attend_project_fwd_plain(*args, need_o=True)
    assert fb.LAUNCHES["attend_project_fwd"] == before + 1
    assert _rel(xo_k, xo_p) <= TOL
    assert _rel(o_k, o_p) <= TOL
    assert _rel(lse_k, lse_p) <= 1e-5  # f32 statistics of the same scores
    o_none, lse_none, xo_again = fb.attend_project_fwd(*args)
    assert o_none is None and lse_none is None and torch.equal(xo_again, xo_k)


# head width 128 (the small_tpu preset's 3 heads at D = 384)
@pytest.mark.parametrize("batch,n,heads,n_valid,residual,d_out,bias", [
    (2, 64, 3, 64, True, 384, 1.0),      # one tile, nothing masked
    (2, 128, 3, 100, False, 384, 1.0),   # ragged last key tile, no residual
    (3, 640, 3, 589, True, 384, 1.0),    # the k=3 channel-subset grid
    (2, 1600, 3, 1569, False, 384, 0.0),  # the flagship grid, products alone
    (2, 768, 3, 768, True, 384, 1.0),    # the EViT grid after layer 6: no mask
    (2, 1152, 3, 1098, True, 384, 1.0),  # the EViT grid after layer 3
    (2, 128, 1, 100, True, 128, 1.0),    # one head, D = D_out = 128
    (2, 640, 6, 589, True, 768, 1.0),    # D = 768: 6 heads of 128
    (2, 192, 3, 150, True, 128, 1.0),    # D_out = 128: half of one 256-column tile
])
def test_attend_project_kernel_matches_plain_dh128(gen, batch, n, heads, n_valid, residual,
                                                   d_out, bias):
    test_attend_project_kernel_matches_plain(gen, batch, n, heads, n_valid, residual, d_out,
                                             bias, dh=128)


@pytest.mark.parametrize("batch,n,heads,n_valid,dh,d_out", [
    (2, 1600, 6, 1569, 64, 384),   # the flagship
    (2, 1600, 12, 1569, 64, 768),  # D = 768
    (2, 1600, 3, 1569, 128, 384),  # head width 128
    (3, 192, 12, 150, 64, 384),    # ragged, D_out no multiple of 256
])
def test_attend_project_kernel_is_bit_identical_across_calls(gen, batch, n, heads, n_valid, dh,
                                                             d_out):
    d = heads * dh
    qkv, x_res = _rnd(gen, batch, n, 3 * d), _rnd(gen, batch, n, d_out)
    wp, bp = _rnd(gen, d_out, d, scale=d ** -0.5), _rnd(gen, d_out)
    args = (qkv, x_res, wp, bp, heads, dh ** -0.5, n_valid)
    first, second = (fb.attend_project_fwd(*args, need_o=True) for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(first, second))
    assert torch.equal(fb.attend_project_fwd(*args)[2], first[2])


# the edges of the D = 768 GEMM tiles (128 rows x 256 columns, clusters of
# two row tiles): fewer rows than one wave of tiles, row counts that are no
# multiple of 128 or 256, and hidden widths that are no multiple of 256 (B3
# takes multiples of 64, B4 of 384)
D768_EDGES = [
    ((1, 64, 768), True, 3072),     # M = 64: one row tile, half a cluster pair
    ((5, 1569, 768), True, 3072),   # M = 7845: the unpadded flagship grid
    ((5, 1569, 768), False, 3072),
    ((3, 200, 768), True, 2112),    # HID = 33 x 64
    ((2, 1600, 768), False, 1152),  # HID = 3 x 384
]


@pytest.mark.parametrize("shape,residual,bias,hid", [
    ((2, 64, 384), True, 1.0, None),
    ((3, 640, 384), False, 1.0, None),
    ((1, 100, 384), True, 1.0, None),   # a ragged last row tile
    ((2, 640, 384), False, 0.0, None),  # the MLP's products alone
    ((4, 768, 384), True, 1.0, None),   # the EViT grid after layer 6
    ((3, 64, 384), True, 1.0, None),    # M = 192: a last 128-row tile half full
    ((3, 64, 384), False, 0.0, None),   # the same, products alone
    ((4, 256, 384), True, 1.0, None),   # the recipe's smallest grid (k = 1)
    ((2, 1152, 384), False, 1.0, None),  # the EViT grid after layer 3
    ((2, 1600, 384), True, 1.0, None),  # the flagship grid
    ((2, 832, 384), True, 1.0, None),   # HCS dropout and k = 4 of 8 channels
    # the base preset's width, D = 768 (128 x 256-tile GEMMs)
    ((2, 1600, 768), True, 1.0, None),  # the flagship grid
    ((2, 1600, 768), False, 0.0, None),  # the products alone
    ((1, 100, 768), True, 1.0, None),   # a ragged last row tile
    ((3, 64, 768), False, 1.0, None),   # M = 192
    ((4, 768, 768), True, 1.0, None),   # the EViT grid after layer 6
    ((2, 1152, 768), False, 1.0, None),  # the EViT grid after layer 3
    ((4, 256, 768), True, 1.0, None),   # the recipe's smallest grid (k = 1)
    *((shape, residual, 1.0, hid) for shape, residual, hid in D768_EDGES),
])
def test_ln_mlp_kernel_matches_plain(gen, shape, residual, bias, hid):
    d = shape[-1]
    hid = hid or 4 * d
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
    with pytest.raises(NotImplementedError):  # head width 192
        fb.attend_project_fwd(qkv, None, wp, bp, 2, 0.125, 64)
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
    (2, 832, 6, 785),    # HCS dropout and k = 4 of 8 channels
])
def test_attend_project_bwd_kernel_matches_plain(gen, batch, n, heads, n_valid, dh=64):
    d = heads * dh
    qkv, x_res = _rnd(gen, batch, n, 3 * d), _rnd(gen, batch, n, d)
    wp, bp = _rnd(gen, d, d, scale=d ** -0.5), _rnd(gen, d)
    o, lse, _ = fb.attend_project_fwd(qkv, x_res, wp, bp, heads, dh ** -0.5, n_valid,
                                      need_o=True)
    dxo = _rnd(gen, batch, n, d)
    args = (qkv, o, lse, wp, dxo, heads, dh ** -0.5, n_valid)
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


@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (1, 64, 3, 64),      # B = 1, one tile, nothing masked
    (2, 640, 3, 70),     # n_valid far below N: 8 of 10 key tiles wholly padded
    (3, 640, 3, 589),    # the k = 3 channel-subset grid
    (2, 1600, 3, 1569),  # the flagship grid
    (2, 768, 3, 768),    # the EViT grid after layer 6: no mask
    (1, 192, 3, 150),    # B N = 192 rows: the row pass's last 128-row block half full
    (2, 128, 1, 100),    # one head, D = D_out = 128
    (2, 640, 6, 589),    # D = 768: 6 heads of 128
])
def test_attend_project_bwd_kernel_matches_plain_dh128(gen, batch, n, heads, n_valid):
    test_attend_project_bwd_kernel_matches_plain(gen, batch, n, heads, n_valid, dh=128)


@pytest.mark.parametrize("shape,residual,hid", [
    ((1, 64, 384), True, None),
    ((3, 640, 384), False, None),
    ((1, 100, 384), True, None),   # a ragged last row tile
    ((2, 1600, 384), False, None),
    ((4, 768, 384), True, None),   # the EViT grid after layer 6
    ((3, 64, 384), True, None),    # M = 192: a last 128-row tile half full
    ((3, 64, 384), False, None),
    ((4, 256, 384), False, None),  # the recipe's smallest grid (k = 1)
    ((2, 1152, 384), True, None),  # the EViT grid after layer 3
    ((2, 832, 384), True, None),   # HCS dropout and k = 4 of 8 channels
    # D = 768: dy a 128 x 256-tile GEMM, then the LayerNorm backward
    ((2, 1600, 768), True, None),  # the flagship grid
    ((2, 1600, 768), False, None),
    ((1, 100, 768), True, None),   # a ragged last row tile
    ((3, 64, 768), False, None),   # M = 192: a last 128-row tile half full
    ((4, 768, 768), True, None),   # the EViT grid after layer 6
    ((2, 1152, 768), False, None),  # the EViT grid after layer 3
    ((4, 256, 768), True, None),   # the recipe's smallest grid (k = 1)
    *(e for e in D768_EDGES if e[2] % 384 == 0),
])
def test_ln_mlp_bwd_kernel_matches_plain(gen, shape, residual, hid):
    d = shape[-1]
    hid = hid or 4 * d
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


@pytest.mark.parametrize("shape", [(3, 64, 384), (8, 1600, 384), (3, 64, 768), (8, 1600, 768)])
def test_ln_mlp_bwd_kernel_is_bit_identical_across_calls(gen, shape):
    """B4 sums every partial in a fixed order and uses no atomics: two calls
    on the same inputs agree bit for bit, every output (at D = 768 the pair
    of blocks adds each row's two partial sums in the same order in both)."""
    d = shape[-1]
    hid = 4 * d
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
def test_attend_project_bwd_kernel_is_bit_identical_across_calls(gen, batch, n, heads, dh=64):
    """B2 sums every partial in a fixed order and uses no atomics: two calls
    on the same inputs agree bit for bit, every output."""
    d, n_valid = heads * dh, n - n // 50
    qkv, x_res = _rnd(gen, batch, n, 3 * d), _rnd(gen, batch, n, d)
    wp, bp = _rnd(gen, d, d, scale=d ** -0.5), _rnd(gen, d)
    o, lse, _ = fb.attend_project_fwd(qkv, x_res, wp, bp, heads, 0.125, n_valid, need_o=True)
    args = (qkv, o, lse, wp, _rnd(gen, batch, n, d), heads, 0.125, n_valid)
    first = fb.attend_project_bwd(*args)
    second = fb.attend_project_bwd(*args)
    for name, g1, g2 in zip(("dqkv", "dwp", "dbp", "db_qkv"), first, second):
        assert torch.equal(g1, g2), name


@pytest.mark.parametrize("batch,n,heads", [(3, 64, 3), (8, 1600, 3)])
def test_attend_project_bwd_kernel_is_bit_identical_across_calls_dh128(gen, batch, n, heads):
    test_attend_project_bwd_kernel_is_bit_identical_across_calls(gen, batch, n, heads, dh=128)


def _grads(fn, inputs, cotangent, plain):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    with fb.plain_versions() if plain else contextlib.nullcontext():
        out = fn(*leaves)
        out.backward(cotangent)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("with_residual", [False, True])
def test_attend_project_function_grads_match_plain_route(gen, with_residual, heads=6, d=384):
    """Gradients of every input through AttendProjectFn: the kernel route
    (B1 forward, B2 backward) against the plain route, on the card. Without
    the residual this is DropPath's training route."""
    b, n, n_valid = 2, 640, 589
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


@pytest.mark.parametrize("with_residual", [False, True])
def test_attend_project_function_grads_match_plain_route_dh128(gen, with_residual):
    test_attend_project_function_grads_match_plain_route(gen, with_residual, heads=3)


@pytest.mark.parametrize("with_residual", [False, True])
def test_attend_project_function_grads_match_plain_route_d768(gen, with_residual):
    """The same at the base preset's widths, D = 768 in 12 heads of 64."""
    test_attend_project_function_grads_match_plain_route(gen, with_residual, heads=12, d=768)


@pytest.mark.parametrize("residual,grid", [
    (False, (2, 640)),
    (True, (2, 640)),
    (True, (3, 64)),    # M = 192: a ragged last 128-row tile
    (False, (2, 256)),  # the recipe's smallest grid
])
def test_ln_mlp_function_grads_match_plain_route(gen, residual, grid, d=384):
    """Gradients of every input through LnMlpFn: the kernel route (B3
    forward, B4 backward) against the plain route, on the card. Without the
    residual this is DropPath's training route."""
    hid = 4 * d
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


@pytest.mark.parametrize("residual,grid", [(False, (2, 640)), (True, (3, 64))])
def test_ln_mlp_function_grads_match_plain_route_d768(gen, residual, grid):
    """The same at the base preset's widths, D = 768 and hidden 3072."""
    test_ln_mlp_function_grads_match_plain_route(gen, residual, grid, d=768)


# sha256 of B3's, B4's, B7's and B8's outputs at D = 384 on the inputs of
# _pinned_inputs (B7 and B8 on the weights' int8 copies), taken on an H100
# SXM (132 SMs: B4's and B8's row splits follow the SM count) from the
# libraries before and after D became a template parameter of each, which
# agree bit for bit: a change to the D = 384 code path must leave these as
# they are
PINNED_D384 = {
    # B1 at the flagship's 6 heads of 64: xo, o, lse, taken on the one-launch
    # kernel B1 was before its attention and projection became two launches
    "attend_project_fwd": "4a1c7dc4ff07b4c410af95ef9b046e9bc1768db295200be4a19bf09984c0196e",
    "ln_mlp_fwd": "90ac5f4e6ecf78c3a7200640e1e6a5468a2b912b4889632fcc9a27dcd2e399a4",
    "ln_mlp_bwd": "517df157e015d74629b46a064a298bfecce4c83ac844dec985d4494ddd751a82",
    "ln_mlp_q_fwd": "17ac91f09b5edf7e21b3f44869eb6887487ecb7d9905e118d7d3e237b5ab7b8f",
    "ln_mlp_q_bwd": "9543643469ee7404636420e01c06d61542ae6b736ddb263a84d7124fd3cec9cb",
}


def _numpy_draws(seed: int):
    """t(shape, scale, dtype): draws of a numpy generator seeded with
    ``seed`` on the card, so that they do not depend on the card or the
    PyTorch build."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(
            device="cuda", dtype=dtype)
    return t


def _pinned_inputs(d=384, hid=1536):
    """Fixed bf16 / f32 inputs at model width d and hidden width hid on (3,
    200) tokens (a ragged last row tile), drawn by numpy from seed d."""
    t = _numpy_draws(d)
    x, do = t((3, 200, d)), t((3, 200, d))
    s, b = t((d,), 0.1, torch.float32) + 1.0, t((d,), 0.1, torch.float32)
    w1, b1, w2, b2 = t((hid, d), d ** -0.5), t((hid,)), t((d, hid), hid ** -0.5), t((d,))
    return x, s, b, w1, b1, w2, b2, do


def _pinned_ap_inputs(heads, dh, d_out, batch=2, n=192):
    """Fixed inputs of B1 (qkv, x_res, wp, bp) with ``heads`` heads of
    ``dh``, drawn by numpy from a seed of the shape."""
    t = _numpy_draws(1000 * heads + dh + d_out)
    d = heads * dh
    return t((batch, n, 3 * d)), t((batch, n, d_out)), t((d_out, d), d ** -0.5), t((d_out,))


def _digest(*outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def test_ln_mlp_kernels_at_d384_give_their_pinned_outputs(gen):
    """B3 and B4 at D = 384 (residual fused) give, bit for bit, the outputs
    they gave before D became a template parameter."""
    x, s, b, w1, b1, w2, b2, do = _pinned_inputs()
    assert _digest(fb.ln_mlp_fwd(x, s, b, w1, b1, w2, b2, True)) == PINNED_D384["ln_mlp_fwd"]
    assert _digest(*fb.ln_mlp_bwd(x, s, b, w1, b1, w2, do, True)) == PINNED_D384["ln_mlp_bwd"]


def test_attend_project_kernel_at_d384_gives_its_pinned_outputs(gen):
    """B1 at the flagship's 6 heads of 64 (residual fused, a ragged last key
    tile) gives, bit for bit, the xo, o and lse of the one-launch kernel it
    replaced."""
    qkv, x, wp, bp = _pinned_ap_inputs(6, 64, 384)
    o, lse, xo = fb.attend_project_fwd(qkv, x, wp, bp, 6, 64 ** -0.5, 150, need_o=True)
    assert _digest(xo, o, lse) == PINNED_D384["attend_project_fwd"]


# sha256 of the o, lse and xo that B1's one-launch kernel gave on
# _pinned_ap_inputs(heads, dh, d_out) with n_valid 150: the two launches give
# them bit for bit (the attention is B5's tile loop, the projection sums the
# same products in the same order), so B2 reads the o and lse it read then
PINNED_FUSED = {
    (12, 64, 768): ("f258dc6e6b1ff8931224d7e20ceecaeb2b829fa7acaa025117a2f99c1054aab8",
                    "399abc112a80b7ab2456d3e2c864c069d49faca14b4f190eeeee6ebe079e2ea6",
                    "d9a0d633a5c0dd8449f45a7e372de66db2b5ea46473d396a58829acba1bd1b82"),
    (3, 128, 384): ("d584185441db30b6d8c5ee23843c273443b28c5954b7920b1319c7ffe23f9812",
                    "24117d6dcebf8e10c07882a7814b4e00ca71743b472096c051aac1bb73cb8b6c",
                    "2e6a6338070b650f7c4d233f329f01ec222dab15087e0eef58c80d05ceab4dad"),
    (6, 128, 768): ("ed63f7135f675bfc12411d6ec62eae99468b404416e461041722f7ac9d7ce048",
                    "542a0d967b2ffa1388a1fa64bd2c6fadf5e1d6a6f5d35b15689085042d08a6ce",
                    "a093ca615940a38375a43ced0a749fff94c10ed780d01014be7f917ff3e5778a"),
    (12, 64, 384): ("d05ae4d0cc5f987e1bc3ad0f9fdd5a3c738d3736c1474d1b23442bde517497a3",
                    "2425d3b5299beb9ca334556b5538028fe629b0d2e10b6b9e970a80b0d563c957",
                    "5033caaa9a0ba9e292ffe3647597128e9deaa2df663c13d1fdef8f408dfa9f2a"),
}


@pytest.mark.parametrize("heads,dh,d_out", sorted(PINNED_FUSED))
def test_attend_project_kernel_gives_the_fused_kernels_outputs(gen, heads, dh, d_out):
    qkv, x, wp, bp = _pinned_ap_inputs(heads, dh, d_out)
    o, lse, xo = fb.attend_project_fwd(qkv, x, wp, bp, heads, dh ** -0.5, 150, need_o=True)
    assert (_digest(o), _digest(lse), _digest(xo)) == PINNED_FUSED[heads, dh, d_out]


# sha256 of B3's output at D = 768, hidden 3072, on _pinned_inputs(768,
# 3072), with and without the residual, taken before its fc2 epilogue
# (EpiBiasResidual) guarded its columns
PINNED_D768 = {
    "ln_mlp_fwd": "14eb571c2f96b721b538368a5d78569861627a1720212161aa69d8f54896ae35",
    "ln_mlp_fwd no residual": "5ab17138f9975de267378b682c7f265759607b22db55523dbf5a6de4fb0a4580",
}


@pytest.mark.parametrize("residual", [True, False])
def test_ln_mlp_kernel_at_d768_gives_its_pinned_output(gen, residual):
    x, s, b, w1, b1, w2, b2, _ = _pinned_inputs(768, 3072)
    key = "ln_mlp_fwd" if residual else "ln_mlp_fwd no residual"
    assert _digest(fb.ln_mlp_fwd(x, s, b, w1, b1, w2, b2, residual)) == PINNED_D768[key]


def test_int8_ln_mlp_kernels_at_d384_give_their_pinned_outputs(gen):
    """B7 and B8 at D = 384 (residual fused) give, bit for bit, the outputs
    they gave before D became a template parameter."""
    x, s, b, w1, b1, w2, b2, do = _pinned_inputs()
    q = fb.quantize_mlp_weights(w1, w2, backward=True)
    assert _digest(fb.ln_mlp_q_fwd(x, s, b, q[0], q[1], b1, q[2], q[3], b2, True)) == \
        PINNED_D384["ln_mlp_q_fwd"]
    assert _digest(*fb.ln_mlp_q_bwd(x, s, b, q[0], q[1], b1, q[4], q[5], q[6], q[7], do,
                                    True)) == PINNED_D384["ln_mlp_q_bwd"]


def test_base_preset_int8_launches_b7_and_b8_on_the_card(gen):
    """The base preset (D = 768) with ``quantization: int8`` runs its fused
    block's MLP through B7 forward and B8 backward at D = 768 (no B3 / B4),
    with finite logits and gradients; a width the int8 kernels are not built
    for (D = 512) still raises NotImplementedError naming ROADMAP B2."""
    from diverse_channel_vit_torch.config import Config
    from diverse_channel_vit_torch.models import build_model

    cfg = Config({"in_channel_names": ["a", "b"], "img_size": [32], "patch_size": 16,
                  "pretrained_model_name": "base", "depth": 2, "quantization": "int8"})
    model = build_model("dichavit", cfg, {"JUMP-CP": [0, 1]}, 5, device="cuda",
                        dtype=torch.bfloat16)
    x = _rnd(gen, 2, 2, 32, 32)
    before = dict(fb.LAUNCHES)
    with torch.inference_mode():
        logits = model(x, torch.arange(2, device="cuda"))[0]
    assert bool(torch.isfinite(logits.float()).all())
    assert fb.LAUNCHES["ln_mlp_q_fwd"] == before["ln_mlp_q_fwd"] + 1  # block 0; 1 is the readout
    logits = model(x, torch.arange(2, device="cuda"))[0]
    logits.float().square().sum().backward()
    assert fb.LAUNCHES["ln_mlp_q_fwd"] == before["ln_mlp_q_fwd"] + 2
    assert fb.LAUNCHES["ln_mlp_q_bwd"] == before["ln_mlp_q_bwd"] + 1
    assert fb.LAUNCHES["ln_mlp_fwd"] == before["ln_mlp_fwd"]
    assert fb.LAUNCHES["ln_mlp_bwd"] == before["ln_mlp_bwd"]
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
               if p.grad is not None)
    x = _rnd(gen, 1, 64, 512)
    q = fb.quantize_mlp_weights(_rnd(gen, 2048, 512), _rnd(gen, 512, 2048), backward=True)
    s, b = torch.ones(512, device="cuda"), torch.zeros(512, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP B2"):
        fb.ln_mlp_q_fwd(x, s, b, q[0], q[1], _rnd(gen, 2048), q[2], q[3], _rnd(gen, 512))
    with pytest.raises(NotImplementedError, match="ROADMAP B2"):
        fb.ln_mlp_q_bwd(x, s, b, q[0], q[1], _rnd(gen, 2048), q[4], q[5], q[6], q[7], x)


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
    with pytest.raises(NotImplementedError):  # head width 192
        fb.attend_project_bwd(qkv, o, lse[:, :2].contiguous(), wp, do, 2, 0.125, 64)
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
    # PPT's grids, each padded to a multiple of 64: token pruning's last
    # blocks (2 and 7 tokens), a middle one (99), channel pruning's 785
    (2, 64, 6, 2),
    (2, 64, 6, 7),
    (2, 128, 6, 99),
    (2, 832, 6, 785),
])
def test_flash_packed_kernels_match_plain(gen, batch, n, heads, n_valid, dh=64):
    d, sm = heads * dh, dh ** -0.5
    q, k, v = _rnd(gen, batch, n, 3 * d).split(d, dim=-1)
    before = dict(fb.LAUNCHES)
    o, lse = at.flash_packed_fwd(q, k, v, heads, sm, n_valid, need_lse=True)
    assert fb.LAUNCHES["flash_packed_fwd"] == before["flash_packed_fwd"] + 1
    o_p, lse_p = at.flash_packed_fwd_plain(q, k, v, heads, sm, n_valid, need_lse=True)
    assert _rel(o, o_p) <= TOL
    assert _rel(lse, lse_p) <= 1e-5  # f32 statistics of the same scores
    assert at.flash_packed_fwd(q, k, v, heads, sm, n_valid)[1] is None
    do = _rnd(gen, batch, n, d)
    got = at.flash_packed_bwd(q, k, v, o, do, lse, heads, sm, n_valid)
    assert fb.LAUNCHES["flash_packed_bwd"] == before["flash_packed_bwd"] + 1
    for name, g, w in zip("qkv", got, at.flash_packed_bwd_plain(q, k, v, o, do, lse, heads,
                                                                 sm, n_valid)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= TOL, name
    assert torch.count_nonzero(got[1][:, n_valid:]) == 0
    assert torch.count_nonzero(got[2][:, n_valid:]) == 0


@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (1, 64, 3, 64),      # one tile, nothing masked
    (2, 640, 3, 70),     # n_valid far below N: 8 of 10 key tiles wholly padded
    (2, 128, 1, 100),    # one head, a ragged last key tile
    (3, 576, 3, 537),    # the EViT grid after layer 9
    (2, 1152, 3, 1098),  # the EViT grid after layer 3
    (2, 1600, 3, 1569),  # the flagship grid
    (2, 768, 3, 768),    # the EViT grid after layer 6: no mask
    (2, 640, 6, 589),    # D = 768: 6 heads of 128
])
def test_flash_packed_kernels_match_plain_dh128(gen, batch, n, heads, n_valid):
    test_flash_packed_kernels_match_plain(gen, batch, n, heads, n_valid, dh=128)


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
                                                          n_valid, dh=64):
    d, sm = heads * dh, dh ** -0.5
    q, k, v = _qkv_views(gen, layout, batch, n, d)
    o, lse = at.flash_packed_fwd(q, k, v, heads, sm, n_valid, need_lse=True)
    o_p, lse_p = at.flash_packed_fwd_plain(q, k, v, heads, sm, n_valid, need_lse=True)
    assert _rel(o, o_p) <= TOL
    assert _rel(lse, lse_p) <= 1e-5
    do = _rnd(gen, batch, n, d)
    got = at.flash_packed_bwd(q, k, v, o, do, lse, heads, sm, n_valid)
    for name, g, w in zip("qkv", got, at.flash_packed_bwd_plain(q, k, v, o, do, lse, heads,
                                                                 sm, n_valid)):
        assert _rel(g, w) <= TOL, name
    assert torch.count_nonzero(got[1][:, n_valid:]) == 0
    assert torch.count_nonzero(got[2][:, n_valid:]) == 0


@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (2, 1600, 6, 1569),  # the flagship grid
    (3, 576, 6, 537),    # the EViT grid after layer 9
])
def test_flash_packed_bwd_kernel_is_bit_identical_across_calls(gen, batch, n, heads, n_valid,
                                                              dh=64):
    """B6 sums in a fixed order and uses no atomics: two calls on the same
    inputs agree bit for bit, dq, dk and dv."""
    d = heads * dh
    q, k, v = _rnd(gen, batch, n, 3 * d).split(d, dim=-1)
    o, lse = at.flash_packed_fwd(q, k, v, heads, dh ** -0.5, n_valid, need_lse=True)
    args = (q, k, v, o, _rnd(gen, batch, n, d), lse, heads, dh ** -0.5, n_valid)
    first = at.flash_packed_bwd(*args)
    second = at.flash_packed_bwd(*args)
    for name, g1, g2 in zip("qkv", first, second):
        assert torch.equal(g1, g2), name


@pytest.mark.parametrize("layout", ["separate", "mixed"])
def test_flash_packed_kernels_match_plain_on_other_layouts_dh128(gen, layout):
    test_flash_packed_kernels_match_plain_on_other_layouts(gen, layout, 2, 1152, 3, 1098,
                                                           dh=128)


@pytest.mark.parametrize("batch,n,heads,n_valid", [(2, 1600, 3, 1569), (3, 576, 3, 537)])
def test_flash_packed_bwd_kernel_is_bit_identical_across_calls_dh128(gen, batch, n, heads,
                                                                    n_valid):
    test_flash_packed_bwd_kernel_is_bit_identical_across_calls(gen, batch, n, heads, n_valid,
                                                               dh=128)


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


@pytest.mark.parametrize("n", [2, 7, 99, 785])
def test_flash_packed_public_op_at_ppt_grids_matches_plain_route(gen, n):
    """PPT's blocks call the public op on their unpadded grids: it pads q, k
    and v to a multiple of 64, masks the pad keys and returns the first n
    rows. Output and gradients of the kernel route (B5 forward, B6 backward)
    against the plain route, on the card."""
    b, d, heads = 2, 384, 6

    def fn(qkv):
        return at.flash_attention_packed(*qkv.split(d, dim=-1), heads)

    qkv, cot = _rnd(gen, b, n, 3 * d), _rnd(gen, b, n, d)
    with torch.no_grad():
        got = fn(qkv)
        with fb.plain_versions():
            want = fn(qkv)
    assert got.shape == (b, n, d) and _rel(got, want) <= TOL
    before = dict(fb.LAUNCHES)
    (g,) = _grads(fn, [qkv], cot, plain=False)
    assert fb.LAUNCHES["flash_packed_fwd"] == before["flash_packed_fwd"] + 1
    assert fb.LAUNCHES["flash_packed_bwd"] == before["flash_packed_bwd"] + 1
    (w,) = _grads(fn, [qkv], cot, plain=True)
    for j, name in enumerate("qkv"):
        assert _rel(g[..., j * d:(j + 1) * d], w[..., j * d:(j + 1) * d]) <= TOL, name


def test_flash_packed_wrappers_raise_on_what_they_do_not_take(gen):
    q, k, v = _rnd(gen, 1, 64, 3 * 384).split(384, dim=-1)
    with pytest.raises(NotImplementedError, match="B.5"):  # float16
        at.flash_packed_fwd(q.half(), k.half(), v.half(), 6, 0.125, 64)
    with pytest.raises(NotImplementedError, match="B.5"):  # q and k, v of two dtypes
        at.flash_packed_fwd(q.float(), k, v, 6, 0.125, 64)
    with pytest.raises(NotImplementedError, match="B.3"):  # head width 192
        at.flash_packed_fwd(q, k, v, 2, 0.125, 64)
    with pytest.raises(NotImplementedError, match="B.3"):  # head width 192 in f32
        at.flash_packed_fwd(q.float(), k.float(), v.float(), 2, 0.125, 64)
    with pytest.raises(NotImplementedError, match="B5"):  # N not a multiple of 64
        at.flash_packed_fwd(q[:, :60], k[:, :60], v[:, :60], 6, 0.125, 60)
    qt = _rnd(gen, 1, 384, 64).transpose(1, 2)  # columns not contiguous
    with pytest.raises(NotImplementedError, match="B5"):
        at.flash_packed_fwd(qt, k, v, 6, 0.125, 64)
    # f32 rows 386 elements apart: not a multiple of 16 bytes
    q_odd = _rnd(gen, 1, 64, 386, dtype=torch.float32)[..., :384]
    with pytest.raises(NotImplementedError, match="B5"):
        at.flash_packed_fwd(q_odd, k.float(), v.float(), 6, 0.125, 64)
    o, lse = at.flash_packed_fwd(q, k, v, 6, 0.125, 64, need_lse=True)
    with pytest.raises(NotImplementedError, match="B.5"):  # float16 backward
        at.flash_packed_bwd(q.half(), k.half(), v.half(), o.half(), o.half(), lse, 6,
                            0.125, 64)
    with pytest.raises(NotImplementedError, match="B5"):
        at.flash_packed_bwd(qt, k, v, o, o, lse, 6, 0.125, 64)


# B5 and B6 in f32 (csrc/flash_f32.cuh, 3xTF32 products, P in f32) against
# their plain versions in full f32 (TF32 off): o within 2e-5 of max|o|, lse
# within 1e-5, dq, dk and dv within 1e-4 of each max|g|. Both sum f32
# products in other orders; one TF32 pass would miss o by about 1e-3.
F32_O_TOL, F32_GRAD_TOL = 2e-5, 1e-4


@pytest.fixture
def full_f32(gen):
    with tf32_off():
        yield gen


def _f32_qkv(gen, layout, batch, n, d):
    """f32 q, k and v: the thirds of one packed qkv tensor ("packed", as the
    model passes them), or another layout of :func:`_qkv_views`."""
    if layout == "packed":
        return _rnd(gen, batch, n, 3 * d, dtype=torch.float32).split(d, dim=-1)
    return tuple(t.float() for t in _qkv_views(gen, layout, batch, n, d))


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("batch,n,d,n_valid,layout", [
    (1, 64, 384, 64, "packed"),      # one tile, nothing masked
    (2, 640, 384, 70, "packed"),     # n_valid far below N: most key tiles wholly padded
    (2, 128, 128, 100, "packed"),    # two heads of 64 or one of 128, a ragged last tile
    (3, 576, 384, 537, "packed"),    # the EViT grid after layer 9
    (2, 1600, 384, 1569, "packed"),  # the flagship grid
    (2, 256, 384, 197, "packed"),    # the DCS recipe at k = 1
    (2, 64, 384, 2, "packed"),       # PPT token pruning's last blocks
    (2, 832, 384, 785, "packed"),    # PPT channel pruning
    (2, 768, 768, 768, "packed"),    # D = 768, nothing masked
    (2, 1152, 384, 1098, "separate"),
    (2, 640, 768, 589, "mixed"),
])
def test_flash_packed_f32_kernels_match_plain(full_f32, batch, n, d, n_valid, layout, dh):
    gen, heads, sm = full_f32, d // dh, dh ** -0.5
    q, k, v = _f32_qkv(gen, layout, batch, n, d)
    before = dict(fb.LAUNCHES)
    o, lse = at.flash_packed_fwd(q, k, v, heads, sm, n_valid, need_lse=True)
    assert fb.LAUNCHES["flash_packed_fwd_f32"] == before["flash_packed_fwd_f32"] + 1
    assert fb.LAUNCHES["flash_packed_fwd"] == before["flash_packed_fwd"]
    o_p, lse_p = at.flash_packed_fwd_plain(q, k, v, heads, sm, n_valid, need_lse=True)
    assert o.dtype == torch.float32 and o.shape == o_p.shape
    assert _rel(o, o_p) <= F32_O_TOL
    assert _rel(lse, lse_p) <= 1e-5
    do = _rnd(gen, batch, n, d, dtype=torch.float32)
    got = at.flash_packed_bwd(q, k, v, o, do, lse, heads, sm, n_valid)
    assert fb.LAUNCHES["flash_packed_bwd_f32"] == before["flash_packed_bwd_f32"] + 1
    assert fb.LAUNCHES["flash_packed_bwd"] == before["flash_packed_bwd"]
    for name, g, w in zip("qkv", got, at.flash_packed_bwd_plain(q, k, v, o, do, lse, heads,
                                                                 sm, n_valid)):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel(g, w) <= F32_GRAD_TOL, name
    assert torch.count_nonzero(got[1][:, n_valid:]) == 0
    assert torch.count_nonzero(got[2][:, n_valid:]) == 0
    again = at.flash_packed_bwd(q, k, v, o, do, lse, heads, sm, n_valid)
    for name, g1, g2 in zip("qkv", got, again):
        assert torch.equal(g1, g2), name


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("n,n_valid", [(99, None), (785, None), (640, 589)])
def test_flash_packed_f32_function_grads_match_plain_route(full_f32, n, n_valid, dh):
    """The public op in f32 through FlashPackedFn (B5-f32 forward, B6-f32
    backward), on PPT's unpadded grids (padded inside the op) and a masked
    padded one: output and the packed qkv's gradient against the plain
    route."""
    gen, b, d = full_f32, 2, 384
    heads = d // dh

    def fn(qkv):
        return at.flash_attention_packed(*qkv.split(d, dim=-1), heads, valid_len=n_valid)

    qkv = _rnd(gen, b, n, 3 * d, dtype=torch.float32)
    cot = _rnd(gen, b, n, d, dtype=torch.float32)
    with torch.no_grad():
        got = fn(qkv)
        with fb.plain_versions():
            want = fn(qkv)
    assert got.shape == (b, n, d) and _rel(got, want) <= F32_O_TOL
    before = dict(fb.LAUNCHES)
    (g,) = _grads(fn, [qkv], cot, plain=False)
    assert fb.LAUNCHES["flash_packed_fwd_f32"] == before["flash_packed_fwd_f32"] + 1
    assert fb.LAUNCHES["flash_packed_bwd_f32"] == before["flash_packed_bwd_f32"] + 1
    (w,) = _grads(fn, [qkv], cot, plain=True)
    assert fb.LAUNCHES["flash_packed_bwd_f32"] == before["flash_packed_bwd_f32"] + 1
    for j, name in enumerate("qkv"):
        assert _rel(g[..., j * d:(j + 1) * d], w[..., j * d:(j + 1) * d]) <= F32_GRAD_TOL, name


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("n,n_valid", [(1600, 1569), (576, 537), (64, 40)])
def test_flash_packed_f32_image_rows_stay_in_their_image(full_f32, n, n_valid, dh):
    """B = 2 with image 1's q, k, v and do 10^4 times image 0's: image 0's o,
    lse and gradients within the f32 limits of image 0's own scale, so no
    tile of image 0 read image 1's rows (N = 1600 and 576 are no multiple of
    the f32 kernels' 128-row blocks)."""
    gen, d = full_f32, 384
    heads, sm = d // dh, dh ** -0.5
    scale = torch.tensor([1.0, 1e4], device="cuda")[:, None, None]
    qkv = _rnd(gen, 2, n, 3 * d, dtype=torch.float32) * scale
    q, k, v = qkv.split(d, dim=-1)
    do = _rnd(gen, 2, n, d, dtype=torch.float32) * scale
    o, lse = at.flash_packed_fwd(q, k, v, heads, sm, n_valid, need_lse=True)
    o_p, lse_p = at.flash_packed_fwd_plain(q[:1], k[:1], v[:1], heads, sm, n_valid,
                                           need_lse=True)
    assert _rel(o[:1], o_p) <= F32_O_TOL
    assert _rel(lse[:1], lse_p) <= 1e-5
    got = at.flash_packed_bwd(q, k, v, o, do, lse, heads, sm, n_valid)
    want = at.flash_packed_bwd_plain(q[:1], k[:1], v[:1], o[:1], do[:1], lse[:1], heads, sm,
                                     n_valid)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g[:1], w) <= F32_GRAD_TOL, name
    assert torch.count_nonzero(got[1][:, n_valid:]) == 0
    assert torch.count_nonzero(got[2][:, n_valid:]) == 0


def _mlp_inputs(gen, shape, bias=1.0):
    d = shape[-1]
    hid = 4 * d
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
    ((3, 200, 768), True, 1.0),   # D = 768: ragged last 64- and 128-row tiles
    ((2, 1600, 768), False, 0.0),  # the base preset's grid, products alone
])
def test_ln_mlp_q_kernels_match_plain(gen, shape, residual, bias):
    """B7 and B8 (the int8 ln_mlp) against their plain versions, every
    output and the codes of their last int8 product (hidden 4 D)."""
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
def test_ln_mlp_int8_function_grads_match_plain_route(gen, residual, d=384):
    """Gradients of every input through LnMlpFn with ``quantized``: the
    kernel route (B7 forward, B8 backward) against the plain route."""
    inputs = list(_mlp_inputs(gen, (2, 640, d)))

    def fn(*a):
        return fb.ln_mlp(*a, residual, quantized=True)

    cot = _rnd(gen, 2, 640, d)
    before = dict(fb.LAUNCHES)
    got = _grads(fn, inputs, cot, plain=False)
    assert fb.LAUNCHES["ln_mlp_q_fwd"] == before["ln_mlp_q_fwd"] + 1
    assert fb.LAUNCHES["ln_mlp_q_bwd"] == before["ln_mlp_q_bwd"] + 1
    assert fb.LAUNCHES["ln_mlp_fwd"] == before["ln_mlp_fwd"]
    want = _grads(fn, inputs, cot, plain=True)
    assert fb.LAUNCHES["ln_mlp_q_bwd"] == before["ln_mlp_q_bwd"] + 1
    for name, g, w in zip(("x", "scale", "bias", "w1", "b1", "w2", "b2"), got, want):
        assert g.dtype == w.dtype and _rel(g, w) <= TOL, name


@pytest.mark.parametrize("residual", [False, True])
def test_ln_mlp_int8_function_grads_match_plain_route_d768(gen, residual):
    """The same at the base preset's widths, D = 768 and hidden 3072."""
    test_ln_mlp_int8_function_grads_match_plain_route(gen, residual, d=768)


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
    # D = 768 pairs 128-unit hidden slices between two blocks: HID a multiple of 256
    x3 = _rnd(gen, 1, 64, 768)
    s3, b3 = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
    q = fb.quantize_mlp_weights(_rnd(gen, 1152, 768), _rnd(gen, 768, 1152))
    with pytest.raises(ValueError):
        fb.ln_mlp_q_fwd(x3, s3, b3, q[0], q[1], _rnd(gen, 1152), q[2], q[3], _rnd(gen, 768))
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


@pytest.mark.parametrize("shape", [(1, 100, 384), (8, 1600, 384), (3, 200, 768)])
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


@pytest.mark.parametrize("shape", [(1, 100, 384), (3, 1569, 384), (3, 1569, 768)])
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
    d = shape[-1]
    assert _rel(dx.reshape(-1, d)[-tail:], dx_p.reshape(-1, d)[-tail:]) <= TOL
    assert (got[7] != want[7]).float().mean().item() <= MAX_CODE_FLIPS


def test_ln_mlp_q_gelu_facts_hold_on_every_float(gen):
    """B7's first pass takes a row's max|h| from GELU of the row's largest
    input once that reaches 0.3 (csrc/int8.cuh, kGeluPosDominates). So the
    library's own GELU must be non-decreasing over every non-negative float
    and, over every negative float, smaller in magnitude than at 0.3."""
    facts = fb.gelu_facts("cuda")
    assert facts["finite"] and facts["steps_down"] == 0, facts
    assert facts["neg_max"] < facts["at_bound"], facts


@pytest.mark.parametrize("shape,residual", [((1, 100, 384), True), ((2, 1600, 384), False),
                                            ((3, 200, 768), True)])
def test_ln_mlp_q_bwd_recompute_is_the_forward(gen, shape, residual):
    """B8 recomputes the forward's int8 fc1: its h (the bf16 operand of dW2,
    returned with ``with_h``) equals B7's h rounded to bf16 (the h that B7
    quantises into the codes fc2 reads), bit for bit, so the LayerNorm, the
    y codes, the int8 sums, the dequantisation and the GELU are the
    forward's; both are within TOL of the plain version's h."""
    fwd, bwd = _q_args(gen, shape)
    h7 = fb.ln_mlp_q_fwd(*fwd, residual, with_h=True)[1]
    h8 = fb.ln_mlp_q_bwd(*bwd, residual, with_h=True)[7]
    assert h8.shape == (shape[0] * shape[1], 4 * shape[-1]) and h8.dtype == torch.bfloat16
    assert torch.equal(h7, h8)
    assert _rel(h8, fb.ln_mlp_q_plain(*fwd, residual, with_h=True)[1]) <= TOL


@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (1, 128, 2, 100),    # two heads, a ragged last key tile
    (2, 640, 6, 589),    # the k=3 channel-subset grid: one wholly padded key tile
    (2, 1664, 6, 1569),  # the benchmark's grid
])
def test_bwd_call_kernel_matches_plain(gen, batch, n, heads, n_valid, dh=64):
    """S1 in both schedules against its plain version; the two schedules
    agree bit for bit, and padded key rows get dk = dv = 0 exactly."""
    d = heads * dh
    q, k, v, o, do = (_rnd(gen, batch, n, d) for _ in range(5))
    args = (q, k, v, o, do, heads, dh ** -0.5, n_valid)
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
# head width 128: `bench_attn --heads 3`; an odd head count, so pair_batched's
# last block carries one head
S1_GRIDS_DH128 = [
    (1, 128, 1, 100),    # one head, a ragged last key tile
    (2, 640, 3, 589),    # one wholly padded key tile
    (2, 1664, 3, 1569),  # the benchmark's grid at --heads 3
    (1, 192, 2, 150),    # two heads: one full pair
]


@pytest.mark.parametrize("batch,n,heads,n_valid", S1_GRIDS_DH128)
def test_bwd_call_kernel_matches_plain_dh128(gen, batch, n, heads, n_valid):
    test_bwd_call_kernel_matches_plain(gen, batch, n, heads, n_valid, dh=128)


@pytest.mark.parametrize("batch,n,heads,n_valid", S1_GRIDS)
def test_bwd_call_kernel_matches_b6_given_b5_lse(gen, batch, n, heads, n_valid, dh=64):
    """S1 (pair_staged) against B6 (flash_packed_bwd) fed the lse of B5
    (flash_packed_fwd) on the same q, k, v, o and do: S1's statistics pass
    recomputes that lse with B5's instructions and then runs B6's passes, so
    dq, dk and dv agree bit for bit."""
    d, sm = heads * dh, dh ** -0.5
    q, k, v, o, do = (_rnd(gen, batch, n, d) for _ in range(5))
    lse = at.flash_packed_fwd(q, k, v, heads, sm, n_valid, need_lse=True)[1]
    want = at.flash_packed_bwd(q, k, v, o, do, lse, heads, sm, n_valid)
    got = s1.bwd_call(q, k, v, o, do, heads, sm, n_valid, "pair_staged")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("batch,n,heads,n_valid", S1_GRIDS_DH128)
def test_bwd_call_kernel_matches_b6_given_b5_lse_dh128(gen, batch, n, heads, n_valid):
    test_bwd_call_kernel_matches_b6_given_b5_lse(gen, batch, n, heads, n_valid, dh=128)


@pytest.mark.parametrize("batch,n,heads,n_valid", S1_GRIDS)
def test_bwd_call_kernel_is_bit_identical_across_calls(gen, batch, n, heads, n_valid, dh=64):
    """Two S1 calls on the same inputs, in each schedule, agree bit for bit
    (every reduction in a fixed order, no atomics)."""
    d = heads * dh
    args = tuple(_rnd(gen, batch, n, d) for _ in range(5)) + (heads, dh ** -0.5, n_valid)
    for variant in s1.VARIANTS:
        first = s1.bwd_call(*args, variant)
        again = s1.bwd_call(*args, variant)
        for name, a, b in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, b), (variant, name)


@pytest.mark.parametrize("batch,n,heads,n_valid", S1_GRIDS_DH128)
def test_bwd_call_kernel_is_bit_identical_across_calls_dh128(gen, batch, n, heads, n_valid):
    test_bwd_call_kernel_is_bit_identical_across_calls(gen, batch, n, heads, n_valid, dh=128)


@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (1, 128, 2, 128),    # nothing masked
    (2, 640, 6, 589),
    (2, 1664, 6, 1569),  # the benchmark's grid
])
def test_qkv_flash_kernel_matches_plain_and_b5(gen, batch, n, heads, n_valid, dh=64):
    """S2 against its plain version, and against B5 (flash_packed_fwd) on the
    three column blocks of the same qkv: S2 is B5's kernel on one packed qkv
    map at column offsets 0, D and 2D, so the two agree bit for bit."""
    d, sm = heads * dh, dh ** -0.5
    qkv = _rnd(gen, batch, n, 3 * d)
    before = fb.LAUNCHES["qkv_flash_fwd"]
    o = s2.qkv_flash_fwd(qkv, heads, sm, n_valid)
    assert fb.LAUNCHES["qkv_flash_fwd"] == before + 1
    assert o.shape == (batch, n, d) and o.dtype == qkv.dtype
    plain = s2.qkv_flash_fwd_plain(qkv, heads, sm, n_valid)
    b5 = at.flash_packed_fwd(*qkv.split(d, dim=-1), heads, sm, n_valid)[0]
    assert _rel(o, plain) <= TOL
    assert _rel(b5, plain) <= TOL
    assert torch.equal(o, b5)


@pytest.mark.parametrize("batch,n,heads,n_valid", [
    (1, 128, 1, 128),    # one head, nothing masked
    (2, 640, 3, 589),
    (2, 1664, 3, 1569),  # the benchmark's grid at 3 heads
])
def test_qkv_flash_kernel_matches_plain_and_b5_dh128(gen, batch, n, heads, n_valid):
    test_qkv_flash_kernel_matches_plain_and_b5(gen, batch, n, heads, n_valid, dh=128)


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


def test_backward_kernels_launch_on_a_thread_with_no_cuda_call_yet(gen):
    """A thread that has made no CUDA call yet, as autograd's device thread
    may be when a backward kernel is its first work, launches B2 and B6 (the
    main thread used both first, and the caching allocator holds every block
    the thread's calls take): their outputs equal the main thread's, bit for
    bit. The TMA encoder needs a current context, which each entry point
    makes current first (ROADMAP C5)."""
    b, n, d, heads, n_valid = 2, 640, 384, 6, 589
    qkv, wp, bp, dxo = (_rnd(gen, b, n, 3 * d), _rnd(gen, d, d, scale=d ** -0.5),
                        _rnd(gen, d), _rnd(gen, b, n, d))
    o, lse, _ = fb.attend_project_fwd(qkv, None, wp, bp, heads, 0.125, n_valid, need_o=True)
    q, k, v = qkv.split(d, dim=-1)
    o5, lse5 = at.flash_packed_fwd(q, k, v, heads, 0.125, n_valid, need_lse=True)

    def calls():
        return (fb.attend_project_bwd(qkv, o, lse, wp, dxo, heads, 0.125, n_valid),
                at.flash_packed_bwd(q, k, v, o5, dxo, lse5, heads, 0.125, n_valid))

    calls()  # the blocks the calls take go back to the allocator's cache
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["out"] = calls()
        except Exception as e:  # noqa: BLE001 (raised again below, on the test's thread)
            got["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "error" in got:
        raise got["error"]
    for part, want in zip(got["out"], calls()):
        for g, w in zip(part, want):
            assert torch.equal(g, w)


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
    with pytest.raises(NotImplementedError, match="S1"):  # head width 192
        s1.bwd_call(q, k, v, o, do, 2, 0.125, 64)
    # an odd head count in pairs: the last pair is one head, as in the TPU kernel
    q5, k5, v5, o5, do5 = (_rnd(gen, 1, 64, 320) for _ in range(5))
    for a, b in zip(s1.bwd_call(q5, k5, v5, o5, do5, 5, 0.125, 64, "pair_batched"),
                    s1.bwd_call(q5, k5, v5, o5, do5, 5, 0.125, 64, "pair_staged")):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        s1.bwd_call(q, k, v, o, do, 6, 0.125, 64, "pair_unknown")
    qkv = _rnd(gen, 1, 64, 3 * 384)
    with pytest.raises(NotImplementedError, match="S2"):  # f32
        s2.qkv_flash_fwd(qkv.float(), 6, 0.125, 64)
    with pytest.raises(NotImplementedError, match="S2"):  # head width 192
        s2.qkv_flash_fwd(qkv, 2, 0.125, 64)
    # S3 launches B7's kernel through B7's wrapper, and refuses what B7 refuses
    x, s, b, w1, b1, w2, b2 = _mlp_inputs(gen, (1, 64, 384))
    w1q, sc1 = s3.quant_w(w1)
    w2q, sc2 = s3.quant_w(w2)
    with pytest.raises(ValueError, match="x"):  # f32 input
        s3.int8_ln_mlp(x.float(), s, b, w1q, sc1, b1, w2q, sc2, b2)
    x2 = _rnd(gen, 1, 64, 256)
    c1, t1 = s3.quant_w(_rnd(gen, 1024, 256))
    c2, t2 = s3.quant_w(_rnd(gen, 256, 1024))
    with pytest.raises(NotImplementedError, match="int8_ln_mlp"):  # D = 256
        s3.int8_ln_mlp(x2, torch.ones(256, device="cuda"), torch.zeros(256, device="cuda"),
                       c1, t1, _rnd(gen, 1024), c2, t2, _rnd(gen, 256))


# the grids of the paper's baseline ViTs and the smaller geometries,
# (images, N, n_valid): 196 patches and the CLS row in 256 (224^2, patch 16),
# 16 and the CLS row in 64 (So2Sat's 32^2, patch 8), 3 channels of 16 and the
# CLS row in 64 (CIFAR's ChannelViT)
@pytest.mark.parametrize("batch,n,n_valid", [(2, 256, 197), (2, 64, 17), (2, 64, 49)])
def test_fused_block_kernels_match_plain_at_the_baselines_grids(gen, batch, n, n_valid):
    """B1 (residual fused) and B2 from its o and lse, B3 (residual fused)
    and B4, 6 heads of 64 at D = 384, hidden 1536: every output within TOL
    of its plain version, padded key rows' dk and dv exactly 0."""
    d, heads, hid = 384, 6, 1536
    qkv, x, do = _rnd(gen, batch, n, 3 * d), _rnd(gen, batch, n, d), _rnd(gen, batch, n, d)
    wp, bp = _rnd(gen, d, d, scale=d ** -0.5), _rnd(gen, d)
    a = (qkv, x, wp, bp, heads, 0.125, n_valid)
    got, want = fb.attend_project_fwd(*a, need_o=True), fb.attend_project_fwd_plain(*a,
                                                                                    need_o=True)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL
    a = (qkv, got[0], got[1], wp, do, heads, 0.125, n_valid)
    bwd = fb.attend_project_bwd(*a)
    for g, w in zip(bwd, fb.attend_project_bwd_plain(*a)):
        assert g.shape == w.shape and _rel(g, w) <= TOL
    assert torch.count_nonzero(bwd[0][:, n_valid:, d:]) == 0
    s, b = 1.0 + _rnd(gen, d, scale=0.1, dtype=torch.float32), _rnd(gen, d, scale=0.1,
                                                                    dtype=torch.float32)
    w1, b1 = _rnd(gen, hid, d, scale=d ** -0.5), _rnd(gen, hid)
    w2, b2 = _rnd(gen, d, hid, scale=hid ** -0.5), _rnd(gen, d)
    a = (x, s, b, w1, b1, w2, b2, True)
    assert _rel(fb.ln_mlp(*a), fb.ln_mlp_plain(*a)) <= TOL
    a = (x, s, b, w1, b1, w2, do, False)
    for g, w in zip(fb.ln_mlp_bwd(*a), fb.ln_mlp_bwd_plain(*a)):
        assert g.shape == w.shape and _rel(g, w) <= TOL


BASELINE_MODELS = {
    "vit_adapt": ("vit_adapt", {}),
    "depthwise_weights": ("depthwisevit_adapt", {"pooling_channel_type": "channel_weights"}),
    "depthwise_attention": ("depthwisevit_adapt", {"pooling_channel_type": "attention"}),
    "hypervit": ("hypervit_adapt", {"hidden_dim": 128}),
    "templatemixing": ("templatemixingvit", {"num_templates": 10}),
}


@pytest.mark.parametrize("variant", sorted(BASELINE_MODELS))
def test_baseline_forward_and_step_match_plain_route(gen, variant):
    """Each baseline at the small preset, depth 3 (blocks 0-1 on the fused
    route at (256, 197), block 2 the readout), 8 channels at 224^2, bf16:
    the eval logits and one CE step's loss and gradients through the kernels
    against the same model under ``plain_versions()``; logits within 5e-2 of
    max|logit| and each gradient within 5e-2 of its max|g| (chip_smoke.py's
    limits), B1 / B3 twice a forward, B1-B4 twice a step."""
    import copy

    from diverse_channel_vit_torch.config import Config
    from diverse_channel_vit_torch.models import build_model

    name, extra = BASELINE_MODELS[variant]
    cfg = Config({"in_channel_names": [f"c{i}" for i in range(8)], "img_size": [224],
                  "patch_size": 16, "pretrained_model_name": "small", "depth": 3, **extra})
    model = build_model(name, cfg, {"train": list(range(8))}, 5, device="cuda",
                        dtype=torch.bfloat16, attn_pooling={})
    plain = copy.deepcopy(model)
    x, cids = _rnd(gen, 2, 8, 224, 224), torch.arange(8, device="cuda")
    y = torch.tensor([1, 3], device="cuda")
    out = {}
    for route, m in (("kernels", model), ("plain", plain)):
        before = dict(fb.LAUNCHES)
        with fb.plain_versions() if route == "plain" else contextlib.nullcontext():
            with torch.no_grad():
                logits = m(x, cids)[0].float()
            m.train()
            loss = torch.nn.functional.cross_entropy(m(x, cids)[0].float(), y)
            loss.backward()
        torch.cuda.synchronize()
        counts = {k: fb.LAUNCHES[k] - before[k] for k in before}
        out[route] = (logits, float(loss), {n: p.grad for n, p in m.named_parameters()
                                            if p.grad is not None}, counts)
    (lk, loss_k, gk, ck), (lp, loss_p, gp, cp) = out["kernels"], out["plain"]
    assert not any(cp.values())
    assert {k: v for k, v in ck.items() if v} == {"attend_project_fwd": 4, "ln_mlp_fwd": 4,
                                                   "attend_project_bwd": 2, "ln_mlp_bwd": 2}
    assert bool(torch.isfinite(lk).all()) and _rel(lk, lp) <= 5e-2
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    assert sorted(gk) == sorted(gp)
    for n, g in gk.items():
        assert _rel(g, gp[n]) <= 5e-2, n
