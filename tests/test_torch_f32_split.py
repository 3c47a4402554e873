"""The tf32 split of the f32 attention kernels (``csrc/flash_f32.cuh``) and
the 3xTF32 arithmetic built on it, emulated on the CPU.

B5 and B6 in f32 take every product as 3xTF32: x = hi + lo with hi =
tf32(x), lo = tf32(x - hi), rounded as ``cvt.rna.tf32.f32`` rounds (to
nearest, ties away from zero, on the 13 low mantissa bits). The kernels'
passes split their q, k, v and do tiles in shared memory into those f32
bit patterns, row-major and, for the products that reduce over keys or
queries, transposed with each 8-row group in the order ``SPLIT_ORDER`` (the
order in which an accumulator's columns meet a tf32 A fragment). Here that
rounding emulated with integer ops on crafted values, its error bound and
layouts, and the attention the kernels compute from those operands (the
products as hi lo + lo hi + hi hi in f64, the softmax in f32, the
transposed copies read in their order) against the JAX package's
``flash_attention_packed`` in f32, whose Pallas kernels run in interpret
mode (tests/conftest.py), forward and gradients: o within 2e-5 of max|o|
(chip_smoke.py's F32_O_TOL), the gradients within 1e-4 of each max|g|
(F32_GRAD_TOL). The kernels themselves are held against their plain
versions on the card (tests/test_torch_kernels_gpu.py).
"""

import jax
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.ops import attention as jat

F32_O_TOL, F32_GRAD_TOL = 2e-5, 1e-4
# an 8-row group of a transposed split copy holds its rows in this order
SPLIT_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded as ``cvt.rna.tf32.f32`` rounds it: to nearest, ties
    away from zero, on the 13 low mantissa bits of its f32 bit pattern,
    which come out zero (adding half of the dropped range to the magnitude
    carries into the kept bits exactly when the dropped bits are at least
    half)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """``(hi, lo)``: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def split_order(n: int) -> torch.Tensor:
    """Row index of each position of an N-long transposed split copy."""
    return torch.arange(n).view(-1, 8)[:, list(SPLIT_ORDER)].reshape(-1)


def split_copies(x: torch.Tensor):
    """``(rows, cols)`` of one (B, N, D) f32 ``x`` as the kernels lay them
    out in shared memory: rows (2, B, N, D) = (hi, lo); cols (2, B, D, N)
    their transposes, each 8-row group in SPLIT_ORDER."""
    rows = torch.stack(tf32_split(x.float()))
    return rows, rows[:, :, split_order(x.shape[1])].transpose(2, 3).contiguous()


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _from_bits(*words) -> torch.Tensor:
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32)).view(torch.float32)


def test_tf32_round_leaves_the_low_13_bits_zero():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    assert not (_bits(hi) & 0x1FFF).any()
    assert not (_bits(lo) & 0x1FFF).any()
    assert (hi != x).any()  # most values need more than tf32's 10 bits


@pytest.mark.parametrize("word,want", [
    (0x3F801000, 0x3F802000),  # 1 + 2^-11: a tie, away from zero
    (0xBF801000, 0xBF802000),  # its negative: away from zero too
    (0x3F803000, 0x3F804000),  # a tie above an odd kept bit: still up
    (0x3F800FFF, 0x3F800000),  # below the tie: down
    (0x3F801001, 0x3F802000),  # above the tie: up
    (0xBF800FFF, 0xBF800000),
    (0x3FFFF000, 0x40000000),  # the carry reaches the exponent
    (0x00001000, 0x00002000),  # a subnormal tie
])
def test_tf32_round_ties_away_from_zero(word, want):
    got = tf32_round(_from_bits(word))
    assert int(_bits(got)[0]) & 0xFFFFFFFF == want


def test_split_passes_zeros_and_padded_rows_as_zeros():
    x = torch.randn(2, 64, 64, generator=torch.Generator().manual_seed(1))
    x[:, 40:] = 0.0  # padded rows
    rows, cols = split_copies(x)
    assert not rows[:, :, 40:].any() and not cols[..., 40:].any()
    neg = tf32_split(torch.tensor([-0.0, 0.0]))
    assert all(not t.any() for t in neg)


def test_split_error_is_within_2_to_the_minus_22():
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal(1 << 14) * 10.0 ** rng.integers(-20, 20, 1 << 14))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


def test_split_copies_keep_each_8_row_group_in_pi_order():
    """rows = (hi, lo) row-major; cols[:, b, c, 8 m + j] = rows[:, b, 8 m +
    order[j], c], on a strided third of one packed qkv."""
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 64, 3 * 32, generator=g)
    _, k, _ = qkv.split(32, dim=-1)
    rows, cols = split_copies(k)
    hi, lo = tf32_split(k.contiguous())
    assert torch.equal(rows, torch.stack((hi, lo)))
    for m in range(8):
        for j in range(8):
            assert torch.equal(cols[:, :, :, 8 * m + j], rows[:, :, 8 * m + SPLIT_ORDER[j], :])


# ---------------------------------------------------------------------------
# the kernels' 3xTF32 attention from the split operands, against JAX
# ---------------------------------------------------------------------------

B, N, N_VALID, HEADS, DH = 1, 256, 197, 2, 64


def _mm3(a_hi, a_lo, b_hi, b_lo):
    """a b as the kernels take it: a_hi b_lo + a_lo b_hi + a_hi b_hi (each
    product exact in f64), rounded to f32."""
    return (a_hi.double() @ b_lo.double() + a_lo.double() @ b_hi.double()
            + a_hi.double() @ b_hi.double()).float()


def _rows(s, h):
    """Head h of a split rows copy (2, B, N, D): (hi, lo), each (B, N, DH)."""
    return s[0][..., h * DH:(h + 1) * DH], s[1][..., h * DH:(h + 1) * DH]


def _cols(s, h):
    """Head h of a split cols copy (2, B, D, N), back in the pi order's key
    positions: (hi, lo), each (B, N, DH), row p = the copy's position p."""
    return (s[0][:, h * DH:(h + 1) * DH].transpose(1, 2),
            s[1][:, h * DH:(h + 1) * DH].transpose(1, 2))


def _split(x):
    return tf32_split(x)


def _kernel_arith(q, k, v, do, scale, n_valid):
    """o, lse and the gradients as B5-f32 and B6-f32 compute them at head
    width 64 from the split copies their passes make in shared memory: S
    and dP from the rows copies; P, P^T, dS and dS^T split in registers; P
    V, P^T dO, dS^T Q and dS K with the register operand's columns taken in
    the pi order against the cols copies."""
    order = split_order(N)
    (q_r, q_c), (k_r, k_c), (v_r, v_c), (do_r, do_c) = map(split_copies, (q, k, v, do))
    o = torch.empty(B, N, HEADS * DH)
    grads = [torch.empty(B, N, HEADS * DH) for _ in range(3)]
    lses = []
    masked = torch.arange(N) >= n_valid
    for h in range(HEADS):
        sl = slice(h * DH, (h + 1) * DH)
        qh, kh, vh, doh = _rows(q_r, h), _rows(k_r, h), _rows(v_r, h), _rows(do_r, h)
        s = _mm3(qh[0], qh[1], kh[0].transpose(1, 2), kh[1].transpose(1, 2))
        s = s.masked_fill(masked, -torch.inf) * (scale * 1.4426950408889634)
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(-1, keepdim=True)
        ph, pl = _split(p[..., order])  # A's columns in the pi order
        vt = _cols(v_c, h)
        o[..., sl] = _mm3(ph, pl, vt[0], vt[1]) / l
        lse = (m + torch.log2(l)) * 0.6931471805599453
        lses.append(lse)
        # the backward, P from the log-sum-exp
        dp = _mm3(doh[0], doh[1], vh[0].transpose(1, 2), vh[1].transpose(1, 2))
        pb = torch.exp2(s - lse * 1.4426950408889634).masked_fill(masked, 0.0)
        di = (o[..., sl] * do[..., sl]).sum(-1, keepdim=True)
        ds = pb * (dp - di) * scale
        dsh, dsl = _split(ds[..., order])
        kt, qt, dot = _cols(k_c, h), _cols(q_c, h), _cols(do_c, h)
        grads[0][..., sl] = _mm3(dsh, dsl, kt[0], kt[1])
        pt = _split(pb.transpose(1, 2)[..., order])  # P^T: keys x queries
        grads[2][..., sl] = _mm3(pt[0], pt[1], dot[0], dot[1])
        dst = _split(ds.transpose(1, 2)[..., order])
        grads[1][..., sl] = _mm3(dst[0], dst[1], qt[0], qt[1])
    return o, grads


def _against_jax(n_valid):
    rng = np.random.default_rng(4)
    q, k, v, do = (rng.standard_normal((B, N, HEADS * DH)).astype(np.float32)
                   for _ in range(4))
    fn = jax.jit(lambda a, b_, c: jat.flash_attention_packed(a, b_, c, HEADS,
                                                             valid_len=n_valid))
    want, vjp = jax.vjp(fn, q, k, v)
    want_g = vjp(do)
    scale = DH ** -0.5
    o, grads = _kernel_arith(*(torch.from_numpy(x) for x in (q, k, v, do)), scale, n_valid)
    want = np.asarray(want)
    assert float(np.abs(o.numpy() - want).max()) <= F32_O_TOL * float(np.abs(want).max())
    for name, g, w in zip("qkv", grads, want_g):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= F32_GRAD_TOL * float(np.abs(w).max()), name
        if name != "q":  # padded keys: exact zeros
            assert not g[:, n_valid:].any(), name


def test_3xtf32_attention_from_the_split_matches_jax():
    _against_jax(N_VALID)


def test_3xtf32_attention_with_every_key_valid_matches_jax():
    _against_jax(N)
