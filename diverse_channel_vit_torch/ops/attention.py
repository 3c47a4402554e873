"""Multi-head attention (counterpart of the JAX package's ``ops/attention.py``):
the mask value, the pad-once policy for the token grid, the plain masked
attention of the CLS readout, and :func:`flash_attention_packed`.

The pad multiple is the port's own: the CUDA kernels work on 64-row tiles,
so the grid is padded once to a multiple of 64 (1569 -> 1600 tokens at the
flagship). Padded keys are masked through ``valid_len`` and padded query rows
are never read, so the padding does not change any real row.

:func:`flash_attention_packed` is masked multi-head attention on lane-packed
(B, N, H*dh) q, k and v, with no projection. Forward kernel
``csrc/flash_packed.cu`` (replaces the TPU kernel ``_packed_fwd_kernel``),
backward kernel ``csrc/flash_packed_bwd.cu`` (replaces
``_packed_bwd_kernel``), inside :class:`FlashPackedFn` when a gradient is
wanted; in bf16 both run on the ``wgmma`` + TMA flash core
``csrc/flash_wgmma.cuh`` that the attend_project kernels share, in f32 on
``csrc/flash_f32.cuh`` (3xTF32 ``wgmma`` products, P kept in f32, as the
TPU kernels run an f32 model's attention; each pass splits its q, k, v and
do tiles into tf32 hi / lo in shared memory). The wrappers follow ``ops/dispatch.py``: the plain version for a CPU
tensor; the kernel, or an exception, for a CUDA one. The kernels take q, k
and v as strided views (each row contiguous, rows ``stride`` elements apart),
each through a TMA map of its own, so the three thirds of one packed
(B, N, 3D) qkv tensor, or three tensors of their own, go in without a copy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels
from .dispatch import (
    LAUNCHES,
    _check,
    _check_launch,
    _launches_kernel,
    _route,
    _wants_grad,
    current_route_plain,
)

MASK_VALUE = -1e30
PAD_MULTIPLE = 64
# the head widths the attention kernels are built for (the flash core's
# template instantiations); the TPU kernels take any multiple of 64
HEAD_WIDTHS = (64, 128)
# the dtypes flash_attention_packed's kernels take, each with its C function
# and launch count; the TPU kernels take any float dtype
FLASH_DTYPES = {torch.bfloat16: "", torch.float32: "_f32"}


def maybe_pad_tokens(xseq: torch.Tensor) -> Tuple[torch.Tensor, Optional[int]]:
    """Pad a (B, N, D) token grid ONCE with zero rows to a multiple of
    :data:`PAD_MULTIPLE`. Returns ``(xseq, valid_len)``, with
    ``valid_len=None`` when no padding was needed."""
    n = xseq.shape[1]
    n_pad = -(-n // PAD_MULTIPLE) * PAD_MULTIPLE
    if n_pad == n:
        return xseq, None
    return F.pad(xseq, (0, 0, 0, n_pad - n)), n


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                    valid_len: Optional[int] = None) -> torch.Tensor:
    """Masked softmax attention in the (B, H, N, dh) layout, scores and
    softmax in f32 (counterpart of ``xla_attention``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if valid_len is not None and valid_len < k.shape[2]:
        s = s.masked_fill(torch.arange(k.shape[2], device=k.device) >= valid_len, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


# ---------------------------------------------------------------------------
# flash_attention_packed: plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, sm_scale: float, n_valid: int):
    """f32 q k^T * scale of one head, keys at or past ``n_valid`` masked."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if sm_scale != 1.0:
        s = s * sm_scale
    n = k.shape[1]
    if n_valid < n:
        s = s.masked_fill(torch.arange(n, device=k.device) >= n_valid, MASK_VALUE)
    return s


def flash_packed_fwd_plain(q, k, v, num_heads: int, sm_scale: float, n_valid: int,
                           need_lse: bool = False):
    """Plain version of :func:`flash_packed_fwd`, the arithmetic of the TPU
    kernel ``_packed_fwd_kernel``: per head s = q k^T * scale in f32, keys
    ``>= n_valid`` set to ``MASK_VALUE``, m = rowmax, p = exp(s - m)
    unnormalised, l = rowsum(p) in f32, o = (p rounded to q's dtype) v
    accumulated in f32, divided by l, rounded once. Returns ``(o, lse)``:
    o (B, N, H*dh) in q's dtype; with ``need_lse`` the per-head log-sum-exp
    m + log(l) of the scaled, masked scores, (B, H, N) f32, else None."""
    dh = q.shape[-1] // num_heads
    dt = q.dtype
    outs, lses = [], []
    for h in range(num_heads):
        sl = slice(h * dh, (h + 1) * dh)
        s = _scores(q[..., sl], k[..., sl], sm_scale, n_valid)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(dt).float(), v[..., sl].float())
        outs.append((o / l).to(dt))
        lses.append((m + torch.log(l))[..., 0])
    o = torch.cat(outs, dim=-1)
    return o, (torch.stack(lses, dim=1) if need_lse else None)


def attention_bwd_heads(q, k, v, o, do, lse, num_heads: int, sm_scale: float, n_valid: int):
    """Per head ``(sl, dq, dk, dv)`` of masked attention, the arithmetic of
    ``_packed_bwd_kernel`` with P taken from the forward's log-sum-exp:
    P = exp(s - lse) in f32 (= exp(s - m) / l; masked keys 0),
    di = rowsum(f32(o) f32(do)), dP = do v^T in f32,
    dS = P (dP - di) * scale; dq = bf16(dS) k rounded to q's dtype;
    dk = bf16(dS)^T q and dv = bf16(P)^T do left in f32 (where the JAX
    kernels sum them across query blocks)."""
    dh = q.shape[-1] // num_heads
    dt = q.dtype
    for h in range(num_heads):
        sl = slice(h * dh, (h + 1) * dh)
        qh, kh, vh, doh = (t[..., sl].float() for t in (q, k, v, do))
        s = _scores(q[..., sl], k[..., sl], sm_scale, n_valid)
        p = torch.exp(s - lse[:, h, :, None])  # masked keys: exp(-1e30 - lse) = 0
        di = (o[..., sl].float() * doh).sum(dim=-1, keepdim=True)
        ds = p * (torch.matmul(doh, vh.transpose(1, 2)) - di) * sm_scale
        dsb, pb = ds.to(dt).float(), p.to(dt).float()
        dq = torch.matmul(dsb, kh).to(dt)
        dk = torch.matmul(dsb.transpose(1, 2), qh)
        dv = torch.matmul(pb.transpose(1, 2), doh)
        yield sl, dq, dk, dv


def flash_packed_bwd_plain(q, k, v, o, do, lse, num_heads: int, sm_scale: float,
                           n_valid: int):
    """Plain version of :func:`flash_packed_bwd`: ``(dq, dk, dv)``, each
    (B, N, H*dh) in q's dtype, by :func:`attention_bwd_heads`."""
    dq, dk, dv = (torch.empty(o.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    for sl, gq, gk, gv in attention_bwd_heads(q, k, v, o, do, lse, num_heads, sm_scale,
                                              n_valid):
        dq[..., sl], dk[..., sl], dv[..., sl] = gq, gk.to(q.dtype), gv.to(q.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# flash_attention_packed: kernels
# ---------------------------------------------------------------------------


def _row_stride(name: str, t: torch.Tensor, b: int, n: int, d: int, device) -> int:
    """The row stride of a (B, N, D) bf16 or f32 view whose rows are
    contiguous and 16-byte aligned, rows ``stride`` elements apart (16 bytes
    a multiple: 8 bf16 or 4 f32 elements) and images ``N * stride`` apart (a
    third of a packed qkv tensor, or a contiguous one)."""
    if tuple(t.shape) != (b, n, d) or t.device != device:
        raise ValueError(f"{name}: want shape {(b, n, d)} on {device}, "
                         f"got {tuple(t.shape)} on {t.device}")
    s0, s1, s2 = t.stride()
    if s2 != 1 or s1 < d or (s1 * t.element_size()) % 16 or (b > 1 and s0 != n * s1) \
            or t.data_ptr() % 16:
        raise NotImplementedError(
            f"flash_attention_packed kernel: {name} with strides {t.stride()} (want rows "
            "contiguous, 16-byte aligned, images N rows apart; ROADMAP B5)")
    return s1


def _flash_check(q, k, v, num_heads: int, n_valid: int):
    """``(b, n, d, suffix)`` of a kernel call: the dtype's suffix of the C
    function and launch count (:data:`FLASH_DTYPES`)."""
    b, n, d = q.shape
    dh = d // num_heads
    if q.dtype not in FLASH_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash_attention_packed kernel: q, k, v in {q.dtype}, {k.dtype}, {v.dtype} (built "
            "for bf16 and f32, all three alike; ROADMAP B.5)")
    if dh not in HEAD_WIDTHS or dh * num_heads != d:
        raise NotImplementedError(
            f"flash_attention_packed kernel: head width {d / num_heads:g} (built for "
            f"{HEAD_WIDTHS}; ROADMAP B.3)")
    if n % PAD_MULTIPLE:
        raise NotImplementedError(
            f"flash_attention_packed kernel: N={n} (built for N a multiple of {PAD_MULTIPLE}, "
            "which flash_attention_packed pads to; ROADMAP B5)")
    if not 1 <= n_valid <= n:
        raise ValueError(f"flash_attention_packed kernel: n_valid={n_valid} not in [1, {n}]")
    return b, n, d, FLASH_DTYPES[q.dtype]


def _flash_fwd_cuda(q, k, v, num_heads, sm_scale, n_valid, need_lse):
    b, n, d, suffix = _flash_check(q, k, v, num_heads, n_valid)
    dev = q.device
    strides = [_row_stride(nm, t, b, n, d, dev) for nm, t in (("q", q), ("k", k), ("v", v))]
    o = torch.empty((b, n, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=dev) if need_lse else None
    fn = kernels.function("flash_packed" + suffix)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, n, num_heads, d // num_heads,
                 *strides, int(n_valid), float(sm_scale),
                 torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("flash_packed_fwd" + suffix, err)
    LAUNCHES["flash_packed_fwd" + suffix] += 1
    return o, lse


def flash_packed_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                     sm_scale: float, n_valid: int, need_lse: bool = False):
    """``(o, lse)``: o = concat_h softmax(q_h k_h^T * scale) v_h over keys
    ``< n_valid``, (B, N, H*dh); the per-head log-sum-exp ``lse`` (B, H, N)
    f32 only with ``need_lse`` (the backward reads it), else None."""
    if _launches_kernel(q):
        return _flash_fwd_cuda(q, k, v, num_heads, sm_scale, n_valid, need_lse)
    return flash_packed_fwd_plain(q, k, v, num_heads, sm_scale, n_valid, need_lse)


def _flash_bwd_cuda(q, k, v, o, do, lse, num_heads, sm_scale, n_valid):
    b, n, d, suffix = _flash_check(q, k, v, num_heads, n_valid)
    dev, f32 = q.device, torch.float32
    strides = [_row_stride(nm, t, b, n, d, dev) for nm, t in (("q", q), ("k", k), ("v", v))]
    _check("o", o, q.dtype, (b, n, d), dev)
    _check("do", do, q.dtype, (b, n, d), dev)
    _check("lse", lse, f32, (b, num_heads, n), dev)
    if lse.data_ptr() % 16:  # the kernel copies lse rows in 16-byte units
        lse = lse.clone()
    # dq | dk | dv in one (B, N, 3D) buffer, as the qkv GEMM's backward reads it
    grads = torch.empty((b, n, 3 * d), dtype=q.dtype, device=dev)
    di = torch.empty((b, num_heads, n), dtype=f32, device=dev)
    fn = kernels.function("flash_packed_bwd" + suffix)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), grads.data_ptr(), di.data_ptr(), b, n, num_heads,
                 d // num_heads, *strides, int(n_valid), float(sm_scale),
                 torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("flash_packed_bwd" + suffix, err)
    LAUNCHES["flash_packed_bwd" + suffix] += 1
    return grads.split(d, dim=-1)


def flash_packed_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor, num_heads: int, sm_scale: float,
                     n_valid: int):
    """Gradients of :func:`flash_packed_fwd` given do, from the forward's
    ``o`` and ``lse``: ``(dq, dk, dv)`` as described at
    :func:`flash_packed_bwd_plain`. Key rows at or past ``n_valid`` get
    dk = dv = 0 exactly."""
    if _launches_kernel(q):
        return _flash_bwd_cuda(q, k, v, o, do, lse, num_heads, sm_scale, n_valid)
    return flash_packed_bwd_plain(q, k, v, o, do, lse, num_heads, sm_scale, n_valid)


class FlashPackedFn(torch.autograd.Function):
    """``q, k, v -> o``, the JAX custom VJP ``_flash_packed``: forward = the
    forward kernel with the log-sum-exp kept; backward = the backward
    kernel."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, sm_scale, n_valid):
        o, lse = flash_packed_fwd(q, k, v, num_heads, sm_scale, n_valid, need_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.plain = current_route_plain()
        ctx.cfg = (num_heads, sm_scale, n_valid)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with _route(ctx.plain):
            dq, dk, dv = flash_packed_bwd(q, k, v, o, do.contiguous(), lse, *ctx.cfg)
        return dq, dk, dv, None, None, None


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                           sm_scale: Optional[float] = None,
                           valid_len: Optional[int] = None) -> torch.Tensor:
    """Masked multi-head attention over lane-packed (B, N, H*dh) q, k, v;
    returns the same layout. Keys at or past ``valid_len`` are masked. The
    model pads its token grid once (:func:`maybe_pad_tokens`); any other N
    is padded here with zero rows to a multiple of :data:`PAD_MULTIPLE`,
    its keys masked, and the first N rows returned, as the JAX op does.
    Differentiable through :class:`FlashPackedFn` when a gradient is
    wanted."""
    b, n, d = q.shape
    if sm_scale is None:
        sm_scale = (d // num_heads) ** -0.5
    n_valid = n if valid_len is None else int(valid_len)
    n_pad = -(-n // PAD_MULTIPLE) * PAD_MULTIPLE
    if n_pad != n:
        pad = (0, 0, 0, n_pad - n)
        return flash_attention_packed(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), num_heads,
                                      sm_scale, n_valid)[:, :n]
    if _wants_grad(q, k, v):
        return FlashPackedFn.apply(q, k, v, num_heads, float(sm_scale), n_valid)
    return flash_packed_fwd(q, k, v, num_heads, float(sm_scale), n_valid)[0]
