"""Fused transformer-block ops with their backward passes (counterpart of the
JAX package's ``ops/fused_block.py``).

- :func:`attend_project` — the qkv projection, masked multi-head attention,
  the output projection, its bias and the residual. Forward kernel
  ``csrc/attend_project.cu`` (replaces the TPU kernel ``_ap_fwd_kernel``),
  backward kernel ``csrc/attend_project_bwd.cu`` (replaces ``_ap_bwd_kernel``).
- :func:`ln_mlp` — LayerNorm, fc1, tanh-GELU, fc2, bias and the residual.
  Forward kernel ``csrc/ln_mlp.cu`` (replaces ``_ln_mlp_fwd_kernel``),
  backward kernel ``csrc/ln_mlp_bwd.cu`` (replaces ``_ln_mlp_bwd_kernel``).
  With ``quantized=True`` (``model.quantization = "int8"``) the int8 forward
  kernel ``csrc/ln_mlp_q.cu`` (replaces ``_ln_mlp_q_fwd_kernel``) and
  backward kernel ``csrc/ln_mlp_q_bwd.cu`` (replaces
  ``_ln_mlp_q_bwd_kernel``), from the int8 weight copies of
  :func:`quantize_mlp_weights`.

Each kernel has a dispatching wrapper and a plain PyTorch version of the same
arithmetic, kept in this module, with the TPU kernel's bf16 cast points (the
plain version computes in f32 when given f32 inputs). On a CPU tensor a
wrapper runs the plain version. On a CUDA tensor it launches the kernel or
raises; it never falls back. :func:`plain_versions` routes CUDA tensors to
the plain versions on explicit request, for holding a kernel against its
plain version on the card.

When a gradient is wanted, :func:`attend_project` and :func:`ln_mlp` run as
``torch.autograd.Function``\\ s that mirror the JAX custom VJPs
(``_apa`` and ``ln_mlp``): the forward keeps what the backward kernel reads,
the backward kernel returns the gradients, and each gradient comes back in
its input's dtype.

Weights are in ``nn.Linear`` layout (out_features, in_features), the layout
the port's modules hold; the JAX functions take the transpose.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels
from .attention import HEAD_WIDTHS, PAD_MULTIPLE, attention_bwd_heads, flash_packed_fwd_plain
# the launch counts and the route switch are shared with ops/attention.py;
# re-exported here, where the model's callers and tests import them from
from .dispatch import (  # noqa: F401
    LAUNCHES,
    _check,
    _check_launch,
    _launches_kernel,
    _route,
    _wants_grad,
    current_route_plain,
    plain_versions,
    reset_launches,
)

_EPS = 1e-6
# tanh-GELU constants (torch approximate="tanh")
_C0 = 0.7978845608028654  # sqrt(2/pi)
_C1 = 0.044715


def _ap_wgrad_splits(rows: int, d_out: int, d: int, device: torch.device) -> int:
    """Row splits of B2's dWp GEMM (``csrc/attend_project_bwd.cu``: 128 x 128
    output tiles, one block per SM): two whole waves on an H100. The count
    depends only on the shapes and the card, so the summation order is the
    same from run to run."""
    tiles = -(-d_out // 128) * -(-d // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-rows // 64), 2 * sms // tiles))


def _ln_mlp_wgrad_splits(rows: int, d: int, hid: int, device: torch.device) -> int:
    """Row splits of B4's and B8's weight-gradient GEMMs
    (``csrc/ln_mlp_wgrad.cuh``: dW2 and dW1 in one launch of 128 x 192
    output tiles, one block per SM):
    whole waves, four of them on an H100. The count depends only on the
    shapes and the card, so the summation order is the same from run to
    run."""
    tiles = 2 * (d // 128) * (hid // 192)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-rows // 64), 4 * sms // tiles))


def _gelu_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    inner = _C0 * (x + _C1 * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(inner))


def _dgelu_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    inner = _C0 * (x + _C1 * x * x * x)
    t = torch.tanh(inner)
    dinner = _C0 * (1.0 + 3.0 * _C1 * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * dinner


def _ln_f32(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """LayerNorm in f32 with a two-pass mean and variance (eps 1e-6):
    ``(y, xhat, rstd)``."""
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + _EPS)
    xhat = xc * rstd
    return xhat * scale.float() + bias.float(), xhat, rstd


def _ln_bwd_f32(dy, xhat, rstd, scale):
    """dx of y = xhat * scale + bias given dy (all f32)."""
    dxhat = dy * scale
    h1 = dxhat.mean(dim=-1, keepdim=True)
    h2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dxhat - h1 - xhat * h2)


def project(y: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """The wide qkv GEMM ``y @ [Wq|Wk|Wv]^T + b``: a plain matrix product
    outside any kernel (the JAX package leaves it to XLA). The GEMM accumulates
    in f32 and adds the bias in its epilogue before rounding to y's dtype."""
    return F.linear(y, w, b)


# ---------------------------------------------------------------------------
# attend_project
# ---------------------------------------------------------------------------


def attend_project_fwd_plain(qkv, x_res, wp, bp, num_heads: int, sm_scale: float,
                             n_valid: int, need_o: bool = False):
    """Plain version of :func:`attend_project_fwd`: the attention of
    :func:`~.attention.flash_packed_fwd_plain` on the thirds of qkv (P
    rounded to qkv's dtype before the product, (P v) / l rounded); then
    o Wp^T + bp (+ x_res) in f32, rounded once. With ``need_o`` also o and
    the per-head log-sum-exp of the scaled, masked scores, (B, H, N) f32."""
    d = qkv.shape[-1] // 3
    o, lse = flash_packed_fwd_plain(*qkv.split(d, dim=-1), num_heads, sm_scale, n_valid,
                                    need_lse=need_o)
    xo = torch.matmul(o.float(), wp.float().t()) + bp.float()
    if x_res is not None:
        xo = xo + x_res.float()
    if not need_o:
        return None, None, xo.to(qkv.dtype)
    return o, lse, xo.to(qkv.dtype)


def _attend_project_check(qkv, wp, num_heads, n_valid, name):
    b, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    d_out = wp.shape[0]
    if dh not in HEAD_WIDTHS:
        raise NotImplementedError(
            f"{name} kernel: head width {dh} (built for {HEAD_WIDTHS}; ROADMAP B1/B2)"
        )
    if n % PAD_MULTIPLE or d_out % 64 or not 1 <= n_valid <= n:
        raise ValueError(f"{name} kernel: N={n} and D_out={d_out} must be multiples "
                         f"of 64 and 1 <= n_valid={n_valid} <= N")
    return b, n, d, dh, d_out


def _attend_project_fwd_cuda(qkv, x_res, wp, bp, num_heads, sm_scale, n_valid, need_o):
    b, n, d, dh, d_out = _attend_project_check(qkv, wp, num_heads, n_valid, "attend_project")
    dev, bf16 = qkv.device, torch.bfloat16
    _check("qkv", qkv, bf16, (b, n, 3 * d), dev)
    _check("wp", wp, bf16, (d_out, d), dev)
    _check("bp", bp, bf16, (d_out,), dev)
    if x_res is not None:
        _check("x_res", x_res, bf16, (b, n, d_out), dev)
    xo = torch.empty((b, n, d_out), dtype=bf16, device=dev)
    o = lse = None
    if need_o:
        o = torch.empty((b, n, d), dtype=bf16, device=dev)
        lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=dev)
    fn = kernels.function("attend_project")
    with torch.cuda.device(dev):
        err = fn(qkv.data_ptr(), None if x_res is None else x_res.data_ptr(), wp.data_ptr(),
                 bp.data_ptr(), None if o is None else o.data_ptr(),
                 None if lse is None else lse.data_ptr(), xo.data_ptr(),
                 b, n, num_heads, dh, d_out, int(n_valid), float(sm_scale),
                 torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("attend_project_fwd", err)
    LAUNCHES["attend_project_fwd"] += 1
    return o, lse, xo


def attend_project_fwd(qkv: torch.Tensor, x_res: Optional[torch.Tensor], wp: torch.Tensor,
                       bp: torch.Tensor, num_heads: int, sm_scale: float, n_valid: int,
                       need_o: bool = False):
    """``(o, lse, xo)``: o = concat_h softmax(q_h k_h^T * scale) v_h over keys
    ``< n_valid``, xo = o Wp^T + bp (+ x_res). ``qkv`` is (B, N, 3D) packed
    [q | k | v]; ``wp`` is (D_out, D). ``o`` and the per-head log-sum-exp
    ``lse`` (B, H, N) f32 are only produced with ``need_o`` (the backward
    needs them; serving does not), else both are None."""
    if _launches_kernel(qkv):
        return _attend_project_fwd_cuda(qkv, x_res, wp, bp, num_heads, sm_scale, n_valid, need_o)
    return attend_project_fwd_plain(qkv, x_res, wp, bp, num_heads, sm_scale, n_valid, need_o)


def attend_project_bwd_plain(qkv, o, lse, wp, dxo, num_heads: int, sm_scale: float,
                             n_valid: int):
    """Plain version of :func:`attend_project_bwd`, the arithmetic of the TPU
    kernel ``_ap_bwd_kernel`` plus the per-batch sums of ``_ap_bwd_impl``:
    do = dxo Wp rounded to qkv's dtype; then per head the attention backward
    of :func:`~.attention.attention_bwd_heads` (P = exp(s * scale - lse),
    masked keys 0; P and dS rounded before their products; every accumulator
    f32). Returns ``(dqkv, dwp, dbp, db_qkv)``: dqkv (B, N, 3D) packed
    [dq | dk | dv] in qkv's dtype, dwp (D_out, D), dbp (D_out,) and db_qkv
    (3D,) in f32 (the q bias sums the rounded dq, the k and v biases the f32
    dk and dv, as the TPU kernel does)."""
    d = qkv.shape[-1] // 3
    dt, f32 = qkv.dtype, torch.float32
    dxf = dxo.float()
    rows = dxf.reshape(-1, dxf.shape[-1])
    dwp = torch.matmul(rows.t(), o.reshape(-1, d).float())
    dbp = rows.sum(dim=0)
    do = torch.matmul(dxf, wp.float()).to(dt)
    dqkv = torch.empty_like(qkv)
    db = torch.empty(3 * d, dtype=f32, device=qkv.device)
    for sl, *gs in attention_bwd_heads(*qkv.split(d, dim=-1), o, do, lse, num_heads, sm_scale,
                                       n_valid):
        for j, g in enumerate(gs):
            cols = slice(j * d + sl.start, j * d + sl.stop)
            dqkv[..., cols] = g.to(dt)
            db[cols] = g.float().sum(dim=(0, 1))
    return dqkv, dwp, dbp, db


def _attend_project_bwd_cuda(qkv, o, lse, wp, dxo, num_heads, sm_scale, n_valid):
    b, n, d, dh, d_out = _attend_project_check(qkv, wp, num_heads, n_valid, "attend_project_bwd")
    dev, bf16, f32 = qkv.device, torch.bfloat16, torch.float32
    _check("qkv", qkv, bf16, (b, n, 3 * d), dev)
    _check("o", o, bf16, (b, n, d), dev)
    _check("lse", lse, f32, (b, num_heads, n), dev)
    _check("wp", wp, bf16, (d_out, d), dev)
    _check("dxo", dxo, bf16, (b, n, d_out), dev)
    splits = _ap_wgrad_splits(b * n, d_out, d, dev)
    dqkv = torch.empty_like(qkv)
    dwp = torch.empty((d_out, d), dtype=f32, device=dev)
    bias = torch.empty(d_out + 3 * d, dtype=f32, device=dev)
    do_buf = torch.empty((b, n, d), dtype=bf16, device=dev)
    di = torch.empty((b, num_heads, n), dtype=f32, device=dev)
    bias_part = torch.empty((b * n // 64, d_out + 3 * d), dtype=f32, device=dev)
    wgrad_part = torch.empty((splits, d_out, d), dtype=f32, device=dev)
    fn = kernels.function("attend_project_bwd")
    with torch.cuda.device(dev):
        err = fn(qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), wp.data_ptr(), dxo.data_ptr(),
                 dqkv.data_ptr(), dwp.data_ptr(), bias.data_ptr(), do_buf.data_ptr(),
                 di.data_ptr(), bias_part.data_ptr(), wgrad_part.data_ptr(),
                 b, n, num_heads, dh, d_out, int(n_valid), float(sm_scale), splits,
                 torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("attend_project_bwd", err)
    LAUNCHES["attend_project_bwd"] += 1
    return dqkv, dwp, bias[:d_out], bias[d_out:]


def attend_project_bwd(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, wp: torch.Tensor,
                       dxo: torch.Tensor, num_heads: int, sm_scale: float, n_valid: int):
    """Gradients of :func:`attend_project_fwd` given dxo, from the forward's
    ``qkv``, ``o`` and ``lse``: ``(dqkv, dwp, dbp, db_qkv)`` as described at
    :func:`attend_project_bwd_plain`. Key rows at or past ``n_valid`` get
    dk = dv = 0 exactly."""
    if _launches_kernel(qkv):
        return _attend_project_bwd_cuda(qkv, o, lse, wp, dxo, num_heads, sm_scale, n_valid)
    return attend_project_bwd_plain(qkv, o, lse, wp, dxo, num_heads, sm_scale, n_valid)


class AttendProjectFn(torch.autograd.Function):
    """``y, w_qkv, b_qkv, wp, bp, x_res -> xo``, the JAX custom VJP ``_apa``:
    forward = the qkv GEMM and the forward kernel with ``o`` and ``lse`` kept;
    backward = the backward kernel, then the two plain GEMMs
    dy = dqkv W_qkv and dW_qkv = dqkv^T y (left to XLA in the JAX package),
    and dx_res = dxo."""

    @staticmethod
    def forward(ctx, y, w_qkv, b_qkv, wp, bp, x_res, num_heads, sm_scale, n_valid):
        qkv = project(y, w_qkv, b_qkv)
        o, lse, xo = attend_project_fwd(qkv, x_res, wp, bp, num_heads, sm_scale, n_valid,
                                        need_o=True)
        ctx.save_for_backward(y, w_qkv, wp, qkv, o, lse)
        ctx.plain = current_route_plain()
        ctx.cfg = (num_heads, sm_scale, n_valid)
        ctx.b_dtype = None if b_qkv is None else b_qkv.dtype
        ctx.bp_dtype = bp.dtype
        ctx.has_res = x_res is not None
        return xo

    @staticmethod
    def backward(ctx, dxo):
        y, w, wp, qkv, o, lse = ctx.saved_tensors
        with _route(ctx.plain):
            dqkv, dwp, dbp, db = attend_project_bwd(qkv, o, lse, wp, dxo.contiguous(), *ctx.cfg)
        d3 = dqkv.shape[-1]
        dy = torch.matmul(dqkv, w)
        dw = torch.matmul(dqkv.reshape(-1, d3).t(), y.reshape(-1, y.shape[-1]))
        return (dy.to(y.dtype), dw.to(w.dtype),
                None if ctx.b_dtype is None else db.to(ctx.b_dtype),
                dwp.to(wp.dtype), dbp.to(ctx.bp_dtype), dxo if ctx.has_res else None,
                None, None, None)


def attend_project(y: torch.Tensor, w_qkv: torch.Tensor, b_qkv: Optional[torch.Tensor],
                   w_proj: torch.Tensor, b_proj: torch.Tensor, x_res: Optional[torch.Tensor],
                   num_heads: int, sm_scale: Optional[float] = None,
                   valid_len: Optional[int] = None) -> torch.Tensor:
    """[x_res +] proj(attention(split(y @ w_qkv^T + b_qkv))). The model pads
    its token grid once (``maybe_pad_tokens``); any other N is padded here
    with zero rows to a multiple of :data:`PAD_MULTIPLE`, its keys masked,
    and the first N rows returned, as the JAX op does. Differentiable through
    :class:`AttendProjectFn` when a gradient is wanted."""
    b, n, d = y.shape
    if sm_scale is None:
        sm_scale = (d // num_heads) ** -0.5
    n_valid = n if valid_len is None else int(valid_len)
    n_pad = -(-n // PAD_MULTIPLE) * PAD_MULTIPLE
    if n_pad != n:
        pad = (0, 0, 0, n_pad - n)
        return attend_project(F.pad(y, pad), w_qkv, b_qkv, w_proj, b_proj,
                              None if x_res is None else F.pad(x_res, pad), num_heads,
                              sm_scale, n_valid)[:, :n]
    if _wants_grad(y, w_qkv, b_qkv, w_proj, b_proj, x_res):
        return AttendProjectFn.apply(y, w_qkv, b_qkv, w_proj, b_proj, x_res, num_heads,
                                     float(sm_scale), n_valid)
    qkv = project(y, w_qkv, b_qkv)
    return attend_project_fwd(qkv, x_res, w_proj, b_proj, num_heads, float(sm_scale),
                              n_valid)[2]


# ---------------------------------------------------------------------------
# ln_mlp
# ---------------------------------------------------------------------------


def ln_mlp_plain(x, scale, bias, w1, b1, w2, b2, residual: bool = False) -> torch.Tensor:
    """Plain version of the :func:`ln_mlp` forward: LayerNorm in f32
    (two-pass mean and variance, eps 1e-6) rounded to w1's dtype;
    h = GELU_tanh(y W1^T + b1) in f32 rounded to w2's dtype;
    h W2^T + b2 (+ x) in f32, rounded once."""
    f32 = torch.float32
    xf = x.to(f32)
    y = _ln_f32(xf, scale, bias)[0].to(w1.dtype)
    h = torch.matmul(y.to(f32), w1.to(f32).t()) + b1.to(f32)
    h = _gelu_tanh_f32(h).to(w2.dtype)
    out = torch.matmul(h.to(f32), w2.to(f32).t()) + b2.to(f32)
    if residual:
        out = out + xf
    return out.to(x.dtype)


# the model widths each MLP kernel is built for: B3 and B4 (``csrc/ln_mlp.cu``,
# ``csrc/ln_mlp_bwd.cu``), and the int8 B7 and B8 (``csrc/ln_mlp_q.cu``,
# ``csrc/ln_mlp_q_bwd.cu``); at 768 each runs a cluster of two blocks per 64
# rows (B4's and B8's dy launch)
LN_MLP_WIDTHS = (384, 768)
LN_MLP_Q_WIDTHS = (384, 768)


def _ln_mlp_check(x, w1, name, multiple=64, widths=LN_MLP_WIDTHS, kernels_of="B3/B4"):
    d = x.shape[-1]
    hid = w1.shape[0]
    if d not in widths:
        raise NotImplementedError(
            f"{name} kernel: width {d} (built for {widths}; ROADMAP B2, {kernels_of})")
    if hid % multiple or hid == 0:
        raise ValueError(f"{name} kernel: hidden width {hid} must be a multiple of {multiple}")
    return d, hid


def _ln_mlp_fwd_cuda(x, scale, bias, w1, b1, w2, b2, residual):
    d, hid = _ln_mlp_check(x, w1, "ln_mlp")
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, bf16, x.shape, dev)
    _check("ln_scale", scale, f32, (d,), dev)
    _check("ln_bias", bias, f32, (d,), dev)
    _check("w1", w1, bf16, (hid, d), dev)
    _check("b1", b1, bf16, (hid,), dev)
    _check("w2", w2, bf16, (d, hid), dev)
    _check("b2", b2, bf16, (d,), dev)
    out = torch.empty_like(x)
    fn = kernels.function("ln_mlp")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 w2.data_ptr(), b2.data_ptr(), out.data_ptr(), x.numel() // d, d, hid,
                 int(bool(residual)), torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("ln_mlp_fwd", err)
    LAUNCHES["ln_mlp_fwd"] += 1
    return out


def ln_mlp_fwd(x, scale, bias, w1, b1, w2, b2, residual: bool = False) -> torch.Tensor:
    """The :func:`ln_mlp` forward without autograd: the kernel for a CUDA
    tensor, the plain version for a CPU one."""
    if _launches_kernel(x):
        return _ln_mlp_fwd_cuda(x, scale, bias, w1, b1, w2, b2, residual)
    return ln_mlp_plain(x, scale, bias, w1, b1, w2, b2, residual)


def ln_mlp_bwd_plain(x, scale, bias, w1, b1, w2, do, residual: bool = False):
    """Plain version of :func:`ln_mlp_bwd`, the arithmetic of the TPU kernel
    ``_ln_mlp_bwd_kernel``: LN, fc1 and GELU recomputed; h and dh_pre rounded
    to w1's dtype before their products; every accumulator f32; dx by the
    LayerNorm backward (+ do with the residual). Returns
    ``(dx, dw1, db1, dw2, db2, ds, db)``: dx in x's dtype, the rest f32, dw1
    (HID, D) and dw2 (D, HID) in ``nn.Linear`` layout."""
    f32 = torch.float32
    d = x.shape[-1]
    xf = x.to(f32).reshape(-1, d)
    y, xhat, rstd = _ln_f32(xf, scale, bias)
    yb = y.to(w1.dtype).to(f32)
    h_pre = torch.matmul(yb, w1.to(f32).t()) + b1.to(f32)
    h = _gelu_tanh_f32(h_pre).to(w1.dtype).to(f32)
    dof = do.to(f32).reshape(-1, d)
    dw2 = torch.matmul(dof.t(), h)
    db2 = dof.sum(dim=0)
    dh_pre = torch.matmul(dof, w2.to(f32)) * _dgelu_tanh_f32(h_pre)
    dh_pre_b = dh_pre.to(w1.dtype).to(f32)
    dw1 = torch.matmul(dh_pre_b.t(), yb)
    db1 = dh_pre.sum(dim=0)
    dy = torch.matmul(dh_pre_b, w1.to(f32))
    ds = (dy * xhat).sum(dim=0)
    db = dy.sum(dim=0)
    dx = _ln_bwd_f32(dy, xhat, rstd, scale.to(f32))
    if residual:
        dx = dx + dof
    return dx.reshape(x.shape).to(x.dtype), dw1, db1, dw2, db2, ds, db


def _ln_mlp_bwd_cuda(x, scale, bias, w1, b1, w2, do, residual):
    d, hid = _ln_mlp_check(x, w1, "ln_mlp_bwd", multiple=384)
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, bf16, x.shape, dev)
    _check("ln_scale", scale, f32, (d,), dev)
    _check("ln_bias", bias, f32, (d,), dev)
    _check("w1", w1, bf16, (hid, d), dev)
    _check("b1", b1, bf16, (hid,), dev)
    _check("w2", w2, bf16, (d, hid), dev)
    _check("do", do, bf16, x.shape, dev)
    m = x.numel() // d
    splits = _ln_mlp_wgrad_splits(m, d, hid, dev)
    dx = torch.empty_like(x)
    dw = torch.empty(2 * d * hid, dtype=f32, device=dev)  # [dW2 | dW1]
    dw2, dw1 = dw[:d * hid].view(d, hid), dw[d * hid:].view(hid, d)
    bias_out = torch.empty(hid + 3 * d, dtype=f32, device=dev)
    y_buf = torch.empty((m, d), dtype=bf16, device=dev)
    stats = torch.empty((m, 2), dtype=f32, device=dev)
    h_buf = torch.empty((m, hid), dtype=bf16, device=dev)
    dhp_buf = torch.empty((m, hid), dtype=bf16, device=dev)
    db1_part = torch.empty((-(-m // 128), hid), dtype=f32, device=dev)
    ln_part = torch.empty((-(-m // 64), 3 * d), dtype=f32, device=dev)
    wgrad_part = torch.empty((splits, 2, d, hid), dtype=f32, device=dev)
    fn = kernels.function("ln_mlp_bwd")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 w2.data_ptr(), do.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                 bias_out.data_ptr(), y_buf.data_ptr(), stats.data_ptr(), h_buf.data_ptr(),
                 dhp_buf.data_ptr(), db1_part.data_ptr(), ln_part.data_ptr(),
                 wgrad_part.data_ptr(), m, d, hid, int(bool(residual)), splits,
                 torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("ln_mlp_bwd", err)
    LAUNCHES["ln_mlp_bwd"] += 1
    db1, db2, ds, db = bias_out.split((hid, d, d, d))
    return dx, dw1, db1, dw2, db2, ds, db


def ln_mlp_bwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, w1: torch.Tensor,
               b1: torch.Tensor, w2: torch.Tensor, do: torch.Tensor, residual: bool = False):
    """Gradients of :func:`ln_mlp` given do: ``(dx, dw1, db1, dw2, db2, ds,
    db)`` as described at :func:`ln_mlp_bwd_plain`."""
    if _launches_kernel(x):
        return _ln_mlp_bwd_cuda(x, scale, bias, w1, b1, w2, do, residual)
    return ln_mlp_bwd_plain(x, scale, bias, w1, b1, w2, do, residual)


class LnMlpFn(torch.autograd.Function):
    """``x, scale, bias, w1, b1, w2, b2 -> out``, the JAX custom VJP of
    ``ln_mlp`` (``quantized`` is its second non-differentiable argument):
    all seven gradients come from the backward kernel. With ``quantized``
    the weights are quantised from the given (compute-dtype) copies at every
    call, forward and backward, as the JAX implementations do, so an
    optimizer step is always seen."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, residual, quantized):
        if quantized:
            w1q, s1c, w2q, s2c = quantize_mlp_weights(w1, w2)
            out = ln_mlp_q_fwd(x, scale, bias, w1q, s1c, b1, w2q, s2c, b2, residual)
        else:
            out = ln_mlp_fwd(x, scale, bias, w1, b1, w2, b2, residual)
        ctx.save_for_backward(x, scale, bias, w1, b1, w2)
        ctx.plain = current_route_plain()
        ctx.residual = residual
        ctx.quantized = quantized
        ctx.b2_dtype = b2.dtype
        return out

    @staticmethod
    def backward(ctx, do):
        x, scale, bias, w1, b1, w2 = ctx.saved_tensors
        with _route(ctx.plain):
            if ctx.quantized:
                w1q, s1c, w2q, s2c, w1r, s1r, w2r, s2r = quantize_mlp_weights(
                    w1, w2, backward=True)
                grads = ln_mlp_q_bwd(x, scale, bias, w1q, s1c, b1, w1r, s1r, w2r, s2r,
                                     do.contiguous(), ctx.residual)
            else:
                grads = ln_mlp_bwd(x, scale, bias, w1, b1, w2, do.contiguous(), ctx.residual)
        dx, dw1, db1, dw2, db2, ds, db = grads
        return (dx, ds.to(scale.dtype), db.to(bias.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(ctx.b2_dtype), None, None)


def ln_mlp(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, w1: torch.Tensor,
           b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
           residual: bool = False, quantized: bool = False) -> torch.Tensor:
    """fc2(tanh-GELU(fc1(LayerNorm(x)))) [+ x] over the last axis of x.
    ``scale``/``bias`` are the LayerNorm's (f32 on the kernel path); ``w1``
    is (hidden, D) and ``w2`` (D, hidden). ``quantized`` runs both GEMMs in
    int8 (:func:`ln_mlp_q_fwd`, the weights quantised from the given copies);
    the backward then quantises the fc1 recompute and both dgrad GEMMs, and
    the weight gradients stay bf16. Differentiable through :class:`LnMlpFn`
    when a gradient is wanted."""
    if _wants_grad(x, scale, bias, w1, b1, w2, b2):
        return LnMlpFn.apply(x, scale, bias, w1, b1, w2, b2, residual, quantized)
    if quantized:
        w1q, s1c, w2q, s2c = quantize_mlp_weights(w1, w2)
        return ln_mlp_q_fwd(x, scale, bias, w1q, s1c, b1, w2q, s2c, b2, residual)
    return ln_mlp_fwd(x, scale, bias, w1, b1, w2, b2, residual)


# ---------------------------------------------------------------------------
# int8 ln_mlp (``model.quantization = "int8"``)
# ---------------------------------------------------------------------------
#
# The arithmetic of the TPU kernels ``_ln_mlp_q_fwd_kernel`` and
# ``_ln_mlp_q_bwd_kernel``: activations are quantised per row with a dynamic
# scale, weights per output (forward) or input (backward dgrads) unit with a
# static one, both symmetric to [-127, 127] with round-half-even; products
# are int8 x int8 summed exactly in int32, then dequantised in f32. The JAX
# package quantises the compute-dtype (bf16) cast of the f32 weights; so do
# the callers here.

QUANTIZATION_MODES = ("none", "int8")

_QUANT = threading.local()  # .mode: this thread's override of the models' own setting


def check_quantization(mode: str) -> str:
    if mode not in QUANTIZATION_MODES:
        raise ValueError(f"unknown quantization mode: {mode!r}")
    return mode


@contextlib.contextmanager
def quantization(mode: str):
    """Run this thread's model forwards with quantisation ``mode``
    (``"none"`` or ``"int8"``) in place of each model's own setting, which
    stays as it is (the JAX ``ServingEngine`` scopes its mode to its own
    compiles the same way). A serving engine enters it around each of its
    forwards, in whichever thread runs them."""
    check_quantization(mode)
    prev = getattr(_QUANT, "mode", None)
    _QUANT.mode = mode
    try:
        yield
    finally:
        _QUANT.mode = prev


def quantization_override() -> Optional[str]:
    """The mode of an enclosing :func:`quantization` block in this thread,
    else None."""
    return getattr(_QUANT, "mode", None)


def quant_rows_f32(x: torch.Tensor):
    """Per-row symmetric int8 quantisation of f32 values (JAX
    ``_quant_rows_f32``): ``(codes, scale)`` with scale = max(max|x| / 127,
    1e-8) over the last axis (kept, size 1) and codes round-half-even(x /
    scale) by true division."""
    s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    return torch.round(x / s).to(torch.int8), s


def quantize_weight(w: torch.Tensor, dim: int):
    """Static symmetric int8 quantisation of ``w`` reduced over ``dim`` (JAX
    ``quantize_weight``; the floor is 1e-12): ``(codes in w's layout, scale
    with dim removed)``. For a weight in ``nn.Linear`` layout (out, in),
    ``dim=1`` gives a scale per output unit (JAX axis 0 of the transposed
    weight) and ``dim=0`` one per input unit (JAX axis 1)."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(dim=dim, keepdim=True) / 127.0, 1e-12)
    return torch.round(wf / s).to(torch.int8), s.squeeze(dim)


def quantize_mlp_weights(w1: torch.Tensor, w2: torch.Tensor, backward: bool = False):
    """The int8 copies of the MLP weights (``nn.Linear`` layout: w1 (HID, D),
    w2 (D, HID)), each k-major in the layout its product reads:
    ``(w1q (HID, D), s1c (HID,), w2q (D, HID), s2c (D,))`` for the forward
    (a scale per output unit, JAX ``quantize_weight(w, 0)``), and with
    ``backward`` also ``w1r (D, HID), s1r (D,), w2r (HID, D), s2r (HID,)``
    for the dgrads (a scale per input unit, JAX ``quantize_weight(w, 1)``;
    both equal the JAX arrays, whose layout is the transpose of
    ``nn.Linear``'s)."""
    w1q, s1c = quantize_weight(w1, 1)
    w2q, s2c = quantize_weight(w2, 1)
    if not backward:
        return w1q, s1c, w2q, s2c
    w1r, s1r = quantize_weight(w1, 0)
    w2r, s2r = quantize_weight(w2, 0)
    return w1q, s1c, w2q, s2c, w1r.t().contiguous(), s1r, w2r.t().contiguous(), s2r


def _int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) int8 codes times b (N, K) int8 codes, summed exactly (every
    partial sum is an integer below 2^53 in f64, as in int32) and rounded to
    f32 once, as the int32 sum is."""
    return torch.matmul(a.double(), b.double().t()).float()


def ln_mlp_q_plain(x, scale, bias, w1q, s1c, b1, w2q, s2c, b2, residual: bool = False,
                   with_codes: bool = False, with_h: bool = False):
    """Plain version of :func:`ln_mlp_q_fwd`, the arithmetic of the TPU kernel
    ``_ln_mlp_q_fwd_kernel`` in its order: y = LayerNorm(x) in f32; y
    quantised per row; h_pre = (acc * ys) * s1c + b1; h = GELU_tanh(h_pre);
    h quantised per row; out = (acc2 * hs) * s2c + b2 (+ x) in f32, rounded to
    x's dtype once. With ``with_codes`` also returns h's codes (M, HID), and
    with ``with_h`` h rounded to bf16 (M, HID), in that order."""
    f32 = torch.float32
    d = x.shape[-1]
    xf = x.to(f32).reshape(-1, d)
    yq, ys = quant_rows_f32(_ln_f32(xf, scale, bias)[0])
    h = _gelu_tanh_f32(_int_product(yq, w1q) * ys * s1c + b1.to(f32))
    hq, hs = quant_rows_f32(h)
    out = _int_product(hq, w2q) * hs * s2c + b2.to(f32)
    if residual:
        out = out + xf
    out = out.reshape(x.shape).to(x.dtype)
    return _with_extras(out, with_codes, hq, with_h, h)


def _with_extras(out, with_codes, codes, with_h, h):
    """``out``, then the check outputs asked for: codes, then h in bf16."""
    extras = ((codes,) if with_codes else ()) + ((h.to(torch.bfloat16),) if with_h else ())
    if not extras:
        return out
    return (out if isinstance(out, tuple) else (out,)) + extras


def _ln_mlp_q_fwd_cuda(x, scale, bias, w1q, s1c, b1, w2q, s2c, b2, residual, with_codes,
                       with_h, launch_key: str = "ln_mlp_q_fwd"):
    """B7's launch; ``launch_key`` is the count it adds to (the benchmark
    script's S3 launches the same kernel under its own name). The hidden
    width is a multiple of 128 at D = 384 and of 256 at 768, where the two
    blocks of a pair take turns at its 128-unit slices."""
    d, hid = _ln_mlp_check(x, w1q, launch_key, multiple=128 * max(1, x.shape[-1] // 384),
                           widths=LN_MLP_Q_WIDTHS, kernels_of="B7/B8")
    dev, bf16, f32, i8 = x.device, torch.bfloat16, torch.float32, torch.int8
    _check("x", x, bf16, x.shape, dev)
    _check("ln_scale", scale, f32, (d,), dev)
    _check("ln_bias", bias, f32, (d,), dev)
    _check("w1q", w1q, i8, (hid, d), dev)
    _check("s1c", s1c, f32, (hid,), dev)
    _check("b1", b1, bf16, (hid,), dev)
    _check("w2q", w2q, i8, (d, hid), dev)
    _check("s2c", s2c, f32, (d,), dev)
    _check("b2", b2, bf16, (d,), dev)
    m = x.numel() // d
    out = torch.empty_like(x)
    codes = torch.empty((m, hid), dtype=i8, device=dev) if with_codes else None
    h = torch.empty((m, hid), dtype=bf16, device=dev) if with_h else None
    fn = kernels.function("ln_mlp_q")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1q.data_ptr(),
                 s1c.data_ptr(), b1.data_ptr(), w2q.data_ptr(), s2c.data_ptr(), b2.data_ptr(),
                 out.data_ptr(), None if codes is None else codes.data_ptr(),
                 None if h is None else h.data_ptr(), m, d, hid, int(bool(residual)),
                 torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(launch_key, err)
    LAUNCHES[launch_key] += 1
    return _with_extras(out, with_codes, codes, with_h, h)


def ln_mlp_q_fwd(x, scale, bias, w1q, s1c, b1, w2q, s2c, b2, residual: bool = False,
                 with_codes: bool = False, with_h: bool = False):
    """The int8 :func:`ln_mlp` forward without autograd, from the int8 weight
    copies of :func:`quantize_mlp_weights`: the kernel ``csrc/ln_mlp_q.cu``
    for a CUDA tensor, :func:`ln_mlp_q_plain` for a CPU one. ``with_codes``
    and ``with_h`` add the check outputs :func:`ln_mlp_q_plain` describes."""
    if _launches_kernel(x):
        return _ln_mlp_q_fwd_cuda(x, scale, bias, w1q, s1c, b1, w2q, s2c, b2, residual,
                                  with_codes, with_h)
    return ln_mlp_q_plain(x, scale, bias, w1q, s1c, b1, w2q, s2c, b2, residual, with_codes,
                          with_h)


def gelu_tanh_rn_table(lo: int, n: int, device) -> torch.Tensor:
    """GELU_tanh of the ``n`` float32 values whose bit patterns follow ``lo``
    (f32, (n,)), by B7's own ``gelu_tanh_rn`` (``csrc/int8.cuh``, from the
    ``ln_mlp_q`` library) on a CUDA ``device``. For checking, on every float,
    the two facts B7's first pass relies on: non-decreasing on [0, inf), and
    below 0 smaller in magnitude than at ``kGeluPosDominates`` (0.3). A check
    of the kernel's GELU only: raises ``ValueError`` for another device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"gelu_tanh_rn_table checks the kernel's GELU: needs a CUDA "
                         f"device, got {device}")
    out = torch.empty(n, dtype=torch.float32, device=device)
    fn = kernels.function("gelu_tanh_rn_table")
    with torch.cuda.device(device):
        err = fn(out.data_ptr(), lo, n, torch.cuda.current_stream(device).cuda_stream)
    _check_launch("gelu_tanh_rn_table", err)
    return out


def gelu_facts(device, chunk: int = 1 << 28) -> dict:
    """The two facts about GELU_tanh that B7's first pass relies on, measured
    on every finite float32 through :func:`gelu_tanh_rn_table`, ``chunk``
    values at a time: ``steps_down``, the neighbouring pairs of non-negative
    floats whose GELU decreases (must be 0); ``neg_max``, max|GELU| over the
    negative floats, and ``at_bound``, GELU(0.3) (``neg_max < at_bound``
    must hold); ``finite``, whether every value was finite."""
    n_finite = 0x7F800000  # bit patterns of the finite non-negative floats
    steps_down, neg_max, finite, last = 0, 0.0, True, None
    for lo in range(0, n_finite, chunk):
        n = min(chunk, n_finite - lo)
        g = gelu_tanh_rn_table(lo, n, device)
        finite &= bool(torch.isfinite(g).all())
        steps_down += int((g[1:] < g[:-1]).sum()) + int(last is not None and bool(g[0] < last))
        last = g[-1]
        neg = gelu_tanh_rn_table(0x80000000 + lo, n, device)
        finite &= bool(torch.isfinite(neg).all())
        neg_max = max(neg_max, neg.abs().max().item())
        del g, neg
    at_bound = gelu_tanh_rn_table(0x3E99999A, 1, device).item()  # 0.3f
    return {"steps_down": steps_down, "neg_max": neg_max, "at_bound": at_bound,
            "finite": finite}


def ln_mlp_q_bwd_plain(x, scale, bias, w1q, s1c, b1, w1r, s1r, w2r, s2r, do,
                       residual: bool = False, with_codes: bool = False,
                       with_h: bool = False):
    """Plain version of :func:`ln_mlp_q_bwd`, the arithmetic of the TPU kernel
    ``_ln_mlp_q_bwd_kernel`` in its order and with its cast points: the int8
    fc1 recompute of the forward; h rounded to bf16 for dW2 = do^T h; dh from
    the f32 do quantised per row and w2r; dh_pre = dh * GELU'(h_pre); dW1 =
    dh_pre^T y with both rounded to bf16; db1 the sum of the f32 dh_pre; dy
    from the f32 dh_pre quantised per row and w1r; the LayerNorm backward
    (+ do with the residual). Returns ``(dx, dw1, db1, dw2, db2, ds, db)`` as
    :func:`ln_mlp_bwd_plain` does, with ``with_codes`` also dh_pre's codes
    (M, HID), and with ``with_h`` the recomputed h in bf16 (M, HID), the
    forward's h as dW2 reads it, in that order."""
    f32, bf16 = torch.float32, torch.bfloat16
    d = x.shape[-1]
    xf = x.to(f32).reshape(-1, d)
    y, xhat, rstd = _ln_f32(xf, scale, bias)
    yq, ys = quant_rows_f32(y)
    h_pre = _int_product(yq, w1q) * ys * s1c + b1.to(f32)
    h = _gelu_tanh_f32(h_pre).to(bf16).to(f32)
    dof = do.to(f32).reshape(-1, d)
    dw2 = torch.matmul(dof.t(), h)
    db2 = dof.sum(dim=0)
    doq, dos = quant_rows_f32(dof)
    dh_pre = _int_product(doq, w2r) * dos * s2r * _dgelu_tanh_f32(h_pre)
    dw1 = torch.matmul(dh_pre.to(bf16).to(f32).t(), y.to(bf16).to(f32))
    db1 = dh_pre.sum(dim=0)
    dhq, dhs = quant_rows_f32(dh_pre)
    dy = _int_product(dhq, w1r) * dhs * s1r
    ds = (dy * xhat).sum(dim=0)
    db = dy.sum(dim=0)
    dx = _ln_bwd_f32(dy, xhat, rstd, scale.to(f32))
    if residual:
        dx = dx + dof
    grads = (dx.reshape(x.shape).to(x.dtype), dw1, db1, dw2, db2, ds, db)
    return _with_extras(grads, with_codes, dhq, with_h, h)


def _ln_mlp_q_bwd_cuda(x, scale, bias, w1q, s1c, b1, w1r, s1r, w2r, s2r, do, residual,
                       with_codes, with_h):
    d, hid = _ln_mlp_check(x, w1q, "ln_mlp_q_bwd", multiple=384, widths=LN_MLP_Q_WIDTHS,
                           kernels_of="B7/B8")
    dev, bf16, f32, i8 = x.device, torch.bfloat16, torch.float32, torch.int8
    _check("x", x, bf16, x.shape, dev)
    _check("ln_scale", scale, f32, (d,), dev)
    _check("ln_bias", bias, f32, (d,), dev)
    _check("w1q", w1q, i8, (hid, d), dev)
    _check("s1c", s1c, f32, (hid,), dev)
    _check("b1", b1, bf16, (hid,), dev)
    _check("w1r", w1r, i8, (d, hid), dev)
    _check("s1r", s1r, f32, (d,), dev)
    _check("w2r", w2r, i8, (hid, d), dev)
    _check("s2r", s2r, f32, (hid,), dev)
    _check("do", do, bf16, x.shape, dev)
    m = x.numel() // d
    splits = _ln_mlp_wgrad_splits(m, d, hid, dev)
    dx = torch.empty_like(x)
    dw = torch.empty(2 * d * hid, dtype=f32, device=dev)  # [dW2 | dW1]
    dw2, dw1 = dw[:d * hid].view(d, hid), dw[d * hid:].view(hid, d)
    bias_out = torch.empty(hid + 3 * d, dtype=f32, device=dev)
    y_buf = torch.empty((m, d), dtype=bf16, device=dev)
    yq_buf = torch.empty((m, d), dtype=i8, device=dev)
    doq_buf = torch.empty((m, d), dtype=i8, device=dev)
    stats = torch.empty((m, 4), dtype=f32, device=dev)
    h_buf = torch.empty((m, hid), dtype=bf16, device=dev)
    dhp_buf = torch.empty((m, hid), dtype=bf16, device=dev)
    dhpf_buf = torch.empty((m, hid), dtype=f32, device=dev)
    db1_part = torch.empty((-(-m // 128), hid), dtype=f32, device=dev)
    rmax_part = torch.empty((hid // 128, m), dtype=f32, device=dev)
    ln_part = torch.empty((-(-m // 64), 3 * d), dtype=f32, device=dev)
    wgrad_part = torch.empty((splits, 2, d, hid), dtype=f32, device=dev)
    codes = torch.empty((m, hid), dtype=i8, device=dev) if with_codes else None
    fn = kernels.function("ln_mlp_q_bwd")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1q.data_ptr(),
                 s1c.data_ptr(), b1.data_ptr(), w1r.data_ptr(), s1r.data_ptr(), w2r.data_ptr(),
                 s2r.data_ptr(), do.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                 bias_out.data_ptr(), y_buf.data_ptr(), yq_buf.data_ptr(), doq_buf.data_ptr(),
                 stats.data_ptr(), h_buf.data_ptr(), dhp_buf.data_ptr(), dhpf_buf.data_ptr(),
                 db1_part.data_ptr(), rmax_part.data_ptr(), ln_part.data_ptr(),
                 wgrad_part.data_ptr(), None if codes is None else codes.data_ptr(), m, d, hid,
                 int(bool(residual)), splits, torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("ln_mlp_q_bwd", err)
    LAUNCHES["ln_mlp_q_bwd"] += 1
    db1, db2, ds, db = bias_out.split((hid, d, d, d))
    return _with_extras((dx, dw1, db1, dw2, db2, ds, db), with_codes, codes, with_h, h_buf)


def ln_mlp_q_bwd(x, scale, bias, w1q, s1c, b1, w1r, s1r, w2r, s2r, do, residual: bool = False,
                 with_codes: bool = False, with_h: bool = False):
    """Gradients of :func:`ln_mlp_q_fwd` given do, from the int8 weight
    copies of ``quantize_mlp_weights(w1, w2, backward=True)``: ``(dx, dw1,
    db1, dw2, db2, ds, db)`` and the check outputs as described at
    :func:`ln_mlp_q_bwd_plain`. The kernel ``csrc/ln_mlp_q_bwd.cu`` for a
    CUDA tensor, the plain version for a CPU one."""
    if _launches_kernel(x):
        return _ln_mlp_q_bwd_cuda(x, scale, bias, w1q, s1c, b1, w1r, s1r, w2r, s2r, do,
                                  residual, with_codes, with_h)
    return ln_mlp_q_bwd_plain(x, scale, bias, w1q, s1c, b1, w1r, s1r, w2r, s2r, do, residual,
                              with_codes, with_h)
