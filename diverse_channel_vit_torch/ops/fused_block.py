"""Fused transformer-block ops, forward only (counterpart of the JAX
package's ``ops/fused_block.py``).

- :func:`attend_project_fwd` — masked multi-head attention over a packed qkv,
  then the output projection, its bias and the residual. Kernel:
  ``csrc/attend_project.cu`` (replaces the TPU kernel ``_ap_fwd_kernel``).
- :func:`ln_mlp` — LayerNorm, fc1, tanh-GELU, fc2, bias and the residual,
  with the hidden activation kept on chip. Kernel: ``csrc/ln_mlp.cu``
  (replaces ``_ln_mlp_fwd_kernel``).

Each is a dispatching wrapper over its kernel and a plain PyTorch version of
the same arithmetic, kept in this module, with the TPU kernel's bf16 cast
points (the plain version computes in f32 when given f32 inputs). On a CPU
tensor a wrapper runs the plain version. On a CUDA tensor it launches the
kernel or raises; it never falls back. :func:`plain_versions` routes CUDA
tensors to the plain versions on explicit request, for holding a kernel
against its plain version on the card.

Weights are in ``nn.Linear`` layout (out_features, in_features), the layout
the port's modules hold; the JAX functions take the transpose.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels
from .attention import MASK_VALUE, PAD_MULTIPLE

_EPS = 1e-6
# tanh-GELU constants (torch approximate="tanh")
_C0 = 0.7978845608028654  # sqrt(2/pi)
_C1 = 0.044715

# launches of each kernel since the last reset_launches(); a wrapper counts
# where it launches its kernel and nowhere else
LAUNCHES = {"attend_project_fwd": 0, "ln_mlp_fwd": 0}

_ROUTE = threading.local()  # .plain: CUDA tensors take the plain versions


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def plain_versions():
    """Run CUDA tensors through the plain versions inside this block, in the
    calling thread only (a comparison aid; the serving path never enters it)."""
    prev = getattr(_ROUTE, "plain", False)
    _ROUTE.plain = True
    try:
        yield
    finally:
        _ROUTE.plain = prev


def _launches_kernel(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return not getattr(_ROUTE, "plain", False)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device: torch.device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


def _gelu_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    inner = _C0 * (x + _C1 * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(inner))


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
    """Plain version of :func:`attend_project_fwd`: per head,
    softmax(q k^T * scale, keys >= n_valid masked) v in f32 with P rounded to
    qkv's dtype before the product, (P v) / l rounded; then
    o Wp^T + bp (+ x_res) in f32, rounded once."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    dt, f32 = qkv.dtype, torch.float32
    masked = torch.arange(n, device=qkv.device) >= n_valid
    outs = []
    for h in range(num_heads):
        q, k, v = (qkv[..., j * d + h * dh: j * d + (h + 1) * dh].to(f32) for j in range(3))
        s = torch.matmul(q, k.transpose(1, 2))
        if sm_scale != 1.0:
            s = s * sm_scale
        if n_valid < n:
            s = s.masked_fill(masked, MASK_VALUE)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(dt).to(f32), v)
        outs.append((o / l).to(dt))
    o = torch.cat(outs, dim=-1)
    xo = torch.matmul(o.to(f32), wp.to(f32).t()) + bp.to(f32)
    if x_res is not None:
        xo = xo + x_res.to(f32)
    return (o if need_o else None), xo.to(dt)


def _attend_project_fwd_cuda(qkv, x_res, wp, bp, num_heads, sm_scale, n_valid, need_o):
    b, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    d_out = wp.shape[0]
    if dh != 64:
        raise NotImplementedError(
            f"attend_project kernel: head width {dh} (only 64 is built; ROADMAP B1)"
        )
    if n % PAD_MULTIPLE or d_out % 64 or not 1 <= n_valid <= n:
        raise ValueError(f"attend_project kernel: N={n} and D_out={d_out} must be multiples "
                         f"of 64 and 1 <= n_valid={n_valid} <= N")
    dev, bf16 = qkv.device, torch.bfloat16
    _check("qkv", qkv, bf16, (b, n, 3 * d), dev)
    _check("wp", wp, bf16, (d_out, d), dev)
    _check("bp", bp, bf16, (d_out,), dev)
    if x_res is not None:
        _check("x_res", x_res, bf16, (b, n, d_out), dev)
    xo = torch.empty((b, n, d_out), dtype=bf16, device=dev)
    o = torch.empty((b, n, d), dtype=bf16, device=dev) if need_o else None
    fn = kernels.function("attend_project")
    with torch.cuda.device(dev):
        err = fn(qkv.data_ptr(), None if x_res is None else x_res.data_ptr(), wp.data_ptr(),
                 bp.data_ptr(), None if o is None else o.data_ptr(), xo.data_ptr(),
                 b, n, num_heads, dh, d_out, int(n_valid), float(sm_scale),
                 torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("attend_project_fwd", err)
    LAUNCHES["attend_project_fwd"] += 1
    return o, xo


def attend_project_fwd(qkv: torch.Tensor, x_res: Optional[torch.Tensor], wp: torch.Tensor,
                       bp: torch.Tensor, num_heads: int, sm_scale: float, n_valid: int,
                       need_o: bool = False) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """``(o, xo)``: o = concat_h softmax(q_h k_h^T * scale) v_h over keys
    ``< n_valid``, xo = o Wp^T + bp (+ x_res). ``qkv`` is (B, N, 3D) packed
    [q | k | v]; ``wp`` is (D_out, D). ``o`` is only produced with
    ``need_o`` (a backward needs it; serving does not)."""
    if _launches_kernel(qkv):
        return _attend_project_fwd_cuda(qkv, x_res, wp, bp, num_heads, sm_scale, n_valid, need_o)
    return attend_project_fwd_plain(qkv, x_res, wp, bp, num_heads, sm_scale, n_valid, need_o)


def attend_project(y: torch.Tensor, w_qkv: torch.Tensor, b_qkv: Optional[torch.Tensor],
                   w_proj: torch.Tensor, b_proj: torch.Tensor, x_res: Optional[torch.Tensor],
                   num_heads: int, sm_scale: Optional[float] = None,
                   valid_len: Optional[int] = None) -> torch.Tensor:
    """[x_res +] proj(attention(split(y @ w_qkv^T + b_qkv))). The token grid
    comes padded once by the model (``maybe_pad_tokens``); the kernel takes
    N a multiple of :data:`PAD_MULTIPLE` and raises otherwise."""
    b, n, d = y.shape
    if sm_scale is None:
        sm_scale = (d // num_heads) ** -0.5
    n_valid = n if valid_len is None else int(valid_len)
    qkv = project(y, w_qkv, b_qkv)
    _, xo = attend_project_fwd(qkv, x_res, w_proj, b_proj, num_heads, float(sm_scale), n_valid)
    return xo


# ---------------------------------------------------------------------------
# ln_mlp
# ---------------------------------------------------------------------------


def ln_mlp_plain(x, scale, bias, w1, b1, w2, b2, residual: bool = False) -> torch.Tensor:
    """Plain version of :func:`ln_mlp`: LayerNorm in f32 (two-pass mean and
    variance, eps 1e-6) rounded to w1's dtype; h = GELU_tanh(y W1^T + b1) in
    f32 rounded to w2's dtype; h W2^T + b2 (+ x) in f32, rounded once."""
    f32 = torch.float32
    xf = x.to(f32)
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + _EPS)
    y = (xc * rstd * scale.to(f32) + bias.to(f32)).to(w1.dtype)
    h = torch.matmul(y.to(f32), w1.to(f32).t()) + b1.to(f32)
    h = _gelu_tanh_f32(h).to(w2.dtype)
    out = torch.matmul(h.to(f32), w2.to(f32).t()) + b2.to(f32)
    if residual:
        out = out + xf
    return out.to(x.dtype)


def _ln_mlp_fwd_cuda(x, scale, bias, w1, b1, w2, b2, residual):
    d = x.shape[-1]
    hid = w1.shape[0]
    if d != 384:
        raise NotImplementedError(f"ln_mlp kernel: width {d} (only 384 is built; ROADMAP B3)")
    if hid % 32:
        raise ValueError(f"ln_mlp kernel: hidden width {hid} must be a multiple of 32")
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


def ln_mlp(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, w1: torch.Tensor,
           b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
           residual: bool = False) -> torch.Tensor:
    """fc2(tanh-GELU(fc1(LayerNorm(x)))) [+ x] over the last axis of x.
    ``scale``/``bias`` are the LayerNorm's (f32 on the kernel path); ``w1``
    is (hidden, D) and ``w2`` (D, hidden)."""
    if _launches_kernel(x):
        return _ln_mlp_fwd_cuda(x, scale, bias, w1, b1, w2, b2, residual)
    return ln_mlp_plain(x, scale, bias, w1, b1, w2, b2, residual)
