"""12-layer full-block chains (forward, and forward + backward): layout and
fusion variants (counterpart of ``scripts/bench_block_fusion.py``).

    python -m diverse_channel_vit_torch.scripts.bench_block_fusion

Variants:
  v0  the shipped Block re-expressed on (B, N, D): f32 LayerNorm, separate
      q / k / v GEMMs, ``flash_attention_packed`` (B5 / B6)
  v1  all dense and LayerNorm math on the flattened (B*N, D) view; 3D only
      for the attention
  v2  v1 with one fused qkv GEMM (384 -> 1152) whose output the attention
      kernel reads as three column blocks of the same array
      (:func:`qkv_flash_fwd`); forward only

The JAX script's v3 (fused ``ln_qkv`` + ``flash_attention_qkv`` +
``ln_mlp``) imports two ops that the JAX package no longer defines, and
raises there; this script prints a note in its place and goes on to the
"v2 vs v1" numerics line. The JAX script's ``ONLY_V3`` switch goes with it.

:func:`qkv_flash_fwd`'s CUDA kernel is ``csrc/qkv_flash.cu`` (replaces the
TPU kernel ``_qkv_fwd_kernel``). The qkv, proj and MLP products are plain
GEMMs (cuBLAS), as the JAX script leaves them to XLA. Parameters are in
``nn.Linear`` layout (out, in), the transpose of the JAX script's.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import kernels
from ..ops.activations import gelu
from ..ops.attention import HEAD_WIDTHS, flash_attention_packed, flash_packed_fwd_plain
from ..ops.dispatch import LAUNCHES, _check, _check_launch, _launches_kernel
from . import synchronize

B, N, D, H = 64, 1569, 384, 6
NP = 1664  # preferred pad
N_LAYERS = 12


def bench(f, *args, iters: int = 8) -> float:
    """Seconds per call of ``f(*args)``: one warm-up call, then ``iters``
    calls on the host clock ending in a synchronise."""
    synchronize(f(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        r = f(*args)
    synchronize(r)
    return (time.perf_counter() - t0) / iters


def report(tag: str, dt: float) -> None:
    print(f"{tag:<56} {dt*1e3:8.2f} ms ({dt*1e3/N_LAYERS:.2f} ms/layer)", flush=True)


def make_params(seed: int, fused_qkv: bool = False, *, d: int = D,
                device: Optional[str] = None) -> dict:
    """One block's parameters from ``seed``: LayerNorms (f32, identity),
    weights normal * 0.02 in bf16 and zero bf16 biases; q, k and v as three
    (D, D) weights, or with ``fused_qkv`` one (3D, D) ``qkv_w``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16

    def w(out, inp):
        return (torch.randn((out, inp), generator=gen, device=dev) * 0.02).to(bf16)

    def zeros(k, dtype=bf16):
        return torch.zeros(k, dtype=dtype, device=dev)

    p = dict(ln1_s=torch.ones(d, device=dev), ln1_b=zeros(d, torch.float32),
             ln2_s=torch.ones(d, device=dev), ln2_b=zeros(d, torch.float32),
             proj_w=w(d, d), proj_b=zeros(d), fc1_w=w(4 * d, d), fc1_b=zeros(4 * d),
             fc2_w=w(d, 4 * d), fc2_b=zeros(d))
    if fused_qkv:
        p["qkv_w"], p["qkv_b"] = w(3 * d, d), zeros(3 * d)
    else:
        for nm in ("q", "k", "v"):
            p[f"w{nm}"], p[f"b{nm}"] = w(d, d), zeros(d)
    return p


def ln(x, s, b, eps: float = 1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * s + b
    return y.to(x.dtype)


# ---------------------------------------------------------------- v0 (3D)
def block_v0(p, x, *, heads: int = H, n_valid: int = N):
    y = ln(x, p["ln1_s"], p["ln1_b"])
    q = F.linear(y, p["wq"], p["bq"])
    k = F.linear(y, p["wk"], p["bk"])
    v = F.linear(y, p["wv"], p["bv"])
    o = flash_attention_packed(q, k, v, heads, (x.shape[-1] // heads) ** -0.5,
                               valid_len=n_valid)
    x = x + F.linear(o, p["proj_w"], p["proj_b"])
    y = ln(x, p["ln2_s"], p["ln2_b"])
    y = gelu(F.linear(y, p["fc1_w"], p["fc1_b"]))
    return x + F.linear(y, p["fc2_w"], p["fc2_b"])


# ---------------------------------------------------------------- v1 (2D)
def block_v1(p, x2, *, b: int = B, n_pad: int = NP, heads: int = H, n_valid: int = N):
    # x2: (B*NP, D)
    d = x2.shape[-1]
    y = ln(x2, p["ln1_s"], p["ln1_b"])
    q = F.linear(y, p["wq"], p["bq"])
    k = F.linear(y, p["wk"], p["bk"])
    v = F.linear(y, p["wv"], p["bv"])
    o = flash_attention_packed(q.reshape(b, n_pad, d), k.reshape(b, n_pad, d),
                               v.reshape(b, n_pad, d), heads, (d // heads) ** -0.5,
                               valid_len=n_valid).reshape(b * n_pad, d)
    x2 = x2 + F.linear(o, p["proj_w"], p["proj_b"])
    y = ln(x2, p["ln2_s"], p["ln2_b"])
    y = gelu(F.linear(y, p["fc1_w"], p["fc1_b"]))
    return x2 + F.linear(y, p["fc2_w"], p["fc2_b"])


# ------------------------------------------------- v2 (fused qkv + slices)
def qkv_flash_fwd_plain(qkv, num_heads: int, sm_scale: float, n_valid: int):
    """Plain version of :func:`qkv_flash_fwd`, the TPU kernel
    ``_qkv_fwd_kernel``'s arithmetic on the three column blocks of qkv: per
    head s = q k^T * scale in f32, keys at or past ``n_valid`` masked, p =
    exp(s - rowmax) unnormalised, o = (p rounded to qkv's dtype) v in f32,
    divided by rowsum(p), rounded once."""
    d = qkv.shape[-1] // 3
    return flash_packed_fwd_plain(*qkv.split(d, dim=-1), num_heads, sm_scale, n_valid)[0]


def _qkv_flash_fwd_cuda(qkv, num_heads, sm_scale, n_valid):
    b, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    if qkv.dtype != torch.bfloat16 or dh not in HEAD_WIDTHS or dh * num_heads != d or n % 64:
        raise NotImplementedError(
            f"qkv_flash_fwd kernel: {qkv.dtype}, head width {dh}, N={n} (built for bf16, "
            f"head width {HEAD_WIDTHS} and N a multiple of 64; ROADMAP B, S2)")
    if not 1 <= n_valid <= n:
        raise ValueError(f"qkv_flash_fwd kernel: n_valid={n_valid} not in [1, {n}]")
    _check("qkv", qkv, torch.bfloat16, (b, n, 3 * d), qkv.device)
    o = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    fn = kernels.function("qkv_flash")
    with torch.cuda.device(qkv.device):
        err = fn(qkv.data_ptr(), o.data_ptr(), b, n, num_heads, dh, int(n_valid),
                 float(sm_scale), torch.cuda.current_stream(qkv.device).cuda_stream)
    _check_launch("qkv_flash_fwd", err)
    LAUNCHES["qkv_flash_fwd"] += 1
    return o


def qkv_flash_fwd(qkv: torch.Tensor, num_heads: int, sm_scale: float,
                  n_valid: int) -> torch.Tensor:
    """o (B, N, D) = concat_h softmax(q_h k_h^T * scale) v_h over keys
    ``< n_valid``, where q, k and v are column blocks 0, 1 and 2 of the one
    packed (B, N, 3D) ``qkv``; no log-sum-exp. The kernel
    ``csrc/qkv_flash.cu`` for a CUDA tensor, the plain version for a CPU
    one."""
    if _launches_kernel(qkv):
        return _qkv_flash_fwd_cuda(qkv, num_heads, sm_scale, n_valid)
    return qkv_flash_fwd_plain(qkv, num_heads, sm_scale, n_valid)


def block_v2_fwd(p, x2, *, b: int = B, n_pad: int = NP, heads: int = H, n_valid: int = N):
    d = x2.shape[-1]
    y = ln(x2, p["ln1_s"], p["ln1_b"])
    qkv = F.linear(y, p["qkv_w"], p["qkv_b"]).reshape(b, n_pad, 3 * d)
    o = qkv_flash_fwd(qkv, heads, (d // heads) ** -0.5, n_valid).reshape(b * n_pad, d)
    x2 = x2 + F.linear(o, p["proj_w"], p["proj_b"])
    y = ln(x2, p["ln2_s"], p["ln2_b"])
    y = gelu(F.linear(y, p["fc1_w"], p["fc1_b"]))
    return x2 + F.linear(y, p["fc2_w"], p["fc2_b"])


def chain(block, p_list, x):
    for p in p_list:
        x = block(p, x)
    return x


def main(device: Optional[str] = None, *, b: int = B, n: int = N, n_pad: int = NP, d: int = D,
         heads: int = H, layers: int = N_LAYERS) -> None:
    dev = resolve_device(device)
    geo = dict(heads=heads, n_valid=n)
    geo2 = dict(geo, b=b, n_pad=n_pad)
    x3 = torch.randn((b, n_pad, d), generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev).to(torch.bfloat16)
    x2 = x3.reshape(b * n_pad, d)

    for tag, block, xin, kw in (
        ("v0 3D (shipped math)", block_v0, x3, geo),
        ("v1 2D-flattened", block_v1, x2, geo2),
    ):
        ps = [make_params(i, d=d, device=dev) for i in range(layers)]

        def blk(p, x, block=block, kw=kw):
            return block(p, x, **kw)

        with torch.no_grad():
            report(f"{tag} fwd", bench(lambda: chain(blk, ps, xin)))

        leaves = [t.requires_grad_() for p in ps for t in p.values()]
        x_in = xin.detach().requires_grad_()

        def grads(blk=blk, ps=ps, x_in=x_in, leaves=leaves):
            loss = chain(blk, ps, x_in).float().sum()
            return torch.autograd.grad(loss, leaves + [x_in])

        report(f"{tag} fwd+bwd", bench(grads))
        del ps, leaves, x_in

    # v2 forward-only probe: the fused qkv GEMM's output read in place
    ps = [make_params(100 + i, fused_qkv=True, d=d, device=dev) for i in range(layers)]
    with torch.no_grad():
        report("v2 fused-qkv lane-sliced fwd",
               bench(lambda: chain(lambda p, x: block_v2_fwd(p, x, **geo2), ps, x2)))
    print("v3 fused ln_qkv+flash_qkv+ln_mlp: not run (the JAX ops it measures, "
          "flash_attention_qkv and ln_qkv, no longer exist)", flush=True)

    # numerics check v2 vs v1 single layer
    p1 = make_params(7, d=d, device=dev)
    p2 = dict(p1)
    p2["qkv_w"] = torch.cat([p1["wq"], p1["wk"], p1["wv"]], dim=0)
    p2["qkv_b"] = torch.cat([p1["bq"], p1["bk"], p1["bv"]])
    with torch.no_grad():
        a = block_v1(p1, x2, **geo2).float()
        bb = block_v2_fwd(p2, x2, **geo2).float()
    print("v2 vs v1 max abs diff:", (a - bb).abs().max().item())


if __name__ == "__main__":
    main()
