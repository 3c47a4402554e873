"""The int8 ``ln_mlp`` forward in one pass against the bf16 one (counterpart
of ``scripts/bench_int8_lnmlp.py``).

    python -m diverse_channel_vit_torch.scripts.bench_int8_lnmlp

:func:`int8_ln_mlp` is the prototype's kernel: LayerNorm, int8 fc1,
tanh-GELU, int8 fc2 and the residual in one launch, activations quantised
per row inside the kernel (dynamic absmax), weights per output unit outside
it (:func:`quant_w`, static absmax), int32 accumulation and f32 rescale.
The TPU kernel ``_int8_kernel`` computes the function of the package's int8
forward (B7, ``_ln_mlp_q_fwd_kernel``) in the same order, so its CUDA kernel
is B7's, ``csrc/ln_mlp_q.cu``, launched through B7's wrapper and counted
under this script's name, as ``bench_block_fusion``'s ``qkv_flash_fwd``
launches B5's kernel. It takes a hidden width that is a multiple of 128.

:func:`main` holds one layer of it against the bf16 ``ln_mlp`` forward (B3,
the counterpart of ``_ln_mlp_fwd_impl``), then times 12-layer chains of each
and prints ms per layer, the effective TFLOP/s and the speedup.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..device import resolve_device
from ..ops import fused_block as fb
from ..ops.dispatch import _launches_kernel
from . import synchronize

L = 12
B, N, D, HID = 64, 1600, 384, 1536


def quant_w(w: torch.Tensor):
    """Static symmetric int8 quantisation of a weight in ``nn.Linear`` layout
    (out, in), one scale per output unit, as the JAX script's ``quant_w``
    (:79) does for the transposed weight: scale = max|w| / 127 over the input
    axis, with no floor; codes round-half-even(w / scale). Returns ``(codes
    (out, in) int8, scale (out,) f32)``: k-major, the layout the kernel
    reads."""
    wf = w.float()
    s = wf.abs().amax(dim=1, keepdim=True) / 127.0
    return torch.round(wf / s).to(torch.int8), s.squeeze(1)


def int8_ln_mlp_plain(x, scale, bias, w1q, s1, b1, w2q, s2, b2, residual: bool = True,
                      with_codes: bool = False):
    """Plain version of :func:`int8_ln_mlp`. The TPU kernel ``_int8_kernel``
    (:41-52) does the arithmetic of the package's int8 forward in the same
    order, so this is ``ln_mlp_q_plain``: y = LayerNorm(x) in f32, quantised
    per row; h = GELU_tanh((acc * ys) * s1 + b1), quantised per row; out =
    (acc2 * hs) * s2 + b2 (+ x), rounded to x's dtype once. With
    ``with_codes`` also h's codes (M, HID)."""
    return fb.ln_mlp_q_plain(x, scale, bias, w1q, s1, b1, w2q, s2, b2, residual, with_codes)


def int8_ln_mlp(x, scale, bias, w1q, s1, b1, w2q, s2, b2, residual: bool = True,
                with_codes: bool = False):
    """fc2(GELU_tanh(fc1(LayerNorm(x)))) [+ x] with both products in int8,
    from the codes and scales of :func:`quant_w` (w1q (HID, D), w2q (D,
    HID)): B7's kernel ``csrc/ln_mlp_q.cu`` for a CUDA tensor, the plain
    version for a CPU one. ``scale`` and ``bias`` are the LayerNorm's (f32),
    ``b1`` and ``b2`` bf16. With ``with_codes`` also returns h's int8 codes
    (M, HID), the codes fc2 read."""
    if _launches_kernel(x):
        return fb._ln_mlp_q_fwd_cuda(x, scale, bias, w1q, s1, b1, w2q, s2, b2, residual,
                                     with_codes, False, launch_key="int8_ln_mlp")
    return int8_ln_mlp_plain(x, scale, bias, w1q, s1, b1, w2q, s2, b2, residual, with_codes)


def bench(fn, args, iters: int = 10) -> float:
    """Seconds per layer of ``fn(*args)``, a chain of L layers: one warm-up
    call, then ``iters`` calls on the host clock ending in a synchronise."""
    synchronize(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    synchronize(out)
    return (time.perf_counter() - t0) / iters / L


def main(device: Optional[str] = None, *, b: int = B, n: int = N, d: int = D,
         hid: int = HID) -> None:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = normal(b, n, d).to(torch.bfloat16)
    scale = torch.ones(d, device=dev)
    bias = torch.zeros(d, device=dev)
    w1 = (normal(hid, d) * 0.05).to(torch.bfloat16)
    b1 = torch.zeros(hid, dtype=torch.bfloat16, device=dev)
    w2 = (normal(d, hid) * 0.05).to(torch.bfloat16)
    b2 = torch.zeros(d, dtype=torch.bfloat16, device=dev)
    w1q, s1 = quant_w(w1)
    w2q, s2 = quant_w(w2)

    def chain_bf(x):
        for _ in range(L):
            x = fb.ln_mlp_fwd(x, scale, bias, w1, b1, w2, b2, True)
        return x

    def chain_i8(x):
        for _ in range(L):
            x = int8_ln_mlp(x, scale, bias, w1q, s1, b1, w2q, s2, b2, True)
        return x

    # numerics sanity on one layer
    o_bf = fb.ln_mlp_fwd(x, scale, bias, w1, b1, w2, b2, True).float()
    o_i8 = int8_ln_mlp(x, scale, bias, w1q, s1, b1, w2q, s2, b2, True).float()
    err = (o_bf - o_i8).abs().max().item()
    rel = err / o_bf.abs().max().item()
    print(f"one-layer max abs err bf16-vs-int8: {err:.4f} (rel {rel:.4f})")

    t_bf = bench(chain_bf, (x,))
    t_i8 = bench(chain_i8, (x,))
    fl = 4 * b * n * d * hid
    print(f"bf16 ln_mlp fwd: {t_bf*1e3:6.3f} ms/layer  {fl/t_bf/1e12:6.1f} TF/s-eff")
    print(f"int8 ln_mlp fwd: {t_i8*1e3:6.3f} ms/layer  {fl/t_i8/1e12:6.1f} TF/s-eff")
    print(f"speedup: {t_bf/t_i8:.2f}x")


if __name__ == "__main__":
    main()
