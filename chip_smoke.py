#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each one either succeeds or ends the run with a non-zero exit):

1. print the card's name and power limit; turn TF32 off for matmuls and
   convolutions;
2. build the CUDA kernels under ``diverse_channel_vit_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build time;
3. hold each kernel against its plain PyTorch version and time the kernel,
   the plain version and a PyTorch library yardstick: the forwards B1
   (attend_project) and B3 (ln_mlp), then the backwards B2 and B4, at the
   flagship shapes (B = 64 images, N = 1600 tokens padded from 1569,
   D = 384, 6 heads, hidden 1536, bf16), B3 and B4 also at the recipe's,
   EViT's and ragged grids, and B2 and B4 each twice on the same inputs,
   bit for bit;
   then B5 and B6 (flash_packed,
   forward and backward) at the three grids the EViT path gives them, B5's
   lse within 1e-5 and B6 twice on the same inputs, bit for bit, with B1's
   and B2's times printed beside theirs (all four run on one flash core,
   ``flash_wgmma.cuh``); then
   B7 and B8 (the int8 ln_mlp, forward and backward) at the flagship shapes,
   with the share of int8 codes that differ from the plain version's; B8's
   recomputed h held bit for bit against B7's, B7's h-storing twin's
   output and codes against its own, B8 twice bit for bit, B8's time split by launch
   (profiler) beside each launch's bound, and an estimate of both kernels'
   epilogue time from a SASS count of their helpers; then
   the benchmark scripts' kernels at the scripts' default shapes: S1
   (``bwd_call``, both schedules), S2 (``qkv_flash_fwd``) and S3
   (``int8_ln_mlp``, B7's kernel), each also held against its package
   sibling on the same inputs (the other schedule and B6 given B5's lse, B5,
   B7), bit for bit, S1 also across two calls; then B1, B2, B5, B6, S1 and
   S2 again at head width 128 (3 heads at D = 384, the ``small_tpu``
   preset), under names ending ``_dh128``; then B3, B4, B1 and B2 at the
   ``base`` preset's widths (D = 768, hidden 3072, 12 heads of 64; B3 and B4
   run a cluster of two blocks per 64 rows there), under names ending
   ``_d768``, B3 and B4 with and without biases and residual, B4 twice bit
   for bit; then B7 and B8 at D = 768 (a cluster of two blocks per 64 rows
   each) as at D = 384, also on a grid with a half-full last 128-row tile;
4. build full-width DiChaViT-S (8 channels, 224^2, patch 16, depth 12, 161
   classes, seeded random weights, bf16 compute) and serve requests through
   ``ServingEngine`` (``predict``, ``submit``) and ``ServingHTTPServer`` on
   localhost, with the kernel launch counts set to 0 just before and read
   just after; time each batch bucket and profile one 64-image ``predict``;
   then hold the logits against the same model run through the plain
   versions. The same for the model with EViT pruning (keep_rate 0.7:
   B5 at layers 3, 6 and 9, B1 / B3 at the other eight) and, for one
   forward and its profile, with ``gelu_exact`` (every block unfused:
   B5 x 11);
5. train the model (f32 parameters, bf16 compute) with the port's
   ``make_optimizer`` / ``make_lr_schedule`` / ``TrainState`` /
   ``make_train_step`` on one synthetic batch of 64 images: CE + CDL + TDL,
   AdamW with the JUMP-CP weight-decay schedule; counts set to 0 just before
   2 warm-up and 10 timed steps and read just after (B1-B4 11 launches per
   step); profile one step; then 3 steps through the kernels against 3
   steps through the plain versions from the same weights, at depth 4. The
   same with EViT pruning (B5, B6 3 launches per step, B1-B4 8), and one
   ``gelu_exact`` step at depth 3, kernels against plain versions;
6. int8 (``quantization="int8"``): serve buckets 1-64 through an int8
   ``ServingEngine`` and HTTP (B7 and B1 x 11 per forward, no B3) beside an
   unquantised engine on the same model; train 12 int8 steps (B1, B2, B7,
   B8 x 11 per step) and 3 at depth 4 against the plain route;
7. the DCS recipe: 48 steps at B = 64 with k drawn from the JAX benchmark's
   mixture (``lowest_cosine_prob``, temperature 1000), each k warmed once
   first, images/s and launches per step (B1-B4 x 11); 3 steps at k = 2, 5
   and 8 at depth 4 against the plain route, both drawing the same channels;
8. the ``small_tpu`` preset (3 heads of 128, every attention kernel at head
   width 128) at full width and depth, as the JAX benchmark's ``mxu_native``
   flagship and recipe, ``int8_dh128`` and dh-128 EViT recipe cells: serving
   as phase 4 (buckets 1-64, a k = 3 subset, logits against the plain
   route), 12 train steps and the 3-step parity at depth 4, the DCS recipe,
   12 int8 train steps (B1, B2, B7, B8) and their parity, and the DCS recipe
   with EViT (keep_rate 0.7: B5 and B6 at layers 3, 6 and 9) and its parity
   at k = 2, 5 and 8; each path prints its images/s, p50 ms and peak memory
   beside the card;
9. the ``base`` preset (DiChaViT-B: D = 768, 12 heads, MLP 3072) at full
   width and depth: serving as phase 4 (buckets 1-64, a k = 3 subset,
   logits against the plain route), 12 train steps at B = 64 and the 3-step
   parity at depth 4, each with its ``phase`` line; the same three with
   ``quantization: int8`` (serving as phase 6: B7 and B1 x 11 per forward,
   no B3; train B1, B2, B7 and B8 x 11 per step, no B3 / B4); then the
   port's geometry smoke
   (``diverse_channel_vit_torch.scripts.smoke_geometries``) through its
   ``main``: the JAX script's five geometries (CHAMMI's 12 channels with the
   proxy loss, DCS at k = 5 of 12, base, head width 128, So2Sat's 18
   channels at 32^2 with patch 8), 6 train steps each, every loss finite,
   B1-B4 x 11 per step, a ``phase`` line each;
10. run the port's three benchmark scripts through their entry points at
   their defaults (``bench_attn`` chain, bwd-variants, step and small-k,
   ``bench_block_fusion``, ``bench_int8_lnmlp``) and S1's and S2's at 3
   heads (``bench_attn bwd-variants --heads 3``, ``bench_block_fusion`` at
   3 heads), their output echoed, the counts set to 0 just before each and
   read just after;
11. print the ``kernels`` JSON line (each kernel's launches from its main
    path), the card line, and last the result line
    ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. Without a CUDA device, or outside a checkout of
the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import subprocess
import sys
import time
import urllib.request

import numpy as np

# flagship geometry (DiChaViT-S at JUMP-CP)
B, N_VALID, D, HEADS, HID = 64, 1569, 384, 6, 1536
# the small_tpu preset: the same width in 3 heads of 128 (the JAX bench's
# mxu_native, int8_dh128 and dh-128 EViT recipe cells)
TPU_PRESET, HEADS_TPU = "small_tpu", 3
# the base preset (DiChaViT-B: D = 768 in 12 heads of 64, MLP 3072) at the
# same geometry: the MLP kernels at D = 768, a cluster of two blocks per 64 rows
BASE_PRESET, D_BASE, HEADS_BASE, HID_BASE = "base", 768, 12, 3072
CHANNELS, IMG, PATCH, DEPTH, CLASSES = 8, 224, 16, 12, 161
BUCKETS = (1, 4, 16, 64)
# the plain-route training check runs at this depth (the plain attention
# materialises every (N, N) score matrix); the timed steps run at DEPTH
PARITY_DEPTH = 4
# EViT (keep_rate 0.7): layers 3, 6 and 9 prune at DEPTH (1, 2 and 3 at
# PARITY_DEPTH); the grids B5 meets there, (N, n_valid): 1569 -> 1 + 1097
# tokens padded to 1152, -> 1 + 767 = 768 (no mask), -> 1 + 536 padded to 576
KEEP_RATE = 0.7
EVIT_GRIDS = ((1600, 1569), (1152, 1098), (768, 768))
# the gelu_exact training check: blocks 0-1 unfused, block 2 the readout
GELU_PARITY_DEPTH = 3
# H100 SXM published dense peaks
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 989e12, 1979e12, 3.35e12
# the DCS recipe (bench.py:85-94): lowest_cosine_prob at temperature 1000
HCS_METHOD, HCS_TEMP = "lowest_cosine_prob", 1000.0
# int8 codes that may differ between an int8 kernel and its plain version: a
# value within f32 noise of a .5 tie (the LayerNorm sums in another order,
# the plain version's tanh comes from another library build) rounds the other
# way; a wrong scale or product would flip most codes
MAX_CODE_FLIPS = 1e-2
# kernel vs plain version, both bf16: they round at the same points but sum
# in other orders and the kernel's online softmax rounds P against a running
# max, so an output may land one or two bf16 ulps (2^-7 relative) apart
KERNEL_REL_TOL = 2e-2
# B5's log-sum-exp against its plain version: f32 statistics of the same
# scores (the kernel's ex2 and log2 against the plain version's exp and log)
LSE_REL_TOL = 1e-5
# logits after 12 layers of such differences
LOGITS_REL_TOL = 5e-2
# kernel route vs plain route over 3 train steps at PARITY_DEPTH: losses, and
# each parameter's step-0 gradient against max|g| of that parameter (the
# differences above, carried through 4 layers forward and back)
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2


# the other grids B3 and B4 meet, (images, tokens): a last 128-row tile half
# full (192 rows), the recipe's smallest grid (k = 1: N = 256), the EViT grid
# after layer 6 (N = 768), and a token count that is no multiple of 64
LN_MLP_GRIDS = ((3, 64), (8, 256), (8, 768), (1, 100))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def hold(name: str, label: str, pairs) -> tuple:
    """Raise unless every kernel output in ``pairs`` ((what, kernel, plain),
    ...) is finite and within KERNEL_REL_TOL of max|plain|; return the
    (max_abs_err, rel_err) of the output with the largest rel_err."""
    import torch

    torch.cuda.synchronize()
    errs = []
    for what, got, ref in pairs:
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} ({label}): {what} is not finite")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / (ref.float().abs().max().item() + 1e-12)
        print(f"{name} ({label}): {what} max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tolerance rel <= {KERNEL_REL_TOL})")
        if not rel <= KERNEL_REL_TOL:
            raise AssertionError(f"{name} ({label}): {what} disagrees with its plain version")
        errs.append((err, rel))
    return max(errs, key=lambda e: e[1])


def kernel_name(name: str, heads: int, d: int = D) -> str:
    """The kernels line's name of an attention kernel at d / heads head width:
    the name alone at 64 and the flagship width, with the head width or the
    model width beside it otherwise."""
    dh = d // heads
    return f"{name}_dh{dh}" if dh != 64 else width_name(name, d)


def width_name(name: str, d: int) -> str:
    """The kernels line's name of a kernel at model width d: the name alone at
    the flagship width, with the width beside it otherwise."""
    return name if d == D else f"{name}_d{d}"


def _rnd(torch, g):
    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)
    return rnd


def check_kernels(fb, torch, F):
    """Phase 3, forwards: each kernel against its plain version at flagship
    shapes.

    Each kernel runs twice. First as the main path calls it, residual fused,
    with biases drawn at the residual's scale, so a dropped or misplaced bias
    or residual moves the output far past the tolerance. Then with no
    residual and zero output bias, so the kernel's products alone set
    max|plain| and a fault there cannot hide under the added terms."""
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(0))
    return {"attend_project_fwd": check_attend_project_fwd(fb, torch, F, HEADS, rnd),
            "ln_mlp_fwd": check_ln_mlp_fwd(fb, torch, F, rnd)}


def check_ln_mlp_fwd(fb, torch, F, rnd, d=D, hid=HID):
    """B3 (ln_mlp_fwd) against its plain version at the flagship grid with
    model width ``d`` and hidden width ``hid``, residual fused and then bare,
    as check_kernels describes, then at LN_MLP_GRIDS; its timings."""
    n = -(-N_VALID // 64) * 64
    bf16 = torch.bfloat16
    # the model reads only the n_valid real rows of the padded grid, so the
    # bound counts those (the kernels also compute the padded rows)
    rows = B * N_VALID
    name = width_name("ln_mlp_fwd", d)
    x = rnd(B, n, d)
    s, bb = rnd(d, scale=0.1, dtype=torch.float32) + 1.0, rnd(d, scale=0.1, dtype=torch.float32)
    w1, b1 = rnd(hid, d, scale=d ** -0.5), rnd(hid)
    w2, b2 = rnd(d, hid, scale=hid ** -0.5), rnd(d)
    largs = (x, s, bb, w1, b1, w2, b2, True)
    bare = (x, s, bb, w1, b1, w2, torch.zeros_like(b2), False)

    def hold_ln(label, a):
        return hold(name, label, (("out", fb.ln_mlp(*a), fb.ln_mlp_plain(*a)),))

    err, rel = hold_ln("main path", largs)
    hold_ln("no residual, zero bias", bare)
    for (nb, nn), res in zip(LN_MLP_GRIDS, (True, False, True, False)):
        hold_ln(f"{nb} x {nn} tokens, residual {res}",
                (rnd(nb, nn, d), s, bb, w1, b1, w2, b2 if res else torch.zeros_like(b2), res))
    ms = cuda_ms(lambda: fb.ln_mlp(*largs), 10)
    plain_ms = cuda_ms(lambda: fb.ln_mlp_plain(*largs), 3, warmup=1)
    sb, bbb = s.to(bf16), bb.to(bf16)

    def library():
        y = F.layer_norm(x, (d,), sb, bbb, 1e-6)
        return F.linear(F.gelu(F.linear(y, w1, b1), approximate="tanh"), w2, b2) + x

    library_ms = cuda_ms(library, 10)
    return dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:152",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=4 * rows * d * hid,
        bytes=2 * (2 * rows * d + 2 * d * hid + hid + d) + 4 * 2 * d,
    )


def check_attend_project_fwd(fb, torch, F, heads, rnd, D=D):
    """B1 (attend_project_fwd) against its plain version at flagship shapes
    with ``heads`` heads (6 of 64, or 3 of 128 for the small_tpu preset, or
    at D = 768 the base preset's 12 of 64), residual fused and then bare, as
    check_kernels describes; its timings."""
    n = -(-N_VALID // 64) * 64
    rows = B * N_VALID
    dh = D // heads
    qkv, x_res = rnd(B, n, 3 * D), rnd(B, n, D)
    wp, bp = rnd(D, D, scale=D ** -0.5), rnd(D)
    args = (qkv, x_res, wp, bp, heads, dh ** -0.5, N_VALID)
    bare = (qkv, None, wp, torch.zeros_like(bp), heads, dh ** -0.5, N_VALID)
    name = kernel_name("attend_project_fwd", heads, D)

    def hold_ap(label, a):
        (o_k, l_k, xo_k), (o_p, l_p, xo_p) = (f(*a, need_o=True) for f in
                                              (fb.attend_project_fwd, fb.attend_project_fwd_plain))
        return hold(name, label, (("xo", xo_k, xo_p), ("o", o_k, o_p), ("lse", l_k, l_p)))

    err_xo, rel_xo = hold_ap("main path", args)
    hold_ap("no residual, zero bias", bare)
    ms = cuda_ms(lambda: fb.attend_project_fwd(*args), 10)
    plain_ms = cuda_ms(lambda: fb.attend_project_fwd_plain(*args), 3, warmup=1)
    keep = (torch.arange(n, device="cuda") < N_VALID)[None, None, None, :]

    def library():
        q, k, v = qkv.view(B, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        return F.linear(o.transpose(1, 2).reshape(B, n, D), wp, bp) + x_res

    library_ms = cuda_ms(library, 10)
    return dict(
        source="diverse_channel_vit_torch/csrc/attend_project.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:671",
        max_abs_err=err_xo, rel_err=rel_xo, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=4 * rows * N_VALID * D + 2 * rows * D * D,
        bytes=2 * (rows * 3 * D + 2 * rows * D + D * D + D),
    )


def check_attend_project_bwd(fb, torch, F, heads, rnd, D=D):
    """B2 (attend_project_bwd) against its plain version at flagship shapes
    with ``heads`` heads at width ``D``, as check_bwd_kernels describes; its
    timings."""
    n = -(-N_VALID // 64) * 64
    rows = B * N_VALID
    dh = D // heads
    name = kernel_name("attend_project_bwd", heads, D)
    qkv, x_res = rnd(B, n, 3 * D), rnd(B, n, D)
    wp, bp = rnd(D, D, scale=D ** -0.5), rnd(D)
    dxo = rnd(B, n, D)
    names = ("dq", "dk", "dv", "dwp", "dbp", "db_qkv")

    def split(out):
        dqkv, dwp, dbp, db = out
        return (dqkv[..., :D], dqkv[..., D:2 * D], dqkv[..., 2 * D:], dwp, dbp, db)

    def hold_ap(label, n_valid):
        o, lse, _ = fb.attend_project_fwd(qkv, x_res, wp, bp, heads, dh ** -0.5, n_valid,
                                          need_o=True)
        a = (qkv, o, lse, wp, dxo, heads, dh ** -0.5, n_valid)
        got = split(fb.attend_project_bwd(*a))
        worst = hold(name, label,
                     list(zip(names, got, split(fb.attend_project_bwd_plain(*a)))))
        return worst, got, a

    (err, rel), got, args = hold_ap("main path", N_VALID)
    pad = torch.cat([got[1][:, N_VALID:], got[2][:, N_VALID:]], dim=-1)
    if torch.count_nonzero(pad).item() != 0:
        raise AssertionError(f"{name}: padded key rows have dk or dv != 0")
    print(f"{name}: dk and dv exactly 0 on the {n - N_VALID} padded key rows")
    hold_ap("every key valid", n)
    first, second = fb.attend_project_bwd(*args), fb.attend_project_bwd(*args)
    if not all(torch.equal(p, q) for p, q in zip(first, second)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    print(f"{name}: two calls on the same inputs agree bit for bit")
    del first, second, got, pad
    ms = cuda_ms(lambda: fb.attend_project_bwd(*args), 10)
    plain_ms = cuda_ms(lambda: fb.attend_project_bwd_plain(*args), 2, warmup=1)
    keep = (torch.arange(n, device="cuda") < N_VALID)[None, None, None, :]
    lq, lw, lb = (t.detach().clone().requires_grad_() for t in (qkv, wp, bp))
    q, k, v = lq.view(B, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
    lib_out = F.linear(o.transpose(1, 2).reshape(B, n, D), lw, lb) + x_res
    library_ms = cuda_ms(
        lambda: torch.autograd.grad(lib_out, (lq, lw, lb), dxo, retain_graph=True), 10)
    del lib_out, o, q, k, v
    return dict(
        source="diverse_channel_vit_torch/csrc/attend_project_bwd.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:713",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=10 * rows * N_VALID * D + 4 * rows * D * D,
        bytes=2 * (rows * 3 * D + rows * D + rows * D + D * D + rows * 3 * D)
        + 4 * (rows * heads + D * D + D + 3 * D),
    )

def check_bwd_kernels(fb, torch, F):
    """Phase 3, backwards: B2 and B4 against their plain versions at flagship
    shapes, every output.

    B2 runs from the forward kernel's own o and lse, as the main path calls
    it (keys 1569-1599 masked), and again with every key valid; it takes no
    residual (the autograd Function passes dxo to the residual itself). B4
    runs with the residual fused, as the main path calls it, and without.
    dxo and do are drawn at scale 1. Padded key rows must come out of B2 with
    dk = dv = 0 exactly, and two calls of B2, as of B4, on the same inputs
    must agree bit for bit."""
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(1))
    return {"attend_project_bwd": check_attend_project_bwd(fb, torch, F, HEADS, rnd),
            "ln_mlp_bwd": check_ln_mlp_bwd(fb, torch, F, rnd)}


def check_ln_mlp_bwd(fb, torch, F, rnd, d=D, hid=HID):
    """B4 (ln_mlp_bwd) against its plain version at the flagship grid with
    model width ``d`` and hidden width ``hid``, every output, residual fused
    and not, then at LN_MLP_GRIDS; two calls on the same inputs bit for bit;
    its timings."""
    n = -(-N_VALID // 64) * 64
    bf16 = torch.bfloat16
    rows = B * N_VALID
    name = width_name("ln_mlp_bwd", d)
    x, do = rnd(B, n, d), rnd(B, n, d)
    s, bb = rnd(d, scale=0.1, dtype=torch.float32) + 1.0, rnd(d, scale=0.1, dtype=torch.float32)
    w1, b1 = rnd(hid, d, scale=d ** -0.5), rnd(hid)
    w2 = rnd(d, hid, scale=hid ** -0.5)
    names = ("dx", "dw1", "db1", "dw2", "db2", "ds", "db")

    def hold_ln(label, residual):
        a = (x, s, bb, w1, b1, w2, do, residual)
        return hold(name, label,
                    list(zip(names, fb.ln_mlp_bwd(*a), fb.ln_mlp_bwd_plain(*a)))), a

    (err, rel), largs = hold_ln("main path, residual fused", True)
    hold_ln("no residual", False)
    for (nb, nn), res in zip(LN_MLP_GRIDS, (False, True, False, True)):
        a = (rnd(nb, nn, d), s, bb, w1, b1, w2, rnd(nb, nn, d), res)
        hold(name, f"{nb} x {nn} tokens, residual {res}",
             list(zip(names, fb.ln_mlp_bwd(*a), fb.ln_mlp_bwd_plain(*a))))
    first, second = fb.ln_mlp_bwd(*largs), fb.ln_mlp_bwd(*largs)
    if not all(torch.equal(p, q) for p, q in zip(first, second)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    print(f"{name}: two calls on the same inputs agree bit for bit")
    del first, second
    ms = cuda_ms(lambda: fb.ln_mlp_bwd(*largs), 10)
    plain_ms = cuda_ms(lambda: fb.ln_mlp_bwd_plain(*largs), 2, warmup=1)
    lib_in = [t.detach().clone().requires_grad_()
              for t in (x, s.to(bf16), bb.to(bf16), w1, b1, w2, rnd(d))]
    lx, ls, lbb, lw1, lb1, lw2, lb2 = lib_in
    lib_out = F.linear(F.gelu(F.linear(F.layer_norm(lx, (d,), ls, lbb, 1e-6), lw1, lb1),
                              approximate="tanh"), lw2, lb2) + lx
    library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_in, do, retain_graph=True), 10)
    del lib_out
    return dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp_bwd.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:167",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=10 * rows * d * hid,
        bytes=2 * (3 * rows * d + 2 * d * hid + hid) + 4 * (2 * d + 2 * d * hid + hid + 3 * d),
    )


def _quant_rows(torch, v):
    s = torch.clamp_min(v.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    return torch.round(v / s).to(torch.int8), s


def _int_mm(torch, a, w):
    """a (..., K) int8 times w (N, K) int8 in int32, by cuBLASLt
    (``torch._int_mm``), as f32: the library yardstick of the int8 GEMMs."""
    out = torch._int_mm(a.reshape(-1, a.shape[-1]), w.t())
    return out.reshape(*a.shape[:-1], w.shape[0]).float()


def int8_library_ms(name: str, fn):
    """``fn``'s time, or None (printed as not measured) if this PyTorch build
    refuses ``torch._int_mm`` at these shapes."""
    try:
        return cuda_ms(fn, 10)
    except RuntimeError as e:
        print(f"{name}: library yardstick not measured: torch._int_mm raised {e}")
        return None


def code_flips(name: str, label: str, got, want) -> float:
    share = (got != want.reshape(got.shape)).float().mean().item()
    print(f"{name} ({label}): int8 codes differing from the plain version's: {share:.3e} "
          f"of {got.numel()} (at most {MAX_CODE_FLIPS})")
    if not share <= MAX_CODE_FLIPS:
        raise AssertionError(f"{name} ({label}): too many int8 codes differ")
    return share


# B8's launches, by the kernel names the profiler reports, and what each is
B8_PARTS = (("q_rows_kernel", "LN pass"), ("q_dual_kernel", "dual"), ("q_dy_kernel", "dy"),
            ("wgrad_kernel", "wgrad"), ("reduce_partials_kernel", "reductions"))

# One hidden element of each int8 kernel's epilogue, built from int8.cuh's
# helpers alone, for counting its instructions in the SASS: B7's pass 1
# (h_pre into the row max) and pass 2 (GELU, quantisation), B8's GELU and
# GELU' from one tanhf with both dequantisations (dual) and the quantisation
# of dh_pre (dy). Inputs come from memory so that nothing folds.
EPILOGUE_PROBE = r"""
#include "int8.cuh"
using namespace dcvit;
extern "C" __global__ void b7_element(const int* a, const float* f, float* o, int8_t* q) {
  const int i = threadIdx.x;
  o[i] = fmaxf(o[i], __fadd_rn(dequant(a[i], f[0], f[1]), f[2]));
  const float h = gelu_tanh_rn(__fadd_rn(dequant(a[i + 1024], f[0], f[3]), f[4]));
  q[i] = quant_s8(h, f[5]);
}
extern "C" __global__ void b8_element(const int* a, const float* f, float* o, int8_t* q) {
  const int i = threadIdx.x;
  float g, dg;
  gelu_dgelu_tanh_rn(__fadd_rn(dequant(a[i], f[0], f[1]), f[2]), g, dg);
  const float dp = __fmul_rn(dequant(a[i + 1024], f[3], f[4]), dg);
  o[i] = g;
  o[i + 1024] = dp;
  q[i] = quant_s8(o[i + 2048], f[5]);
}
"""
# SASS opcodes that move data or steer control, not counted as epilogue work
PROBE_SKIP = ("LDG", "STG", "LDC", "ULDC", "S2R", "S2UR", "EXIT", "BRA", "NOP", "CS2R",
              "CALL", "RET", "BSSY", "BSYNC")


@functools.lru_cache(maxsize=None)
def epilogue_instructions(kernels) -> dict:
    """Static SASS instruction count of one hidden element of B7's and B8's
    epilogues (``EPILOGUE_PROBE`` built with the kernels' flags, read with
    ``cuobjdump -sass``), memory and control opcodes left out, up to each
    function's first unpredicated EXIT: the subroutines placed after it
    (``__fdiv_rn``'s slow path, reached by CALL) are left out, both sides of
    a branch in the body still count. {} (printed as not measured) where the
    toolkit lacks cuobjdump."""
    import os
    import re

    nvcc = kernels.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("int8 epilogue instructions: not measured (no cuobjdump beside nvcc)")
        return {}
    probe_dir = kernels.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    src, cubin = probe_dir / "epilogue_probe.cu", probe_dir / "epilogue_probe.cubin"
    src.write_text(EPILOGUE_PROBE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-I", str(kernels.CSRC), "-o", str(cubin), str(src)],
                   check=True, capture_output=True, text=True, timeout=300)
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if not (name and m):
            continue
        op = m.group(2).split(".")[0]
        if op == "EXIT" and not m.group(1):
            name = None  # the rest is subroutines off the fast path
        elif op not in PROBE_SKIP:
            counts[name] += 1
    print(f"int8 epilogue instructions per hidden element (static SASS count to the first "
          f"EXIT, memory and control left out): {counts}")
    return counts


@functools.lru_cache(maxsize=None)
def issue_rate() -> float:
    """Thread-instructions a second the card could issue at the SM clock's
    maximum (nvidia-smi): SMs x 4 schedulers x 32 lanes x that clock. The
    clock under load may be lower."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 4 * 32 * mhz * 1e6


def device_ms_by_kernel(fn, calls: int, torch) -> dict:
    """Device ms a call of each kernel ``fn`` launches, over ``calls`` calls,
    from the profiler; {} if it recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", 0) or 0
        if dev > 0 and getattr(e, "device_type", None) != torch.autograd.DeviceType.CPU:
            out[e.key] = out.get(e.key, 0.0) + dev / 1e3 / calls
    return out


def check_q_kernels(fb, torch, F, kernels, d=D, hid=HID, seed=3):
    """Phase 3, the int8 ln_mlp: B7 and B8 against their plain versions at
    the flagship grid with model width ``d`` and hidden width ``hid`` (at D
    = 768 both run a cluster of two blocks per 64 rows), each output within
    KERNEL_REL_TOL and the codes of the last int8 product (hq for B7,
    dh_pre's for B8) within MAX_CODE_FLIPS. B7 runs with the residual fused
    and output biases at the residual's scale, as the main path calls it,
    then with no residual and zero output bias; B8 with the residual fused
    and without; at D = 768 both also at LN_MLP_GRIDS' 3 x 64 (a half-full
    last 128-row tile) and 1 x 100 (a ragged last 64-row tile). The library
    yardstick is the same arithmetic in PyTorch ops with ``torch._int_mm``
    (cuBLASLt int8) for the int8 GEMMs and, in B8, bf16 ``torch.matmul`` for
    the weight gradients.
    B7's instantiation that also stores h must give the main path's output
    and codes, and B8's recomputed h must equal its h, bit for bit; two B8
    calls on the same inputs agree bit for bit; B8's time is split by its
    launches (profiler) beside each one's bound; and the epilogue's
    instruction count (SASS) gives an estimate of its issue time, printed
    beside the bound: neither a bound nor a measured time."""
    n = -(-N_VALID // 64) * 64
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(seed))
    bf16, f32 = torch.bfloat16, torch.float32
    rows = B * N_VALID
    name7, name8 = width_name("ln_mlp_q_fwd", d), width_name("ln_mlp_q_bwd", d)
    x, do = rnd(B, n, d), rnd(B, n, d)
    s, bb = rnd(d, scale=0.1, dtype=f32) + 1.0, rnd(d, scale=0.1, dtype=f32)
    w1, b1 = rnd(hid, d, scale=d ** -0.5), rnd(hid)
    w2, b2 = rnd(d, hid, scale=hid ** -0.5), rnd(d)
    w1q, s1c, w2q, s2c, w1r, s1r, w2r, s2r = fb.quantize_mlp_weights(w1, w2, backward=True)
    results = {}
    more_grids = (LN_MLP_GRIDS[0], LN_MLP_GRIDS[3]) if d != D else ()

    # --- B7 ln_mlp_q_fwd
    fargs = (x, s, bb, w1q, s1c, b1, w2q, s2c, b2, True)
    flips = []
    cases = [("main path", fargs),
             ("no residual, zero bias",
              (x, s, bb, w1q, s1c, b1, w2q, s2c, torch.zeros_like(b2), False))]
    for nb, nn in more_grids:
        cases.append((f"{nb} x {nn} tokens, residual True",
                      (rnd(nb, nn, d), s, bb, w1q, s1c, b1, w2q, s2c, b2, True)))
    for label, a in cases:
        out, codes = fb.ln_mlp_q_fwd(*a, with_codes=True)
        out_p, codes_p = fb.ln_mlp_q_plain(*a, with_codes=True)
        worst = hold(name7, label, (("out", out, out_p),))
        flips.append(code_flips(name7, label, codes, codes_p))
        if label == "main path":
            err, rel = worst
        del out, codes, out_p, codes_p
    ms = cuda_ms(lambda: fb.ln_mlp_q_fwd(*fargs), 10)
    plain_ms = cuda_ms(lambda: fb.ln_mlp_q_plain(*fargs), 3, warmup=1)
    insns = epilogue_instructions(kernels)
    rate = issue_rate()

    def epilogue_estimate(name, key, elements):
        """Printed only: an estimate from a static count at the maximum
        clock, which may lie above or below the epilogue's real issue time."""
        if key in insns:
            print(f"{name}: epilogue estimate {insns[key] * elements / rate * 1e3:.4f} ms "
                  f"({insns[key]} instructions x {elements} hidden elements / {rate:.4g} "
                  f"thread-instructions/s at the maximum SM clock; not a bound)")

    def library():
        xf = x.float()
        yq, ys = _quant_rows(torch, F.layer_norm(xf, (d,), s, bb, 1e-6))
        h = F.gelu(_int_mm(torch, yq, w1q) * ys * s1c + b1.float(), approximate="tanh")
        hq, hs = _quant_rows(torch, h)
        return (_int_mm(torch, hq, w2q) * hs * s2c + b2.float() + xf).to(bf16)

    library_ms = int8_library_ms(name7, library)
    results[name7] = dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp_q.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:474",
        max_abs_err=err, rel_err=rel, code_flips=max(flips), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, int8_ops=4 * rows * d * hid, flops=0,
        bytes=2 * 2 * rows * d + 2 * d * hid + 4 * (hid + d) + 2 * (hid + d) + 4 * 2 * d,
    )
    epilogue_estimate(name7, "b7_element", rows * hid)

    # --- B8 ln_mlp_q_bwd
    names = ("dx", "dw1", "db1", "dw2", "db2", "ds", "db")
    flips = []
    cases = [("main path, residual fused", (x, do, True)), ("no residual", (x, do, False))]
    for nb, nn in more_grids:
        cases.append((f"{nb} x {nn} tokens, residual True",
                      (rnd(nb, nn, d), rnd(nb, nn, d), True)))
    for label, (xx, dd, residual) in cases:
        a = (xx, s, bb, w1q, s1c, b1, w1r, s1r, w2r, s2r, dd, residual)
        got = fb.ln_mlp_q_bwd(*a, with_codes=True)
        want = fb.ln_mlp_q_bwd_plain(*a, with_codes=True)
        worst = hold(name8, label, list(zip(names, got[:7], want[:7])))
        flips.append(code_flips(name8, label, got[7], want[7]))
        if label.startswith("main path"):
            (err, rel), bargs = worst, a
        del got, want
    # B7's h comes from its instantiation that also stores h (ln_mlp_q.cu),
    # whose output and codes must be the main path's
    out7, codes7, h7 = fb.ln_mlp_q_fwd(*fargs, with_codes=True, with_h=True)
    out_main, codes_main = fb.ln_mlp_q_fwd(*fargs, with_codes=True)
    if not (torch.equal(out7, out_main) and torch.equal(codes7, codes_main)):
        raise AssertionError(f"{name7}: the output or codes with h differ from the main path's")
    h8 = fb.ln_mlp_q_bwd(*bargs, with_h=True)[7]
    if not torch.equal(h7, h8):
        raise AssertionError(f"{name8}: the recomputed h differs from {name7}'s")
    print(f"{name8}: the recomputed h equals {name7}'s, bit for bit (and {name7}'s output and "
          "codes with h are the main path's)")
    del out7, codes7, h7, h8, out_main, codes_main
    first, second = fb.ln_mlp_q_bwd(*bargs), fb.ln_mlp_q_bwd(*bargs)
    if not all(torch.equal(p, q) for p, q in zip(first, second)):
        raise AssertionError(f"{name8}: two calls on the same inputs differ")
    print(f"{name8}: two calls on the same inputs agree bit for bit")
    del first, second
    ms = cuda_ms(lambda: fb.ln_mlp_q_bwd(*bargs), 10)
    plain_ms = cuda_ms(lambda: fb.ln_mlp_q_bwd_plain(*bargs), 2, warmup=1)
    # B8's launches, each beside its bound (max of operations and bytes)
    parts = device_ms_by_kernel(lambda: fb.ln_mlp_q_bwd(*bargs), 3, torch)
    m = B * n
    splits = fb._ln_mlp_wgrad_splits(m, d, hid, torch.device("cuda"))
    part_bounds = {
        "LN pass": 8 * rows * d / PEAK_BYTES,
        "dual": max(4 * rows * d * hid / PEAK_INT8_OPS, (2 * rows * d + 8 * rows * hid) / PEAK_BYTES),
        "dy": max(2 * rows * d * hid / PEAK_INT8_OPS, (4 * rows * hid + 6 * rows * d) / PEAK_BYTES),
        "wgrad": 4 * rows * d * hid / PEAK_BF16_FLOPS,
        "reductions": 4 * (splits * 2 * d * hid + -(-m // 128) * hid
                           + -(-m // 64) * 3 * d) / PEAK_BYTES,
    }
    split = {}
    for key, label in B8_PARTS:
        split[label] = sum(v for k, v in parts.items() if key in k) if parts else None
        shown = "not measured" if split[label] is None else f"{split[label]:.4f} ms"
        print(f"{name8} part {label}: {shown} a call, bound "
              f"{part_bounds[label] * 1e3:.4f} ms")

    def library_bwd():
        xf, dof = x.float().reshape(-1, d), do.float().reshape(-1, d)
        mu = xf.mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(((xf - mu) ** 2).mean(dim=-1, keepdim=True) + 1e-6)
        xhat = (xf - mu) * rstd
        y = xhat * s + bb
        yq, ys = _quant_rows(torch, y)
        h_pre = (_int_mm(torch, yq, w1q) * ys * s1c + b1.float()).requires_grad_()
        with torch.enable_grad():
            h = F.gelu(h_pre, approximate="tanh")
        h16 = h.detach().to(bf16)
        dw2 = torch.matmul(do.reshape(-1, d).t(), h16)
        doq, dos = _quant_rows(torch, dof)
        dh = _int_mm(torch, doq, w2r) * dos * s2r
        (dh_pre,) = torch.autograd.grad(h, h_pre, dh)
        dw1 = torch.matmul(dh_pre.to(bf16).t(), y.to(bf16))
        dhq, dhs = _quant_rows(torch, dh_pre)
        dy = _int_mm(torch, dhq, w1r) * dhs * s1r
        dxhat = dy * s
        dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(-1, keepdim=True)) + dof
        return (dx.to(bf16), dw1, dh_pre.sum(0), dw2, dof.sum(0), (dy * xhat).sum(0),
                dy.sum(0))

    library_ms = int8_library_ms(name8, library_bwd)
    results[name8] = dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp_q_bwd.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:525",
        max_abs_err=err, rel_err=rel, code_flips=max(flips), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, int8_ops=6 * rows * d * hid, flops=4 * rows * d * hid,
        bytes=2 * 3 * rows * d + 3 * d * hid + 4 * (2 * hid + 3 * d) + 2 * hid
        + 4 * (2 * d * hid + hid + 3 * d), sub_ms=split,
    )
    epilogue_estimate(name8, "b8_element", rows * hid)
    return results


def check_flash_kernels(torch, F, core, heads=HEADS):
    """Phase 3, B5 and B6 (flash_attention_packed) against their plain
    versions at the grids the EViT path gives them (EVIT_GRIDS, B = 64,
    ``heads`` heads: 6 of 64, or 3 of 128 for the small_tpu preset; bf16),
    q, k and v as the thirds of one packed qkv tensor, as
    the model passes them. The last grid has no mask and no padded rows.
    Each output within KERNEL_REL_TOL, B5's lse within LSE_REL_TOL; B6's dk
    and dv exactly 0 on padded key rows, and two B6 calls on the same inputs
    equal bit for bit. Times are per call at each grid and summed over the
    three (one EViT forward's or step's work), beside the same sums for the
    bound, the plain version and the library call (SDPA; for B6 autograd
    through it), and printed beside B1's and B2's from ``core`` (the
    results of check_kernels and check_bwd_kernels), which run on the same
    flash core."""
    from diverse_channel_vit_torch.ops import attention as at

    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(2))
    dh, scale = D // heads, (D // heads) ** -0.5
    fname, bname = kernel_name("flash_packed_fwd", heads), kernel_name("flash_packed_bwd", heads)
    ap_f, ap_b = kernel_name("attend_project_fwd", heads), kernel_name("attend_project_bwd", heads)
    fwd = dict(source="diverse_channel_vit_torch/csrc/flash_packed.cu",
               replaces="diverse_channel_vit_tpu/ops/attention.py:243", grids=[])
    bwd = dict(source="diverse_channel_vit_torch/csrc/flash_packed_bwd.cu",
               replaces="diverse_channel_vit_tpu/ops/attention.py:297", grids=[])
    for n, n_valid in EVIT_GRIDS:
        label = f"N {n}, n_valid {n_valid}"
        qkv = rnd(B, n, 3 * D)
        q, k, v = qkv.split(D, dim=-1)
        do = rnd(B, n, D)
        o, lse = at.flash_packed_fwd(q, k, v, heads, scale, n_valid, need_lse=True)
        o_p, lse_p = at.flash_packed_fwd_plain(q, k, v, heads, scale, n_valid, need_lse=True)
        err_f, rel_f = hold(fname, label, (("o", o, o_p), ("lse", lse, lse_p)))
        rel_lse = ((lse - lse_p).abs().max() / lse_p.abs().max()).item()
        print(f"{fname} ({label}): lse rel {rel_lse:.3e} (tolerance rel <= "
              f"{LSE_REL_TOL})")
        if not rel_lse <= LSE_REL_TOL:
            raise AssertionError(f"{fname} ({label}): lse disagrees with its plain "
                                 "version")
        del o_p, lse_p
        got = at.flash_packed_bwd(q, k, v, o, do, lse, heads, scale, n_valid)
        want = at.flash_packed_bwd_plain(q, k, v, o, do, lse, heads, scale, n_valid)
        err_b, rel_b = hold(bname, label,
                            (("dq", got[0], want[0]), ("dk", got[1], want[1]),
                             ("dv", got[2], want[2])))
        pad = int(torch.count_nonzero(got[1][:, n_valid:])) + \
            int(torch.count_nonzero(got[2][:, n_valid:]))
        if pad:
            raise AssertionError(f"{bname} ({label}): padded key rows have dk or dv != 0")
        print(f"{bname} ({label}): dk and dv exactly 0 on the {n - n_valid} padded "
              "key rows")
        again = at.flash_packed_bwd(q, k, v, o, do, lse, heads, scale, n_valid)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{bname} ({label}): two calls on the same inputs "
                                 "differ")
        print(f"{bname} ({label}): two calls on the same inputs agree bit for bit")
        del got, want, again
        keep = (torch.arange(n, device="cuda") < n_valid)[None, None, None, :]
        heads_view = qkv.view(B, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        timing_f = dict(
            ms=cuda_ms(lambda: at.flash_packed_fwd(q, k, v, heads, scale, n_valid), 10),
            plain_ms=cuda_ms(lambda: at.flash_packed_fwd_plain(q, k, v, heads, scale, n_valid),
                             3, warmup=1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                *heads_view, attn_mask=keep), 10))
        timing_b = dict(
            ms=cuda_ms(lambda: at.flash_packed_bwd(q, k, v, o, do, lse, heads, scale, n_valid),
                       10),
            plain_ms=cuda_ms(lambda: at.flash_packed_bwd_plain(q, k, v, o, do, lse, heads, scale,
                                                               n_valid), 2, warmup=1))
        lq = qkv.detach().clone().requires_grad_()
        lib_out = F.scaled_dot_product_attention(
            *lq.view(B, n, 3, heads, dh).permute(2, 0, 3, 1, 4), attn_mask=keep)
        do_h = do.view(B, n, heads, dh).transpose(1, 2)
        timing_b["library_ms"] = cuda_ms(
            lambda: torch.autograd.grad(lib_out, lq, do_h, retain_graph=True), 10)
        del lib_out, lq
        rows = B * n_valid
        for entry, err, rel, timing, flops, nbytes in (
                (fwd, err_f, rel_f, timing_f, 4 * rows * n_valid * D, 2 * 4 * rows * D),
                (bwd, err_b, rel_b, timing_b, 10 * rows * n_valid * D,
                 2 * 8 * rows * D + 4 * rows * heads)):
            entry["grids"].append(dict(n=n, n_valid=n_valid, max_abs_err=err, rel_err=rel,
                                       flops=flops, bytes=nbytes, **timing,
                                       bound_ms=1e3 * max(flops / PEAK_BF16_FLOPS,
                                                          nbytes / PEAK_BYTES)))
        del qkv, q, k, v, o, lse, do
        torch.cuda.empty_cache()
    results = {}
    for name, entry in ((fname, fwd), (bname, bwd)):
        grids = entry.pop("grids")
        worst = max(grids, key=lambda g: g["rel_err"])
        entry.update(max_abs_err=worst["max_abs_err"], rel_err=worst["rel_err"],
                     **{key: sum(g[key] for g in grids)
                        for key in ("ms", "plain_ms", "library_ms", "flops", "bytes")},
                     per_grid=[{k: g[k] for k in ("n", "n_valid", "ms", "bound_ms", "plain_ms",
                                                  "library_ms")} for g in grids])
        results[name] = entry
    per_grid = {name: ", ".join(f"{g['ms']:.4f}" for g in results[name]["per_grid"])
                for name in results}
    print(f"flash core (flash_wgmma.cuh), head width {dh}: B1 {core[ap_f]['ms']:.4f} ms and B2 "
          f"{core[ap_b]['ms']:.4f} ms at N 1600; B5 {results[fname]['ms']:.4f} ms "
          f"({per_grid[fname]}) and B6 {results[bname]['ms']:.4f} ms ({per_grid[bname]}) over "
          "the EViT grids")
    return results


# the benchmark scripts' default geometry (scripts/bench_attn.py,
# scripts/bench_block_fusion.py: N = 1569 padded to a multiple of 128;
# scripts/bench_int8_lnmlp.py: N = 1600, every row real)
SCRIPT_N, INT8_N = 1664, 1600


def check_script_kernels(fb, torch, F, heads=HEADS):
    """Phase 3, the benchmark scripts' kernels at their scripts' default
    shapes, each against its plain version and its package sibling on the
    same inputs (the difference printed), S1 and S2 at ``heads`` heads (6
    of 64, or 3 of 128: ``bench_attn --heads 3`` and ``bench_block_fusion``
    at 3 heads), S3 with the default heads only:

    - S1 ``bwd_call`` (B = 64, N = 1664, n_valid = 1569): both schedules,
      every output, padded key rows exactly 0; ``pair_staged`` against
      ``pair_batched``, against B6 (``flash_packed_bwd``) given B5's lse on
      the same inputs, and against a second call must agree bit for bit.
      Library: autograd through SDPA on q, k and v, the backward timed.
    - S2 ``qkv_flash_fwd`` (the same grid): against B5 (``flash_packed_fwd``
      on the three views of the same qkv), bit for bit. Library: SDPA on the
      views.
    - S3 ``int8_ln_mlp`` (B = 64, N = 1600), B7's kernel launched through
      B7's wrapper: residual fused with biases at the residual's scale, then
      no residual and zero output bias; the hidden codes within
      MAX_CODE_FLIPS of the plain version's; against B7 (``ln_mlp_q_fwd``)
      on the same codes and scales, outputs and hidden codes bit for bit.
      Library: B7's composition with ``torch._int_mm``."""
    from diverse_channel_vit_torch.ops import attention as at
    from diverse_channel_vit_torch.scripts import bench_attn as s1
    from diverse_channel_vit_torch.scripts import bench_block_fusion as s2
    from diverse_channel_vit_torch.scripts import bench_int8_lnmlp as s3

    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(4))
    bf16, f32 = torch.bfloat16, torch.float32
    n, dh = SCRIPT_N, D // heads
    scale = dh ** -0.5
    rows = B * n  # every query row is computed and read
    keep = (torch.arange(n, device="cuda") < N_VALID)[None, None, None, :]
    results = {}
    s1name, s2name = kernel_name("bwd_call", heads), kernel_name("qkv_flash_fwd", heads)

    # --- S1 bwd_call
    q, k, v, o, do = (rnd(B, n, D) for _ in range(5))
    args = (q, k, v, o, do, heads, scale, N_VALID)
    want = s1.bwd_call_plain(*args)
    got, ms = {}, {}
    for variant in s1.VARIANTS:
        got[variant] = s1.bwd_call(*args, variant)
        worst = hold(s1name, variant, list(zip(("dq", "dk", "dv"), got[variant], want)))
        if variant == "pair_staged":
            err, rel = worst
        pad = sum(int(torch.count_nonzero(t[:, N_VALID:])) for t in got[variant][1:])
        if pad:
            raise AssertionError(f"{s1name} ({variant}): padded key rows have dk or dv != 0")
        ms[variant] = cuda_ms(lambda variant=variant: s1.bwd_call(*args, variant), 10)
    print(f"{s1name}: dk and dv exactly 0 on the {n - N_VALID} padded key rows")
    sibling = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got["pair_staged"], got["pair_batched"]))
    print(f"{s1name}: max |pair_staged - pair_batched| over dq, dk, dv: {sibling:.3e} "
          "(must be 0)")
    if sibling != 0.0:
        raise AssertionError(f"{s1name}: the two schedules disagree")
    # S1 = its statistics pass (B5's lse, recomputed) + B6's passes
    lse = at.flash_packed_fwd(q, k, v, heads, scale, N_VALID, need_lse=True)[1]
    b6 = at.flash_packed_bwd(q, k, v, o, do, lse, heads, scale, N_VALID)
    b6_diff = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got["pair_staged"], b6))
    b6_ms = cuda_ms(lambda: at.flash_packed_bwd(q, k, v, o, do, lse, heads, scale, N_VALID), 10)
    print(f"{s1name}: max |S1 - B6 given B5's lse| over dq, dk, dv: {b6_diff:.3e} (must be 0); "
          f"B6 {b6_ms:.4f} ms, S1 {ms['pair_staged']:.4f} ms")
    if b6_diff != 0.0:
        raise AssertionError(f"{s1name}: S1 disagrees with B6 given B5's lse")
    for variant in s1.VARIANTS:
        again = s1.bwd_call(*args, variant)
        if not all(torch.equal(a, b) for a, b in zip(got[variant], again)):
            raise AssertionError(f"{s1name} ({variant}): two calls on the same inputs differ")
    print(f"{s1name}: two calls on the same inputs agree bit for bit in both schedules")
    del got, want, lse, b6, again
    plain_ms = cuda_ms(lambda: s1.bwd_call_plain(*args), 2, warmup=1)
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    heads_view = [t.view(B, n, heads, dh).transpose(1, 2) for t in (lq, lk, lv)]
    lib_out = F.scaled_dot_product_attention(*heads_view, attn_mask=keep, scale=scale)
    do_h = do.view(B, n, heads, dh).transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do_h,
                                                     retain_graph=True), 10)
    del lib_out, lq, lk, lv, heads_view
    results[s1name] = dict(
        source="diverse_channel_vit_torch/csrc/bench_attn_bwd.cu",
        replaces="scripts/bench_attn.py:94",
        max_abs_err=err, rel_err=rel, ms=ms["pair_staged"], plain_ms=plain_ms,
        library_ms=library_ms, per_variant=ms, sibling_max_abs_diff=sibling,
        b6_max_abs_diff=b6_diff, sibling_ms=b6_ms,
        flops=10 * rows * N_VALID * D, bytes=2 * 8 * rows * D,
    )
    del q, k, v, o, do, args
    torch.cuda.empty_cache()

    # --- S2 qkv_flash_fwd
    qkv = rnd(B, n, 3 * D)
    out = s2.qkv_flash_fwd(qkv, heads, scale, N_VALID)
    err, rel = hold(s2name, "benchmark grid",
                    (("o", out, s2.qkv_flash_fwd_plain(qkv, heads, scale, N_VALID)),))
    views = qkv.split(D, dim=-1)
    b5 = at.flash_packed_fwd(*views, heads, scale, N_VALID)[0]
    sibling = (out.float() - b5.float()).abs().max().item()
    b5_ms = cuda_ms(lambda: at.flash_packed_fwd(*views, heads, scale, N_VALID), 10)
    ms = cuda_ms(lambda: s2.qkv_flash_fwd(qkv, heads, scale, N_VALID), 10)
    print(f"{s2name}: max |S2 - B5 (flash_packed_fwd)| on the same qkv {sibling:.3e} "
          f"(must be 0); B5 {b5_ms:.4f} ms, S2 {ms:.4f} ms")
    if sibling != 0.0:
        raise AssertionError(f"{s2name}: S2 disagrees with B5 on the same qkv")
    plain_ms = cuda_ms(lambda: s2.qkv_flash_fwd_plain(qkv, heads, scale, N_VALID), 3, warmup=1)
    heads_view = qkv.view(B, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads_view, attn_mask=keep), 10)
    results[s2name] = dict(
        source="diverse_channel_vit_torch/csrc/qkv_flash.cu",
        replaces="scripts/bench_block_fusion.py:121",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        sibling_max_abs_diff=sibling, sibling_ms=b5_ms,
        flops=4 * rows * N_VALID * D, bytes=2 * 4 * rows * D,
    )
    del qkv, out, b5, views, heads_view
    torch.cuda.empty_cache()

    if heads != HEADS:
        return results

    # --- S3 int8_ln_mlp
    rows = B * INT8_N
    x = rnd(B, INT8_N, D)
    s, bb = rnd(D, scale=0.1, dtype=f32) + 1.0, rnd(D, scale=0.1, dtype=f32)
    w1q, s1c = s3.quant_w(rnd(HID, D, scale=D ** -0.5))
    w2q, s2c = s3.quant_w(rnd(D, HID, scale=HID ** -0.5))
    b1, b2 = rnd(HID), rnd(D)
    fargs = (x, s, bb, w1q, s1c, b1, w2q, s2c, b2, True)
    flips = []
    for label, a in (("main path", fargs),
                     ("no residual, zero bias",
                      (x, s, bb, w1q, s1c, b1, w2q, s2c, torch.zeros_like(b2), False))):
        out, codes = s3.int8_ln_mlp(*a, with_codes=True)
        out_p, codes_p = s3.int8_ln_mlp_plain(*a, with_codes=True)
        worst = hold("int8_ln_mlp", label, (("out", out, out_p),))
        flips.append(code_flips("int8_ln_mlp", label, codes, codes_p))
        out7, codes7 = fb.ln_mlp_q_fwd(*a, with_codes=True)
        diff = (out.float() - out7.float()).abs().max().item()
        share = (codes != codes7).float().mean().item()
        print(f"int8_ln_mlp ({label}): against B7 (ln_mlp_q_fwd) on the same codes and scales: "
              f"max |out - out_B7| {diff:.3e}, hidden codes differing {share:.3e} (both must "
              "be 0: one kernel)")
        if diff != 0.0 or share != 0.0:
            raise AssertionError(f"int8_ln_mlp ({label}): S3 disagrees with B7")
        if label == "main path":
            (err, rel), sibling, sibling_codes = worst, diff, share
        del out, codes, out_p, codes_p, out7, codes7
    ms = cuda_ms(lambda: s3.int8_ln_mlp(*fargs), 10)
    b7_ms = cuda_ms(lambda: fb.ln_mlp_q_fwd(*fargs), 10)
    print(f"int8_ln_mlp: S3 {ms:.4f} ms, B7 {b7_ms:.4f} ms (one kernel)")
    plain_ms = cuda_ms(lambda: s3.int8_ln_mlp_plain(*fargs), 3, warmup=1)

    def library():
        xf = x.float()
        yq, ys = _quant_rows(torch, F.layer_norm(xf, (D,), s, bb, 1e-6))
        h = F.gelu(_int_mm(torch, yq, w1q) * ys * s1c + b1.float(), approximate="tanh")
        hq, hs = _quant_rows(torch, h)
        return (_int_mm(torch, hq, w2q) * hs * s2c + b2.float() + xf).to(bf16)

    library_ms = int8_library_ms("int8_ln_mlp", library)
    results["int8_ln_mlp"] = dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp_q.cu",
        replaces="scripts/bench_int8_lnmlp.py:39",
        max_abs_err=err, rel_err=rel, code_flips=max(flips), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, sibling_max_abs_diff=sibling, sibling_code_share=sibling_codes,
        sibling_ms=b7_ms, int8_ops=4 * rows * D * HID, flops=0,
        bytes=2 * 2 * rows * D + 2 * D * HID + 4 * (HID + D) + 2 * (HID + D) + 4 * 2 * D,
    )
    del x, fargs
    torch.cuda.empty_cache()
    return results


# which kernels each benchmark script run must launch: (module, argv or the
# keywords of its main, names); the last two runs are the small_tpu
# preset's head width, 3 heads of 128
SCRIPT_RUNS = (
    ("bench_attn", ["chain"], ("attend_project_fwd", "attend_project_bwd")),
    ("bench_attn", ["bwd-variants"], ("bwd_call",)),
    ("bench_attn", ["step"], ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd",
                              "ln_mlp_bwd")),
    ("bench_attn", ["small-k"], ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd",
                                 "ln_mlp_bwd")),
    ("bench_block_fusion", [], ("flash_packed_fwd", "flash_packed_bwd", "qkv_flash_fwd")),
    ("bench_int8_lnmlp", [], ("ln_mlp_fwd", "int8_ln_mlp")),
    ("bench_attn", ["bwd-variants", "--heads", str(HEADS_TPU)], ("bwd_call",)),
    ("bench_block_fusion", {"heads": HEADS_TPU},
     ("flash_packed_fwd", "flash_packed_bwd", "qkv_flash_fwd")),
)


def script_label(name: str, args) -> str:
    """How a run of SCRIPT_RUNS is called: its command line, or its main's
    call for a keyword that the script takes in Python only."""
    if isinstance(args, dict):
        kw = ", ".join(f"{k}={v}" for k, v in args.items())
        return f"diverse_channel_vit_torch.scripts.{name}.main({kw})"
    return " ".join(["python -m", f"diverse_channel_vit_torch.scripts.{name}", *args])


def run_geometries(fb, torch, want: dict) -> dict:
    """The port's geometry smoke (``scripts/smoke_geometries.py``) through
    its ``main``, as ``python -m`` runs it: the JAX script's five geometries,
    1 + 5 train steps each at its batch size, every loss finite (the script
    asserts it). Per geometry its launch counts, ``want`` per step (the port
    pads every token grid to a multiple of 64, So2Sat's 289 tokens to 320, so
    every geometry takes the fused route), and its phase line. Returns the
    paths by label."""
    from diverse_channel_vit_torch.scripts import smoke_geometries as sg

    fb.reset_launches()
    results = sg.main(device="cuda")
    paths = {}
    for tag, _ in sg.GEOMETRIES:
        r = results[tag]
        check_counts(f"geometry {tag}", r["launches"], r["steps"], "step", want)
        print(f"phase geometry {tag}: {r['imgs_per_s']:.2f} images/s, mean "
              f"{r['ms_per_step']:.3f} ms a step over {r['steps'] - 1} steps, peak memory "
              f"{r['peak_mem_gb']:.3f} GB; card {card_line()}")
        paths[f"geometry {tag}"] = (r["launches"], r["steps"], "step")
    torch.cuda.empty_cache()
    return paths


def run_scripts(fb):
    """Phase 8: each benchmark script through its entry point (``main``, what
    ``python -m diverse_channel_vit_torch.scripts.<name>`` calls) at its
    defaults and at 3 heads of 128 (SCRIPT_RUNS), its output echoed; the
    counts set to 0 just before each run and read just after, and each
    kernel the run exists for launched at least once. An exception ends the
    smoke run. Returns the counts by run."""
    import importlib

    counts = {}
    for name, args, names in SCRIPT_RUNS:
        label = script_label(name, args)
        mod = importlib.import_module(f"diverse_channel_vit_torch.scripts.{name}")
        print(f"== {label}", flush=True)
        t = time.perf_counter()
        fb.reset_launches()
        if isinstance(args, dict):
            mod.main(**args)
        elif args:
            mod.main(args)
        else:
            mod.main()
        launches = {k: c for k, c in fb.LAUNCHES.items() if c}
        print(f"== {label}: {time.perf_counter() - t:.1f} s; kernel launches {launches}",
              flush=True)
        missing = [k for k in names if not launches.get(k)]
        if missing:
            raise AssertionError(f"{label}: {missing} launched no time")
        counts[label] = launches
    return counts


def phase_line(label: str, imgs_per_s: float, p50_ms: float, torch) -> None:
    """A path's images/s and p50 ms beside the peak device memory since the
    path reset it and the card it ran on."""
    print(f"phase {label}: {imgs_per_s:.2f} images/s, p50 {p50_ms:.3f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; card {card_line()}")


def post_npy(port: int, image: np.ndarray, cids) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, image)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=buf.getvalue(), method="POST",
        headers={"Content-Type": "application/x-npy", "X-Channels": ",".join(map(str, cids))},
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.load(io.BytesIO(resp.read()), allow_pickle=False)


def get_json(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.loads(resp.read())


def profile_call(fn, label: str, torch):
    """Device time by kernel over one call of ``fn``, and the device's busy
    share of its wall time: the 16 largest items, then every other kernel of
    the port (``dcvit::``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", 0) or 0
        if dev > 0 and getattr(e, "device_type", None) != torch.autograd.DeviceType.CPU:
            rows.append((dev, e.key, e.count))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"profile of {label}: the profiler recorded no device time; breakdown not measured")
        return
    rows.sort(reverse=True)
    print(f"profile of {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%)")
    for i, (dev, key, count) in enumerate(rows):
        if i < 16 or "dcvit::" in key:
            print(f"  {100 * dev / busy:5.1f}%  {dev / 1e3:8.3f} ms  x{count:<4d} {key[:90]}")


def model_config(depth: int, **extra):
    from diverse_channel_vit_torch.config import Config

    return Config({
        "in_channel_names": [f"ch{i}" for i in range(CHANNELS)], "img_size": [IMG],
        "patch_size": PATCH, "pretrained_model_name": "small", "depth": depth,
        "proxy_loss_lambda": 1e-3, "ortho_loss_v1_lambda": 1e-3, "gamma_s": 1.0,
        "gamma_d": 4.0, **extra,
    })


def build(depth: int, **extra):
    """DiChaViT-S on the card, random weights from seed 0, bf16 compute."""
    import torch

    from diverse_channel_vit_torch.models import build_model

    return build_model("dichavit", model_config(depth, **extra),
                       {"JUMP-CP": list(range(CHANNELS))}, CLASSES, device="cuda",
                       dtype=torch.bfloat16, seed=0)


def check_counts(label: str, launches: dict, units: int, unit: str, want: dict) -> None:
    """Raise unless every kernel launched ``want[name]`` times per ``unit``
    (0 for a kernel ``want`` does not name) over ``units`` of them."""
    for name, count in launches.items():
        per = want.get(name, 0)
        if units == 0 or count != per * units:
            raise AssertionError(f"{label}: {name} launched {count} times in {units} {unit}s, "
                                 f"want {per} per {unit}")
    print(f"{label}: kernel launches {launches} in {units} {unit}s, as expected")


def evit_blocks(model):
    blocks = model.feature_extractor.blocks
    depth = len(blocks)
    return [blocks[i] for i in sorted({depth // 4, depth // 2, (3 * depth) // 4})]


def kept_differences(own, ref, forced: bool) -> list:
    """Per EViT layer, how many tokens of the unpruned grid that ``own``
    kept ``ref`` did not, summed over the images. Each entry is a (B, keep)
    index tensor into the grid the layer before left. With ``forced`` the
    ``own`` route kept ``ref``'s tokens at every layer (its indices are its
    own choice on ``ref``'s grids); otherwise each route's grids follow its
    own choices."""
    out, ids_own, ids_ref = [], None, None
    for a, b in zip(own, ref):
        base = ids_ref if forced else ids_own
        a = a if base is None else base.gather(1, a)
        b = b if ids_ref is None else ids_ref.gather(1, b)
        out.append(int(sum(a.shape[1] - len(set(x.tolist()) & set(y.tolist()))
                           for x, y in zip(a.cpu(), b.cpu()))))
        ids_own, ids_ref = a, b
    return out



def logits_close(label: str, got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if not np.isfinite(got).all():
        raise AssertionError(f"{label}: logits not finite")
    err = float(np.abs(got - want).max())
    rel = err / float(np.abs(want).max())
    print(f"{label}: max_abs_err {err:.3e} rel {rel:.3e} (tolerance rel <= {LOGITS_REL_TOL})")
    if not rel <= LOGITS_REL_TOL:
        raise AssertionError(f"{label}: kernel route disagrees with the plain route")
    return rel


def serve(fb, torch, label: str = "serving", **extra):
    """Phase 4: full-width DiChaViT-S (or with ``extra`` another preset of
    the same width) through the serving entry points."""
    from diverse_channel_vit_torch.serving import ServingEngine
    from diverse_channel_vit_torch.serving_http import ServingHTTPServer

    model = build(DEPTH, **extra)
    engine = ServingEngine(model, buckets=BUCKETS, device="cuda")
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    full, sub = list(range(CHANNELS)), [0, 3, 5]

    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    engine.n_forwards = 0
    t0 = time.perf_counter()
    engine.warmup(full, (IMG, IMG))
    out64 = engine.predict(imgs, full)
    out3 = engine.predict(imgs[:3], full)
    out_sub = engine.predict(np.ascontiguousarray(imgs[:4, sub]), sub)
    engine.start()
    futs = [engine.submit(imgs[i], full) for i in range(5)]
    out_submit = np.stack([f.result(timeout=300) for f in futs])
    server = ServingHTTPServer(engine, port=0).start()
    try:
        out_http = post_npy(server.port, imgs[7], full)
        health = get_json(server.port, "/healthz")
        stats = get_json(server.port, "/v1/stats")
    finally:
        server.stop()
    timings = {}
    for bucket in BUCKETS:
        reps = 8 if bucket == 64 else 20
        lats = []
        for _ in range(reps):
            t = time.perf_counter()
            engine.predict(imgs[:bucket], full)
            lats.append(time.perf_counter() - t)
        lats = np.sort(np.asarray(lats))
        timings[bucket] = {
            "imgs_per_s": bucket * reps / float(lats.sum()),
            "p50_ms": float(np.percentile(lats, 50)) * 1e3,
            "p99_ms": float(np.percentile(lats, 99)) * 1e3,
            "reps": reps,
        }
    profile_call(lambda: engine.predict(imgs, full), "one 64-image predict", torch)
    launches, forwards = dict(fb.LAUNCHES), engine.n_forwards
    print(f"main path: {forwards} forwards in {time.perf_counter() - t0:.1f} s; "
          f"health {health}; stats {stats}")
    # blocks 0-10 fused, block 11 the CLS readout; no flash_packed, no backward
    check_counts(label, launches, forwards, "forward",
                 {"attend_project_fwd": DEPTH - 1, "ln_mlp_fwd": DEPTH - 1})

    outs = {"predict64": out64, "predict3": out3, "predict_subset": out_sub,
            "submit": out_submit, "http": out_http}
    for key, val in outs.items():
        if not np.isfinite(val).all():
            raise AssertionError(f"{key}: logits not finite")
    if out64.shape != (B, CLASSES) or out_sub.shape != (4, CLASSES) or out_http.shape != (CLASSES,):
        raise AssertionError("unexpected logits shape")
    # the same images through other buckets and entry points agree
    scale = np.abs(out64).max()
    for key, got, want in (("predict3", out3, out64[:3]), ("submit", out_submit, out64[:5]),
                           ("http", out_http, out64[7])):
        rel = np.abs(got - want).max() / scale
        print(f"{key} vs the 64-bucket rows: rel {rel:.3e} (tolerance {KERNEL_REL_TOL})")
        if rel > KERNEL_REL_TOL:
            raise AssertionError(f"{key} disagrees with the same images in the 64 bucket")

    # the same model through the plain versions, on the card
    with fb.plain_versions(), torch.inference_mode():
        cid = torch.arange(CHANNELS, device="cuda")
        ref = model(torch.from_numpy(imgs).cuda().to(torch.bfloat16), cid)[0].float().cpu().numpy()
        cid_sub = torch.tensor(sub, device="cuda")
        ref_sub = model(torch.from_numpy(np.ascontiguousarray(imgs[:4, sub])).cuda()
                        .to(torch.bfloat16), cid_sub)[0].float().cpu().numpy()
    if dict(fb.LAUNCHES) != launches:
        raise AssertionError("the plain run launched a kernel")
    for key, got, want in (("predict64", out64, ref), ("predict_subset", out_sub, ref_sub)):
        logits_close(f"logits {key} vs plain versions on the card", got, want)
    engine.stop()
    print(f"{label} " + json.dumps({"buckets": timings}))
    phase_line(f"{label}, bucket 64", timings[64]["imgs_per_s"], timings[64]["p50_ms"], torch)
    del model, engine
    return launches, forwards


def serve_int8(fb, torch, label: str = "int8 serving", **extra):
    """Phase 4d: int8 serving of DiChaViT-S (or with ``extra`` another
    preset, such as the base one). One bf16 model behind two engines:
    ``ServingEngine(quantization="int8")`` serves buckets 1-64 through
    ``predict``, ``submit`` and ``ServingHTTPServer``, the counts set to 0
    just before and read just after (per forward B7 and B1 x 11, no B3);
    then a 64-image ``predict`` of the unquantised engine on the same model
    must launch B3 x 11 and no B7, and give other logits. The int8 logits are
    held against the plain route on the card."""
    from diverse_channel_vit_torch.serving import ServingEngine
    from diverse_channel_vit_torch.serving_http import ServingHTTPServer

    model = build(DEPTH, **extra)
    engine = ServingEngine(model, buckets=BUCKETS, device="cuda", quantization="int8")
    dense_engine = ServingEngine(model, buckets=BUCKETS, device="cuda")
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    full = list(range(CHANNELS))

    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    engine.n_forwards = 0
    engine.warmup(full, (IMG, IMG))
    out64 = engine.predict(imgs, full)
    engine.start()
    out_submit = np.stack([f.result(timeout=300)
                           for f in [engine.submit(imgs[i], full) for i in range(5)]])
    server = ServingHTTPServer(engine, port=0).start()
    try:
        out_http = post_npy(server.port, imgs[7], full)
    finally:
        server.stop()
        engine.stop()
    timings = {}
    for bucket in BUCKETS:
        reps = 8 if bucket == 64 else 20
        lats = []
        for _ in range(reps):
            t = time.perf_counter()
            engine.predict(imgs[:bucket], full)
            lats.append(time.perf_counter() - t)
        lats = np.sort(np.asarray(lats))
        timings[bucket] = {"imgs_per_s": bucket * reps / float(lats.sum()),
                           "p50_ms": float(np.percentile(lats, 50)) * 1e3,
                           "p99_ms": float(np.percentile(lats, 99)) * 1e3, "reps": reps}
    launches, forwards = dict(fb.LAUNCHES), engine.n_forwards
    check_counts(label, launches, forwards, "forward",
                 {"attend_project_fwd": DEPTH - 1, "ln_mlp_q_fwd": DEPTH - 1})
    # peak memory of the int8 engine's own forwards (the checks below add more)
    phase_line(f"{label}, bucket 64", timings[64]["imgs_per_s"], timings[64]["p50_ms"], torch)
    profile_call(lambda: engine.predict(imgs, full), f"one 64-image predict ({label})", torch)

    fb.reset_launches()
    dense_engine.n_forwards = 0
    dense = dense_engine.predict(imgs, full)
    check_counts(f"bf16 serving beside {label}", dict(fb.LAUNCHES), dense_engine.n_forwards,
                 "forward", {"attend_project_fwd": DEPTH - 1, "ln_mlp_fwd": DEPTH - 1})
    if {blk.quantization for blk in model.feature_extractor.blocks} != {"none"}:
        raise AssertionError("the int8 engine changed the model's own quantization")
    for key, val in (("predict64", out64), ("submit", out_submit), ("http", out_http)):
        if not np.isfinite(val).all():
            raise AssertionError(f"{label} {key}: logits not finite")
    if out64.shape != (B, CLASSES) or out_http.shape != (CLASSES,):
        raise AssertionError(f"unexpected {label} logits shape")
    scale = np.abs(out64).max()
    for key, got, want in (("submit", out_submit, out64[:5]), ("http", out_http, out64[7])):
        rel = np.abs(got - want).max() / scale
        print(f"{label} {key} vs the 64-bucket rows: rel {rel:.3e} (tolerance {KERNEL_REL_TOL})")
        if rel > KERNEL_REL_TOL:
            raise AssertionError(f"{label} {key} disagrees with the same images in the 64 bucket")
    moved = float(np.abs(out64 - dense).max() / np.abs(dense).max())
    print(f"{label} logits vs the bf16 engine's: rel {moved:.3e} (must differ)")
    if moved == 0.0:
        raise AssertionError(f"{label}: the int8 engine's logits equal the bf16 engine's")
    with fb.plain_versions(), fb.quantization("int8"), torch.inference_mode():
        ref = model(torch.from_numpy(imgs).cuda().to(torch.bfloat16),
                    torch.arange(CHANNELS, device="cuda"))[0].float().cpu().numpy()
    logits_close(f"{label} logits vs plain versions on the card", out64, ref)
    print(f"{label} " + json.dumps({"buckets": timings}))
    del model, engine, dense_engine
    torch.cuda.empty_cache()
    return launches, forwards, timings


def serve_evit(fb, torch):
    """Phase 4b: EViT-pruned DiChaViT-S (keep_rate 0.7) through
    ``ServingEngine`` and one HTTP request, the counts set to 0 just before
    and read just after: per forward B5 at the three pruning layers and B1 /
    B3 at the other eight non-readout blocks. The HTTP request (bucket 1)
    keeps the tokens the 64-image forward kept for its image, so the two can
    be held together; then the logits against the plain route on the card,
    the kernel route keeping the plain route's tokens. How many tokens each
    route would keep of its own accord is printed beside."""
    from diverse_channel_vit_torch.serving import ServingEngine
    from diverse_channel_vit_torch.serving_http import ServingHTTPServer

    model = build(DEPTH, keep_rate=KEEP_RATE)
    blocks = evit_blocks(model)
    engine = ServingEngine(model, buckets=BUCKETS, device="cuda")
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    full = list(range(CHANNELS))

    fb.reset_launches()
    engine.n_forwards = 0
    out64 = engine.predict(imgs, full)
    kept64 = [blk.evit_kept.clone() for blk in blocks]
    lats = []
    for _ in range(8):
        t = time.perf_counter()
        engine.predict(imgs, full)
        lats.append(time.perf_counter() - t)
    engine.start()
    server = ServingHTTPServer(engine, port=0).start()
    try:
        for blk, idx in zip(blocks, kept64):
            blk.evit_forced = idx[7:8]
        out_http = post_npy(server.port, imgs[7], full)
        own_http = [blk.evit_kept.clone() for blk in blocks]
    finally:
        server.stop()
        engine.stop()
        for blk in blocks:
            blk.evit_forced = None
    launches, forwards = dict(fb.LAUNCHES), engine.n_forwards
    check_counts("EViT serving", launches, forwards, "forward",
                 {"attend_project_fwd": DEPTH - 4, "ln_mlp_fwd": DEPTH - 4,
                  "flash_packed_fwd": 3})
    print(f"EViT serving: kept tokens per pruning layer {[k.shape[1] for k in kept64]}; "
          f"bucket 1 would keep otherwise "
          f"{kept_differences(own_http, [k[7:8] for k in kept64], forced=True)}"
          " tokens of image 7")
    lats = np.sort(np.asarray(lats))
    timing = {"imgs_per_s": B * len(lats) / float(lats.sum()),
              "p50_ms": float(np.percentile(lats, 50)) * 1e3, "reps": len(lats)}
    print("EViT serving bucket 64 " + json.dumps(timing))
    profile_call(lambda: engine.predict(imgs, full), "one 64-image EViT predict", torch)
    if out64.shape != (B, CLASSES) or out_http.shape != (CLASSES,):
        raise AssertionError("unexpected logits shape")
    rel = np.abs(out_http - out64[7]).max() / np.abs(out64).max()
    print(f"EViT http vs the 64-bucket row, same kept tokens: rel {rel:.3e} "
          f"(tolerance {KERNEL_REL_TOL})")
    if not rel <= KERNEL_REL_TOL:
        raise AssertionError("EViT http disagrees with the same image in the 64 bucket")

    x = torch.from_numpy(imgs).cuda().to(torch.bfloat16)
    cid = torch.arange(CHANNELS, device="cuda")
    with fb.plain_versions(), torch.inference_mode():
        ref = model(x, cid)[0].float().cpu().numpy()
    kept_plain = [blk.evit_kept.clone() for blk in blocks]
    print(f"EViT serving: the 64-image predict kept "
          f"{kept_differences(kept64, kept_plain, forced=False)} tokens per pruning layer that "
          "the plain route did not")
    for blk, idx in zip(blocks, kept_plain):
        blk.evit_forced = idx
    with torch.inference_mode():
        got = model(x, cid)[0].float().cpu().numpy()
    for blk in blocks:
        blk.evit_forced = None
    logits_close("EViT logits vs plain versions on the card, same kept tokens", got, ref)
    del model, engine
    torch.cuda.empty_cache()
    return launches, forwards, timing


def serve_gelu_exact(fb, torch):
    """Phase 4c: DiChaViT-S with ``gelu_exact`` at full width, one 64-image
    ``predict``: every non-readout block takes the unfused route (B5 x 11,
    no B1 / B3); a profile of a second predict; the logits against the plain
    route on the card."""
    from diverse_channel_vit_torch.serving import ServingEngine

    model = build(DEPTH, gelu_exact=True)
    engine = ServingEngine(model, buckets=BUCKETS, device="cuda")
    imgs = np.random.default_rng(0).standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    engine.predict(imgs[:1], list(range(CHANNELS)))  # first use, outside the count
    fb.reset_launches()
    engine.n_forwards = 0
    t = time.perf_counter()
    out = engine.predict(imgs, list(range(CHANNELS)))
    secs = time.perf_counter() - t
    launches, forwards = dict(fb.LAUNCHES), engine.n_forwards
    check_counts("gelu_exact serving", launches, forwards, "forward",
                 {"flash_packed_fwd": DEPTH - 1})
    print(f"gelu_exact serving: one 64-image predict {secs * 1e3:.2f} ms")
    profile_call(lambda: engine.predict(imgs, list(range(CHANNELS))),
                 "one 64-image gelu_exact predict", torch)
    with fb.plain_versions(), torch.inference_mode():
        ref = model(torch.from_numpy(imgs).cuda().to(torch.bfloat16),
                    torch.arange(CHANNELS, device="cuda"))[0].float().cpu().numpy()
    logits_close("gelu_exact logits vs plain versions on the card", out, ref)
    del model, engine
    torch.cuda.empty_cache()
    return launches, forwards


def recipe_ks(n_draws: int = 48) -> list:
    """The JAX benchmark's k mixture of the DCS recipe (``bench.py:137``
    ``_recipe_ks``): k ~ U[1, 8] from numpy's ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [int(rng.integers(1, CHANNELS + 1)) for _ in range(n_draws)]


def train_setup(depth: int, torch, ks=None, **extra):
    """Model, train state and steps as a user builds them: DiChaViT-S with
    f32 parameters from seed 0 and bf16 compute; AdamW with the JUMP-CP
    weight-decay schedule (optimizer/adamw_jumpcp.yaml) under the cosine lr
    schedule (scheduler/cosine.yaml); CE + CDL + TDL with
    extra_loss_lambda = 1. ``steps[i % len(steps)]`` is step i's function:
    one all-channel step, or with ``ks`` the DCS recipe's step for k = ks[i]
    (``HCS_METHOD`` at ``HCS_TEMP``, one step function per distinct k, all
    drawing from one generator seeded with 0 on the card)."""
    from diverse_channel_vit_torch.training import (
        TrainState, make_lr_schedule, make_optimizer, make_train_step)

    model = build(depth, **extra)
    lr = make_lr_schedule("cosine", 2.5e-4, dict(
        t_initial="FILL_LATER", lr_min=1e-6, cycle_mul=1.0, cycle_decay=0.5, cycle_limit=1,
        warmup_t=3, warmup_lr_init=1e-5, warmup_prefix=False, t_in_epochs=True, k_decay=1.0,
    ), num_epochs=100, steps_per_epoch=100)
    tx = make_optimizer("adamw", dict(lr=2.5e-4, betas=[0.9, 0.999], eps=1e-6,
                                      weight_decay=0.04, weight_decay_end=0.4, amsgrad=False),
                        lr_schedule=lr, total_steps=10_000)
    state = TrainState(model, tx)
    kw = dict(channel_ids=range(CHANNELS), loss_type="ce", extra_loss_lambda=1.0)
    if ks is None:
        return model, state, [make_train_step(model, **kw)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    by_k = {k: make_train_step(model, k=k, hcs_method=HCS_METHOD, hcs_temp=HCS_TEMP,
                               generator=gen, **kw) for k in sorted(set(ks))}
    return model, state, [by_k[k] for k in ks]


def synthetic_batch(torch):
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    labels = rng.integers(0, CLASSES, size=B)
    return {"image": torch.from_numpy(imgs).cuda(), "label": torch.from_numpy(labels).cuda()}


def train(fb, torch, label: str, want: dict, **extra):
    """The DiChaViT-S train step on the card at full width: counts set to 0
    just before 2 warm-up and 10 timed steps and read just after, each kernel
    ``want[name]`` launches per step; then one profiled step."""
    batch = synthetic_batch(torch)
    model, state, (step,) = train_setup(DEPTH, torch, **extra)
    n_params = sum(p.numel() for p in model.parameters())
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("the model's parameters are not f32")
    warm, timed = 2, 10
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    lats, losses = [], []
    for i in range(warm + timed):
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        if i >= warm:
            lats.append(time.perf_counter() - t)
        losses.append({k: float(v) for k, v in m.items()})
    launches, steps = dict(fb.LAUNCHES), warm + timed
    check_counts(label, launches, steps, "step", want)
    for i, m in enumerate(losses):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label} step {i}: non-finite metrics {m}")
    print(f"{label} metrics, step 0: {json.dumps(losses[0])}; step {steps - 1}: "
          f"{json.dumps(losses[-1])}")
    lats = np.asarray(lats)
    timing = {"imgs_per_s": B * timed / float(lats.sum()),
              "p50_ms": float(np.percentile(lats, 50)) * 1e3,
              "min_ms": float(lats.min()) * 1e3, "max_ms": float(lats.max()) * 1e3,
              "steps": timed, "batch": B, "params": n_params,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{label} " + json.dumps(timing))
    phase_line(label, timing["imgs_per_s"], timing["p50_ms"], torch)
    profile_call(lambda: step(state, batch), f"one {label} step (64 images)", torch)
    del model, state, step
    torch.cuda.empty_cache()
    return launches, steps, timing


def train_recipe(fb, torch, want: dict, label: str = "DCS recipe train", **extra):
    """The DCS recipe at full width: B = 64, k drawn per step from the JAX
    benchmark's 48-draw mixture, one step function per k over one train
    state (``extra``: model config keys, such as another preset or EViT's
    keep_rate). Each distinct k is warmed once and that pass discarded (a
    fresh shape's first pass runs slow); then counts set to 0 just before
    the 48 timed steps and read just after, each kernel ``want[name]``
    launches per step, whatever k. The p50 step is the median interval
    between CUDA events recorded after each step (no host synchronisation
    inside the timed run)."""
    batch = synthetic_batch(torch)
    ks = recipe_ks()
    model, state, steps = train_setup(DEPTH, torch, ks=ks, **extra)
    first = {}
    for i, k in enumerate(ks):
        first.setdefault(k, i)
    for k, i in sorted(first.items()):
        state, m = steps[i](state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(ks) + 1)]
    t = time.perf_counter()
    events[0].record()
    metrics = []
    for i in range(len(ks)):
        state, m = steps[i](state, batch)
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    launches = dict(fb.LAUNCHES)
    check_counts(label, launches, len(ks), "step", want)
    sampled = [m["sampled_channels"].tolist() if "sampled_channels" in m else "all"
               for m in metrics[:6]]
    losses = [float(m["loss"]) for m in metrics]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: non-finite losses {losses}")
    for k, m in zip(ks, metrics):
        got = len(m["sampled_channels"]) if "sampled_channels" in m else CHANNELS
        if got != k:
            raise AssertionError(f"{label}: a k = {k} step trained on {got} channels")
    timing = {"imgs_per_s": B * len(ks) / secs, "steps": len(ks), "batch": B,
              "mean_k": float(np.mean(ks)), "secs": secs,
              "p50_ms": float(np.percentile(step_ms, 50)),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{label}: k of the first steps {ks[:6]}, channels drawn {sampled}; "
          f"losses {losses[0]:.4f} .. {losses[-1]:.4f}")
    print(f"{label} " + json.dumps(timing))
    phase_line(label, timing["imgs_per_s"], timing["p50_ms"], torch)
    del model, state, steps
    torch.cuda.empty_cache()
    return launches, len(ks), timing


def train_parity(fb, torch, label: str, depth: int, n_steps: int, want: dict, ks=None,
                 **extra):
    """Kernel route against plain route from the same weights: ``n_steps``
    steps at ``depth`` (with ``ks``, the recipe's steps at those k, both
    routes drawing from generators of the same seed), losses within
    TRAIN_LOSS_REL_TOL and step-0 gradients within TRAIN_GRAD_REL_TOL of
    max|g|, the channels drawn equal. The plain route runs first; its EViT
    blocks' kept tokens are forced on the kernel route step by step
    (near-equal CLS scores may otherwise keep another boundary token), and
    how many tokens the kernel route would have kept otherwise is printed."""
    batch = synthetic_batch(torch)
    runs = {}
    for route in ("plain", "kernels"):
        model, state, steps = train_setup(depth, torch, ks=ks, **extra)
        blocks = evit_blocks(model) if extra.get("keep_rate") else []
        before = dict(fb.LAUNCHES)
        ctx = fb.plain_versions() if route == "plain" else contextlib.nullcontext()
        route_losses, grads0, kept, flips, drawn = [], None, [], [], []
        with ctx:
            for i in range(n_steps):
                if route == "kernels":
                    for blk, idx in zip(blocks, runs["plain"][3][i]):
                        blk.evit_forced = idx
                state, m = steps[i % len(steps)](state, batch)
                route_losses.append(float(m["loss"]))
                drawn.append(m["sampled_channels"].tolist() if "sampled_channels" in m else None)
                kept.append([blk.evit_kept.clone() for blk in blocks])
                if route == "kernels":
                    flips.append(kept_differences(kept[-1], runs["plain"][3][i], forced=True))
                if i == 0:
                    grads0 = {n: p.grad.float().clone() for n, p in model.named_parameters()}
        torch.cuda.synchronize()
        counts = {k: fb.LAUNCHES[k] - before[k] for k in before}
        runs[route] = (route_losses, grads0, counts, kept, flips, drawn)
        del model, state, steps
        torch.cuda.empty_cache()
    (lk, gk, nk, _, flips, dk), (lp, gp, np_, _, _, dp) = runs["kernels"], runs["plain"]
    if any(np_.values()):
        raise AssertionError(f"{label}: the plain training run launched kernels: {np_}")
    check_counts(f"{label}, kernel route", nk, n_steps, "step", want)
    if extra.get("keep_rate"):
        print(f"{label}: tokens the kernel route would have kept otherwise, per step and "
              f"EViT layer, of {B} images: {flips}")
    if ks is not None:
        print(f"{label}: channels drawn per step, kernel route {dk}, plain route {dp}")
        if dk != dp:
            raise AssertionError(f"{label}: the two routes drew other channels")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    print(f"{label} (depth {depth}, {n_steps} steps): losses kernels {lk} plain {lp}, "
          f"max rel {loss_rel:.3e} (tolerance {TRAIN_LOSS_REL_TOL})")
    if not loss_rel <= TRAIN_LOSS_REL_TOL:
        raise AssertionError(f"{label}: losses of the kernel and plain routes disagree")
    worst = (0.0, "")
    for name, g in gk.items():
        ref = gp[name]
        scale = ref.abs().max().item()
        rel = (g - ref).abs().max().item() / scale if scale else (g - ref).abs().max().item()
        worst = max(worst, (rel, name))
    print(f"{label}: step-0 gradients of {len(gk)} parameter tensors, worst rel "
          f"{worst[0]:.3e} ({worst[1]}) (tolerance {TRAIN_GRAD_REL_TOL} of max|g|)")
    if not worst[0] <= TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"{label}: gradient of {worst[1]} disagrees")


def main() -> int:
    import torch
    import torch.nn.functional as F

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diverse_channel_vit_torch.ops import fused_block as fb
    from diverse_channel_vit_torch.ops import kernels

    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")

    secs = kernels.build()
    print(f"kernel build: {secs:.1f} s")
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # the wgmma core's kernels: their registers, spills, stack frames and
    # ptxas notes (C75xx: wgmma serialised, setmaxnreg ignored)
    for name in ("attend_project", "attend_project_bwd", "flash_packed", "flash_packed_bwd",
                 "bench_attn_bwd", "qkv_flash", "ln_mlp", "ln_mlp_bwd", "ln_mlp_q",
                 "ln_mlp_q_bwd"):
        for line in kernels.BUILD_LOG.get(name, "").splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "stack frame", "C75")):
                print(f"  ptxas {name}: {line.strip()}")

    results = check_kernels(fb, torch, F)
    results.update(check_bwd_kernels(fb, torch, F))
    results.update(check_flash_kernels(torch, F, results))
    results.update(check_q_kernels(fb, torch, F, kernels))
    results.update(check_script_kernels(fb, torch, F))
    # the attention kernels at head width 128: the small_tpu preset's 3 heads
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(10))
    results[kernel_name("attend_project_fwd", HEADS_TPU)] = check_attend_project_fwd(
        fb, torch, F, HEADS_TPU, rnd)
    results[kernel_name("attend_project_bwd", HEADS_TPU)] = check_attend_project_bwd(
        fb, torch, F, HEADS_TPU, rnd)
    results.update(check_flash_kernels(torch, F, results, HEADS_TPU))
    results.update(check_script_kernels(fb, torch, F, HEADS_TPU))
    # the base preset's widths: B3 and B4 at D = 768 (a cluster of two blocks
    # per 64 rows), B1 and B2 with 12 heads of 64
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(12))
    results[width_name("ln_mlp_fwd", D_BASE)] = check_ln_mlp_fwd(fb, torch, F, rnd, D_BASE,
                                                                HID_BASE)
    results[width_name("ln_mlp_bwd", D_BASE)] = check_ln_mlp_bwd(fb, torch, F, rnd, D_BASE,
                                                                HID_BASE)
    results[kernel_name("attend_project_fwd", HEADS_BASE, D_BASE)] = check_attend_project_fwd(
        fb, torch, F, HEADS_BASE, rnd, D_BASE)
    results[kernel_name("attend_project_bwd", HEADS_BASE, D_BASE)] = check_attend_project_bwd(
        fb, torch, F, HEADS_BASE, rnd, D_BASE)
    # B7 and B8 at D = 768 (a cluster of two blocks per 64 rows each)
    results.update(check_q_kernels(fb, torch, F, kernels, D_BASE, HID_BASE, seed=13))
    for name, r in results.items():
        # each product at the unit that runs it: bf16 FLOPs and int8 operations
        t_ops = r.pop("flops") / PEAK_BF16_FLOPS + r.pop("int8_ops", 0) / PEAK_INT8_OPS
        t_bytes = r.pop("bytes") / PEAK_BYTES
        r["bound_ms"] = max(t_ops, t_bytes) * 1e3
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        lib = "not measured" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()

    # each path: the counts by kernel and the units (forwards or steps) they
    # were read over; the kernels line takes each kernel's launches from its
    # main paths
    paths = {}
    fused4 = ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd", "ln_mlp_bwd")
    evit4 = {**dict.fromkeys(fused4, DEPTH - 4), "flash_packed_fwd": 3, "flash_packed_bwd": 3}
    int8_train = ("attend_project_fwd", "attend_project_bwd", "ln_mlp_q_fwd", "ln_mlp_q_bwd")
    paths["serving"] = (*serve(fb, torch), "forward")
    torch.cuda.empty_cache()
    paths["EViT serving"] = (*serve_evit(fb, torch)[:2], "forward")
    serve_gelu_exact(fb, torch)
    paths["train"] = (*train(fb, torch, "train", dict.fromkeys(fused4, DEPTH - 1))[:2], "step")
    train_parity(fb, torch, "train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(fused4, PARITY_DEPTH - 1))
    paths["EViT train"] = (*train(fb, torch, "EViT train", evit4, keep_rate=KEEP_RATE)[:2],
                           "step")
    # at PARITY_DEPTH the pruning layers are 1, 2 and 3: block 0 fused, no readout
    evit_parity = {**dict.fromkeys(fused4, 1), "flash_packed_fwd": 3, "flash_packed_bwd": 3}
    train_parity(fb, torch, "EViT train parity", PARITY_DEPTH, 3, evit_parity,
                 keep_rate=KEEP_RATE)
    train_parity(fb, torch, "gelu_exact train parity", GELU_PARITY_DEPTH, 1,
                 {"flash_packed_fwd": GELU_PARITY_DEPTH - 1,
                  "flash_packed_bwd": GELU_PARITY_DEPTH - 1}, gelu_exact=True)
    # int8: B7 / B8 in place of B3 / B4 in every fused block
    paths["int8 serving"] = (*serve_int8(fb, torch)[:2], "forward")
    paths["int8 train"] = (*train(fb, torch, "int8 train", dict.fromkeys(int8_train, DEPTH - 1),
                                  quantization="int8")[:2], "step")
    train_parity(fb, torch, "int8 train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(int8_train, PARITY_DEPTH - 1), quantization="int8")
    # the DCS recipe: k of 8 channels per step, B1-B4 in every fused block
    paths["DCS recipe train"] = (*train_recipe(fb, torch, dict.fromkeys(fused4, DEPTH - 1))[:2],
                                 "step")
    train_parity(fb, torch, "DCS recipe train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(fused4, PARITY_DEPTH - 1), ks=(2, 5, 8))
    torch.cuda.empty_cache()

    # the small_tpu preset (3 heads of 128) at full width and depth, as the
    # JAX bench's mxu_native, int8_dh128 and dh-128 EViT recipe cells: every
    # attention kernel at head width 128
    tpu = dict(pretrained_model_name=TPU_PRESET)
    paths["small_tpu serving"] = (*serve(fb, torch, "small_tpu serving", **tpu), "forward")
    torch.cuda.empty_cache()
    paths["small_tpu train"] = (*train(fb, torch, "small_tpu train",
                                       dict.fromkeys(fused4, DEPTH - 1), **tpu)[:2], "step")
    train_parity(fb, torch, "small_tpu train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(fused4, PARITY_DEPTH - 1), **tpu)
    paths["small_tpu DCS recipe train"] = (*train_recipe(
        fb, torch, dict.fromkeys(fused4, DEPTH - 1), "small_tpu DCS recipe train", **tpu)[:2],
        "step")
    paths["small_tpu int8 train"] = (*train(
        fb, torch, "small_tpu int8 train", dict.fromkeys(int8_train, DEPTH - 1),
        quantization="int8", **tpu)[:2], "step")
    train_parity(fb, torch, "small_tpu int8 train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(int8_train, PARITY_DEPTH - 1), quantization="int8", **tpu)
    paths["small_tpu EViT recipe train"] = (*train_recipe(
        fb, torch, evit4, "small_tpu EViT recipe train", keep_rate=KEEP_RATE, **tpu)[:2],
        "step")
    train_parity(fb, torch, "small_tpu EViT recipe train parity", PARITY_DEPTH, 3, evit_parity,
                 ks=(2, 5, 8), keep_rate=KEEP_RATE, **tpu)
    torch.cuda.empty_cache()

    # the base preset (DiChaViT-B) at full width and depth: serving, train,
    # and the 3-step parity at depth 4, in bf16 and in int8 (B7 / B8 at D =
    # 768); then the geometry smoke
    base = dict(pretrained_model_name=BASE_PRESET)
    paths["base serving"] = (*serve(fb, torch, "base serving", **base), "forward")
    torch.cuda.empty_cache()
    paths["base train"] = (*train(fb, torch, "base train", dict.fromkeys(fused4, DEPTH - 1),
                                  **base)[:2], "step")
    train_parity(fb, torch, "base train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(fused4, PARITY_DEPTH - 1), **base)
    paths["base int8 serving"] = (*serve_int8(fb, torch, "base int8 serving", **base)[:2],
                                  "forward")
    paths["base int8 train"] = (*train(fb, torch, "base int8 train",
                                       dict.fromkeys(int8_train, DEPTH - 1),
                                       quantization="int8", **base)[:2], "step")
    train_parity(fb, torch, "base int8 train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(int8_train, PARITY_DEPTH - 1), quantization="int8", **base)
    torch.cuda.empty_cache()
    paths.update(run_geometries(fb, torch, dict.fromkeys(fused4, DEPTH - 1)))
    # the benchmark scripts: S1-S3 run only there, S1 and S2 also at 3 heads
    for (name, args, _), counts in zip(SCRIPT_RUNS, run_scripts(fb).values()):
        paths[script_label(name, args)] = (counts, 1, "run")

    # each kernel's main paths, first the one its launches are read from
    dh128 = "_dh128"
    main_paths = {
        "attend_project_fwd": ("serving", "train"),
        "ln_mlp_fwd": ("serving", "train"),
        "attend_project_bwd": ("train",),
        "ln_mlp_bwd": ("train",),
        "flash_packed_fwd": ("EViT serving", "EViT train"),
        "flash_packed_bwd": ("EViT train",),
        "ln_mlp_q_fwd": ("int8 serving", "int8 train"),
        "ln_mlp_q_bwd": ("int8 train",),
        "bwd_call": (script_label(*SCRIPT_RUNS[1][:2]),),
        "qkv_flash_fwd": (script_label(*SCRIPT_RUNS[4][:2]),),
        "int8_ln_mlp": (script_label(*SCRIPT_RUNS[5][:2]),),
        "attend_project_fwd" + dh128: ("small_tpu serving", "small_tpu train",
                                       "small_tpu int8 train"),
        "attend_project_bwd" + dh128: ("small_tpu train", "small_tpu int8 train"),
        "flash_packed_fwd" + dh128: ("small_tpu EViT recipe train",),
        "flash_packed_bwd" + dh128: ("small_tpu EViT recipe train",),
        "bwd_call" + dh128: (script_label(*SCRIPT_RUNS[6][:2]),),
        "qkv_flash_fwd" + dh128: (script_label(*SCRIPT_RUNS[7][:2]),),
        width_name("ln_mlp_fwd", D_BASE): ("base serving", "base train"),
        width_name("ln_mlp_bwd", D_BASE): ("base train",),
        kernel_name("attend_project_fwd", HEADS_BASE, D_BASE): ("base serving", "base train"),
        kernel_name("attend_project_bwd", HEADS_BASE, D_BASE): ("base train",),
        width_name("ln_mlp_q_fwd", D_BASE): ("base int8 serving", "base int8 train"),
        width_name("ln_mlp_q_bwd", D_BASE): ("base int8 train",),
    }
    d768 = f"_d{D_BASE}"
    line = []
    for name, r in results.items():
        counter = name
        for suffix in (dh128, d768):
            counter = counter[:-len(suffix)] if counter.endswith(suffix) else counter
        entry = {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"]}
        first, *rest = main_paths[name]
        counts, units, unit = paths[first]
        entry.update(launches=counts[counter], launches_in=first,
                     **{f"launches_per_{unit}": counts[counter] / units})
        for label in rest:
            counts, units, unit = paths[label]
            entry[f"launches_per_{unit}_{label.replace(' ', '_')}"] = counts[counter] / units
        if name in fused4:
            for label in ("EViT train", "DCS recipe train"):
                counts, units, _ = paths[label]
                entry[f"launches_per_step_{label.replace(' ', '_')}"] = counts[name] / units
        if "code_flips" in r:
            entry.update(code_flips=r["code_flips"])
        entry.update(max_abs_err=r["max_abs_err"], rel_err=r["rel_err"],
                     tolerance=KERNEL_REL_TOL, ms=r["ms"], kernel_ms=r["ms"],
                     plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     library_ms=r["library_ms"])
        for key in ("per_grid", "per_variant", "sibling_max_abs_diff", "b6_max_abs_diff",
                    "sibling_code_share", "sibling_ms", "sub_ms"):
            if key in r:
                entry[key] = r[key]
        line.append(entry)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
