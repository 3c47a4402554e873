#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each one either succeeds or ends the run with a non-zero exit):

1. print the card's name and power limit; turn TF32 off for matmuls and
   convolutions;
2. build the CUDA kernels under ``diverse_channel_vit_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build time;
3. hold each kernel against its plain PyTorch version at the flagship shapes
   (B = 64 images, N = 1600 tokens padded from 1569, D = 384, 6 heads,
   hidden 1536, bf16) and time the kernel, the plain version and a PyTorch
   library yardstick: the forwards B1 (attend_project) and B3 (ln_mlp), then
   the backwards B2 and B4;
4. build full-width DiChaViT-S (8 channels, 224^2, patch 16, depth 12, 161
   classes, seeded random weights, bf16 compute) and serve requests through
   ``ServingEngine`` (``predict``, ``submit``) and ``ServingHTTPServer`` on
   localhost, with the kernel launch counts set to 0 just before and read
   just after; time each batch bucket and profile one 64-image ``predict``;
   then hold the logits against the same model run through the plain
   versions;
5. train the same model (f32 parameters, bf16 compute) with the port's
   ``make_optimizer`` / ``make_lr_schedule`` / ``TrainState`` /
   ``make_train_step`` on one synthetic batch of 64 images: CE + CDL + TDL,
   AdamW with the JUMP-CP weight-decay schedule; counts set to 0 just before
   2 warm-up and 10 timed steps and read just after (each kernel 11 launches
   per step); profile one step; then 3 steps through the kernels against 3
   steps through the plain versions from the same weights, at depth 4;
6. print the ``kernels`` JSON line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. Without a CUDA device, or outside a checkout of
the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
import urllib.request

import numpy as np

# flagship geometry (DiChaViT-S at JUMP-CP)
B, N_VALID, D, HEADS, HID = 64, 1569, 384, 6, 1536
CHANNELS, IMG, PATCH, DEPTH, CLASSES = 8, 224, 16, 12, 161
BUCKETS = (1, 4, 16, 64)
# the plain-route training check runs at this depth (the plain attention
# materialises every (N, N) score matrix); the timed steps run at DEPTH
PARITY_DEPTH = 4
# H100 SXM published dense peaks
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# kernel vs plain version, both bf16: they round at the same points but sum
# in other orders and the kernel's online softmax rounds P against a running
# max, so an output may land one or two bf16 ulps (2^-7 relative) apart
KERNEL_REL_TOL = 2e-2
# logits after 12 layers of such differences
LOGITS_REL_TOL = 5e-2
# kernel route vs plain route over 3 train steps at PARITY_DEPTH: losses, and
# each parameter's step-0 gradient against max|g| of that parameter (the
# differences above, carried through 4 layers forward and back)
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2


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
    n = -(-N_VALID // 64) * 64
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(0))
    bf16 = torch.bfloat16

    results = {}
    # the model reads only the n_valid real rows of the padded grid, so the
    # bound counts those (the kernels also compute the padded rows)
    rows = B * N_VALID
    # --- B1 attend_project_fwd
    dh = D // HEADS
    qkv, x_res = rnd(B, n, 3 * D), rnd(B, n, D)
    wp, bp = rnd(D, D, scale=D ** -0.5), rnd(D)
    args = (qkv, x_res, wp, bp, HEADS, dh ** -0.5, N_VALID)
    bare = (qkv, None, wp, torch.zeros_like(bp), HEADS, dh ** -0.5, N_VALID)

    def hold_ap(label, a):
        (o_k, l_k, xo_k), (o_p, l_p, xo_p) = (f(*a, need_o=True) for f in
                                              (fb.attend_project_fwd, fb.attend_project_fwd_plain))
        return hold("attend_project_fwd", label,
                    (("xo", xo_k, xo_p), ("o", o_k, o_p), ("lse", l_k, l_p)))

    err_xo, rel_xo = hold_ap("main path", args)
    hold_ap("no residual, zero bias", bare)
    ms = cuda_ms(lambda: fb.attend_project_fwd(*args), 10)
    plain_ms = cuda_ms(lambda: fb.attend_project_fwd_plain(*args), 3, warmup=1)
    keep = (torch.arange(n, device="cuda") < N_VALID)[None, None, None, :]

    def library():
        q, k, v = qkv.view(B, n, 3, HEADS, dh).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        return F.linear(o.transpose(1, 2).reshape(B, n, D), wp, bp) + x_res

    library_ms = cuda_ms(library, 10)
    results["attend_project_fwd"] = dict(
        source="diverse_channel_vit_torch/csrc/attend_project.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:671",
        max_abs_err=err_xo, rel_err=rel_xo, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=4 * rows * N_VALID * D + 2 * rows * D * D,
        bytes=2 * (rows * 3 * D + 2 * rows * D + D * D + D),
    )

    # --- B3 ln_mlp_fwd
    x = rnd(B, n, D)
    s, bb = rnd(D, scale=0.1, dtype=torch.float32) + 1.0, rnd(D, scale=0.1, dtype=torch.float32)
    w1, b1 = rnd(HID, D, scale=D ** -0.5), rnd(HID)
    w2, b2 = rnd(D, HID, scale=HID ** -0.5), rnd(D)
    largs = (x, s, bb, w1, b1, w2, b2, True)
    bare = (x, s, bb, w1, b1, w2, torch.zeros_like(b2), False)

    def hold_ln(label, a):
        return hold("ln_mlp_fwd", label, (("out", fb.ln_mlp(*a), fb.ln_mlp_plain(*a)),))

    err, rel = hold_ln("main path", largs)
    hold_ln("no residual, zero bias", bare)
    ms = cuda_ms(lambda: fb.ln_mlp(*largs), 10)
    plain_ms = cuda_ms(lambda: fb.ln_mlp_plain(*largs), 3, warmup=1)
    sb, bbb = s.to(bf16), bb.to(bf16)

    def library():
        y = F.layer_norm(x, (D,), sb, bbb, 1e-6)
        return F.linear(F.gelu(F.linear(y, w1, b1), approximate="tanh"), w2, b2) + x

    library_ms = cuda_ms(library, 10)
    results["ln_mlp_fwd"] = dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:152",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=4 * rows * D * HID,
        bytes=2 * (2 * rows * D + 2 * D * HID + HID + D) + 4 * 2 * D,
    )
    return results


def check_bwd_kernels(fb, torch, F):
    """Phase 3, backwards: B2 and B4 against their plain versions at flagship
    shapes, every output.

    B2 runs from the forward kernel's own o and lse, as the main path calls
    it (keys 1569-1599 masked), and again with every key valid; it takes no
    residual (the autograd Function passes dxo to the residual itself). B4
    runs with the residual fused, as the main path calls it, and without.
    dxo and do are drawn at scale 1. Padded key rows must come out of B2 with
    dk = dv = 0 exactly."""
    n = -(-N_VALID // 64) * 64
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(1))
    bf16 = torch.bfloat16
    rows = B * N_VALID
    dh = D // HEADS
    results = {}

    # --- B2 attend_project_bwd
    qkv, x_res = rnd(B, n, 3 * D), rnd(B, n, D)
    wp, bp = rnd(D, D, scale=D ** -0.5), rnd(D)
    dxo = rnd(B, n, D)
    names = ("dq", "dk", "dv", "dwp", "dbp", "db_qkv")

    def split(out):
        dqkv, dwp, dbp, db = out
        return (dqkv[..., :D], dqkv[..., D:2 * D], dqkv[..., 2 * D:], dwp, dbp, db)

    def hold_ap(label, n_valid):
        o, lse, _ = fb.attend_project_fwd(qkv, x_res, wp, bp, HEADS, dh ** -0.5, n_valid,
                                          need_o=True)
        a = (qkv, o, lse, wp, dxo, HEADS, dh ** -0.5, n_valid)
        got = split(fb.attend_project_bwd(*a))
        worst = hold("attend_project_bwd", label,
                     list(zip(names, got, split(fb.attend_project_bwd_plain(*a)))))
        return worst, got, a

    (err, rel), got, args = hold_ap("main path", N_VALID)
    pad = torch.cat([got[1][:, N_VALID:], got[2][:, N_VALID:]], dim=-1)
    if torch.count_nonzero(pad).item() != 0:
        raise AssertionError("attend_project_bwd: padded key rows have dk or dv != 0")
    print(f"attend_project_bwd: dk and dv exactly 0 on the {n - N_VALID} padded key rows")
    hold_ap("every key valid", n)
    ms = cuda_ms(lambda: fb.attend_project_bwd(*args), 10)
    plain_ms = cuda_ms(lambda: fb.attend_project_bwd_plain(*args), 2, warmup=1)
    keep = (torch.arange(n, device="cuda") < N_VALID)[None, None, None, :]
    lq, lw, lb = (t.detach().clone().requires_grad_() for t in (qkv, wp, bp))
    q, k, v = lq.view(B, n, 3, HEADS, dh).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
    lib_out = F.linear(o.transpose(1, 2).reshape(B, n, D), lw, lb) + x_res
    library_ms = cuda_ms(
        lambda: torch.autograd.grad(lib_out, (lq, lw, lb), dxo, retain_graph=True), 10)
    del lib_out, o, q, k, v
    results["attend_project_bwd"] = dict(
        source="diverse_channel_vit_torch/csrc/attend_project_bwd.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:713",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=10 * rows * N_VALID * D + 4 * rows * D * D,
        bytes=2 * (rows * 3 * D + rows * D + rows * D + D * D + rows * 3 * D)
        + 4 * (rows * HEADS + D * D + D + 3 * D),
    )
    del qkv, x_res, dxo, args, got, pad

    # --- B4 ln_mlp_bwd
    x, do = rnd(B, n, D), rnd(B, n, D)
    s, bb = rnd(D, scale=0.1, dtype=torch.float32) + 1.0, rnd(D, scale=0.1, dtype=torch.float32)
    w1, b1 = rnd(HID, D, scale=D ** -0.5), rnd(HID)
    w2 = rnd(D, HID, scale=HID ** -0.5)
    names = ("dx", "dw1", "db1", "dw2", "db2", "ds", "db")

    def hold_ln(label, residual):
        a = (x, s, bb, w1, b1, w2, do, residual)
        return hold("ln_mlp_bwd", label,
                    list(zip(names, fb.ln_mlp_bwd(*a), fb.ln_mlp_bwd_plain(*a)))), a

    (err, rel), largs = hold_ln("main path, residual fused", True)
    hold_ln("no residual", False)
    ms = cuda_ms(lambda: fb.ln_mlp_bwd(*largs), 10)
    plain_ms = cuda_ms(lambda: fb.ln_mlp_bwd_plain(*largs), 2, warmup=1)
    lib_in = [t.detach().clone().requires_grad_()
              for t in (x, s.to(bf16), bb.to(bf16), w1, b1, w2, rnd(D))]
    lx, ls, lbb, lw1, lb1, lw2, lb2 = lib_in
    lib_out = F.linear(F.gelu(F.linear(F.layer_norm(lx, (D,), ls, lbb, 1e-6), lw1, lb1),
                              approximate="tanh"), lw2, lb2) + lx
    library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_in, do, retain_graph=True), 10)
    del lib_out
    results["ln_mlp_bwd"] = dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp_bwd.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:167",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=10 * rows * D * HID,
        bytes=2 * (3 * rows * D + 2 * D * HID + HID) + 4 * (2 * D + 2 * D * HID + HID + 3 * D),
    )
    return results


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
    share of its wall time."""
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
    for dev, key, count in rows[:16]:
        print(f"  {100 * dev / busy:5.1f}%  {dev / 1e3:8.3f} ms  x{count:<4d} {key[:90]}")


def model_config(depth: int):
    from diverse_channel_vit_torch.config import Config

    return Config({
        "in_channel_names": [f"ch{i}" for i in range(CHANNELS)], "img_size": [IMG],
        "patch_size": PATCH, "pretrained_model_name": "small", "depth": depth,
        "proxy_loss_lambda": 1e-3, "ortho_loss_v1_lambda": 1e-3, "gamma_s": 1.0,
        "gamma_d": 4.0,
    })


def serve(fb, torch):
    """Phase 4: full-width DiChaViT-S through the serving entry points."""
    from diverse_channel_vit_torch.models import build_model
    from diverse_channel_vit_torch.serving import ServingEngine
    from diverse_channel_vit_torch.serving_http import ServingHTTPServer

    model = build_model("dichavit", model_config(DEPTH), {"JUMP-CP": list(range(CHANNELS))},
                        CLASSES, device="cuda", dtype=torch.bfloat16, seed=0)
    engine = ServingEngine(model, buckets=BUCKETS, device="cuda")
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    full, sub = list(range(CHANNELS)), [0, 3, 5]

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
    print(f"main path: {forwards} forwards in {time.perf_counter() - t0:.1f} s, "
          f"kernel launches {launches}; health {health}; stats {stats}")
    per_layer = DEPTH - 1  # blocks 0-10 fused, block 11 the CLS readout
    for name in ("attend_project_fwd", "ln_mlp_fwd"):
        if forwards == 0 or launches[name] != per_layer * forwards:
            raise AssertionError(f"{name}: {launches[name]} launches for {forwards} forwards, "
                                 f"want {per_layer} per forward")
    for name in ("attend_project_bwd", "ln_mlp_bwd"):
        if launches[name]:
            raise AssertionError(f"{name}: launched {launches[name]} times while serving")

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
        err = float(np.abs(got - want).max())
        rel = err / float(np.abs(want).max())
        print(f"logits {key} vs plain versions on the card: max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tolerance rel <= {LOGITS_REL_TOL})")
        if rel > LOGITS_REL_TOL:
            raise AssertionError(f"{key}: kernel route disagrees with the plain route")
    engine.stop()
    print("serving " + json.dumps({"buckets": timings}))
    return launches, forwards


def train_setup(depth: int, torch):
    """Model, train state and step as a user builds them: DiChaViT-S with
    f32 parameters from seed 0 and bf16 compute; AdamW with the JUMP-CP
    weight-decay schedule (optimizer/adamw_jumpcp.yaml) under the cosine lr
    schedule (scheduler/cosine.yaml); CE + CDL + TDL with
    extra_loss_lambda = 1."""
    from diverse_channel_vit_torch.models import build_model
    from diverse_channel_vit_torch.training import (
        TrainState, make_lr_schedule, make_optimizer, make_train_step)

    model = build_model("dichavit", model_config(depth), {"JUMP-CP": list(range(CHANNELS))},
                        CLASSES, device="cuda", dtype=torch.bfloat16, seed=0)
    lr = make_lr_schedule("cosine", 2.5e-4, dict(
        t_initial="FILL_LATER", lr_min=1e-6, cycle_mul=1.0, cycle_decay=0.5, cycle_limit=1,
        warmup_t=3, warmup_lr_init=1e-5, warmup_prefix=False, t_in_epochs=True, k_decay=1.0,
    ), num_epochs=100, steps_per_epoch=100)
    tx = make_optimizer("adamw", dict(lr=2.5e-4, betas=[0.9, 0.999], eps=1e-6,
                                      weight_decay=0.04, weight_decay_end=0.4, amsgrad=False),
                        lr_schedule=lr, total_steps=10_000)
    state = TrainState(model, tx)
    step = make_train_step(model, channel_ids=range(CHANNELS), loss_type="ce",
                           extra_loss_lambda=1.0)
    return model, state, step


def synthetic_batch(torch):
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    labels = rng.integers(0, CLASSES, size=B)
    return {"image": torch.from_numpy(imgs).cuda(), "label": torch.from_numpy(labels).cuda()}


def train(fb, torch):
    """Phase 5: the DiChaViT-S train step on the card."""
    batch = synthetic_batch(torch)
    model, state, step = train_setup(DEPTH, torch)
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
    per_layer = DEPTH - 1
    print(f"train: {steps} steps, kernel launches {launches}")
    for name, count in launches.items():
        if count != per_layer * steps:
            raise AssertionError(f"{name}: {count} launches in {steps} train steps, "
                                 f"want {per_layer} per step")
    for i, m in enumerate(losses):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {i}: non-finite metrics {m}")
    print(f"train metrics, step 0: {json.dumps(losses[0])}; step {steps - 1}: "
          f"{json.dumps(losses[-1])}")
    lats = np.asarray(lats)
    timing = {"imgs_per_s": B * timed / float(lats.sum()),
              "p50_ms": float(np.percentile(lats, 50)) * 1e3,
              "min_ms": float(lats.min()) * 1e3, "max_ms": float(lats.max()) * 1e3,
              "steps": timed, "batch": B, "params": n_params,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("train " + json.dumps(timing))
    profile_call(lambda: step(state, batch), "one train step (64 images)", torch)
    del model, state, step
    torch.cuda.empty_cache()

    # kernel route vs plain route from the same weights, at PARITY_DEPTH
    runs = {}
    for route in ("kernels", "plain"):
        model, state, step = train_setup(PARITY_DEPTH, torch)
        before = dict(fb.LAUNCHES)
        ctx = fb.plain_versions() if route == "plain" else contextlib.nullcontext()
        route_losses, grads0 = [], None
        with ctx:
            for i in range(3):
                state, m = step(state, batch)
                route_losses.append(float(m["loss"]))
                if i == 0:
                    grads0 = {n: p.grad.float().clone() for n, p in model.named_parameters()}
        torch.cuda.synchronize()
        runs[route] = (route_losses, grads0, {k: fb.LAUNCHES[k] - before[k] for k in before})
        del model, state, step
        torch.cuda.empty_cache()
    (lk, gk, nk), (lp, gp, np_) = runs["kernels"], runs["plain"]
    if any(np_.values()):
        raise AssertionError(f"the plain training run launched kernels: {np_}")
    if any(v != 3 * (PARITY_DEPTH - 1) for v in nk.values()):
        raise AssertionError(f"the kernel training run launched {nk}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    print(f"train parity (depth {PARITY_DEPTH}, 3 steps): losses kernels {lk} plain {lp}, "
          f"max rel {loss_rel:.3e} (tolerance {TRAIN_LOSS_REL_TOL})")
    if not loss_rel <= TRAIN_LOSS_REL_TOL:
        raise AssertionError("train parity: losses of the kernel and plain routes disagree")
    worst = (0.0, "")
    for name, g in gk.items():
        ref = gp[name]
        scale = ref.abs().max().item()
        rel = (g - ref).abs().max().item() / scale if scale else (g - ref).abs().max().item()
        worst = max(worst, (rel, name))
    print(f"train parity: step-0 gradients of {len(gk)} parameter tensors, worst rel "
          f"{worst[0]:.3e} ({worst[1]}) (tolerance {TRAIN_GRAD_REL_TOL} of max|g|)")
    if not worst[0] <= TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"train parity: gradient of {worst[1]} disagrees")
    return launches, steps, timing


def main() -> int:
    import torch
    import torch.nn.functional as F

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

    results = check_kernels(fb, torch, F)
    results.update(check_bwd_kernels(fb, torch, F))
    for name, r in results.items():
        t_ops, t_bytes = r.pop("flops") / PEAK_BF16_FLOPS, r.pop("bytes") / PEAK_BYTES
        r["bound_ms"] = max(t_ops, t_bytes) * 1e3
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    serve_launches, forwards = serve(fb, torch)
    torch.cuda.empty_cache()
    train_launches, steps, _ = train(fb, torch)

    line = []
    for name, r in results.items():
        entry = {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"]}
        if name.endswith("_fwd"):  # main paths: serving, and the train step
            entry.update(launches=serve_launches[name],
                         launches_per_forward=serve_launches[name] / forwards,
                         train_launches=train_launches[name],
                         launches_per_step=train_launches[name] / steps)
        else:  # main path: the train step
            entry.update(launches=train_launches[name],
                         launches_per_step=train_launches[name] / steps)
        entry.update(max_abs_err=r["max_abs_err"], rel_err=r["rel_err"],
                     tolerance=KERNEL_REL_TOL, ms=r["ms"], kernel_ms=r["ms"],
                     plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     library_ms=r["library_ms"])
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
