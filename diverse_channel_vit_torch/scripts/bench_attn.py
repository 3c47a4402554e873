"""Attention-kernel benchmark of the port (counterpart of
``scripts/bench_attn.py``).

Experiments (on the card):

  python -m diverse_channel_vit_torch.scripts.bench_attn chain         # attend_project chains
  python -m diverse_channel_vit_torch.scripts.bench_attn bwd-variants  # pair-staged vs
                                                                        # batched-pair bwd
  python -m diverse_channel_vit_torch.scripts.bench_attn step --batch 64 96 128
  python -m diverse_channel_vit_torch.scripts.bench_attn small-k       # recipe steps, k = 2, 4

Every chain runs L = 12 layers. ``bwd-variants`` times :func:`bwd_call`,
whose CUDA kernel ``csrc/bench_attn_bwd.cu`` (replaces the TPU kernel
``_bwd_kernel``) recomputes the softmax statistics from q and k and runs in
two schedules: ``pair_staged`` (one head per block) and ``pair_batched`` (a
head pair per block of its dk/dv and dq passes, one warpgroup per head
sharing one ring of tiles); they agree bit for bit. The JAX script's
``smap`` experiment (a shard_map at mesh {data: 1}) waits for the multi-GPU
port (ROADMAP A10). An experiment that fails raises; the JAX script
prints FAILED and goes on.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..device import resolve_device
from ..ops import fused_block as fb
from ..ops import kernels
from ..ops.attention import HEAD_WIDTHS, _scores
from ..ops.dispatch import LAUNCHES, _check, _check_launch, _launches_kernel
from . import synchronize

L = 12
# the kernel's schedules: heads carried by one block
VARIANTS = {"pair_staged": 1, "pair_batched": 2}
TILE = 64  # the kernels' query and key tile (the JAX script's block_q)


def bench(f, *args, iters: int = 10) -> float:
    """Seconds per call of ``f(*args)``: one warm-up call, then ``iters``
    calls on the host clock ending in a synchronise."""
    synchronize(f(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        r = f(*args)
    synchronize(r)
    return (time.perf_counter() - t0) / iters


def report(tag: str, dt: float) -> None:
    print(f"{tag:<58} {dt*1e3:8.2f} ms ({dt*1e3/L:.2f} ms/layer)", flush=True)


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


# ---------------------------------------------------------------------------
# shipped-op chains
# ---------------------------------------------------------------------------


def exp_chain(cfg, device: Optional[str] = None) -> None:
    """12-layer chains of the port's attend_project op (B1 forward, B2
    backward), forward and forward + backward with respect to y. At the
    default N = 1569 each call pads to a multiple of 64 and slices back, as
    the JAX op does."""
    dev = resolve_device(device)
    b, n, d, h = cfg.batch[0], cfg.n, cfg.dim, cfg.heads
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    y = _normal(gen, (b, n, d), dev).to(bf16)
    w = (_normal(gen, (3 * d, d), dev) * 0.02).to(bf16)
    bq = torch.zeros(3 * d, dtype=bf16, device=dev)
    wp = (_normal(gen, (d, d), dev) * 0.02).to(bf16)
    bp = torch.zeros(d, dtype=bf16, device=dev)

    def chain(y):
        for _ in range(L):
            y = fb.attend_project(y, w, bq, wp, bp, y, h, valid_len=cfg.n_valid)
        return y

    def fwd(y):
        with torch.no_grad():
            return chain(y)

    def grad(y):
        y = y.detach().requires_grad_()
        return torch.autograd.grad(chain(y).float().sum(), y)[0]

    report(f"attend_project fwd B={b} N={n} dh={d//h}", bench(fwd, y))
    report(f"attend_project fwd+bwd B={b} N={n} dh={d//h}", bench(grad, y))


# ---------------------------------------------------------------------------
# backward variants: one head per block against a head pair per block
# ---------------------------------------------------------------------------


def bwd_call_plain(q, k, v, o, do, num_heads: int, sm_scale: float, n_valid: int,
                   variant: str = "pair_staged"):
    """Plain version of :func:`bwd_call`, the TPU kernel ``_bwd_kernel``'s
    arithmetic (both variants compute it): per head s = q k^T * scale in f32,
    keys at or past ``n_valid`` masked, P = exp(s - rowmax) / rowsum;
    di = rowsum(f32(o) f32(do)); dS = P (do v^T - di) * scale;
    dq = bf16(dS) k; dk = bf16(dS)^T q and dv = bf16(P)^T do summed in f32
    over every query row; each rounded to q's dtype once. ``variant`` names
    a schedule of the kernel and leaves the function as it is."""
    dh = q.shape[-1] // num_heads
    dt = q.dtype
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    for h in range(num_heads):
        sl = slice(h * dh, (h + 1) * dh)
        qh, kh, vh, doh = (t[..., sl].float() for t in (q, k, v, do))
        s = _scores(q[..., sl], k[..., sl], sm_scale, n_valid)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        di = (o[..., sl].float() * doh).sum(dim=-1, keepdim=True)
        ds = p * (torch.matmul(doh, vh.transpose(1, 2)) - di) * sm_scale
        dsb, pb = ds.to(dt).float(), p.to(dt).float()
        dq[..., sl] = torch.matmul(dsb, kh).to(dt)
        dk[..., sl] = torch.matmul(dsb.transpose(1, 2), qh).to(dt)
        dv[..., sl] = torch.matmul(pb.transpose(1, 2), doh).to(dt)
    return dq, dk, dv


def _bwd_call_cuda(q, k, v, o, do, num_heads, sm_scale, n_valid, variant):
    b, n, d = q.shape
    dh = d // num_heads
    hp = VARIANTS[variant]
    if q.dtype != torch.bfloat16 or dh not in HEAD_WIDTHS or dh * num_heads != d or n % TILE:
        raise NotImplementedError(
            f"bwd_call kernel ({variant}): {q.dtype}, {num_heads} heads of width {dh}, N={n} "
            f"(built for bf16, head width {HEAD_WIDTHS} and N a multiple of {TILE}; "
            "ROADMAP B, S1)")
    if not 1 <= n_valid <= n:
        raise ValueError(f"bwd_call kernel: n_valid={n_valid} not in [1, {n}]")
    dev, f32 = q.device, torch.float32
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check(name, t, torch.bfloat16, (b, n, d), dev)
    grads = torch.empty((b, n, 3 * d), dtype=q.dtype, device=dev)  # [dq | dk | dv]
    lse, di = (torch.empty((b, num_heads, n), dtype=f32, device=dev) for _ in range(2))
    fn = kernels.function("bench_attn_bwd")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 grads.data_ptr(), lse.data_ptr(), di.data_ptr(), b, n, num_heads, dh,
                 int(n_valid), float(sm_scale), hp, torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("bwd_call", err)
    LAUNCHES["bwd_call"] += 1
    return grads.split(d, dim=-1)


def bwd_call(q, k, v, o, do, num_heads: int, sm_scale: float, n_valid: int,
             variant: str = "pair_staged"):
    """``(dq, dk, dv)`` of masked multi-head attention over (B, N, H*dh) q,
    k, v given its output o and do, the softmax statistics recomputed from
    q and k (no log-sum-exp input); keys at or past ``n_valid`` masked, and
    their dk and dv rows exactly 0. ``variant`` picks the kernel's schedule
    (``pair_staged`` or ``pair_batched``). The kernel
    ``csrc/bench_attn_bwd.cu`` for a CUDA tensor (dq, dk and dv then the
    column views of one (B, N, 3D) buffer), the plain version for a CPU
    one."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; want one of {sorted(VARIANTS)}")
    if _launches_kernel(q):
        return _bwd_call_cuda(q, k, v, o, do, num_heads, sm_scale, n_valid, variant)
    return bwd_call_plain(q, k, v, o, do, num_heads, sm_scale, n_valid, variant)


def exp_bwd_variants(cfg, device: Optional[str] = None) -> None:
    dev = resolve_device(device)
    b, n, d, h = cfg.batch[0], cfg.n_pad, cfg.dim, cfg.heads
    dh = d // h
    sm = dh ** -0.5
    q, k, v, o, do = (_normal(torch.Generator(device=dev).manual_seed(i), (b, n, d), dev)
                      .to(torch.bfloat16) for i in range(5))
    outs = {}
    for variant in VARIANTS:
        def chain(q, k, v, o, do, variant=variant):
            outs = []
            for _ in range(L):
                dq, dk, dv = bwd_call(q, k, v, o, do, h, sm, cfg.n_valid, variant)
                outs.append(dq[0, 0, 0].float() + dk[0, 0, 0].float() + dv[0, 0, 0].float())
                q = q + 0 * dq  # serialize layers
            return torch.stack(outs).sum()

        dt = bench(chain, q, k, v, o, do)
        report(f"bwd {variant} tile={TILE} B={b} N={n} dh={dh}", dt)
        outs[variant] = bwd_call(q, k, v, o, do, h, sm, cfg.n_valid, variant)
    a, bb = outs["pair_staged"], outs["pair_batched"]
    diffs = [(x.float() - y.float()).abs().max().item() for x, y in zip(a, bb)]
    print("numerics max |staged - batched| dq/dk/dv:", diffs)


# ---------------------------------------------------------------------------
# full train step at several batch sizes
# ---------------------------------------------------------------------------


def exp_step(cfg, device: Optional[str] = None, iters: int = 20, **model) -> None:
    """Training images/s of the all-channel DiChaViT-S step at each batch
    size over ``iters`` steps (``model``: ``img`` / ``depth`` for a smaller
    model)."""
    from .. import bench as bench_mod

    for bsz in cfg.batch:
        ips = bench_mod.flagship_imgs_per_sec(num_heads=cfg.heads, batch=bsz, iters=iters,
                                              device=device, **model)
        print(f"train step batch={bsz} heads={cfg.heads}: "
              f"{ips:.1f} imgs/s ({bsz/ips*1e3:.1f} ms/step)", flush=True)


def exp_small_k(cfg, device: Optional[str] = None, iters: int = 20, **model) -> None:
    """Recipe-path regime: step throughput at small k against the per-step
    batch, over ``iters`` steps."""
    from .. import bench as bench_mod

    for k in (2, 4):
        for bsz in cfg.batch:
            net, state, data = bench_mod._setup(cfg.heads, bsz, device=device, **model)
            step = bench_mod._mk_step(net, k)
            ips, _ = bench_mod._measure(state, data, [step], bsz, iters=iters)
            print(f"k={k} batch={bsz}: {ips:.1f} imgs/s "
                  f"({bsz/ips*1e3:.1f} ms/step)", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("exp", choices=["chain", "bwd-variants", "step", "small-k"])
    ap.add_argument("--batch", type=int, nargs="+", default=[64])
    ap.add_argument("--n", type=int, default=1569)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--heads", type=int, default=6)
    cfg = ap.parse_args(argv)
    cfg.n_valid = cfg.n
    cfg.n_pad = -(-cfg.n // 128) * 128
    return cfg


EXPERIMENTS = {"chain": exp_chain, "bwd-variants": exp_bwd_variants, "step": exp_step,
               "small-k": exp_small_k}


def main(argv=None, device: Optional[str] = None) -> None:
    cfg = parse_args(argv)
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={name} devices={torch.cuda.device_count() if dev.type == 'cuda' else 1}")
    EXPERIMENTS[cfg.exp](cfg, device=dev)


if __name__ == "__main__":
    main()
