"""The port's kernel benchmark scripts (counterparts of the repository's
``scripts/bench_attn.py``, ``scripts/bench_block_fusion.py`` and
``scripts/bench_int8_lnmlp.py``), each run as

    python -m diverse_channel_vit_torch.scripts.<name> [arguments]

with the JAX scripts' experiments, arguments, defaults and report lines. Each
carries the hand-written CUDA kernel of its script's Pallas prototype beside
its plain PyTorch version. They run on ``cuda`` unless their functions are
given ``device="cpu"``, and nothing runs at import. Times are host-clock
times over a run of calls ending in ``torch.cuda.synchronize()``, after one
warm-up call, as the JAX scripts time theirs.
"""

from __future__ import annotations

import torch


def synchronize(out) -> None:
    """Wait for the work that produced ``out`` (a tensor, or a tuple or list
    whose first item is one): synchronise its CUDA device; a CPU tensor is
    ready already."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
