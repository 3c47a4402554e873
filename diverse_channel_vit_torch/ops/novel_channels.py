"""Leave-one-out novel-channel synthesis (counterpart of the JAX package's
``ops/novel_channels.py``).

At eval time the channels of a split or chunk that training never saw get
channel embeddings built from trained channels' rows (the reference's
``channel_vit.py:89-136``: a walking cursor over a channel bank with the
strategies avg_2 / avg_3 (and their ``_not_in_chunk`` banks), replicate,
zero, random, as_is, random_input_corr, fixed_input_corr).

The plan (:func:`synthesis_plan`) is host-side index lists that depend only
on the mapper and the strategy; :func:`synthesize_rows` applies it to a
table on the table's device. The batch-dependent DYNAMIC_INPUT_CORR_{1..6}
strategies (the reference's ``channel_vit_adapt.py:153-254``) are
:func:`dynamic_input_corr`, one per-sample (B, D) row per novel channel.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

STATIC_STRATEGIES = (
    "avg_2", "avg_2_not_in_chunk", "avg_3", "avg_3_not_in_chunk",
    "replicate", "zero", "as_is", "random", "random_input_corr",
    "fixed_input_corr",
)


def flatten_training_channels(mapper: Dict[str, Sequence[int]], training_chunks: str) -> List[int]:
    """The channels of ``training_chunks``, a '_'-joined chunk list, in
    order and with repeats (``trainer.py:408``)."""
    out: List[int] = []
    for ch in training_chunks.split("_"):
        out.extend(mapper[ch])
    return out


def synthesis_plan(
    mapper: Dict[str, Sequence[int]],
    chunk: str,
    training_chunks: str,
    strategy: str,
    *,
    channel_map: Optional[Dict[int, int]] = None,
    rng: Optional[np.random.Generator] = None,
) -> List[Tuple[str, List[int]]]:
    """Per channel of ``chunk``: ("avg", [source ids]) or ("zero", []).

    A trained channel keeps its own row. The cursor into the bank advances
    once per novel channel, modulo the bank's length (``channel_vit.py:96-136``).
    ``random_input_corr`` draws one trained channel from ``rng`` per novel
    channel; an unknown strategy raises at the first novel channel.
    """
    training_channels = flatten_training_channels(mapper, training_chunks)
    chunk_channels = list(mapper[chunk])
    chs_not_seen = [c for c in training_channels if c not in chunk_channels]
    bank = chs_not_seen if "not_in_chunk" in strategy else training_channels
    if not bank:
        bank = training_channels

    plan: List[Tuple[str, List[int]]] = []
    cur = 0
    for c in chunk_channels:
        if c in training_channels or strategy == "as_is":
            plan.append(("avg", [c]))
            continue
        if strategy in ("avg_2", "avg_2_not_in_chunk"):
            plan.append(("avg", [bank[cur], bank[(cur + 1) % len(bank)]]))
        elif strategy in ("avg_3", "avg_3_not_in_chunk"):
            plan.append(("avg", [bank[cur], bank[(cur + 1) % len(bank)],
                                 bank[(cur + 2) % len(bank)]]))
        elif strategy == "replicate":
            plan.append(("avg", [bank[cur]]))
        elif strategy == "zero":
            plan.append(("zero", []))
        elif strategy == "random":
            # the reference's RANDOM keeps the channel's own (untrained) row
            plan.append(("avg", [c]))
        elif strategy == "random_input_corr":
            r = rng or np.random.default_rng()
            plan.append(("avg", [int(r.choice(training_channels))]))
        elif strategy == "fixed_input_corr":
            if not channel_map:
                raise ValueError("fixed_input_corr needs a channel_map {novel: trained}")
            plan.append(("avg", [channel_map[c]]))
        else:
            raise ValueError(f"Invalid new_channel_init: {strategy!r}")
        cur = (cur + 1) % len(bank)
    return plan


def synthesize_rows(table: torch.Tensor, plan: List[Tuple[str, List[int]]]) -> torch.Tensor:
    """Apply a plan to any per-channel table (C_total, ...) -> (C, ...). A
    mean is the sum times 1/n, as JAX's ``jnp.mean`` rounds it (``/ 3``
    lands an ulp away in a third of the entries)."""
    rows = []
    for kind, ids in plan:
        if kind == "zero":
            rows.append(torch.zeros_like(table[0]))
        else:
            rows.append(table[torch.tensor(ids, device=table.device)].sum(dim=0)
                        * (1.0 / len(ids)))
    return torch.stack(rows, dim=0)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)


def dynamic_input_corr(
    variant: int,
    x: torch.Tensor,
    ch_idx: int,
    bank_imgs: torch.Tensor,
    channel_embed: torch.Tensor,
    training_channels: Sequence[int],
    proj_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """DYNAMIC_INPUT_CORR_{1..6}: match the novel channel's input against a
    bank of training-channel images (``channel_vit_adapt.py:153-254``).

    x: (B, C, H, W) eval batch; ``ch_idx`` the novel channel's position in
    it; bank_imgs: (A, C_train, H, W) exemplars of the training channels;
    channel_embed: the full (C_total, D) table. Returns a per-sample (B, D)
    embedding. Variants 1-3 and 6 pick a trained channel's row (1 and 6 by
    a vote over the exemplars, ties to the lowest channel), 4 and 5 weight
    the rows by the mean correlation; 5 and 6 correlate the patch
    projections (``proj_fn``) in place of the pixels.
    """
    b = x.shape[0]
    tc = torch.tensor(list(training_channels), device=channel_embed.device)
    a, c_train = bank_imgs.shape[:2]

    if variant in (5, 6):
        if proj_fn is None:
            raise ValueError("variants 5/6 need the patch-projection fn")
        xc = _normalize(proj_fn(x[:, ch_idx:ch_idx + 1]).reshape(b, -1))
        bk = proj_fn(bank_imgs.reshape(-1, 1, *bank_imgs.shape[2:]))
        bk = _normalize(bk.reshape(a, c_train, -1))
    else:
        xc = _normalize(x[:, ch_idx].reshape(b, -1))
        bk = _normalize(bank_imgs.reshape(a, c_train, -1))

    if variant == 2:
        flat = _normalize(bk.transpose(0, 1).reshape(c_train, -1))
        xrep = _normalize(xc.repeat(1, a))
        idx = (xrep @ flat.T).argmax(dim=-1)  # (B,)
        return channel_embed[tc[idx]]
    if variant == 3:
        mean_bank = _normalize(bk.mean(dim=0))
        idx = (xc @ mean_bank.T).argmax(dim=-1)
        return channel_embed[tc[idx]]

    corr = torch.einsum("bd,acd->bac", xc, bk)  # (B, A, C_train)
    if variant in (1, 6):
        # the mode over exemplars as JAX takes it: one-hot counts, then the
        # first (lowest) channel among equal counts (torch.mode names no order)
        votes = F.one_hot(corr.argmax(dim=-1), c_train).sum(dim=1)  # (B, C_train)
        return channel_embed[tc[votes.argmax(dim=-1)]]
    if variant in (4, 5):
        return corr.mean(dim=1) @ channel_embed[tc]
    raise ValueError(f"dynamic_input_corr variant {variant} not in 1..6")
