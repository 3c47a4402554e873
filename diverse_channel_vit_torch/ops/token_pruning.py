"""Token reduction (counterpart of the JAX package's ``ops/token_pruning.py``):
the top-k token selection of EViT and PPT, PPT's channel selection and
significance scores, and the HCS token and channel dropout.

Every keep count is a Python int, fixed by the token and channel counts, as
in the JAX package (whose static counts keep its shapes jit-stable). The
random drops draw on the device from an explicit ``torch.Generator``; their
``idx`` argument is the seam that hands in another package's draw.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .sampling import uniform_subset


def select_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The CLS row of the (B, 1 + N, D) grid ``x``, then its non-CLS rows at
    ``idx`` (B, keep) in that order: (B, 1 + keep, D). The gather carries
    the gradient; the indices carry none."""
    rows = torch.gather(x[:, 1:], 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.cat([x[:, :1], rows], dim=1)


def topk_token_select(x: torch.Tensor, scores: torch.Tensor,
                      keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample top-``keep`` of the non-CLS tokens by ``scores`` (B, N),
    gathered in descending-score order after the CLS row, which is always
    kept. Returns ``(tokens, idx)``: the (B, 1 + keep, D) grid and the
    (B, keep) indices into the non-CLS tail (the JAX function returns the
    grid alone)."""
    idx = torch.topk(scores, keep, dim=1, sorted=True).indices
    return select_tokens(x, idx), idx


def ppt_significance_scores(attn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """PPT's token scores from the dense attention (the JAX function, the
    oracle that :class:`~..models.vit.AttentionWithScores` is held to):
    the CLS row of ``attn`` (B, H, N, N) summed over heads, times each
    token's value norm over all heads of ``v`` (B, H, N, dh), over the
    non-CLS tokens and normalised to sum 1: (B, N - 1) f32."""
    b, h, n, dh = v.shape
    v_norm = torch.linalg.vector_norm(v.float().transpose(1, 2).reshape(b, n, h * dh), dim=2)
    sig = (attn[:, :, 0].float().sum(dim=1) * v_norm)[:, 1:]
    return sig / sig.sum(dim=1, keepdim=True)


def topk_channel_select(x: torch.Tensor, scores: torch.Tensor, nc: int, keep_channels: int,
                        keep_idx: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PPT channel pruning (the JAX ``topk_channel_select``): the CLS row of
    the unpadded channel-major grid ``x`` (B, 1 + nc * hw, D), then the
    token groups of the ``keep_channels`` channels whose scores (B, nc * hw),
    summed over the batch and the group, are highest, in channel order.
    The same channels for every sample. Returns ``(tokens, keep_idx)``;
    ``keep_idx`` (keep_channels,) given replaces the choice."""
    b = x.shape[0]
    hw = scores.shape[1] // nc
    if keep_idx is None:
        ch_scores = scores.reshape(b, nc, hw).sum(dim=(0, 2))
        keep_idx = torch.sort(torch.topk(ch_scores, keep_channels).indices).values
    grid = x[:, 1:].reshape(b, nc, hw, -1)
    kept = grid.index_select(1, keep_idx).reshape(b, keep_channels * hw, -1)
    return torch.cat([x[:, :1], kept], dim=1), keep_idx


def random_token_drop(x: torch.Tensor, keep_tokens: int, *,
                      generator: Optional[torch.Generator] = None,
                      idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HCS token dropout (the JAX ``random_token_drop``): the CLS row of
    ``x`` (B, 1 + N, D), then ``keep_tokens`` of the other tokens drawn
    uniformly without replacement, in index order; the same tokens for
    every sample. ``idx`` (keep_tokens,) sorted, given, replaces the draw."""
    if idx is None:
        idx = draw_kept(x.shape[1] - 1, keep_tokens, generator, x.device)
    return torch.cat([x[:, :1], x[:, 1:].index_select(1, idx)], dim=1)


def random_channel_drop(x: torch.Tensor, nc: int, keep_channels: int, *,
                        generator: Optional[torch.Generator] = None,
                        idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HCS channel dropout (the JAX ``random_channel_drop``): the CLS row,
    then the token groups of ``keep_channels`` of the ``nc`` channels drawn
    uniformly without replacement, in channel order. ``idx`` as in
    :func:`random_token_drop`."""
    b = x.shape[0]
    hw = (x.shape[1] - 1) // nc
    if idx is None:
        idx = draw_kept(nc, keep_channels, generator, x.device)
    grid = x[:, 1:].reshape(b, nc, hw, -1)
    kept = grid.index_select(1, idx).reshape(b, keep_channels * hw, -1)
    return torch.cat([x[:, :1], kept], dim=1)


def draw_kept(n: int, keep: int, generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """``keep`` of range(n) drawn uniformly without replacement, sorted:
    the draw of :func:`random_token_drop` and :func:`random_channel_drop`."""
    return torch.sort(uniform_subset(n, keep, device=device, generator=generator)).values
