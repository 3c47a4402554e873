"""Token pruning (counterpart of the JAX package's ``ops/token_pruning.py``):
the top-k token selection of EViT.

The keep count is a Python int, fixed by the token count, as in the JAX
package (whose static counts keep its shapes jit-stable).
"""

from __future__ import annotations

from typing import Tuple

import torch


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
