"""Attention pieces of the serving path (counterpart of the JAX package's
``ops/attention.py``): the mask value, the pad-once policy for the token
grid, and the plain masked attention.

The pad multiple is the port's own: both CUDA kernels work on 64-row tiles,
so the grid is padded once to a multiple of 64 (1569 -> 1600 tokens at the
flagship). Padded keys are masked through ``valid_len`` and padded query rows
are never read, so the padding does not change any real row.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

MASK_VALUE = -1e30
PAD_MULTIPLE = 64


def maybe_pad_tokens(xseq: torch.Tensor) -> Tuple[torch.Tensor, Optional[int]]:
    """Pad a (B, N, D) token grid ONCE with zero rows to a multiple of
    :data:`PAD_MULTIPLE`. Returns ``(xseq, valid_len)``, with
    ``valid_len=None`` when no padding was needed."""
    n = xseq.shape[1]
    n_pad = -(-n // PAD_MULTIPLE) * PAD_MULTIPLE
    if n_pad == n:
        return xseq, None
    return F.pad(xseq, (0, 0, 0, n_pad - n)), n


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                    valid_len: Optional[int] = None) -> torch.Tensor:
    """Masked softmax attention in the (B, H, N, dh) layout, scores and
    softmax in f32 (counterpart of ``xla_attention``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if valid_len is not None and valid_len < k.shape[2]:
        s = s.masked_fill(torch.arange(k.shape[2], device=k.device) >= valid_len, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)
