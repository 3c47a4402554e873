"""Per-channel patch embedding (counterpart of the JAX package's
``ops/patch_embed.py``).

The reference's ``Conv3d(1, D, kernel=(1, p, p), stride=(1, p, p))`` is an
im2col reshape and one (B*C*N, p*p) x (p*p, D) matrix product. The port keeps
that form: a cuDNN convolution would run in TF32 by default.

Tokens stay in the (B, C, N, D) channel-grouped layout.
"""

from __future__ import annotations

from typing import Optional

import torch


def extract_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, N, p*p) non-overlapping patches, row-major."""
    b, c, h, w = x.shape
    p = patch_size
    h0, w0 = h // p, w // p
    x = x.reshape(b, c, h0, p, w0, p).permute(0, 1, 2, 4, 3, 5)
    return x.reshape(b, c, h0 * w0, p * p)


def per_channel_patch_embed(x: torch.Tensor, kernel: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, *,
                            patch_size: int) -> torch.Tensor:
    """x: (B, C, H, W); kernel: (p*p, D), the flattened Conv3d weight shared by
    every channel; bias: (D,). Returns (B, C, N, D) in the kernel's dtype."""
    tokens = torch.matmul(extract_patches(x, patch_size), kernel)
    if bias is not None:
        tokens = tokens + bias
    return tokens


def add_channel_embedding(tokens: torch.Tensor, channel_embed: torch.Tensor) -> torch.Tensor:
    """tokens (B, C, N, D) + channel_embed (C, D) or (B, C, D), broadcast over N."""
    if channel_embed.ndim == 2:
        return tokens + channel_embed[None, :, None, :]
    return tokens + channel_embed[:, :, None, :]
