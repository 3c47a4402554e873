"""Channel attention pooling: a small transformer over the channel axis
(counterpart of the JAX package's ``models/channel_attention_pooling.py``;
the reference's ``models/channel_attention_pooling.py:79-127``).

The depthwise token grid (B, C, N, K) attends over its C channels with the
N patches folded into the batch: optional learned channel tokens added by
global channel id, an optional CLS token prepended, ``depth`` PreNorm
multi-head attention + feed-forward pairs, then the mean over the channels,
or with ``use_cls_token`` the *last* channel position. Reading the last
position after prepending the CLS token at the front is a quirk of the
reference (``channel_attention_pooling.py:122-124``) that the JAX package
reproduces; so does the port.

This is dense attention over C <= 18 channels: the JAX package computes it
with ``einsum`` and no Pallas kernel, and the port with plain torch ops. It
runs in f32, as the JAX module does (its parameters are f32 and no dtype is
given, so flax promotes the compute dtype's tokens to f32); the caller casts
the pooled grid back. The feed-forward's GELU is the model's: tanh, or erf
with ``gelu_exact`` (the JAX process-wide flag). Parameter names follow the
JAX tree: ``attn_{i}.norm``, ``attn_{i}.to_qkv`` (no bias),
``attn_{i}.to_out``, ``ff_{i}.norm``, ``ff_{i}.fc1``, ``ff_{i}.fc2``,
``channel_tokens``, ``cls_token``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import activations
from ..ops.initializers import lecun_normal_, normal_, normal_div8_


def _dense(fan_in: int, fan_out: int, bias: bool, g) -> nn.Linear:
    lin = nn.Linear(fan_in, fan_out, bias=bias)
    lecun_normal_(lin.weight, g)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class _PreNormMHA(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, dropout: float, g=None):
        super().__init__()
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        inner = heads * dim_head
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.to_qkv = _dense(dim, 3 * inner, False, g)
        self.to_out = _dense(inner, dim, True, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * self.dim_head ** -0.5, -1)
        attn = F.dropout(attn, self.dropout, self.training)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return F.dropout(self.to_out(out), self.dropout, self.training)


class _PreNormFF(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, dropout: float, gelu_exact: bool, g=None):
        super().__init__()
        self.dropout, self.gelu_exact = dropout, gelu_exact
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = _dense(dim, mlp_dim, True, g)
        self.fc2 = _dense(mlp_dim, dim, True, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = activations.gelu(self.fc1(self.norm(x)), self.gelu_exact)
        return F.dropout(self.fc2(F.dropout(y, self.dropout, self.training)), self.dropout,
                         self.training)


class ChannelAttentionPoolingLayer(nn.Module):
    """tokens (B, C, N, K) and the (C,) global channel ids -> (B, N, K) f32.
    ``dropout`` acts in training on the attention probabilities and after
    each branch's projections, as in the JAX module, drawn from torch's
    default generator."""

    def __init__(self, max_num_channels: int, dim: int, depth: int = 1, heads: int = 4,
                 dim_head: int = 16, mlp_dim: int = 4, dropout: float = 0.0,
                 use_cls_token: bool = False, use_channel_tokens: bool = False,
                 init_channel_tokens: Optional[str] = None, gelu_exact: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_cls_token = use_cls_token
        self.depth = depth
        g = generator
        if use_channel_tokens:
            self.channel_tokens = nn.Parameter(torch.zeros(max_num_channels, dim))
            if init_channel_tokens == "random":
                normal_div8_(self.channel_tokens, g)
        if use_cls_token:
            self.cls_token = nn.Parameter(normal_(torch.empty(dim), generator=g))
        for i in range(depth):
            setattr(self, f"attn_{i}", _PreNormMHA(dim, heads, dim_head, dropout, g))
            setattr(self, f"ff_{i}", _PreNormFF(dim, mlp_dim, dropout, gelu_exact, g))

    def forward(self, tokens: torch.Tensor, channel_ids: torch.Tensor) -> torch.Tensor:
        b, c, n, k = tokens.shape
        x = tokens.float().transpose(1, 2).reshape(b * n, c, k)  # ((B*N), C, K)
        if hasattr(self, "channel_tokens"):
            x = x + self.channel_tokens[channel_ids][None]
        if self.use_cls_token:
            x = torch.cat([self.cls_token.expand(b * n, 1, k), x], dim=1)
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(x)
            x = x + getattr(self, f"ff_{i}")(x)
        # the reference reads the last channel position after prepending the
        # CLS token at the front
        pooled = x[:, -1] if self.use_cls_token else x.mean(dim=1)
        return pooled.reshape(b, n, k)
