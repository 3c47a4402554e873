"""ViT building blocks (counterpart of the JAX package's ``models/vit.py``).

Parameters sit in ``nn.Linear`` / ``nn.LayerNorm`` containers laid out as in
the PyTorch reference (fused ``attn.qkv`` in [q | k | v] row order), so a
reference ``state_dict`` loads with ``strict=True``. The blocks call the
functional ops themselves. Every parameter is f32 (the master copy an
optimizer updates) and is cast to the compute dtype at each use, as the JAX
package casts its f32 parameters; without autograd the blocks' casts are
made once and reused until the parameter changes (:func:`_wb`).

A :class:`Block` runs one of two routes, the same in training and inference
(the JAX package's ``Block.__call__`` routing with dropout, attention dropout
and DropPath all 0, which is all the port takes):

- the fused route: LN1 in f32 -> the wide qkv GEMM -> ``attend_project``
  with the residual fused -> ``ln_mlp`` with the residual fused (each an
  autograd Function over its forward and backward kernels when a gradient
  is wanted);
- the CLS-only readout of the last block (``cls_query``): only the CLS row's
  query, attention row and MLP are computed, as dense ops.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import activations, fused_block
from ..ops.attention import plain_attention


def _layer_norm_f32(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


def _wb(layer: nn.Linear, dtype: torch.dtype):
    """The layer's weight and bias in ``dtype``. Without autograd (serving)
    the cast copies stay on the layer and are reused until a parameter
    changes: an in-place update (an optimizer step, ``load_state_dict``)
    bumps its version, ``Module.to`` gives it new storage."""
    params = (layer.weight, layer.bias)
    if torch.is_grad_enabled():
        return tuple(None if p is None else p.to(dtype) for p in params)
    key = (dtype,) + tuple(None if p is None else (p.data_ptr(), p._version) for p in params)
    cached = layer.__dict__.get("_cast_cache")
    if cached is None or cached[0] != key:
        cached = layer._cast_cache = (
            key, tuple(None if p is None else p.detach().to(dtype) for p in params))
    return cached[1]


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """Pre-norm transformer block; ``dtype`` is the compute dtype."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _check_fused_route(self, x: torch.Tensor) -> None:
        if x.is_cuda:
            d = x.shape[-1]
            if self.dtype != torch.bfloat16:
                raise NotImplementedError(
                    f"{self.dtype} on CUDA needs the unfused block route (ROADMAP B5); "
                    "the kernels take bf16"
                )
            if d % 128 or (d // self.attn.num_heads) % 64:
                raise NotImplementedError(
                    f"D={d} with {self.attn.num_heads} heads needs the unfused block route "
                    "(flash_attention_packed, ROADMAP B5)"
                )

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None,
                cls_query: bool = False) -> torch.Tensor:
        if cls_query:
            return self._cls_readout(x, valid_len)
        self._check_fused_route(x)
        dt = self.dtype
        x = x.to(dt)
        y = _layer_norm_f32(x, self.norm1).to(dt)
        x = fused_block.attend_project(
            y, *_wb(self.attn.qkv, dt), *_wb(self.attn.proj, dt), x, self.attn.num_heads,
            self.attn.scale, valid_len,
        )
        return fused_block.ln_mlp(
            x, self.norm2.weight, self.norm2.bias, *_wb(self.mlp.fc1, dt),
            *_wb(self.mlp.fc2, dt), residual=True,
        )

    def _cls_readout(self, x: torch.Tensor, valid_len: Optional[int]) -> torch.Tensor:
        """Last-block CLS readout: the queries and the MLP run on the CLS row
        alone; keys and values still see the whole grid. Returns (B, 1, D)."""
        dt = self.dtype
        b, n, d = x.shape
        h = self.attn.num_heads
        y = _layer_norm_f32(x, self.norm1).to(dt)
        w, bias = _wb(self.attn.qkv, dt)
        q = F.linear(y[:, :1], w[:d], None if bias is None else bias[:d])
        k, v = F.linear(y, w[d:], None if bias is None else bias[d:]).split(d, dim=-1)
        qh = q.reshape(b, 1, h, d // h).transpose(1, 2)
        kh = k.reshape(b, n, h, d // h).transpose(1, 2)
        vh = v.reshape(b, n, h, d // h).transpose(1, 2)
        o = plain_attention(qh, kh, vh, self.attn.scale, valid_len)
        a = F.linear(o.transpose(1, 2).reshape(b, 1, d), *_wb(self.attn.proj, dt))
        xc = x[:, :1] + a
        y2 = _layer_norm_f32(xc, self.norm2).to(dt)
        z = F.linear(activations.gelu(F.linear(y2, *_wb(self.mlp.fc1, dt))),
                     *_wb(self.mlp.fc2, dt))
        return xc + z
