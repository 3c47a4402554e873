"""ViT building blocks (counterpart of the JAX package's ``models/vit.py``).

Parameters sit in ``nn.Linear`` / ``nn.LayerNorm`` containers laid out as in
the PyTorch reference (fused ``attn.qkv`` in [q | k | v] row order), so a
reference ``state_dict`` loads with ``strict=True``. The blocks call the
functional ops themselves. Every parameter is f32 (the master copy an
optimizer updates) and is cast to the compute dtype at each use, as the JAX
package casts its f32 parameters; without autograd the blocks' casts are
made once and reused until the parameter changes (:func:`_wb`).

A :class:`Block` runs one of three routes, the same in training and
inference (the JAX package's ``Block.__call__`` routing with dropout and
attention dropout 0, which is all the port takes):

- the fused route, where :func:`fused_route_ok` allows it (``attention_impl``
  ``auto`` or ``pallas``, bf16, at most 8192 tokens, a width that is a
  multiple of 128, head width a multiple of 64, tanh-GELU): LN1 in
  f32 -> the wide qkv GEMM -> ``attend_project`` with the residual fused ->
  ``ln_mlp`` with the residual fused (each an autograd Function over its
  forward and backward kernels when a gradient is wanted). With
  ``quantization="int8"`` (or inside ``fused_block.quantization("int8")``)
  ``ln_mlp`` runs its int8 kernels; as in the JAX package, only this MLP is
  quantised: the attention projections, the unfused ``Mlp``, the EViT blocks
  and the readout stay in the compute dtype;
- the unfused route otherwise (f32, ``gelu_exact``, ``attention_impl``
  ``xla``, a grid past 8192 tokens, a width such as the ``tiny`` preset's
  D = 192): LN1 in f32 -> :class:`Attention` (the qkv GEMM,
  ``flash_attention_packed`` on the q/k/v views, the proj GEMM) -> residual
  -> LN2 in f32 -> :class:`Mlp` (fc1, GELU, fc2) -> residual;
- the CLS-only readout of the last block (``cls_query``): only the CLS row's
  query, attention row and MLP are computed, as dense ops.

DropPath (stochastic depth, JAX ``DropPath``): in training a block with a
rate above 0 takes per-sample masks ``drop`` (two (B,) bools, one for each
branch, drawn by the caller) and adds ``where(mask, branch / keep, 0)``
(keep = 1 - rate) to the residual stream; the fused route then calls
``attend_project`` without ``x_res`` and ``ln_mlp`` with
``residual=False`` and adds the masked branches itself (JAX
``models/vit.py:664-706``). Eval, and a block at rate 0, keep the fused
residual.

:meth:`Block.evit` is the JAX package's ``BlockEViT`` on the same parameters:
the unfused attention, then the top ``int(keep_rate * (n_valid - 1))``
tokens by head-mean CLS attention, then the dense MLP.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import activations, fused_block
from ..ops.attention import MASK_VALUE, flash_attention_packed, plain_attention
from ..ops.token_pruning import select_tokens, topk_token_select


def _layer_norm_f32(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


def _cached(module: nn.Module, params, dtype: torch.dtype, make):
    """``make()``, kept on ``module`` and reused until one of ``params``
    changes: an in-place update (an optimizer step, ``load_state_dict``)
    bumps its version, ``Module.to`` gives it new storage. For use without
    autograd only."""
    key = (dtype,) + tuple(None if p is None else (p.data_ptr(), p._version) for p in params)
    cached = module.__dict__.get("_cast_cache")
    if cached is None or cached[0] != key:
        cached = module._cast_cache = (key, make())
    return cached[1]


def _wb(layer: nn.Linear, dtype: torch.dtype):
    """The layer's weight and bias in ``dtype``. Without autograd (serving)
    the cast copies are made once and reused (:func:`_cached`)."""
    params = (layer.weight, layer.bias)
    if torch.is_grad_enabled():
        return tuple(None if p is None else p.to(dtype) for p in params)
    return _cached(layer, params, dtype,
                   lambda: tuple(None if p is None else p.detach().to(dtype) for p in params))


def _quantized_mlp(mlp: "Mlp", dtype: torch.dtype):
    """``(w1q, s1c, b1, w2q, s2c, b2)`` of the int8 MLP forward, quantised
    from the ``dtype`` casts of the weights as the JAX package quantises its
    compute-dtype casts. Serving only (no autograd): made once and reused
    until a parameter changes. Training quantises at every call instead
    (``ops/fused_block.LnMlpFn``)."""
    def make():
        (w1, b1), (w2, b2) = _wb(mlp.fc1, dtype), _wb(mlp.fc2, dtype)
        w1q, s1c, w2q, s2c = fused_block.quantize_mlp_weights(w1, w2)
        return w1q, s1c, b1, w2q, s2c, b2

    return _cached(mlp, (mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias), dtype,
                   make)


# the longest token grid the JAX package's fused route takes
# (``ops/attention.py`` ``MAX_SINGLE_PASS_N``); past it JAX runs the block
# unfused
MAX_SINGLE_PASS_N = 8192
ATTENTION_IMPLS = ("auto", "pallas", "xla")


def fused_route_ok(x: torch.Tensor, dtype: torch.dtype, num_heads: int, gelu_exact: bool,
                   attention_impl: str = "auto") -> bool:
    """The JAX package's ``Block._fused_ok`` without its TPU-only terms: the
    fused kernels take ``attention_impl`` ``auto`` or ``pallas``, bf16, a
    token count that is a multiple of 8 and at most
    :data:`MAX_SINGLE_PASS_N`, a width that is a multiple of 128 with head
    width a multiple of 64, and tanh-GELU. The gate is the same on the CPU
    and the card, so the port routes (and so rounds) as the JAX package
    does."""
    n, d = x.shape[1], x.shape[-1]
    return (attention_impl in ("auto", "pallas") and dtype == torch.bfloat16 and n % 8 == 0
            and n <= MAX_SINGLE_PASS_N and d % 128 == 0 and (d // num_heads) % 64 == 0
            and not gelu_exact)


def drop_branch(branch: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Per-sample stochastic depth of a residual branch (JAX ``DropPath``):
    each sample's branch divided by keep = 1 - ``rate`` where ``mask`` (B,)
    holds, zero where it does not; the branch itself when ``mask`` is None."""
    if mask is None:
        return branch
    keep = mask.view((-1,) + (1,) * (branch.ndim - 1))
    return torch.where(keep, branch / (1.0 - rate), branch.new_zeros(()))


class Attention(nn.Module):
    """The unfused attention: the qkv GEMM, ``flash_attention_packed`` on the
    q/k/v thirds of its output (strided views, no copy), the proj GEMM. The
    weights are cast to the input's dtype."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def project_qkv(self, y: torch.Tensor):
        """``(q, k, v)``, each (B, N, D), views of one (B, N, 3D) GEMM output."""
        return F.linear(y, *_wb(self.qkv, y.dtype)).split(y.shape[-1], dim=-1)

    def attend(self, q, k, v, valid_len: Optional[int] = None) -> torch.Tensor:
        o = flash_attention_packed(q, k, v, self.num_heads, self.scale, valid_len)
        return F.linear(o, *_wb(self.proj, q.dtype))

    def forward(self, y: torch.Tensor, valid_len: Optional[int] = None) -> torch.Tensor:
        return self.attend(*self.project_qkv(y), valid_len)


class Mlp(nn.Module):
    """The dense MLP of the unfused route: fc1, GELU (tanh, or erf when
    ``exact``), fc2, the weights cast to the input's dtype."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, y: torch.Tensor, exact: bool = False) -> torch.Tensor:
        h = activations.gelu(F.linear(y, *_wb(self.fc1, y.dtype)), exact)
        return F.linear(h, *_wb(self.fc2, y.dtype))


class Block(nn.Module):
    """Pre-norm transformer block; ``dtype`` is the compute dtype and
    ``gelu_exact`` picks the erf GELU (which only the unfused route and the
    readout compute).

    ``evit_kept`` and ``evit_forced`` are a seam for comparing two routes of
    one model: :meth:`evit` leaves the indices of the tokens it chose in
    ``evit_kept`` ((B, keep) int64, or None when it kept every token) and,
    when ``evit_forced`` holds indices, keeps those instead."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, dtype: torch.dtype = torch.float32,
                 gelu_exact: bool = False, quantization: str = "none",
                 attention_impl: str = "auto", drop_path: float = 0.0):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {attention_impl!r}: want one of {ATTENTION_IMPLS}")
        self.dtype = dtype
        self.gelu_exact = gelu_exact
        self.attention_impl = attention_impl
        self.drop_path = float(drop_path)
        self.quantization = fused_block.check_quantization(quantization)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.evit_kept: Optional[torch.Tensor] = None
        self.evit_forced: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None,
                cls_query: bool = False, drop=None) -> torch.Tensor:
        """``drop``: the DropPath masks ``(attention branch, MLP branch)``,
        each (B,) bool, in training at a rate above 0; None otherwise."""
        m1, m2 = (None, None) if drop is None else drop
        if cls_query:
            return self._cls_readout(x, valid_len, m1, m2)
        dt, rate = self.dtype, self.drop_path
        if not fused_route_ok(x, dt, self.attn.num_heads, self.gelu_exact, self.attention_impl):
            y = _layer_norm_f32(x, self.norm1).to(dt)
            x = x + drop_branch(self.attn(y, valid_len), m1, rate)
            return x + drop_branch(
                self.mlp(_layer_norm_f32(x, self.norm2).to(dt), self.gelu_exact), m2, rate)
        fuse = drop is None  # the residual adds fused into both kernels
        x = x.to(dt)
        y = _layer_norm_f32(x, self.norm1).to(dt)
        a = fused_block.attend_project(
            y, *_wb(self.attn.qkv, dt), *_wb(self.attn.proj, dt), x if fuse else None,
            self.attn.num_heads, self.attn.scale, valid_len,
        )
        x = a if fuse else x + drop_branch(a, m1, rate)
        mode = fused_block.quantization_override() or self.quantization
        if mode == "int8" and not torch.is_grad_enabled():
            z = fused_block.ln_mlp_q_fwd(x, self.norm2.weight, self.norm2.bias,
                                         *_quantized_mlp(self.mlp, dt), residual=fuse)
        else:
            z = fused_block.ln_mlp(
                x, self.norm2.weight, self.norm2.bias, *_wb(self.mlp.fc1, dt),
                *_wb(self.mlp.fc2, dt), residual=fuse, quantized=mode == "int8",
            )
        return z if fuse else x + drop_branch(z, m2, rate)

    @torch.no_grad()
    def attention_probs(self, x: torch.Tensor, valid_len: Optional[int] = None) -> torch.Tensor:
        """This block's dense attention probabilities on its input ``x``, (B,
        H, N, N) f32, keys at or past ``valid_len`` masked (the JAX
        ``xla_capture`` route's ``attn_probs``, for ``attention_maps``)."""
        b, n, d = x.shape
        h = self.attn.num_heads
        q, k, _ = self.attn.project_qkv(_layer_norm_f32(x, self.norm1).to(self.dtype))
        qh, kh = (t.float().reshape(b, n, h, d // h).transpose(1, 2) for t in (q, k))
        s = torch.matmul(qh, kh.transpose(-1, -2)) * self.attn.scale
        if valid_len is not None and valid_len < n:
            s = s.masked_fill(torch.arange(n, device=x.device) >= valid_len, MASK_VALUE)
        return torch.softmax(s, dim=-1)

    def evit(self, x: torch.Tensor, keep_rate: float, valid_len: Optional[int] = None,
             drop=None) -> Tuple[torch.Tensor, Optional[int]]:
        """EViT block (the JAX package's ``BlockEViT``): attention and its
        residual, then, when ``keep = int(keep_rate * (n_valid - 1))`` is below
        ``n_valid - 1``, the CLS row and the top ``keep`` other tokens by
        head-mean CLS attention in descending order; then LN2, the dense MLP
        and its residual. Returns ``(x, valid_len)``: after a prune the grid
        is fully valid (``None``) and the caller pads it again. ``drop`` as in
        :meth:`forward`."""
        dt = self.dtype
        m1, m2 = (None, None) if drop is None else drop
        n = x.shape[1]
        n_valid = n if valid_len is None else int(valid_len)
        y = _layer_norm_f32(x, self.norm1).to(dt)
        q, k, v = self.attn.project_qkv(y)
        x = x + drop_branch(self.attn.attend(q, k, v, valid_len), m1, self.drop_path)
        keep = int(keep_rate * (n_valid - 1))
        self.evit_kept = None
        if keep_rate < 1.0 and keep < n_valid - 1:
            kept, self.evit_kept = topk_token_select(x, self._cls_scores(q, k, n_valid), keep)
            x = kept if self.evit_forced is None else select_tokens(x, self.evit_forced)
            valid_len = None
        z = self.mlp(_layer_norm_f32(x, self.norm2).to(dt), self.gelu_exact)
        return x + drop_branch(z, m2, self.drop_path), valid_len

    @torch.no_grad()
    def _cls_scores(self, q: torch.Tensor, k: torch.Tensor, n_valid: int) -> torch.Tensor:
        """Head-mean CLS attention over the non-CLS tokens, (B, N - 1) f32:
        the CLS row of softmax(q k^T * scale) recomputed at O(N * dh) from q's
        CLS row (keys at or past ``n_valid`` masked), padded tokens pinned to
        -1 so that top-k never takes them. Only its order is used."""
        b, n, d = k.shape
        h = self.attn.num_heads
        logits = torch.einsum("bhd,bnhd->bhn", q[:, 0].float().reshape(b, h, d // h),
                              k.float().reshape(b, n, h, d // h)) * self.attn.scale
        if n_valid < n:
            pad = torch.arange(n, device=k.device) >= n_valid
            logits = logits.masked_fill(pad, MASK_VALUE)
        scores = torch.softmax(logits, dim=-1)[:, :, 1:].mean(dim=1)
        if n_valid < n:
            scores = scores.masked_fill(pad[1:], -1.0)
        return scores

    def _cls_readout(self, x: torch.Tensor, valid_len: Optional[int], m1=None,
                     m2=None) -> torch.Tensor:
        """Last-block CLS readout: the queries and the MLP run on the CLS row
        alone; keys and values still see the whole grid. Returns (B, 1, D).
        DropPath's per-sample masks ``m1``, ``m2`` act as on the full rows."""
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
        xc = x[:, :1] + drop_branch(a, m1, self.drop_path)
        y2 = _layer_norm_f32(xc, self.norm2).to(dt)
        return xc + drop_branch(self.mlp(y2, self.gelu_exact), m2, self.drop_path)
