"""Channel Vision Transformer (counterpart of the JAX package's
``models/channel_vit.py``).

Tokens stay channel-grouped ``(B, C, N, D)`` through the patch embedding and
enter the blocks as the flat ``(B, 1 + C*N, D)`` grid in channel-major order,
padded once to the kernels' multiple (``ops/attention.maybe_pad_tokens``).
The forward is the JAX module's forward for ``block_type="block"`` with no
dropout and no token dropping. With ``keep_rate < 1`` the blocks at layers
depth // 4, depth // 2 and 3 * depth // 4 run as EViT blocks
(:meth:`~.vit.Block.evit`), each keeping the top ``int(keep_rate * (n_valid
- 1))`` tokens, and the grid is padded again after each prune; an EViT layer
takes precedence over the readout. The last block reads out the CLS row
alone unless ``cls_only_readout`` is off (exact in training too: the other
rows of the last block feed nothing). In train mode (``module.train()``) it
also returns DiChaViT's diversity losses: TDL on the projected tokens before
the channel embedding, CDL of the selected channel embeddings against their
proxies.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import maybe_pad_tokens
from ..ops.initializers import conv_patch_, normal_div8_, orthogonal_, trunc_normal_
from ..ops.losses import orthogonal_projection_loss, proxy_loss
from ..ops.patch_embed import add_channel_embedding, per_channel_patch_embed
from .vit import Block


def _torch_bicubic_1d(size_in: int, size_out: int, scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """Index/weight tables of torch's bicubic ``F.interpolate``
    (align_corners=False, a=-0.75, border-replicate) for one axis with an
    explicit ``scale_factor``."""
    a = -0.75
    x = (np.arange(size_out) + 0.5) / scale - 0.5
    ix = np.floor(x).astype(np.int64)
    t = (x - ix)[:, None]
    d = np.abs(t - np.array([-1.0, 0.0, 1.0, 2.0])[None, :])
    w = np.where(
        d <= 1.0,
        (a + 2) * d**3 - (a + 3) * d**2 + 1.0,
        np.where(d < 2.0, a * d**3 - 5 * a * d**2 + 8 * a * d - 4 * a, 0.0),
    )
    idx = np.clip(ix[:, None] + np.array([-1, 0, 1, 2])[None, :], 0, size_in - 1)
    return idx, w.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _bicubic_tables(side: int, h0: int, w0: int, device: torch.device):
    """(idx_h, w_h, idx_w, w_w) on ``device``, made once per geometry. They
    are made outside inference mode even when the first call comes from a
    serving forward, so that a later training forward can save them for its
    backward."""
    tables = _torch_bicubic_1d(side, h0, (h0 + 0.1) / side) + \
        _torch_bicubic_1d(side, w0, (w0 + 0.1) / side)
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, device=device) for a in tables)


def interpolate_pos_embed(pos_embed: torch.Tensor, h0: int, w0: int,
                          num_channels: int = 1) -> torch.Tensor:
    """Bicubic-resize the (1, N+1, D) positional table to an (h0, w0) grid at
    ``scale_factor=(h0+0.1)/sqrt(N)``, the reference's
    ``interpolate_pos_encoding``.

    The reference skips the resample only when ``C * h0 * w0 == N``, so for
    C > 1 it resamples even at the native grid, and the +0.1-scaled resample
    is not the identity. ``num_channels`` feeds that condition.
    """
    n = pos_embed.shape[1] - 1
    if num_channels * h0 * w0 == n and h0 == w0:
        return pos_embed
    dim = pos_embed.shape[-1]
    side = int(math.sqrt(n))
    grid = pos_embed[:, 1:].reshape(side, side, dim).float()
    idx_h, w_h, idx_w, w_w = _bicubic_tables(side, h0, w0, pos_embed.device)
    # separable: rows then columns (torch's upsample_bicubic2d order)
    rows = torch.einsum("otsd,ot->osd", grid[idx_h], w_h)  # (h0, side, D)
    out = torch.einsum("hotd,ot->hod", rows[:, idx_w], w_w)  # (h0, w0, D)
    out = out.reshape(1, h0 * w0, dim).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :1], out], dim=1)


class _ConvProj(nn.Module):
    """Holds the reference's ``Conv3d(1, D, (1, p, p))`` weight and bias; the
    projection itself runs as im2col + matmul (``ops/patch_embed.py``)."""

    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, 1, 1, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(dim))


class PatchEmbedPerChannel(nn.Module):
    def __init__(self, num_total_channels: int, patch_size: int, dim: int,
                 use_channelvit_channels: bool, with_proxies: bool):
        super().__init__()
        self.proj = _ConvProj(dim, patch_size)
        if use_channelvit_channels:
            self.channel_embed = nn.Embedding(num_total_channels, dim)
            if with_proxies:  # CDL table (training only)
                self.channel_emb_proxies = nn.Parameter(torch.empty(num_total_channels, dim))


# size presets mirroring channelvit_{tiny,small,base,distill}
SIZE_PRESETS = {
    "tiny": dict(embed_dim=192, depth=12, num_heads=3),
    "small": dict(embed_dim=384, depth=12, num_heads=6),
    "base": dict(embed_dim=768, depth=12, num_heads=12),
    "distill": dict(embed_dim=384, depth=12, num_heads=6),
    "small_tpu": dict(embed_dim=384, depth=12, num_heads=3),
    "test": dict(embed_dim=64, depth=2, num_heads=2),
}


def apply_preset_overrides(preset: dict, cfg_model) -> dict:
    """Optional ``model.{embed_dim,depth,num_heads}`` overrides on a preset."""
    out = dict(preset)
    for key in ("embed_dim", "depth", "num_heads"):
        val = cfg_model.get(key)
        if val:
            out[key] = int(val)
    return out


class ChannelVisionTransformer(nn.Module):
    """Per-channel-token ViT backbone; ``forward`` returns the f32 CLS
    embedding (B, D) and the f32 extra loss (0 in eval mode). Parameters are
    f32; ``dtype`` is the compute dtype."""

    def __init__(self, num_total_channels: int, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 use_channelvit_channels: bool = True, orthogonal_channel_emb_init: bool = False,
                 freeze_channel_emb: bool = False, proxy_loss_lambda: float = 0.0, ortho_loss_v1_lambda: float = 0.0,
                 proxy_orthogonal_init: bool = False, gamma_s: float = 1.0,
                 gamma_d: float = 0.5, reverse_pos_pairs: bool = False,
                 use_square: bool = False, temperature: float = 0.11111,
                 attention_impl: str = "auto", cls_only_readout: bool = True, keep_rate: Optional[float] = None,
                 gelu_exact: bool = False, quantization: str = "none",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_total_channels = num_total_channels
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.use_channelvit_channels = use_channelvit_channels
        self.freeze_channel_emb = freeze_channel_emb
        self.proxy_loss_lambda = proxy_loss_lambda
        self.ortho_loss_v1_lambda = ortho_loss_v1_lambda
        self.tdl = dict(gamma_s=gamma_s, gamma_d=gamma_d, reverse_pos_pairs=reverse_pos_pairs,
                        use_square=use_square)
        self.channel_scale = math.sqrt(1.0 / temperature)  # CDL scale
        self.cls_only_readout = cls_only_readout
        # EViT keep rate; a run-time knob, as the parameters do not depend on it
        self.keep_rate = keep_rate
        self.dtype = dtype
        self.patch_embed = PatchEmbedPerChannel(
            num_total_channels, patch_size, embed_dim, use_channelvit_channels,
            proxy_loss_lambda > 0,
        )
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, (img_size // patch_size) ** 2 + 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, dtype=dtype, gelu_exact=gelu_exact,
                  quantization=quantization, attention_impl=attention_impl)
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self._init_weights(generator, orthogonal_channel_emb_init, proxy_orthogonal_init)

    @torch.no_grad()
    def _init_weights(self, g, orthogonal_channel_emb, proxy_orthogonal):
        """Reference init: dense kernels and tables trunc-normal(0.02), zero
        biases, LayerNorm (1, 0), patch conv uniform(+-1/sqrt(p*p))."""
        pe = self.patch_embed
        conv_patch_(pe.proj.weight, self.patch_size ** 2, g)
        pe.proj.bias.zero_()
        if self.use_channelvit_channels:
            (orthogonal_ if orthogonal_channel_emb else trunc_normal_)(
                pe.channel_embed.weight, generator=g)
            if hasattr(pe, "channel_emb_proxies"):
                (orthogonal_ if proxy_orthogonal else normal_div8_)(
                    pe.channel_emb_proxies, generator=g)
        trunc_normal_(self.cls_token, generator=g)
        trunc_normal_(self.pos_embed, generator=g)
        for blk in self.blocks:
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                trunc_normal_(lin.weight, generator=g)
                if lin.bias is not None:
                    lin.bias.zero_()
            for ln in (blk.norm1, blk.norm2):
                ln.reset_parameters()
        self.norm.reset_parameters()

    def forward(self, x: torch.Tensor, channel_ids: torch.Tensor):
        """x: (B, C, H, W) with the channels already selected; channel_ids:
        (C,) global ids indexing the channel-embedding table."""
        b, c, h, w = x.shape
        p, dim, dt = self.patch_size, self.embed_dim, self.dtype
        n = (h // p) * (w // p)
        pe = self.patch_embed
        kernel = pe.proj.weight.reshape(dim, p * p).t().to(dt)
        tokens = per_channel_patch_embed(x.to(dt), kernel, pe.proj.bias.to(dt), patch_size=p)
        extra_loss = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.training and self.ortho_loss_v1_lambda > 0:
            # TDL on the projected tokens, before the channel embedding
            extra_loss = extra_loss + self.ortho_loss_v1_lambda * orthogonal_projection_loss(
                tokens, **self.tdl)
        if self.use_channelvit_channels:
            sel_embed = pe.channel_embed.weight[channel_ids]  # (C, D) f32
            if self.freeze_channel_emb:  # neither CE nor CDL trains the table
                sel_embed = sel_embed.detach()
            if self.training and self.proxy_loss_lambda > 0:
                # CDL: the selected channel embeddings against their proxies
                extra_loss = extra_loss + self.proxy_loss_lambda * proxy_loss(
                    pe.channel_emb_proxies[channel_ids], sel_embed,
                    torch.eye(c, dtype=torch.float32, device=x.device), self.channel_scale)
            tokens = add_channel_embedding(tokens, sel_embed.to(dt))
        tokens = tokens.reshape(b, c * n, dim)
        pos = interpolate_pos_embed(self.pos_embed, h // p, w // p, num_channels=c).to(dt)
        tokens = tokens + pos[:, 1:].repeat(1, c, 1)  # per-channel copy of the table
        cls = (self.cls_token.to(dt) + pos[:, :1]).expand(b, 1, dim)
        xseq, valid_len = maybe_pad_tokens(torch.cat([cls, tokens], dim=1))
        depth = len(self.blocks)
        evit_on = self.keep_rate is not None and float(self.keep_rate) < 1.0
        evit_layers = {depth // 4, depth // 2, (3 * depth) // 4} if evit_on else set()
        for i, blk in enumerate(self.blocks):
            if i in evit_layers:
                xseq, valid_len = blk.evit(xseq, float(self.keep_rate), valid_len)
                if valid_len is None:  # pruned: pad the fully valid grid again
                    xseq, valid_len = maybe_pad_tokens(xseq)
                continue
            xseq = blk(xseq, valid_len=valid_len,
                       cls_query=self.cls_only_readout and i == depth - 1)
        # LayerNorm is per token: norm only the CLS row that is read
        cls_out = F.layer_norm(xseq[:, :1].float(), (dim,), self.norm.weight, self.norm.bias,
                               self.norm.eps)
        return cls_out[:, 0], extra_loss
