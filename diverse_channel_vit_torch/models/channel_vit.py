"""Channel Vision Transformer (counterpart of the JAX package's
``models/channel_vit.py``).

Tokens stay channel-grouped ``(B, C, N, D)`` through the patch embedding and
enter the blocks as the flat ``(B, 1 + C*N, D)`` grid in channel-major order,
padded once to the kernels' multiple (``ops/attention.maybe_pad_tokens``).
The forward is the JAX module's forward without dropout, with DropPath at
``drop_path_rate`` (rising
linearly with depth, JAX ``models/channel_vit.py:263``; the per-sample
masks drawn by :meth:`ChannelVisionTransformer.draw_drop_path`). With ``keep_rate < 1`` the blocks at layers
depth // 4, depth // 2 and 3 * depth // 4 run as EViT blocks
(:meth:`~.vit.Block.evit`), each keeping the top ``int(keep_rate * (n_valid
- 1))`` tokens, and the grid is padded again after each prune; an EViT layer
takes precedence over the readout. The last block reads out the CLS row
alone unless ``cls_only_readout`` is off (exact in training too: the other
rows of the last block feed nothing). In train mode (``module.train()``) it
also returns DiChaViT's diversity losses: TDL on the projected tokens before
the channel embedding, CDL of the selected channel embeddings against their
proxies. Given a ``taps`` dict the forward fills it with every block's output
(MIRO's taps, ``training/miro.py``) and runs the last block at all rows, and
with ``attention_layer`` it adds that block's dense attention probabilities
(:func:`attention_maps`).

HCS token dropout (``dropout_tokens_hcs``, JAX
``models/channel_vit.py:211-222``): in training, with ``block_type="block"``,
``"random"`` and ``"token_random50"`` keep ``kc * N`` of the C * N patch
tokens and ``"channel"`` and ``"channel_random50"`` keep the token groups of
``kc`` channels (``kc`` = ``token_keep_channels``, by default ceil(C / 2)), drawn
uniformly and the same for every sample, before the grid is padded: the
fused route then runs on the dropped grid (785 tokens padded to 832 at 8
channels of 196 patches and kc = 4).

PPT (``block_type="block_v2"``, JAX ``models/channel_vit.py:278-300``):
every block is a :class:`~.vit.BlockV2` on the **unpadded** grid, as in the
JAX package, with ``dropout_tokens_hcs`` ``"token_pruning"`` (each block
keeps ``max(1, cur_n * kc // C)`` of its ``cur_n`` non-CLS tokens) or
``"channel_pruning"`` (block 0 keeps ``kc`` channels); any other value
prunes nothing. The port's pad-once rule (ROADMAP C, "the pad rule") holds
for the grids it pads: a PPT grid changes length at every block, and its
channel pruning needs the channel-major grid without pad rows, so it is not
padded in the model; ``flash_attention_packed`` pads each block's q, k and
v to its multiple of 64 and slices the output back, so pad tokens enter
neither the attention nor the significance scores. No readout or EViT
layer applies, as in the JAX loop.
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
from ..ops.token_pruning import draw_kept, random_channel_drop, random_token_drop
from .vit import Block, BlockV2, draw_drop_path, init_block_

BLOCK_TYPES = ("block", "block_v2")


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
                 drop_path_rate: float = 0.0, block_type: str = "block",
                 dropout_tokens_hcs: Optional[str] = "none",
                 token_keep_channels: Optional[int] = None, fused_block: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if block_type not in BLOCK_TYPES:
            raise ValueError(f"block_type {block_type!r}: want one of {BLOCK_TYPES}")
        self.block_type = block_type
        self.dropout_tokens_hcs = dropout_tokens_hcs or "none"
        self.token_keep_channels = token_keep_channels
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
        self.drop_path_rate = float(drop_path_rate)
        dpr = [self.drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        block = BlockV2 if block_type == "block_v2" else Block
        self.blocks = nn.ModuleList(
            block(embed_dim, num_heads, mlp_ratio, qkv_bias, dtype=dtype, gelu_exact=gelu_exact,
                  quantization=quantization, attention_impl=attention_impl, drop_path=rate,
                  fused=fused_block)
            for rate in dpr
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
            init_block_(blk, g)
        self.norm.reset_parameters()

    def draw_drop_path(self, batch: int, generator: Optional[torch.Generator] = None,
                       device=None) -> list:
        """DropPath's per-sample keep masks of one training forward
        (:func:`~.vit.draw_drop_path`), on the model's device by default."""
        return draw_drop_path(self.blocks, batch, generator,
                              self.cls_token.device if device is None else device)

    def keep_channels(self, c: int) -> int:
        """``kc``: ``token_keep_channels``, or ceil(C / 2) of the forward's C
        channels (JAX ``models/channel_vit.py:214``)."""
        return self.token_keep_channels or max(1, math.ceil(0.5 * c))

    def token_dropout_on(self) -> bool:
        """Whether a training forward drops tokens (HCS token dropout)."""
        return self.block_type == "block" and self.dropout_tokens_hcs not in ("none", None)

    def draw_token_drop(self, c: int, n: int, generator: Optional[torch.Generator] = None,
                        device=None) -> Optional[torch.Tensor]:
        """The sorted indices HCS token dropout keeps in a training forward
        of ``c`` channels of ``n`` patches: ``kc * n`` tokens of ``c * n`` or
        ``kc`` channels of ``c``, drawn from ``generator``; None when the
        model drops nothing."""
        if not self.token_dropout_on():
            return None
        kc = self.keep_channels(c)
        device = self.cls_token.device if device is None else device
        if self.dropout_tokens_hcs in ("random", "token_random50"):
            return draw_kept(c * n, kc * n, generator, device)
        if self.dropout_tokens_hcs in ("channel", "channel_random50"):
            return draw_kept(c, kc, generator, device)
        raise ValueError(f"Unknown dropout_tokens_hcs: {self.dropout_tokens_hcs}")

    def forward(self, x: torch.Tensor, channel_ids: torch.Tensor,
                channel_embed_override: Optional[torch.Tensor] = None, *,
                taps: Optional[dict] = None, drop_path: Optional[list] = None,
                attention_layer: Optional[int] = None,
                token_drop: Optional[torch.Tensor] = None):
        """x: (B, C, H, W) with the channels already selected; channel_ids:
        (C,) global ids indexing the channel-embedding table.
        ``channel_embed_override``, (C, D) or per-sample (B, C, D), takes the
        selected rows' place (the novel-channel evals' synthesized
        embeddings); CDL is computed only for a (C, D) selection.

        ``taps``: a dict to fill with each block's output at the real
        tokens' rows, ``block_{i}`` (B, n_valid, D); the last block then
        runs at all rows. ``drop_path``: the DropPath
        masks of :meth:`draw_drop_path`, used in train mode only; drawn from
        torch's default generator when a train-mode forward at a rate above
        0 is given none. ``attention_layer``: also put that block's dense
        attention probabilities on its input into ``taps["attn_probs"]`` and
        the valid token count of its grid into ``taps["attn_valid"]``.
        ``token_drop``: the indices HCS token dropout keeps
        (:meth:`draw_token_drop`), used in train mode only; drawn from
        torch's default generator when a training forward that drops tokens
        is given none."""
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
            if channel_embed_override is not None:
                sel_embed = channel_embed_override
            else:
                sel_embed = pe.channel_embed.weight[channel_ids]  # (C, D) f32
                if self.freeze_channel_emb:  # neither CE nor CDL trains the table
                    sel_embed = sel_embed.detach()
            if self.training and self.proxy_loss_lambda > 0 and sel_embed.ndim == 2:
                # CDL: the selected channel embeddings against their proxies
                extra_loss = extra_loss + self.proxy_loss_lambda * proxy_loss(
                    pe.channel_emb_proxies[channel_ids], sel_embed,
                    torch.eye(c, dtype=torch.float32, device=x.device), self.channel_scale)
            tokens = add_channel_embedding(tokens, sel_embed.to(dt))
        tokens = tokens.reshape(b, c * n, dim)
        pos = interpolate_pos_embed(self.pos_embed, h // p, w // p, num_channels=c).to(dt)
        tokens = tokens + pos[:, 1:].repeat(1, c, 1)  # per-channel copy of the table
        cls = (self.cls_token.to(dt) + pos[:, :1]).expand(b, 1, dim)
        xseq = torch.cat([cls, tokens], dim=1)
        if self.training and self.token_dropout_on():
            if token_drop is None:
                token_drop = self.draw_token_drop(c, n, device=x.device)
            if self.dropout_tokens_hcs in ("random", "token_random50"):
                xseq = random_token_drop(xseq, token_drop.numel(), idx=token_drop)
            else:
                xseq = random_channel_drop(xseq, c, token_drop.numel(), idx=token_drop)
        depth = len(self.blocks)
        masks = [None] * depth
        if self.training and self.drop_path_rate > 0:
            masks = self.draw_drop_path(b, device=x.device) if drop_path is None else drop_path
        if attention_layer is not None:
            attention_layer %= depth
        if self.block_type == "block_v2":
            return self._ppt_blocks(xseq, c, masks, taps, attention_layer), extra_loss
        xseq, valid_len = maybe_pad_tokens(xseq)
        evit_on = self.keep_rate is not None and float(self.keep_rate) < 1.0
        evit_layers = {depth // 4, depth // 2, (3 * depth) // 4} if evit_on else set()
        # a tap sees every row of the last block, so it takes the full route
        readout = self.cls_only_readout and taps is None
        for i, blk in enumerate(self.blocks):
            if i == attention_layer:
                taps["attn_probs"] = blk.attention_probs(xseq, valid_len)
                taps["attn_valid"] = xseq.shape[1] if valid_len is None else valid_len
            if i in evit_layers:
                xseq, valid_len = blk.evit(xseq, float(self.keep_rate), valid_len, masks[i])
                if taps is not None:
                    taps[f"block_{i}"] = xseq[:, :valid_len]
                if valid_len is None:  # pruned: pad the fully valid grid again
                    xseq, valid_len = maybe_pad_tokens(xseq)
                continue
            xseq = blk(xseq, valid_len=valid_len, cls_query=readout and i == depth - 1,
                       drop=masks[i])
            if taps is not None:  # the real tokens' rows, not the pad
                taps[f"block_{i}"] = xseq[:, :valid_len]
        return self._cls_norm(xseq), extra_loss

    def _cls_norm(self, xseq: torch.Tensor) -> torch.Tensor:
        # LayerNorm is per token: norm only the CLS row that is read
        cls_out = F.layer_norm(xseq[:, :1].float(), (self.embed_dim,), self.norm.weight,
                               self.norm.bias, self.norm.eps)
        return cls_out[:, 0]

    def _ppt_blocks(self, xseq: torch.Tensor, c: int, masks: list, taps: Optional[dict],
                    attention_layer: Optional[int]) -> torch.Tensor:
        """The ``block_v2`` loop (JAX ``models/channel_vit.py:278-300``) on
        the unpadded grid: block i keeps ``max(1, cur_n * kc // c)`` tokens
        under token pruning, block 0 keeps ``kc`` channels under channel
        pruning. Returns the final CLS embedding."""
        kc = self.keep_channels(c)
        pruning = self.dropout_tokens_hcs
        if pruning not in ("token_pruning", "channel_pruning"):
            pruning = None
        for i, blk in enumerate(self.blocks):
            if i == attention_layer:
                taps["attn_probs"] = blk.attention_probs(xseq)
                taps["attn_valid"] = xseq.shape[1]
            cur_n = xseq.shape[1] - 1
            xseq = blk(xseq, pruning=pruning, keep_tokens=max(1, (cur_n * kc) // c),
                       keep_channels=kc if i == 0 else None, nc=c, drop=masks[i])
            if taps is not None:
                taps[f"block_{i}"] = xseq
        return self._cls_norm(xseq)


def attention_maps(model: nn.Module, x: torch.Tensor, channel_ids: torch.Tensor,
                   layer_idx: int = -1) -> Tuple[torch.Tensor, int]:
    """The dense attention probabilities of block ``layer_idx`` (negative
    counts from the end) in an eval forward without gradient, (B, H, N, N)
    f32 on the padded grid, and the grid's valid token count (JAX
    ``models/vit.py`` ``attention_maps``, the ``train.plot_attn`` source)."""
    taps: dict = {}
    was_training = model.training
    model.eval()
    with torch.no_grad():
        model(x, channel_ids, taps=taps, attention_layer=layer_idx)
    model.train(was_training)
    return taps["attn_probs"], int(taps["attn_valid"])
