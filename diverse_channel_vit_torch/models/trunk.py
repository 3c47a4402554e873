"""Shared ViT trunk of the baseline models (counterpart of the JAX package's
``models/trunk.py``, ``ViTTrunk``): CLS token, positional table and
transformer blocks over an already embedded token grid (B, N, D).

The JAX package makes the trunk a submodule (``trunk/block_{i}``) of
DepthwiseViT, HyperNetViT and TemplateMixingViT, and repeats its loop inline
in ``vit_adapt``. Here :class:`ViTTrunk` is the base class of the four
backbones, so its parameters sit at the backbone's top level in the
reference's names: ``cls_token``, ``pos_embed``, ``blocks.{i}`` and
``norm``. Freezing (``training/freeze.py``), MIRO's taps and encoders
(``training/miro.py``), ``attention_maps`` and DropPath's rate schedule then
work on them as on ChannelViT's.

:meth:`ViTTrunk.run_trunk` is the JAX ``ViTTrunk.__call__`` without
dropout: the positional table resampled to the (h0, w0) grid (no resample at
the native grid), the CLS row, one pad of the grid to the kernels' multiple
of 64 with ``valid_len`` (``ops/attention.maybe_pad_tokens``), the blocks
(the same :class:`~.vit.Block` as ChannelViT's, so ``fused_route_ok``
routes them to B1-B4 or to the unfused route), the last block as the
CLS-only readout unless ``cls_only_readout`` is off or taps are asked for,
then the final LayerNorm on the CLS row alone, in f32.

The process-wide JAX flags become keys of each model: ``gelu_exact``,
``quantization`` and ``fused_block`` reach every block, as do
``attention_impl`` and ``drop_path_rate`` (DropPath's rate rising linearly
from 0 at the first block). No trunk drops tokens: ``token_dropout_on`` is
False, as no JAX trunk reads ``dropout_tokens_hcs``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import maybe_pad_tokens
from ..ops.initializers import trunc_normal_
from .channel_vit import SIZE_PRESETS, apply_preset_overrides, interpolate_pos_embed
from .vit import Block, draw_drop_path, init_block_
from .wrappers import ChannelAdaptiveClassifier


class ViTTrunk(nn.Module):
    """Base of the baseline backbones: ``num_total_channels`` sizes their
    per-channel tables, ``dtype`` is the compute dtype (parameters are f32)."""

    def __init__(self, num_total_channels: int, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, attention_impl: str = "auto",
                 cls_only_readout: bool = True, gelu_exact: bool = False,
                 quantization: str = "none", drop_path_rate: float = 0.0,
                 fused_block: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_total_channels = num_total_channels
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.cls_only_readout = cls_only_readout
        self.dtype = dtype
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, (img_size // patch_size) ** 2 + 1, embed_dim))
        self.drop_path_rate = float(drop_path_rate)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, dtype=dtype, gelu_exact=gelu_exact,
                  quantization=quantization, attention_impl=attention_impl,
                  drop_path=self.drop_path_rate * i / max(depth - 1, 1), fused=fused_block)
            for i in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    @torch.no_grad()
    def _init_trunk(self, g: Optional[torch.Generator]) -> None:
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

    def token_dropout_on(self) -> bool:
        return False

    def run_trunk(self, tokens: torch.Tensor, h0: int, w0: int, *,
                  taps: Optional[dict] = None, drop_path: Optional[list] = None,
                  attention_layer: Optional[int] = None) -> torch.Tensor:
        """tokens (B, h0 * w0, D) -> the f32 CLS embedding (B, D). ``taps``,
        ``drop_path`` and ``attention_layer`` as in
        ``ChannelVisionTransformer.forward``."""
        b, _, dim = tokens.shape
        dt = self.dtype
        pos = interpolate_pos_embed(self.pos_embed, h0, w0).to(dt)
        cls = (self.cls_token.to(dt) + pos[:, :1]).expand(b, 1, dim)
        xseq = torch.cat([cls, tokens.to(dt) + pos[:, 1:]], dim=1)
        xseq, valid_len = maybe_pad_tokens(xseq)
        depth = len(self.blocks)
        masks = [None] * depth
        if self.training and self.drop_path_rate > 0:
            masks = self.draw_drop_path(b, device=tokens.device) if drop_path is None else drop_path
        if attention_layer is not None:
            attention_layer %= depth
        # a tap sees every row of the last block, so it takes the full route
        readout = self.cls_only_readout and taps is None
        for i, blk in enumerate(self.blocks):
            if i == attention_layer:
                taps["attn_probs"] = blk.attention_probs(xseq, valid_len)
                taps["attn_valid"] = xseq.shape[1] if valid_len is None else valid_len
            xseq = blk(xseq, valid_len=valid_len, cls_query=readout and i == depth - 1,
                       drop=masks[i])
            if taps is not None:  # the real tokens' rows, not the pad
                taps[f"block_{i}"] = xseq[:, :valid_len]
        # LayerNorm is per token: norm only the CLS row that is read
        return F.layer_norm(xseq[:, 0].float(), (dim,), self.norm.weight, self.norm.bias,
                            self.norm.eps)


def trunk_kwargs(cfg_model) -> dict:
    """The trunk's keys as a JAX baseline factory reads them from the model
    config (the size preset with its ``embed_dim`` / ``depth`` /
    ``num_heads`` overrides, ``img_size``, ``patch_size``,
    ``drop_path_rate``, ``attention_impl``, ``cls_only_readout``), plus the
    JAX process-wide ``gelu_exact``, ``quantization`` and ``fused_block``,
    read from the same config."""
    preset = apply_preset_overrides(
        SIZE_PRESETS[cfg_model.get("pretrained_model_name", "small")], cfg_model)
    img_size = cfg_model.get("img_size") or [224]
    return dict(
        num_total_channels=len(cfg_model.in_channel_names),
        img_size=img_size[0] if isinstance(img_size, (list, tuple)) else img_size,
        patch_size=cfg_model.get("patch_size", 16),
        drop_path_rate=float(cfg_model.get("drop_path_rate", 0.0) or 0.0),
        attention_impl=cfg_model.get("attention_impl", "auto") or "auto",
        cls_only_readout=bool(cfg_model.get("cls_only_readout", True)),
        gelu_exact=bool(cfg_model.get("gelu_exact", False)),
        quantization=cfg_model.get("quantization") or "none",
        fused_block=bool(cfg_model.get("fused_block", True)),
        **preset,
    )


def classifier(backbone: ViTTrunk, cfg_model, mapper: dict, num_classes: int,
               generator: Optional[torch.Generator]) -> ChannelAdaptiveClassifier:
    """The backbone with its class proxies and head, as every JAX factory
    wraps it."""
    return ChannelAdaptiveClassifier(
        backbone=backbone,
        embed_dim=backbone.embed_dim,
        num_classes=num_classes,
        with_head="Allen" not in mapper,  # CHAMMI is evaluated on features
        learnable_temp=cfg_model.get("learnable_temp", False),
        temperature=cfg_model.get("temperature", 0.11111),
        generator=generator,
    )
