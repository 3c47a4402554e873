"""DepthwiseViT: per-channel depthwise patch kernels, channel pooling, the
shared trunk (counterpart of the JAX package's ``models/depthwise_vit.py``,
``DepthwiseViT`` and the factory ``depthwisevit_adapt``).

The reference's grouped convolution over a ``(C_total * D, 1, p, p)`` bank
is here, as in the JAX package, a bank ``depthwise_bank`` (C_total, p*p, D)
gathered by global channel id and applied to each channel's patches: one
batched (B*N, p*p) x (p*p, D) product per channel, giving the (B, C, N, D)
token grid, in the compute dtype with f32 accumulation. The JAX module
upcasts this product to f32 on the CPU only (XLA:CPU cannot run the
c-batched bf16 dot); the port keeps the compute dtype everywhere, and the
CPU tests hold the f32 model to JAX's. Then the ``channel_embed`` row of
each channel is added (``channel_embed_override``, (C, D) or per-sample
(B, C, D), in its place; the JAX module broadcasts only a (C, D) override
correctly), and the channels are pooled:

- ``pooling_channel_type: channel_weights``: a learned weight per channel,
  ``channel_weights`` (C_total,) initialised to 1 / C_total plus 0.002 N(0, 1),
  gathered and contracted with the C axis in the compute dtype;
- ``attention``: :class:`~.channel_attention_pooling.ChannelAttentionPoolingLayer`
  (``attn_pooling``, the ``attn_pooling`` config group; its ``dim`` and
  ``max_num_channels`` are the model's), in f32.

The pooled (B, N, D) grid goes through the trunk (``models/trunk.py``).
The factory reads the keys the JAX factory reads. ``kernels_per_channel``,
``pooling`` and ``in_dim`` of ``model/depthwisevit_adapt.yaml`` no JAX
factory of this model reads, so JAX trains with them ignored, and so does
the port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.initializers import kaiming_normal_, normal_, trunc_normal_
from ..ops.patch_embed import add_channel_embedding, extract_patches
from .channel_attention_pooling import ChannelAttentionPoolingLayer
from .registry import register_model
from .trunk import ViTTrunk, classifier, trunk_kwargs

POOLING_TYPES = ("channel_weights", "attention")


class DepthwiseViT(ViTTrunk):
    def __init__(self, num_total_channels: int, *, pooling_channel_type: str = "channel_weights",
                 attn_pooling: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, **trunk):
        super().__init__(num_total_channels, **trunk)
        if pooling_channel_type not in POOLING_TYPES:
            raise ValueError("pooling_channel_type must be channel_weights or attention")
        g, p, dim = generator, self.patch_size, self.embed_dim
        self.pooling_channel_type = pooling_channel_type
        self.depthwise_bank = nn.Parameter(torch.empty(num_total_channels, p * p, dim))
        self.channel_embed = nn.Parameter(torch.empty(num_total_channels, dim))
        # the reference's grouped-conv bank: kaiming fan_in p * p
        kaiming_normal_(self.depthwise_bank, p * p, generator=g)
        trunc_normal_(self.channel_embed, generator=g)
        if pooling_channel_type == "channel_weights":
            cw = normal_(torch.empty(num_total_channels), 0.002, g) + 1.0 / num_total_channels
            self.channel_weights = nn.Parameter(cw)
        else:
            ap = {k: v for k, v in (attn_pooling or {}).items()
                  if v is not None and k not in ("dim", "max_num_channels")}
            self.attn_pooling = ChannelAttentionPoolingLayer(
                num_total_channels, dim, gelu_exact=self.blocks[0].gelu_exact, generator=g, **ap)
        self._init_trunk(g)

    def forward(self, x: torch.Tensor, channel_ids: torch.Tensor,
                channel_embed_override: Optional[torch.Tensor] = None, *,
                taps: Optional[dict] = None, drop_path: Optional[list] = None,
                attention_layer: Optional[int] = None, token_drop=None):
        b, c, h, w = x.shape
        p, dt = self.patch_size, self.dtype
        wk = self.depthwise_bank[channel_ids].to(dt)  # (C, p*p, D)
        patches = extract_patches(x.to(dt), p)  # (B, C, N, p*p)
        tokens = torch.matmul(patches.transpose(0, 1), wk[:, None]).transpose(0, 1)
        emb = (self.channel_embed[channel_ids] if channel_embed_override is None
               else channel_embed_override)
        tokens = add_channel_embedding(tokens, emb.to(dt))  # (B, C, N, D)
        if self.pooling_channel_type == "channel_weights":
            cw = self.channel_weights[channel_ids].to(dt)
            pooled = torch.einsum("bcnd,c->bnd", tokens, cw)
        else:
            pooled = self.attn_pooling(tokens, channel_ids)
        cls = self.run_trunk(pooled, h // p, w // p, taps=taps, drop_path=drop_path,
                             attention_layer=attention_layer)
        return cls, x.new_zeros((), dtype=torch.float32)


@register_model("depthwisevit_adapt")
def depthwisevit_adapt(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32,
                       generator=None, attn_pooling=None):
    """``attn_pooling``: the ``attn_pooling`` config group as a dict, read
    with ``pooling_channel_type: attention`` (its defaults when None)."""
    backbone = DepthwiseViT(
        pooling_channel_type=cfg_model.get("pooling_channel_type") or "channel_weights",
        attn_pooling=attn_pooling, dtype=dtype, generator=generator, **trunk_kwargs(cfg_model))
    return classifier(backbone, cfg_model, mapper, num_classes, generator)
