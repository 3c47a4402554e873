"""ViTAdapt, the plain-ViT baseline with a channel-sliceable first layer
(counterpart of the JAX package's ``models/vit_adapt.py``,
``SlicedPatchVisionTransformer`` and the factory ``vit_adapt``).

The first layer is a bank ``proj_bank`` (C_total, p*p, D) indexed by the
global channel ids, and ``proj_bias`` (D,): the selected channels' patch
projections summed over the channels, which is the reference's
multi-channel Conv2d. Here that sum is one GEMM, the (B, N, C*p*p) patches
against the gathered (C*p*p, D) bank, in the compute dtype with f32
accumulation (the JAX einsum's ``preferred_element_type``). Then the shared
trunk (``models/trunk.py``); the JAX module runs the same loop inline, with
the same parameter names.

``channel_embed_override`` is taken and ignored, as JAX ignores it: the
model has no per-channel table to override. The factory reads the keys the
JAX factory reads (``models/trunk.trunk_kwargs``, ``learnable_temp``,
``temperature``). The rest of ``model/vit_adapt.yaml`` (``pooling``,
``in_dim``, ``use_channelvit_channels``, ``orthogonal_channel_emb_init``,
``freeze_channel_emb``, ``keep_rate``, ``block_type``,
``dropout_tokens_hcs``) no JAX factory of this model reads, so JAX trains
such a config with them ignored, and the port ignores them too.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.initializers import conv_patch_
from ..ops.patch_embed import extract_patches
from .registry import register_model
from .trunk import ViTTrunk, classifier, trunk_kwargs


class SlicedPatchVisionTransformer(ViTTrunk):
    """ViT with a per-channel first-layer weight bank; ``forward`` returns the
    f32 CLS embedding (B, D) and an f32 zero."""

    def __init__(self, num_total_channels: int, *, generator: Optional[torch.Generator] = None,
                 **trunk):
        super().__init__(num_total_channels, **trunk)
        p, dim = self.patch_size, self.embed_dim
        self.proj_bank = nn.Parameter(torch.empty(num_total_channels, p * p, dim))
        self.proj_bias = nn.Parameter(torch.zeros(dim))
        # fan_in of the reference's Conv2d(C_total, D, p)
        conv_patch_(self.proj_bank, num_total_channels * p * p, generator)
        self._init_trunk(generator)

    def forward(self, x: torch.Tensor, channel_ids: torch.Tensor,
                channel_embed_override: Optional[torch.Tensor] = None, *,
                taps: Optional[dict] = None, drop_path: Optional[list] = None,
                attention_layer: Optional[int] = None, token_drop=None):
        b, c, h, w = x.shape
        p, dt = self.patch_size, self.dtype
        patches = extract_patches(x.to(dt), p)  # (B, C, N, p*p)
        n = patches.shape[2]
        wk = self.proj_bank[channel_ids].to(dt).reshape(c * p * p, self.embed_dim)
        tokens = torch.matmul(patches.transpose(1, 2).reshape(b, n, c * p * p), wk)
        tokens = tokens + self.proj_bias.to(dt)
        cls = self.run_trunk(tokens, h // p, w // p, taps=taps, drop_path=drop_path,
                             attention_layer=attention_layer)
        return cls, x.new_zeros((), dtype=torch.float32)


@register_model("vit_adapt")
def vit_adapt(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32, generator=None):
    backbone = SlicedPatchVisionTransformer(dtype=dtype, generator=generator,
                                            **trunk_kwargs(cfg_model))
    return classifier(backbone, cfg_model, mapper, num_classes, generator)
