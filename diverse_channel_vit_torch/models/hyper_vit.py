"""HyperViT: a hypernetwork makes the first layer's kernels from channel
z-vectors (counterpart of the JAX package's ``models/hyper_vit.py``,
``HyperNetViT`` and the factory ``hypervit_adapt``).

Each global channel has a z-vector, a row of ``conv1_emb`` (C_total,
z_dim): scaled-orthogonal with ``orthogonal_init``, else N(0, 1) truncated
at +-2 (``nn.Embedding``'s default, as JAX draws it); ``freeze_z_emb`` stops
its gradient. ``channel_embed_override`` (C, z_dim) replaces the selected
rows (the novel-channel strategies synthesise z rows). The
:class:`~.hypernet.HyperNetwork` (``hidden_dim`` units, ``use_conv1x1``)
turns the selected rows into (D / 8, C, p, p) kernels in f32; the patches of
all channels go through them as one GEMM, (B, N, C*p*p) against
(C*p*p, D / 8), in the compute dtype with f32 accumulation (the
multi-channel convolution, summed over the channels), then ``conv1x1``, a
dense layer to D in the compute dtype, then the trunk (``models/trunk.py``).

The factory reads the keys the JAX factory reads: ``z_dim`` and
``hidden_dim`` (64 each when unset; ``model/hypervit_adapt.yaml`` sets 64
and 128), ``orthogonal_init``, ``use_conv1x1``, ``freeze_z_emb`` and the
trunk's. ``z_emb_init``, ``pooling`` and ``in_dim`` no JAX factory of this
model reads, so JAX trains with them ignored, and so does the port.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.initializers import lecun_normal_, orthogonal_, trunc_normal_
from ..ops.patch_embed import extract_patches
from .hypernet import HyperNetwork
from .registry import register_model
from .trunk import ViTTrunk, classifier, trunk_kwargs


class HyperNetViT(ViTTrunk):
    def __init__(self, num_total_channels: int, *, z_dim: int = 64, hidden_dim: int = 64,
                 orthogonal_init: bool = False, use_conv1x1: bool = False,
                 freeze_z_emb: bool = False, generator: Optional[torch.Generator] = None,
                 **trunk):
        super().__init__(num_total_channels, **trunk)
        g, dim = generator, self.embed_dim
        self.freeze_z_emb = freeze_z_emb
        self.conv1_emb = nn.Parameter(torch.empty(num_total_channels, z_dim))
        if orthogonal_init:
            orthogonal_(self.conv1_emb, generator=g)
        else:
            trunc_normal_(self.conv1_emb, std=1.0, generator=g)
        self.hypernet = HyperNetwork(z_dim, hidden_dim, self.patch_size, dim // 8, 1,
                                     use_conv1x1, generator=g)
        self.conv1x1 = nn.Linear(dim // 8, dim)
        lecun_normal_(self.conv1x1.weight, g)
        nn.init.zeros_(self.conv1x1.bias)
        self._init_trunk(g)

    def forward(self, x: torch.Tensor, channel_ids: torch.Tensor,
                channel_embed_override: Optional[torch.Tensor] = None, *,
                taps: Optional[dict] = None, drop_path: Optional[list] = None,
                attention_layer: Optional[int] = None, token_drop=None):
        b, c, h, w = x.shape
        p, dt = self.patch_size, self.dtype
        if channel_embed_override is None:
            table = self.conv1_emb.detach() if self.freeze_z_emb else self.conv1_emb
            z = table[channel_ids]  # (C, z_dim)
        else:
            z = channel_embed_override
        kernels = self.hypernet(z)  # (D/8, C, p, p) f32
        dim_out = kernels.shape[0]
        wk = kernels.reshape(dim_out, c * p * p).t().to(dt)  # (C*p*p, D/8)
        patches = extract_patches(x.to(dt), p)  # (B, C, N, p*p)
        n = patches.shape[2]
        tokens = torch.matmul(patches.transpose(1, 2).reshape(b, n, c * p * p), wk)
        tokens = F.linear(tokens, self.conv1x1.weight.to(dt), self.conv1x1.bias.to(dt))
        cls = self.run_trunk(tokens, h // p, w // p, taps=taps, drop_path=drop_path,
                             attention_layer=attention_layer)
        return cls, x.new_zeros((), dtype=torch.float32)


@register_model("hypervit_adapt")
def hypervit_adapt(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32,
                   generator=None):
    backbone = HyperNetViT(
        z_dim=cfg_model.get("z_dim") or 64,
        hidden_dim=cfg_model.get("hidden_dim") or 64,
        orthogonal_init=bool(cfg_model.get("orthogonal_init", False)),
        use_conv1x1=bool(cfg_model.get("use_conv1x1", False)),
        freeze_z_emb=bool(cfg_model.get("freeze_z_emb", False)),
        dtype=dtype, generator=generator, **trunk_kwargs(cfg_model))
    return classifier(backbone, cfg_model, mapper, num_classes, generator)
