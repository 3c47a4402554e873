"""TemplateMixingViT: the first layer mixed from a shared bank of templates
(counterpart of the JAX package's ``models/template_mixing_vit.py``,
``TemplateMixingViT`` and the factory ``templatemixingvit``).

A bank ``conv1_param_bank`` (D / 8, T, k, k), kaiming-normal, and per-channel
coefficients ``conv1_coefs`` (C_total, T), orthogonal: channel c's kernel is
``sum_t coefs[c, t] * bank[:, t]`` (``channel_embed_override`` (C, T)
replaces the selected coefficient rows). The stem is a k x k convolution
with stride ``patch_size`` and no padding, so each token sees the top-left
k x k of its patch (a 3 x 3 kernel at stride 16: not a patch embedding).
It runs in f32, as the JAX stem does, and without TF32: an im2col
(``F.unfold``) and an f32 matmul, under PyTorch's default of no TF32 for
matmuls (a cuDNN convolution would take TF32 by default). Then
``conv1x1``, a dense layer to D in the compute dtype, then the trunk
(``models/trunk.py``) on the (h', w') grid the stem leaves.

The factory reads the keys the JAX factory reads: ``num_templates`` (64
when unset; ``model/templatemixingvit.yaml`` sets 10) and the trunk's. The
kernel size is 3, as in JAX, which reads no key for it. ``separate_coef``,
``pooling`` and ``in_dim`` no JAX factory of this model reads, so JAX trains
with them ignored, and so does the port.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.initializers import kaiming_normal_, lecun_normal_, orthogonal_
from .registry import register_model
from .trunk import ViTTrunk, classifier, trunk_kwargs


class TemplateMixingViT(ViTTrunk):
    def __init__(self, num_total_channels: int, *, num_templates: int = 64,
                 kernel_size: int = 3, generator: Optional[torch.Generator] = None, **trunk):
        super().__init__(num_total_channels, **trunk)
        g, dim, k = generator, self.embed_dim, kernel_size
        self.kernel_size = k
        self.conv1_param_bank = nn.Parameter(kaiming_normal_(
            torch.empty(dim // 8, num_templates, k, k), generator=g))
        self.conv1_coefs = nn.Parameter(orthogonal_(
            torch.empty(num_total_channels, num_templates), generator=g))
        self.conv1x1 = nn.Linear(dim // 8, dim)
        lecun_normal_(self.conv1x1.weight, g)
        nn.init.zeros_(self.conv1x1.bias)
        self._init_trunk(g)

    def forward(self, x: torch.Tensor, channel_ids: torch.Tensor,
                channel_embed_override: Optional[torch.Tensor] = None, *,
                taps: Optional[dict] = None, drop_path: Optional[list] = None,
                attention_layer: Optional[int] = None, token_drop=None):
        b, c, h, w = x.shape
        p, k, dt = self.patch_size, self.kernel_size, self.dtype
        coefs = self.conv1_coefs[channel_ids] if channel_embed_override is None \
            else channel_embed_override  # (C, T)
        kernels = torch.einsum("ct,othw->ochw", coefs, self.conv1_param_bank)  # (D/8, C, k, k)
        cols = F.unfold(x.float(), k, stride=p)  # (B, C*k*k, h' * w')
        y = torch.matmul(kernels.reshape(kernels.shape[0], c * k * k), cols)  # (B, D/8, h'w')
        tokens = y.transpose(1, 2).to(dt)
        tokens = F.linear(tokens, self.conv1x1.weight.to(dt), self.conv1x1.bias.to(dt))
        h0, w0 = (h - k) // p + 1, (w - k) // p + 1
        cls = self.run_trunk(tokens, h0, w0, taps=taps, drop_path=drop_path,
                             attention_layer=attention_layer)
        return cls, x.new_zeros((), dtype=torch.float32)


@register_model("templatemixingvit")
def templatemixingvit(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32,
                      generator=None):
    backbone = TemplateMixingViT(num_templates=cfg_model.get("num_templates") or 64,
                                 dtype=dtype, generator=generator, **trunk_kwargs(cfg_model))
    return classifier(backbone, cfg_model, mapper, num_classes, generator)
