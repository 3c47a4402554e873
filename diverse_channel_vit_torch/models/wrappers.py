"""Model wrapper (counterpart of the JAX package's ``models/wrappers.py``):
backbone + class proxies (+ classifier head), in the PyTorch reference's
attribute layout (``feature_extractor``, ``proxies``,
``adaptive_interface.0``, ``logit_scale``, ``classifer_head`` [sic])."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.initializers import normal_div8_, trunc_normal_


class ChannelAdaptiveClassifier(nn.Module):
    """``forward`` returns ``(out, extra_loss)``: logits when the model has a
    head (non-CHAMMI datasets), else the CLS embedding."""

    def __init__(self, backbone: nn.Module, embed_dim: int, num_classes: int, with_head: bool,
                 learnable_temp: bool = False, temperature: float = 0.11111,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_extractor = backbone
        # class proxies for the proxy main loss; the reference registers them
        # a second time through adaptive_interface
        self.proxies = nn.Parameter(normal_div8_(torch.empty(num_classes, embed_dim), generator))
        self.adaptive_interface = nn.ParameterList([self.proxies])
        if learnable_temp:
            self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / temperature)))
        self.classifer_head = None
        if with_head:
            self.classifer_head = nn.Linear(embed_dim, num_classes)
            with torch.no_grad():
                trunc_normal_(self.classifer_head.weight, generator=generator)
                self.classifer_head.bias.zero_()

    @property
    def num_total_channels(self) -> int:
        return self.feature_extractor.num_total_channels

    def forward(self, x: torch.Tensor, channel_ids: torch.Tensor,
                channel_embed_override: Optional[torch.Tensor] = None, **backbone_kw):
        """``backbone_kw``: the backbone's ``taps``, ``drop_path`` and
        ``attention_layer``."""
        emb, extra_loss = self.feature_extractor(x, channel_ids, channel_embed_override,
                                                 **backbone_kw)
        out = emb if self.classifer_head is None else self.classifer_head(emb)
        return out, extra_loss


def model_scale(model: ChannelAdaptiveClassifier, learnable_temp: bool,
                temperature: float) -> torch.Tensor:
    """The proxy-loss scale: exp(logit_scale) if learnable, else sqrt(1/T)."""
    if learnable_temp:
        return torch.exp(model.logit_scale)
    return torch.tensor(math.sqrt(1.0 / temperature), dtype=torch.float32,
                        device=model.proxies.device)
