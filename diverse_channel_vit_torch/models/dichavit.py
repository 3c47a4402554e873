"""The DiChaViT factory (counterpart of the JAX package's
``models/dichavit.py``).

DiChaViT is the ChannelViT backbone; its diversity mechanisms (channel
sampling, CDL, TDL) act only in training, so at inference they show only in
the parameters it carries (``channel_emb_proxies`` with CDL on).
The JAX compile knobs ``scan_blocks`` and ``remat`` change nothing here: the
port's parameters always use the reference layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from .channel_vit import SIZE_PRESETS, ChannelVisionTransformer, apply_preset_overrides
from .registry import register_model
from .wrappers import ChannelAdaptiveClassifier


def _build_channel_vit(cfg_model, mapper: dict, num_classes: int, dtype: torch.dtype,
                       generator: Optional[torch.Generator]) -> ChannelAdaptiveClassifier:
    if (cfg_model.get("block_type", "block") or "block") != "block":
        raise NotImplementedError("block_type other than 'block' (PPT blocks, ROADMAP A8)")
    keep_rate = cfg_model.get("keep_rate")
    if keep_rate is not None and float(keep_rate) < 1.0:
        raise NotImplementedError("EViT token pruning (keep_rate < 1, ROADMAP A8)")
    if cfg_model.get("gelu_exact", False):
        raise NotImplementedError(
            "gelu_exact needs the unfused block route, which is not ported yet "
            "(ROADMAP B5); the fused route computes tanh-GELU"
        )
    preset = apply_preset_overrides(
        SIZE_PRESETS[cfg_model.get("pretrained_model_name", "small")], cfg_model
    )
    img_size = cfg_model.get("img_size") or [224]
    backbone = ChannelVisionTransformer(
        num_total_channels=len(cfg_model.in_channel_names),
        img_size=img_size[0] if isinstance(img_size, (list, tuple)) else img_size,
        patch_size=cfg_model.get("patch_size", 16),
        use_channelvit_channels=cfg_model.get("use_channelvit_channels", True),
        orthogonal_channel_emb_init=cfg_model.get("orthogonal_channel_emb_init", False),
        proxy_loss_lambda=cfg_model.get("proxy_loss_lambda", 0.0) or 0.0,
        proxy_orthogonal_init=cfg_model.get("proxy_orthogonal_init", False),
        cls_only_readout=bool(cfg_model.get("cls_only_readout", True)),
        dtype=dtype,
        generator=generator,
        **preset,
    )
    return ChannelAdaptiveClassifier(
        backbone=backbone,
        embed_dim=preset["embed_dim"],
        num_classes=num_classes,
        with_head="Allen" not in mapper,  # CHAMMI is evaluated on features
        learnable_temp=cfg_model.get("learnable_temp", False),
        temperature=cfg_model.get("temperature", 0.11111),
        generator=generator,
    )


@register_model("dichavit")
def dichavit(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32, generator=None):
    return _build_channel_vit(cfg_model, mapper, num_classes, dtype, generator)
