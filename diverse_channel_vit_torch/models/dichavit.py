"""The DiChaViT and ChannelViT factories (counterpart of the JAX package's
``models/dichavit.py``: ``dichavit`` and ``channelvit_adapt``, one builder).

DiChaViT is the ChannelViT backbone; its diversity mechanisms (channel
sampling, CDL, TDL) act only in training. CDL and TDL are computed by the
backbone in train mode; channel sampling (DCS) happens in the train step
(``training/steps.py``, ``ops/sampling.py``). ``quantization: int8`` in the
model config runs the fused blocks' MLPs in int8 (the JAX config's
``model.quantization``; ``"none"`` when unset).
The JAX compile knobs ``scan_blocks`` and ``remat`` change nothing here: the
port's parameters always use the reference layout.

The other keys the JAX factory reads are honoured or refused:
``freeze_channel_emb`` stops the channel-embedding table's gradient;
``attention_impl`` (``auto``, ``pallas`` or ``xla``) routes the blocks as
the JAX ``Block._fused_ok`` does (``xla`` takes the unfused route), and so
does ``fused_block`` (``false`` takes the unfused route: JAX's process-wide
``set_fused_block`` from the same key, here a term of each block's gate);
``drop_path_rate`` sets DropPath's rate at the last block (0 at the first,
rising linearly); ``block_type`` (``block``, or ``block_v2`` for PPT's
pruning blocks), ``dropout_tokens_hcs`` (HCS token or channel dropout in
training: ``random``, ``token_random50``, ``channel``, ``channel_random50``;
PPT's ``token_pruning`` or ``channel_pruning`` with ``block_v2``) and
``token_keep_channels`` (kc, by default ceil(C / 2)) as the JAX factory
passes them on (``models/channel_vit.py``). ``drop_rate`` and
``attn_drop_rate`` are ignored, as the JAX factories ignore them: no JAX
factory reads either key, so JAX trains such a config without dropout.
"""

from __future__ import annotations

from typing import Optional

import torch

from .channel_vit import SIZE_PRESETS, ChannelVisionTransformer, apply_preset_overrides
from .registry import register_model
from .wrappers import ChannelAdaptiveClassifier


def _build_channel_vit(cfg_model, mapper: dict, num_classes: int, dtype: torch.dtype,
                       generator: Optional[torch.Generator]) -> ChannelAdaptiveClassifier:
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
        freeze_channel_emb=bool(cfg_model.get("freeze_channel_emb", False)),
        proxy_loss_lambda=cfg_model.get("proxy_loss_lambda", 0.0) or 0.0,
        ortho_loss_v1_lambda=cfg_model.get("ortho_loss_v1_lambda", 0.0) or 0.0,
        proxy_orthogonal_init=cfg_model.get("proxy_orthogonal_init", False),
        gamma_s=cfg_model.get("gamma_s", 1.0),
        gamma_d=cfg_model.get("gamma_d", 0.5),
        reverse_pos_pairs=cfg_model.get("reverse_pos_pairs", False),
        use_square=cfg_model.get("use_square", False),
        temperature=cfg_model.get("temperature", 0.11111),
        attention_impl=cfg_model.get("attention_impl", "auto") or "auto",
        cls_only_readout=bool(cfg_model.get("cls_only_readout", True)),
        keep_rate=cfg_model.get("keep_rate"),
        gelu_exact=bool(cfg_model.get("gelu_exact", False)),
        quantization=cfg_model.get("quantization") or "none",
        drop_path_rate=float(cfg_model.get("drop_path_rate", 0.0) or 0.0),
        block_type=cfg_model.get("block_type", "block") or "block",
        dropout_tokens_hcs=cfg_model.get("dropout_tokens_hcs", "none") or "none",
        token_keep_channels=cfg_model.get("token_keep_channels"),
        fused_block=bool(cfg_model.get("fused_block", True)),
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


@register_model("channelvit_adapt")
def channelvit_adapt(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32,
                     generator=None):
    """ChannelViT: the same builder under its own name (JAX
    ``models/dichavit.py:75-77``); DiChaViT's mechanisms stay off unless its
    config turns them on."""
    return _build_channel_vit(cfg_model, mapper, num_classes, dtype, generator)
