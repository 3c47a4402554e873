"""Parameter freezing / selective training (the port's own copy of the JAX
package's ``training/freeze.py``; the reference's freeze helpers,
``model_utils.py:21-42``).

- ``model.freeze_other``: train only the adaptive interface (the
  channel-specific first-layer parameters) and the heads; freeze the trunk.
- ``model.unfreeze_last_n_layers`` (-1 = all): train only the last n
  transformer blocks, the final norm and the heads / proxies (plus the
  interface when ``model.unfreeze_first_layer``).

The rules are JAX's, applied to the port's parameter names (the PyTorch
reference's layout: ``feature_extractor.patch_embed.proj.weight``,
``feature_extractor.blocks.3.attn.qkv.weight``, ``classifer_head.weight``
[sic], ``miro_encoders.block_0``). A frozen parameter leaves the optimizer
(``training/state.TrainState``'s ``frozen``): no update, no weight decay,
no moments, as optax's ``set_to_zero`` partition. It keeps
``requires_grad``, so the backward still produces its gradient (as JAX's
does) and the logged ``grad_norm`` counts it.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple

import torch

# the channel-specific first layer of the port's models (JAX's list, by the
# port's names): ChannelViT's patch projection, channel-embedding table and
# CDL proxies (JAX: proj_kernel, proj_bias, channel_embed,
# channel_emb_proxies); ViTAdapt's bank and bias; DepthwiseViT's bank and
# channel pooling; HyperViT's z-vectors and hypernetwork; TemplateMixingViT's
# coefficients and template bank
INTERFACE_PATTERNS = (r"channel_embed", r"channel_emb_proxies", r"(^|\.)patch_embed\.proj\.",
                      r"proj_bank", r"proj_bias", r"depthwise_bank", r"conv1_emb",
                      r"conv1_coefs", r"conv1_param_bank", r"hypernet", r"attn_pooling")
HEAD_PATTERNS = (r"proxies", r"classifer_head", r"logit_scale", r"(^|\.)norm(\.|$)",
                 r"miro_encoders")
_BLOCK_RE = re.compile(r"(^|\.)blocks\.(\d+)\.")


def _block_index(name: str) -> Optional[int]:
    m = _BLOCK_RE.search(name)
    return int(m.group(2)) if m else None


def build_trainable_labels(
    named_params: Iterable[Tuple[str, torch.Tensor]],
    *,
    freeze_other: bool = False,
    unfreeze_last_n_layers: int = -1,
    unfreeze_first_layer: bool = True,
) -> Dict[str, str]:
    """``{name: "train" | "freeze"}`` for each parameter, by JAX's
    ``build_trainable_labels`` rules."""
    names = [n for n, _ in named_params]

    def is_interface(p: str) -> bool:
        return any(re.search(pat, p) for pat in INTERFACE_PATTERNS)

    def is_head(p: str) -> bool:
        return any(re.search(pat, p) for pat in HEAD_PATTERNS)

    max_block = max((b for b in map(_block_index, names) if b is not None), default=-1)
    total_depth = max_block + 1
    last_n = -1 if unfreeze_last_n_layers is None else int(unfreeze_last_n_layers)
    if last_n >= 0 and not freeze_other and max_block < 0:
        raise ValueError("unfreeze_last_n_layers >= 0 but no transformer blocks found among the "
                         "parameters: freezing would silently cover every block")

    def label(p: str) -> str:
        if freeze_other:
            return "train" if is_interface(p) or is_head(p) else "freeze"
        if last_n >= 0:
            bi = _block_index(p)
            if bi is not None:
                return "train" if bi >= total_depth - last_n else "freeze"
            if is_interface(p):
                return "train" if unfreeze_first_layer else "freeze"
            return "train" if is_head(p) else "freeze"
        return "train"

    return {n: label(n) for n in names}


def frozen_names(labels: Dict[str, str]) -> set:
    return {n for n, lab in labels.items() if lab == "freeze"}
