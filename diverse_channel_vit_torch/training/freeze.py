"""Parameter freezing / selective training (the port's own copy of the JAX
package's ``training/freeze.py``; the reference's freeze helpers,
``model_utils.py:21-42``).

- ``model.freeze_other``: train only the adaptive interface (the
  channel-specific first-layer parameters) and the heads; freeze the trunk.
- ``model.unfreeze_last_n_layers`` (-1 = all): train only the last n
  transformer blocks, the final norm and the heads / proxies (plus the
  interface when ``model.unfreeze_first_layer``).

The rules are JAX's, its patterns and block regex included, applied to
each parameter's JAX path (``models.export.jax_param_path``, the carrier's
name map: ``feature_extractor.blocks.3.attn.qkv.weight`` ->
``backbone/block_3/attn/qkv/weight``, ``classifer_head.weight`` [sic] ->
``classifier_head/weight``), so every model's labels are JAX's leaf for
leaf. JAX's block regex ``block_(\\d+)`` finds no block in a ConvNeXt tree
(``stage{s}_block{b}``): ``unfreeze_last_n_layers`` then raises there as in
JAX, and ``freeze_other`` trains the stems, the channel pooling, the heads
and every block's ``norm``. A frozen parameter leaves the optimizer
(``training/state.TrainState``'s ``frozen``): no update, no weight decay,
no moments, as optax's ``set_to_zero`` partition. It keeps
``requires_grad``, so the backward still produces its gradient (as JAX's
does) and the logged ``grad_norm`` counts it.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..models.export import jax_param_path

# the channel-specific first layer ("adaptive interface") across the zoo and
# the heads, JAX's lists
INTERFACE_PATTERNS = (
    r"channel_embed", r"channel_emb_proxies", r"proj_kernel", r"proj_bias",
    r"proj_bank", r"depthwise_bank", r"conv1_emb", r"conv1_coefs",
    r"conv1_param_bank", r"conv1depthwise_param_bank", r"hypernet",
    r"stem_conv", r"stem_bias", r"patch_emb", r"weighted_sum_pooling",
    r"class_emb", r"attn_pooling",
)
HEAD_PATTERNS = (r"proxies", r"classifier_head", r"logit_scale", r"(^|/)norm(/|$)",
                 r"miro_encoders")
_BLOCK_RE = re.compile(r"block_(\d+)")


def build_trainable_labels(
    named_params: Iterable[Tuple[str, torch.Tensor]],
    *,
    freeze_other: bool = False,
    unfreeze_last_n_layers: int = -1,
    unfreeze_first_layer: bool = True,
) -> Dict[str, str]:
    """``{name: "train" | "freeze"}`` for each parameter, by JAX's
    ``build_trainable_labels`` rules on each parameter's JAX path."""
    paths = {n: jax_param_path(n) for n, _ in named_params}
    names = list(paths)

    def is_interface(p: str) -> bool:
        return any(re.search(pat, paths[p]) for pat in INTERFACE_PATTERNS)

    def is_head(p: str) -> bool:
        return any(re.search(pat, paths[p]) for pat in HEAD_PATTERNS)

    def block_index(p: str) -> Optional[int]:
        m = _BLOCK_RE.search(paths[p])
        return int(m.group(1)) if m else None

    max_block = max((b for b in map(block_index, names) if b is not None), default=-1)
    total_depth = max_block + 1
    last_n = -1 if unfreeze_last_n_layers is None else int(unfreeze_last_n_layers)
    if last_n >= 0 and not freeze_other and max_block < 0:
        raise ValueError("unfreeze_last_n_layers >= 0 but no transformer blocks found among the "
                         "parameters: freezing would silently cover every block")

    def label(p: str) -> str:
        if freeze_other:
            return "train" if is_interface(p) or is_head(p) else "freeze"
        if last_n >= 0:
            bi = block_index(p)
            if bi is not None:
                return "train" if bi >= total_depth - last_n else "freeze"
            if is_interface(p):
                return "train" if unfreeze_first_layer else "freeze"
            return "train" if is_head(p) else "freeze"
        return "train"

    return {n: label(n) for n in names}


def frozen_names(labels: Dict[str, str]) -> set:
    return {n for n, lab in labels.items() if lab == "freeze"}
