"""Weight carrier: the JAX package's flax parameter tree -> the port's
``state_dict`` (the port's own copy of the mapping in the JAX package's
``models/export.py``).

The target is the PyTorch reference's layout, which the port's modules use:

- ``proj_kernel (p*p, D)``      -> ``patch_embed.proj.weight (D, 1, 1, p, p)``
- ``attn.{wq,wk,wv}.kernel.T``  -> rows ``[q | k | v]`` of ``attn.qkv.weight``
- LayerNorm ``scale``/``bias``  -> ``weight``/``bias``
- every Dense ``kernel``        -> transposed ``weight``
- ``classifier_head``           -> ``classifer_head`` [sic]

- ``miro_encoders/backbone/block_{i}/__call__/[0]`` (MIRO's VarianceEncoder
  biases, beside the model in JAX's ``state.params``) -> ``miro_encoders.block_{i}``

Both JAX block layouts carry over: unrolled ``block_{i}`` modules and the
``scan_blocks`` stack (``blocks/blocks/block`` leaves with a leading depth
axis, as flax builds it; the JAX exporter expects ``blocks/block``, which is
taken as well).
"""

from __future__ import annotations

import math
import re
from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_from_jax"]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _index_tree(tree, i: int):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _block_state(out: "OrderedDict[str, np.ndarray]", prefix: str, blk: Dict[str, Any]):
    attn = blk["attn"]
    out[prefix + "norm1.weight"] = _np(blk["norm1"]["scale"])
    out[prefix + "norm1.bias"] = _np(blk["norm1"]["bias"])
    out[prefix + "attn.qkv.weight"] = np.concatenate(
        [_np(attn[w]["kernel"]).T for w in ("wq", "wk", "wv")], axis=0
    )
    if "bias" in attn["wq"]:
        out[prefix + "attn.qkv.bias"] = np.concatenate(
            [_np(attn[w]["bias"]) for w in ("wq", "wk", "wv")]
        )
    out[prefix + "attn.proj.weight"] = _np(attn["proj"]["kernel"]).T
    out[prefix + "attn.proj.bias"] = _np(attn["proj"]["bias"])
    out[prefix + "norm2.weight"] = _np(blk["norm2"]["scale"])
    out[prefix + "norm2.bias"] = _np(blk["norm2"]["bias"])
    for fc in ("fc1", "fc2"):
        out[prefix + f"mlp.{fc}.weight"] = _np(blk["mlp"][fc]["kernel"]).T
        out[prefix + f"mlp.{fc}.bias"] = _np(blk["mlp"][fc]["bias"])


def params_from_jax(params: Dict[str, Any], *,
                    prefix: str = "feature_extractor.") -> "OrderedDict[str, torch.Tensor]":
    """Flax param tree (nested dicts of arrays, numpy or any array type
    ``np.asarray`` reads) -> the port's ``state_dict``.

    Accepts the trainer's full tree (``{"backbone": ..., "proxies",
    ["logit_scale"], ["classifier_head"], ["miro_encoders"]}``) or a bare
    backbone tree.
    """
    bb = params.get("backbone", params)
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()

    pk = _np(bb["proj_kernel"])  # (p*p, D)
    p = int(math.isqrt(pk.shape[0]))
    if p * p != pk.shape[0]:
        raise ValueError(f"proj_kernel rows {pk.shape[0]} is not a square patch")
    out[prefix + "patch_embed.proj.weight"] = pk.T.reshape(pk.shape[1], 1, 1, p, p)
    out[prefix + "patch_embed.proj.bias"] = _np(bb["proj_bias"])
    out[prefix + "patch_embed.channel_embed.weight"] = _np(bb["channel_embed"])
    if "channel_emb_proxies" in bb:
        out[prefix + "patch_embed.channel_emb_proxies"] = _np(bb["channel_emb_proxies"])
    out[prefix + "cls_token"] = _np(bb["cls_token"])
    out[prefix + "pos_embed"] = _np(bb["pos_embed"])

    if "blocks" in bb:  # scan_blocks stacked layout
        # flax nests the scan as blocks/blocks/block; also take blocks/block
        node = bb["blocks"]
        stacked = node.get("blocks", node)["block"]
        depth = _np(stacked["norm1"]["scale"]).shape[0]
        for i in range(depth):
            _block_state(out, f"{prefix}blocks.{i}.", _index_tree(stacked, i))
    else:
        depth = 1 + max(int(k.split("_")[1]) for k in bb if k.startswith("block_"))
        for i in range(depth):
            _block_state(out, f"{prefix}blocks.{i}.", bb[f"block_{i}"])

    out[prefix + "norm.weight"] = _np(bb["norm"]["scale"])
    out[prefix + "norm.bias"] = _np(bb["norm"]["bias"])

    if "backbone" in params:
        if "proxies" in params:
            out["proxies"] = _np(params["proxies"])
            out["adaptive_interface.0"] = out["proxies"]
        if "logit_scale" in params:
            out["logit_scale"] = _np(params["logit_scale"])
        if "classifier_head" in params:
            head = params["classifier_head"]
            out["classifer_head.weight"] = _np(head["kernel"]).T
            out["classifer_head.bias"] = _np(head["bias"])
        for name, bias in params.get("miro_encoders", {}).items():
            i = int(re.search(r"block_(\d+)", name).group(1))
            out[f"miro_encoders.block_{i}"] = _np(bias)
    return OrderedDict((k, torch.tensor(v)) for k, v in out.items())
