"""Weight carrier: the JAX package's flax parameter tree -> the port's
``state_dict`` (the port's own copy of the mapping in the JAX package's
``models/export.py``).

The target is the PyTorch reference's layout, which the port's modules use
(ChannelViT / DiChaViT below; the baselines in :func:`_baseline_state`;
the ConvNeXt family in timm's names, :func:`_convnext_state`, and DINOv2 in
the hub's, :func:`_dinov2_state`, convolutions HWIO -> OIHW):

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


def _baseline_state(out: "OrderedDict[str, np.ndarray]", prefix: str, tree: Dict[str, Any]):
    """A baseline backbone's tree (``vit_adapt``, ``depthwisevit_adapt``,
    ``hypervit_adapt``, ``templatemixingvit``): the JAX ``trunk`` submodule's
    leaves at the backbone's top level, ``block_{i}`` as ChannelViT's
    blocks, a Dense's ``kernel`` transposed into ``weight``, a LayerNorm's
    ``scale`` into ``weight``, every other leaf (the banks, tables, channel
    weights, the hypernetwork's ``W``/``b``/``W_out``/``b_out``/``W_out_h``)
    under its own path."""
    for key, node in tree.items():
        if key == "trunk":
            _baseline_state(out, prefix, node)
        elif re.fullmatch(r"block_\d+", key):
            _block_state(out, f"{prefix}blocks.{key.split('_')[1]}.", node)
        elif not hasattr(node, "items"):
            out[prefix + key] = _np(node)
        elif "kernel" in node:  # Dense
            out[f"{prefix}{key}.weight"] = _np(node["kernel"]).T
            if "bias" in node:
                out[f"{prefix}{key}.bias"] = _np(node["bias"])
        elif "scale" in node:  # LayerNorm
            out[f"{prefix}{key}.weight"] = _np(node["scale"])
            out[f"{prefix}{key}.bias"] = _np(node["bias"])
        else:
            _baseline_state(out, f"{prefix}{key}.", node)


def _channel_vit_state(out: "OrderedDict[str, np.ndarray]", prefix: str, bb: Dict[str, Any]):
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


def _dense(out, name: str, node) -> None:
    out[name + ".weight"] = _np(node["kernel"]).T
    if "bias" in node:
        out[name + ".bias"] = _np(node["bias"])


def _norm(out, name: str, node) -> None:
    out[name + ".weight"] = _np(node["scale"])
    out[name + ".bias"] = _np(node["bias"])


def _hwio_to_oihw(kernel) -> np.ndarray:
    return np.ascontiguousarray(_np(kernel).transpose(3, 2, 0, 1))


def _convnext_trunk_state(out, prefix: str, tree: Dict[str, Any]) -> None:
    """The JAX ``ConvNeXtTrunk`` tree -> the port's timm-layout trunk:
    ``stage{s}_block{b}/{dwconv, norm, pwconv1, pwconv2, gamma}`` ->
    ``stages.{s}.blocks.{b}.{conv_dw, norm, mlp.fc1, mlp.fc2, gamma}``
    (convolutions HWIO -> OIHW, the depthwise (7, 7, 1, C) -> (C, 1, 7, 7)),
    ``downsample_{norm,conv}_{s}`` -> ``stages.{s}.downsample.{0,1}``."""
    for key, node in tree.items():
        if key == "stem_norm":
            _norm(out, prefix + "stem_norm", node)
        elif m := re.fullmatch(r"downsample_norm_(\d+)", key):
            _norm(out, f"{prefix}stages.{m.group(1)}.downsample.0", node)
        elif m := re.fullmatch(r"downsample_conv_(\d+)", key):
            name = f"{prefix}stages.{m.group(1)}.downsample.1"
            out[name + ".weight"] = _hwio_to_oihw(node["kernel"])
            out[name + ".bias"] = _np(node["bias"])
        elif m := re.fullmatch(r"stage(\d+)_block(\d+)", key):
            blk = f"{prefix}stages.{m.group(1)}.blocks.{m.group(2)}."
            out[blk + "conv_dw.weight"] = _hwio_to_oihw(node["dwconv"]["kernel"])
            out[blk + "conv_dw.bias"] = _np(node["dwconv"]["bias"])
            _norm(out, blk + "norm", node["norm"])
            _dense(out, blk + "mlp.fc1", node["pwconv1"])
            _dense(out, blk + "mlp.fc2", node["pwconv2"])
            out[blk + "gamma"] = _np(node["gamma"])
        else:
            raise KeyError(f"unknown ConvNeXt trunk leaf {key!r}")


def _convnext_state(out, prefix: str, bb: Dict[str, Any]) -> None:
    """A ConvNeXt-family backbone: the trunk (:func:`_convnext_trunk_state`),
    the stems ``stem_conv`` / ``stem_conv_{chunk}`` HWIO -> OIHW, every other
    leaf as the baselines' (the banks and tables under their own names, the
    Dense ``stem_conv1x1`` and ``attn_pooling/wq*`` transposed, the
    InstanceNorm's ``scale`` into ``weight``)."""
    for key, node in bb.items():
        if key == "trunk":
            _convnext_trunk_state(out, prefix + "trunk.", node)
        elif re.fullmatch(r"stem_conv(_.+)?", key) and not hasattr(node, "items"):
            out[prefix + key] = _hwio_to_oihw(node)
        else:
            _baseline_state(out, prefix, {key: node})


def _dinov2_state(out, prefix: str, tree: Dict[str, Any]) -> None:
    """The JAX ``DinoV2ViT`` tree -> the port's hub-layout names."""
    for key in ("cls_token", "pos_embed", "register_tokens"):
        if key in tree:
            out[prefix + key] = _np(tree[key])
    out[prefix + "patch_embed.proj.weight"] = _hwio_to_oihw(tree["patch_proj"]["kernel"])
    out[prefix + "patch_embed.proj.bias"] = _np(tree["patch_proj"]["bias"])
    _norm(out, prefix + "norm", tree["norm"])
    i = 0
    while f"block{i}" in tree:
        blk, o = tree[f"block{i}"], f"{prefix}blocks.{i}."
        _norm(out, o + "norm1", blk["norm1"])
        _norm(out, o + "norm2", blk["norm2"])
        _dense(out, o + "attn.qkv", blk["qkv"])
        _dense(out, o + "attn.proj", blk["attn_proj"])
        _dense(out, o + "mlp.fc1", blk["fc1"])
        _dense(out, o + "mlp.fc2", blk["fc2"])
        out[o + "ls1.gamma"] = _np(blk["ls1_gamma"])
        out[o + "ls2.gamma"] = _np(blk["ls2_gamma"])
        i += 1


_CONVNEXT_BLOCK = {"conv_dw": "dwconv", "norm": "norm", "mlp.fc1": "pwconv1",
                   "mlp.fc2": "pwconv2"}


def jax_param_path(name: str) -> str:
    """The JAX path (``/``-joined) of a port parameter, by its name, for
    every model: the inverse of the carrier's names, for the freeze labels
    (``training/freeze.py``). Module names are JAX's (``block_{i}`` for a
    ViT block, the ConvNeXt trunk's ``stage{s}_block{b}`` and
    ``downsample_{norm,conv}_{s}``, ChannelViT's ``proj_kernel`` and
    ``proj_bias``, ``classifier_head``); a leaf keeps the port's name
    (``weight``), which no freeze pattern reads, and a baseline's trunk
    leaves stay at the backbone's top level, as the carrier puts them."""
    if name.startswith("classifer_head."):
        return "classifier_head/" + name[len("classifer_head."):].replace(".", "/")
    if not name.startswith("feature_extractor."):
        return name.replace(".", "/")
    rest = name[len("feature_extractor."):]
    if m := re.fullmatch(r"patch_embed\.proj\.(weight|bias)", rest):
        rest = "proj_kernel" if m.group(1) == "weight" else "proj_bias"
    elif rest.startswith("patch_embed."):
        rest = rest[len("patch_embed."):].replace(".", "/")
    elif m := re.fullmatch(r"blocks\.(\d+)\.(.+)", rest):
        rest = f"block_{m.group(1)}/{m.group(2).replace('.', '/')}"
    elif m := re.fullmatch(r"trunk\.stages\.(\d+)\.blocks\.(\d+)\.(.+)\.(\w+)", rest):
        mod = _CONVNEXT_BLOCK.get(m.group(3), m.group(3))
        rest = f"trunk/stage{m.group(1)}_block{m.group(2)}/{mod}/{m.group(4)}"
    elif m := re.fullmatch(r"trunk\.stages\.(\d+)\.blocks\.(\d+)\.gamma", rest):
        rest = f"trunk/stage{m.group(1)}_block{m.group(2)}/gamma"
    elif m := re.fullmatch(r"trunk\.stages\.(\d+)\.downsample\.([01])\.(\w+)", rest):
        kind = "norm" if m.group(2) == "0" else "conv"
        rest = f"trunk/downsample_{kind}_{m.group(1)}/{m.group(3)}"
    else:
        rest = rest.replace(".", "/")
    return "backbone/" + rest


def params_from_jax(params: Dict[str, Any], *,
                    prefix: str = "feature_extractor.") -> "OrderedDict[str, torch.Tensor]":
    """Flax param tree (nested dicts of arrays, numpy or any array type
    ``np.asarray`` reads) -> the port's ``state_dict``, for ChannelViT /
    DiChaViT (a tree with ``proj_kernel``), the ConvNeXt family (a
    ``trunk`` of ConvNeXt stages), DINOv2 (a ``patch_proj``; pass
    ``prefix=""`` for the bare ``DinoV2ViT``) and the baselines.

    Accepts the trainer's full tree (``{"backbone": ..., "proxies",
    ["logit_scale"], ["classifier_head"], ["miro_encoders"]}``) or a bare
    backbone tree. A gradient tree of the same structure carries over the
    same way.
    """
    bb = params.get("backbone", params)
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    if "proj_kernel" in bb:
        _channel_vit_state(out, prefix, bb)
    elif "trunk" in bb and "stage0_block0" in bb["trunk"]:
        _convnext_state(out, prefix, bb)
    elif "patch_proj" in bb:
        _dinov2_state(out, prefix, bb)
    else:
        _baseline_state(out, prefix, bb)

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
