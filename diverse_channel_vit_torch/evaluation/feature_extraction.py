"""Standalone pretrained-feature extraction CLI (counterpart of the JAX
package's ``evaluation/feature_extraction.py``; the reference's
``morphem/feature_extraction.py:122-202``).

Each channel of a CHAMMI image becomes an RGB image, goes through a
pretrained backbone, and the per-channel feature vectors of an image are
concatenated; ``features.npy`` per dataset then feeds ``run_benchmark``.
The weights come from a local state dict (``--weights``); nothing is
downloaded. Backbones (``--model``):

- ``resnet18``, ``resnet18_jax``, ``resnet34_jax``: a torchvision-layout
  ResNet (``models/resnet.py``; ResNet-18 for ``resnet18``, the layer counts
  of the state dict for the ``_jax`` names), 512 features;
- ``convnext_jax``: the timm stem (``stem.0``) and the ConvNeXt-Tiny trunk
  (``models/convnext.py``, ``stem.1`` its stem LayerNorm), mean-pooled, 768;
- ``dinov2_jax``: DINOv2 (``models/dinov2.py``), hub or HuggingFace layout,
  the CLS features; ``--heads`` for a width the published models lack;
- ``convnext`` raises ``NotImplementedError`` (ROADMAP A7): the JAX package
  runs it through torchvision's own ``convnext_tiny`` on the host, another
  key layout with a LayerNorm after the pool, and torchvision is not a
  dependency of the port.

The pipeline runs on ``device`` (the card unless ``"cpu"`` is asked for), as
the JAX device pipeline does: batches of fixed shape (``pad_last``), read
by ``LOADER_THREADS`` host threads and copied to the device in a prefetch
thread, the RGB replication on the device (an
``expand``; ResNet sums its first convolution's weight over the three
planes instead, the same product without the copy), every batch's features
kept on the device, one readback at the end, the pad rows dropped. Every
backbone runs in f32. Backbones are cached per (model, weights, heads,
device), so the three CHAMMI datasets of one process share one.

DINOv2 inputs are zero-padded to patch multiples by the reference's
``create_pad`` (``pad_to_patch_multiple``: the odd pixel on the right /
bottom, the rest split evenly). The JAX device pipeline pads on the right /
bottom alone, so where the image side is no multiple of 14 its DINOv2
features differ from the port's; its host function (``run``) pads as the
reference does, as the port does.

Usage:
    python -m diverse_channel_vit_torch.evaluation.feature_extraction \\
        --root_dir data/chammi --dataset Allen --img_size 224 \\
        --model dinov2_jax --weights weights/dinov2_vits14_reg.pth --dest features/
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..data.loaders import BatchLoader, prefetch
from ..data.morphem70k import SingleCellDataset
from ..device import resolve_device
from ..models.resnet import load_state_dict_file

BACKBONES = ("resnet18", "resnet18_jax", "resnet34_jax", "convnext", "convnext_jax",
             "dinov2_jax")
# host threads that read and resize the images (the JAX CLI reads in one;
# the batches are the same, in the same order): the host sets the pace
LOADER_THREADS = 4


def channel_replicate(batch_chw: np.ndarray) -> np.ndarray:
    """(B, C, H, W) -> (B * C, 3, H, W) on the host: every channel an RGB
    image (``feature_extraction.py:131-140``)."""
    b, c, h, w = batch_chw.shape
    return np.repeat(batch_chw.reshape(b * c, 1, h, w), 3, axis=1)


def resnet_backbone(weights: str, device, layers=None) -> Tuple[Callable, int]:
    """A ResNet from a local torchvision-layout state dict; ``layers`` from
    the state dict's blocks when None. ``fn(x)``: (N, 1, H, W) gray planes
    standing for RGB -> (N, 512)."""
    from ..models.resnet import ResNetFeatures, load_torch_resnet_state

    sd = load_state_dict_file(weights)
    if layers is None:
        layers = tuple(sum(1 for k in sd if k.startswith(f"layer{li}.")
                           and k.endswith(".conv1.weight") and ".downsample" not in k)
                       for li in range(1, 5))
    net = load_torch_resnet_state(ResNetFeatures(layers, dtype=torch.float32), sd).to(device)
    return (lambda x: net(x, gray=True)), 512


class ConvNeXtFeatures(torch.nn.Module):
    """timm ``convnext_tiny``'s stem and trunk, mean-pooled (the JAX
    ``jax_convnext_backbone``): (N, 3, H, W) -> (N, 768)."""

    def __init__(self, sd: dict):
        super().__init__()
        from ..models import convnext

        self.trunk = convnext.ConvNeXtTrunk(**convnext.TINY)
        convnext.load_torch_convnext_state(self.trunk, sd)
        w = torch.as_tensor(np.asarray(sd["stem.0.weight"], np.float32))
        self.stem = torch.nn.Conv2d(w.shape[1], w.shape[0], w.shape[-1], stride=w.shape[-1])
        with torch.no_grad():
            self.stem.weight.copy_(w)
            self.stem.bias.copy_(torch.as_tensor(np.asarray(sd["stem.0.bias"], np.float32)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(self.stem(x)).mean(dim=(2, 3))


def _rgb(x: torch.Tensor) -> torch.Tensor:
    return x.expand(-1, 3, -1, -1)


def build_backbone(model: str, weights: str, device, heads: Optional[int] = None):
    """``(fn, feat_dim)``: ``fn`` maps (N, 1, H, W) planes on ``device`` to
    (N, feat_dim) f32 features of their RGB replicas."""
    if model in ("resnet18", "resnet18_jax", "resnet34_jax"):
        from ..models.resnet import RESNET18_LAYERS

        return resnet_backbone(weights, device, RESNET18_LAYERS if model == "resnet18" else None)
    if model == "convnext_jax":
        net = ConvNeXtFeatures(load_state_dict_file(weights)).to(device).eval()
        return (lambda x: net(_rgb(x))), 768
    if model == "dinov2_jax":
        from ..models.dinov2 import (DinoV2ViT, config_from_state_dict,
                                     load_torch_dinov2_state, pad_to_patch_multiple)

        sd = load_state_dict_file(weights)
        cfg = config_from_state_dict(sd, num_heads=heads)
        net = load_torch_dinov2_state(DinoV2ViT(**cfg), sd).to(device).eval()
        patch = cfg["patch_size"]
        return (lambda x: net(pad_to_patch_multiple(_rgb(x), patch))), cfg["embed_dim"]
    if model == "convnext":
        raise NotImplementedError(
            "--model convnext: torchvision's convnext_tiny on the host is not ported "
            "(ROADMAP A7); convnext_jax runs a timm-layout ConvNeXt-Tiny checkpoint")
    raise ValueError(f"Unsupported backbone {model!r}; use {'|'.join(BACKBONES)}")


_BACKBONE_CACHE: dict = {}


@torch.no_grad()
def get_save_features(root_dir: str, file_name: str, dataset: str, dest_dir: str, *,
                      model: str = "resnet18", weights: str = "", img_size: int = 224,
                      batch_size: int = 32, heads: Optional[int] = None,
                      device=None) -> str:
    """Write ``{dest_dir}/{dataset}/features.npy``, (N, C * F) f32 in the
    dataset's order, and return its path (JAX ``get_save_features``)."""
    device = resolve_device(device)
    key = (model, weights, heads, str(device))
    if key not in _BACKBONE_CACHE:
        _BACKBONE_CACHE[key] = build_backbone(model, weights, device, heads)
    fn, _ = _BACKBONE_CACHE[key]
    ds = SingleCellDataset(root_dir, file_name=file_name, chunk_name=dataset, is_train=False,
                           img_size=img_size)
    loader = BatchLoader(ds, batch_size=batch_size, shuffle=False, pad_last=True,
                         num_workers=LOADER_THREADS)

    def ship(batch):
        img = torch.from_numpy(np.ascontiguousarray(batch["image"], np.float32))
        return img.to(device), np.asarray(batch["valid"])

    feats, valids = [], []
    for x, valid in prefetch(map(ship, iter(loader)), depth=2):
        b, c, h, w = x.shape
        feats.append(fn(x.reshape(b * c, 1, h, w)).float().reshape(b, -1))
        valids.append(valid)
    out = torch.cat(feats).cpu().numpy()[np.concatenate(valids)]
    os.makedirs(os.path.join(dest_dir, dataset), exist_ok=True)
    path = os.path.join(dest_dir, dataset, "features.npy")
    np.save(path, out)
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root_dir", required=True)
    p.add_argument("--file_name", default="morphem70k_v2.csv")
    p.add_argument("--dataset", required=True, choices=["Allen", "HPA", "CP"])
    p.add_argument("--dest", required=True)
    p.add_argument("--model", default="resnet18")
    p.add_argument("--weights", default="")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--heads", type=int, default=None,
                   help="dinov2_jax head count (inferred for published widths)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    path = get_save_features(a.root_dir, a.file_name, a.dataset, a.dest, model=a.model,
                             weights=a.weights, img_size=a.img_size, batch_size=a.batch_size,
                             heads=a.heads, device=a.device)
    print(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
