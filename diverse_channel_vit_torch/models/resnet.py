"""A frozen ResNet-18/34 trunk (counterpart of the JAX package's
``models/resnet.py``): the channel scorer of DiChaViT's
``hcs_sampling=lowest_cosine_prob_resnet34`` (reference ``dichavit.py:68-79``,
``:162-167``). Each input channel, replicated to RGB, goes through the trunk,
and the step samples channels by the batch-mean cosine of those features.

Inference only and frozen: the weights are buffers, not parameters. Each
BatchNorm is one affine from its running statistics (:func:`frozen_batch_norm`,
the JAX ``FrozenBatchNorm``; the reference runs the trunk under ``eval()``),
folded into the convolution before it: a convolution with the scaled weight
and a bias. The convolutions
are plain ``F.conv2d`` (the JAX package leaves them to XLA; no TPU kernel is
involved) on channels-last activations, in the trunk's ``dtype``, the
model's compute dtype. (The JAX trunk casts its input to that dtype, then
flax promotes every layer to its f32 parameters; the port keeps bf16
throughout, which changes the scores by bf16 rounding and so only the
channels of near-tied draws.)

:func:`load_torch_resnet_state` loads a torchvision-layout ``resnet18`` /
``resnet34`` state dict (``fc.*`` ignored); nothing is downloaded.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["RESNET18_LAYERS", "RESNET34_LAYERS", "frozen_batch_norm", "ResNetFeatures",
           "load_torch_resnet_state", "load_state_dict_file", "per_channel_features"]

RESNET18_LAYERS = (2, 2, 2, 2)
RESNET34_LAYERS = (3, 4, 6, 3)
_DIMS = (64, 128, 256, 512)


def frozen_batch_norm(weight, bias, mean, var, eps: float = 1e-5):
    """Eval-mode BatchNorm as one affine, ``(scale, shift)`` in f32:
    y = x * scale + shift, scale = weight / sqrt(var + eps), shift = bias -
    mean * scale (the JAX ``FrozenBatchNorm``)."""
    scale = weight.float() * torch.rsqrt(var.float() + eps)
    return scale, bias.float() - mean.float() * scale


class ConvBN(nn.Module):
    """A bias-free convolution and the frozen BatchNorm after it, as one
    convolution: weight (O, I, k, k) times the BatchNorm's scale per output
    channel, bias its shift. Identity BatchNorm until :meth:`load`."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.stride, self.padding = stride, kernel // 2
        self.register_buffer("weight", torch.empty(cout, cin, kernel, kernel, dtype=dtype))
        self.register_buffer("bias", torch.zeros(cout, dtype=dtype))

    @torch.no_grad()
    def load(self, conv_weight, bn_weight, bn_bias, mean, var) -> None:
        if tuple(conv_weight.shape) != tuple(self.weight.shape):
            raise ValueError(f"convolution weight of shape {tuple(conv_weight.shape)}, the "
                             f"trunk's {tuple(self.weight.shape)}")
        scale, shift = frozen_batch_norm(bn_weight, bn_bias, mean, var)
        self.weight.copy_(conv_weight.float() * scale[:, None, None, None])
        self.bias.copy_(shift)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, stride=self.stride, padding=self.padding)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, 3, stride, dtype)
        self.conv2 = ConvBN(cout, cout, 3, 1, dtype)
        self.downsample = (ConvBN(cin, cout, 1, stride, dtype)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(self.conv1(x)))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNetFeatures(nn.Module):
    """torchvision-layout ResNet trunk: (B, 3, H, W) -> (B, 512) f32
    global-average-pooled features (the reference's ``fc = Identity``).
    Random init (torchvision's: He-normal convolutions by fan-out, identity
    BatchNorms) from ``generator`` until :func:`load_torch_resnet_state`."""

    def __init__(self, layers: Sequence[int] = RESNET34_LAYERS,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = ConvBN(3, 64, 7, 2, dtype)
        cin = 64
        for li, (n, cout) in enumerate(zip(layers, _DIMS)):
            blocks = []
            for bi in range(n):
                blocks.append(BasicBlock(cin, cout, 2 if (li > 0 and bi == 0) else 1, dtype))
                cin = cout
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.num_layers = len(layers)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, ConvBN):
                    o, _, kh, kw = m.weight.shape
                    w = torch.randn(m.weight.shape, generator=generator)
                    m.weight.copy_(w * math.sqrt(2.0 / (o * kh * kw)))
        self.requires_grad_(False)
        self.eval()
        self.to(device)  # channels-last weights (``_apply``), on ``device``

    def forward(self, x: torch.Tensor, gray: bool = False) -> torch.Tensor:
        """``gray``: ``x`` is (B, 1, H, W), standing for the RGB image whose
        three planes equal it; the first convolution then runs on the
        weight summed over its input planes (the same product, a third of
        the work, no replicated copy)."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        c1 = self.conv1
        w = c1.weight.sum(dim=1, keepdim=True) if gray else c1.weight
        x = F.relu(F.conv2d(x, w, c1.bias, stride=2, padding=3))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for li in range(self.num_layers):
            x = getattr(self, f"layer{li + 1}")(x)
        return x.float().mean(dim=(2, 3))

    def _apply(self, fn, recurse=True):
        """Keep the convolution weights channels-last across ``.to()``."""
        out = super()._apply(fn, recurse)
        for m in self.modules():
            if isinstance(m, ConvBN):
                m.weight = m.weight.contiguous(memory_format=torch.channels_last)
        return out


def load_state_dict_file(path: str) -> dict:
    """A local torch checkpoint as a plain {name: tensor} dict: a raw state
    dict or one under ``"state_dict"`` / ``"model"``, ``module.`` prefixes
    dropped (the JAX ``trainer._load_torch_state_dict``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k.removeprefix("module."): v for k, v in obj.items()}


@torch.no_grad()
def load_torch_resnet_state(net: ResNetFeatures, state: dict) -> ResNetFeatures:
    """Load a torchvision / timm ``resnet18`` / ``resnet34`` state dict
    (tensors or arrays) into ``net`` in place, each BatchNorm folded into
    its convolution; ``fc.*`` is ignored. Every trunk tensor must be
    present with its shape."""

    def put(m: ConvBN, conv: str, bn: str):
        m.load(*(torch.as_tensor(state[f"{conv}.weight" if k == "conv" else f"{bn}.{k}"])
                 for k in ("conv", "weight", "bias", "running_mean", "running_var")))

    put(net.conv1, "conv1", "bn1")
    for li in range(net.num_layers):
        for bi, blk in enumerate(getattr(net, f"layer{li + 1}")):
            t = f"layer{li + 1}.{bi}"
            put(blk.conv1, t + ".conv1", t + ".bn1")
            put(blk.conv2, t + ".conv2", t + ".bn2")
            if blk.downsample is not None:
                put(blk.downsample, t + ".downsample.0", t + ".downsample.1")
    return net


def per_channel_features(net: ResNetFeatures, x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 512): each channel replicated to RGB through
    the frozen trunk, the channels folded into the batch for one forward
    (the JAX ``per_channel_features``; reference ``get_channel_emb_resnet34``,
    ``dichavit.py:100-111``). No gradient."""
    b, c, h, w = x.shape
    with torch.no_grad():
        feats = net(x.reshape(b * c, 1, h, w), gray=True)
    return feats.reshape(b, c, -1)
