"""Hypernetworks: channel z-vectors -> first-layer kernels or channel
embeddings (counterpart of the JAX package's ``models/hypernet.py``; the
reference's ``models/hypernet.py:9-169``).

Each class keeps the JAX module's parameter names and shapes (``W``, ``b``,
``W_out``, ``b_out``, ``W_out_h``, ``W_h``) and its einsums, in f32. Init as
the reference's: the weights kaiming-normal (fan_in as torch computes it on
the same shape), the biases ``b`` and ``b_out`` plain N(0, 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.initializers import kaiming_normal_, normal_


def _kaiming(g, *shape) -> nn.Parameter:
    return nn.Parameter(kaiming_normal_(torch.empty(shape), generator=g))


def _normal(g, *shape) -> nn.Parameter:
    return nn.Parameter(normal_(torch.empty(shape), generator=g))


class HyperNetwork(nn.Module):
    """z (C, z_dim) -> kernels (out_size, C * in_size, k, k)
    (``hypernet.py:9-50``), with an optional 1x1 bottleneck of out_size / 4
    hidden units (``use_conv1x1``)."""

    def __init__(self, z_dim: int, d: int, kernel_size: int, out_size: int, in_size: int = 1,
                 use_conv1x1: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, k = generator, kernel_size
        self.kernel_size, self.out_size, self.in_size = k, out_size, in_size
        self.use_conv1x1 = use_conv1x1
        self.W = _kaiming(g, z_dim, in_size, d)
        self.b = _normal(g, in_size, d)
        if use_conv1x1:
            hid = out_size // 4
            self.W_out_h = _kaiming(g, d, hid, k, k)
            self.W_out = _kaiming(g, hid, out_size)
        else:
            self.W_out = _kaiming(g, d, out_size, k, k)
        self.b_out = _normal(g, out_size, k, k)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        k, c = self.kernel_size, z.shape[0]
        a = torch.einsum("cz,zid->cid", z, self.W) + self.b
        if self.use_conv1x1:
            a = torch.relu(torch.einsum("cid,dmhw->cimhw", a, self.W_out_h))
            kern = torch.einsum("cimhw,mo->ciohw", a, self.W_out) + self.b_out
        else:
            kern = torch.einsum("cid,dohw->ciohw", a, self.W_out) + self.b_out
        # (c, i, o, h, w) -> (o, c*i, h, w) (hypernet.py:49)
        return kern.permute(2, 0, 1, 3, 4).reshape(self.out_size, c * self.in_size, k, k)


class HyperNetworkV2(nn.Module):
    """Batched: z (B, C, z_dim) -> kernels (B, out, C, k, k)
    (``hypernet.py:53-93``)."""

    def __init__(self, z_dim: int, d: int, kernel_size: int, out_size: int,
                 use_conv1x1: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, k = generator, kernel_size
        self.use_conv1x1 = use_conv1x1
        self.W = _kaiming(g, z_dim, d)
        self.b = _normal(g, d)
        if use_conv1x1:
            hid = out_size // 4
            self.W_out_h = _kaiming(g, d, hid, k, k)
            self.W_out = _kaiming(g, hid, out_size)
        else:
            self.W_out = _kaiming(g, d, out_size, k, k)
        self.b_out = _normal(g, out_size, k, k)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        a = torch.einsum("bcz,zd->bcd", z, self.W) + self.b
        if self.use_conv1x1:
            a = torch.relu(torch.einsum("bcd,dmhw->bcmhw", a, self.W_out_h))
            kern = torch.einsum("bcmhw,mo->bcohw", a, self.W_out) + self.b_out
        else:
            kern = torch.einsum("bcd,dohw->bcohw", a, self.W_out) + self.b_out
        return kern.permute(0, 2, 1, 3, 4)  # (B, out, C, k, k)


class HyperNetworkChannelEmbV2(nn.Module):
    """Batched channel embeddings: z (B, C, z_dim) -> (B, out, C)
    (``hypernet.py:140-169``)."""

    def __init__(self, z_dim: int, d: int, out_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, hid = generator, out_size // 4
        self.W = _kaiming(g, z_dim, d)
        self.b = _normal(g, d)
        self.W_h = _kaiming(g, d, hid)
        self.W_out = _kaiming(g, hid, out_size)
        self.b_out = _normal(g, out_size)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        out = torch.relu(torch.einsum("bcz,zd->bcd", z, self.W) + self.b)
        out = torch.relu(torch.einsum("bcd,dh->bch", out, self.W_h))
        out = torch.einsum("bch,ho->bco", out, self.W_out) + self.b_out
        return out.permute(0, 2, 1)  # (B, out, C)


class HyperNetworkChannelEmb(nn.Module):
    """z (C, z_dim) -> channel embeddings (out_size, C) (``hypernet.py:96-137``)."""

    def __init__(self, z_dim: int, d: int, out_size: int, in_size: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, hid = generator, out_size // 4
        self.W = _kaiming(g, z_dim, in_size, d)
        self.b = _normal(g, in_size, d)
        self.W_h = _kaiming(g, d, hid)
        self.W_out = _kaiming(g, hid, out_size)
        self.b_out = _normal(g, out_size)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        out = torch.relu(torch.einsum("cz,zid->cid", z, self.W) + self.b)
        out = torch.relu(torch.einsum("cid,dh->cih", out, self.W_h))
        out = torch.einsum("cih,ho->cio", out, self.W_out) + self.b_out
        return out.mean(dim=1).t()  # (out, C)
