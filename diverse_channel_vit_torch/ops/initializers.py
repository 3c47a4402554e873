"""In-place weight initializers driven by an explicit ``torch.Generator``
(counterpart of the JAX package's ``ops/initializers.py``).

They exist to build a model at random from a seed; numbers drawn here differ
from ``jax.random``'s for the same seed, so parity tests carry weights across
with ``models.export.params_from_jax`` instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _norm_cdf(x: float) -> float:
    return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float = 0.02, mean: float = 0.0, a: float = -2.0,
                  b: float = 2.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(mean, std^2) truncated in value space to [a, b] by inverse-CDF
    sampling (the reference's ``trunc_normal_``)."""
    lo = _norm_cdf((a - mean) / std)
    hi = _norm_cdf((b - mean) / std)
    u = torch.empty(t.shape, dtype=torch.float32)
    u.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    x = torch.erfinv(u) * (std * math.sqrt(2.0)) + mean
    return t.copy_(x.clamp_(a, b))


@torch.no_grad()
def conv_patch_(t: torch.Tensor, fan_in: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)): the variance of torch's
    default Conv init, which the reference's patch-embed conv keeps."""
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.empty(t.shape, dtype=torch.float32).uniform_(-bound, bound, generator=generator)
    return t.copy_(u)


@torch.no_grad()
def normal_div8_(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """randn / 8: the reference's proxy initializer."""
    return t.copy_(torch.randn(t.shape, generator=generator) / 8.0)


@torch.no_grad()
def orthogonal_(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Orthogonal rows/columns (torch ``nn.init.orthogonal_``)."""
    w = torch.empty(t.shape, dtype=torch.float32)
    torch.nn.init.orthogonal_(w, generator=generator)
    return t.copy_(w)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float = 1.0,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0, std^2) (``torch.randn`` scaled): the reference's hypernetwork
    biases and channel-pooling CLS token."""
    return t.copy_(torch.randn(t.shape, generator=generator) * std)


@torch.no_grad()
def kaiming_normal_(t: torch.Tensor, fan_in: Optional[int] = None, gain: float = math.sqrt(2.0),
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0, gain^2 / fan_in), torch's ``kaiming_normal_`` in fan_in mode:
    ``fan_in`` defaults to ``shape[1] * prod(shape[2:])`` (``shape[0]`` for a
    vector), as torch computes it on the same shape."""
    if fan_in is None:
        fan_in = t.shape[1] * math.prod(t.shape[2:]) if t.ndim > 1 else t.shape[0]
    return normal_(t, gain / math.sqrt(fan_in), generator)


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Truncated normal of variance 1 / fan_in over a ``nn.Linear`` weight
    (out, in): the default kernel init of a flax ``Dense``."""
    std = t.shape[1] ** -0.5 / 0.87962566103423978  # the std of N(0, 1) cut at +-2
    return trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
