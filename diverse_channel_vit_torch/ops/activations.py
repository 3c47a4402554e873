"""Activation helpers (counterpart of the JAX package's ``ops/activations.py``).

GELU defaults to the tanh approximation, as in the JAX package; the exact
erf form (torch ``nn.GELU()``, the reference's choice) sits behind
``exact``. The port's only block route, the fused one, computes tanh-GELU,
so ``build_model`` refuses a config with ``gelu_exact`` set.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    return F.gelu(x, approximate="none" if exact else "tanh")
