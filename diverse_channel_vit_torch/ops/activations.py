"""Activation helpers (counterpart of the JAX package's ``ops/activations.py``).

GELU defaults to the tanh approximation, as in the JAX package; the exact
erf form (torch ``nn.GELU()``, the reference's choice) sits behind
``exact``. Where the JAX package reads a process-wide flag
(``set_gelu_exact``), the port's blocks take ``gelu_exact`` from the model
config; the fused block route computes tanh-GELU only, so a model with
``gelu_exact`` set runs the unfused route (``models/vit.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    return F.gelu(x, approximate="none" if exact else "tanh")
