"""MIRO: mutual-information regularization with intermediate features (the
port's own copy of the JAX package's ``training/miro.py``; the reference's
``models/model_utils.py:94-141``, ``trainer.py:170-208, 885-910``).

- **Taps**: the output of every transformer block, ``block_{i}``, (B, N, D)
  at the N real tokens, the last block's included: a forward given a
  ``taps`` dict (``models/channel_vit.py``) fills it and runs the last block
  at all N rows, not the CLS-only readout, as JAX's intermediates capture
  turns the readout off (``cls_readout_ok``). JAX names the same taps
  ``backbone/block_{i}/__call__/[0]``. The port pads every token grid to a
  multiple of 64 and leaves the pad rows out of its taps; JAX pads only
  some grids (``ops/attention.py`` ``maybe_pad_tokens``) and its taps then
  hold the pad rows too, so the two losses agree exactly where JAX does not
  pad, as at the CPU tests' f32 geometry. The reference pads nothing.
- **MeanEncoder** = identity; **VarianceEncoder** = a bias per tap,
  ``var = softplus(b) + eps`` with ``b0 = softplus^-1(0.1 - eps)`` and the
  channelwise shape of :func:`_b_shape`.
- **Loss**: per tap ``mean((f - pre_f)^2 / var + log var) / 2`` against the
  taps of the pre-featurizer (a frozen copy of the initial model, run in
  eval mode without gradient), summed over taps, times ``train.miro_ld``.
- The encoders are ``model.miro_encoders`` (a ``ParameterDict``), so they
  checkpoint and average with the model; ``TrainState`` gives them a param
  group at ``lr * train.miro_lr_mult``.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

MIRO_KEY = "miro_encoders"
_EPS = 1e-5


def _b_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Channelwise bias shape (``model_utils.py:112-121``; a 4-D tap is NHWC
    in the JAX package)."""
    if len(shape) == 4:
        return (1, 1, 1, shape[3])
    if len(shape) == 3:
        return (1, 1, shape[2])
    if len(shape) == 2:
        return (1, shape[1])
    raise ValueError(f"MIRO tap of rank {len(shape)} not supported: {shape}")


def init_encoders(model: nn.Module) -> nn.ParameterDict:
    """One VarianceEncoder bias per tap (the ``get_shapes`` equivalent),
    f32 on the model's device. Every tap of the port's backbone is a (B, N,
    D) block output, so the shapes follow from the depth and width with no
    forward."""
    fe = model.feature_extractor
    if not len(fe.blocks):
        raise ValueError("train.miro=True but the model has no transformer blocks to tap")
    b0 = math.log(math.exp(0.1 - _EPS) - 1.0)  # softplus^-1(init - eps)
    device = next(model.parameters()).device
    return nn.ParameterDict({
        f"block_{i}": nn.Parameter(torch.full(_b_shape((1, 1, fe.embed_dim)), b0,
                                             dtype=torch.float32, device=device))
        for i in range(len(fe.blocks))})


def pre_featurizer(model: nn.Module) -> nn.Module:
    """A frozen copy of ``model`` as it is now (the reference's
    ``pre_featurizer``, JAX ``trainer.py:443-460``), in eval mode."""
    pre = copy.deepcopy(model)
    for m in pre.modules():  # serving's weight casts of the live model
        m.__dict__.pop("_cast_cache", None)
    for p in pre.parameters():
        p.requires_grad_(False)
    return pre.eval()


def miro_vlb(encoders, feats: Dict[str, torch.Tensor],
             pre_feats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``sum_taps mean((f - pre_f)^2 / var + log var) / 2``
    (``trainer.py:898-908``), in f32, the taps in sorted-name order (JAX's)."""
    reg = None
    for name in sorted(feats):
        var = F.softplus(encoders[name]) + _EPS
        f = feats[name].float()
        pre = pre_feats[name].detach().float()
        term = ((f - pre) ** 2 / var + torch.log(var)).mean() / 2.0
        reg = term if reg is None else reg + term
    return reg
