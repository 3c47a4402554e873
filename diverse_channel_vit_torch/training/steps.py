"""The train step (counterpart of the JAX package's ``training/steps.py``).

:func:`make_train_step` is the single-chunk step (JUMP-CP, So2Sat): forward
in train mode, the main loss (cross entropy over the head's logits, or the
proxy loss over the embedding) plus ``extra_loss_lambda`` times the model's
diversity losses, backward, and one optimizer update. The JAX package jits
this into one function; here it runs eagerly, with the fused blocks'
backward passes in the CUDA kernels of ``ops/fused_block.py``.

Ported for one device and all channels of the batch (``k = None``). Channel
sampling (DCS/HCS, ``k < C``), the per-chunk CHAMMI grad step, MIRO,
on-device augmentation and the multi-device mesh are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..models.wrappers import model_scale
from ..ops.losses import cross_entropy_loss, proxy_logits
from .state import TrainState


def _select_channels(k: Optional[int], num_channels: int) -> None:
    """The step trains on all of the batch's channels; sampling a subset of
    ``k < C`` (DCS/HCS) is ROADMAP slice 4 and raises until then."""
    if k is not None and k < num_channels:
        raise NotImplementedError(
            "channel sampling (k < C, DCS/HCS) is not ported yet (ROADMAP slice 4)")


def _loss_and_metrics(model, x, cids, y, *, loss_type: str, extra_loss_lambda: float,
                      learnable_temp: bool, temperature: float):
    out, extra = model(x, cids)
    logits = out
    if loss_type == "proxy":
        logits = proxy_logits(model.proxies, out,
                              model_scale(model, learnable_temp, temperature))
    main = cross_entropy_loss(logits, y)
    total = main + extra_loss_lambda * extra
    acc = (logits.argmax(dim=-1) == y).float().mean()
    metrics = {"loss": total.detach(), "main_loss": main.detach(),
               "extra_loss": extra.detach(), "acc": acc}
    return total, metrics


def make_train_step(
    model: torch.nn.Module,
    *,
    channel_ids: Sequence[int],
    k: Optional[int] = None,
    loss_type: str = "ce",
    extra_loss_lambda: float = 0.0,
    learnable_temp: bool = False,
    temperature: float = 0.11111,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, metrics)`` for a single-chunk batch
    ``{"image": (B, C, H, W) f32, "label": (B,) int}`` on the model's device.
    The state is updated in place and returned. ``metrics`` holds 0-d tensors
    on the device (reading them waits for the step): ``loss``, ``main_loss``,
    ``extra_loss``, ``acc`` and ``grad_norm``, the gradients' global norm
    before clipping."""
    _select_channels(k, len(channel_ids))
    ids = torch.tensor(list(channel_ids), dtype=torch.long)
    cids_on = {}

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        x, y = batch["image"], batch["label"]
        cids = cids_on.get(x.device)
        if cids is None:
            cids = cids_on[x.device] = ids.to(x.device)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = _loss_and_metrics(
            model, x, cids, y, loss_type=loss_type, extra_loss_lambda=extra_loss_lambda,
            learnable_temp=learnable_temp, temperature=temperature)
        total.backward()
        metrics["grad_norm"] = state.apply_gradients()
        return state, metrics

    return step
