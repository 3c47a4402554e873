"""The train step (counterpart of the JAX package's ``training/steps.py``).

:func:`make_train_step` is the single-chunk step (JUMP-CP, So2Sat): channel
sampling when ``k`` is below the batch's channel count, forward in train
mode, the main loss (cross entropy over the head's logits, or the proxy loss
over the embedding) plus ``extra_loss_lambda`` times the model's diversity
losses, backward, and one optimizer update. The JAX package jits this into
one function per ``k``; here it runs eagerly, with the fused blocks'
backward passes in the CUDA kernels of ``ops/fused_block.py``.

Channel sampling (DiChaViT's DCS, the recipe's ``hcs_sampling``): ``k`` is a
host int fixed per step function, so a recipe that draws k per step makes
one step function per k over the same train state (as the JAX benchmark
keeps one compiled step per k). The channels are drawn on the device from a
``torch.Generator`` (``ops/sampling.py``).

Ported for one device. The ``_proj`` / ``_resnet34`` / ``hcs_per_sample``
samplers, the per-chunk CHAMMI grad step, MIRO, on-device augmentation and
the multi-device mesh are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..models.wrappers import model_scale
from ..ops.losses import cross_entropy_loss, proxy_logits
from ..ops.sampling import NOT_PORTED, dcs_select
from .state import TrainState


def _select_channels(model, x: torch.Tensor, cids: torch.Tensor, *, k: Optional[int],
                     method: str, temp: float, generator: Optional[torch.Generator],
                     draws: Optional[dict]):
    """Gather a sampled channel subset of the batch (the JAX
    ``_select_channels`` for the ported methods): ``(x_sel, cids_sel)``,
    both left on the device. ``k`` None or >= C keeps every channel. The
    cosine scores use the model's channel embeddings of the batch's ids,
    without gradient (the selection is not differentiable); ``uniform``
    reads only their count and device."""
    if k is None or k >= x.shape[1]:
        return x, cids
    with torch.no_grad():
        emb = model.feature_extractor.patch_embed.channel_embed.weight.index_select(0, cids)
    idx = dcs_select(k, method, channel_embed=emb, temp=temp, generator=generator,
                     **(draws or {}))
    return x.index_select(1, idx), cids.index_select(0, idx)


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
    hcs_method: str = "none",
    hcs_temp: float = 0.1,
    generator: Optional[torch.Generator] = None,
    loss_type: str = "ce",
    extra_loss_lambda: float = 0.0,
    learnable_temp: bool = False,
    temperature: float = 0.11111,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch, draws=None) -> (state, metrics)`` for a
    single-chunk batch ``{"image": (B, C, H, W) f32, "label": (B,) int}`` on
    the model's device. The state is updated in place and returned.
    ``metrics`` holds tensors on the device (reading them waits for the
    step): ``loss``, ``main_loss``, ``extra_loss``, ``acc`` and ``grad_norm``,
    the gradients' global norm before clipping, and with ``k`` below the
    channel count ``sampled_channels``, the (k,) ids the step trained on.

    ``k`` < C samples k channels per step by ``hcs_method`` (``"none"`` /
    ``"uniform"``, ``"lowest_cosine"``, ``"highest_cosine"``,
    ``"lowest_cosine_prob"``) at temperature ``hcs_temp``, drawing from
    ``generator`` (by default one seeded with 0 on the batch's device).
    ``draws`` ({"anchor": ..., "gumbel": ...}, see ``ops.sampling.dcs_select``)
    replaces one step's random draws."""
    if k is not None and k < len(channel_ids) and hcs_method in NOT_PORTED:
        raise NotImplementedError(
            f"hcs_sampling={hcs_method!r} is not ported yet (ROADMAP A4)")
    ids = torch.tensor(list(channel_ids), dtype=torch.long)
    cids_on = {}
    gen = [generator]

    def step(state: TrainState, batch: Dict[str, torch.Tensor], draws: Optional[dict] = None):
        x, y = batch["image"], batch["label"]
        cids = cids_on.get(x.device)
        if cids is None:
            cids = cids_on[x.device] = ids.to(x.device)
        if gen[0] is None and k is not None and k < x.shape[1]:
            gen[0] = torch.Generator(device=x.device).manual_seed(0)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        xs, cs = _select_channels(model, x, cids, k=k, method=hcs_method, temp=hcs_temp,
                                  generator=gen[0], draws=draws)
        total, metrics = _loss_and_metrics(
            model, xs, cs, y, loss_type=loss_type, extra_loss_lambda=extra_loss_lambda,
            learnable_temp=learnable_temp, temperature=temperature)
        total.backward()
        metrics["grad_norm"] = state.apply_gradients()
        if cs is not cids:
            metrics["sampled_channels"] = cs
        return state, metrics

    return step
