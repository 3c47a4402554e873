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

``augment_fn(generator, images)`` runs an augmentation on the device before
the channel selection, as the JAX step does (JUMP-CP's ``ops/augment.py``
in the Trainer). :func:`make_eval_step` is the eval forward.

:func:`make_grad_step` is CHAMMI's per-chunk micro-batch (the JAX
``make_grad_step``): the same forward and loss, its backward adding into
the parameters' ``.grad``, no update. A mixed batch zeroes the gradients
once, runs one grad step per chunk, and makes one update with
``TrainState.apply_gradients`` (the JAX ``make_apply_step``), which clips
the summed gradient and returns its norm before clipping: the accumulation
in ``.grad`` is JAX's ``tree_add``.

DropPath: a model built with ``drop_path_rate`` > 0 gets per-sample masks
drawn by ``ChannelVisionTransformer.draw_drop_path`` from the step's
generator after the channel selection; a step's ``draws["drop_path"]``
replaces them (how the tests hand JAX's masks to the port).

MIRO (``miro_pre``, ``miro_ld``): the live forward fills its taps, the
pre-featurizer (``training/miro.pre_featurizer``) runs on the same selected
channels in eval mode without gradient, and ``miro_ld * miro_vlb`` joins the
loss (JAX ``training/steps.py:131-185``); the metrics gain ``miro_loss``.
The encoders are the model's ``miro_encoders``.

``feature_fn`` is accepted and passed to the channel selection; only the
``_resnet34`` sampler reads it, and that sampler is not ported yet.

Ported for one device. The ``_proj`` / ``_resnet34`` / ``hcs_per_sample``
samplers and the multi-device mesh are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..models.wrappers import model_scale
from ..ops.losses import cross_entropy_loss, proxy_logits
from ..ops.sampling import NOT_PORTED, dcs_select
from .miro import MIRO_KEY, miro_vlb
from .state import TrainState


def _select_channels(model, x: torch.Tensor, cids: torch.Tensor, *, k: Optional[int],
                     method: str, temp: float, generator: Optional[torch.Generator],
                     draws: Optional[dict], feature_fn: Optional[Callable] = None):
    """Gather a sampled channel subset of the batch (the JAX
    ``_select_channels`` for the ported methods): ``(x_sel, cids_sel)``,
    both left on the device. ``k`` None or >= C keeps every channel. The
    cosine scores use the model's channel embeddings of the batch's ids,
    without gradient (the selection is not differentiable); ``uniform``
    reads only their count and device. ``feature_fn`` is the frozen scorer
    of the ``_resnet34`` sampler (JAX ``steps.py:105-118``), which no ported
    method reads yet."""
    if k is None or k >= x.shape[1]:
        return x, cids
    with torch.no_grad():
        emb = model.feature_extractor.patch_embed.channel_embed.weight.index_select(0, cids)
    idx = dcs_select(k, method, channel_embed=emb, temp=temp, generator=generator,
                     **{n: v for n, v in (draws or {}).items() if n != "drop_path"})
    return x.index_select(1, idx), cids.index_select(0, idx)


def _loss_and_metrics(model, x, cids, y, *, loss_type: str, extra_loss_lambda: float,
                      learnable_temp: bool, temperature: float, drop_path=None,
                      miro_pre=None, miro_ld: float = 0.0):
    feats = None if miro_pre is None else {}
    out, extra = model(x, cids, taps=feats, drop_path=drop_path)
    logits = out
    if loss_type == "proxy":
        logits = proxy_logits(model.proxies, out,
                              model_scale(model, learnable_temp, temperature))
    main = cross_entropy_loss(logits, y)
    total = main + extra_loss_lambda * extra
    metrics = {"main_loss": main.detach(), "extra_loss": extra.detach()}
    if miro_pre is not None:
        # the frozen pre-featurizer on the same input, eval mode, no gradient
        # (the reference's torch.no_grad, trainer.py:885-910)
        pre_feats: dict = {}
        with torch.no_grad():
            miro_pre(x, cids, taps=pre_feats)
        vlb = miro_vlb(getattr(model, MIRO_KEY), feats, pre_feats)
        total = total + miro_ld * vlb
        metrics["miro_loss"] = vlb.detach()
    acc = (logits.argmax(dim=-1) == y).float().mean()
    metrics.update(loss=total.detach(), acc=acc)
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
    augment_fn: Optional[Callable] = None,
    miro_pre: Optional[torch.nn.Module] = None,
    miro_ld: float = 0.0,
    feature_fn: Optional[Callable] = None,
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
    replaces one step's random draws.

    ``augment_fn(generator, images) -> images`` augments the batch first,
    drawing from the same generator before the channel sampling does (the
    JAX step's order).

    ``draws["drop_path"]`` (the list ``draw_drop_path`` returns) replaces
    the step's DropPath masks. ``miro_pre`` (the frozen pre-featurizer) and
    ``miro_ld`` add MIRO's loss (``miro_loss`` in the metrics);
    ``feature_fn`` goes to the channel selection."""
    grad_step = make_grad_step(
        model, channel_ids=channel_ids, k=k, hcs_method=hcs_method, hcs_temp=hcs_temp,
        generator=generator, loss_type=loss_type, extra_loss_lambda=extra_loss_lambda,
        learnable_temp=learnable_temp, temperature=temperature, augment_fn=augment_fn,
        miro_pre=miro_pre, miro_ld=miro_ld, feature_fn=feature_fn)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], draws: Optional[dict] = None):
        state.zero_grad()
        metrics = grad_step(batch, draws)
        metrics["grad_norm"] = state.apply_gradients()
        return state, metrics

    return step


def make_grad_step(
    model: torch.nn.Module,
    *,
    channel_ids: Sequence[int],
    k: Optional[int] = None,
    hcs_method: str = "none",
    hcs_temp: float = 0.1,
    generator: Optional[torch.Generator] = None,
    loss_type: str = "proxy",
    extra_loss_lambda: float = 0.0,
    learnable_temp: bool = False,
    temperature: float = 0.11111,
    augment_fn: Optional[Callable] = None,
    miro_pre: Optional[torch.nn.Module] = None,
    miro_ld: float = 0.0,
    feature_fn: Optional[Callable] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``grad_step(batch, draws=None) -> metrics``: one batch's forward,
    loss and backward, its gradients added into the parameters' ``.grad``,
    no update. It is CHAMMI's per-chunk micro-batch (the JAX
    ``make_grad_step``, whose gradients the trainer sums with ``tree_add``;
    the reference's repeated ``loss.backward()``, ``trainer.py:846-931``):
    the caller zeroes the gradients before the first chunk
    (``state.zero_grad()``) and updates once after the last
    (``state.apply_gradients()``, which returns the summed gradient's norm
    before clipping). The arguments and the metrics are
    :func:`make_train_step`'s, without ``grad_norm``."""
    if k is not None and k < len(channel_ids) and hcs_method in NOT_PORTED:
        raise NotImplementedError(
            f"hcs_sampling={hcs_method!r} is not ported yet (ROADMAP A4)")
    ids = torch.tensor(list(channel_ids), dtype=torch.long)
    cids_on = {}
    gen = [generator]

    def grad_step(batch: Dict[str, torch.Tensor], draws: Optional[dict] = None):
        x, y = batch["image"], batch["label"]
        cids = cids_on.get(x.device)
        if cids is None:
            cids = cids_on[x.device] = ids.to(x.device)
        fe = model.feature_extractor
        if gen[0] is None and (augment_fn is not None or k is not None and k < x.shape[1]
                               or fe.drop_path_rate > 0):
            gen[0] = torch.Generator(device=x.device).manual_seed(0)
        if augment_fn is not None:
            x = augment_fn(gen[0], x)
        model.train()
        xs, cs = _select_channels(model, x, cids, k=k, method=hcs_method, temp=hcs_temp,
                                  generator=gen[0], draws=draws, feature_fn=feature_fn)
        masks = None
        if fe.drop_path_rate > 0:
            masks = (draws or {}).get("drop_path")
            if masks is None:
                masks = fe.draw_drop_path(xs.shape[0], gen[0], xs.device)
        total, metrics = _loss_and_metrics(
            model, xs, cs, y, loss_type=loss_type, extra_loss_lambda=extra_loss_lambda,
            learnable_temp=learnable_temp, temperature=temperature, drop_path=masks,
            miro_pre=miro_pre, miro_ld=miro_ld)
        total.backward()
        if cs is not cids:
            metrics["sampled_channels"] = cs
        return metrics

    return grad_step


def make_eval_step(model: torch.nn.Module) -> Callable[..., torch.Tensor]:
    """``eval_step(images, channel_ids, override=None) -> out``: the model's
    eval-mode forward without gradient (the JAX ``make_eval_step``):
    logits for a model with a head, else the CLS embedding. ``override`` is
    the channel-embedding override of the novel-channel evals, (C, D) or
    per-sample (B, C, D), in place of the table's rows for ``channel_ids``."""

    def eval_step(x: torch.Tensor, cids: torch.Tensor,
                  override: Optional[torch.Tensor] = None) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            out, _ = model(x, cids, channel_embed_override=override)
        return out

    return eval_step
