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

The samplers (``hcs_method``, JAX ``_select_channels``): the DCS methods
score the channel embeddings of the batch's ids; ``*_proj`` scores the
batch-mean cosine of each channel's projected patches (the patch embedding
without its bias, under ``no_grad``); ``*_resnet34`` that of
``feature_fn(x)`` (B, C, F), the Trainer's frozen ResNet-34
(``models/resnet.py``); ``hcs_per_sample`` draws a subset per sample and
trains with the (B, k, D) rows of the channel-embedding table as the
forward's override, so the table's gradient flows through the gather.
HCS token dropout draws its kept indices from the step's generator after
the DropPath masks; ``draws["token_drop"]`` replaces them.

Ported for one device. The multi-device mesh is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..models.wrappers import model_scale
from ..ops.losses import cross_entropy_loss, proxy_logits
from ..ops.patch_embed import per_channel_patch_embed
from ..ops.sampling import batch_cosine_matrix, dcs_select, per_sample_uniform_subsets
from .miro import MIRO_KEY, miro_vlb
from .state import TrainState


# the per-channel tables a sampler reads, by the port's parameter name
# (ChannelViT's modules, DepthwiseViT's parameter)
_TABLES = {"channel_embed": ("patch_embed.channel_embed.weight", "channel_embed"),
           "patch_embed.proj": ("patch_embed.proj.weight",)}


def _table(model, key: str, method: str) -> torch.Tensor:
    """The backbone's ``key`` table for the sampler ``method``, or
    ``ValueError`` naming it when the model has none."""
    params = dict(model.feature_extractor.named_parameters())
    for name in _TABLES[key]:
        if name in params:
            return params[name]
    raise ValueError(f"hcs_sampling={method!r} reads the model's {key} table, which "
                     f"{type(model.feature_extractor).__name__} does not have; "
                     "hcs_sampling=uniform samples channels for every model")


def _select_channels(model, x: torch.Tensor, cids: torch.Tensor, *, k: Optional[int],
                     method: str, temp: float, generator: Optional[torch.Generator],
                     draws: Optional[dict], feature_fn: Optional[Callable] = None):
    """Gather a sampled channel subset of the batch (the JAX
    ``_select_channels``): ``(x_sel, cids_sel, override)``, all left on the
    device. ``k`` None or >= C keeps every channel. The scores carry no
    gradient (the selection is not differentiable): the channel embeddings
    of the batch's ids, or for ``*_proj`` / ``*_resnet34`` the batch-mean
    cosine of per-channel features. ``uniform`` reads only the count.
    ``hcs_per_sample`` returns the (B, k) gather, the first sample's ids
    and the (B, k, D) override of the table's rows, which does carry the
    gradient (JAX ``steps.py:83-93``); the others return no override.
    ``feature_fn`` is the ``_resnet34`` scorer (JAX ``steps.py:111-124``).
    ``uniform`` and ``_resnet34`` work for every model; a method that reads
    a table the model lacks (the channel embeddings, or ``_proj``'s patch
    projection, which only ChannelViT and DiChaViT have; DepthwiseViT has
    channel embeddings) raises ``ValueError`` naming it, where JAX raises
    ``KeyError``."""
    b, c = x.shape[:2]
    if k is None or k >= c:
        return x, cids, None
    picked = {n: v for n, v in (draws or {}).items() if n in ("anchor", "gumbel")}
    if method == "hcs_per_sample":
        idx = per_sample_uniform_subsets(b, c, k, device=x.device, generator=generator,
                                         gumbel=picked.get("gumbel"))  # (B, k)
        x_sel = torch.gather(x, 1, idx[:, :, None, None].expand(-1, -1, *x.shape[2:]))
        override = _table(model, "channel_embed", method).index_select(0, cids)[idx]  # (B, k, D)
        return x_sel, cids.index_select(0, idx[0]), override
    cos = None
    scored = method not in (None, "none", "uniform")
    if scored and method.endswith("_proj"):
        p = model.feature_extractor.patch_size
        weight = _table(model, "patch_embed.proj", method)
        with torch.no_grad():  # the reference samples under no_grad
            kernel = weight.reshape(weight.shape[0], p * p).t()
            toks = per_channel_patch_embed(x, kernel, None, patch_size=p)
            cos = batch_cosine_matrix(toks.reshape(b, c, -1))
    elif scored and method.endswith("_resnet34"):
        if feature_fn is None:
            raise ValueError(
                "hcs_sampling=*_resnet34 needs the trainer-provided frozen "
                "backbone (model.resnet34_ckpt); see trainer._hcs_feature_fn")
        with torch.no_grad():
            cos = batch_cosine_matrix(feature_fn(x))
    emb = None
    if cos is None:  # uniform reads only the count, as JAX's zeros (C, 1) give it
        emb = (_table(model, "channel_embed", method).detach().index_select(0, cids) if scored
               else x.new_zeros(c, 1))
    idx = dcs_select(k, method, channel_embed=emb, cos_matrix=cos, temp=temp,
                     generator=generator, **picked)
    return x.index_select(1, idx), cids.index_select(0, idx), None


def _loss_and_metrics(model, x, cids, y, *, loss_type: str, extra_loss_lambda: float,
                      learnable_temp: bool, temperature: float, drop_path=None,
                      miro_pre=None, miro_ld: float = 0.0, override=None, token_drop=None):
    feats = None if miro_pre is None else {}
    out, extra = model(x, cids, override, taps=feats, drop_path=drop_path,
                       token_drop=token_drop)
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
            miro_pre(x, cids, taps=pre_feats)  # no override, as JAX's (steps.py:176)
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
    ``"lowest_cosine_prob"``, ``"lowest_cosine_prob_proj"``,
    ``"lowest_cosine_prob_resnet34"``, ``"hcs_per_sample"``) at temperature
    ``hcs_temp``, drawing from ``generator`` (by default one seeded with 0
    on the batch's device). ``draws`` ({"anchor": ..., "gumbel": ...}, see
    ``ops.sampling.dcs_select``; a (B, C) ``gumbel`` for
    ``hcs_per_sample``) replaces one step's random draws.

    ``augment_fn(generator, images) -> images`` augments the batch first,
    drawing from the same generator before the channel sampling does (the
    JAX step's order).

    ``draws["drop_path"]`` (the list ``draw_drop_path`` returns) replaces
    the step's DropPath masks, ``draws["token_drop"]`` (``draw_token_drop``)
    its HCS token dropout. ``miro_pre`` (the frozen pre-featurizer) and
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
                               or fe.drop_path_rate > 0 or fe.token_dropout_on()):
            gen[0] = torch.Generator(device=x.device).manual_seed(0)
        if augment_fn is not None:
            x = augment_fn(gen[0], x)
        model.train()
        xs, cs, override = _select_channels(model, x, cids, k=k, method=hcs_method,
                                            temp=hcs_temp, generator=gen[0], draws=draws,
                                            feature_fn=feature_fn)
        draws = draws or {}
        masks = None
        if fe.drop_path_rate > 0:
            masks = draws.get("drop_path")
            if masks is None:
                masks = fe.draw_drop_path(xs.shape[0], gen[0], xs.device)
        token_drop = None
        if fe.token_dropout_on():
            token_drop = draws.get("token_drop")
            if token_drop is None:
                p = fe.patch_size
                token_drop = fe.draw_token_drop(
                    xs.shape[1], (xs.shape[2] // p) * (xs.shape[3] // p), gen[0], xs.device)
        total, metrics = _loss_and_metrics(
            model, xs, cs, y, loss_type=loss_type, extra_loss_lambda=extra_loss_lambda,
            learnable_temp=learnable_temp, temperature=temperature, drop_path=masks,
            miro_pre=miro_pre, miro_ld=miro_ld, override=override, token_drop=token_drop)
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
