"""Channel sampling, DCS and HCS (counterpart of the JAX package's
``ops/sampling.py``).

The draws come from an explicit ``torch.Generator`` and stay on the device:
no ``.item()``, no host round trip. Only ``k``, the number of channels
drawn, is a host int (it fixes the shapes of the step). Sampling without
replacement is the Gumbel-top-k trick, as in the JAX package, not
``torch.multinomial``: the same distribution as the reference's sequential
``torch.multinomial(prob, k, replacement=False)``, and a draw that a test can
hand in. ``anchor`` and ``gumbel`` are that seam: given, they replace the
generator's draws (``jax.random.randint`` of the anchor and
``jax.random.gumbel`` of the noise, in JAX's order), so both packages pick
the same channels.

Every method of the JAX package: ``uniform``, ``lowest_cosine``,
``highest_cosine``, ``lowest_cosine_prob`` and its ``_proj`` and
``_resnet34`` variants, which score the channels by a batch-mean cosine
matrix (:func:`batch_cosine_matrix`, given as ``cos_matrix``) instead of the
channel embeddings, and ``hcs_per_sample``'s independent subset per sample
(:func:`per_sample_uniform_subsets`, whose seam is a (B, C) ``gumbel``).
"""

from __future__ import annotations

from typing import Optional

import torch

def gumbel_noise(generator: torch.Generator, n: int, device: torch.device) -> torch.Tensor:
    """(n,) standard Gumbel noise, -log(-log(u)) with u uniform in
    [tiny, 1), drawn on the generator's device (torch's default generator of
    ``device`` when None) and moved to ``device``."""
    u = torch.rand(n, generator=generator,
                   device=device if generator is None else generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def gumbel_topk(logits: torch.Tensor, k: int, *, generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k indices without replacement from softmax(logits), in order of
    logits + Gumbel noise, descending (the JAX ``gumbel_topk``)."""
    if gumbel is None:
        gumbel = gumbel_noise(generator, logits.shape[-1], logits.device)
    return torch.topk(logits.float() + gumbel.to(logits.device), k).indices


def uniform_subset(c: int, k: int, *, device: torch.device,
                   generator: Optional[torch.Generator] = None,
                   gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k distinct indices drawn uniformly from range(c)."""
    return gumbel_topk(torch.zeros(c, device=device), k, generator=generator, gumbel=gumbel)


def force_include(indices: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """``indices`` with its last slot set to ``anchor`` unless the anchor is
    already among them (the reference's ``indices[-1] = first_channel_idx``),
    computed on the device."""
    present = (indices == anchor).any()
    out = indices.clone()
    out[-1] = torch.where(present, indices[-1], anchor.to(indices.dtype))
    return out


def cosine_similarity_matrix(emb: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(C, C) cosine similarities of the rows of ``emb``, in f32."""
    e = emb.float()
    e = e / torch.clamp_min(torch.linalg.vector_norm(e, dim=-1, keepdim=True), eps)
    return e @ e.t()


def batch_cosine_matrix(features: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(B, C, F) features -> the batch mean of each sample's (C, C) cosine
    matrix of its channels' features, in f32 (the JAX
    ``batch_cosine_matrix``; the ``_proj`` and ``_resnet34`` scores)."""
    f = features.float()
    f = f / torch.clamp_min(torch.linalg.vector_norm(f, dim=-1, keepdim=True), eps)
    return torch.einsum("bcd,bed->bce", f, f).mean(dim=0)


def per_sample_uniform_subsets(b: int, c: int, k: int, *, device: torch.device,
                               generator: Optional[torch.Generator] = None,
                               gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, k) independent uniform subsets of range(c), one per sample
    (``hcs_per_sample``; the JAX ``per_sample_uniform_subsets``): each row
    the top k of its own Gumbel noise. ``gumbel`` (B, C) replaces the
    generator's draw (JAX draws row i from the i-th of ``split(key, B)``)."""
    if gumbel is None:
        u = torch.rand(b, c, generator=generator, device=generator.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.topk(gumbel.to(device).float(), k, dim=-1).indices


def dcs_select(k: int, method: Optional[str], *, channel_embed: Optional[torch.Tensor] = None,
               cos_matrix: Optional[torch.Tensor] = None,
               temp: float = 0.1, generator: Optional[torch.Generator] = None,
               anchor: Optional[torch.Tensor] = None,
               gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diverse Channel Sampling: ``k`` of the C channels whose embeddings are
    the rows of ``channel_embed`` (C, D), as (k,) int64 positions on its
    device (the JAX ``dcs_select``).

    - ``"uniform"`` (or ``"none"``/None): a uniform subset.
    - ``"lowest_cosine"`` / ``"highest_cosine"``: the k channels least / most
      similar (cosine of the embeddings) to a random anchor channel, the
      anchor forced in.
    - ``"lowest_cosine_prob"``: k channels without replacement with
      probability softmax((1 - cos) / temp) against the anchor, the anchor
      forced in; ``"lowest_cosine_prob_proj"`` and
      ``"lowest_cosine_prob_resnet34"`` the same over ``cos_matrix``, the
      (C, C) batch-mean cosines of the step's per-channel features.

    ``cos_matrix``, when given, takes the place of the embeddings' cosines
    for every method (the JAX ``dcs_select``); the ``_proj`` and
    ``_resnet34`` methods need it.

    Draws: the anchor (``randint``), then for the ``lowest_cosine_prob``
    methods the Gumbel noise, from ``generator``, unless given as ``anchor``
    (0-d integer) and ``gumbel`` ((C,) f32)."""
    src = channel_embed if channel_embed is not None else cos_matrix
    c, device = src.shape[0], src.device
    if method in (None, "none", "uniform"):
        return uniform_subset(c, k, device=device, generator=generator, gumbel=gumbel)
    if method not in ("lowest_cosine", "highest_cosine") \
            and not method.startswith("lowest_cosine_prob"):
        raise ValueError(f"Invalid hcs_sampling: {method!r}")
    if cos_matrix is None:
        if method.endswith(("_proj", "_resnet34")):
            raise ValueError(f"dcs_select({method!r}) needs the features' cos_matrix")
        cos_matrix = cosine_similarity_matrix(channel_embed)
    if anchor is None:
        anchor = torch.randint(0, c, (), generator=generator, device=generator.device)
    anchor = anchor.to(device)
    cos = cos_matrix[anchor]  # (C,)
    if method == "lowest_cosine":
        idx = torch.topk(-cos, k).indices
    elif method == "highest_cosine":
        idx = torch.topk(cos, k).indices
    else:
        idx = gumbel_topk((1.0 - cos) / temp, k, generator=generator, gumbel=gumbel)
    return force_include(idx, anchor)
