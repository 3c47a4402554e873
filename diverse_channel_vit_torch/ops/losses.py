"""Losses of the DiChaViT train step (counterpart of the JAX package's
``ops/losses.py``), all computed in f32.

- :func:`cross_entropy_loss` — mean cross entropy over int labels or
  probabilities.
- :func:`proxy_loss` — squared-L2 distance between scale-normalised
  embeddings and proxies, fed through cross entropy (the CDL channel loss and
  the proxy main loss).
- :func:`orthogonal_projection_loss` — the TDL token-diversity loss by the
  O(N D) sum identity: with f_i the L2-normalised tokens, s_c the token sum
  of channel c and S the sum over channels,

      sum over i != j of one channel of f_i . f_j = sum_c ||s_c||^2 - N
      sum over pairs of different channels       = ||S||^2 - sum_c ||s_c||^2

  so no (N, N) Gram matrix is formed.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # torch F.normalize semantics: x / max(||x||, eps)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy. ``labels`` may be int classes or probabilities
    (the same shape as ``logits``)."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    if labels.ndim == logits.ndim:
        nll = -(labels.float() * log_probs).sum(dim=-1)
    else:
        nll = -log_probs.gather(-1, labels.long()[..., None])[..., 0]
    return nll.mean()


def proxy_logits(proxies: torch.Tensor, emb: torch.Tensor,
                 scale: Union[float, torch.Tensor]) -> torch.Tensor:
    """-||scale*norm(e) - scale*norm(p)||^2, the squared distances computed
    exactly as the reference's ``cdist**2``."""
    p = scale * _l2_normalize(proxies.float())
    e = scale * _l2_normalize(emb.float())
    d2 = (e * e).sum(dim=-1, keepdim=True) + (p * p).sum(dim=-1)[None, :] - 2.0 * e @ p.t()
    return -d2


def proxy_loss(proxies: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
               scale: Union[float, torch.Tensor]) -> torch.Tensor:
    """Proxy-NCA style loss. proxies: (K, D); emb: (N, D); labels: (N,) ints
    or (N, K) probabilities; scale: sqrt(1/T) (possibly learnable)."""
    return cross_entropy_loss(proxy_logits(proxies, emb, scale), labels)


def orthogonal_projection_loss(features: torch.Tensor, gamma_s: float, gamma_d: float,
                               reverse_pos_pairs: bool, use_square: bool,
                               channel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TDL loss on channel-grouped tokens, O(N D) by the sum identity.

    features: (B, C, N, D), N tokens per channel. channel_mask: optional (C,)
    or (B, C) boolean; masked channels contribute neither tokens nor pairs.
    """
    b, c, n, _ = features.shape
    f = _l2_normalize(features.float())
    if channel_mask is not None:
        mask = channel_mask.float().reshape(-1, c).expand(b, c)
        f = f * mask[:, :, None, None]
    else:
        mask = torch.ones((b, c), dtype=torch.float32, device=features.device)
    n_c = mask * n  # tokens per channel, (B, C)

    s_c = f.sum(dim=2)  # (B, C, D)
    s_all = s_c.sum(dim=1)  # (B, D)
    sq_c = (s_c * s_c).sum(dim=-1)  # (B, C)
    n_tok = n_c.sum(dim=1)  # (B,)

    pos_sum = sq_c.sum(dim=1) - n_tok
    neg_sum = (s_all * s_all).sum(dim=-1) - sq_c.sum(dim=1)
    pos_pairs = (n_c * (n_c - 1.0)).sum(dim=1) + 1e-6
    neg_pairs = n_tok * n_tok - (n_c * n_c).sum(dim=1) + 1e-6
    pos_mean = pos_sum / pos_pairs
    neg_mean = neg_sum / neg_pairs

    if use_square:
        neg_mean = neg_mean ** 2
    if reverse_pos_pairs:
        if use_square:
            pos_mean = pos_mean ** 2
        loss = gamma_s * pos_mean + gamma_d * neg_mean
    else:
        loss = gamma_s * (1.0 - pos_mean) + gamma_d * neg_mean
    return loss.mean()
