"""DINOv2 ViT feature backbone, eval only (counterpart of the JAX package's
``models/dinov2.py``).

The reference's feature extraction (``morphem/feature_extraction.py:34-44``)
loads ``dinov2_vits14_reg`` from torch.hub and reads
``forward_features(x)["x_norm_clstoken"]``. Nothing is downloaded here: the
weights come from a local state dict in the hub layout (``cls_token``,
``blocks.N.attn.qkv.*``, ``blocks.N.ls1.gamma``) or the HuggingFace
``Dinov2WithRegistersModel`` layout (:func:`canon_hub_layout`). The modules
keep the hub's names, so a hub state dict loads by name.

The positional table is resampled as the hub's ``interpolate_pos_encoding``
does: for the ``*_reg`` backbones a size-based antialiased bicubic
(``offset`` 0, ``antialias``), whose tables (:func:`torch_bicubic_1d_aa`) are
torch's separable antialiased kernel (a = -0.5, taps clipped to the input
and renormalised); for the plain backbones a scale-factor bicubic at
``(g + 0.1) / side`` without antialiasing (a = -0.75, border replicate). The
resample is a pair of small gathers and einsums made once per geometry.

Everything runs in f32 as JAX runs it; the attention is the plain softmax
product (JAX ``models/dinov2.py:124-126``), a ``torch.matmul`` pair, and
the GELU is exact, as the hub's. No TPU kernel lies on this path.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .channel_vit import _torch_bicubic_1d


def _bicubic_filter(d: np.ndarray, a: float = -0.5) -> np.ndarray:
    d = np.abs(d)
    return np.where(d <= 1.0, (a + 2) * d**3 - (a + 3) * d**2 + 1.0,
                    np.where(d < 2.0, a * d**3 - 5 * a * d**2 + 8 * a * d - 4 * a, 0.0))


def torch_bicubic_1d_aa(size_in: int, size_out: int, scale_factor: float):
    """Index and weight tables, (size_out, taps) each, of one axis of torch
    ``F.interpolate(mode="bicubic", antialias=True)`` at ``scale_factor``:
    centers at ``scale * (i + 0.5)`` with ``scale = 1 / scale_factor``, the
    support stretched by ``scale`` when down-scaling, out-of-range taps
    clipped and the window renormalised; padded taps weigh 0. Equal sizes
    are the identity, as in torch."""
    if size_in == size_out:
        return np.arange(size_out)[:, None], np.ones((size_out, 1), np.float32)
    scale = 1.0 / scale_factor
    support = 2.0 * scale if scale >= 1.0 else 2.0
    invscale = 1.0 / scale if scale >= 1.0 else 1.0
    centers = scale * (np.arange(size_out) + 0.5)
    xmin = np.maximum(0, (centers - support + 0.5).astype(np.int64))
    xmax = np.minimum(size_in, (centers + support + 0.5).astype(np.int64))
    taps = max(int((xmax - xmin).max()), 1)
    idx = xmin[:, None] + np.arange(taps)[None, :]
    w = _bicubic_filter((idx + 0.5 - centers[:, None]) * invscale)
    w = np.where(idx < xmax[:, None], w, 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    return np.clip(idx, 0, size_in - 1), w.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _pos_tables(side: int, h0: int, w0: int, offset: float, antialias: bool,
                device: torch.device):
    fn = torch_bicubic_1d_aa if antialias else _torch_bicubic_1d
    tables = fn(side, h0, (h0 + offset) / side) + fn(side, w0, (w0 + offset) / side)
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(np.asarray(a), device=device) for a in tables)


def interpolate_pos_embed_dinov2(pos_embed: torch.Tensor, h0: int, w0: int, *,
                                 offset: float = 0.0, antialias: bool = True) -> torch.Tensor:
    """The hub's ``interpolate_pos_encoding``: the (1, 1 + N, D) table's CLS
    row kept, its square patch grid resampled to (h0, w0) at the effective
    scale ``(g + offset) / side``; the table itself at its native square
    grid."""
    n = pos_embed.shape[1] - 1
    if h0 * w0 == n and h0 == w0:
        return pos_embed
    dim = pos_embed.shape[-1]
    side = int(math.isqrt(n))
    if side * side != n:
        raise ValueError(f"non-square positional grid of {n} rows")
    grid = pos_embed[0, 1:].reshape(side, side, dim).float()
    idx_h, w_h, idx_w, w_w = _pos_tables(side, h0, w0, float(offset), bool(antialias),
                                         pos_embed.device)
    rows = torch.einsum("otsd,ot->osd", grid[idx_h], w_h)
    out = torch.einsum("hotd,ot->hod", rows[:, idx_w], w_w)
    return torch.cat([pos_embed[:, :1], out.reshape(1, h0 * w0, dim).to(pos_embed.dtype)], dim=1)


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d // self.heads)
        o = torch.matmul(torch.softmax(s, dim=-1), v)
        return self.proj(o.transpose(1, 2).reshape(b, n, d))


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class DinoBlock(nn.Module):
    """Pre-norm attention and MLP, each residual scaled by a LayerScale gamma
    (hub ``dinov2/layers/block.py``), exact GELU."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads)
        self.ls1 = _LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = _LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1.gamma * self.attn(self.norm1(x))
        y = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x + self.ls2.gamma * y


class DinoV2ViT(nn.Module):
    """DINOv2 with register tokens; :meth:`forward_features` returns the
    hub's dict (``x_norm_clstoken``, ``x_norm_regtokens``,
    ``x_norm_patchtokens``). The (interpolated) positional table goes to
    [cls | patches]; the register tokens follow the CLS token without one.
    Zero-initialised tokens and tables, torch's default layers, until a
    state dict loads (:func:`load_torch_dinov2_state`)."""

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 patch_size: int = 14, num_registers: int = 4, mlp_ratio: float = 4.0,
                 pos_grid: int = 37, interpolate_offset: float = 0.0,
                 interpolate_antialias: bool = True):
        super().__init__()
        self.embed_dim, self.patch_size, self.num_registers = embed_dim, patch_size, num_registers
        self.interpolate_offset = interpolate_offset
        self.interpolate_antialias = interpolate_antialias
        self.patch_embed = _PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid * pos_grid, embed_dim))
        self.register_tokens = (nn.Parameter(torch.zeros(1, num_registers, embed_dim))
                                if num_registers else None)
        self.blocks = nn.ModuleList(DinoBlock(embed_dim, num_heads, mlp_ratio)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward_features(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, _, hh, ww = x.shape
        p, d = self.patch_size, self.embed_dim
        if hh % p or ww % p:
            raise ValueError(f"input {hh}x{ww} is no multiple of the patch {p}: pad it first "
                             "(pad_to_patch_multiple)")
        tok = self.patch_embed.proj(x.float())  # (B, D, gh, gw)
        gh, gw = tok.shape[-2:]
        seq = torch.cat([self.cls_token.expand(b, 1, d), tok.flatten(2).transpose(1, 2)], dim=1)
        seq = seq + interpolate_pos_embed_dinov2(self.pos_embed, gh, gw,
                                                 offset=self.interpolate_offset,
                                                 antialias=self.interpolate_antialias)
        if self.register_tokens is not None:
            seq = torch.cat([seq[:, :1], self.register_tokens.expand(b, -1, d), seq[:, 1:]],
                            dim=1)
        for blk in self.blocks:
            seq = blk(seq)
        seq = self.norm(seq)
        r = 1 + self.num_registers
        return {"x_norm_clstoken": seq[:, 0], "x_norm_regtokens": seq[:, 1:r],
                "x_norm_patchtokens": seq[:, r:]}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W), H and W multiples of the patch -> the (B, D) CLS
        features."""
        return self.forward_features(x)["x_norm_clstoken"]


def canon_hub_layout(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A hub- or HuggingFace-layout DINOv2 state dict in the hub's names, as
    f32 numpy arrays (the HF per-projection q, k, v joined into ``qkv``)."""
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    if "cls_token" in sd:
        return sd
    out = {"cls_token": sd["embeddings.cls_token"],
           "pos_embed": sd["embeddings.position_embeddings"],
           "patch_embed.proj.weight": sd["embeddings.patch_embeddings.projection.weight"],
           "patch_embed.proj.bias": sd["embeddings.patch_embeddings.projection.bias"],
           "norm.weight": sd["layernorm.weight"], "norm.bias": sd["layernorm.bias"]}
    if "embeddings.register_tokens" in sd:
        out["register_tokens"] = sd["embeddings.register_tokens"]
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in sd:
        pre, o = f"encoder.layer.{i}", f"blocks.{i}"
        for name in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                out[f"{o}.{name}.{leaf}"] = sd[f"{pre}.{name}.{leaf}"]
        for leaf in ("weight", "bias"):
            out[f"{o}.attn.qkv.{leaf}"] = np.concatenate(
                [sd[f"{pre}.attention.attention.{m}.{leaf}"] for m in ("query", "key", "value")])
            out[f"{o}.attn.proj.{leaf}"] = sd[f"{pre}.attention.output.dense.{leaf}"]
        out[f"{o}.ls1.gamma"] = sd[f"{pre}.layer_scale1.lambda1"]
        out[f"{o}.ls2.gamma"] = sd[f"{pre}.layer_scale2.lambda1"]
        i += 1
    return out


# head counts of the published DINOv2 widths (vit_small / base / large / giant2)
HEADS_BY_DIM = {384: 6, 768: 12, 1024: 16, 1536: 24}


def config_from_state_dict(sd: Dict[str, Any], num_heads: Optional[int] = None) -> dict:
    """The architecture of a state dict (either layout). The head count is
    not in the weights: the published widths' unless ``num_heads`` is
    given; another width without it raises ``ValueError``."""
    sd = canon_hub_layout(sd)
    dim = int(sd["cls_token"].shape[-1])
    if num_heads is None:
        num_heads = HEADS_BY_DIM.get(dim, 6)
        if dim % num_heads:
            raise ValueError(f"cannot infer num_heads for embed_dim={dim}; pass num_heads=")
    depth = 0
    while f"blocks.{depth}.norm1.weight" in sd:
        depth += 1
    n = int(sd["pos_embed"].shape[1]) - 1
    return dict(embed_dim=dim, depth=depth, num_heads=int(num_heads),
                patch_size=int(sd["patch_embed.proj.weight"].shape[-1]),
                num_registers=(int(sd["register_tokens"].shape[1]) if "register_tokens" in sd
                               else 0),
                mlp_ratio=float(sd["blocks.0.mlp.fc1.weight"].shape[0] / dim),
                pos_grid=int(math.isqrt(n)))


@torch.no_grad()
def load_torch_dinov2_state(model: DinoV2ViT, sd: Dict[str, Any]) -> DinoV2ViT:
    """Load a hub- or HF-layout state dict into ``model`` in place. Every
    tensor of the model must be there (keys of the hub's that the forward
    does not read, ``mask_token``, are left out)."""
    sd = canon_hub_layout(sd)
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"DINOv2 state dict lacks {missing[:4]}")
    model.load_state_dict({k: torch.from_numpy(sd[k]) for k in own}, strict=True)
    return model


def pad_to_patch_multiple(x: torch.Tensor, patch: int) -> torch.Tensor:
    """The reference's ``create_pad`` (``morphem/feature_extraction.py:
    94-119``): zero-pad H and W up to multiples of ``patch``, the odd pixel on
    the right / bottom; on the tensor's device."""
    h, w = x.shape[-2:]
    ph, pw = (-h) % patch, (-w) % patch
    if not (ph or pw):
        return x
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
