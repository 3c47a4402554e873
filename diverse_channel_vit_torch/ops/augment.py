"""Batched JUMP-CP train augmentation on the batch's device (counterpart of
the JAX package's ``ops/augment.py``).

The reference runs albumentations per image on the host
(``jump_cp_transforms.py:105-141``); this is the same pipeline over a whole
(B, C, H, W) batch where the batch lies, the JAX package's order:

    pad-to-256 (random position) -> random crop 224 -> one-of
    {hflip, vflip, rot90, rot180, rot270} (p=0.5) -> Defocus(r in 1..3,
    p=0.5) -> CoarseDropout(10 x 10x10, p=0.5) -> normalize

Every sample draws its own parameters from an explicit ``torch.Generator``.
``draws`` replaces them, as ``ops/sampling.py``'s ``anchor`` / ``gumbel``
do, so a test can hand in the JAX package's draws (see :func:`make_draws`
for the keys and their ranges). Pad and crop are one gather; the flips and
rotations index per choice; Defocus is one grouped ``F.conv2d`` with a disc
kernel per sample (radius 1-3 zero-padded to 7 x 7, over a reflect pad of
3: the inner rows of a reflect pad of 3 are those of a pad of r); the holes
are a mask. This is not a TPU kernel: library ops are the port here.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

RADII = (1, 2, 3)
HOLES, HOLE = 10, 10  # CoarseDropout: max_holes, hole height and width


def _disc_kernel(r: int) -> np.ndarray:
    y, x = np.mgrid[-r : r + 1, -r : r + 1]
    k = ((x * x + y * y) <= r * r).astype(np.float32)
    return k / k.sum()


def make_draws(generator: torch.Generator, b: int, h: int, w: int, *, img_size: int = 224,
               pad_to: int = 256, p: float = 0.5) -> Dict[str, torch.Tensor]:
    """One batch's random parameters, drawn on the generator's device:

    - ``pad_top`` / ``pad_left`` (B,) in [0, max(0, pad_to - h)] / [.., w]
    - ``crop_top`` / ``crop_left`` (B,) in [0, H' - img_size], H' the padded size
    - ``flip_apply`` (B,) bool (p), ``flip_choice`` (B,) in [0, 5)
    - ``defocus_radius`` (B,) in RADII, ``defocus_apply`` (B,) bool (p)
    - ``hole_top`` / ``hole_left`` (B, 10) in [0, max(1, img_size - 10))
    - ``hole_apply`` (B,) bool (p)
    """
    dev = generator.device
    ph, pw = max(0, pad_to - h), max(0, pad_to - w)
    hp, wp = h + ph, w + pw

    def ints(high, shape=(b,)):
        return torch.randint(0, high, shape, generator=generator, device=dev)

    def coin():
        return torch.rand(b, generator=generator, device=dev) <= p

    hmax = max(1, img_size - HOLE)
    return {
        "pad_top": ints(ph + 1), "pad_left": ints(pw + 1),
        "crop_top": ints(hp - img_size + 1), "crop_left": ints(wp - img_size + 1),
        "flip_apply": coin(), "flip_choice": ints(5),
        "defocus_radius": ints(len(RADII)) + RADII[0], "defocus_apply": coin(),
        "hole_top": ints(hmax, (b, HOLES)), "hole_left": ints(hmax, (b, HOLES)),
        "hole_apply": coin(),
    }


def pad_crop(x: torch.Tensor, pad_top, pad_left, crop_top, crop_left, *, img_size: int,
             pad_to: int) -> torch.Tensor:
    """Zero-pad each image to (pad_to, pad_to) at (pad_top, pad_left), then
    crop img_size² at (crop_top, crop_left); images at least pad_to wide are
    not padded (PadIfNeeded). One gather: crop row i reads source row
    crop_top + i - pad_top, zero where that falls outside the image."""
    b, c, h, w = x.shape
    if h >= pad_to and w >= pad_to:
        pad_top = torch.zeros_like(pad_top)
        pad_left = torch.zeros_like(pad_left)
    ar = torch.arange(img_size, device=x.device)
    rows = (crop_top - pad_top)[:, None].to(x.device) + ar  # (B, S)
    cols = (crop_left - pad_left)[:, None].to(x.device) + ar
    rin, cin = (rows >= 0) & (rows < h), (cols >= 0) & (cols < w)
    bi = torch.arange(b, device=x.device)[:, None, None]
    out = x[bi, :, rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    out = out.permute(0, 3, 1, 2)  # (B, S, S, C) -> (B, C, S, S)
    keep = (rin[:, :, None] & cin[:, None, :])[:, None]
    return torch.where(keep, out, torch.zeros((), dtype=x.dtype, device=x.device))


_FLIPS = (
    lambda t: torch.flip(t, (3,)),  # horizontal
    lambda t: torch.flip(t, (2,)),  # vertical
    lambda t: torch.rot90(t, 1, (2, 3)),
    lambda t: torch.rot90(t, 2, (2, 3)),
    lambda t: torch.rot90(t, 3, (2, 3)),
)


def flip_rotate_one_of(x: torch.Tensor, apply, choice) -> torch.Tensor:
    """A.OneOf([HFlip, VFlip, Rot90, Rot180, Rot270]) where ``apply``."""
    out = x.clone()
    apply, choice = apply.to(x.device), choice.to(x.device)
    for c, fn in enumerate(_FLIPS):
        idx = torch.nonzero(apply & (choice == c)).flatten()
        if idx.numel():
            out[idx] = fn(x[idx])
    return out


def defocus(x: torch.Tensor, radius, apply) -> torch.Tensor:
    """Per-sample disc blur of radius ``radius`` (in RADII) over a reflect
    pad, where ``apply``: one grouped convolution, a 7 x 7 kernel per
    (image, channel)."""
    b, c, h, w = x.shape
    r_max = max(RADII)
    size = 2 * r_max + 1
    bank = torch.zeros(len(RADII), size, size)
    for i, r in enumerate(RADII):
        o = r_max - r
        bank[i, o : o + 2 * r + 1, o : o + 2 * r + 1] = torch.from_numpy(_disc_kernel(r))
    bank = bank.to(device=x.device, dtype=x.dtype)
    kern = bank[(radius.to(x.device) - RADII[0]).long()]  # (B, size, size)
    kern = kern[:, None].expand(b, c, size, size).reshape(b * c, 1, size, size)
    padded = F.pad(x, (r_max,) * 4, mode="reflect").reshape(1, b * c, h + 2 * r_max,
                                                            w + 2 * r_max)
    blurred = F.conv2d(padded, kern, groups=b * c).reshape(b, c, h, w)
    return torch.where(apply.to(x.device)[:, None, None, None], blurred, x)


def coarse_dropout(x: torch.Tensor, hole_top, hole_left, apply, *, hole: int = HOLE
                   ) -> torch.Tensor:
    """A.CoarseDropout: zero every hole x hole square at (hole_top,
    hole_left) (B, holes) where ``apply``."""
    b, c, h, w = x.shape
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)
    ht, hl = hole_top.to(x.device)[:, :, None], hole_left.to(x.device)[:, :, None]
    in_r = (rows >= ht) & (rows < ht + hole)  # (B, holes, H)
    in_c = (cols >= hl) & (cols < hl + hole)  # (B, holes, W)
    inside = (in_r[:, :, :, None] & in_c[:, :, None, :]).any(dim=1)
    inside = inside & apply.to(x.device)[:, None, None]
    return torch.where(inside[:, None], torch.zeros((), dtype=x.dtype, device=x.device), x)


def jumpcp_train_augment(generator: Optional[torch.Generator], imgs: torch.Tensor,
                         mean: Sequence[float], std: Sequence[float], *, img_size: int = 224,
                         pad_to: int = 256, draws: Optional[Dict[str, torch.Tensor]] = None
                         ) -> torch.Tensor:
    """The whole CellAugmentation train pipeline on a (B, C, H, W) raw batch,
    in its dtype, then normalised by the per-channel ``mean`` / ``std``
    (f32 out, as the JAX function's f32 statistics promote it). ``draws``
    (all the keys of :func:`make_draws`) replaces the generator's draws."""
    b, c, h, w = imgs.shape
    d = draws if draws is not None else make_draws(generator, b, h, w, img_size=img_size,
                                                   pad_to=pad_to)
    out = pad_crop(imgs, d["pad_top"], d["pad_left"], d["crop_top"], d["crop_left"],
                   img_size=img_size, pad_to=pad_to)
    out = flip_rotate_one_of(out, d["flip_apply"], d["flip_choice"])
    out = defocus(out, d["defocus_radius"], d["defocus_apply"])
    out = coarse_dropout(out, d["hole_top"], d["hole_left"], d["hole_apply"])
    m = torch.as_tensor(mean, dtype=torch.float32, device=imgs.device)[None, :, None, None]
    s = torch.as_tensor(std, dtype=torch.float32, device=imgs.device)[None, :, None, None]
    return (out - m) / s
