"""Numpy image augmentations (host-side, per-example); the port's own copy
of the JAX package's ``data/transforms.py``.

Re-implementations of the reference's transform stacks without
torchvision/albumentations/cv2:

- So2Sat: random rot90 + two axis flips (``dataset_utils.py:23-76``)
- JUMP-CP: pad-to-256 + random crop 224, flip/rot90 one-of, Defocus(1-3),
  CoarseDropout(10x 10x10 holes) (``jump_cp_transforms.py:105-141``)

All functions take (C, H, W) float32 arrays and an ``np.random.Generator``;
randomness is explicit so loaders are reproducible per (seed, epoch, index).
CHAMMI's resized crops and CIFAR's channel recomposition come with those
datasets (ROADMAP A6).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# geometric
# ---------------------------------------------------------------------------


def random_rot90_flips(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """So2Sat train augmentation (``dataset_utils.py:52-63``)."""
    r = rng.integers(0, 4)
    img = np.rot90(img, int(r), (1, 2))
    if rng.integers(0, 2) == 1:
        img = np.flip(img, 1)
    if rng.integers(0, 2) == 1:
        img = np.flip(img, 2)
    return np.ascontiguousarray(img)


def random_pad_crop(
    rng: np.random.Generator, img: np.ndarray, pad_to: int, crop: int
) -> np.ndarray:
    """Albumentations PadIfNeeded(min=pad_to, position=random, zeros) +
    RandomCrop(crop) (``jump_cp_transforms.py:30-45``)."""
    c, h, w = img.shape
    if h < pad_to or w < pad_to:
        ph, pw = max(0, pad_to - h), max(0, pad_to - w)
        top_pad = int(rng.integers(0, ph + 1))
        left_pad = int(rng.integers(0, pw + 1))
        img = np.pad(
            img,
            ((0, 0), (top_pad, ph - top_pad), (left_pad, pw - left_pad)),
            mode="constant",
        )
        c, h, w = img.shape
    top = int(rng.integers(0, h - crop + 1))
    left = int(rng.integers(0, w - crop + 1))
    return img[:, top : top + crop, left : left + crop]


def flip_rotate_one_of(rng: np.random.Generator, img: np.ndarray, p: float = 0.5) -> np.ndarray:
    """A.OneOf([HFlip, VFlip, Rot90, Rot180, Rot270]) with probability p
    (``jump_cp_transforms.py:105-113``)."""
    if rng.random() > p:
        return img
    choice = int(rng.integers(0, 5))
    if choice == 0:
        return np.ascontiguousarray(np.flip(img, 2))  # horizontal
    if choice == 1:
        return np.ascontiguousarray(np.flip(img, 1))  # vertical
    return np.ascontiguousarray(np.rot90(img, choice - 1, (1, 2)))


# ---------------------------------------------------------------------------
# photometric / regularization
# ---------------------------------------------------------------------------


def defocus(
    rng: np.random.Generator, img: np.ndarray, radius_range=(1, 3), p: float = 0.5
) -> np.ndarray:
    """Albumentations Defocus: convolve with a disc kernel of random radius,
    applied with probability ``p`` (A.Defocus's default 0.5)."""
    if rng.random() > p:
        return img
    r = int(rng.integers(radius_range[0], radius_range[1] + 1))
    if r <= 0:
        return img
    y, x = np.mgrid[-r : r + 1, -r : r + 1]
    kernel = ((x * x + y * y) <= r * r).astype(np.float32)
    kernel /= kernel.sum()
    c, h, w = img.shape
    pad = r
    padded = np.pad(img, ((0, 0), (pad, pad), (pad, pad)), mode="reflect")
    # separately accumulate shifted copies — O(k^2) adds, no scipy needed
    out = np.zeros_like(img, dtype=np.float32)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            kv = kernel[dy, dx]
            if kv > 0:
                out += kv * padded[:, dy : dy + h, dx : dx + w]
    return out.astype(img.dtype)


def coarse_dropout(
    rng: np.random.Generator,
    img: np.ndarray,
    max_holes: int = 10,
    hole_h: int = 10,
    hole_w: int = 10,
    fill: float = 0.0,
    p: float = 0.5,
) -> np.ndarray:
    """Albumentations CoarseDropout (``jump_cp_transforms.py:124-130``),
    applied with its default per-sample probability 0.5."""
    if rng.random() > p:
        return img
    img = img.copy()
    c, h, w = img.shape
    # albumentations default min_holes=None -> always max_holes holes
    for _ in range(max_holes):
        y = int(rng.integers(0, max(1, h - hole_h)))
        x = int(rng.integers(0, max(1, w - hole_w)))
        img[:, y : y + hole_h, x : x + hole_w] = fill
    return img


def mask_channels(img: np.ndarray, channel_mask) -> np.ndarray:
    """Zero out relative channel indices (``dataset_utils.py:66-76``)."""
    if not len(channel_mask):
        return img
    img = img.copy()
    img[list(channel_mask)] = 0.0
    return img
