"""Numpy image augmentations (host-side, per-example); the port's own copy
of the JAX package's ``data/transforms.py``.

Re-implementations of the reference's transform stacks without
torchvision/albumentations/cv2:

- So2Sat: random rot90 + two axis flips (``dataset_utils.py:23-76``)
- CHAMMI: RandomResizedCrop(scale 0.8-1.0, ratio 0.9-1.1) + HFlip for train,
  Resize + CenterCrop for eval (``dataset_utils.py:233-280``)
- JUMP-CP: pad-to-256 + random crop 224, flip/rot90 one-of, Defocus(1-3),
  CoarseDropout(10x 10x10 holes) (``jump_cp_transforms.py:105-141``)

All functions take (C, H, W) float32 arrays and an ``np.random.Generator``;
randomness is explicit so loaders are reproducible per (seed, epoch, index).
:func:`get_channel` recomposes CIFAR's RGB into a chunk's channel list
(``dataset_utils.py:316-360``).
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


def hflip(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.flip(img, 2))


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(C, H, W) bilinear resize, torch ``align_corners=False`` convention."""
    c, h, w = img.shape
    if (h, w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * (w / out_w) - 0.5
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[None, :, None]
    wx = (xs - x0)[None, None, :]
    a = img[:, y0][:, :, x0]
    b = img[:, y0][:, :, x1]
    c_ = img[:, y1][:, :, x0]
    d = img[:, y1][:, :, x1]
    top = a * (1 - wx) + b * wx
    bot = c_ * (1 - wx) + d * wx
    return (top * (1 - wy) + bot * wy).astype(img.dtype)


def resize(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision Resize(size): scale the short side to ``size``."""
    c, h, w = img.shape
    if h <= w:
        out_h, out_w = size, max(1, round(w * size / h))
    else:
        out_h, out_w = max(1, round(h * size / w)), size
    return _bilinear_resize(img, out_h, out_w)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    c, h, w = img.shape
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    out = img[:, top : top + size, left : left + size]
    if out.shape[1] != size or out.shape[2] != size:  # pad if smaller
        pad_h, pad_w = size - out.shape[1], size - out.shape[2]
        out = np.pad(out, ((0, 0), (pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2)))
    return out


def sample_rrc_params(
    rng: np.random.Generator, h: int, w: int, scale=(0.8, 1.0), ratio=(0.9, 1.1)
):
    """torchvision RandomResizedCrop param sampling (10 tries then fallback).
    Returns (top, left, crop_h, crop_w)."""
    area = h * w
    log_ratio = np.log(np.asarray(ratio, np.float64))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    # fallback: center crop of clamped aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def random_resized_crop(
    rng: np.random.Generator,
    img: np.ndarray,
    size: int,
    scale=(0.8, 1.0),
    ratio=(0.9, 1.1),
) -> np.ndarray:
    """torchvision RandomResizedCrop."""
    c, h, w = img.shape
    top, left, ch, cw = sample_rrc_params(rng, h, w, scale, ratio)
    return _bilinear_resize(img[:, top : top + ch, left : left + cw], size, size)


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


_CIFAR_CHANNEL_MAP = {"red": 0, "green": 1, "blue": 2}


def get_channel(dataset: str, data_channels, x: np.ndarray) -> np.ndarray:
    """Synthetic-channel expansion (``dataset_utils.py:316-360``): cifar10/100
    recompose (B, 3, H, W) RGB batches into a channel list; the microscopy
    datasets pass through."""
    if dataset in ("cifar10", "cifar100"):
        return _get_channel_cifar(data_channels, x)
    if dataset in ("Allen", "CP", "HPA", "morphem70k"):
        return x
    raise NotImplementedError(f"get_channel: dataset {dataset!r}")


def _get_channel_cifar(data_channels, x: np.ndarray) -> np.ndarray:
    """x: (B, 3, H, W) RGB. Each entry of ``data_channels`` is "red" /
    "green" / "blue", "avg_<c1>_<c2>..." (channel mean), or "zero"
    (``dataset_utils.py:325-360``)."""
    assert len(data_channels) <= 3
    if sorted(data_channels) == sorted(_CIFAR_CHANNEL_MAP):
        return x
    b, c, h, w = x.shape
    out = []
    for channel in data_channels:
        if channel in _CIFAR_CHANNEL_MAP:
            ci = _CIFAR_CHANNEL_MAP[channel]
            out.append(x[:, ci : ci + 1])
            continue
        splits = channel.split("_")
        reduce, channel_list = splits[0].lower(), splits[1:]
        if reduce == "avg":
            idx = [_CIFAR_CHANNEL_MAP[cn] for cn in channel_list]
            out.append(x[:, idx].mean(axis=1, keepdims=True))
        elif reduce == "zero":
            out.append(np.zeros((b, 1, h, w), x.dtype))
        else:
            raise ValueError(f"unknown channel spec {channel!r}")
    return np.concatenate(out, axis=1)


def mask_channels(img: np.ndarray, channel_mask) -> np.ndarray:
    """Zero out relative channel indices (``dataset_utils.py:66-76``)."""
    if not len(channel_mask):
        return img
    img = img.copy()
    img[list(channel_mask)] = 0.0
    return img
