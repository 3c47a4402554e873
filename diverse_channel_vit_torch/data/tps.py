"""Thin-plate-spline warp augmentation (Bookstein principal warps); the
port's own copy of the JAX package's ``data/tps.py``.

Same algorithm as the reference's ``datasets/tps_transform.py:22-190``
(itself derived from DeepSIM): a 3x3 control grid jittered by +-10% of
width (+ pinned corners), the *inverse* warp solved on a coarse grid
``approximate_grid=10`` times smaller, bilinearly upsampled, then the image
resampled with linear interpolation and reflect boundary. Used on CHAMMI
train pipelines with probability ``train.tps_prob``
(``dataset_utils.py:236,262``).

The whole inverse-warp build is vectorized numpy; resampling uses
``scipy.ndimage.map_coordinates`` (host). At CHAMMI resolutions this is a
few ms per image across loader worker threads.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

_SMALL = 1e-100


def _U(r: np.ndarray) -> np.ndarray:
    """TPS radial basis r^2 log r (0 at r=0)."""
    return (r**2) * np.where(r < _SMALL, 0.0, np.log(np.maximum(r, _SMALL)))


def _solve_tps(from_points: np.ndarray, to_points: np.ndarray) -> np.ndarray:
    """Solve for TPS coefficients mapping from_points -> to_points."""
    n = len(from_points)
    xd = np.subtract.outer(from_points[:, 0], from_points[:, 0])
    yd = np.subtract.outer(from_points[:, 1], from_points[:, 1])
    K = _U(np.sqrt(xd**2 + yd**2))
    P = np.ones((n, 3))
    P[:, 1:] = from_points
    L = np.zeros((n + 3, n + 3))
    L[:n, :n] = K
    L[:n, n:] = P
    L[n:, :n] = P.T
    V = np.zeros((n + 3, 2))
    V[:n] = to_points
    return np.linalg.pinv(L) @ V  # (n+3, 2)


def _eval_tps(coeffs: np.ndarray, points: np.ndarray, x: np.ndarray, y: np.ndarray):
    w = coeffs[:-3]  # (n, 2)
    a1, ax, ay = coeffs[-3], coeffs[-2], coeffs[-1]  # each (2,)
    d = _U(np.sqrt((points[:, 0] - x[..., None]) ** 2 + (points[:, 1] - y[..., None]) ** 2))
    out = d @ w  # (..., 2)
    out[..., 0] += a1[0] + ax[0] * x + ay[0] * y
    out[..., 1] += a1[1] + ax[1] * x + ay[1] * y
    return out[..., 0], out[..., 1]


def _make_inverse_warp(from_points, to_points, output_region, approximate_grid=10):
    """Coarse-grid inverse warp + bilinear upsample (``tps_transform.py:49-85``)."""
    x_min, y_min, x_max, y_max = output_region
    x_steps = (x_max - x_min) / approximate_grid
    y_steps = (y_max - y_min) / approximate_grid
    x, y = np.mgrid[x_min : x_max : x_steps * 1j, y_min : y_max : y_steps * 1j]

    coeffs = _solve_tps(np.asarray(to_points, float), np.asarray(from_points, float))
    tx, ty = _eval_tps(coeffs, np.asarray(to_points, float), x, y)

    new_x, new_y = np.mgrid[x_min : x_max + 1, y_min : y_max + 1]
    x_fracs, x_idx = np.modf((x_steps - 1) * (new_x - x_min) / float(x_max - x_min))
    y_fracs, y_idx = np.modf((y_steps - 1) * (new_y - y_min) / float(y_max - y_min))
    x_idx = x_idx.astype(int)
    y_idx = y_idx.astype(int)
    ix1 = (x_idx + 1).clip(0, int(x_steps) - 1)
    iy1 = (y_idx + 1).clip(0, int(y_steps) - 1)
    x1, y1 = 1 - x_fracs, 1 - y_fracs

    def upsample(t):
        return (
            t[x_idx, y_idx] * x1 * y1
            + t[x_idx, iy1] * x1 * y_fracs
            + t[ix1, y_idx] * x_fracs * y1
            + t[ix1, iy1] * x_fracs * y_fracs
        )

    return upsample(tx), upsample(ty)


def tps_warp_chw(
    rng: np.random.Generator,
    img: np.ndarray,
    points_per_dim: int = 3,
    scale: float = 0.1,
    approximate_grid: int = 10,
) -> np.ndarray:
    """Warp a (C, H, W) image with a random TPS field
    (``tps_transform.py:165-193``: 3x3 grid, jitter 0.1*width, corners pinned)."""
    c, h, w = img.shape
    rows = np.linspace(0, h, points_per_dim)
    cols = np.linspace(0, w, points_per_dim)
    rr, cc = np.meshgrid(rows, cols)
    src = np.dstack([cc.flat, rr.flat])[0]
    dst = src + rng.uniform(-scale * h, scale * h, src.shape)
    corners = np.array([[0, 0], [0, h], [w, 0], [w, h]], float)
    src = np.concatenate([src, corners])
    dst = np.concatenate([dst, corners])

    warp_x, warp_y = _make_inverse_warp(src, dst, (0, 0, h - 1, w - 1), approximate_grid)
    coords = np.stack([warp_x, warp_y])
    out = np.stack(
        [ndimage.map_coordinates(ch, coords, order=1, mode="reflect") for ch in img]
    )
    return out.astype(img.dtype)


class TPSTransform:
    """Apply TPS with probability p (``tps_transform.py:196-233``)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
        if rng.random() > self.p:
            return img
        return tps_warp_chw(rng, img)
