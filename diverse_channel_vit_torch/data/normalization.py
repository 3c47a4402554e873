"""Per-dataset channel statistics (the port's own copy of the JAX
package's ``data/normalization.py``).

Verbatim the reference's hard-coded training-set mean/std tables
(``datasets/dataset_utils.py:90-202``) — these are *data facts*, not code,
and must match exactly for checkpoint/metric parity.
"""

from __future__ import annotations

import numpy as np

MEAN_STD = {
    "Allen": (
        [0.17299628, 0.21203272, 0.06717163],
        [0.31244728, 0.33736905, 0.15192129],
    ),
    "HPA": (
        [0.08290479, 0.041127298, 0.064044416, 0.08445485],
        [0.16213107, 0.1055938, 0.17713426, 0.1631108],
    ),
    "CP": (
        [0.09957531, 0.19229747, 0.16250895, 0.1824028, 0.14978175],
        [0.1728119, 0.16629605, 0.15171643, 0.14863704, 0.1524553],
    ),
    "so2sat_city": (
        [-3.5912242e-05, -7.658551e-06, 5.937501e-05, 2.516598e-05, 0.044198506,
         0.25761467, 0.0007556685, 0.0013503395, 0.12375654, 0.109277464,
         0.101086065, 0.114239536, 0.15926327, 0.18147452, 0.17457514,
         0.1950194, 0.15428114, 0.109052904],
        [0.17555329, 0.17556609, 0.4599934, 0.45599362, 2.855352, 8.322579,
         2.44937, 1.464371, 0.0395863, 0.047778852, 0.066362865, 0.063593246,
         0.07744504, 0.09099384, 0.09217117, 0.10162713, 0.09989747, 0.0877891],
    ),
    "jump_cp": (
        [4.031743599139058, 1.565935237087539, 3.77367898215863,
         3.4605251427133257, 4.1723172504050225, 6.780529773318951,
         6.787385700135139, 6.778120829362721],
        [17.318438884455695, 12.015918256263747, 16.966058078452495,
         15.064776266287147, 17.964118200870608, 21.638766346725316,
         21.670565699654457, 21.639488585095584],
    ),
    "cifar10": (
        [0.49139968, 0.48215841, 0.44653091],
        [0.24703223, 0.24348513, 0.26158784],
    ),
    "cifar100": (
        [0.50707516, 0.48654887, 0.44091784],
        [0.26733429, 0.25643846, 0.27615047],
    ),
}


def get_mean_std_dataset(dataset: str):
    """``get_mean_std_dataset`` parity (``dataset_utils.py:90-202``)."""
    if dataset == "morphem70k":
        return {k: MEAN_STD[k] for k in ("CP", "Allen", "HPA")}
    if dataset not in MEAN_STD:
        raise ValueError(f"No stats for dataset {dataset!r}")
    return MEAN_STD[dataset]


def normalize_chw(img: np.ndarray, mean, std) -> np.ndarray:
    """(C, H, W) normalize with per-channel stats (float32)."""
    mean = np.asarray(mean, np.float32)[:, None, None]
    std = np.asarray(std, np.float32)[:, None, None]
    return (img.astype(np.float32) - mean) / std
