"""So2Sat LCZ42 city-split dataset (18-channel Sentinel-1/2, 32x32); the
port's own copy of the JAX package's ``data/so2sat.py`` (h5py is imported
when a dataset is built).

Reference: ``datasets/so2sat.py`` — HDF5 files {training, validation,
testing}.h5, sen1 (8ch) + sen2 (10ch) concatenated channel-wise, one-hot
labels collapsed to ints (:46-68); So2Sat augmentation = normalize +
random rot90 + two axis flips (``dataset_utils.py:23-76``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .normalization import get_mean_std_dataset, normalize_chw
from .registry import register_dataset
from .transforms import mask_channels, random_rot90_flips

_SPLIT_FILE = {"train": "training.h5", "valid": "validation.h5", "test": "testing.h5"}


@register_dataset("so2sat_city")
class So2Sat:
    """So2Sat LCZ42 HDF5 dataset: sen1(8ch)+sen2(10ch) -> 18 channels
    (``datasets/so2sat.py`` parity)."""

    def __init__(
        self,
        root_dir: str,
        *,
        split: str,
        channels: Sequence[int],
        is_train: bool,
        channel_mask: Sequence[int] = (),
        in_memory: Optional[bool] = None,
    ):
        import h5py  # lazy: not needed for synthetic-only runs

        if split not in _SPLIT_FILE:
            raise ValueError(f"split must be train/valid/test, got {split!r}")
        self.path = os.path.join(root_dir, _SPLIT_FILE[split])
        self.file = h5py.File(self.path, "r")
        self.channels = np.asarray(list(channels), np.int64)
        self.is_train = is_train
        self.channel_mask = list(channel_mask)
        self.mean, self.std = get_mean_std_dataset("so2sat_city")
        self._labels = None
        self._n = int(self.file["label"].shape[0])
        # 32x32x18 float32 ~ 73KB/example; validation fits in RAM easily but
        # training.h5 (~350k examples, 25GB) streams from disk.
        self.in_memory = bool(in_memory) if in_memory is not None else (self._n <= 50000)
        if self.in_memory:
            self._sen1 = np.asarray(self.file["sen1"])
            self._sen2 = np.asarray(self.file["sen2"])
            self._label = np.asarray(self.file["label"])
        else:
            self._sen1 = self.file["sen1"]
            self._sen2 = self.file["sen2"]
            self._label = self.file["label"]

    def __len__(self) -> int:
        return self._n

    def get_example(self, index: int, rng: Optional[np.random.Generator] = None) -> dict:
        img = np.concatenate(
            [
                np.asarray(self._sen1[index], np.float32),
                np.asarray(self._sen2[index], np.float32),
            ],
            axis=-1,
        ).transpose(2, 0, 1)  # (18, 32, 32)
        img = normalize_chw(img, self.mean, self.std)
        if self.is_train:
            rng = rng or np.random.default_rng()
            img = random_rot90_flips(rng, img)
        img = img[self.channels]
        img = mask_channels(img, self.channel_mask)
        onehot = np.asarray(self._label[index])
        label = int(np.argmax(onehot))
        return {"image": img.astype(np.float32), "label": label}
