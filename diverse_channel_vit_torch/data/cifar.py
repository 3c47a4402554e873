"""CIFAR-10/100 from local pickle files (the port's own copy of the JAX
package's ``data/cifar.py``; the reference's ``dataset_utils.py:316-390``
and ``:412-440``).

The channel-split CIFAR experiments: each chunk sees a recomposition of the
RGB image ("red", "avg_red_green", "zero", ...,
:func:`..data.transforms.get_channel`). Where the reference fetches the
data with torchvision, this loader reads local files only: the standard CIFAR
python pickles from ``dataset.root_dir`` (``cifar-10-batches-py/`` or
``cifar-100-python/``) and the reference's per-chunk index splits from
``<root_dir>/split/{dataset}_{train|test}.json`` (key ``{chunk}_idx``)
when that file exists, the whole split otherwise (the reference tree ships
no split files). An example is normalised with the dataset's statistics,
flipped left-right with probability 0.5 in training, then recomposed to the
chunk's channels, so a loader's batches have one shape per chunk.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

from .normalization import MEAN_STD
from .registry import register_dataset
from .transforms import get_channel

CIFAR10_CLASSES = [
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
]


def _load_pickles(root_dir: str, name: str, train: bool):
    """Standard CIFAR python-pickle layout -> (N, 3, 32, 32) uint8 + labels."""
    if name == "cifar10":
        base = os.path.join(root_dir, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        label_key = b"labels"
    else:
        base = os.path.join(root_dir, "cifar-100-python")
        files = ["train"] if train else ["test"]
        label_key = b"fine_labels"
    imgs, labels = [], []
    for f in files:
        with open(os.path.join(base, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        imgs.append(np.asarray(d[b"data"], np.uint8))
        labels.extend(d[label_key])
    data = np.concatenate(imgs).reshape(-1, 3, 32, 32)
    return data, np.asarray(labels, np.int64)


def load_cifar_classes(root_dir: str, name: str) -> List[str]:
    """Class-name vocabulary (torchvision ``.classes`` role)."""
    try:
        if name == "cifar10":
            with open(os.path.join(root_dir, "cifar-10-batches-py", "batches.meta"), "rb") as f:
                return [c.decode() for c in pickle.load(f, encoding="bytes")[b"label_names"]]
        with open(os.path.join(root_dir, "cifar-100-python", "meta"), "rb") as f:
            return [c.decode() for c in pickle.load(f, encoding="bytes")[b"fine_label_names"]]
    except (OSError, KeyError):
        return CIFAR10_CLASSES if name == "cifar10" else [str(i) for i in range(100)]


class _CifarBase:
    """One split of one chunk: normalized RGB recomposed to the chunk's
    channel list. ``get_example`` matches the BatchLoader protocol."""

    name = "cifar10"

    def __init__(
        self,
        root_dir: str,
        *,
        chunk_name: str = "train",
        data_channels: Optional[Sequence[str]] = None,
        split: str = "train",
        is_train: bool = True,
        img_size: int = 32,
        seed: int = 0,
    ):
        del img_size, seed  # cifar is always 32x32; splits are file-defined
        self.is_train = is_train
        data, labels = _load_pickles(root_dir, self.name, train=is_train)
        # per-chunk index subsets: honor the reference's split-json protocol
        # (dataset_utils.py:369-378) when the file exists
        split_file = os.path.join(
            root_dir, "split", f"{self.name}_{'train' if is_train else 'test'}.json"
        )
        if os.path.isfile(split_file):
            with open(split_file) as f:
                idx = json.load(f).get(f"{chunk_name}_idx")
            if idx is not None:
                data, labels = data[np.asarray(idx)], labels[np.asarray(idx)]
        self.data, self.labels = data, labels
        self.data_channels = list(data_channels or ["red", "green", "blue"])
        mean, std = MEAN_STD[self.name]
        self.mean = np.asarray(mean, np.float32)[:, None, None]
        self.std = np.asarray(std, np.float32)[:, None, None]

    def __len__(self) -> int:
        return len(self.labels)

    def get_example(self, index: int, rng=None) -> dict:
        img = self.data[index].astype(np.float32) / 255.0
        if self.is_train and rng is not None and rng.random() < 0.5:
            img = img[:, :, ::-1].copy()  # RandomHorizontalFlip(0.5)
        img = (img - self.mean) / self.std
        # chunk channel recomposition (dataset_utils.py:325-360) — the
        # reference applies it per train batch in the Trainer; applying it
        # per example keeps the loader output shape static per chunk
        img = get_channel(self.name, self.data_channels, img[None])[0]
        return {"image": img, "label": int(self.labels[index])}


@register_dataset("cifar10")
class Cifar10Dataset(_CifarBase):
    name = "cifar10"


@register_dataset("cifar100")
class Cifar100Dataset(_CifarBase):
    name = "cifar100"
