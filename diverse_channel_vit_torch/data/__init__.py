"""Data layer of the port (counterpart of the JAX package's ``data/``).

Numpy pipelines feeding fixed-shape host batches, equal to the JAX
package's bit for bit for the same seed: the synthetic, JUMP-CP and So2Sat
datasets, the host transforms, the channel statistics and the single-chunk
loaders. The JUMP-CP train augmentation may instead run on the card
(``ops/augment.py``). CHAMMI (MorphEm70k) and CIFAR are not ported
(ROADMAP A6).
"""

from .loaders import BatchLoader, get_classes, get_train_val_test_loaders, prefetch
from .normalization import get_mean_std_dataset
from .registry import DATASET_REGISTRY, register_dataset
from . import synthetic  # noqa: F401  (registers "synthetic")
from . import so2sat  # noqa: F401  (registers "so2sat_city")
from . import jump_cp  # noqa: F401  (registers "jump_cp")

__all__ = [
    "BatchLoader",
    "get_classes",
    "get_train_val_test_loaders",
    "prefetch",
    "get_mean_std_dataset",
    "DATASET_REGISTRY",
    "register_dataset",
]
