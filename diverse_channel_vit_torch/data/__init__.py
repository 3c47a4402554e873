"""Data layer of the port (counterpart of the JAX package's ``data/``).

Numpy pipelines feeding fixed-shape host batches, equal to the JAX
package's bit for bit for the same seed: the synthetic, JUMP-CP, So2Sat,
CHAMMI (MorphEm70k, with TPS and the native fused crop) and CIFAR-10/100
(local pickles) datasets, the host transforms, the channel statistics, the
single-chunk loaders and CHAMMI's mixed-chunk loader. The JUMP-CP train augmentation may instead run on the
card (``ops/augment.py``).
"""

from .loaders import (
    BatchLoader,
    MixedChunkLoader,
    get_classes,
    get_train_val_test_loaders,
    make_random_instance_train_loader,
    prefetch,
)
from .normalization import get_mean_std_dataset
from .registry import DATASET_REGISTRY, register_dataset
from . import synthetic  # noqa: F401  (registers "synthetic")
from . import so2sat  # noqa: F401  (registers "so2sat_city")
from . import jump_cp  # noqa: F401  (registers "jump_cp")
from . import morphem70k  # noqa: F401  (registers "morphem70k")
from . import cifar  # noqa: F401  (registers "cifar10", "cifar100")

__all__ = [
    "BatchLoader",
    "MixedChunkLoader",
    "get_classes",
    "get_train_val_test_loaders",
    "make_random_instance_train_loader",
    "prefetch",
    "get_mean_std_dataset",
    "DATASET_REGISTRY",
    "register_dataset",
]
