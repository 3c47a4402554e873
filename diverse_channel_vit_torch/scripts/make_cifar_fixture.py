"""Write a small CIFAR-10 tree in the standard python-pickle layout, for
tests and smoke runs that have no CIFAR download.

    python -m diverse_channel_vit_torch.scripts.make_cifar_fixture ROOT [N_PER_BATCH] [N_TEST]

``ROOT/cifar-10-batches-py/`` gets ``data_batch_1`` .. ``data_batch_5``
(``N_PER_BATCH`` images each, 8 by default), ``test_batch`` (``N_TEST``,
16 by default) and ``batches.meta``, as the CIFAR python version lays them
out: ``b"data"`` (N, 3072) uint8 rows in RGB planes, ``b"labels"`` and
``b"label_names"``. Pixels and labels are numpy draws from ``seed``. Then
``-cn cifar10_cfg ++dataset.root_dir=ROOT`` reads it (``data/cifar.py``).
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

LABEL_NAMES = ["airplane", "automobile", "bird", "cat", "deer",
               "dog", "frog", "horse", "ship", "truck"]


def main(root: str, n_per_batch: int = 8, n_test: int = 16, seed: int = 0) -> str:
    """Write the tree under ``root``; returns ``root``."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    files = {f"data_batch_{i}": n_per_batch for i in range(1, 6)}
    files["test_batch"] = n_test
    for name, n in files.items():
        batch = {b"data": rng.integers(0, 256, size=(n, 3 * 32 * 32), dtype=np.uint8),
                 b"labels": [int(v) for v in rng.integers(0, 10, size=n)]}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(batch, f)
    with open(os.path.join(base, "batches.meta"), "wb") as f:
        pickle.dump({b"label_names": [c.encode() for c in LABEL_NAMES]}, f)
    return root


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:4]))
