"""JUMP-CP Cell Painting dataset (8-channel per-cell crops); the port's own
copy of the JAX package's ``data/jump_cp.py``. pandas (with pyarrow for
parquet) is imported when a dataset is built, never with this module.

Reference: ``datasets/jump_cp.py`` — per-cell ``.npy`` CHW crops indexed by a
cyto-mask parquet (``BR00116991.pq``), plate/well/field id maps + well ->
target-label factorization from the platemap/metadata TSV-named parquet files
(:12-50), deterministic 60/20/20 split via a seed-0 permutation (:108-122),
channel subset *or* channel-mask + intensity-rescale compensation (:91-97,
:142-153). Augmentation = ``CellAugmentation``
(``jump_cp_transforms.py:67-165``): random pad-to-256 + crop-224, one-of
flip/rot90, Defocus(1-3), CoarseDropout(10x10x10), normalize.

Static-shape note: the reference returns ``None`` for unlabeled wells and
filters them in ``collate_fn`` (:164-168), yielding ragged batches. Here
unlabeled rows are filtered once at construction — identical data
distribution, fixed batch shapes.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from .normalization import get_mean_std_dataset, normalize_chw
from .registry import register_dataset
from .transforms import coarse_dropout, defocus, flip_rotate_one_of, mask_channels, random_pad_crop

PLATE_TO_ID = {"BR00116991": 0, "BR00116993": 1, "BR00117000": 2}


def load_meta_data(base_path: str):
    """``load_meta_data`` parity (``jump_cp.py:12-50``)."""
    import pandas as pd

    field_to_id = dict(zip([str(i) for i in range(1, 10)], range(9)))
    well_to_id = {}
    for i in range(16):
        for j in range(1, 25):
            well_to_id[f"{chr(ord('A') + i)}{j:02d}"] = len(well_to_id)

    plate_map = {
        "compound": f"{base_path}/JUMP-Target-1_compound_platemap.tsv",
        "crispr": f"{base_path}/JUMP-Target-1_crispr_platemap.tsv",
        "orf": f"{base_path}/JUMP-Target-1_orf_platemap.tsv",
    }
    meta_data = {
        "compound": f"{base_path}/JUMP-Target-1_compound_metadata.tsv",
        "crispr": f"{base_path}/JUMP-Target-1_crispr_metadata.tsv",
        "orf": f"{base_path}/JUMP-Target-1_orf_metadata.tsv",
    }

    def read_any(path):
        # the reference stores parquet under .tsv names (jump_cp.py:36)
        try:
            return pd.read_parquet(path)
        except Exception:
            return pd.read_csv(path, sep="\t")

    well_to_lbl = {}
    for perturbation in plate_map:
        df = read_any(meta_data[perturbation]).merge(
            read_any(plate_map[perturbation]), how="inner", on="broad_sample"
        )
        target_name = "target" if perturbation == "compound" else "gene"
        codes, _ = __import__("pandas").factorize(df[target_name])
        codes = codes + 1  # negative control -> 0
        well_to_lbl[perturbation] = dict(zip(df["well_position"], codes))
    return PLATE_TO_ID, field_to_id, well_to_id, well_to_lbl


def split_indices(n: int, split: str, seed: int = 0) -> np.ndarray:
    """Deterministic 60/20/20 permutation split (``jump_cp.py:108-122``).

    Uses the same legacy ``np.random.seed(0)`` permutation as the reference
    so split membership matches exactly.
    """
    rs = np.random.RandomState(seed)
    perm = rs.permutation(n)
    train_end = int(0.6 * n)
    valid_end = int(0.2 * n) + train_end
    if split == "train":
        return perm[:train_end]
    if split == "valid":
        return perm[train_end:valid_end]
    if split == "test":
        return perm[valid_end:]
    raise ValueError("Unknown split")


S3_PREFIX = "s3://insitro-research-2023-context-vit/"
PACKED_NAME = "jumpcp/packed_crops.npy"


@register_dataset("jump_cp")
class JUMPCP:
    NUM_TOTAL_CHANNELS = 8

    def __init__(
        self,
        root_dir: str,
        *,
        split: str,
        channels: Sequence,
        is_train: bool,
        img_size: int = 224,
        channel_mask: bool = False,
        scale: Optional[float] = 1.0,
        perturbation: str = "compound",
        cyto_mask_paths: Optional[List[str]] = None,
        device_augment: bool = False,
    ):
        import pandas as pd

        self.root_dir = root_dir
        paths = cyto_mask_paths or [os.path.join(root_dir, "jumpcp/BR00116991.pq")]
        df = pd.concat([pd.read_parquet(p) for p in paths], ignore_index=True)
        idx = split_indices(len(df.index), split)
        df = df.iloc[idx]

        _, _, _, self.well2lbl = load_meta_data(
            os.path.join(root_dir, "jumpcp/platemap_and_metadata")
        )
        lbl = self.well2lbl[perturbation]
        # pre-filter unlabeled wells (reference filters at collate time)
        keep = df["well_loc"].isin(lbl.keys())
        df = df[keep]
        self.data_path = list(df["path"])
        self.labels = np.asarray([lbl[w] for w in df["well_loc"]], np.int64)

        # packed-crop fast path (scripts/pack_jumpcp.py): one memmapped
        # array + {path -> row} index replaces per-cell .npy file IO.
        # Used only when EVERY row of this split is present in the pack.
        self._packed = None
        packed = os.path.join(root_dir, PACKED_NAME)
        if os.path.exists(packed) and os.path.exists(packed + ".index.json"):
            import json

            with open(packed + ".index.json") as f:
                index = json.load(f)
            rows = [index.get(p) for p in self.data_path]
            if all(r is not None for r in rows):
                self._packed = np.load(packed, mmap_mode="r")
                self._packed_rows = np.asarray(rows, np.int64)

        if len(channels) and isinstance(channels[0], str):
            channels = [int(c) for c in channels[0].split("-")]
        self.channels = np.asarray(list(channels), np.int64)
        if scale is None and channel_mask:
            self.scale = float(self.NUM_TOTAL_CHANNELS) / len(self.channels)
        else:
            self.scale = 1.0 if scale is None else float(scale)
        self.channel_mask = channel_mask
        self.is_train = is_train
        self.img_size = img_size
        self.mean, self.std = get_mean_std_dataset("jump_cp")
        # device_augment: return raw full-channel crops; the train step runs
        # the whole CellAugmentation pipeline on the device (ops/augment.py).
        # Only valid for the plain full-channel train path.
        self.device_augment = bool(
            device_augment and is_train and not channel_mask
            and len(self.channels) == self.NUM_TOTAL_CHANNELS and self.scale == 1.0
        )

    def __len__(self) -> int:
        return len(self.data_path)

    def _load(self, index: int) -> np.ndarray:
        if self._packed is not None:
            return np.asarray(self._packed[self._packed_rows[index]], np.float32)
        path = self.data_path[index].replace(S3_PREFIX, self.root_dir)
        return np.load(path).astype(np.float32)  # (8, H, W)

    def get_example(self, index: int, rng: Optional[np.random.Generator] = None) -> dict:
        img = self._load(index)
        if self.device_augment:
            # raw crop; geometric/photometric augs + normalize happen on device
            return {"image": img[self.channels], "label": int(self.labels[index])}
        if self.is_train:
            rng = rng or np.random.default_rng()
            img = random_pad_crop(rng, img, pad_to=256, crop=self.img_size)
            img = flip_rotate_one_of(rng, img)
            img = defocus(rng, img, (1, 3))
            img = coarse_dropout(rng, img, max_holes=10, hole_h=10, hole_w=10)
        img = normalize_chw(img, self.mean, self.std)
        if self.scale != 1.0:
            img = img * self.scale
        if self.channel_mask:
            unselected = [c for c in range(img.shape[0]) if c not in self.channels]
            img = mask_channels(img, unselected)
        else:
            img = img[self.channels]
        return {"image": img.astype(np.float32), "label": int(self.labels[index])}
