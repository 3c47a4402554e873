"""CHAMMI / morphem70k dataset (mixed 3/4/5-channel microscopy chunks); the
port's own copy of the JAX package's ``data/morphem70k.py``.

Reference: ``datasets/morphem70k.py`` — one CSV drives all three chunks
(Allen/WTC-11 3ch, HPA 4ch, CP 5ch); images are stored in "tape" format
``(h, w*c)`` TIFFs unfolded to ``(c, h, w)`` via a Fortran-order reshape
(``_fold_channels`` :163-186); train rows filter on
``train_test_split == "Train"``; per-chunk class dicts (:77-156).

Train pipeline (``dataset_utils.py:233-280``): TPS(p) -> RandomResizedCrop
(0.8-1.0, ratio 0.9-1.1) -> HFlip -> per-chunk Normalize. Eval: Resize ->
CenterCrop -> Normalize.

Tapes are read from the packed blob (``chammi_packed.bin`` with its
``.index.json``, which needs no PIL) when it covers every row, else from the
TIFFs through PIL, imported when the first one is read. A TPS-free train
view of a uint8 / uint16 tape runs the native fused op
(``native/chammi_preproc.cc``), whose build raises when it fails; the numpy
pipeline :func:`plain_train_view` is its plain version. The SSL two-view
train examples come with ``train.ssl``, which the Trainer refuses.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .normalization import get_mean_std_dataset, normalize_chw
from .registry import register_dataset
from .tps import tps_warp_chw
from .transforms import (_bilinear_resize, center_crop, hflip, random_resized_crop, resize,
                         sample_rrc_params)

TRAIN_CLASS_DICTS = {
    "Allen": {"M0": 0, "M1M2": 1, "M3": 2, "M4M5": 3, "M6M7_complete": 4, "M6M7_single": 5},
    "HPA": {"golgi apparatus": 0, "microtubules": 1, "mitochondria": 2, "nuclear speckles": 3},
    "CP": {"BRD-A29260609": 0, "BRD-K04185004": 1, "BRD-K21680192": 2, "DMSO": 3},
    "morphem70k": {
        "BRD-A29260609": 0, "BRD-K04185004": 1, "BRD-K21680192": 2, "DMSO": 3,
        "M0": 4, "M1M2": 5, "M3": 6, "M4M5": 7, "M6M7_complete": 8, "M6M7_single": 9,
        "golgi apparatus": 10, "microtubules": 11, "mitochondria": 12, "nuclear speckles": 13,
    },
}


def class_dict(chunks) -> dict:
    """The label vocabulary of a chunk subset (``chunks``, names among
    Allen, HPA and CP): the chunks' own vocabularies concatenated in Allen,
    HPA, CP order. Every chunk's is the global vocabulary's
    ``TRAIN_CLASS_DICTS["morphem70k"]`` in another order."""
    out = {}
    for part in ("Allen", "HPA", "CP"):
        if part in chunks:
            off = len(out)
            out.update({name: off + i for name, i in TRAIN_CLASS_DICTS[part].items()})
    return out


def fold_channels(image: np.ndarray, channel_width: int) -> np.ndarray:
    """Tape (h, w*c) -> (c, h, w) float in [0, 1] (``morphem70k.py:163-186``)."""
    hwc = np.reshape(image, (image.shape[0], channel_width, -1), order="F")
    chw = np.transpose(hwc, (2, 0, 1)).astype(np.float32)
    if image.dtype == np.uint8:
        chw /= 255.0
    elif image.dtype == np.uint16:
        chw /= 65535.0
    return chw


def plain_train_view(rng, tape: np.ndarray, channel_width: int, crop: tuple, img_size: int,
                     mean, std) -> np.ndarray:
    """The native op's plain version in the train view: fold, crop, resize,
    then the flip draw and the normalisation (the JAX package's numpy
    path)."""
    chw = fold_channels(tape, channel_width)
    top, left, ch_, cw = crop
    out = _bilinear_resize(chw[:, top : top + ch_, left : left + cw], img_size, img_size)
    return normalize_chw(hflip(out) if rng.random() < 0.5 else out, mean, std)


PACKED_BIN = "chammi_packed.bin"


def _read_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def _open_pack(root_dir: str, file_paths) -> "tuple | None":
    """(memmap, index) when a packed blob (scripts/pack_chammi.py) exists
    and covers EVERY requested row, else None."""
    bin_path = os.path.join(root_dir, PACKED_BIN)
    if not (os.path.exists(bin_path) and os.path.exists(bin_path + ".index.json")):
        return None
    import json

    with open(bin_path + ".index.json") as f:
        index = json.load(f)
    if any(p not in index for p in file_paths):
        return None
    return np.memmap(bin_path, dtype=np.uint8, mode="r"), index


@register_dataset("morphem70k")
class SingleCellDataset:
    """One CHAMMI chunk (or a '_'-joined combination)."""

    def __init__(
        self,
        root_dir: str,
        *,
        file_name: str,
        chunk_name: str,
        is_train: bool,
        img_size: int = 224,
        target_labels: str = "label",
        tps_prob: float = 0.0,
        train_classes_dict: Optional[dict] = None,
    ):
        import pandas as pd

        self.chunk = chunk_name
        self.is_train = is_train
        self.img_size = img_size
        self.tps_prob = tps_prob
        self.root_dir = root_dir

        meta = pd.read_csv(os.path.join(root_dir, file_name))
        if chunk_name in ("Allen", "HPA", "CP"):
            meta = meta[meta["chunk"] == chunk_name]
        elif chunk_name not in ("morphem70k", "Allen_HPA_CP"):
            parts = chunk_name.split("_")
            meta = meta[meta["chunk"].isin(parts)]
        if is_train:
            meta = meta[meta["train_test_split"] == "Train"]
        meta = meta.reset_index(drop=True)
        self.file_paths = list(meta["file_path"])
        self.channel_widths = list(meta["channel_width"])
        self.chunks_col = list(meta["chunk"]) if "chunk" in meta else [chunk_name] * len(meta)
        self.raw_labels = list(meta[target_labels]) if target_labels in meta else [None] * len(meta)

        if train_classes_dict is not None:
            self.train_classes_dict = train_classes_dict
        elif chunk_name in TRAIN_CLASS_DICTS:
            self.train_classes_dict = TRAIN_CLASS_DICTS[chunk_name]
        else:  # '_'-joined combination
            self.train_classes_dict = class_dict(chunk_name.split("_"))

        self.mean_stds = get_mean_std_dataset("morphem70k")
        self._pack = _open_pack(root_dir, self.file_paths)

    def _read(self, index: int) -> np.ndarray:
        if self._pack is not None:
            buf, idx = self._pack
            off, h, w, dt = idx[self.file_paths[index]]
            n = h * w * np.dtype(dt).itemsize
            return buf[off:off + n].view(dt).reshape(h, w)
        return _read_image(os.path.join(self.root_dir, self.file_paths[index]))

    def __len__(self) -> int:
        return len(self.file_paths)

    def _train_view(self, rng, tape, channel_width, mean, std) -> np.ndarray:
        """One augmented train view: the draws and their order are the JAX
        package's. TPS-free views of uint8 / uint16 tapes take the native
        fused unfold+RRC+normalize (exact RRC semantics, one pass over the
        tape); TPS views and other dtypes the numpy pipeline."""
        tps_fire = self.tps_prob > 0 and rng.random() <= self.tps_prob
        w = int(channel_width)
        if not tps_fire:
            crop = sample_rrc_params(rng, tape.shape[0], w, scale=(0.8, 1.0), ratio=(0.9, 1.1))
            if tape.dtype in (np.uint8, np.uint16):
                from ..native import fold_crop_resize_normalize

                out = fold_crop_resize_normalize(tape, w, crop, self.img_size, mean, std)
                return hflip(out) if rng.random() < 0.5 else out
            return plain_train_view(rng, tape, w, crop, self.img_size, mean, std)
        chw = tps_warp_chw(rng, fold_channels(tape, w))
        out = random_resized_crop(rng, chw, self.img_size, scale=(0.8, 1.0), ratio=(0.9, 1.1))
        if rng.random() < 0.5:
            out = hflip(out)
        return normalize_chw(out, mean, std)

    def get_example(self, index: int, rng: Optional[np.random.Generator] = None) -> dict:
        img = self._read(index)
        chunk = self.chunks_col[index]
        mean, std = self.mean_stds[chunk]
        cw = self.channel_widths[index]
        if self.is_train:
            out = self._train_view(rng or np.random.default_rng(), img, cw, mean, std)
        else:
            chw = fold_channels(img, int(cw))
            out = normalize_chw(center_crop(resize(chw, self.img_size), self.img_size), mean, std)
        label = self.raw_labels[index]
        label = self.train_classes_dict.get(label, -1) if label is not None else -1
        return {"image": out.astype(np.float32), "label": int(label)}
