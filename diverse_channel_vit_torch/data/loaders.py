"""Batch loaders: fixed-shape host batches (the port's own copy of the JAX
package's ``data/loaders.py``, single-chunk part).

Replaces the reference's DataLoader orchestration
(``dataset_utils.py:392-783``), as the JAX package does:

- **Static shapes**: every batch of a loader has identical shapes; train
  loaders drop the last partial batch, eval loaders pad it and report the
  valid rows in a ``valid`` mask.
- **Per-host sharding**: the DistributedSampler role
  (``dataset_utils.py:502-598``) is a strided index shard per host
  (``BatchLoader``'s ``num_hosts`` / ``host_id``; one host until ROADMAP
  A10).
- **Deterministic augmentation**: per-example RNG seeded by
  (seed, epoch, index) — reproducible regardless of worker scheduling, and
  equal to the JAX package's batches bit for bit.

- **CHAMMI**: one loader per chunk for eval, and for training the
  mixed-chunk loader (``MixedChunkLoader``, built by
  ``make_random_instance_train_loader``) with fixed per-chunk quotas.

- **CIFAR**: the local pickles (``data/cifar.py``), each chunk's channel
  ids naming recompositions in ``dataset.in_channel_names``.
"""

from __future__ import annotations

import concurrent.futures as cf
import zlib
from functools import partial
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .morphem70k import TRAIN_CLASS_DICTS, class_dict
from .registry import DATASET_REGISTRY


def _stack_examples(examples: List[dict]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key in examples[0]:
        vals = [e[key] for e in examples]
        if np.isscalar(vals[0]) or getattr(vals[0], "ndim", 1) == 0:
            out[key] = np.asarray(vals)
        else:
            out[key] = np.stack(vals, axis=0)
    return out


# --------------------------------------------------------------------------
# process-pool workers (true parallelism for GIL-bound numpy augmentation:
# TPS warps, host-side JUMP-CP pipelines). The per-example RNG is seeded by
# (seed, epoch, index), so results are bit-identical to the serial/thread
# paths regardless of worker scheduling. Workers are SPAWNED (never forked:
# the parent may hold an initialised CUDA context); they only build the
# dataset, so
# CUDA is never initialised in them.
# --------------------------------------------------------------------------

_WORKER_DATASET = None
_WORKER_SHM: Dict[str, object] = {}


def _worker_init(factory):
    global _WORKER_DATASET
    _WORKER_DATASET = factory()


def _attach_shm(name: str):
    shm = _WORKER_SHM.get(name)
    if shm is None:
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name)
        try:  # only the CREATOR (the loader) owns the segment's lifetime;
            # stop this worker's resource tracker from unlinking it at exit
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        _WORKER_SHM[name] = shm
    return shm


def _worker_fetch_shm(args) -> dict:
    """Compute one example and write its array fields straight into the
    loader's shared-memory arena — only scalar fields ride the result pipe.
    (Returning 1 MB images through pickle+pipe made process workers
    SLOWER than serial; measured in PERFORMANCE.md.)"""
    seed, epoch, i, shm_name, slot, layout = args
    rng = np.random.default_rng((seed, epoch, int(i)))
    ex = _WORKER_DATASET.get_example(int(i), rng=rng)
    buf = _attach_shm(shm_name).buf
    small = {}
    for key, val in ex.items():
        if key in layout:
            offset, shape, dtype = layout[key]
            item = int(np.prod(shape)) * np.dtype(dtype).itemsize
            out = np.ndarray(shape, dtype, buffer=buf, offset=offset + slot * item)
            out[...] = val
        else:
            small[key] = val
    return small


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Background-thread batch prefetch.

    The step runs asynchronously on the card; prefetching the *next* batch
    while the current step executes keeps the card fed (the role DataLoader
    worker processes played for the reference). ``iterator`` may move each
    batch to the card itself (the Trainer's ``_to_device``), so the copy
    happens in this thread too. An exception in the thread is raised to the
    consumer (the JAX version ends the epoch early instead), and a consumer
    that stops early (debug mode) stops the thread.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for item in iterator:
                if not put(item):
                    return
        except Exception as e:  # handed to the consumer, raised there
            put((end, e))
            return
        put((end, None))

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is end:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()


class BatchLoader:
    """Iterates fixed-shape batches over one dataset.

    dataset must expose ``__len__`` and ``get_example(index, rng=None)``.
    """

    def __init__(
        self,
        dataset,
        *,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        drop_last: bool = False,
        pad_last: bool = False,
        num_hosts: int = 1,
        host_id: int = 0,
        num_workers: int = 0,
        worker_processes: bool = False,
        dataset_factory=None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.num_workers = num_workers
        self._epoch = 0
        self._pool = self._procpool = None
        self._shm = None
        self._shm_layout = None
        if worker_processes and num_workers > 0 and dataset_factory is not None:
            import multiprocessing as mp

            self._procpool = cf.ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_worker_init,
                initargs=(dataset_factory,),
            )
        elif num_workers > 0:
            self._pool = cf.ThreadPoolExecutor(max_workers=num_workers)

    def close(self):
        if self._procpool is not None:
            self._procpool.shutdown(wait=False, cancel_futures=True)
            self._procpool = None
        if self._shm is not None:
            try:
                self._shm.close()
                self._shm.unlink()
            except Exception:
                pass
            self._shm = None

    def __del__(self):  # best-effort arena cleanup
        try:
            self.close()
        except Exception:
            pass

    def _ensure_arena(self):
        """Allocate the shared-memory arena from one probe example's field
        shapes (batches are fixed-shape by loader contract)."""
        if self._shm is not None:
            return
        probe = self.dataset.get_example(0, rng=np.random.default_rng(0))
        layout, offset = {}, 0
        for k, v in probe.items():
            a = np.asarray(v)
            if a.ndim >= 1:
                layout[k] = (offset, tuple(a.shape), str(a.dtype))
                offset += self.batch_size * a.nbytes
                offset = (offset + 63) & ~63
        from multiprocessing import shared_memory

        self._shm = shared_memory.SharedMemory(create=True, size=max(offset, 1))
        self._shm_layout = layout

    def set_epoch(self, epoch: int):
        """DistributedSampler.set_epoch parity (``trainer.py:769-770``)."""
        self._epoch = int(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        return idx[self.host_id :: self.num_hosts]

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _fetch_stacked(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        if self._procpool is not None:
            self._ensure_arena()
            args = [
                (self.seed, self._epoch, int(i), self._shm.name, slot, self._shm_layout)
                for slot, i in enumerate(indices)
            ]
            chunk = max(1, len(args) // (self.num_workers * 4))
            smalls = list(self._procpool.map(_worker_fetch_shm, args, chunksize=chunk))
            batch = _stack_examples(smalls) if smalls and smalls[0] else {}
            n = len(indices)
            for k, (offset, shape, dtype) in self._shm_layout.items():
                view = np.ndarray((n,) + shape, dtype, buffer=self._shm.buf,
                                  offset=offset)
                batch[k] = view.copy()  # one memcpy; arena reused next batch
            return batch
        return _stack_examples(self._fetch(indices))

    def _fetch(self, indices: Sequence[int]) -> List[dict]:
        def one(i):
            rng = np.random.default_rng((self.seed, self._epoch, int(i)))
            return self.dataset.get_example(int(i), rng=rng)

        if self._pool is not None:
            return list(self._pool.map(one, indices))
        return [one(i) for i in indices]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_batches(0)

    def iter_batches(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate this epoch's batches from batch index ``start``.

        The skipped prefix is never fetched — batch order is a pure function
        of (seed, epoch), so resuming a preempted epoch at its interruption
        point (trainer ``train.auto_resume``) costs nothing."""
        idx = self._indices()
        bs = self.batch_size
        n_full = len(idx) // bs
        for b in range(start, n_full):
            batch = self._fetch_stacked(idx[b * bs : (b + 1) * bs])
            batch["valid"] = np.ones((bs,), np.bool_)
            yield batch
        rem = idx[n_full * bs :]
        if len(rem) and not self.drop_last and start <= n_full:
            batch = self._fetch_stacked(rem)
            valid = np.ones((len(rem),), np.bool_)
            if self.pad_last:
                pad = bs - len(rem)
                batch = {
                    k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
                    for k, v in batch.items()
                }
                valid = np.concatenate([valid, np.zeros((pad,), np.bool_)])
            batch["valid"] = valid
            yield batch
        if not self.shuffle:
            return
        self._epoch += 1  # auto-advance for plain `for batch in loader` use


class MixedChunkLoader:
    """CHAMMI mixed-chunk train loader with fixed per-chunk quotas.

    Yields ``{chunk_name: {"image": (b_c, C_c, H, W), "label": (b_c,),
    "valid": (b_c,)}}`` in the order of ``datasets``, where ``b_c =
    round(batch_size * len_c / total)`` is constant across batches (the
    largest quota takes the rounding drift, so the quotas sum to
    ``batch_size``) — the static-shape analogue of
    ``make_random_instance_train_loader`` + ``get_collate``
    (``dataset_utils.py:719-783``).
    """

    def __init__(
        self,
        datasets: Dict[str, object],
        *,
        batch_size: int,
        seed: int = 0,
        num_workers: int = 0,
        worker_processes: bool = False,
        dataset_factories: Optional[Dict[str, object]] = None,
    ):
        self.datasets = datasets
        self.batch_size = int(batch_size)
        self.seed = seed
        self._epoch = 0
        lens = {k: len(d) for k, d in datasets.items()}
        total = sum(lens.values())
        quotas = {k: max(1, int(round(self.batch_size * n / total))) for k, n in lens.items()}
        drift = self.batch_size - sum(quotas.values())
        largest = max(quotas, key=lambda k: quotas[k])
        quotas[largest] += drift
        self.quotas = quotas
        # a per-chunk seed from crc32: Python's str hash changes per process
        self.loaders = {
            k: BatchLoader(
                d,
                batch_size=quotas[k],
                shuffle=True,
                seed=seed + zlib.crc32(k.encode()) % 10000,
                drop_last=True,
                num_workers=num_workers,
                worker_processes=worker_processes,
                dataset_factory=(dataset_factories or {}).get(k),
            )
            for k, d in datasets.items()
        }

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)
        for ld in self.loaders.values():
            ld.set_epoch(epoch)

    def close(self):
        for ld in self.loaders.values():
            ld.close()

    def __len__(self) -> int:
        return min(len(ld) for ld in self.loaders.values())

    def __iter__(self):
        return self.iter_batches(0)

    def iter_batches(self, start: int = 0):
        """Iterate from batch index ``start``; every chunk's loader skips the
        same prefix, so the chunks' batches pair up as in a whole epoch."""
        iters = {k: ld.iter_batches(start) for k, ld in self.loaders.items()}
        for _ in range(start, len(self)):
            yield {k: next(it) for k, it in iters.items()}
        self._epoch += 1
        for ld in self.loaders.values():
            ld.set_epoch(self._epoch)


# ---------------------------------------------------------------------------
# class vocabularies (``dataset_utils.py:606-646``)
# ---------------------------------------------------------------------------

ALLEN_V2 = list(TRAIN_CLASS_DICTS["Allen"])
ALLEN_V1 = ["Interphase", "Mitotic"]
HPA_CLASSES = list(TRAIN_CLASS_DICTS["HPA"])
CP_CLASSES = list(TRAIN_CLASS_DICTS["CP"])


def get_classes(dataset: str, file_name: str = "", training_chunks: Optional[List[str]] = None,
                root_dir: str = ""):
    if dataset in ("cifar10", "cifar100"):
        from .cifar import load_cifar_classes

        classes = load_cifar_classes(root_dir, dataset)
        return classes, classes
    if dataset in ("Allen", "CP", "HPA", "morphem70k"):
        allen = ALLEN_V2 if "morphem70k_v2" in (file_name or "") else ALLEN_V1
        if dataset == "Allen":
            return allen, None
        if dataset == "HPA":
            return HPA_CLASSES, None
        if dataset == "CP":
            return CP_CLASSES, None
        if training_chunks is None:
            return allen + HPA_CLASSES + CP_CLASSES, None
        out = []
        if "Allen" in training_chunks:
            out += allen
        if "HPA" in training_chunks:
            out += HPA_CLASSES
        if "CP" in training_chunks:
            out += CP_CLASSES
        return out, None
    if dataset == "so2sat_city":
        return list(range(17)), list(range(17))
    if dataset == "jump_cp":
        return list(range(161)), list(range(161))
    if dataset == "synthetic":
        return None, None  # taken from cfg.dataset.num_classes
    raise ValueError(f"dataset {dataset} not valid!")


# ---------------------------------------------------------------------------
# loader orchestration (``get_train_val_test_loaders``, dataset_utils.py:392)
# ---------------------------------------------------------------------------


def _build_split(name: str, cfg_dataset, chunk_channels, split: str, is_train: bool, seed: int,
                 **chammi):
    """One split's dataset; ``chammi``: CHAMMI's train-side keywords
    (``tps_prob``, ``train_classes_dict``)."""
    cls = DATASET_REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"dataset {name!r} not registered; have {sorted(DATASET_REGISTRY)}")
    if name == "synthetic":
        return cls(
            split="train" if is_train else ("valid" if split == "valid" else "test"),
            num_samples=cfg_dataset.get("num_train_samples", 512)
            if is_train
            else cfg_dataset.get("num_eval_samples", 128),
            num_classes=cfg_dataset.get("num_classes", 10),
            num_channels=len(cfg_dataset.in_channel_names),
            img_size=cfg_dataset.get("img_size", 32),
            seed=seed,
            difficulty=cfg_dataset.get("difficulty", "easy"),
            patch=cfg_dataset.get("hard_patch", 16),
            alpha=cfg_dataset.get("hard_alpha", 0.45),
            beta=cfg_dataset.get("hard_beta", 0.75),
            distractors=cfg_dataset.get("hard_distractors", 2),
        )
    if name == "so2sat_city":
        h5_split = "train" if split == "train" else ("valid" if split == "valid" else "test")
        return cls(
            cfg_dataset.root_dir,
            split=h5_split,
            channels=chunk_channels,
            is_train=is_train,
        )
    if name == "jump_cp":
        return cls(
            cfg_dataset.root_dir,
            split=split if split in ("train", "valid") else "test",
            channels=chunk_channels,
            is_train=is_train,
            img_size=cfg_dataset.get("img_size", 224),
            device_augment=bool(getattr(cfg_dataset, "_device_augment", False)),
        )
    if name in ("morphem70k", "Allen", "HPA", "CP"):
        return cls(
            cfg_dataset.root_dir,
            file_name=cfg_dataset.file_name,
            chunk_name=chunk_channels,  # chunk name string for CHAMMI
            is_train=is_train,
            img_size=cfg_dataset.get("img_size", 224),
            **chammi,
        )
    if name in ("cifar10", "cifar100"):
        # chunk values are channel ids into in_channel_names, which may name
        # recompositions ("red", "avg_red_green", "zero", ...)
        names = list(cfg_dataset.in_channel_names)
        return cls(
            cfg_dataset.root_dir,
            chunk_name=getattr(cfg_dataset, "_chunk_name", "train"),
            data_channels=[names[int(i)] for i in chunk_channels],
            split=split,
            is_train=is_train,
            seed=seed,
        )
    raise ValueError(f"dataset {name} not valid!")


def get_train_val_test_loaders(
    cfg,
    chunk_name: str,
    seed: int,
    *,
    with_train: bool = True,
) -> Tuple[Optional[BatchLoader], Optional[BatchLoader], object]:
    """Build (train, val, test) loaders for one chunk.

    ``test`` is a dict of loaders when the chunk declares several test
    channel subsets (so2sat test_1/test_2/test_full — the channel-robustness
    splits the reference evaluates in ``eval_regular``). A CHAMMI chunk's
    datasets take the chunk's name. ``with_train=False`` builds no train loader (CHAMMI trains on the
    mixed-chunk loader) and returns None in its place.
    """
    name = cfg.dataset.name
    # annotate the dataset cfg with what the dataset ctors need: the train
    # side's flag, and the chunk that prefixes CIFAR's split-json keys
    cfg.dataset._device_augment = bool(cfg.train.get("device_augment", False))
    cfg.dataset._chunk_name = chunk_name
    bs = cfg.train.batch_size
    eval_bs = cfg.eval.get("batch_size") or bs
    nw = cfg.hardware.get("num_workers", 0) or 0
    worker_procs = bool(cfg.hardware.get("worker_processes", False))

    chunk_map = None
    for entry in cfg.data_chunk.chunks:
        entry = entry if isinstance(entry, dict) else entry.to_dict()
        if chunk_name in entry:
            chunk_map = entry[chunk_name]
            break
    if chunk_map is None:
        raise KeyError(f"chunk {chunk_name!r} not in data_chunk config")

    is_channel_map = isinstance(chunk_map, dict) or hasattr(chunk_map, "keys")

    is_chammi = name in ("morphem70k", "Allen", "HPA", "CP")

    def mk(split, is_train, channels, batch, shuffle, drop_last, pad_last):
        kwargs = dict(name=name, cfg_dataset=cfg.dataset,
                      chunk_channels=chunk_name if is_chammi else channels, split=split,
                      is_train=is_train, seed=seed)
        ds = _build_split(**kwargs)
        # process workers only where they pay: the augmented train path
        factory = partial(_build_split, **kwargs) if (is_train and worker_procs) else None
        return BatchLoader(
            ds,
            batch_size=batch,
            shuffle=shuffle,
            seed=seed + {"train": 24122022, "valid": 21022024, "test": 21022025}.get(split.split("_")[0], 0),
            drop_last=drop_last,
            pad_last=pad_last,
            num_workers=nw,
            worker_processes=is_train and worker_procs,
            dataset_factory=factory,
        )

    train_channels = chunk_map.get("train") if is_channel_map else None
    train_loader = mk("train", True, train_channels, bs, True, True, False) if with_train else None

    val_loader = None
    if is_channel_map and chunk_map.get("valid") is not None:
        val_loader = mk("valid", False, chunk_map["valid"], eval_bs, False, False, True)

    if is_channel_map:
        test_keys = sorted(k for k in chunk_map.keys() if k.startswith("test"))
        tests = {k: mk(k, False, chunk_map[k], eval_bs, False, False, True) for k in test_keys}
        test_loader = tests[test_keys[0]] if len(test_keys) == 1 else tests
    else:
        test_loader = mk("test", False, None, eval_bs, False, False, True)
    return train_loader, val_loader, test_loader


def make_random_instance_train_loader(cfg, seed: int, *, training_chunks=None
                                      ) -> Optional[MixedChunkLoader]:
    """CHAMMI mixed loader (``dataset_utils.py:719-746``) over
    ``training_chunks`` (default: every chunk of ``data_chunk.chunks``), in
    that order; None for other datasets. Labels come from the global
    14-class vocabulary, or under ``training_chunks`` from the chunks'
    vocabularies concatenated in Allen, HPA, CP order: the proxy bank spans
    every training class."""
    if cfg.dataset.name != "morphem70k":
        return None
    chunks = training_chunks or [next(iter(e if isinstance(e, dict) else e.to_dict()))
                                 for e in cfg.data_chunk.chunks]
    global_dict = (TRAIN_CLASS_DICTS["morphem70k"] if training_chunks is None
                   else class_dict(chunks))
    worker_procs = bool(cfg.hardware.get("worker_processes", False))
    datasets, factories = {}, {}
    for chunk_name in chunks:
        kwargs = dict(name="morphem70k", cfg_dataset=cfg.dataset, chunk_channels=chunk_name,
                      split="train", is_train=True, seed=seed,
                      tps_prob=cfg.train.get("tps_prob", 0.0), train_classes_dict=global_dict)
        datasets[chunk_name] = _build_split(**kwargs)
        factories[chunk_name] = partial(_build_split, **kwargs)
    return MixedChunkLoader(
        datasets,
        batch_size=cfg.train.batch_size,
        seed=seed + 2052023,
        num_workers=cfg.hardware.get("num_workers", 0) or 0,
        worker_processes=worker_procs,
        dataset_factories=factories if worker_procs else None,
    )
