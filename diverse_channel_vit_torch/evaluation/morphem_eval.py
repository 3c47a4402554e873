"""The Trainer's CHAMMI / MorphEm evaluation (counterpart of the JAX
package's ``evaluation/morphem_eval.py``, ``Trainer.eval_morphem70k`` of the
reference, ``trainer.py:560-736``): forward every test chunk -> per-chunk
``features.npy`` -> ``run_benchmark`` per (classifier x knn_metric) -> the
CHAMMI score -> clean-up.

A run trained on a ``train.training_chunks`` subset is evaluated once per
strategy (``new_channel_init``): each chunk's channels that training never
saw get the strategy's synthesized embeddings (``Trainer._synthesis_override``,
``ops/novel_channels.py``), passed to the forward as its override.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Dict

import numpy as np
import torch

from .benchmark import chammi_score, run_benchmark


def extract_features(trainer, chunk: str, loader, new_channel_init=None) -> np.ndarray:
    """The backbone's features (the model output: CHAMMI models have no
    head) of every valid row of the chunk's test loader, in the loader's
    order, as float32; the pad rows of a ``pad_last`` batch are dropped
    before the forward. ``debug`` stops after 3 batches. With
    ``new_channel_init`` the chunk's channel embeddings are that strategy's
    (JAX ``evaluation/morphem_eval.py:21-43``); a dynamic strategy on a chunk
    with novel channels raises there, as in JAX: CHAMMI has no per-batch
    synthesis."""
    cids = torch.tensor(trainer._chunk_channel_ids(chunk), device=trainer.device)
    override = trainer._synthesis_override(chunk, new_channel_init)
    bound = trainer.bound_chunk(chunk)  # a ConvNeXt model's per-chunk stem
    chunk_kw = {} if bound is None else {"chunk": bound}
    feats = []
    max_batches = 3 if trainer.debug else math.inf
    for i, batch in enumerate(loader):
        if i >= max_batches:
            break
        valid = batch.get("valid")
        img = batch["image"]
        if valid is not None and not valid.all():
            img = img[np.asarray(valid)]
        x = torch.from_numpy(np.ascontiguousarray(img)).to(trainer.device)
        feats.append(trainer._eval_step(x, cids, override, **chunk_kw).float().cpu().numpy())
    return np.concatenate(feats, axis=0)


def eval_morphem70k(trainer, epoch: int, new_channel_init=None) -> Dict[str, float]:
    """Full CHAMMI eval: per-chunk feature dump -> MorphEm Tasks 1-4 -> the
    CHAMMI score (``trainer.py:560-736`` parity), the features under the
    strategy ``new_channel_init``. ``accuracy`` is the cosine-kNN CHAMMI
    score."""
    cfg = trainer.cfg
    folder = f"epoch{epoch}_seed{trainer.seed}"
    feature_dir = cfg.eval.feature_dir.replace("{FOLDER_NAME}", folder)
    dest_dir = cfg.eval.dest_dir.replace("{FOLDER_NAME}", folder)
    root_dir = cfg.eval.root_dir or cfg.dataset.root_dir

    for chunk, loader in trainer.test_loaders.items():
        ld = loader if not isinstance(loader, dict) else list(loader.values())[0]
        feats = extract_features(trainer, chunk, ld, new_channel_init)
        out_dir = os.path.join(feature_dir, chunk)
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, cfg.eval.feature_file), feats)

    results: Dict[str, float] = {}
    classifiers = list(cfg.eval.get("classifiers", ["knn"]))
    knn_metrics = list(cfg.eval.get("knn_metrics", ["cosine"]))
    for classifier in classifiers:
        metrics = knn_metrics if classifier == "knn" else [""]
        for km in metrics:
            df = run_benchmark(
                root_dir=root_dir,
                dest_dir=dest_dir,
                feature_dir=feature_dir,
                feature_file=cfg.eval.feature_file,
                classifier=classifier,
                umap=bool(cfg.eval.get("umap", False)),
                knn_metric=km or "l2",
                device=trainer.device,
            )
            tag = f"{classifier}_{km}" if classifier == "knn" else classifier
            for _, row in df.iterrows():
                results[f"{tag}/{row.dataset}/{row.task}/f1"] = float(row.f1_score_macro)
                results[f"{tag}/{row.dataset}/{row.task}/acc"] = float(row.accuracy)
            results[f"{tag}/chammi_score"] = chammi_score(df)

    # headline metric: cosine-kNN CHAMMI score (trainer.py:711-731)
    headline = results.get("knn_cosine/chammi_score")
    if headline is not None:
        results["accuracy"] = headline
    if cfg.eval.get("clean_up", True):
        shutil.rmtree(feature_dir, ignore_errors=True)
    return results
