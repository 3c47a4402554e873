"""Evaluation (counterpart of the JAX package's ``evaluation/``).

The reference's ``morphem/`` package (the bundled MorphEm CHAMMI
benchmark): ``run_benchmark`` (``morphem/benchmark.py:31``), ``evaluate``
(``morphem/evaluation.py:101``) and the FAISS 1-NN (``morphem/utils.py:8-46``),
the latter an exact float32 matmul + top-k on the card, in query blocks;
and the Trainer's CHAMMI eval (``morphem_eval.py``: per-chunk features, the
benchmark, the CHAMMI score). The bank-sharded kNN waits for multi-GPU
(ROADMAP A10); the standalone feature-extraction CLI and the embedding
figures (``umap``) for ROADMAP A7.
"""

from .benchmark import chammi_score, evaluate, run_benchmark
from .knn import KNeighbors
from .metrics import classification_report_dict, macro_f1

__all__ = [
    "KNeighbors",
    "chammi_score",
    "evaluate",
    "run_benchmark",
    "classification_report_dict",
    "macro_f1",
]
