"""Classification metrics (numpy, sklearn-parity); the port's own copy of
the JAX package's ``evaluation/metrics.py``.

Re-derivations of ``sklearn.metrics.f1_score(average='macro')`` and
``classification_report(output_dict=True)`` as used by the MorphEm evaluator
(``morphem/evaluation.py:197-206``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _prf(y_true: np.ndarray, y_pred: np.ndarray, label) -> tuple:
    tp = int(np.sum((y_pred == label) & (y_true == label)))
    fp = int(np.sum((y_pred == label) & (y_true != label)))
    fn = int(np.sum((y_pred != label) & (y_true == label)))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    support = int(np.sum(y_true == label))
    return precision, recall, f1, support


def macro_f1(y_true, y_pred, labels: Optional[Sequence] = None) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(y_true) if labels is None else labels
    return float(np.mean([_prf(y_true, y_pred, l)[2] for l in labels]))


def classification_report_dict(
    y_true, y_pred, labels: Sequence, target_names: Sequence[str]
) -> Dict:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    report: Dict = {}
    rows = []
    for label, name in zip(labels, target_names):
        p, r, f1, s = _prf(y_true, y_pred, label)
        report[name] = {"precision": p, "recall": r, "f1-score": f1, "support": s}
        rows.append((p, r, f1, s))
    total = len(y_true)
    report["accuracy"] = float(np.mean(y_true == y_pred))
    supports = np.array([r[3] for r in rows], dtype=np.float64)
    w = supports / max(supports.sum(), 1)
    report["macro avg"] = {
        "precision": float(np.mean([r[0] for r in rows])),
        "recall": float(np.mean([r[1] for r in rows])),
        "f1-score": float(np.mean([r[2] for r in rows])),
        "support": int(supports.sum()),
    }
    report["weighted avg"] = {
        "precision": float(np.sum(w * [r[0] for r in rows])),
        "recall": float(np.sum(w * [r[1] for r in rows])),
        "f1-score": float(np.sum(w * [r[2] for r in rows])),
        "support": int(supports.sum()),
    }
    return report
