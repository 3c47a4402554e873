"""MorphEm CHAMMI benchmark driver (the port's own copy of the JAX
package's ``evaluation/benchmark.py``).

Parity port of the benchmark *protocol* (``morphem/benchmark.py:31-90``,
``morphem/evaluation.py:101-223``) on top of the kNN on the card:

- per dataset {Allen, HPA, CP}: Task_one (in-distribution), Task_two
  (held-out), and a leave-one-out task (HPA: Task_three over ``cell_type``,
  CP: Task_four over ``Plate``)
- classifier = exact 1-NN (l2/cosine) or SGD linear classifier
- returns a DataFrame [dataset, task, classifier, accuracy, f1_score_macro]
  and writes the same json/csv artifacts

The kNN runs on ``device`` (the card unless ``"cpu"`` is asked for). The
SGD classifier imports scikit-learn when it is built. The embedding figures
(``umap=True``) are not ported (ROADMAP A7) and raise.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import pandas as pd

from .knn import KNeighbors
from .metrics import classification_report_dict, macro_f1

TASK_ORDER = {"Task_one": 1, "Task_two": 2, "Task_three": 3, "Task_four": 4}


def _make_model(model_choice: str, knn_metric: str, device=None):
    if model_choice == "knn":
        return KNeighbors(metric=knn_metric, device=device)
    if model_choice == "sgd":
        from sklearn.linear_model import SGDClassifier

        return SGDClassifier(alpha=0.001, max_iter=100)
    raise ValueError(f"{model_choice} is not implemented. Try sgd or knn.")


def evaluate(
    features_path: str,
    df_path: str,
    leave_out: Optional[str],
    leaveout_label: Optional[str],
    model_choice: str,
    knn_metric: str,
    device=None,
) -> Dict:
    """``morphem/evaluation.py:101-223`` parity."""
    features = np.load(features_path)
    df = pd.read_csv(df_path)

    tasks = list(df["train_test_split"].unique())
    tasks.remove("Train")
    tasks = sorted(tasks, key=lambda x: TASK_ORDER[x])
    leaveout_ind = tasks.index(leave_out) if leave_out is not None else None

    train_indices = np.where(df["train_test_split"] == "Train")[0]
    all_test_indices = [np.where(df[task])[0] for task in tasks]

    target_value = list(df["Label"].unique())
    encoded_target = {v: i for i, v in enumerate(target_value)}
    df["encoded_label"] = df.Label.apply(lambda x: encoded_target[x])
    y_all = df["encoded_label"].values

    train_X = features[train_indices]
    train_Y = y_all[train_indices]

    if leave_out is not None:
        df_takeout = df[df[leave_out]]
        groups = list(df_takeout[leaveout_label].unique())
        all_group_indices = [
            df_takeout[df_takeout[leaveout_label] == g].index.values for g in groups
        ]
        all_other_indices = [
            df_takeout[df_takeout[leaveout_label] != g].index.values for g in groups
        ]

    accuracies, f1scores, reports = [], [], []
    for task_ind, task in enumerate(tasks):
        if task != leave_out:
            model = _make_model(model_choice, knn_metric, device)
            model.fit(train_X, train_Y)
            predictions = model.predict(features[all_test_indices[task_ind]])
            ground_truth = y_all[all_test_indices[task_ind]]
        else:  # leave-one-out group loop (evaluation.py:181-201)
            predictions, ground_truth = [], []
            for gi in range(len(groups)):
                model = _make_model(model_choice, knn_metric, device)
                rest = np.concatenate((train_indices, all_other_indices[gi]), axis=None)
                model.fit(features[rest], y_all[rest])
                predictions.append(model.predict(features[all_group_indices[gi]]))
                ground_truth.append(y_all[all_group_indices[gi]])
            predictions = np.concatenate(predictions)
            ground_truth = np.concatenate(ground_truth)

        int_labels = np.unique(ground_truth)
        str_labels = [target_value[i] for i in int_labels]
        accuracies.append(float(np.mean(predictions == ground_truth)))
        f1scores.append(macro_f1(ground_truth, predictions, labels=int_labels))
        reports.append(
            classification_report_dict(ground_truth, predictions, int_labels.tolist(), str_labels)
        )

    return {
        "tasks": tasks,
        "accuracies": accuracies,
        "f1scores_macro": f1scores,
        "reports_dict": reports,
        "encoded_target": encoded_target,
    }


def run_benchmark(
    root_dir: str,
    dest_dir: str,
    feature_dir: str,
    feature_file: str,
    classifier: str = "knn",
    umap: bool = False,
    knn_metric: str = "l2",
    device=None,
) -> pd.DataFrame:
    """``morphem/benchmark.py:31-90`` parity. ``umap=True``, the reference's
    2-D embedding figures (``morphem/evaluation.py:18-60``), raises
    ``NotImplementedError`` (ROADMAP A7)."""
    if umap:
        raise NotImplementedError("eval.umap: the embedding figures (create_embedding_figure) "
                                  "are not ported yet (ROADMAP A7)")
    task_rows = [
        ("Allen", None, None),
        ("HPA", "Task_three", "cell_type"),
        ("CP", "Task_four", "Plate"),
    ]
    full = []
    os.makedirs(dest_dir, exist_ok=True)
    for dataset, leave_out, leaveout_label in task_rows:
        results = evaluate(
            os.path.join(feature_dir, dataset, feature_file),
            os.path.join(root_dir, dataset, "enriched_meta.csv"),
            leave_out,
            leaveout_label,
            classifier,
            knn_metric,
            device,
        )
        report = {"target_encoding": results["encoded_target"]}
        for ti, task in enumerate(results["tasks"]):
            report[task] = results["reports_dict"][ti]
        suffix = f"{classifier}_{knn_metric}" if classifier == "knn" else classifier
        with open(os.path.join(dest_dir, f"{dataset}_{suffix}_results.json"), "w") as f:
            json.dump(report, f)
        for ti, task in enumerate(results["tasks"]):
            full.append(
                dict(
                    dataset=dataset,
                    task=task,
                    classifier=classifier,
                    accuracy=results["accuracies"][ti],
                    f1_score_macro=results["f1scores_macro"][ti],
                )
            )
    full_df = pd.DataFrame(full)
    suffix = f"{classifier}_{knn_metric}" if classifier == "knn" else classifier
    full_df.to_csv(os.path.join(dest_dir, f"{suffix}_full_results.csv"), index=False)
    return full_df


def chammi_score(df: pd.DataFrame, metric_col: str = "f1_score_macro") -> float:
    """CHAMMI final score: mean(Allen_T2, mean(HPA_T2, T3), mean(CP_T2, T3, T4))
    (``trainer.py:711-731``)."""

    def get(dataset, task):
        row = df[(df.dataset == dataset) & (df.task == task)]
        return float(row[metric_col].iloc[0]) if len(row) else np.nan

    allen = get("Allen", "Task_two")
    hpa = np.nanmean([get("HPA", "Task_two"), get("HPA", "Task_three")])
    cp = np.nanmean([get("CP", "Task_two"), get("CP", "Task_three"), get("CP", "Task_four")])
    return float(np.nanmean([allen, hpa, cp]))
