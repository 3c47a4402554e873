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
SGD classifier imports scikit-learn when it is built. ``umap=True`` draws
the 2-D embedding figures (:func:`create_embedding_figure`).
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


def pca_2d(train: np.ndarray):
    """A 2-component PCA fitted on ``train``: scikit-learn's ``PCA`` where it
    imports (what the JAX package uses), else the same numpy computation
    (centre, SVD, the signs of ``svd_flip``: each component's largest
    absolute loading positive, scikit-learn's rule since 1.5). Returns
    ``transform(x) -> (N, 2)``."""
    try:
        from sklearn.decomposition import PCA
    except ImportError:
        return numpy_pca_2d(train)
    return PCA(n_components=2).fit(train).transform


def numpy_pca_2d(train: np.ndarray):
    """:func:`pca_2d` without scikit-learn."""
    x = np.asarray(train, np.float64)
    mean = x.mean(axis=0)
    _, _, vt = np.linalg.svd(x - mean, full_matrices=False)
    comps = vt[:2]
    signs = np.sign(comps[np.arange(len(comps)), np.argmax(np.abs(comps), axis=1)])
    comps = comps * np.where(signs == 0, 1.0, signs)[:, None]
    return lambda q: (np.asarray(q, np.float64) - mean) @ comps.T


def create_embedding_figure(dataset: str, features_path: str, df_path: str, dest_dir: str,
                            label_col: str) -> str:
    """The 2-D embedding figure of one dataset (``morphem/evaluation.py:
    18-60``, JAX ``create_embedding_figure``): fitted on the Train split, one
    panel per test task, coloured by ``label_col`` (``label`` when the
    metadata lacks it). UMAP (``n_neighbors=15``) where ``umap`` imports, else
    a PCA (:func:`pca_2d`), as JAX does. Where matplotlib does not import,
    the port saves each task's 2-D embedding as
    ``{dataset}_{task}_{method}.npy`` instead of the figure (a difference
    from JAX, which needs matplotlib). Returns the figure's path, or
    ``dest_dir`` when it wrote the arrays."""
    os.makedirs(dest_dir, exist_ok=True)
    features = np.load(features_path)
    df = pd.read_csv(df_path)
    tasks = [t for t in df["train_test_split"].unique() if t != "Train"]
    train_idx = np.where(df["train_test_split"] == "Train")[0]
    try:
        import umap as _umap

        transform = _umap.UMAP(n_neighbors=15, n_components=2).fit(features[train_idx]).transform
        method = "umap"
    except ImportError:
        transform, method = pca_2d(features[train_idx]), "pca"
    labels = df[label_col] if label_col in df.columns else df.get("label", None)
    panels = []
    for task in tasks:
        idx = np.where(df[task])[0]
        lab = labels.iloc[idx] if labels is not None else pd.Series(np.zeros(len(idx)))
        panels.append((task, transform(features[idx]), lab))
    try:
        import matplotlib
    except ImportError:
        for task, emb, _ in panels:
            np.save(os.path.join(dest_dir, f"{dataset}_{task}_{method}.npy"), emb)
        return dest_dir
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, max(len(tasks), 1), figsize=(5 * max(len(tasks), 1), 4))
    for ax, (task, emb, lab) in zip(np.atleast_1d(axes), panels):
        for value in pd.unique(lab):
            m = np.asarray(lab == value)
            ax.scatter(emb[m, 0], emb[m, 1], s=4, label=str(value)[:18])
        ax.set_title(f"{dataset} {task} ({method})")
        ax.legend(fontsize=6, markerscale=2)
    fig.tight_layout()
    path = os.path.join(dest_dir, f"{dataset}_{method}.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


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
    """``morphem/benchmark.py:31-90`` parity. ``umap=True`` first draws each
    dataset's embedding figure (:func:`create_embedding_figure`, coloured by
    Allen's ``Structure``, HPA's ``cell_type``, CP's ``source``); a figure
    that fails prints why and never fails the benchmark, as in JAX."""
    task_rows = [
        ("Allen", None, None, "Structure"),
        ("HPA", "Task_three", "cell_type", "cell_type"),
        ("CP", "Task_four", "Plate", "source"),
    ]
    full = []
    os.makedirs(dest_dir, exist_ok=True)
    for dataset, leave_out, leaveout_label, umap_label in task_rows:
        if umap:
            try:
                create_embedding_figure(dataset, os.path.join(feature_dir, dataset, feature_file),
                                        os.path.join(root_dir, dataset, "enriched_meta.csv"),
                                        dest_dir, umap_label)
            except Exception as e:  # figures must never fail the benchmark
                print(f"[run_benchmark] embedding figure for {dataset} failed: {e}")
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
