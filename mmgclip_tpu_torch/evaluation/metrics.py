"""Classification metrics in numpy (ROC/AUC/accuracy/F1/confusion/bootstrap;
port of mmgclip_tpu/evaluation/metrics.py, the same code on the same numpy RNG).

Self-contained replacements for the sklearn/scipy calls the reference makes
(reference: mmgclip/evaluator.py:296-300,380-381,421-471; ClassifierExperiment.py:239-271)
so the metric path has no sklearn dependency and the bootstrap is vectorized.
Numerics match sklearn (tested against it).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def roc_curve(y_true, y_score, drop_intermediate: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FPR/TPR at descending score thresholds (sklearn-compatible output)."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, np.float64)
    order = np.argsort(-y_score, kind="stable")
    y_true, y_score = y_true[order], y_score[order]

    distinct = np.where(np.diff(y_score))[0]
    threshold_idx = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idx]
    fps = 1 + threshold_idx - tps
    thresholds = y_score[threshold_idx]

    if drop_intermediate and len(fps) > 2:
        # drop collinear points, as sklearn does
        keep = np.where(
            np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        )[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]

    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]

    p = max(tps[-1], 1)
    n = max(fps[-1], 1)
    return fps / n, tps / p, thresholds


def auc(x, y) -> float:
    """Trapezoidal area under a curve."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return float(np.trapezoid(y, x))


def roc_auc_score(y_true, y_score) -> float:
    """AUROC via the rank statistic (ties handled by midranks)."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, np.float64)
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _midranks(y_score)
    return float((ranks[y_true].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _midranks(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_x = x[order]
    i = 0
    while i < len(sorted_x):
        j = i
        while j + 1 < len(sorted_x) and sorted_x[j + 1] == sorted_x[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2 + 1
        i = j + 1
    return ranks


def accuracy_score(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def f1_score(y_true, y_pred, average: str = "binary") -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if average == "binary":
        tp = np.sum((y_pred == 1) & (y_true == 1))
        fp = np.sum((y_pred == 1) & (y_true != 1))
        fn = np.sum((y_pred != 1) & (y_true == 1))
        denom = 2 * tp + fp + fn
        return float(2 * tp / denom) if denom else 0.0
    if average == "micro":
        # micro F1 over multiclass == accuracy
        return accuracy_score(y_true, y_pred)
    raise ValueError(f"Unsupported average {average!r}")


def confusion_matrix(y_true, y_pred, labels=None) -> np.ndarray:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if labels is None:
        labels = np.unique(np.r_[y_true, y_pred])
    k = len(labels)
    index = {label: i for i, label in enumerate(labels)}
    out = np.zeros((k, k), np.int64)
    for t, p in zip(y_true, y_pred):
        if t in index and p in index:
            out[index[t], index[p]] += 1
    return out


def softmax(x, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, np.float64)
    shifted = x - x.max(axis=axis, keepdims=True)
    e = np.exp(shifted)
    return e / e.sum(axis=axis, keepdims=True)


def bootstrap_auc_ci(
    y_true,
    y_score,
    n_iterations: int = 1000,
    seed: int = 0,
) -> Dict[str, float]:
    """1000x bootstrap AUROC with a 95% percentile CI
    (reference: evaluator.py:421-471, calculate_ci :89-93).

    Vectorized: one resample-index matrix, per-row rank AUC.
    """
    y_true = np.asarray(y_true).astype(np.int64)
    y_score = np.asarray(y_score, np.float64)
    n = y_true.size
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_iterations, n))

    scores = []
    for row in idx:
        labels = y_true[row]
        if labels.min() == labels.max():
            continue  # single-class resample, skipped like the reference
        scores.append(roc_auc_score(labels == 1, y_score[row]))
    scores = np.sort(np.asarray(scores))
    lower = scores[int(0.025 * len(scores))]
    upper = scores[int(0.975 * len(scores))]
    return {
        "mean": float(scores.mean()),
        "lower": float(lower),
        "upper": float(upper),
        "n_valid": int(len(scores)),
    }


def mean_roc_curve(curves, grid_points: int = 100):
    """Interpolated mean ROC across classes (reference: evaluator.py:392-409)."""
    mean_fpr = np.linspace(0, 1, grid_points)
    tprs = [np.interp(mean_fpr, fpr, tpr) for fpr, tpr in curves]
    mean_tpr = np.mean(tprs, axis=0)
    std_tpr = np.std(tprs, axis=0)
    return mean_fpr, mean_tpr, std_tpr, auc(mean_fpr, mean_tpr)
