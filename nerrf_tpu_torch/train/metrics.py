"""Evaluation metrics for the detector quality gates: ROC-AUC for the GNN,
F1 for the LSTM.

(Copied from ``nerrf_tpu/train/metrics.py``, the part training's evaluation
runs; keep the two identical.)  Numpy, host-side: scores come back from the
device as flat arrays.
"""

from __future__ import annotations

import numpy as np


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney).  Returns 0.5 for degenerate inputs."""
    labels = np.asarray(labels).astype(np.float64).ravel()
    scores = np.asarray(scores).astype(np.float64).ravel()
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # midrank ties
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    rank_sum = ranks[pos].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def f1_score(labels: np.ndarray, preds: np.ndarray) -> float:
    labels = np.asarray(labels).ravel() > 0.5
    preds = np.asarray(preds).ravel() > 0.5
    tp = int((labels & preds).sum())
    fp = int((~labels & preds).sum())
    fn = int((labels & ~preds).sum())
    if tp == 0:
        return 0.0
    prec = tp / (tp + fp)
    rec = tp / (tp + fn)
    return float(2 * prec * rec / (prec + rec))


def best_f1(labels: np.ndarray, scores: np.ndarray, n_thresholds: int = 101):
    """Best F1 over a threshold sweep; returns (f1, threshold).

    When several consecutive thresholds tie at the best F1 (a well-separated
    model has a wide score gap between the classes, so the whole gap ties),
    the returned threshold is the MIDDLE of that contiguous plateau, not its
    first point: a cut at the plateau's edge sits immediately above the
    densest negative cluster, and a held-out calibration with no margin
    flips on the next trace's jitter."""
    scores = np.asarray(scores).ravel()
    if len(scores) == 0:
        return 0.0, 0.5
    lo, hi = float(scores.min()), float(scores.max())
    grid = np.linspace(lo, hi, n_thresholds)
    f1s = np.array([f1_score(labels, scores > t) for t in grid])
    best = float(f1s.max())
    if best == 0.0:
        return 0.0, 0.5
    i = int(f1s.argmax())          # first index achieving the best
    j = i
    while j + 1 < len(grid) and f1s[j + 1] == f1s[i]:
        j += 1                     # extend the contiguous optimal plateau
    return best, float(grid[(i + j) // 2])
