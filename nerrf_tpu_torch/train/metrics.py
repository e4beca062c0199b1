"""Evaluation metrics for the detector quality gates: ROC-AUC for the GNN,
F1 for the LSTM, and the file detector's operating-threshold calibrators.

(Copied from ``nerrf_tpu/train/metrics.py``, the parts training's evaluation
and the held-out calibration run; keep the two identical.)  Numpy,
host-side: scores come back from the device as flat arrays.
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


def threshold_at_precision(labels: np.ndarray, scores: np.ndarray,
                           target: float = 0.98, min_recall: float = 0.0,
                           return_recall: bool = False):
    """The lowest score cut whose precision on (labels, scores) meets
    ``target`` — i.e. maximum recall subject to a precision floor.  Returns
    None when no cut achieves it (the caller falls back to the F1 optimum).

    This is the KPI-aligned calibrator for the file detector: the <5%
    false-positive-undo KPI is a PRECISION constraint, and the F1-optimal
    cut sits immediately above the densest benign cluster with no margin
    (benign rotated-log scores jitter across it from trace to trace, while
    a precision-floor cut clears them).

    ``min_recall`` guards against a degenerate calibration:
    when only the single top score clears the precision target, the
    "calibrated" cut silently collapses detection to one file.  If the best
    qualifying cut's recall falls below the floor, the calibration is
    declared unreachable (None) and the caller keeps its fallback, instead
    of shipping a threshold that technically meets precision while
    detecting almost nothing.  ``return_recall`` surfaces the achieved
    recall as ``(threshold, recall)`` so calibration sidecars can record it.

    O(n log n): sort once, sweep cumulative TP/FP over distinct scores."""
    labels = np.asarray(labels).ravel() > 0.5
    scores = np.asarray(scores).ravel().astype(np.float64)
    if len(scores) == 0 or not labels.any():
        return None
    order = np.argsort(-scores)
    s, l = scores[order], labels[order]
    tp = np.cumsum(l)
    fp = np.cumsum(~l)
    # cut AFTER each distinct score value (predict positive for >= s[i]):
    # only positions where the next score differs are valid cut points
    distinct = np.append(s[:-1] != s[1:], True)
    prec = tp / (tp + fp)
    ok = distinct & (prec >= target)
    if not ok.any():
        return None
    # lowest qualifying cut = the last qualifying index in descending order;
    # return the midpoint toward the next score below it so the operating
    # point sits in the middle of the local gap instead of exactly on an
    # observed score (a cut ON the cluster edge flips with jitter)
    i = int(np.nonzero(ok)[0][-1])
    recall = float(tp[i] / labels.sum())
    if recall < min_recall:
        return None
    below = s[s < s[i]]
    t = float((s[i] + below.max()) / 2.0) if len(below) else float(s[i])
    return (t, recall) if return_recall else t


def f1_at_threshold(labels: np.ndarray, scores: np.ndarray,
                    threshold: float) -> dict:
    """Precision/recall/F1 at a FIXED operating threshold — the deployed
    quantity, as opposed to best_f1's oracle sweep.  Returns a dict so
    artifacts can record all three without positional confusion."""
    labels = np.asarray(labels).ravel() > 0.5
    pred = np.asarray(scores).ravel() >= threshold
    tp = float((pred & labels).sum())
    prec = tp / pred.sum() if pred.any() else 0.0
    rec = tp / labels.sum() if labels.any() else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"precision": float(prec), "recall": float(rec), "f1": float(f1)}


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
