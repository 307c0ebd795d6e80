"""Numpy evaluation metrics (counterpart of ``hetu_tpu/metrics.py``, of
which this is a copy): softmax, thresholded confusion matrices, ROC/PR AUC,
accuracy, precision/recall/F-beta. Host-side numpy by design — these run on
eval results, not in the step.
"""
from __future__ import annotations

import warnings

import numpy as np


def softmax_func(y):
    y = np.asarray(y, dtype=np.float64)
    e = np.exp(y - y.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def confusion_matrix_at_thresholds(labels, predictions, thresholds,
                                   includes=None):
    """Per-threshold TP/FN/TN/FP dict (reference metrics.py:17)."""
    labels = np.asarray(labels).reshape(-1).astype(bool)
    predictions = np.asarray(predictions).reshape(-1)
    if includes is None:
        includes = ("tp", "fn", "tn", "fp")
    out = {k: np.zeros(len(thresholds), dtype=np.float64) for k in includes}
    for i, t in enumerate(thresholds):
        pred_pos = predictions > t
        if "tp" in out:
            out["tp"][i] = np.sum(pred_pos & labels)
        if "fn" in out:
            out["fn"][i] = np.sum(~pred_pos & labels)
        if "tn" in out:
            out["tn"][i] = np.sum(~pred_pos & ~labels)
        if "fp" in out:
            out["fp"][i] = np.sum(pred_pos & ~labels)
    return out


def roc_pr_curve(values, curve="ROC"):
    tp, fn, tn, fp = values["tp"], values["fn"], values["tn"], values["fp"]
    eps = 1e-7
    if curve == "ROC":
        x = fp / (fp + tn + eps)
        y = tp / (tp + fn + eps)
    else:  # PR
        x = tp / (tp + fn + eps)
        y = tp / (tp + fp + eps)
    return x, y


def auc(labels, predictions, num_thresholds=200, curve="ROC"):
    """Trapezoidal AUC over thresholded confusion matrices
    (reference metrics.py:120).

    Degenerate inputs return NaN with a warning instead of an ``eps``-fudged
    arbitrary number: empty inputs, and single-class labels — ROC needs
    both classes (TPR or FPR is 0/0 at every threshold), PR needs at least
    one positive. The previous behavior silently returned a value like
    ~0.5 whose magnitude was pure epsilon artifact.
    """
    flat_labels = np.asarray(labels).reshape(-1).astype(bool)
    flat_preds = np.asarray(predictions).reshape(-1)
    n_pos = int(flat_labels.sum())
    n_neg = flat_labels.size - n_pos
    degenerate = None
    if flat_preds.size == 0 or flat_labels.size == 0:
        degenerate = "empty labels/predictions"
    elif curve == "ROC" and (n_pos == 0 or n_neg == 0):
        degenerate = (f"single-class labels ({n_pos} positive, {n_neg} "
                      "negative) — ROC AUC needs both classes")
    elif curve != "ROC" and n_pos == 0:
        degenerate = "no positive labels — PR AUC needs at least one"
    if degenerate is not None:
        warnings.warn(f"auc({curve}) is undefined for {degenerate}; "
                      "returning NaN", stacklevel=2)
        return float("nan")
    eps = 1e-7
    thresholds = [(i + 1) * 1.0 / (num_thresholds - 1)
                  for i in range(num_thresholds - 2)]
    thresholds = [0.0 - eps] + thresholds + [1.0 + eps]
    values = confusion_matrix_at_thresholds(flat_labels, flat_preds,
                                            thresholds)
    x, y = roc_pr_curve(values, curve=curve)
    return float(np.sum(np.abs(np.diff(x)) * (y[:-1] + y[1:]) / 2.0))


def accuracy(labels, predictions):
    labels = np.asarray(labels)
    predictions = np.asarray(predictions)
    if labels.ndim > 1:
        labels = labels.argmax(-1)
    if predictions.ndim > 1:
        predictions = predictions.argmax(-1)
    return float(np.mean(labels == predictions))


def confusion_matrix_one_hot(labels, predictions):
    labels = np.asarray(labels).argmax(-1)
    predictions = np.asarray(predictions).argmax(-1)
    n = max(labels.max(), predictions.max()) + 1
    cm = np.zeros((n, n), dtype=np.int64)
    for t, p in zip(labels, predictions):
        cm[t, p] += 1
    return cm


def _prf_counts(labels, predictions):
    cm = confusion_matrix_one_hot(labels, predictions)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    return tp, fp, fn


def precision_score_one_hot(labels, predictions, average=None):
    tp, fp, _ = _prf_counts(labels, predictions)
    if average == "micro":
        return float(tp.sum() / max(tp.sum() + fp.sum(), 1e-7))
    per_class = tp / np.maximum(tp + fp, 1e-7)
    if average == "macro":
        return float(per_class.mean())
    return per_class


def recall_score_one_hot(labels, predictions, average=None):
    tp, _, fn = _prf_counts(labels, predictions)
    if average == "micro":
        return float(tp.sum() / max(tp.sum() + fn.sum(), 1e-7))
    per_class = tp / np.maximum(tp + fn, 1e-7)
    if average == "macro":
        return float(per_class.mean())
    return per_class


def f_score_one_hot(labels, predictions, beta=1.0, average=None):
    p = precision_score_one_hot(labels, predictions, average=average)
    r = recall_score_one_hot(labels, predictions, average=average)
    b2 = beta * beta
    return (1 + b2) * p * r / np.maximum(b2 * p + r, 1e-7) if not np.isscalar(p) \
        else float((1 + b2) * p * r / max(b2 * p + r, 1e-7))
