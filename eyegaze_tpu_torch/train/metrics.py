"""Classification metrics with sklearn's semantics (numpy only).

The port's copy of ``eyegaze_tpu/train/metrics.py``, a rebuild of
``5_Metrics/classification_metrics.py:36-397``: accuracy, macro/weighted
precision/recall/F1, per-class metrics, the confusion matrix, and
one-vs-rest ROC with micro/macro averaging.  The trainer gathers the eval
logits on the host, so these run on numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def confusion_matrix(labels: np.ndarray, preds: np.ndarray, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) with rows = true class (sklearn convention)."""
    idx = np.asarray(labels, np.int64) * num_classes + np.asarray(preds, np.int64)
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def per_class_metrics(cm: np.ndarray, eps: float = 1e-12) -> Dict[str, np.ndarray]:
    tp = np.diagonal(cm).astype(np.float32)
    support = cm.sum(axis=1).astype(np.float32)
    pred_count = cm.sum(axis=0).astype(np.float32)
    # sklearn zero_division=0 semantics: 0 when the denominator is 0.
    precision = np.where(pred_count > 0, tp / (pred_count + eps), 0.0).astype(np.float32)
    recall = np.where(support > 0, tp / (support + eps), 0.0).astype(np.float32)
    f1 = np.where(precision + recall > 0,
                  2 * precision * recall / (precision + recall + eps), 0.0).astype(np.float32)
    return {"precision": precision, "recall": recall, "f1": f1, "support": support}


def classification_metrics(labels: np.ndarray, preds: np.ndarray,
                           num_classes: int = 3) -> Dict[str, np.ndarray]:
    """accuracy + macro/weighted P/R/F1 + confusion matrix + per-class P/R/F1.

    Float32 throughout, rounded as XLA rounds the JAX version's: the macro
    means are the sum times float32(1 / num_classes) (XLA's division by a
    constant), so equal predictions give equal bits on both sides."""
    cm = confusion_matrix(labels, preds, num_classes)
    pc = per_class_metrics(cm)
    n = cm.sum()
    accuracy = np.float32(np.trace(cm)) / np.float32(max(n, 1))
    support = pc["support"]
    w = support / np.float32(max(support.sum(), 1))
    inv = np.float32(1.0 / num_classes)
    out = {
        "accuracy": accuracy,
        "precision_macro": pc["precision"].sum(dtype=np.float32) * inv,
        "recall_macro": pc["recall"].sum(dtype=np.float32) * inv,
        "f1_macro": pc["f1"].sum(dtype=np.float32) * inv,
        "precision_weighted": (w * pc["precision"]).sum(dtype=np.float32),
        "recall_weighted": (w * pc["recall"]).sum(dtype=np.float32),
        "f1_weighted": (w * pc["f1"]).sum(dtype=np.float32),
        "confusion_matrix": cm,
    }
    out.update({f"{k}_per_class": v for k, v in pc.items() if k != "support"})
    return out


def roc_curves(labels: np.ndarray, probs: np.ndarray) -> Dict:
    """One-vs-rest ROC curves + AUCs with micro/macro averaging.

    labels: (N,) ints; probs: (N, C) softmax probabilities.
    Matches classification_metrics.py's sklearn roc_curve/auc usage.
    """
    n, c = probs.shape
    onehot = np.eye(c)[labels]

    def _roc(y, s):
        order = np.argsort(-s, kind="stable")
        y = y[order]
        s = s[order]
        # Tied scores share one threshold: evaluate the curve only at the last
        # index of each distinct score (sklearn _binary_clf_curve semantics).
        thr_idx = np.r_[np.flatnonzero(np.diff(s)), len(s) - 1]
        tps = np.cumsum(y)[thr_idx]
        fps = (thr_idx + 1) - tps
        tpr = np.concatenate([[0.0], tps / max(tps[-1], 1)])
        fpr = np.concatenate([[0.0], fps / max(fps[-1], 1)])
        # np.trapezoid exists only in NumPy >= 2.0.
        auc = getattr(np, "trapezoid", getattr(np, "trapz", None))(tpr, fpr)
        return fpr, tpr, float(auc)

    out = {"per_class": {}}
    aucs = []
    for k in range(c):
        fpr, tpr, auc = _roc(onehot[:, k], probs[:, k])
        out["per_class"][k] = {"fpr": fpr, "tpr": tpr, "auc": auc}
        aucs.append(auc)
    out["macro_auc"] = float(np.mean(aucs))
    fpr, tpr, micro = _roc(onehot.ravel(), probs.ravel())
    out["micro"] = {"fpr": fpr, "tpr": tpr, "auc": micro}
    return out
