"""Error and mechanism analysis.

The port's copy of ``eyegaze_tpu/analysis/error_analysis.py`` (host-side
numpy and scipy), the reference's ``6_Utils/error_analysis.py``:
- ErrorAnalyzer (:37-246): per-pair accuracy, hard-pair identification,
  error distribution by class, confusion patterns;
- MechanismAnalyzer (:277-601): gaze center-of-mass distance, IoU overlap of
  binarized heatmaps, spatial-sensitivity-vs-correctness table, cls1/cls2
  cosine correlation, per-class statistical tests (two-sample t-test).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class ErrorAnalyzer:
    def __init__(self, labels: np.ndarray, preds: np.ndarray,
                 pairs: Optional[np.ndarray] = None, num_classes: int = 3):
        self.labels = np.asarray(labels)
        self.preds = np.asarray(preds)
        self.pairs = np.asarray(pairs) if pairs is not None else None
        self.num_classes = num_classes
        self.correct = self.labels == self.preds

    def per_pair_accuracy(self) -> Dict[int, float]:
        assert self.pairs is not None, "pair ids required"
        return {
            int(p): float(self.correct[self.pairs == p].mean())
            for p in np.unique(self.pairs)
        }

    def hard_pairs(self, threshold: float = 0.5) -> List[int]:
        """Pairs with accuracy below threshold."""
        return [p for p, acc in self.per_pair_accuracy().items() if acc < threshold]

    def error_distribution(self) -> Dict[int, Dict[str, float]]:
        """Per-true-class error rate and count."""
        out = {}
        for c in range(self.num_classes):
            sel = self.labels == c
            n = int(sel.sum())
            out[c] = {
                "count": n,
                "errors": int((~self.correct[sel]).sum()),
                "error_rate": float((~self.correct[sel]).mean()) if n else 0.0,
            }
        return out

    def confusion_patterns(self, top_k: int = 5) -> List[Dict]:
        """Most frequent (true -> pred) error patterns."""
        patterns: Dict[tuple, int] = {}
        for t, p in zip(self.labels[~self.correct], self.preds[~self.correct]):
            patterns[(int(t), int(p))] = patterns.get((int(t), int(p)), 0) + 1
        ranked = sorted(patterns.items(), key=lambda kv: -kv[1])[:top_k]
        return [{"true": t, "pred": p, "count": n} for (t, p), n in ranked]


class MechanismAnalyzer:
    """Input-level mechanism statistics for gaze-pair models."""

    @staticmethod
    def center_of_mass(heatmap: np.ndarray) -> np.ndarray:
        """(H, W) or (3, H, W) -> (y, x) intensity-weighted center."""
        if heatmap.ndim == 3:
            heatmap = heatmap.mean(axis=0)
        h, w = heatmap.shape
        total = heatmap.sum() + 1e-12
        ys = (heatmap.sum(axis=1) @ np.arange(h)) / total
        xs = (heatmap.sum(axis=0) @ np.arange(w)) / total
        return np.asarray([ys, xs])

    @classmethod
    def com_distance(cls, img_a: np.ndarray, img_b: np.ndarray) -> float:
        """Euclidean distance between the two players' gaze centers of mass."""
        return float(np.linalg.norm(cls.center_of_mass(img_a) - cls.center_of_mass(img_b)))

    @staticmethod
    def iou_overlap(img_a: np.ndarray, img_b: np.ndarray, threshold: float = 0.5) -> float:
        """IoU of binarized (min-max normalized) heatmaps."""
        def binarize(img):
            if img.ndim == 3:
                img = img.mean(axis=0)
            lo, hi = img.min(), img.max()
            return (img - lo) / (hi - lo + 1e-12) > threshold

        a, b = binarize(img_a), binarize(img_b)
        union = np.logical_or(a, b).sum()
        return float(np.logical_and(a, b).sum() / union) if union else 0.0

    @staticmethod
    def cls_cosine_correlation(cls1: np.ndarray, cls2: np.ndarray) -> np.ndarray:
        """Per-sample cosine similarity of the two CLS embeddings."""
        num = (cls1 * cls2).sum(axis=1)
        den = np.linalg.norm(cls1, axis=1) * np.linalg.norm(cls2, axis=1) + 1e-12
        return num / den

    @staticmethod
    def sensitivity_vs_correctness(values: np.ndarray, correct: np.ndarray) -> Dict:
        """Compare a mechanism statistic between correct/incorrect samples
        (two-sample Welch t-test, error_analysis.py:471-601 semantics)."""
        from scipy import stats as sstats

        v_ok = values[correct]
        v_bad = values[~correct]
        if len(v_ok) < 2 or len(v_bad) < 2:
            return {"mean_correct": float(np.mean(v_ok)) if len(v_ok) else None,
                    "mean_incorrect": float(np.mean(v_bad)) if len(v_bad) else None,
                    "t": None, "p": None}
        t, p = sstats.ttest_ind(v_ok, v_bad, equal_var=False)
        return {
            "mean_correct": float(v_ok.mean()),
            "mean_incorrect": float(v_bad.mean()),
            "t": float(t),
            "p": float(p),
        }

    @staticmethod
    def per_class_tests(values: np.ndarray, labels: np.ndarray) -> Dict:
        """Pairwise Welch t-tests of a statistic between classes."""
        from scipy import stats as sstats

        out = {}
        classes = np.unique(labels)
        for i in classes:
            for j in classes:
                if i < j:
                    a, b = values[labels == i], values[labels == j]
                    if len(a) >= 2 and len(b) >= 2:
                        t, p = sstats.ttest_ind(a, b, equal_var=False)
                        out[f"{int(i)}-vs-{int(j)}"] = {"t": float(t), "p": float(p)}
        return out
