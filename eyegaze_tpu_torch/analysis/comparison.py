"""Multi-model comparison.

The port's copy of ``eyegaze_tpu/analysis/comparison.py`` (the reference's
``6_Utils/model_comparison.py``): ModelResults container, metric table,
ranking, pairwise significance tests (McNemar-style on per-sample
correctness), CSV + LaTeX emission, the comparison figure suite.

The numbers need no pandas: ``metric_rows``, ``ranking`` and
``pairwise_rows`` run where it is not installed, as on the card's host.
The tables built from them (``metric_table``, ``pairwise_significance``,
``to_csv``, ``to_latex``) import pandas, and ``plot_all`` matplotlib, at
their first use (``utils/lazy``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from eyegaze_tpu_torch.train.metrics import classification_metrics, roc_curves
from eyegaze_tpu_torch.utils.lazy import LazyImport

pd = LazyImport("pandas")


@dataclasses.dataclass
class ModelResults:
    name: str
    labels: np.ndarray
    preds: np.ndarray
    probs: Optional[np.ndarray] = None
    metadata: Optional[Dict] = None

    def metrics(self, num_classes: int = 3) -> Dict[str, float]:
        m = classification_metrics(np.asarray(self.labels), np.asarray(self.preds), num_classes)
        return {k: float(v) for k, v in m.items()
                if not hasattr(v, "shape") or v.ndim == 0}


class MultiModelComparator:
    def __init__(self, results: List[ModelResults], num_classes: int = 3):
        self.results = results
        self.num_classes = num_classes

    def metric_rows(self) -> List[Dict]:
        """One record per model: its name under ``Model`` and its scalar
        metrics."""
        return [{"Model": r.name, **r.metrics(self.num_classes)} for r in self.results]

    def metric_table(self):
        return pd.DataFrame(self.metric_rows())

    def ranking(self, metric: str = "f1_macro") -> List[str]:
        """Model names, best ``metric`` first, in the order of the JAX
        package's ``metric_table().sort_values(metric, ascending=False)``:
        pandas sorts a column descending by reversing it, taking numpy's
        quicksort argsort and reversing that, which is done here without
        pandas."""
        rows = self.metric_rows()
        values = np.asarray([r[metric] for r in rows], np.float64)[::-1]
        order = np.arange(len(rows))[::-1][np.argsort(values, kind="quicksort")][::-1]
        return [rows[i]["Model"] for i in order]

    def pairwise_rows(self) -> List[Dict]:
        """Exact binomial (McNemar) test on discordant predictions between
        each model pair (model_comparison.py:190-247 role)."""
        from scipy import stats as sstats

        rows = []
        for i, a in enumerate(self.results):
            for b in self.results[i + 1:]:
                assert len(a.labels) == len(b.labels), "misaligned result sets"
                ok_a = a.preds == a.labels
                ok_b = b.preds == b.labels
                n01 = int((ok_a & ~ok_b).sum())
                n10 = int((~ok_a & ok_b).sum())
                n = n01 + n10
                p = float(sstats.binomtest(min(n01, n10), n, 0.5).pvalue) if n else 1.0
                rows.append({
                    "Model_A": a.name, "Model_B": b.name,
                    "A_only_correct": n01, "B_only_correct": n10, "p_value": p,
                })
        return rows

    def pairwise_significance(self):
        """``pairwise_rows`` as a DataFrame."""
        return pd.DataFrame(self.pairwise_rows())

    def plot_all(self, output_dir, class_names=None) -> List[str]:
        """Emit the reference's comparison figure suite
        (model_comparison.py:249-513): grouped metric bars, normalized-CM
        grid, micro-ROC overlay (when probs exist), per-class F1 bars, and
        the radar chart.  Returns the written paths.
        """
        from pathlib import Path

        from eyegaze_tpu_torch.utils import visualizers as viz

        class_names = class_names or viz.CLASS_NAMES[: self.num_classes]
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        table = self.metric_table()
        written = []

        def emit(fname, fn, *a, **kw):
            p = out / fname
            fn(*a, path=p, **kw)
            written.append(str(p))

        emit("metrics_comparison.png", viz.plot_metrics_comparison, table,
             metric_cols=("accuracy", "precision_macro", "recall_macro", "f1_macro"))
        full = {r.name: classification_metrics(
            np.asarray(r.labels), np.asarray(r.preds), self.num_classes)
            for r in self.results}
        emit("confusion_matrix_grid.png", viz.plot_confusion_matrix_grid,
             {n: np.asarray(m["confusion_matrix"]) for n, m in full.items()},
             class_names=class_names)
        emit("per_class_f1.png", viz.plot_per_class_comparison,
             {n: np.asarray(m["f1_per_class"]) for n, m in full.items()},
             class_names=class_names, metric="f1")
        emit("radar_chart.png", viz.plot_radar_chart, table)
        rocs = {r.name: roc_curves(r.labels, r.probs)
                for r in self.results if r.probs is not None}
        if rocs:
            emit("roc_overlay.png", viz.plot_roc_overlay, rocs)
        return written

    def to_csv(self, path) -> None:
        self.metric_table().to_csv(path, index=False)

    def to_latex(self, path, metric_cols=("accuracy", "precision_macro",
                                          "recall_macro", "f1_macro")) -> str:
        df = self.metric_table()[["Model", *metric_cols]]
        latex = df.to_latex(index=False, float_format="%.4f")
        with open(path, "w") as f:
            f.write(latex)
        return latex
