"""Learning-curve analysis from run history.

The port's copy of ``eyegaze_tpu/analysis/learning_curves.py`` (the
reference's ``6_Utils/learning_curves.py``): history loading from the
RunLogger JSONL (``utils/logging.py``'s, which ``train_dual_eeg`` and the
other trainers write, with the ``--watch`` sidecar beside it), from
checkpoint meta files, from the wandb API (``learning_curves.py:59-124``),
from CSV/TSV log files (:197-223), and from plain-text logs via key=value
regex; best-epoch identification, summary stats, multi-run comparison.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

# "key=value" / "key: value" tokens on a log line, e.g.
# "[log] epoch=3 train/loss=0.41 val/f1_macro=0.87".
_KV_RE = re.compile(r"([A-Za-z_][\w./-]*)\s*[=:]\s*([-+]?\d*\.?\d+(?:[eE][-+]?\d+)?)")


class LearningCurveAnalyzer:
    def __init__(self, history: List[Dict]):
        self.history = history

    @classmethod
    def from_jsonl(cls, path) -> "LearningCurveAnalyzer":
        lines = Path(path).read_text().splitlines()
        return cls([json.loads(line) for line in lines if line.strip()])

    @classmethod
    def from_checkpoint_meta(cls, ckpt_dir) -> "LearningCurveAnalyzer":
        """Minimal history from checkpoint meta files (best epochs only)."""
        recs = []
        for p in sorted(Path(ckpt_dir).glob("*.meta.json")):
            recs.append(json.loads(p.read_text()))
        return cls(recs)

    @classmethod
    def from_wandb(cls, project: str, run_name: str,
                   entity: Optional[str] = None) -> Optional["LearningCurveAnalyzer"]:
        """History via the wandb API (learning_curves.py:59-124 role).

        Returns None with a warning when wandb is unavailable or the run is
        not found (the reference's graceful-degradation contract).
        """
        try:
            import wandb
        except ImportError:
            print("[learning_curves] wandb not installed; cannot fetch history")
            return None
        try:
            api = wandb.Api()
            path = f"{entity}/{project}" if entity else project
            for run in api.runs(path):
                if run.name == run_name:
                    hist = run.history()
                    recs = hist.to_dict("records") if hasattr(hist, "to_dict") else list(hist)
                    return cls([{k: v for k, v in r.items() if v == v} for r in recs])
            print(f"[learning_curves] run {run_name!r} not found in {path!r}")
            return None
        except Exception as e:
            print(f"[learning_curves] wandb fetch failed: {e}")
            return None

    @classmethod
    def from_csv_log(cls, path, delimiter: str = ",") -> "LearningCurveAnalyzer":
        """History from a CSV/TSV metrics log (learning_curves.py:197-223 role)."""
        import csv

        with open(path, newline="") as f:
            rows = list(csv.DictReader(f, delimiter=delimiter))
        recs = []
        for row in rows:
            rec = {}
            for k, v in row.items():
                try:
                    rec[k] = float(v)
                except (TypeError, ValueError):
                    rec[k] = v
            recs.append(rec)
        return cls(recs)

    @classmethod
    def from_text_log(cls, path, epoch_key: str = "epoch") -> "LearningCurveAnalyzer":
        """History from a plain-text training log via key=value/key: value
        regex; one record per line that carries at least one numeric metric."""
        recs = []
        for line in Path(path).read_text().splitlines():
            kv = {k: float(v) for k, v in _KV_RE.findall(line)}
            if kv:
                if epoch_key in kv:
                    kv[epoch_key] = int(kv[epoch_key])
                recs.append(kv)
        return cls(recs)

    def series(self, key: str):
        epochs, vals = [], []
        for rec in self.history:
            if key in rec:
                epochs.append(rec.get("epoch", len(epochs)))
                vals.append(rec[key])
        return np.asarray(epochs), np.asarray(vals, dtype=np.float64)

    def best_epoch(self, key: str = "val/f1_macro", greater_is_better: bool = True):
        epochs, vals = self.series(key)
        if len(vals) == 0:
            return None
        idx = int(np.argmax(vals) if greater_is_better else np.argmin(vals))
        return {"epoch": int(epochs[idx]), key: float(vals[idx])}

    def summary(self) -> Dict:
        keys = sorted({k for rec in self.history for k in rec
                       if isinstance(rec.get(k), (int, float)) and k != "time"})
        out = {}
        for k in keys:
            _, vals = self.series(k)
            if len(vals):
                out[k] = {"first": float(vals[0]), "last": float(vals[-1]),
                          "min": float(vals.min()), "max": float(vals.max())}
        return out


def compare_training_histories(analyzers: Dict[str, LearningCurveAnalyzer],
                               key: str = "val/f1_macro") -> Dict[str, Dict]:
    return {name: (a.best_epoch(key) or {}) for name, a in analyzers.items()}


class WatchAnalyzer:
    """Per-layer parameter/gradient health from the ``--watch`` sidecar.

    The trainers' wandb.watch equivalent (RunLogger.log_watch,
    train_gaze_earlyfusion.py:458) writes ``<run>_watch.jsonl``: one record
    per watched epoch, each key a flattened param path under ``param/`` or
    ``grad/`` with ``{counts, edges, l2, mean, std}``.  This surfaces them
    as per-layer time series (the wandb histogram-panel role).
    """

    def __init__(self, records: List[Dict]):
        self.records = records

    @classmethod
    def from_jsonl(cls, path) -> "WatchAnalyzer":
        lines = Path(path).read_text().splitlines()
        return cls([json.loads(line) for line in lines if line.strip()])

    @classmethod
    def for_run(cls, run_jsonl_path) -> Optional["WatchAnalyzer"]:
        """Locate the sidecar next to a run's main JSONL (run.jsonl ->
        run_watch.jsonl); None when the run was not watched."""
        p = Path(run_jsonl_path)
        sidecar = p.with_name(p.stem + "_watch.jsonl")
        return cls.from_jsonl(sidecar) if sidecar.exists() else None

    def layers(self, kind: str = "grad") -> List[str]:
        """Layer paths present in the records (kind: 'grad' | 'param')."""
        names = set()
        for rec in self.records:
            names.update(k[len(kind) + 1:] for k in rec
                         if k.startswith(kind + "/"))
        return sorted(names)

    def series(self, layer: str, kind: str = "grad", stat: str = "l2"):
        """(epochs, values) of one summary stat for one layer."""
        epochs, vals = [], []
        for rec in self.records:
            entry = rec.get(f"{kind}/{layer}")
            if entry is not None:
                epochs.append(rec.get("epoch", len(epochs)))
                vals.append(entry[stat])
        return np.asarray(epochs), np.asarray(vals, dtype=np.float64)

    def norm_table(self, kind: str = "grad", stat: str = "l2") -> Dict[str, np.ndarray]:
        """{layer: stat-over-epochs} for every watched layer — the flat view
        plot_watch_norms consumes."""
        return {name: self.series(name, kind, stat)[1]
                for name in self.layers(kind)}

    def vanishing_or_exploding(self, low: float = 1e-7,
                               high: float = 1e3) -> Dict[str, str]:
        """Health screen: layers whose LAST gradient l2 is ~0 (vanishing)
        or huge (exploding) — the reason wandb.watch exists."""
        out = {}
        for name in self.layers("grad"):
            _, vals = self.series(name, "grad", "l2")
            if len(vals) == 0:
                continue
            if vals[-1] < low:
                out[name] = "vanishing"
            elif vals[-1] > high:
                out[name] = "exploding"
        return out
