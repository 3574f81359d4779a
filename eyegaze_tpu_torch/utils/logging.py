"""Run logging: scalar dicts to stdout + JSONL + optional wandb.

Port of ``eyegaze_tpu/utils/logging.py``: every run writes a local JSONL
history (one record per ``log`` call, ``[log] k=v ...`` on stdout) and uses
wandb only if it is installed AND enabled.  ``tree_histograms`` is the
``wandb.watch(model, log='all')`` counterpart over a module's parameters
or gradients, keyed by their state_dict names.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch


class RunLogger:
    def __init__(self, output_dir: str | Path, run_name: str = "run",
                 use_wandb: bool = False, wandb_kwargs: Optional[Dict] = None):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"{run_name}.jsonl"
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(**(wandb_kwargs or {}))
            except Exception as e:  # noqa: BLE001 — logging goes on to the JSONL without it
                print(f"[log] wandb disabled: {e}", flush=True)
                self._wandb = None

    def log(self, metrics: Dict):
        rec = {"time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
        parts = [f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                 for k, v in metrics.items()]
        print("[log] " + " ".join(parts), flush=True)
        if self._wandb is not None:
            self._wandb.log(metrics)

    def log_watch(self, record: Dict):
        """Histogram records (large) go to a sidecar JSONL, not stdout."""
        path = self.path.with_name(self.path.stem + "_watch.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
        if self._wandb is not None:
            self._wandb.log(record)


def tree_histograms(named: Iterable[Tuple[str, torch.Tensor]], bins: int = 20,
                    prefix: str = "") -> Dict:
    """For every (name, tensor), e.g. ``model.named_parameters()`` or their
    gradients: a fixed-bin histogram plus l2/mean/std, keyed by
    ``prefix + name``."""
    out = {}
    for name, value in named:
        arr = value.detach().float().cpu().numpy().ravel()
        counts, edges = np.histogram(arr, bins=bins)
        out[prefix + name] = {
            "counts": counts.tolist(),
            "edges": [float(edges[0]), float(edges[-1])],
            "l2": float(np.linalg.norm(arr)),
            "mean": float(arr.mean()),
            "std": float(arr.std()),
        }
    return out
