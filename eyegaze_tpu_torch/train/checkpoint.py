"""Checkpoints: best-by-metric and periodic, as reference-named state_dicts.

Port of ``eyegaze_tpu/train/checkpoint.py`` with its API and policy
(``save_periodic``, ``save_if_best``, ``restore``, ``load_meta``,
``latest_epoch``, ``best_metric.json``).  Where the JAX package writes one
orbax directory, a checkpoint ``<name>`` here is three files:

- ``<name>.pt``: the model's ``state_dict()``, reference-named, on the CPU.
  ``Predictor.from_checkpoint`` serves it and
  ``scripts/import_torch_checkpoint.py`` imports it into the JAX package;
- ``<name>.meta.json``: ``{"config": cfg.to_dict(), ...}``, as the JAX
  manager writes it;
- ``<name>.train.pt``: the optimizer's state (its update count is the train
  step) and the RNG state of the model's device, for ``--resume``.

Each file is written to a temporary name and renamed, and read back with
``weights_only=True``.

Under tensor parallelism (``parallel/tensor.py``) a model's parameters are
the rank's shards.  Every rank calls ``save_*`` (the full model
``state_dict`` and the optimizer's moments are gathered over the tp group)
and only the manager built with ``write=True`` (global rank 0's) writes:
the files are one process's, so a tp run's checkpoint serves and resumes in
one process and the other way round.  ``restore`` loads the full state
and cuts it to the rank's shards.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Dict, Optional

import torch

from eyegaze_tpu_torch.parallel import tensor
from eyegaze_tpu_torch.train.optim import Optimizer


def _atomic_save(obj, path: Path) -> None:
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _rng_state(device: torch.device) -> torch.Tensor:
    """The state of ``device``'s default generator (dropout draws from it)."""
    return torch.cuda.get_rng_state(device) if device.type == "cuda" else torch.get_rng_state()


def _set_rng_state(device: torch.device, state: torch.Tensor) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


class CheckpointManager:
    """``write=False``: the manager of a rank that takes part in the
    gathers of a save but writes nothing (module docstring)."""

    def __init__(self, directory: str | Path, metric_greater_is_better: bool = True,
                 write: bool = True):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.greater_is_better = metric_greater_is_better
        self.write = write
        self.best_metric: Optional[float] = None
        self._last_config: Optional[Dict] = None
        best_file = self.directory / "best_metric.json"
        if best_file.exists():
            self.best_metric = json.loads(best_file.read_text())["best_metric"]

    def _is_better(self, metric: float) -> bool:
        if self.best_metric is None:
            return True
        return metric > self.best_metric if self.greater_is_better else metric < self.best_metric

    def _save(self, name: str, model: torch.nn.Module, optimizer: Optimizer,
              config: Optional[Dict] = None, extra: Optional[Dict] = None):
        if config is None:
            config = self._last_config  # reuse the run's config on later saves
        else:
            self._last_config = config
        device = next(model.parameters()).device
        state = tensor.full_state_dict(model)
        optimizer_state = tensor.full_optimizer_state(optimizer)
        if not self.write:
            return
        _atomic_save({k: v.cpu() for k, v in state.items()}, self.directory / f"{name}.pt")
        _atomic_save({"optimizer": optimizer_state, "step": optimizer.count,
                      "rng": _rng_state(device)}, self.directory / f"{name}.train.pt")
        meta = {"config": config or {}, **(extra or {})}
        (self.directory / f"{name}.meta.json").write_text(json.dumps(meta, default=str))

    def save_periodic(self, epoch: int, model, optimizer, config=None, extra=None):
        self._save(f"checkpoint_epoch_{epoch}", model, optimizer, config, extra)

    def save_if_best(self, metric: float, model, optimizer, config=None, extra=None) -> bool:
        if self._is_better(metric):
            self.best_metric = float(metric)
            self._save("best_model", model, optimizer, config,
                       {**(extra or {}), "best_metric": self.best_metric})
            if self.write:
                (self.directory / "best_metric.json").write_text(
                    json.dumps({"best_metric": self.best_metric}))
            return True
        return False

    def restore(self, name: str, model: torch.nn.Module, optimizer: Optimizer) -> int:
        """Loads checkpoint ``name`` into ``model`` (strict) and
        ``optimizer``, each cut to the rank's shards under tp, and its RNG
        state into the model's device; returns the train step."""
        tensor.load_full_state_dict(model, torch.load(self.directory / f"{name}.pt",
                                                      map_location="cpu", weights_only=True))
        train = torch.load(self.directory / f"{name}.train.pt", map_location="cpu",
                           weights_only=True)
        tensor.load_full_optimizer_state(optimizer, train["optimizer"])
        _set_rng_state(next(model.parameters()).device, train["rng"])
        return int(train["step"])

    def load_meta(self, name: str) -> Dict:
        p = self.directory / f"{name}.meta.json"
        return json.loads(p.read_text()) if p.exists() else {}

    def latest_epoch(self) -> Optional[int]:
        epochs = [int(m.group(1)) for p in self.directory.glob("checkpoint_epoch_*.pt")
                  if (m := re.fullmatch(r"checkpoint_epoch_(\d+)\.pt", p.name))]
        return max(epochs) if epochs else None
