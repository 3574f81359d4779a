"""Training loop: train steps, evaluation, best-by-metric and periodic
checkpoints, resume, logging.

Port of ``eyegaze_tpu/train/trainer.py``.  Where the JAX trainer compiles
one train step over a pytree state, this one drives a module and an
``Optimizer`` (``train/optim.py``) on one explicit device:

- ``train_step``: ``model.train()``, ``loss_fn(model, batch) -> (loss,
  aux)``, backward, then the optimizer's clip and AdamW update.  Its
  metrics stay on the device; an epoch reads them once, at its end.
- ``evaluate``: ``model.eval()`` under ``torch.inference_mode()``,
  ``eval_logits_fn(model, batch) -> logits`` per batch, sklearn-parity
  metrics on the host; ``model.train()`` is put back.  For an objective
  that is not a classification (ART's denoising), ``eval_metrics_fn(model,
  batch) -> {name: scalar tensor}`` replaces it: each metric is the plain
  mean of its per-batch values over the batches (not weighted by rows, as
  in the JAX package), reported as ``val/<name>``.
- Dropout draws from the device's default generator, seeded from
  ``config.seed``: dropout masks cannot match the JAX package's
  (docs/PARITY.md), so there is no counterpart of its PRNG key.
- ``prefetch`` host batches stay in flight: on a CUDA device each goes
  through pinned memory as a ``non_blocking`` copy.

Under ``use_mesh`` (a ``dp``, ``tpN`` or ``dpN,tpM`` spec,
``parallel/sharding.py``) the trainer is one rank of a group that
``parallel.launch`` (the entry points' ``--mesh``) or torchrun
(``--multihost``) started; the spec is parsed against the group's world,
whose size its dp x tp must equal (``parallel.join_mesh``):

- with tp > 1 the model is cut into the rank's shard (``parallel.tensor.
  shard_tp_``) before DDP wraps it; the optimizer, holding the same
  parameter objects, keeps per-shard moments and clips by the full norm
  (``train/optim.py``); the replicated parameters' gradients are averaged
  over the tp group before the update, one all_reduce a step, so a
  nondeterministic backward kernel on a card cannot make the tp ranks'
  copies drift apart;
- the model trains through ``DistributedDataParallel`` over the dp group;
  dropout draws from ``seed + dp_rank`` on the default generator, so the tp
  ranks of one data rank draw the same masks on replicated activations,
  and from ``seed + rank`` inside the sharded regions (``parallel/
  tensor.py``); without tp dp_rank is the rank;
- each train batch is the global batch, of which the dp rank takes its
  rows (``shard_rows``; a batch that does not split evenly raises, where
  the JAX trainer replicates it), or with ``local_batches`` the rank's own
  batch;
- the epoch's train metrics (losses, correct, count, grad_norm) are the
  global batch's, summed over the ranks where the epoch reads them;
- a loss that leaves out an output computed from parameters needs
  ``find_unused_parameters``; without it a step that leaves a parameter
  without a gradient raises;
- evaluation runs each global eval batch (with ``local_batches``, the
  ranks' batches gathered first) through ``RowParallel``: every rank scores
  the full validation set, a ragged batch padded to the rank multiple and
  trimmed back, and ``eval_metrics_fn`` sees the outputs of the whole
  batch, so a ratio of sums over the batch (ART's SNR) is the global one;
- global rank 0 alone logs and writes checkpoints, every rank takes part
  in their gathers (``train/checkpoint.py``) and then waits at a barrier;
  ``restore`` loads on every rank.

Parameters and the optimizer stay float32; a model built with
``dtype=torch.bfloat16`` computes in bf16 (no gradient scaler: bf16 has
float32's exponent range).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from eyegaze_tpu_torch import parallel
from eyegaze_tpu_torch.parallel import tensor
from eyegaze_tpu_torch.train.checkpoint import CheckpointManager
from eyegaze_tpu_torch.train.metrics import classification_metrics
from eyegaze_tpu_torch.train.optim import Optimizer
from eyegaze_tpu_torch.utils.logging import tree_histograms

Batch = Dict[str, torch.Tensor]
LossFn = Callable[[torch.nn.Module, Batch], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class TrainerConfig:
    num_epochs: int = 10
    eval_every_epochs: int = 1
    save_every_epochs: int = 10
    metric_for_best: str = "f1_macro"
    greater_is_better: bool = True
    checkpoint_dir: Optional[str] = None
    seed: int = 42
    # The device-mesh spec ('dp', 'dpN', 'tpN', 'dpN,tpM'): train as one
    # rank of the running group (module docstring).
    use_mesh: Any = False
    # Under a mesh: each rank's batches are its own rows (--multihost), not
    # the global batch that every rank iterates (--mesh).  Every rank must
    # then give as many train batches of as many rows (multihost.common_steps).
    local_batches: bool = False
    # Under a mesh: the loss leaves out an output computed from parameters,
    # which then get no gradient (parallel.data_parallel_module).
    find_unused_parameters: bool = False
    # wandb.watch equivalent: every N epochs, log parameter + gradient
    # histograms (one extra gradient on the epoch's last batch).  0 disables.
    # Needs a watch_logger on the Trainer.
    watch_every_epochs: int = 0
    # Host batches kept in flight to the device.  0 disables.
    prefetch: int = 2


def seed_device(device: torch.device, seed: int) -> None:
    """Seeds ``device``'s default generator, which dropout draws from."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)


class Trainer:
    """Drives (train_batches, eval_batches) epochs over ``model`` and
    ``optimizer`` on ``device``.  Batches come in as dicts of numpy arrays;
    ``loss_fn``, ``eval_logits_fn`` and ``eval_metrics_fn`` get them as
    tensors on the device.  ``aux`` holds 'logits' where there is a train
    accuracy; its 'loss_*' entries are logged.  At most one of
    ``eval_logits_fn`` and ``eval_metrics_fn`` is given."""

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: Optimizer,
        loss_fn: LossFn,
        eval_logits_fn: Optional[Callable[[torch.nn.Module, Batch], torch.Tensor]],
        config: TrainerConfig,
        *,
        device: torch.device,
        num_classes: int = 3,
        logger: Optional[Callable[[Dict], None]] = None,
        eval_metrics_fn: Optional[Callable[[torch.nn.Module, Batch],
                                           Dict[str, torch.Tensor]]] = None,
        watch_logger: Optional[Callable[[Dict], None]] = None,
    ):
        if eval_logits_fn is not None and eval_metrics_fn is not None:
            raise ValueError("give one of eval_logits_fn and eval_metrics_fn, not both")
        self.rank, self.world = 0, 1
        self.tp = 1
        if config.use_mesh:
            if not parallel.active():
                raise ValueError(f"use_mesh={config.use_mesh!r} needs a running group: start the "
                                 "ranks with eyegaze_tpu_torch.parallel.launch (the entry "
                                 "points' --mesh) or torchrun (--multihost)")
            self.rank, self.world = parallel.rank_and_world()
            _, self.tp = parallel.join_mesh(config.use_mesh)
            if self.tp > 1:
                tensor.shard_tp_(model, parallel.tp_rank_and_world()[0], self.tp)
        # The data axis: the rank's rows of each global batch, and the sums.
        self.dp_rank, self.dp = parallel.data_rank_and_world()
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device)
        # The module train steps call (DDP under a mesh), and the one
        # evaluation calls (the rank's rows, gathered).
        self._train_model = (
            parallel.data_parallel_module(self.model, self.device,
                                          find_unused_parameters=config.find_unused_parameters)
            if config.use_mesh else self.model)
        self._eval_model = parallel.RowParallel(self.model) if config.use_mesh else self.model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.eval_logits_fn = eval_logits_fn
        self.eval_metrics_fn = eval_metrics_fn
        self.num_classes = num_classes
        primary = self.rank == 0
        self.logger = (logger if primary else None) or (lambda d: None)
        self.watch_logger = (watch_logger if primary else lambda d: None) if watch_logger else None
        self.ckpt = (CheckpointManager(config.checkpoint_dir, config.greater_is_better,
                                       write=primary)
                     if config.checkpoint_dir else None)
        self.history: list[Dict] = []
        self.eval_logits: Optional[np.ndarray] = None  # the last evaluate's, in batch order
        self._last_batch: Optional[Batch] = None
        seed_device(self.device, config.seed + self.dp_rank)
        if self.tp > 1:
            tensor.seed_region(self.device, config.seed + self.rank)

    def _put(self, batch: Dict[str, np.ndarray], rows: bool = False) -> Batch:
        """``batch`` on the device; with ``rows`` under a mesh (train
        batches), only the rank's rows of a global batch."""
        if rows and self.config.use_mesh and not self.config.local_batches:
            batch = parallel.shard_rows(batch, self.dp_rank, self.dp)
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _prefetched(self, batches: Iterable[Dict[str, np.ndarray]],
                    rows: bool = False) -> Iterator[Batch]:
        in_flight: collections.deque = collections.deque()
        for batch in batches:
            in_flight.append(self._put(batch, rows))
            if len(in_flight) > self.config.prefetch:
                yield in_flight.popleft()
        while in_flight:
            yield in_flight.popleft()

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One update on a device batch; returns its metrics as device
        tensors: loss, grad_norm (before clipping), correct and count
        (where there are logits and labels), and aux's 'loss_*'."""
        self._train_model.train()
        loss, aux = self.loss_fn(self._train_model, batch)
        self.optimizer.zero_grad()
        loss.backward()
        if self.config.use_mesh and not self.config.find_unused_parameters:
            self._require_gradients()
        if self.tp > 1:
            tensor.average_replicated_grads_(self.model, self.tp)
        metrics = {"loss": loss.detach(), "grad_norm": self.optimizer.step()}
        if "logits" in aux and "label" in batch:
            metrics["correct"] = (aux["logits"].argmax(dim=-1) == batch["label"]).sum()
            metrics["count"] = batch["label"].shape[0]
        metrics.update({k: v.detach() for k, v in aux.items() if k.startswith("loss_")})
        self._last_batch = batch
        return metrics

    def _require_gradients(self) -> None:
        """Raises where DDP left a parameter without a gradient: its bucket
        was not averaged over the ranks."""
        missing = [n for n, p in self.model.named_parameters()
                   if p.requires_grad and p.grad is None]
        if missing:
            raise RuntimeError(f"the loss gives {len(missing)} parameters no gradient "
                               f"({', '.join(missing[:4])}, ...), so DDP averaged none of their "
                               "buckets: train with TrainerConfig(find_unused_parameters=True)")

    def train_epoch(self, batches: Iterable[Dict[str, np.ndarray]], epoch: int) -> Dict:
        totals: Dict[str, Any] = {}
        n_batches = 0
        t0 = time.time()
        for batch in self._prefetched(batches, rows=True):
            for k, v in self.train_step(batch).items():
                totals[k] = totals.get(k, 0) + v
            n_batches += 1
        # The epoch's one wait on the device; under a mesh the sums of the
        # global batch over the dp ranks: correct and count add up, the rest
        # are dp rank means (equal over the tp ranks of one data rank).
        summed = parallel.sum_over_ranks(list(totals.values()), self.device)
        totals = {k: s if k in ("correct", "count") else s / self.dp
                  for k, s in zip(totals, summed)}
        dt = time.time() - t0
        out = {f"train/{k}": v / n_batches for k, v in totals.items()
               if k not in ("correct", "count")}
        if "count" in totals:
            out["train/accuracy"] = totals["correct"] / max(totals["count"], 1)
        out["train/epoch_time_s"] = dt
        out["epoch"] = epoch
        return out

    def evaluate(self, batches: Iterable[Dict[str, np.ndarray]]) -> Dict:
        if self.eval_metrics_fn is not None:
            return self._evaluate_metrics(batches)
        all_logits, all_labels = [], []
        self.model.eval()
        try:
            with torch.inference_mode():
                for batch in self._eval_batches(batches):
                    all_logits.append(self.eval_logits_fn(self._eval_model, batch).float().cpu())
                    all_labels.append(batch["label"].cpu())
        finally:
            self.model.train()
        logits = torch.cat(all_logits).numpy()
        labels = torch.cat(all_labels).numpy()
        self.eval_logits = logits
        m = classification_metrics(labels, logits.argmax(axis=-1), self.num_classes)
        return {f"val/{k}": (v if k == "confusion_matrix" else float(v))
                for k, v in m.items() if not k.endswith("per_class")}

    def _eval_batches(self, batches: Iterable[Dict[str, np.ndarray]]) -> Iterator[Batch]:
        """The eval batches on the device, each the global batch: with
        ``local_batches`` the ranks' i-th batches are gathered in rank order
        first (a batch's rows may differ, none included; a rank whose
        batches ran out gives none, one that held none raises on every
        rank)."""
        if not (self.config.use_mesh and self.config.local_batches):
            yield from self._prefetched(batches)
            return
        it = iter(batches)
        empty = None
        while True:
            batch = next(it, None)
            if batch is not None:
                empty = {k: v[:0] for k, v in batch.items()}
            holding, without = parallel.sum_over_ranks(
                [batch is not None, batch is None and empty is None], self.device)
            if holding == 0:
                return
            if without:
                raise RuntimeError(f"{int(without)} of {self.dp} ranks hold no eval batch "
                                   "while others do: every rank needs a validation shard")
            yield self._put({k: parallel.all_processes_concat(v)
                             for k, v in (batch if batch is not None else empty).items()})

    def _evaluate_metrics(self, batches: Iterable[Dict[str, np.ndarray]]) -> Dict:
        """``eval_metrics_fn``'s metrics, each the mean of its per-batch
        values; they stay on the device until the last batch."""
        sums: Dict[str, torch.Tensor] = {}
        n = 0
        self.model.eval()
        try:
            with torch.inference_mode():
                for batch in self._eval_batches(batches):
                    for k, v in self.eval_metrics_fn(self._eval_model, batch).items():
                        sums[k] = sums[k] + v.float() if k in sums else v.float()
                    n += 1
        finally:
            self.model.train()
        return {f"val/{k}": float(v) / max(n, 1) for k, v in sums.items()}

    def _watch(self, epoch: int) -> None:
        """Parameter and gradient histograms; the gradient is of the loss on
        the epoch's last batch (under a mesh, of the global batch: every rank
        takes part), taken apart from the optimizer's.  Under tp they are of
        rank 0's shards and the replicated parameters."""
        self._train_model.train()
        self.optimizer.zero_grad()
        self.loss_fn(self._train_model, self._last_batch)[0].backward()
        record = {"epoch": epoch}
        record.update(tree_histograms(self.model.named_parameters(), prefix="param/"))
        record.update(tree_histograms(((n, p.grad) for n, p in self.model.named_parameters()
                                       if p.grad is not None), prefix="grad/"))
        self.optimizer.zero_grad()
        self.watch_logger(record)

    def restore(self, name: str) -> int:
        """Loads checkpoint ``name`` into the model and the optimizer (the
        rank's shards of the full state under tp); returns its train step.
        Under a mesh with more than one rank the saved generator state is
        rank 0's, so each rank draws from ``seed + dp_rank + dp * step``
        instead (``seed + rank + world * step`` in the sharded regions)."""
        step = self.ckpt.restore(name, self.model, self.optimizer)
        if self.world > 1:
            seed_device(self.device, self.config.seed + self.dp_rank + self.dp * step)
            if self.tp > 1:
                tensor.seed_region(self.device, self.config.seed + self.rank + self.world * step)
        return step

    def fit(
        self,
        train_batches_fn: Callable[[int], Iterable],
        eval_batches_fn: Optional[Callable[[], Iterable]] = None,
        config_dict: Optional[Dict] = None,
        start_epoch: int = 0,
    ) -> Dict:
        best = None
        for epoch in range(start_epoch, self.config.num_epochs):
            stats = self.train_epoch(train_batches_fn(epoch), epoch)
            if eval_batches_fn is not None and (epoch + 1) % self.config.eval_every_epochs == 0:
                stats.update(self.evaluate(eval_batches_fn()))
                metric = stats.get(f"val/{self.config.metric_for_best}")
                if metric is not None and self.ckpt is not None:
                    # Every rank gathers (the metric is the global batch's,
                    # equal on every rank); the manager of rank 0 writes.
                    if self.ckpt.save_if_best(metric, self.model, self.optimizer, config_dict,
                                              {"epoch": epoch}) and self.rank == 0:
                        best = metric
                    parallel.barrier()
            if self.ckpt is not None and (epoch + 1) % self.config.save_every_epochs == 0:
                self.ckpt.save_periodic(epoch, self.model, self.optimizer, config_dict)
                parallel.barrier()
            if (self.config.watch_every_epochs > 0 and self.watch_logger is not None
                    and (epoch + 1) % self.config.watch_every_epochs == 0
                    and self._last_batch is not None):
                self._watch(epoch)
            loggable = {k: v for k, v in stats.items() if not isinstance(v, np.ndarray)}
            self.logger(loggable)
            self.history.append(loggable)
        if best is None and self.ckpt is not None:
            best = self.ckpt.best_metric
        return {"best_metric": best, "history": self.history}
