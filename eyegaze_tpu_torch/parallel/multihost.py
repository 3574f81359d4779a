"""Multi-process training under torchrun: the SPMD contract.

The counterpart of ``eyegaze_tpu/parallel/multihost.py``.  Every process
runs the same entry point (``torchrun ... -m eyegaze_tpu_torch.train_dual_eeg
--multihost``), loads only its data rank's slice of the data
(``process_shard_bounds``) and trains its own local batches as one rank of
the group; DDP averages the gradients over the dp group, so the global
batch is ``global_batch_size(local)``.  The world is the mesh's dp x tp:
the tp ranks of one data rank load the same slice.  Every function here
shards and gathers by dp rank over the dp group (``mesh.py``): the
model's outputs are replicated over tp after its last row-parallel reduce,
so one copy per data rank is gathered.  JAX's ``all_processes_concat``
dedups shards on the assumption that non-batch dims are replicated
(ROADMAP section 3); nothing here assumes it.

- ``initialize_multihost`` joins the group that torchrun describes in
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT``.  With none of them set it joins nothing and returns (0,
  1), the single-process contract.  With any of them set, a missing one or
  a failed join raises: the JAX function swallows a failed join when no
  coordinator is configured, which would leave N processes training alone
  and writing one checkpoint directory.
- ``all_processes_concat`` gathers every process's rows in rank order (the
  eval pattern: each process scores its shard, every process gets the full
  set); a process may hold any number of rows, none included.
- ``common_steps``: the shards of a split into trials may hold other
  numbers of windows, so every process trains the smallest shard's number
  of batches an epoch (the JAX script lets the processes' steps differ).
- The JAX ``host_local_to_global`` and ``fetch_local_shard`` assemble and
  split global arrays over a device mesh.  Without a model axis a rank's
  tensors are its own rows, so neither has a counterpart here.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from eyegaze_tpu_torch.parallel.mesh import (
    active,
    data_rank_and_world,
    gather_uneven,
    init_data_parallel,
    rank_and_world,
)

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def local_device(device: torch.device | str) -> torch.device:
    """This process's device: card ``LOCAL_RANK`` on CUDA, else ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def initialize_multihost(device: torch.device | str = "cuda", *,
                         backend: Optional[str] = None) -> Tuple[int, int]:
    """Joins torchrun's group with this process's device
    (``local_device``); returns (rank, world size).  (0, 1) without any of
    torchrun's variables; raises on a partial set or a failed join.  A
    second call returns the group's (rank, world size)."""
    given = [k for k in TORCHRUN_VARS if os.environ.get(k)]
    if not given:
        return 0, 1
    missing = [k for k in TORCHRUN_VARS if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"--multihost: {', '.join(given)} set but {', '.join(missing)} "
                           "missing; start the processes with torchrun")
    if active():
        return rank_and_world()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    init_data_parallel(rank, world, local_device(device), backend=backend,
                       init_method="env://")
    return rank, world


def process_shard_bounds(n: int, process_index: Optional[int] = None,
                         process_count: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) of this process's contiguous slice of n examples, by
    its dp rank among the dp ranks unless given.

    Every process loads ``n // process_count`` examples; n must divide
    evenly (entry points drop the remainder first, as their batches drop
    theirs)."""
    rank, world = data_rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    if n % pc:
        raise ValueError(
            f"n={n} examples do not divide process_count={pc}; trim to a "
            f"multiple first (drop-last contract)")
    per = n // pc
    return pi * per, (pi + 1) * per


def global_batch_size(local_batch_size: int) -> int:
    """Global batch implied by a per-process batch: one per dp rank."""
    return local_batch_size * data_rank_and_world()[1]


def common_steps(steps: int, rows: int) -> int:
    """The train steps an epoch that every process takes: the smallest of
    the processes' ``steps``.  Each process's batches must hold as many
    ``rows`` (the row gathers and DDP's average assume it), else every
    process raises.  ``steps`` itself with one process."""
    table = all_processes_concat(np.array([[steps, rows]], np.int64))
    if len(set(table[:, 1].tolist())) > 1:
        raise ValueError(f"the processes' train batches hold {table[:, 1].tolist()} rows: every "
                         "process needs a shard of at least per_device_train_batch_size windows")
    return int(table[:, 0].min())


def all_processes_concat(x):
    """Every dp rank's rows of ``x`` (a numpy array or a tensor), in rank
    order, as the same type; ``x`` itself with one dp rank."""
    if isinstance(x, np.ndarray):
        return gather_uneven(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    return gather_uneven(x)
