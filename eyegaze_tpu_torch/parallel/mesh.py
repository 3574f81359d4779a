"""Data and tensor parallelism over ``torch.distributed``: ranks, the mesh's
groups, row shards, the row gather and DDP.

The counterpart of ``eyegaze_tpu/parallel/mesh.py`` (``make_mesh``,
``shard_batch``, ``data_parallel_jit``).  JAX runs one program over a 1-D
device mesh and lets XLA insert the gradient all-reduce; here each rank is
a process with one device, the model is wrapped in
``DistributedDataParallel`` (parameters broadcast from rank 0, gradients
averaged over the ranks), and every rank takes its own rows of each global
batch:

- ``init_data_parallel`` joins a rank to its group, the backend following
  the device (``nccl`` for one rank per card, ``gloo`` on the CPU); ranks
  that share one card ask for ``backend="gloo"`` themselves.  Nothing
  retries on another backend.
- ``launch`` starts the ranks with ``torch.multiprocessing.spawn``, joined
  through a ``file://`` store in a temporary directory (no TCP port to
  clash over), and returns each rank's return value; a rank that raises
  makes it raise.  One rank runs in the calling process.
- ``shard_rows``: rank r takes rows ``[r b / w, (r + 1) b / w)`` of a global
  batch of b rows, so ``--mesh dpN`` sees the global batches of one device.
- ``gather_rows``: the rows of every rank, in rank order, under autograd.
  Its backward sums the gradient over the ranks and returns the rank's own
  rows, so that DDP's average gives the global batch's gradient of a loss
  that couples the rows of the batch (the IBS alignment and contrastive
  losses).  Built on ``all_reduce``, which gloo also runs on CUDA tensors;
  an identity with one rank or none.
- The gather, the evaluation's gathers and the epoch's sums run on a group
  of their own, made when a rank joins: DDP reduces its gradient buckets
  asynchronously on the default group while the backward runs, and the
  gather's backward all_reduce then never queues among them.
- ``RowParallel`` runs a module on the rank's rows of a global batch (padded
  to a multiple of the ranks by repeating its last row) and gathers the
  outputs of the whole batch on every rank: evaluation scores the full
  validation set on every rank, and a rank with no valid rows computes
  only padding, which is cut off.

The mesh is dp x tp with the model axis innermost, as JAX's ``make_mesh_2d``
lays it out: global rank ``r = d tp + t`` is tp rank t of data rank d.  The
tp groups are ``{d tp + t : t}`` (the all_reduces of the Megatron layers,
``parallel/tensor.py``), the dp groups ``{d tp + t : d}``.  Everything on
the data axis runs over the rank's dp group, by its dp rank: ``shard_rows``'s
callers, ``gather_rows``, ``gather_uneven``, ``sum_over_ranks``,
``RowParallel`` and DDP.  Without a tp axis the dp group is the whole group.
``init_data_parallel`` makes the row group of a mesh without tp;
``join_mesh`` (the Trainer, the predictors and the entry points call it with
their ``--mesh`` spec) makes the tp, dp and row groups of the spec's tp
where the group holds another.  ``new_group`` is collective, so every rank
makes every group, in the same order, at the same point.
"""

from __future__ import annotations

import datetime
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from eyegaze_tpu_torch.parallel.sharding import parse_mesh_spec

TIMEOUT = datetime.timedelta(minutes=10)
# The group of this module's own collectives on the data axis (module
# docstring); set by init_data_parallel, cleared by leave.
_ROWS: Optional[dist.ProcessGroup] = None
# The mesh's tp size, the rank's tp group and its dp group (None: the whole
# group, where tp is 1).
_TP = 1
_TP_GROUP: Optional[dist.ProcessGroup] = None
_DP_GROUP: Optional[dist.ProcessGroup] = None
# On the CPU a rank is a process, not a device: an unsized "dp" asks for
# one, a sized "dpN" for N (parse_mesh_spec bounds N by this).
_CPU_RANKS = 1 << 16


def active() -> bool:
    """Whether this process is a rank of an initialized group."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of this process's group; (0, 1) without one."""
    return (dist.get_rank(), dist.get_world_size()) if active() else (0, 1)


def mesh_world(spec: Any, device: torch.device | str) -> int:
    """The ranks ``--mesh spec`` asks for on ``device``, dp x tp: on CUDA
    one per card the spec takes ("dp" takes every visible card, and a spec
    that needs more cards than there are raises), on the CPU the sizes the
    spec gives, an unsized dp counting 1 ("tp2" 2, "dp2,tp2" 4, "dp,tp2"
    2, "dp" 1)."""
    device = torch.device(device)
    if device.type == "cuda":
        dp, tp = parse_mesh_spec(spec, torch.cuda.device_count())
        return dp * tp
    dp, tp = parse_mesh_spec(spec, _CPU_RANKS)
    return (1 if dp == _CPU_RANKS // tp else dp) * tp


def _make_groups(tp: int, backend: str, timeout: datetime.timedelta) -> None:
    """The row group, and for tp > 1 the tp and dp groups, of a mesh with
    the model axis innermost (module docstring).  Collective."""
    global _ROWS, _TP, _TP_GROUP, _DP_GROUP
    rank, world = dist.get_rank(), dist.get_world_size()
    if world % tp:
        raise ValueError(f"a tp axis of {tp} does not divide the {world} ranks of the group")
    dp = world // tp
    _TP, _TP_GROUP, _DP_GROUP = tp, None, None
    if tp == 1:
        _ROWS = dist.new_group(backend=backend, timeout=timeout)
        return
    for d in range(dp):
        group = dist.new_group([d * tp + t for t in range(tp)], backend=backend, timeout=timeout)
        if rank // tp == d:
            _TP_GROUP = group
    for t in range(tp):
        ranks = [d * tp + t for d in range(dp)]
        group = dist.new_group(ranks, backend=backend, timeout=timeout)
        rows = dist.new_group(ranks, backend=backend, timeout=timeout)
        if rank % tp == t:
            _DP_GROUP, _ROWS = group, rows


def init_data_parallel(rank: int, world: int, device: torch.device | str, *,
                       backend: str | None = None, init_method: str,
                       timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Joins this process to the group as ``rank`` of ``world`` through
    ``init_method`` and returns its device (a bare "cuda" is the current
    card).  The backend follows the device unless given; the row group
    (module docstring) takes the same."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=timeout)
    _make_groups(1, backend, timeout)
    return device


def join_mesh(spec: Any) -> Tuple[int, int]:
    """(dp, tp) of ``spec`` parsed against the running group's world, whose
    size the spec's dp x tp must equal; makes the mesh's groups where the
    group holds another tp.  Called at the same point on every rank."""
    if not active():
        raise ValueError(f"mesh {spec!r} needs a running group: start the ranks with "
                         "eyegaze_tpu_torch.parallel.launch (the entry points' --mesh) or "
                         "torchrun (--multihost)")
    world = dist.get_world_size()
    dp, tp = parse_mesh_spec(spec, world)
    if dp * tp != world:
        raise ValueError(f"mesh spec {spec!r} is dp{dp},tp{tp}, {dp * tp} ranks, but the group "
                         f"holds {world}")
    if tp != _TP:
        _make_groups(tp, dist.get_backend(), TIMEOUT)
    return dp, tp


def leave() -> None:
    """Leaves the group that ``init_data_parallel`` joined."""
    global _ROWS, _TP, _TP_GROUP, _DP_GROUP
    _ROWS, _TP, _TP_GROUP, _DP_GROUP = None, 1, None, None
    dist.destroy_process_group()


def data_rank_and_world() -> tuple[int, int]:
    """(dp rank, dp size) of this process on the mesh; (0, 1) without a
    group."""
    rank, world = rank_and_world()
    return rank // _TP, world // _TP


def tp_rank_and_world() -> tuple[int, int]:
    """(tp rank, tp size) of this process on the mesh; (0, 1) without a
    group or a tp axis."""
    return (dist.get_rank() % _TP, _TP) if active() else (0, 1)


def tp_group() -> Optional[dist.ProcessGroup]:
    """The rank's tp group (None without a tp axis)."""
    return _TP_GROUP


def _rows_group() -> dist.ProcessGroup:
    if _ROWS is None:
        raise RuntimeError("this process joined its group without init_data_parallel, which "
                           "makes the group of the row gathers")
    return _ROWS


def _rank_device(device: str, rank: int) -> torch.device:
    """A bare "cuda" is one card per rank; an indexed one is shared."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank)
    return device


def _run_rank(rank, fn, world, device, backend, init_method, args):
    dev = init_data_parallel(rank, world, _rank_device(device, rank), backend=backend,
                             init_method=init_method)
    try:
        return fn(rank, world, dev, *args)
    finally:
        leave()


def _spawned(index, first, fn, world, device, backend, init_method, threads, out_dir, args):
    rank = first + index
    torch.set_num_threads(threads)
    result = _run_rank(rank, fn, world, device, backend, init_method, args)
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")


def launch(fn: Callable, world: int, *args, device: torch.device | str = "cpu",
           backend: str | None = None, store_dir: str | Path | None = None,
           here: bool = False) -> List[Any]:
    """``fn(rank, world, device, *args)`` on ``world`` ranks of one group
    (``fn`` joins a tp mesh with ``join_mesh``); returns each rank's return
    value, in rank order.

    Ranks are spawned processes (``fn`` and ``args`` must pickle), each with
    the caller's intra-op thread count; with one rank, or with ``here``,
    rank 0 runs in this process (a server's front end).  On ``device``
    "cuda" rank r takes card r; an indexed card ("cuda:0") is shared by
    every rank and needs ``backend="gloo"``.  The group meets through a
    ``file://`` store in a temporary directory under ``store_dir``.  A rank
    that raises makes ``launch`` raise (the others are stopped)."""
    if world < 1:
        raise ValueError(f"launch needs at least one rank, got {world}")
    if active():
        raise RuntimeError("launch called from a rank of a running group")
    device = str(device)
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = f"file://{Path(tmp).absolute() / 'store'}"
        if world == 1:
            return [_run_rank(0, fn, world, device, backend, init_method, args)]
        first = 1 if here else 0
        spawn_args = (first, fn, world, device, backend, init_method, torch.get_num_threads(),
                      tmp, args)
        if not here:
            torch.multiprocessing.spawn(_spawned, args=spawn_args, nprocs=world, join=True)
            return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                    for r in range(world)]
        others = torch.multiprocessing.start_processes(
            _spawned, args=spawn_args, nprocs=world - 1, join=False, start_method="spawn")
        try:
            mine = _run_rank(0, fn, world, device, backend, init_method, args)
        except BaseException:
            for p in others.processes:
                p.terminate()
            raise
        while not others.join():
            pass
        return [mine] + [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                         for r in range(1, world)]


def _fit_rank(rank, world, device, entry, args, kwargs):
    result = entry(*args, device=device, **kwargs)
    return {k: result[k] for k in ("best_metric", "history")}


def fit_on_ranks(entry: Callable, world: int, device: torch.device | str, *args,
                 **kwargs) -> Dict[str, Any]:
    """``entry(*args, device=<the rank's device>, **kwargs)``, a training
    entry point's ``run``, on ``world`` ranks (``launch``; the entry's
    Trainer joins its mesh spec); returns rank 0's ``best_metric`` and
    ``history``."""
    return launch(_fit_rank, world, entry, args, kwargs, device=device)[0]


def require_divisible(rows: int, world: int, what: str = "train batch") -> None:
    """Raises unless a ``what`` of ``rows`` rows splits evenly over ``world``
    ranks (the JAX trainer replicates such a batch instead)."""
    if rows % world:
        raise ValueError(f"a {what} of {rows} rows does not split over {world} ranks; "
                         f"data-parallel training needs a batch size that is a multiple of "
                         f"{world}")


def shard_rows(batch: Any, rank: int, world: int) -> Any:
    """Rows ``[rank b / world, (rank + 1) b / world)`` of every array of
    ``batch`` (an array, a tensor or a dict of them); b must divide."""
    if isinstance(batch, dict):
        return {k: shard_rows(v, rank, world) for k, v in batch.items()}
    rows = batch.shape[0]
    require_divisible(rows, world)
    per = rows // world
    return batch[rank * per:(rank + 1) * per]


def _comm_dtype(dtype: torch.dtype) -> torch.dtype:
    """A dtype every backend sums exactly for a gather (one nonzero addend
    per entry): half floats go as float32, booleans as bytes."""
    if dtype in (torch.float16, torch.bfloat16):
        return torch.float32
    return torch.uint8 if dtype == torch.bool else dtype


def _comm_device(t: torch.Tensor) -> torch.device:
    """NCCL sums only CUDA tensors; gloo sums them where they lie."""
    if t.device.type != "cuda" and dist.get_backend(_rows_group()) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _gather(x: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
    """Every dp rank's rows of ``x`` (dp rank r holding ``counts[r]``), in
    rank order, by one all_reduce of a zero-filled buffer."""
    rank = data_rank_and_world()[0]
    start = sum(counts[:rank])
    buf = torch.zeros((sum(counts),) + tuple(x.shape[1:]), dtype=_comm_dtype(x.dtype),
                      device=_comm_device(x))
    buf[start:start + counts[rank]] = x
    dist.all_reduce(buf, group=_rows_group())
    return buf.to(device=x.device, dtype=x.dtype)


def sum_over_ranks(values: Sequence[Any], device: torch.device | str = "cpu") -> List[float]:
    """Each of ``values`` (numbers or scalar tensors) summed over the dp
    ranks, in float64, by one all_reduce; the values themselves without a
    group."""
    if not values:
        return []
    t = torch.stack([torch.as_tensor(v, dtype=torch.float64, device=device).reshape(())
                     for v in values])
    if data_rank_and_world()[1] > 1:
        t = t.to(_comm_device(t))
        dist.all_reduce(t, group=_rows_group())
    return t.tolist()


def gather_uneven(x: torch.Tensor) -> torch.Tensor:
    """Every dp rank's rows of ``x`` in rank order, whatever each rank holds
    (0 rows included; the other dims and the dtype must agree)."""
    rank, world = data_rank_and_world()
    if world == 1:
        return x
    counts = [int(c) for c in sum_over_ranks(
        [x.shape[0] if r == rank else 0 for r in range(world)], device=x.device)]
    return _gather(x, counts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _gather(x, [x.shape[0]] * data_rank_and_world()[1])

    @staticmethod
    def backward(ctx, grad):
        # Each rank holds the gradient of its own copy of the gathered
        # rows; the gathered tensor's gradient is their sum.
        total = grad.to(device=_comm_device(grad), dtype=_comm_dtype(grad.dtype), copy=True)
        dist.all_reduce(total, group=_rows_group())
        start = data_rank_and_world()[0] * ctx.rows
        return total[start:start + ctx.rows].to(device=grad.device, dtype=grad.dtype)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of ``x`` of every dp rank, in rank order (every rank holds
    the same number), with a gradient: see the module docstring.  ``x``
    itself with one dp rank or no group."""
    if data_rank_and_world()[1] == 1:
        return x
    return _GatherRows.apply(x)


def data_parallel_module(module: torch.nn.Module, device: torch.device, *,
                         find_unused_parameters: bool = False,
                         ) -> torch.nn.parallel.DistributedDataParallel:
    """``module`` in DDP over the rank's dp group: dp rank 0's parameters
    broadcast to the group at construction, gradients averaged over it in
    the backward.  Buffers are constants and are not broadcast.

    ``find_unused_parameters`` is for a loss that leaves out an output
    computed from parameters (the flagship's IBS logits without the IBS
    cross entropy): DDP then searches the graph each step for the
    parameters that get no gradient.  Without it, such a parameter's bucket
    is never reduced (``Trainer.train_step`` raises).  ``static_graph`` is
    no way around the search: its first step passes every output through
    DDP's sink, so the IBS head counts as used, and from the second step
    on the bucket that holds the head is never reduced, its gradients left
    rank-local (two gloo ranks on the CPU, with or without the row gather
    in the loss)."""
    return torch.nn.parallel.DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=find_unused_parameters,
        process_group=_DP_GROUP)


def barrier() -> None:
    if active() and dist.get_world_size() > 1:
        dist.barrier()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class RowParallel(torch.nn.Module):
    """``module`` over the dp rank's rows of a global batch, its outputs of
    the whole batch gathered on every rank (see the module docstring); the
    tp ranks of one dp rank take the same rows.  Tensor
    arguments whose leading dim is the batch's are split; outputs whose
    leading dim is the rank's rows are gathered, others (a scalar) pass as
    the rank computed them."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module

    def forward(self, *args, **kwargs):
        rank, world = data_rank_and_world()
        first = next(t for t in (*args, *kwargs.values()) if isinstance(t, torch.Tensor))
        rows = first.shape[0]
        per = -(-rows // world)

        def take(t):
            if not (isinstance(t, torch.Tensor) and t.ndim and t.shape[0] == rows):
                return t
            if per * world > rows:
                t = torch.cat([t, t[-1:].expand(per * world - rows, *t.shape[1:])])
            return t[rank * per:(rank + 1) * per]

        def gather(t):
            if isinstance(t, torch.Tensor) and t.ndim and t.shape[0] == per:
                return gather_rows(t)[:rows]
            return t

        out = self.module(*_map(take, list(args)), **_map(take, kwargs))
        return _map(gather, out)
