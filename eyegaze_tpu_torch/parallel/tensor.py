"""Tensor parallelism: Megatron column and row layers with the all_reduces
written out.

The counterpart of ``shard_tp`` in ``eyegaze_tpu/parallel/sharding.py``.
There GSPMD inserts every collective from the parameters' shardings; here
each sharded block (an attention or a feed-forward, ``sharding.TP_RULES``)
runs on the tp group (``mesh.py``) as Megatron lays it out:

    x --copy--> column layers (the rank's heads / hidden) --> row layer
      --reduce--> + bias

- *copy into the tp region* (``copy_to_region``): identity forward,
  ``all_reduce`` of the gradient over the tp group in the backward.  A
  block takes one copy per distinct input: self-attention's q, k and v
  share one, cross-attention takes two (x and memory).
- *reduce from the tp region* (inside ``RowParallelDense``): ``all_reduce``
  forward, identity backward.

So a block costs one ``all_reduce`` in the forward pass and one per copy in
the backward pass.  ``all_reduce_count`` counts them, and nothing else.

``ColumnParallelDense`` holds the rank's rows of a ``Dense`` (its output
features; for the ViT's fused ``qkv`` the rank's heads in each of the q, k
and v thirds), ``RowParallelDense`` the rank's columns (its input
features), and adds the bias once, after the reduce.  Both subclass
``Dense``, so the compute type follows it.  The reduce sums float32
partial products whatever the compute type: a bf16 row layer multiplies
its bf16 operands in float32 (each product exact), the ranks' partial sums
are added in float32, and the result, plus the bias, is rounded to bf16
once, as one process's bf16 matmul (float32 accumulation, one rounding)
does; so the layer is at least as precise as one process.  (gloo also
sums bf16 CUDA tensors badly or not at all.)

``shard_tp_`` turns a built model, loaded with its full weights, into the
rank's shard in place: the sharded ``Dense`` children are replaced, the
parameters kept as the same objects with their data cut (an optimizer
built before still holds them; AdamW's moments, made at its first step,
are then per shard, as ``shard_tp`` shards them in JAX), and each sharded
parameter marked with its ``Shard``.  ``full_state_dict`` and
``full_optimizer_state`` gather the shards back into the reference-named
full state; ``load_full_state_dict`` and ``load_full_optimizer_state``
cut a full state into the rank's shards.

Dropout under tp.  Replicated activations (the residual stream, the heads'
inputs, the ViT's broadcast attention mask, shared by every head) draw from
the device's default generator, which the trainer seeds with ``seed +
dp_rank``: the tp ranks of one data rank draw the same masks, and the
replicated parameters stay equal.  Inside a sharded region (the attention
weights of the rank's heads, the feed-forward's hidden units) each rank
draws its own slice from a second generator (``seed_region``, seeded with
``seed + rank``), as Megatron's RNG tracker does.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from eyegaze_tpu_torch.models.transformer import Dense, cast_params
from eyegaze_tpu_torch.parallel import mesh
from eyegaze_tpu_torch.parallel.sharding import Shard, tp_plan

# The tp all_reduces of the layers: each reduce's forward and each copy's
# backward adds one.
all_reduce_count = 0
# The generators of the sharded regions' dropout, by device.
_REGION: Dict[torch.device, torch.Generator] = {}


def _comm_device(t: torch.Tensor, group) -> torch.device:
    """NCCL sums only CUDA tensors; gloo sums them where they lie."""
    if t.device.type != "cuda" and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _sum_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the tp group, in float32, on ``x``'s device."""
    group = mesh.tp_group()
    buf = x.to(device=_comm_device(x, group), dtype=torch.float32, copy=True)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        global all_reduce_count
        all_reduce_count += 1
        return _sum_f32(grad).to(grad.dtype)


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        global all_reduce_count
        all_reduce_count += 1
        return _sum_f32(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


def copy_to_region(x: torch.Tensor) -> torch.Tensor:
    """``x`` into the tp region: itself, its gradient summed over the tp
    group."""
    return _CopyToRegion.apply(x)


class ColumnParallelDense(Dense):
    """The rank's output features of a ``Dense``: its forward is
    ``Dense``'s; the block feeds it a ``copy_to_region`` input."""


class RowParallelDense(Dense):
    """The rank's input features of a ``Dense``: float32 partial products,
    summed over the tp group, plus the bias, in the compute type (module
    docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        weight, bias = cast_params(self, (self.weight, self.bias), dt)
        partial = F.linear(x.to(dt).float(), weight.float())
        return (_ReduceFromRegion.apply(partial) + bias.float()).to(dt)


def seed_region(device: torch.device | str, seed: int) -> None:
    """Seeds the generator of the sharded regions' dropout on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _REGION[device] = torch.Generator(device=device).manual_seed(seed)


def region_dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """Inverted dropout on the activations of a sharded region, drawn from
    the region's generator (``seed_region``; seeded with the global rank
    where no one seeded it)."""
    if not training or p == 0.0:
        return x
    if x.device not in _REGION:
        seed_region(x.device, mesh.rank_and_world()[0])
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=_REGION[x.device])
    return x * keep / (1.0 - p)


def take_shard(t: torch.Tensor, shard: Shard, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s piece of a full tensor."""
    d, g = shard
    shape = t.shape
    n = shape[d] // g // tp
    v = t.reshape(*shape[:d], g, shape[d] // g, *shape[d + 1:])
    return v.narrow(d + 1, rank * n, n).reshape(*shape[:d], g * n, *shape[d + 1:]).clone()


def gather_shard(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The full tensor of every tp rank's piece ``t``, in rank order, by one
    all_reduce of a zero-filled buffer (exact: one nonzero addend)."""
    rank, tp = mesh.tp_rank_and_world()
    group = mesh.tp_group()
    d, g = shard
    shape = t.shape
    n = shape[d] // g
    buf = torch.zeros(*shape[:d], g, n * tp, *shape[d + 1:], dtype=t.dtype,
                      device=_comm_device(t, group))
    buf.narrow(d + 1, rank * n, n).copy_(t.reshape(*shape[:d], g, n, *shape[d + 1:]))
    dist.all_reduce(buf, group=group)
    return buf.reshape(*shape[:d], g * n * tp, *shape[d + 1:]).to(t.device)


def _convert(dense: Dense, cls, shard: Shard, rank: int, tp: int) -> Dense:
    """``dense`` as ``cls`` holding the rank's piece of its weight (and, for
    a column layer, of its bias); the parameter objects are kept."""
    weight, bias = dense.weight, dense.bias
    with torch.no_grad():
        weight.data = take_shard(weight.data, shard, rank, tp)
        weight.tp_shard = shard
        if shard.dim == 0:
            bias.data = take_shard(bias.data, shard, rank, tp)
            bias.tp_shard = shard
    out = cls(weight.shape[1], weight.shape[0], device=torch.device("meta"),
              dtype=dense.compute_dtype)
    out.weight, out.bias = weight, bias
    out.train(dense.training)
    return out


def shard_tp_(model: torch.nn.Module, rank: int, tp: int) -> Dict[str, object]:
    """Turns ``model`` (built whole, its full weights loaded) into tp rank
    ``rank``'s shard in place, by ``sharding.TP_RULES`` (module
    docstring); returns the plan (module path -> layout).  A no-op at tp
    1."""
    plan = tp_plan(model, tp)
    for path, layout in plan.items():
        module = model.get_submodule(path)
        for name in layout.columns:
            setattr(module, name, _convert(getattr(module, name), ColumnParallelDense,
                                           Shard(0, layout.groups), rank, tp))
        setattr(module, layout.row, _convert(getattr(module, layout.row), RowParallelDense,
                                             Shard(1, 1), rank, tp))
        if layout.heads:
            module.num_heads //= tp
        module.tp = tp
    return plan


def _shards(model: torch.nn.Module) -> Dict[str, Shard]:
    return {k: p.tp_shard for k, p in model.named_parameters() if hasattr(p, "tp_shard")}


def is_sharded(p: torch.Tensor) -> bool:
    return hasattr(p, "tp_shard")


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s reference-named full ``state_dict`` (detached), the
    shards gathered over the tp group; every tp rank of the group calls it.
    ``model.state_dict()`` itself where nothing is sharded."""
    shards = _shards(model)
    return {k: gather_shard(v.detach(), shards[k]) if k in shards else v.detach()
            for k, v in model.state_dict().items()}


def load_full_state_dict(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Loads a full ``state`` into the sharded ``model`` (strict): each
    sharded entry cut to the rank's piece."""
    shards = _shards(model)
    rank, tp = mesh.tp_rank_and_world()
    model.load_state_dict({k: take_shard(v, shards[k], rank, tp) if k in shards else v
                           for k, v in state.items()}, strict=True)


def _optimizer_shards(optimizer) -> Dict[int, Shard]:
    """AdamW's parameter indices (its ``state_dict``'s numbering: the
    groups' parameters in order) of the sharded parameters."""
    params = [p for g in optimizer.adamw.param_groups for p in g["params"]]
    return {i: p.tp_shard for i, p in enumerate(params) if is_sharded(p)}


def _map_moments(state: dict, shards: Dict[int, Shard], fn) -> dict:
    """``state`` (an ``Optimizer.state_dict()``) with ``fn(tensor, shard)``
    applied to every moment of a sharded parameter, in index order."""
    adamw = state["adamw"]
    moments = {}
    for i in sorted(adamw["state"]):
        entry = adamw["state"][i]
        moments[i] = {k: fn(v, shards[i]) if i in shards and torch.is_tensor(v) and v.ndim
                      else v for k, v in entry.items()}
    return {**state, "adamw": {**adamw, "state": moments}}


def full_optimizer_state(optimizer) -> dict:
    """``optimizer.state_dict()`` with the sharded parameters' moments
    gathered over the tp group (every tp rank calls it): one process's."""
    shards = _optimizer_shards(optimizer)
    state = optimizer.state_dict()
    return _map_moments(state, shards, gather_shard) if shards else state


def load_full_optimizer_state(optimizer, state: dict) -> None:
    """Loads a full optimizer ``state`` (one process's) into the rank's
    optimizer: each sharded parameter's moments cut to its piece."""
    shards = _optimizer_shards(optimizer)
    rank, tp = mesh.tp_rank_and_world()
    if shards:
        state = _map_moments(state, shards, lambda v, s: take_shard(v, s, rank, tp))
    optimizer.load_state_dict(state)


def average_replicated_grads_(model: torch.nn.Module, tp: int) -> None:
    """The gradients of ``model``'s replicated parameters averaged over the
    tp group in place, by one all_reduce.  Every tp rank computes the same
    gradient for them in exact arithmetic, and on the CPU bit for bit; on a
    card a backward kernel that sums with atomics (cuDNN's convolution
    weight gradients) gives each rank other roundings, and the replicated
    parameters would drift apart.  Not counted in ``all_reduce_count``."""
    grads = [p.grad for p in model.parameters() if p.grad is not None and not is_sharded(p)]
    if not grads:
        return
    flat = _sum_f32(torch.cat([g.reshape(-1).float() for g in grads])) / tp
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def sharded_sum(local: torch.Tensor) -> torch.Tensor:
    """``local`` summed over the tp group in float32, not counted among the
    layers' all_reduces (the clip norm's squares)."""
    return _sum_f32(local)

