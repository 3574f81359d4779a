"""The device-mesh spec of the entry points' ``--mesh`` and the rules of
tensor parallelism.

The port's copy of ``parse_mesh_spec`` and ``TP_RULES`` from
``eyegaze_tpu/parallel/sharding.py``: the same grammar (``True``, ``"dp"``,
``"dpN"``, ``"tpN"``, ``"dpN,tpM"``) and the same errors, and the same
layers sharded Megatron-style over the model axis:

- the ViT's attention (``attn.qkv`` by heads, ``attn.proj`` by its input
  columns) and MLP (``mlp.fc1`` by columns, ``mlp.fc2`` by rows), JAX's
  ``attn/(query|key|value)``, ``attn/out`` and ``mlp/fc1|fc2`` rules;
- HyperEEG's graph attention (``attn.{query,key,value}`` by columns,
  ``attn.out`` by rows), which JAX's ``attn/(query|key|value)`` rule also
  matches; its ``cross`` attention and its ``ff1``/``ff2`` stay replicated,
  as in JAX;
- the shared stack's attention wherever it sits (``{q,k,v}_proj`` by
  columns, ``out_proj`` by rows: JAX's ``q_proj`` rules match any path,
  the flagship's cross-brain attention included) and its feed-forward
  (``ffn.linear1`` by columns, ``ffn.linear2`` by rows).

A row layer's bias is replicated and added once, after the reduce.
Everything else is replicated: layer norms, embeddings, the connectivity
and CNN front ends, the heads.

The port's divisibility rule.  A rule applies to a whole module, not a
leaf: a Megatron attention split hands each rank whole heads, so an
attention module shards only where ``num_heads % tp == 0``, and a
feed-forward or MLP only where its hidden width divides tp.  JAX tests
each leaf on its own dimension, and its ``q_proj`` rule tests ``E % tp``
where the port tests the heads: at 8 heads of width 32 and tp 16, JAX
shards ``q_proj`` (256 % 16 == 0) and the port replicates the module.
The numbers are the same either way; only the memory differs.
"""

from __future__ import annotations

import re
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch


class Layout(NamedTuple):
    """How a module of one class shards: its column-parallel children, its
    row-parallel child, the groups a column weight's rows fall in (3 for
    the ViT's fused ``qkv``, laid out [q | k | v], each [H][hd]), and
    whether it splits heads (else a hidden width)."""

    columns: Tuple[str, ...]
    row: str
    groups: int
    heads: bool


LAYOUTS: Dict[str, Layout] = {
    "MultiHeadAttention": Layout(("q_proj", "k_proj", "v_proj"), "out_proj", 1, True),
    "Attention": Layout(("qkv",), "proj", 3, True),
    "FlaxAttention": Layout(("query", "key", "value"), "out", 1, True),
    "FeedForward": Layout(("linear1",), "linear2", 1, False),
    "Mlp": Layout(("fc1",), "fc2", 1, False),
}

# (module path regex, module class): the first rule that matches a module's
# path and class shards it, where the divisibility rule allows.
TP_RULES: Tuple[Tuple[str, str], ...] = (
    (r"(^|\.)attn$", "Attention"),  # ViT blocks
    (r"(^|\.)attn$", "FlaxAttention"),  # HyperEEG's graph block, not its cross
    (r"(^|\.)mlp$", "Mlp"),
    (r"", "MultiHeadAttention"),  # every attention of the shared stack
    (r"(^|\.)ffn$", "FeedForward"),
)


class Shard(NamedTuple):
    """A sharded parameter: split along ``dim`` into tp pieces within each
    of ``groups`` equal blocks of that dim."""

    dim: int
    groups: int


def _width(module: torch.nn.Module, layout: Layout) -> int:
    """What tp must divide: the heads, or the hidden width."""
    if layout.heads:
        return module.num_heads
    return getattr(module, layout.columns[0]).out_features


def tp_plan(model: torch.nn.Module, tp: int) -> Dict[str, Layout]:
    """The modules of ``model`` that shard at ``tp`` (path -> layout), by
    ``TP_RULES`` and the divisibility rule (module docstring).  Empty at tp
    1."""
    if tp <= 1:
        return {}
    plan = {}
    for path, module in model.named_modules():
        cls = type(module).__name__
        if getattr(module, "tp", 1) > 1:
            raise ValueError(f"{path or 'the model'} is already sharded (tp={module.tp})")
        for pattern, rule_cls in TP_RULES:
            if cls == rule_cls and re.search(pattern, path):
                layout = LAYOUTS[cls]
                if _width(module, layout) % tp == 0:
                    plan[path] = layout
                break
    return plan


def shard_report(model: torch.nn.Module, tp: int) -> Dict[str, Shard]:
    """Which parameters of a whole (unsharded) ``model`` shard at ``tp``,
    and how: the counterpart of JAX's ``partition_spec_for`` over a
    parameter tree.  A column layer's weight and bias split on dim 0 (the
    output features), a row layer's weight on dim 1; every parameter not
    named is replicated."""
    out = {}
    for path, layout in tp_plan(model, tp).items():
        prefix = f"{path}." if path else ""
        for name in layout.columns:
            out[f"{prefix}{name}.weight"] = Shard(0, layout.groups)
            out[f"{prefix}{name}.bias"] = Shard(0, layout.groups)
        out[f"{prefix}{layout.row}.weight"] = Shard(1, 1)
    return out


def parse_mesh_spec(spec: Any, n_devices: Optional[int] = None) -> Tuple[int, int]:
    """Parse a mesh spec into (dp, tp) sizes over ``n_devices`` devices
    (default: the visible CUDA cards).

    Accepts ``True``/``"dp"`` (all devices data-parallel), ``"tp4"`` (pure
    tensor parallel), ``"dp2,tp4"`` (explicit 2-D), or ``"dp4"``.  An
    unsized ``dp`` absorbs the devices the other axis leaves free.  A spec
    that needs more devices than there are raises.
    """
    if n_devices is None:
        n_devices = torch.cuda.device_count()
    if spec is True or spec is None or spec == "":
        return n_devices, 1
    if not isinstance(spec, str):
        raise ValueError(f"mesh spec must be a string or True, got {spec!r}")
    dp: Optional[int] = None
    tp = 1
    for token in spec.split(","):
        token = token.strip().lower()
        if not token:
            continue
        m = re.fullmatch(r"(dp|tp)(\d*)", token)
        if not m:
            raise ValueError(f"bad mesh token {token!r} (want dp[N] / tp[N])")
        size = int(m.group(2)) if m.group(2) else None
        if m.group(1) == "dp":
            dp = size  # None = fill
        else:
            if size is None:
                raise ValueError("tp needs an explicit size, e.g. tp2")
            tp = size
    if dp is None:
        dp = max(n_devices // tp, 1)
    if dp * tp > n_devices:
        raise ValueError(
            f"mesh spec {spec!r} needs {dp * tp} devices, have {n_devices}")
    return dp, tp
