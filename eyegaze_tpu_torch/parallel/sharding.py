"""The device-mesh spec of the entry points' ``--mesh``.

The port's copy of ``parse_mesh_spec`` from ``eyegaze_tpu/parallel/
sharding.py``: the same grammar (``True``, ``"dp"``, ``"dpN"``, ``"tpN"``,
``"dpN,tpM"``) and the same errors.  The port has the data-parallel axis
only (``parallel/mesh.py``): a spec with a tensor-parallel axis larger than
1 parses, then is refused, until the Megatron layers (``TP_RULES`` and
``shard_tp`` in the JAX package) are ported.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Tuple

TP_NOT_PORTED = ("tensor parallelism (tp > 1) is not ported yet: ROADMAP §1 item 5, Megatron "
                 "column and row layers with an explicit all_reduce; use a dp-only spec")


def parse_mesh_spec(spec: Any, n_devices: Optional[int] = None) -> Tuple[int, int]:
    """Parse a mesh spec into (dp, tp) sizes over ``n_devices`` devices
    (default: the visible CUDA cards).

    Accepts ``True``/``"dp"`` (all devices data-parallel), ``"dp4"``,
    ``"tp4"`` and ``"dp2,tp4"``; an unsized ``dp`` absorbs the devices the
    other axis leaves free.  A spec that needs more devices than there are
    raises, and so does any tp > 1 (``TP_NOT_PORTED``).
    """
    if n_devices is None:
        import torch

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
    if tp > 1:
        raise ValueError(f"mesh spec {spec!r}: {TP_NOT_PORTED}")
    return dp, tp
