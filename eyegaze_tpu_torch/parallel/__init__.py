"""Data parallelism for the port over ``torch.distributed``.

The counterpart of ``eyegaze_tpu/parallel/``'s data-parallel half: the mesh
spec (``sharding.py``), the ranks, row shards, row gather and DDP
(``mesh.py``) and the torchrun contract (``multihost.py``).  Tensor
parallelism (``TP_RULES``, ``shard_tp``) is not ported; a spec with tp > 1
is refused.
"""

from eyegaze_tpu_torch.parallel.mesh import (
    RowParallel,
    active,
    barrier,
    data_parallel_module,
    fit_on_ranks,
    gather_rows,
    gather_uneven,
    init_data_parallel,
    launch,
    leave,
    mesh_world,
    rank_and_world,
    require_divisible,
    shard_rows,
    sum_over_ranks,
)
from eyegaze_tpu_torch.parallel.multihost import (
    all_processes_concat,
    common_steps,
    global_batch_size,
    initialize_multihost,
    local_device,
    process_shard_bounds,
)
from eyegaze_tpu_torch.parallel.sharding import TP_NOT_PORTED, parse_mesh_spec
