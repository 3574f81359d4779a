"""Data and tensor parallelism for the port over ``torch.distributed``.

The counterpart of ``eyegaze_tpu/parallel/``: the mesh spec and the tensor-
parallel rules (``sharding.py``), the ranks, the mesh's groups, row shards,
row gather and DDP (``mesh.py``), the Megatron column and row layers and
the conversion of a built model into a rank's shard (``tensor.py``, imported
where it is used: it imports the models) and the torchrun contract
(``multihost.py``).
"""

from eyegaze_tpu_torch.parallel.mesh import (
    RowParallel,
    active,
    barrier,
    data_parallel_module,
    data_rank_and_world,
    fit_on_ranks,
    gather_rows,
    gather_uneven,
    init_data_parallel,
    join_mesh,
    launch,
    leave,
    mesh_world,
    rank_and_world,
    require_divisible,
    shard_rows,
    sum_over_ranks,
    tp_group,
    tp_rank_and_world,
)
from eyegaze_tpu_torch.parallel.multihost import (
    all_processes_concat,
    common_steps,
    global_batch_size,
    initialize_multihost,
    local_device,
    process_shard_bounds,
)
from eyegaze_tpu_torch.parallel.sharding import (
    LAYOUTS,
    TP_RULES,
    Shard,
    parse_mesh_spec,
    shard_report,
    tp_plan,
)
