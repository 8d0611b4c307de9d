"""Distribution layer of the port: device meshes, placement, collectives
and the sharded round (the port of ``parallel/``).

Axes, as in the JAX package:
  ``data``  — pool rows (the reference's RDD partitioning of the pool)
  ``model`` — the tree (ensemble) axis

One process drives every shard of the mesh, as JAX's single controller does,
or, in a multi-process job (``multihost.py``: a gloo process group, the
launch contract of the JAX package's env trio or ``torchrun``), each process
drives its own rows of the global mesh and ``global_put`` places the same
host value on every rank.
"""

from distributed_active_learning_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_MODEL,
    Mesh,
    Sharded,
    ShardedForest,
    constrain_forest,
    forest_tree_specs,
    gather,
    global_put,
    make_mesh,
    mesh_of,
    shard_fill_watermark,
    shard_forest,
    shard_pool_state,
    shard_rows,
)
from distributed_active_learning_tpu_torch.parallel.kernels import (
    make_sharded_round_fn,
    per_shard,
    sharded_leaves,
    sharded_similarity_mass,
    sharded_votes,
)
from distributed_active_learning_tpu_torch.parallel.collectives import (
    exchange_blocks,
    gather_fills,
    global_count,
    masked_mean,
    vector_accumulate,
)
from distributed_active_learning_tpu_torch.parallel.multihost import (
    gather_scalar_gauges,
    host_np,
    is_primary,
    maybe_initialize,
    process_count,
    process_index,
)
