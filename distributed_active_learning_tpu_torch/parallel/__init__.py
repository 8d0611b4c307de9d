"""Distribution layer of the port: device meshes, placement, collectives
and the sharded round (the port of ``parallel/``).

Axes, as in the JAX package:
  ``data``  — pool rows (the reference's RDD partitioning of the pool)
  ``model`` — the tree (ensemble) axis

One process drives every shard of the mesh, as JAX's single controller does.
``multihost.py`` (``torch.distributed`` across processes) and ``global_put``
wait for the multi-process mesh (ROADMAP).
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
