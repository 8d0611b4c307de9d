"""Per-shard kernels and the sharded AL round (the port of
``parallel/kernels.py``).

The JAX package spells its hot reductions out with ``shard_map`` (each
device evaluates its pool block against its tree shard, one ``psum`` over
``model``) and lets GSPMD partition the rest of the round. Here one process
launches each shard's work on the shard's device (:func:`per_shard`), adds
the model shards in order (``collectives.vector_accumulate``) and joins the
row blocks in shard order on the mesh's first device, where the round's
global steps run (:func:`make_sharded_round_fn`). ``sharded_similarity_mass``
waits for the density slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib
from distributed_active_learning_tpu_torch.parallel.collectives import vector_accumulate


def per_shard(forest, x, fn: Callable):
    """``fn(local_forest, x_block)`` on every (data, model) shard of a
    ``ShardedPallasForest``, each on the shard's device: returns the
    ``[data][model]`` grid of results and the logical row count of ``x`` (a
    row-sharded pool, or a plain tensor that is padded and split here)."""
    xs = mesh_lib.shard_rows(x, forest.mesh, replicate=True)
    if len(xs.blocks) != len(forest.shards):
        raise ValueError(
            f"x is sharded over {len(xs.blocks)} data shards, the forest over {len(forest.shards)}")
    grid = [[fn(f, xs.block(s, m)) for m, f in enumerate(row)]
            for s, row in enumerate(forest.shards)]
    return grid, xs.n_rows


def join_blocks(blocks, mesh: mesh_lib.Mesh, n: int) -> torch.Tensor:
    """Per-data-shard blocks joined in shard order on the mesh's first
    device, cut to the logical ``n`` rows."""
    return torch.cat([b.to(mesh.first) for b in blocks])[:n]


def sharded_votes(mesh: mesh_lib.Mesh):
    """Per-point positive-vote counts with the pool's rows over ``data`` and
    the trees over ``model``: each shard evaluates its tree shard on its row
    block with the forest's kernel (K1), one sum over ``model`` completes the
    counts, and the blocks are joined in shard order on the first device.

    Returns ``(forest, x) -> votes [n] int32`` for a pallas forest, global or
    already sharded."""
    from distributed_active_learning_tpu_torch.ops.trees_pallas import (
        attach_mesh,
        predict_leaves_pallas,
    )

    def local_votes(f, xb):
        return (predict_leaves_pallas(f, xb) > 0.5).sum(dim=1, dtype=torch.int32)

    def votes_fn(forest, x) -> torch.Tensor:
        grid, n = per_shard(attach_mesh(forest, mesh), x, local_votes)
        return join_blocks([vector_accumulate(row) for row in grid], mesh, n)

    return votes_fn


def make_sharded_round_fn(strategy, window_size: int, mesh: mesh_lib.Mesh, fused: bool = False):
    """The AL round over a device mesh: ``(forest, state, aux) -> (new_state,
    picked, scores)`` for a pool placed by ``parallel.mesh.shard_pool_state``
    and a forest placed by ``shard_forest`` + ``attach_mesh``.

    The explicit counterpart of the GSPMD round: the unfused round's votes
    are counted per shard and added over ``model`` (:func:`sharded_votes`),
    the block scores are joined in shard order on the first device (scores
    are elementwise in the votes, so joining votes or scores gives the same
    bits), and the global ``select_top_k``/``select_bottom_k`` runs there on
    the gathered mask: the all-gather GSPMD inserts for ``lax.top_k``. The
    fused round selects per shard and merges on the ring
    (``ops.round_fused._sharded_score_select``).
    """
    from distributed_active_learning_tpu_torch.runtime.loop import make_round_fn

    round_fn = make_round_fn(strategy, window_size, fused=fused)

    def sharded_round(forest, state, aux):
        x = state.x
        if not isinstance(x, mesh_lib.Sharded) or len(x.blocks) != mesh.shape[mesh_lib.AXIS_DATA]:
            raise ValueError(
                f"the pool is not sharded over this mesh's {mesh.shape[mesh_lib.AXIS_DATA]} data "
                "shards; place it with parallel.mesh.shard_pool_state"
            )
        return round_fn(forest, state, aux)

    return sharded_round
