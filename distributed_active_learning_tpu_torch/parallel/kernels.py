"""Per-shard kernels and the sharded AL round (the port of
``parallel/kernels.py``).

The JAX package spells its hot reductions out with ``shard_map`` (each
device evaluates its pool block against its tree shard, one ``psum`` over
``model``; the similarity mass's pooled vector, one ``psum`` over ``data``)
and lets GSPMD partition the rest of the round. Here one process launches
each shard's work on the shard's device (:func:`per_shard`), adds the
shards of an axis in order (``collectives.vector_accumulate``) and joins the
row blocks in shard order on the mesh's first device, where the round's
global steps run (:func:`make_sharded_round_fn`). Over several processes
each runs its own cells only (whole rows, a part of one, or cells that
cross a row boundary); a row whose cells lie on several ranks is
completed over the row group (the sum over ``model`` in model order,
``collectives.row_accumulate``; the leaf blocks joined in tree order), and
the sums over ``data`` and the joins all-gather the other rows, each from
its owner (``collectives``, ``multihost``), so every rank runs the round's
global steps on the same values.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib
from distributed_active_learning_tpu_torch.parallel.collectives import (
    owner_gather,
    row_accumulate,
    vector_accumulate,
)


def per_shard(forest, x, fn: Callable):
    """``fn(local_forest, x_block)`` on every (data, model) cell of a
    :class:`~.mesh.ShardedForest` that this process holds, each on the
    cell's device: returns the grid of results (this process's rows, and in
    each its cells in model order) and the logical row count of ``x`` (a
    row-sharded pool, or a plain tensor that is padded and split here)."""
    xs = mesh_lib.shard_rows(x, forest.mesh, replicate=True)
    if len(xs.blocks) != len(forest.shards):
        raise ValueError(
            f"x is sharded over {len(xs.blocks)} data shards, the forest over {len(forest.shards)}")
    grid = [[fn(f, xs.block(s, m)) for m, f in enumerate(row)]
            for s, row in zip(xs.local_ids, forest.shards)]
    return grid, xs.n_rows


def join_blocks(blocks, mesh: mesh_lib.Mesh, n: int) -> torch.Tensor:
    """Per-data-shard blocks joined in shard order on the mesh's first
    device, cut to the logical ``n`` rows (over processes, this rank's
    blocks all-gathered with the other rows', each row from its owner:
    COLLECTIVE)."""
    blocks = [b.to(mesh.first) for b in blocks]
    if mesh.spread.spans_rows:
        blocks = owner_gather(blocks, mesh.spread)
    return torch.cat(blocks)[:n]


def join_leaf_grid(grid, mesh: mesh_lib.Mesh, n: int) -> torch.Tensor:
    """A ``[data][model]`` grid of ``[n_local, T / model]`` leaf blocks as
    the global ``[n, T]``: each row block's model shards joined in tree
    order, then the row blocks in row order, so a reduction over trees
    afterwards (``tree_mean``) adds in the single-device order and gives its
    bits. A row whose cells lie on several processes is joined across its
    row group first (COLLECTIVE; a rank holding two rows joins them in row
    order)."""
    rows = [torch.cat([lv.to(row[0].device) for lv in row], dim=1) for row in grid]
    sp = mesh.spread
    if sp.procs > 1:
        from distributed_active_learning_tpu_torch.parallel import multihost

        width = grid[0][0].shape[1]  # trees a cell
        for i, s in enumerate(sp.rows):
            holders = tuple(sp.holders(s))
            if len(holders) > 1:
                counts = [len(sp.cols_of(r, s)) * width for r in holders]
                rows[i] = torch.cat(multihost.all_gather(rows[i].contiguous(), ranks=holders,
                                                         counts=counts, dim=1), dim=1)
    return join_blocks(rows, mesh, n)


def sharded_leaves(forest, x) -> torch.Tensor:
    """``[n, T]`` leaf values of a :class:`~.mesh.ShardedForest` on the
    mesh's first device: each shard's own form (K1 for the leaf kernel's
    shards, the plain gemm or gather form otherwise) on its row block."""
    from distributed_active_learning_tpu_torch.ops import forest_eval

    grid, n = per_shard(forest, x, forest_eval.leaves)
    return join_leaf_grid(grid, forest.mesh, n)


def sharded_votes(mesh: mesh_lib.Mesh):
    """Per-point positive-vote counts with the pool's rows over ``data`` and
    the trees over ``model``: each shard counts its tree shard's votes on
    its row block with the forest's own form (K1 for a pallas forest, the
    plain path-matrix or gather walk otherwise, as the JAX package's
    ``shard_map`` body evaluates any form), one sum over ``model`` completes
    the counts (over the row group where a row spans processes), and the
    blocks are joined in shard order on the first device.

    Returns ``(forest, x) -> votes [n] int32`` for a forest global or
    already placed on ``mesh``."""
    from distributed_active_learning_tpu_torch.ops import forest_eval
    from distributed_active_learning_tpu_torch.ops.trees_pallas import attach_mesh

    def votes_fn(forest, x) -> torch.Tensor:
        grid, n = per_shard(attach_mesh(forest, mesh), x, forest_eval.votes)
        sp = mesh.spread
        return join_blocks([row_accumulate(row, sp, s) for s, row in zip(sp.rows, grid)], mesh, n)

    return votes_fn


def sharded_similarity_mass(mesh: mesh_lib.Mesh):
    """The similarity mass with the pool sharded over ``data``: each shard
    normalizes its block and folds its masked rows into one ``[d]`` vector,
    the vectors are added over ``data`` in shard order, each row once (the
    JAX package's one ``psum``: ``d`` floats a shard cross the mesh), and
    each shard
    finishes with its local matvec; the blocks are joined on the first
    device. Products in IEEE float32, as ``ops.similarity`` runs them.

    Returns ``(x, count_mask) -> mass [n]`` for a row-sharded (or plain)
    ``x`` and a mask, sharded or global."""
    from distributed_active_learning_tpu_torch.ops import similarity

    def mass(x, count_mask) -> torch.Tensor:
        xs = mesh_lib.shard_rows(x, mesh, replicate=True)
        ms = mesh_lib.shard_rows(count_mask, mesh)
        with similarity._ieee_f32():
            xn = [similarity.l2_normalize(xs.block(s)) for s in xs.local_ids]
            local = [torch.mv(b.T, ms.block(s).to(b.device, b.dtype))
                     for s, b in zip(xs.local_ids, xn)]
            pooled = vector_accumulate(local, mesh.spread)
            out = [torch.mv(b, pooled.to(b.device)) for b in xn]
        return join_blocks(out, mesh, xs.n_rows)

    return mass


def make_sharded_round_fn(strategy, window_size: int, mesh: mesh_lib.Mesh,
                          with_metrics: bool = False, n_classes: int = 2, fused: bool = False,
                          scenario=None):
    """The AL round over a device mesh: ``(forest, state, aux) -> (new_state,
    picked, scores[, metrics])`` for a pool placed by
    ``parallel.mesh.shard_pool_state`` and a forest placed by
    ``shard_forest`` + ``attach_mesh``.

    The explicit counterpart of the GSPMD round, the same body as the
    single-device round (``runtime.loop._round_core``): the forest is
    evaluated per shard (:func:`sharded_votes`, :func:`sharded_leaves`; the
    density mass by :func:`sharded_similarity_mass`), the scores, the masks
    and the labels are joined in shard order on the first device, where the
    global ``select_top_k``/``select_bottom_k`` and every ``RoundMetrics``
    reduction run (the all-gathers GSPMD inserts), and the reveal writes
    each shard's own block (``state.reveal_masked_local``). The fused round
    selects per shard and merges on the ring
    (``ops.round_fused._sharded_score_select``). ``with_metrics``,
    ``n_classes`` and ``scenario`` as in ``runtime.loop.make_round_fn``; of
    the scenarios a mesh takes the noisy oracle only (``run_experiment``
    refuses the others)."""
    from distributed_active_learning_tpu_torch.runtime.loop import make_round_fn

    round_fn = make_round_fn(strategy, window_size, with_metrics=with_metrics,
                             n_classes=n_classes, fused=fused, scenario=scenario)

    def sharded_round(forest, state, aux, *costs):
        x = state.x
        if not isinstance(x, mesh_lib.Sharded) or len(x.blocks) != len(mesh.devices):
            raise ValueError(
                f"the pool is not sharded over this mesh's {mesh.shape[mesh_lib.AXIS_DATA]} data "
                "shards; place it with parallel.mesh.shard_pool_state"
            )
        return round_fn(forest, state, aux, *costs)

    return sharded_round
