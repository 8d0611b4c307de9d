"""Collectives of the mesh (the port of ``parallel/collectives.py``).

The JAX package reduces over a mesh axis with ``lax.psum``. Here the shards
of an axis are tensors on the axis's devices, and a reduction adds them in
shard order on the axis's first device. Each ``.to()`` of another device's
tensor is a PyTorch copy, which waits for the source device's current stream
and orders the destination's after it. :func:`gather_fills` and
:func:`exchange_blocks` are the pod slab's two collectives
(``serving/slab.py``: the rebalance epoch's fill vector and its
window-sized all-to-all).

Over several processes each collective takes the placement's ``spread``
(``parallel/mesh.py``'s ``Spread``: ``Mesh.spread``, ``Sharded.spread``;
``None`` is one process). Each rank passes its own shards; where other
ranks hold other rows, the shards of the rows' owners are all-gathered over
gloo in shard order (:func:`owner_gather`: a row that several ranks hold
counts once), and each rank adds them in that order itself: never a
backend ``all_reduce`` of floats, whose summation order is its own, since
the port holds masses and means to XLA's order. :func:`row_accumulate` is
the sum over ``model`` of one row's cells, across the row's ranks; a rank
whose cells cross a row boundary holds two rows and calls it for each, in
row order. Every rank must call these at the same point.

Each collective declares itself to the program auditor's trace
(``kernels.collective_work``: its name, kind and one shard's operands, the
bytes that cross each link); outside a trace that costs one thread-local
read.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from distributed_active_learning_tpu_torch import kernels


def owner_gather(rows: Sequence[torch.Tensor], spread) -> List[torch.Tensor]:
    """Every data row's tensor in row order on ``rows[0]``'s device, each
    from its owner: ``rows`` are this rank's rows' tensors
    (``spread.rows``, equal shapes on every rank), and each rank sends the
    rows it owns (owners own different numbers of rows, possibly none) in
    one all-gather over the job, so every row counts once. COLLECTIVE."""
    from distributed_active_learning_tpu_torch.parallel.multihost import all_gather

    with kernels.collective_work("owner_gather", "gather", rows):
        dev = rows[0].device
        first = spread.rows.start
        mine = [rows[s - first].to(dev) for s in spread.owned(spread.rank)]
        stacked = torch.stack(mine) if mine else rows[0].to(dev)[None][:0]
        counts = [len(spread.owned(r)) for r in range(spread.procs)]
        return list(torch.cat(all_gather(stacked, counts=counts)).unbind(0))


def _all_shards(local: Sequence[torch.Tensor], spread) -> List[torch.Tensor]:
    """Every shard's tensor of the axis in shard order: ``local`` itself
    where one process holds every row, else every row's from its owner
    (:func:`owner_gather`)."""
    if spread is None or not spread.spans_rows:
        return list(local)
    return owner_gather(local, spread)


def vector_accumulate(local: Sequence[torch.Tensor], spread=None) -> torch.Tensor:
    """Elementwise sum of the per-shard vectors of one axis, added in shard
    order on the first shard's device (``lax.psum`` over the axis)."""
    with kernels.collective_work("vector_accumulate", "reduce", local):
        shards = _all_shards(local, spread)
        dev = local[0].device
        acc = shards[0].to(dev)
        for v in shards[1:]:
            acc = acc + v.to(dev)
        return acc


def row_accumulate(cells: Sequence[torch.Tensor], spread=None, row: int = 0) -> torch.Tensor:
    """The sum over ``model`` of data row ``row``'s per-cell vectors, in
    model order (``lax.psum`` over ``model``): ``cells`` are this process's
    cells of the row; where the row spans processes (``spread.holders``),
    every rank of the row gathers the others' cells over the row's group
    (made with the mesh, ``multihost.make_groups``; the ranks hold different
    numbers of the row's cells) and adds all of them in model order itself,
    so every rank of the
    row gets the same bits. COLLECTIVE over the row group then: a rank that
    holds two rows calls this for each, in row order, as every rank does."""
    with kernels.collective_work("row_accumulate", "reduce", cells):
        if spread is not None and spread.procs > 1 and len(spread.holders(row)) > 1:
            from distributed_active_learning_tpu_torch.parallel import multihost

            holders = tuple(spread.holders(row))
            dev = cells[0].device
            parts = multihost.all_gather(torch.stack([c.to(dev) for c in cells]),
                                         ranks=holders,
                                         counts=[len(spread.cols_of(r, row)) for r in holders])
            cells = list(torch.cat(parts).unbind(0))
        return vector_accumulate(cells)


def global_count(local_masks: Sequence[torch.Tensor], spread=None) -> torch.Tensor:
    """Global True-count of per-shard boolean masks: one int32 per shard
    moves to the first shard's device, never the mask."""
    counts = [m.sum(dtype=torch.int32) for m in local_masks]
    with kernels.collective_work("global_count", "reduce", counts):
        return vector_accumulate(counts, spread)


def gather_fills(local_fills: Sequence[torch.Tensor], spread=None) -> torch.Tensor:
    """All shards' fill watermarks as one ``[S]`` int32 vector on the first
    shard's device (``lax.all_gather`` of one scalar a shard): the rebalance
    planner's only global input."""
    dev = local_fills[0].device
    local = [f.reshape(()).to(dev, torch.int32) for f in local_fills]
    with kernels.collective_work("gather_fills", "gather", local):
        return torch.stack(_all_shards(local, spread))


def exchange_blocks(blocks: Sequence[torch.Tensor], spread=None) -> List[torch.Tensor]:
    """The window-sized all-to-all of per-target row blocks
    (``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``): shard
    ``i`` sends ``blocks[i]`` ``[S, b, ...]``, whose slot ``j`` goes to shard
    ``j``; shard ``j`` receives ``[S, b, ...]`` on its own device, whose slot
    ``i`` is what shard ``i`` sent it. On one card this is tensor indexing;
    across cards each slot is a peer copy to the receiver's device. Over
    processes each rank passes its own shards' blocks and gets its own
    shards' receipts (every block is all-gathered: window-sized)."""
    with kernels.collective_work("exchange_blocks", "exchange", blocks):
        return _exchange_blocks(blocks, spread)


def _exchange_blocks(blocks: Sequence[torch.Tensor], spread) -> List[torch.Tensor]:
    shards = _all_shards(blocks, spread)
    n = len(shards)
    for b in shards:
        if b.shape[0] != n:
            raise ValueError(f"exchange_blocks needs [S={n}, b, ...] blocks, got "
                             f"{tuple(b.shape)}")
    first = spread.rows.start if spread is not None and spread.spans_rows else 0
    mine = range(first, first + len(blocks))
    return [torch.stack([shards[i][j].to(blocks[j - first].device) for i in range(n)])
            for j in mine]


def masked_mean(values: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                spread=None) -> torch.Tensor:
    """Global mean of the per-shard ``values`` where ``masks`` are set: each
    shard's masked sum and count, each added over the axis in shard order
    (``lax.psum``), then one division (the JAX package's ``masked_mean``,
    LAL's pool-level scalar features)."""
    sums, counts = [], []
    for v, m in zip(values, masks, strict=True):
        mf = m.to(v.dtype)
        sums.append((v * mf).sum())
        counts.append(mf.sum())
    return (vector_accumulate(sums, spread)
            / torch.clamp_min(vector_accumulate(counts, spread), 1.0))
