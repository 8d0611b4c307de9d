"""Collectives of the mesh (the port of ``parallel/collectives.py``).

The JAX package reduces over a mesh axis with ``lax.psum``. Here the shards
of an axis are tensors on the axis's devices, and a reduction adds them in
shard order on the axis's first device. Each ``.to()`` of another device's
tensor is a PyTorch copy, which waits for the source device's current stream
and orders the destination's after it. :func:`gather_fills` and
:func:`exchange_blocks` are the pod slab's two collectives
(``serving/slab.py``: the rebalance epoch's fill vector and its
window-sized all-to-all).

Over several processes (``across_processes=True``, for a data axis whose
shards lie in other processes too; ``parallel/multihost.py``) each rank
passes its own shards, every rank's are all-gathered over gloo in shard
order, and each rank adds them in that order itself: never a backend
``all_reduce`` of floats, whose summation order is its own, since the port
holds masses and means to XLA's order. Every rank must call these at the
same point.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def _all_shards(local: Sequence[torch.Tensor], across_processes: bool) -> List[torch.Tensor]:
    """Every shard's tensor of the axis in shard order on ``local[0]``'s
    device: ``local`` itself in one process, else every rank's ``local``
    (equal counts and shapes) gathered in rank order."""
    if not across_processes:
        return list(local)
    from distributed_active_learning_tpu_torch.parallel.multihost import all_gather

    dev = local[0].device
    stacked = torch.stack([t.to(dev) for t in local])
    return [t for rank in all_gather(stacked) for t in rank.unbind(0)]


def vector_accumulate(local: Sequence[torch.Tensor], across_processes: bool = False) -> torch.Tensor:
    """Elementwise sum of the per-shard vectors of one axis, added in shard
    order on the first shard's device (``lax.psum`` over the axis)."""
    shards = _all_shards(local, across_processes)
    dev = local[0].device
    acc = shards[0].to(dev)
    for v in shards[1:]:
        acc = acc + v.to(dev)
    return acc


def global_count(local_masks: Sequence[torch.Tensor], across_processes: bool = False) -> torch.Tensor:
    """Global True-count of per-shard boolean masks: one int32 per shard
    moves to the first shard's device, never the mask."""
    return vector_accumulate([m.sum(dtype=torch.int32) for m in local_masks], across_processes)


def gather_fills(local_fills: Sequence[torch.Tensor], across_processes: bool = False) -> torch.Tensor:
    """All shards' fill watermarks as one ``[S]`` int32 vector on the first
    shard's device (``lax.all_gather`` of one scalar a shard): the rebalance
    planner's only global input."""
    dev = local_fills[0].device
    local = [f.reshape(()).to(dev, torch.int32) for f in local_fills]
    return torch.stack(_all_shards(local, across_processes))


def exchange_blocks(blocks: Sequence[torch.Tensor],
                    across_processes: bool = False) -> List[torch.Tensor]:
    """The window-sized all-to-all of per-target row blocks
    (``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``): shard
    ``i`` sends ``blocks[i]`` ``[S, b, ...]``, whose slot ``j`` goes to shard
    ``j``; shard ``j`` receives ``[S, b, ...]`` on its own device, whose slot
    ``i`` is what shard ``i`` sent it. On one card this is tensor indexing;
    across cards each slot is a peer copy to the receiver's device. Over
    processes each rank passes its own shards' blocks and gets its own
    shards' receipts (every block is all-gathered: window-sized)."""
    shards = _all_shards(blocks, across_processes)
    n = len(shards)
    for b in shards:
        if b.shape[0] != n:
            raise ValueError(f"exchange_blocks needs [S={n}, b, ...] blocks, got "
                             f"{tuple(b.shape)}")
    mine = range(n)
    if across_processes:
        from distributed_active_learning_tpu_torch.parallel.multihost import process_index

        first = process_index() * len(blocks)
        mine = range(first, first + len(blocks))
    return [torch.stack([shards[i][j].to(blocks[j - mine[0]].device) for i in range(n)])
            for j in mine]


def masked_mean(values: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                across_processes: bool = False) -> torch.Tensor:
    """Global mean of the per-shard ``values`` where ``masks`` are set: each
    shard's masked sum and count, each added over the axis in shard order
    (``lax.psum``), then one division (the JAX package's ``masked_mean``,
    LAL's pool-level scalar features)."""
    sums, counts = [], []
    for v, m in zip(values, masks, strict=True):
        mf = m.to(v.dtype)
        sums.append((v * mf).sum())
        counts.append(mf.sum())
    return (vector_accumulate(sums, across_processes)
            / torch.clamp_min(vector_accumulate(counts, across_processes), 1.0))
