"""Collectives of the single-process mesh (the port of
``parallel/collectives.py``).

The JAX package reduces over a mesh axis with ``lax.psum``. Here the shards
of an axis are tensors on the axis's devices, and a reduction adds them in
shard order on the axis's first device. Each ``.to()`` of another device's
tensor is a PyTorch copy, which waits for the source device's current stream
and orders the destination's after it. :func:`gather_fills` and
:func:`exchange_blocks` are the pod slab's two collectives
(``serving/slab.py``: the rebalance epoch's fill vector and its
window-sized all-to-all).
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def vector_accumulate(local: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise sum of the per-shard vectors of one axis, added in shard
    order on the first shard's device (``lax.psum`` over the axis)."""
    dev = local[0].device
    acc = local[0]
    for v in local[1:]:
        acc = acc + v.to(dev)
    return acc


def global_count(local_masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global True-count of per-shard boolean masks: one int32 per shard
    moves to the first shard's device, never the mask."""
    return vector_accumulate([m.sum(dtype=torch.int32) for m in local_masks])


def gather_fills(local_fills: Sequence[torch.Tensor]) -> torch.Tensor:
    """All shards' fill watermarks as one ``[S]`` int32 vector on the first
    shard's device (``lax.all_gather`` of one scalar a shard): the rebalance
    planner's only global input."""
    dev = local_fills[0].device
    return torch.stack([f.reshape(()).to(dev, torch.int32) for f in local_fills])


def exchange_blocks(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The window-sized all-to-all of per-target row blocks
    (``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``): shard
    ``i`` sends ``blocks[i]`` ``[S, b, ...]``, whose slot ``j`` goes to shard
    ``j``; shard ``j`` receives ``[S, b, ...]`` on its own device, whose slot
    ``i`` is what shard ``i`` sent it. On one card this is tensor indexing;
    across cards each slot is a peer copy to the receiver's device."""
    n = len(blocks)
    for b in blocks:
        if b.shape[0] != n:
            raise ValueError(f"exchange_blocks needs [S={n}, b, ...] blocks, got "
                             f"{tuple(b.shape)}")
    return [torch.stack([blocks[i][j].to(blocks[j].device) for i in range(n)])
            for j in range(n)]


def masked_mean(values: Sequence[torch.Tensor], masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global mean of the per-shard ``values`` where ``masks`` are set: each
    shard's masked sum and count, each added over the axis in shard order
    (``lax.psum``), then one division (the JAX package's ``masked_mean``,
    LAL's pool-level scalar features)."""
    sums, counts = [], []
    for v, m in zip(values, masks, strict=True):
        mf = m.to(v.dtype)
        sums.append((v * mf).sum())
        counts.append(mf.sum())
    return vector_accumulate(sums) / torch.clamp_min(vector_accumulate(counts), 1.0)
