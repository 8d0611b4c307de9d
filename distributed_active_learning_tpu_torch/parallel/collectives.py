"""Collectives of the single-process mesh (the port of
``parallel/collectives.py``).

The JAX package reduces over a mesh axis with ``lax.psum``. Here the shards
of an axis are tensors on the axis's devices, and a reduction adds them in
shard order on the axis's first device. Each ``.to()`` of another device's
tensor is a PyTorch copy, which waits for the source device's current stream
and orders the destination's after it. ``gather_fills`` and
``exchange_blocks`` wait for the pod slab.
"""

from __future__ import annotations

from typing import Sequence

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
