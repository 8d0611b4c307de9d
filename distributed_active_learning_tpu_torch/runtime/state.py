"""Device-resident active-learning pool state (the port of
``runtime/state.py``).

The pool is one dense tensor on the device and the labeled/unlabeled split is
a boolean mask over it: fixed shapes, no per-round host round-trips. On a
device mesh the pool's arrays are :class:`~..parallel.mesh.Sharded` row
blocks (``parallel.mesh.shard_pool_state``, after :func:`pad_for_sharding`);
the functions here take either form.

A grid of pools of unequal widths pads every pool to one slab width and
marks the real rows with the scalar fill watermark ``n_filled`` (a 0-d int32
tensor on the device): rows at or past it are padding, labeled, excluded
from the fit window, the counts and the metrics, as in the JAX package. On a
mesh the watermark is the per-shard ``[S]`` leaf
(``parallel.mesh.shard_fill_watermark``): shard ``s`` is filled below its
own ``n_filled[s]`` rows of its block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.ops.topk import stable_top_k
from distributed_active_learning_tpu_torch.parallel.collectives import global_count
from distributed_active_learning_tpu_torch.parallel.mesh import Sharded, gather


@dataclasses.dataclass(frozen=True)
class PoolState:
    """Full state of one AL experiment's pool.

    ``oracle_y`` holds every label; strategies may only consume labels where
    ``labeled_mask`` is True. ``key`` is the PRNG key threaded through rounds
    and ``round`` the round counter. The per-round driver keeps the key on
    the CPU (see :mod:`..prng`) and the counter as a Python int; the chunked
    driver carries both on the device (:func:`as_carry`), where a round that
    turns out inactive keeps them through :func:`select_state`.
    """

    x: torch.Tensor             # [n, d] float32 — pool features
    oracle_y: torch.Tensor      # [n] int32
    labeled_mask: torch.Tensor  # [n] bool
    key: prng.Key               # [2] int64 key words
    round: Union[int, torch.Tensor] = 0  # a 0-d int32 device tensor in the carry form
    n_valid_static: int = -1
    # The fill watermark: a 0-d int32 tensor on the device (rows
    # [0, n_filled) are filled), or on a mesh the per-shard [S] leaf. None
    # keeps every mask and count on the static path, bit for bit the code
    # without it.
    n_filled: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "PoolState":
        return dataclasses.replace(self, **kw)

    @property
    def n_pool(self) -> int:
        return self.x.shape[0]

    @property
    def n_valid(self) -> int:
        return self.n_pool if self.n_valid_static < 0 else self.n_valid_static

    @property
    def fill_mask(self) -> torch.Tensor:
        """Rows below the fill watermark; all True without one. A per-shard
        ``[S]`` leaf compares each shard's block-local row against its own
        watermark (block ``s`` is rows ``[s * rows, (s + 1) * rows)``)."""
        rows = torch.arange(self.n_pool, device=self.x.device)
        if self.n_filled is None:
            return torch.ones_like(rows, dtype=torch.bool)
        if self.n_filled.ndim == 0:
            return rows < self.n_filled
        per = self.n_pool // self.n_filled.shape[0]
        return rows % per < torch.repeat_interleave(self.n_filled.to(rows.device), per)

    @property
    def valid_mask(self) -> torch.Tensor:
        mask = torch.arange(self.n_pool, device=self.x.device) < self.n_valid
        if self.n_filled is not None:
            mask = mask & self.fill_mask
        return mask

    @property
    def unlabeled_mask(self):
        if isinstance(self.labeled_mask, Sharded):
            m = self.labeled_mask
            if self.n_filled is None:
                return m.map(torch.logical_not)
            return m.with_blocks((~m.block(s) & _block_fill(self, s),) for s in m.local_ids)
        if self.n_filled is not None:
            return ~self.labeled_mask & self.fill_mask
        return ~self.labeled_mask


def _block_fill(state: PoolState, s: int) -> torch.Tensor:
    """Shard ``s``'s block of :attr:`PoolState.fill_mask` on its device."""
    blk = state.labeled_mask.block(s)
    n_local = blk.shape[0]
    if state.n_filled is None:
        return torch.ones_like(blk)
    if state.n_filled.ndim == 0:
        rows = torch.arange(s * n_local, (s + 1) * n_local, device=blk.device)
        return rows < state.n_filled.to(blk.device)
    return torch.arange(n_local, device=blk.device) < state.n_filled[s].to(blk.device)


def valid_blocks(state: PoolState) -> list:
    """Each shard's block of :attr:`PoolState.valid_mask` (real rows below
    the fill watermark) on its own device, for a row-sharded state."""
    mask = state.labeled_mask
    n_local = mask.n_local
    return [(torch.arange(s * n_local, (s + 1) * n_local, device=mask.block(s).device)
             < state.n_valid) & _block_fill(state, s) for s in mask.local_ids]


def labeled_count(state: PoolState) -> torch.Tensor:
    """Number of real labeled points, as a device scalar (padding rows are
    labeled and not counted; on a mesh, one count per shard is added up)."""
    mask = state.labeled_mask
    if isinstance(mask, Sharded):
        return global_count([mask.block(s) & v for s, v in zip(mask.local_ids, valid_blocks(state))],
                            mask.spread)
    if state.n_filled is None and state.n_valid == state.n_pool:
        return mask.sum(dtype=torch.int32)
    return (mask & state.valid_mask).sum(dtype=torch.int32)


def filled_count(state: PoolState) -> torch.Tensor:
    """The filled rows as a 0-d int32 tensor: the watermark (the sum of a
    per-shard ``[S]`` leaf), or the real row count without one."""
    if state.n_filled is None:
        return torch.full((), state.n_valid, dtype=torch.int32, device=state.x.device)
    if state.n_filled.ndim:
        return state.n_filled.sum(dtype=torch.int32)
    return state.n_filled.to(torch.int32)


def init_pool_state(x, y, key: prng.Key, device) -> PoolState:
    """Wrap arrays into a fresh all-unlabeled PoolState on ``device``."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)
    y = torch.as_tensor(np.asarray(y, dtype=np.int32)).to(device)
    return PoolState(
        x=x,
        oracle_y=y,
        labeled_mask=torch.zeros(x.shape[0], dtype=torch.bool, device=device),
        key=key,
    )


def set_start_state(state: PoolState, n_start: int, n_classes: int = 2) -> PoolState:
    """Seed the labeled set: one point per present class plus random extras
    (``Dataset.setStartState``), drawing the same priorities as the JAX
    package from the same key."""
    n = state.n_pool
    if n_start > n:
        raise ValueError(f"n_start={n_start} exceeds pool size {n}")
    y = state.oracle_y.cpu().numpy()
    present = [bool((y == c).any()) for c in range(n_classes)]
    if sum(present) < 2:
        raise ValueError(
            "set_start_state needs at least two classes present in the pool "
            "(the reference's take(1) on an empty class RDD would fail the "
            "same way: dataset.py:90-106)"
        )
    keys = prng.split(state.key, n_classes + 2)
    key, k_rest, k_classes = keys[0], keys[1], keys[2:]
    dev = state.x.device

    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    neg = torch.full((n,), -1.0, device=dev)
    n_seeded = 0
    for c in range(n_classes):
        if not present[c]:
            continue
        pri = prng.uniform(k_classes[c], (n,), dev)
        # argmax returns the first maximum, as jnp.argmax does.
        pick = torch.argmax(torch.where(state.oracle_y == c, pri, neg))
        mask[pick] = True
        n_seeded += 1

    n_extra = max(n_start - n_seeded, 0)
    if n_extra > 0:
        pri_rest = prng.uniform(k_rest, (n,), dev)
        _, extra_idx = stable_top_k(torch.where(mask, neg, pri_rest), n_extra)
        mask[extra_idx] = True
    return state.replace(labeled_mask=mask, key=key)


def _reveal_rows(mask: torch.Tensor, picked_idx: torch.Tensor, base: int = 0) -> torch.Tensor:
    """``mask`` holds global rows ``[base, base + len(mask))``: set the picked
    ones, drop the rest."""
    n = mask.shape[0]
    local = picked_idx.to(mask.device) - base
    keep = (local >= 0) & (local < n)
    ext = torch.cat([mask, mask.new_zeros(1)])
    ext.scatter_(0, torch.where(keep, local, n), True)
    return ext[:n]


def reveal(state: PoolState, picked_idx: torch.Tensor) -> PoolState:
    """Label the picked pool indices (the oracle call) and advance the round.

    Indices past the pool (a short tile's padding candidates or the ring's
    ``IDX_SENTINEL``, reachable only when fewer than ``window`` rows remain
    selectable) are dropped, as the JAX scatter drops out-of-bounds updates.
    On a mesh, global index ``i`` lands in shard ``i // n_local``.
    """
    mask = state.labeled_mask
    if isinstance(mask, Sharded):
        n_local = mask.n_local
        new = mask.with_blocks((_reveal_rows(mask.block(s), picked_idx, s * n_local),)
                               for s in mask.local_ids)
    else:
        new = _reveal_rows(mask, picked_idx)
    return state.replace(labeled_mask=new, round=state.round + 1)


def reveal_masked(state: PoolState, picked_idx: torch.Tensor, keep: torch.Tensor, *,
                  abstain_key: Optional[prng.Key] = None, abstain_prob: float = 0.0) -> PoolState:
    """:func:`reveal` of the picks where ``keep`` is True only (the JAX
    package's ``labeled_mask.at[picked].max(keep)``): a batched round selects
    at the widest window of its experiments and reveals each experiment's
    own first ``window`` picks. With ``keep`` all True this is
    :func:`reveal`.

    ``abstain_key`` and ``abstain_prob`` make the reveal probabilistic (the
    noisy-oracle scenario): each kept pick is revealed only where
    ``uniform(abstain_key, picked.shape) >= abstain_prob``. An abstained
    pick writes nothing and re-enters the pool, so every count downstream
    counts revealed labels, never picks.

    On a mesh the window-sized draw is made once and each shard reveals its
    own block (:func:`reveal_masked_local`), the JAX package's per-shard
    spelling: the blocks join to the global reveal bit for bit."""
    if abstain_key is not None:
        keep = keep & (prng.uniform(abstain_key, picked_idx.shape, picked_idx.device)
                       >= abstain_prob)
    mask = state.labeled_mask
    if isinstance(mask, Sharded):
        n_local = mask.n_local
        new = mask.with_blocks((reveal_masked_local(mask.block(s), picked_idx, keep, s, n_local),)
                               for s in mask.local_ids)
    else:
        new = _reveal_rows(mask, torch.where(keep, picked_idx, -1))
    return state.replace(labeled_mask=new, round=state.round + 1)


def reveal_masked_local(mask_block: torch.Tensor, picked_idx: torch.Tensor, keep: torch.Tensor,
                        shard_index: int, rows: int) -> torch.Tensor:
    """Shard ``shard_index``'s block ``[rows]`` of :func:`reveal_masked`'s
    mask: the picks (global indices, the whole window) that land in its rows
    ``[shard_index * rows, (shard_index + 1) * rows)`` and are kept are
    written at their local positions, the rest write nothing. ``keep``
    already holds the abstain draw (:func:`reveal_masked` makes it once, the
    window-sized draw of the replicated round key)."""
    dropped = torch.where(keep, picked_idx, -1)
    return _reveal_rows(mask_block, dropped, shard_index * rows)


def as_carry(state: PoolState) -> PoolState:
    """The chunked driver's carry form of a single-device state: the key and
    the round counter (0-d int32) as tensors on the pool's device, so that a
    chunk can advance or freeze them without asking the host."""
    dev = state.x.device
    return state.replace(
        key=state.key.to(dev),
        round=torch.as_tensor(state.round, dtype=torch.int32).to(dev),
    )


def select_state(active: torch.Tensor, new: PoolState, old: PoolState) -> PoolState:
    """``new`` if the 0-d boolean ``active`` else ``old``, for the fields a
    round changes (mask, key, round): the chunked driver's masked no-op.
    Rounds past the label cap or the round quota inside a chunk leave the
    carried state exactly unchanged, so stopping is exact and not quantized
    to chunks. A select on the device, never a host branch; a row-sharded
    mask is selected block by block."""
    if isinstance(old.labeled_mask, Sharded):
        a, b = new.labeled_mask, old.labeled_mask
        mask = b.with_blocks(tuple(torch.where(active.to(y.device), x, y) for x, y in zip(ra, rb))
                             for ra, rb in zip(a.blocks, b.blocks))
    else:
        mask = torch.where(active, new.labeled_mask, old.labeled_mask)
    return old.replace(
        labeled_mask=mask,
        key=torch.where(active, new.key, old.key),
        round=torch.where(active, new.round, old.round),
    )


def global_labeled_mask(state: PoolState) -> torch.Tensor:
    """The real rows' labeled mask as one tensor (gathered from the shards
    on a mesh, padding rows dropped)."""
    return gather(state.labeled_mask)[: state.n_valid]


def pad_for_sharding(state: PoolState, multiple: int) -> PoolState:
    """Pad the pool to a row count divisible by ``multiple`` (a mesh data
    axis), so every shard holds an equal block. Padding rows carry zero
    features, label 0 and ``labeled_mask=True``: the masked top-k never
    selects them, and every real-row count filters through ``valid_mask``.
    The real row count is kept in ``n_valid_static``."""
    n = state.n_pool
    pad = (-n) % multiple
    if pad == 0:
        return state
    return state.replace(
        x=torch.cat([state.x, state.x.new_zeros((pad, state.x.shape[1]))]),
        oracle_y=torch.cat([state.oracle_y, state.oracle_y.new_zeros(pad)]),
        labeled_mask=torch.cat([state.labeled_mask, state.labeled_mask.new_ones(pad)]),
        n_valid_static=n,
    )
