"""Slab-paged streaming pool: fixed-capacity slabs and in-place ingest (the
port of the single-slab half of ``serving/slab.py``).

The batch pipeline's :class:`~..runtime.state.PoolState` is sized once per
experiment; a service's points arrive continuously. The slab design splits
how much memory is allocated from how much of it is real:

- **Capacity is slab-quantized.** Pool tensors are allocated in fixed
  ``slab_rows``-row slabs; the re-fit chunk is captured once per capacity
  (one CUDA graph a capacity, ``serving/tenants.py``), and growth, a slab at
  a time, is the only shape change.

- **The fill is a watermark on the device.** ``SlabPool.n_filled`` is a 0-d
  int32 tensor: rows at or past it are allocated but unfilled, excluded
  from selection, fit and metrics by ``PoolState``'s dynamic masks.

- **Ingest writes in place.** :func:`make_ingest_fn` writes a fixed-width
  block at the watermark into the slab's own tensors (``x``, ``codes``,
  ``oracle_y``) and advances ``n_filled`` with ``add_``: it never rebinds
  them, so a chunk graph captured on the slab reads the new rows and the
  new watermark at its next replay. Arrivals smaller than the block are
  padded; the pad rows land past the advanced watermark and are overwritten
  by the next block.

- **Scoring is capacity-independent.** :func:`make_score_fn` evaluates the
  resident forest over a fixed-width query batch.

- **The pod.** At pod scale the pool is S contiguous row blocks over a
  mesh's ``data`` axis (:func:`shard_slab_pool`): each of ``x``,
  ``oracle_y``, ``labeled_mask`` and ``codes`` is a
  :class:`~..parallel.mesh.Sharded` (block ``s`` on ``mesh.devices[s][0]``)
  and ``n_filled`` is the per-shard ``[S]`` watermark on the mesh's first
  device. Ingest writes each block at ONE shard's watermark
  (:func:`make_sharded_ingest_fn`, the shard picked by
  :func:`route_to_shard`); a rebalance epoch (:func:`make_rebalance_fn`)
  moves at most ``block_rows`` rows a shard from the fullest shards to the
  emptiest with one window-sized all-to-all
  (``parallel.collectives.exchange_blocks``) and returns the move as a
  global-index map, which ``ops.ring_topk.remap_indices`` reads. Global row
  identity is positional, ``shard * rows + local`` with ``rows = capacity //
  S``: :func:`grow_sharded_slab` pads every shard's block, so it renumbers
  global indices, and every map held across a growth is stale (as in the
  JAX package, ``serving/slab.py:218-223``). These are plain PyTorch: the
  JAX package runs them as XLA programs under ``shard_map``, with no
  Pallas kernel.
  Over processes (a mesh from ``parallel.multihost``) every rank makes the
  same calls with the same arguments, as JAX's multi-controller model does:
  each holds only its own shards' blocks and writes only those, while the
  ``[S]`` watermark, the rebalance plan and the epoch's index maps are
  whole and equal on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from distributed_active_learning_tpu_torch.runtime import state as state_lib


@dataclasses.dataclass(frozen=True)
class SlabPool:
    """Device-resident slab-paged pool.

    ``labeled_mask`` rows past the watermark stay False (ingest never
    touches the mask: fresh points arrive unlabeled). ``codes`` holds the
    binned features the device trainer reads, kept in lockstep with ``x``
    by the ingest."""

    x: torch.Tensor             # [capacity, d] float32
    oracle_y: torch.Tensor      # [capacity] int32
    labeled_mask: torch.Tensor  # [capacity] bool
    codes: torch.Tensor         # [capacity, d] int32 — binned features
    n_filled: torch.Tensor      # 0-d int32 — the fill watermark
    slab_rows: int = 1024

    def replace(self, **kw) -> "SlabPool":
        return dataclasses.replace(self, **kw)

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def n_slabs(self) -> int:
        return self.capacity // self.slab_rows


def slab_capacity(n_rows: int, slab_rows: int) -> int:
    """Smallest slab-multiple capacity holding ``n_rows`` (at least 1 slab)."""
    return max(-(-n_rows // slab_rows), 1) * slab_rows


def empty_slab_pool(capacity: int, d: int, slab_rows: int, device) -> SlabPool:
    """A zeroed, unfilled pool of ``capacity`` rows (the buffers a capacity's
    chunk graph is captured on before the slab grows into them)."""
    return SlabPool(
        x=torch.zeros((capacity, d), dtype=torch.float32, device=device),
        oracle_y=torch.zeros(capacity, dtype=torch.int32, device=device),
        labeled_mask=torch.zeros(capacity, dtype=torch.bool, device=device),
        codes=torch.zeros((capacity, d), dtype=torch.int32, device=device),
        n_filled=torch.zeros((), dtype=torch.int32, device=device),
        slab_rows=slab_rows,
    )


def init_slab_pool(x, y, labeled_mask, edges: torch.Tensor, slab_rows: int) -> SlabPool:
    """Allocate a slab pool holding the initial points, on ``edges``'
    device. The unfilled tail is zeros with ``labeled_mask=False``: the
    watermark, not the stored values, keeps it out of every program."""
    from distributed_active_learning_tpu_torch.ops import trees_train

    dev = edges.device
    x = torch.as_tensor(np.asarray(x, dtype=np.float32) if not torch.is_tensor(x) else x,
                        dtype=torch.float32).to(dev)
    y = torch.as_tensor(np.asarray(y, dtype=np.int32) if not torch.is_tensor(y) else y,
                        dtype=torch.int32).to(dev)
    mask = torch.as_tensor(np.asarray(labeled_mask, dtype=bool)
                           if not torch.is_tensor(labeled_mask) else labeled_mask,
                           dtype=torch.bool).to(dev)
    n = x.shape[0]
    pool = empty_slab_pool(slab_capacity(n, slab_rows), x.shape[1], slab_rows, dev)
    pool.x[:n] = x
    pool.oracle_y[:n] = y
    pool.labeled_mask[:n] = mask
    pool.codes[:n] = trees_train.code_features(x, edges)
    pool.n_filled.fill_(n)
    return pool


def grow_slab(pool: SlabPool, n_slabs: int = 1, into: SlabPool = None) -> SlabPool:
    """Extend capacity by ``n_slabs`` fresh (unfilled) slabs; the watermark
    and all filled content carry over. ``into`` is a zeroed pool of the new
    capacity allocated ahead (:func:`empty_slab_pool`, the buffers a chunk
    graph was captured on): the content is copied into it, on the current
    stream, and it is returned; else new tensors are allocated."""
    cap = pool.capacity + n_slabs * pool.slab_rows
    if into is None:
        into = empty_slab_pool(cap, pool.x.shape[1], pool.slab_rows, pool.x.device)
    elif into.capacity != cap or into.slab_rows != pool.slab_rows:
        raise ValueError(f"a pool of {into.capacity} rows ({into.slab_rows} a slab) cannot take "
                         f"the growth of {pool.capacity} rows by {n_slabs} slab(s) of "
                         f"{pool.slab_rows}")
    old = pool.capacity
    for name in ("x", "oracle_y", "labeled_mask", "codes"):
        getattr(into, name)[:old].copy_(getattr(pool, name))
    into.n_filled.copy_(pool.n_filled)
    return into


def flat_state(pool: SlabPool, key: torch.Tensor, round_: torch.Tensor) -> state_lib.PoolState:
    """The :class:`~..runtime.state.PoolState` view a chunk reads: the SAME
    tensors (no copies), the watermark riding as ``n_filled`` so selection,
    fit and metrics mask the unfilled tail. ``key`` and ``round_`` are the
    carry form's device tensors."""
    return state_lib.PoolState(
        x=pool.x,
        oracle_y=pool.oracle_y,
        labeled_mask=pool.labeled_mask,
        key=key,
        round=round_,
        n_filled=pool.n_filled,
    )


def make_ingest_fn():
    """Build the in-place append.

    ``ingest(pool, edges, block_x, block_y, count, fill) -> pool`` writes a
    fixed-width block at the watermark ``fill`` (the host's copy of
    ``n_filled``, so the write needs no read from the device) into the
    slab's own tensors, bins the block against the service's edges on the
    device, and advances ``n_filled`` by ``count`` (the block's real rows;
    pad rows land past the new watermark). Every write is in place and
    queued on the current stream, behind any chunk already running there.
    The caller must guarantee ``fill + block_rows <= capacity`` (grow
    first)."""
    from distributed_active_learning_tpu_torch.ops import trees_train

    def ingest(pool: SlabPool, edges: torch.Tensor, block_x: torch.Tensor,
               block_y: torch.Tensor, count: int, fill: int) -> SlabPool:
        rows = block_x.shape[0]
        if fill + rows > pool.capacity:
            raise ValueError(f"a block of {rows} rows at fill {fill} overruns capacity "
                             f"{pool.capacity}; grow the slab first")
        pool.x[fill:fill + rows].copy_(block_x)
        pool.oracle_y[fill:fill + rows].copy_(block_y)
        pool.codes[fill:fill + rows].copy_(trees_train.code_features(block_x, edges))
        pool.n_filled.add_(count)
        return pool

    return ingest


def score_body(forest, queries: torch.Tensor):
    """The resident-forest scoring computation, shared by the single-tenant
    endpoint and the grouped path (``serving/tenants.py``): ``(scores[B],
    entropy[B])`` float32, the model's confidence per query (P(class 1) for a
    binary forest, the predicted class's probability for a multiclass one)
    and its predictive entropy."""
    from distributed_active_learning_tpu_torch.ops import forest_eval, scoring, trees_multi

    if trees_multi.is_multi(forest):
        probs = trees_multi.proba_multi(forest, queries)
        scores = torch.max(probs, dim=-1).values
        ent = trees_multi.entropy_multi(probs)
    else:
        p = forest_eval.proba(forest, queries)
        scores = p
        ent = scoring.full_entropy(p)
    return scores.to(torch.float32), ent.to(torch.float32)


def make_score_fn():
    """Build the scoring endpoint ``score(forest, queries[B, d]) ->
    (scores[B], entropy[B])``: fixed query width ``B`` (callers pad), no
    pool dependence; with ``kernel="pallas"`` one K1 launch a call."""

    def score(forest, queries: torch.Tensor):
        return score_body(forest, queries)

    return score


def _forget_heaps(forest) -> None:
    """Drop the heap operands a :class:`~..ops.trees_pallas.PallasForest`
    cached from its path matrices (a graph must record the packing, so that
    a replay packs the forest its buffers hold then)."""
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest

    for f in (forest.planes if isinstance(forest, MultiForest) else (forest,)):
        vars(f).pop("heap", None)


class GraphedScore:
    """The score endpoint on the card as ONE CUDA graph: :func:`score_body`
    over a static query buffer and a static copy of the resident forest,
    captured at the first call on the current stream (a side stream: the
    tenant's score stream; thread-local capture mode, so the precompile
    worker may capture beside it) and replayed by every later one. A call
    with another forest than the last copies its tensors into the graph's
    forest buffers first (on the current stream, which the caller has made
    wait for that forest's fit); a forest of another shape, or another
    query width, is captured anew (``captures`` counts it). The outputs are
    the graph's static buffers: read them before the next call. The eager
    body costs ~800 small launches a call (the entropy's f32 ``log2`` and
    the tree mean in XLA's order are written out op by op), the graph
    one."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self._graph = None
        self._src = None
        self._forest = None
        self._q = None
        self._out = None
        self._launches: dict = {}

    def _capture(self) -> None:
        from distributed_active_learning_tpu_torch.runtime.loop import capture_thread_local

        score_body(self._forest, self._q)  # warm-up: per-stream library state
        torch.cuda.current_stream(self._q.device).synchronize()  # audit: ok[DAL101] (pre-capture)
        _forget_heaps(self._forest)
        graph = torch.cuda.CUDAGraph()
        out, launches = capture_thread_local(graph, lambda: score_body(self._forest, self._q))
        self._graph, self._out, self._launches = graph, out, launches
        self.captures += 1

    def __call__(self, forest, queries: torch.Tensor):
        from distributed_active_learning_tpu_torch.runtime.checkpoint import forest_leaves
        from distributed_active_learning_tpu_torch.runtime.loop import replay_counted

        if torch.cuda.current_stream(queries.device) == torch.cuda.default_stream(queries.device):
            raise RuntimeError("GraphedScore runs on a side stream (a capture cannot use the "
                               "default one): call it under torch.cuda.stream(...)")
        if forest is not self._src:
            leaves = forest_leaves(forest)
            mine = None if self._forest is None else forest_leaves(self._forest)
            if mine is None or [_layout(t) for t in mine] != [_layout(t) for t in leaves]:
                self._forest = _clone_forest(forest)
                self._graph = None
            else:
                for dst, src in zip(mine, leaves):
                    if not _broadcast(dst):  # a shared constant is the same tensor
                        dst.copy_(src)
            self._src = forest
        if self._q is None or self._q.shape != queries.shape:
            self._q = torch.empty_like(queries)
            self._graph = None
        self._q.copy_(queries)
        if self._graph is None:
            self._capture()
        replay_counted(self._graph, self._launches)
        self.replays += 1
        return self._out


def _broadcast(t: torch.Tensor) -> bool:
    """A broadcast view (a stride of 0): a device fit's path matrix and
    targets, views of one cached constant a depth, which the leaf kernel
    recognizes by storage (``trees_pallas.heap_depth``)."""
    return 0 in t.stride()


def _layout(t: torch.Tensor) -> tuple:
    """What a forest tensor must share with the graph's copy to be loaded
    into it: shape and dtype, and for a broadcast constant its storage."""
    return (tuple(t.shape), t.dtype) + ((t.data_ptr(), t.stride()) if _broadcast(t) else ())


def _clone_forest(forest):
    """``forest`` with every tensor cloned (its static copy in a graph), but
    the broadcast constants, which stay the very views they are."""
    from distributed_active_learning_tpu_torch.runtime.checkpoint import (
        forest_from_leaves,
        forest_leaves,
    )

    return forest_from_leaves(forest, [t if _broadcast(t) else t.clone()
                                       for t in forest_leaves(forest)])


def pad_block(x: np.ndarray, y: np.ndarray, block_rows: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-side pad of an arrival to the ingest width; returns
    ``(block_x, block_y, count)`` with ``count`` the real rows."""
    n = x.shape[0]
    if n > block_rows:
        raise ValueError(f"arrival of {n} rows exceeds ingest block {block_rows}")
    bx = np.zeros((block_rows, x.shape[1]), np.float32)
    bx[:n] = x
    by = np.zeros((block_rows,), np.int32)
    by[:n] = y
    return bx, by, n


# --------------------------------------------------------------------------
# The pod: the pool over a mesh's data axis
# --------------------------------------------------------------------------

#: Invalid-slot marker in rebalance index maps (valid global indices are >= 0).
MOVED_SENTINEL = -1

_POOL_FIELDS = ("x", "oracle_y", "labeled_mask", "codes")


def _n_data(mesh) -> int:
    from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib

    return mesh.shape[mesh_lib.AXIS_DATA]


def shard_slab_pool(pool: SlabPool, mesh) -> SlabPool:
    """Place a slab pool over ``mesh``'s data axis with a per-shard
    watermark: each field a :class:`~..parallel.mesh.Sharded` of the
    contiguous blocks ``[s * rows, (s + 1) * rows)``, ``n_filled`` the
    ``[S]`` int32 leaf on the mesh's first device. A scalar ``n_filled`` is
    split with ``parallel.mesh.shard_fill_watermark`` (a single-slab pool
    fills contiguously, so the split is exact); a ``[S]`` leaf is checked
    and kept. The capacity must divide by the data axis."""
    from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib

    n_shards = _n_data(mesh)
    if pool.capacity % n_shards:
        raise ValueError(
            f"slab capacity {pool.capacity} not divisible by data axis {n_shards}")
    nf = pool.n_filled
    if nf.ndim == 0:
        nf = mesh_lib.shard_fill_watermark(nf, pool.capacity, n_shards)
    elif tuple(nf.shape) != (n_shards,):
        raise ValueError(
            f"per-shard n_filled leaf {tuple(nf.shape)} does not match the data axis "
            f"({n_shards} shards)")
    # Fresh blocks: a block on the pool's own device would otherwise be a
    # view of it, and the in-place ingest would write through.
    placed = {f: mesh_lib.shard_rows(mesh_lib.gather(getattr(pool, f)), mesh).map(torch.clone)
              for f in _POOL_FIELDS}
    return pool.replace(n_filled=nf.to(mesh.first, torch.int32).clone(), **placed)


def route_to_shard(fills) -> int:
    """The ingest router: the least-filled shard's index (ties to the
    lowest). Host-side and O(S): it reads the ``[S]`` watermark vector only."""
    return int(np.argmin(_host(fills)))


def make_sharded_ingest_fn(mesh):
    """Build the per-shard append.

    ``ingest(pool, edges, block_x, block_y, count, shard) -> (pool,
    global_fill)`` writes the block at shard ``shard``'s own watermark into
    that shard's block tensors, in place, bins it against ``edges`` on the
    shard's device, and advances ``n_filled[shard]`` by ``count``; no other
    shard's rows change. The write position is read on the device
    (``n_filled[shard]``, clamped so that the block fits, as
    ``dynamic_update_slice`` clamps), so nothing goes to the host.
    ``global_fill`` is the post-ingest total, a 0-d int32 on the mesh's first
    device. The same contract as :func:`make_ingest_fn`: each call returns a
    fresh closure for one capacity, and the caller must guarantee the shard
    has room (``fills[shard] + block_rows <= capacity // S``; grow first).
    Over processes every rank makes the same call: the ranks that hold
    ``shard`` write its rows, and every rank advances the watermark."""
    from distributed_active_learning_tpu_torch.ops import trees_train

    n_shards = _n_data(mesh)

    def ingest(pool: SlabPool, edges: torch.Tensor, block_x: torch.Tensor,
               block_y: torch.Tensor, count, shard) -> Tuple[SlabPool, torch.Tensor]:
        shard = int(shard)
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} is not one of the mesh's {n_shards} data shards")
        rows, b = pool.x.n_local, block_x.shape[0]
        if b > rows:
            raise ValueError(f"a block of {b} rows exceeds a shard's {rows} rows")
        if shard in pool.x.local_ids:
            xb = pool.x.block(shard)
            dev = xb.device
            start = torch.clamp(pool.n_filled[shard].to(dev, torch.int64), 0, rows - b)
            pos = start + torch.arange(b, device=dev)
            bx = block_x.to(dev, torch.float32)
            xb.index_copy_(0, pos, bx)
            pool.oracle_y.block(shard).index_copy_(0, pos, block_y.to(dev, torch.int32))
            pool.codes.block(shard).index_copy_(0, pos,
                                                trees_train.code_features(bx, edges.to(dev)))
        pool.n_filled[shard] += count
        return pool, pool.n_filled.sum(dtype=torch.int32)

    return ingest


def grow_sharded_slab(pool: SlabPool, mesh, n_slabs: int = 1) -> SlabPool:
    """Extend EVERY shard's block by ``n_slabs`` fresh slabs, shard-locally:
    each block is padded at its tail (zeros, mask False) on its own device,
    the global capacity grows by ``S * n_slabs * slab_rows`` and the
    per-shard watermark carries over (local fills are positions within a
    block, which grew only at its tail). Global row indices RENUMBER (the
    ``shard * rows`` strides widen): every index map held across a growth is
    stale."""
    from distributed_active_learning_tpu_torch.parallel.mesh import Sharded

    pad = n_slabs * pool.slab_rows
    n_shards = _n_data(mesh)

    def grow(a: Sharded) -> Sharded:
        if (a.n_shards or len(a.blocks)) != n_shards:
            raise ValueError(f"the pool is sharded over {a.n_shards or len(a.blocks)} data "
                             f"shards, the mesh has {n_shards}")
        grown = a.map(lambda blk: torch.cat([blk, blk.new_zeros((pad, *blk.shape[1:]))]))
        return dataclasses.replace(grown, n_rows=a.n_rows + n_shards * pad)

    return pool.replace(**{f: grow(getattr(pool, f)) for f in _POOL_FIELDS})


def rebalance_plan(fills, block_rows: int) -> torch.Tensor:
    """The epoch's move matrix ``[S, S]`` int32: ``plan[i, j]`` rows go from
    shard ``i`` to shard ``j``. Donors are shards above the floor target
    ``total // S``, receivers below it; each shard moves at most
    ``block_rows`` rows an epoch, and the matching is the interval overlap of
    the donors' and the receivers' cumulative runs: exact, order-stable,
    and never more than the smaller of the total excess and deficit."""
    fills = torch.as_tensor(fills).to(torch.int32)
    n_shards = fills.shape[0]
    target = torch.div(fills.sum(dtype=torch.int32), n_shards, rounding_mode="floor")
    excess = torch.clamp(fills - target, 0, block_rows)
    deficit = torch.clamp(target - fills, 0, block_rows)
    dc = torch.cumsum(excess, 0)
    rc = torch.cumsum(deficit, 0)
    dlo, rlo = dc - excess, rc - deficit
    overlap = (torch.minimum(dc[:, None], rc[None, :])
               - torch.maximum(dlo[:, None], rlo[None, :]))
    return torch.clamp(overlap, 0, block_rows).to(torch.int32)


def rebalance_trigger(fills, ratio: float = 2.0) -> bool:
    """Host-side epoch trigger: fire when max/min shard fill exceeds
    ``ratio`` (an empty shard next to a non-empty one always fires)."""
    r = _fill_ratio(fills)
    return r is not None and r > ratio


def _host(fills) -> np.ndarray:
    return fills.cpu().numpy() if torch.is_tensor(fills) else np.asarray(fills)


def _fill_ratio(fills) -> Optional[float]:
    """max/min shard fill as a float (inf when an empty shard sits next to a
    non-empty one), or None when the vector cannot be imbalanced."""
    f = _host(fills)
    if f.size <= 1 or f.max() == 0:
        return None
    if f.min() == 0:
        return float("inf")
    return float(f.max()) / float(f.min())


class RebalanceHysteresis:
    """Thrash-proof epoch trigger around :func:`rebalance_trigger`, the JAX
    package's: the trigger becomes active when the fill ratio exceeds
    ``enter_ratio`` and stays active until it drops to ``exit_ratio`` or
    below, and while active it fires at most once every ``min_interval``
    calls of :meth:`update` (one call a step). ``fired``,
    ``suppressed_interval`` and ``suppressed_band`` count its decisions."""

    def __init__(self, enter_ratio: float = 2.0, exit_ratio: float = 1.5,
                 min_interval: int = 4):
        if exit_ratio > enter_ratio:
            raise ValueError(
                f"exit_ratio ({exit_ratio}) must not exceed enter_ratio ({enter_ratio}) "
                "— the band would invert")
        self.enter_ratio = float(enter_ratio)
        self.exit_ratio = float(exit_ratio)
        self.min_interval = int(min_interval)
        self._active = False
        # Primed so that the first excursion past enter_ratio fires at once.
        self._since_fire = self.min_interval
        self.fired = 0
        self.suppressed_interval = 0
        self.suppressed_band = 0

    @property
    def active(self) -> bool:
        """True between entering above ``enter_ratio`` and dropping to
        ``exit_ratio``."""
        return self._active

    def update(self, fills) -> bool:
        """Advance one step with the current ``[S]`` fill vector; True means
        run a rebalance epoch now."""
        self._since_fire += 1
        ratio = _fill_ratio(fills)
        if ratio is None:
            self._active = False
            return False
        if self._active and ratio <= self.exit_ratio:
            self._active = False
        if not self._active and ratio > self.enter_ratio:
            self._active = True
        if not self._active:
            if ratio > self.exit_ratio:
                self.suppressed_band += 1
            return False
        if self._since_fire < self.min_interval:
            self.suppressed_interval += 1
            return False
        self._since_fire = 0
        self.fired += 1
        return True


def make_rebalance_fn(mesh, block_rows: int):
    """Build the rebalance epoch.

    ``rebalance(pool) -> (pool, moved_src, moved_dst)`` runs one epoch: the
    shards' fills are gathered (``collectives.gather_fills``) and read on
    the host once, every shard takes the same :func:`rebalance_plan`, each
    donor packs its TOPMOST filled rows (content, label, mask bit, codes)
    into a per-target ``[S, block_rows]`` buffer (slot ``(j, b)`` holds its
    row ``fill - sent + off[j] + b``), ONE window-sized all-to-all
    (``collectives.exchange_blocks``) swaps the buffers, and each receiver
    appends the valid rows at its watermark in the JAX package's stable
    order: valid slots first, in sender order (``argsort(~valid,
    stable=True)``), the invalid ones dropped. Donor rows past the shrunk
    watermark get their labeled bits cleared. Every write is in place.

    ``moved_src`` / ``moved_dst`` ``[S, S * block_rows]`` int32 (on the
    mesh's first device) are the epoch's global-index map, padded with
    :data:`MOVED_SENTINEL`: row ``s`` lists the rows shard ``s`` received as
    ``old global index -> new global index``. A balanced pool gives an
    all-zero plan, and the epoch changes nothing.

    Over processes every rank runs the epoch at the same point: the fills
    are gathered and the all-to-all exchanged across the processes, each
    rank packs its own shards' donors and appends its own shards' receipts,
    and every rank takes the same plan and the same index maps (the plan
    and the fills alone give them: a receiver's valid slots hold, in sender
    order, each sender's rows from its shrunk watermark on). COLLECTIVE."""
    from distributed_active_learning_tpu_torch.parallel import collectives

    n_shards = _n_data(mesh)
    b = int(block_rows)
    flat = n_shards * b
    spread = mesh.spread

    def rebalance(pool: SlabPool):
        rows = pool.capacity // n_shards
        mine = pool.x.local_ids
        fills_dev = collectives.gather_fills([pool.n_filled[s] for s in mine], spread)
        fills = fills_dev.cpu()
        plan = rebalance_plan(fills, b)
        fl = [int(v) for v in fills.tolist()]
        sent = [int(v) for v in plan.sum(1).tolist()]
        recv = [int(v) for v in plan.sum(0).tolist()]
        pl = plan.tolist()
        # Pack: slot (j, t) of shard i holds its row fill - sent + off[j] + t
        # where t < plan[i, j] (clamped into the block, as the JAX gather
        # reads a clamped row for the invalid slots).
        send = {f: [] for f in _POOL_FIELDS + ("valid",)}
        for i in mine:
            dev = pool.x.block(i).device
            counts = torch.tensor(pl[i], dtype=torch.int64)
            off = torch.cumsum(counts, 0) - counts
            slot = torch.arange(b, dtype=torch.int64)
            valid = slot[None, :] < counts[:, None]
            src = torch.clamp(fl[i] - sent[i] + off[:, None] + slot[None, :], 0, rows - 1)
            src_d = src.reshape(-1).to(dev)
            for f in _POOL_FIELDS:
                blk = getattr(pool, f).block(i)
                send[f].append(blk.index_select(0, src_d).reshape(n_shards, b, *blk.shape[1:]))
            send["valid"].append(valid.to(dev))
        recv_blocks = {f: collectives.exchange_blocks(v, spread) for f, v in send.items()}
        # The map, on the host from the plan: receiver j's rows come, in
        # sender order, from each sender i's rows fill - sent + off[j] + t.
        moved_src = torch.full((n_shards, flat), MOVED_SENTINEL, dtype=torch.int32)
        moved_dst = torch.full((n_shards, flat), MOVED_SENTINEL, dtype=torch.int32)
        for j in range(n_shards):
            src = [i * rows + fl[i] - sent[i] + sum(pl[i][:j]) + t
                   for i in range(n_shards) for t in range(pl[i][j])]
            moved_src[j, : recv[j]] = torch.tensor(src, dtype=torch.int32)
            moved_dst[j, : recv[j]] = j * rows + fl[j] + torch.arange(recv[j], dtype=torch.int32)
        new_fill = [fl[s] - sent[s] + recv[s] for s in range(n_shards)]
        for j, got_valid in zip(mine, recv_blocks["valid"]):
            dev = pool.x.block(j).device
            valid = got_valid.reshape(flat)
            # Valid slots first, stable in sender order; the rest dropped.
            order = torch.argsort((~valid).to(torch.int32), stable=True)[: recv[j]]
            if recv[j]:
                pos = fl[j] + torch.arange(recv[j], device=dev)
                for f in _POOL_FIELDS:
                    got = recv_blocks[f][j - mine[0]]
                    getattr(pool, f).block(j).index_copy_(
                        0, pos, got.reshape(flat, *got.shape[2:]).index_select(0, order))
            # The tail contract: no labeled bit past a watermark (a donor's
            # shipped rows fall past its shrunk one).
            pool.labeled_mask.block(j)[new_fill[j]:].fill_(False)
        pool.n_filled.copy_(torch.tensor(new_fill, dtype=torch.int32))
        first = mesh.first
        return pool, moved_src.to(first), moved_dst.to(first)

    return rebalance
