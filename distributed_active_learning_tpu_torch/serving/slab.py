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

The pod-sharded half of the JAX module (``shard_slab_pool`` and the
rebalancing epochs) comes with the mesh-and-pod slice (ROADMAP queue 1
item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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
        torch.cuda.current_stream(self._q.device).synchronize()
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


_POD_HALF = ("shard_slab_pool", "route_to_shard", "make_sharded_ingest_fn", "grow_sharded_slab",
             "rebalance_plan", "rebalance_trigger", "RebalanceHysteresis", "make_rebalance_fn",
             "MOVED_SENTINEL")


def __getattr__(name: str):
    if name in _POD_HALF:
        raise NotImplementedError(
            f"serving.slab.{name} is the pod-sharded slab pool, which comes with the "
            "mesh-and-pod slice (ROADMAP queue 1 item 8)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
