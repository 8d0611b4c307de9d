"""Pipelined chunk dispatch: overlap device execution with host touchdowns
(the port of ``runtime/pipeline.py``).

The chunked driver (``runtime/loop.py::make_chunk_fn``) runs K AL rounds per
launch; this module drives those launches:

- **Chunks dispatch ahead of their results.** ``dispatch`` returns at once (a
  CUDA graph replay is queued on the stream); up to ``depth`` chunks are in
  flight. The carried state stays on the device and threads from launch to
  launch without the host reading it.
- **The stop decision blocks only on two scalars**, the chunk's post-chunk
  labeled count and its active-round count (:class:`ChunkExtras`).
- **The ys come back asynchronously.** Right behind each dispatch, on the
  same stream, :func:`start_host_copy` queues a non-blocking copy of the
  extras and the stacked ys into pinned host buffers of that chunk and
  records an event. A replayed graph writes into the same device buffers
  every time, and at depth 2 chunk N + 1 is dispatched before chunk N's
  scalars are read: stream order puts chunk N's copy before chunk N + 1's
  replay, so each chunk's values land in its own host buffers. The loop
  waits on that event, never on the device.
- **Touchdowns overlay the next chunk's execution.** After chunk N's scalars
  arrive, chunk N + 2 is dispatched and only then does chunk N's touchdown
  (record append, logging) run.
- **One speculative chunk may run past the stop point.** With ``depth=2``
  chunk N + 1 launches before chunk N's outcome is known; if N stopped, N + 1
  is wholly inactive: its masked no-op rounds freeze the carried state bit for
  bit and append nothing, so results equal the serial driver's. ``depth=1``
  is the strict launch -> block -> touchdown order.

The chunk's carry is updated in place by the next launch (the graph's static
buffers), so a touchdown must not read the carry it is handed once a later
chunk was dispatched. A checkpointing driver copies the carry's mask, key
and round into fresh buffers at dispatch instead (:class:`CarrySnapshots`)
and writes the copy at the touchdown.

The drive feeds the ops plane (``runtime/obs.py``: the in-flight depth, the
``pipeline_touchdown`` heartbeat, the touchdown-hidden fraction, the chunk
count) and the flight recorder (``dispatch`` and ``touchdown`` events), as
the JAX module does.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, NamedTuple, Optional

import torch

from distributed_active_learning_tpu_torch.runtime import obs, telemetry


class ChunkExtras(NamedTuple):
    """The two scalar chunk outputs the host stop decision blocks on.

    Everything else a chunk produces (the stacked ys, the carried state) is
    read after them or never read at all; these two int32 scalars are the
    whole launch-to-launch control dependency.
    """

    n_labeled_after: Any  # exact post-chunk labeled count (real rows only)
    n_active: Any         # how many of the chunk's rounds were active


@dataclasses.dataclass
class PipelineStats:
    """Aggregate dispatch-vs-touchdown overlap accounting for one drive."""

    chunks: int = 0
    launch_seconds: float = 0.0     # dispatch -> stop-scalars-ready, summed
    touchdown_seconds: float = 0.0  # host bookkeeping wall, summed
    overlap_seconds: float = 0.0    # touchdown wall spent with a chunk in flight
    vetoed: int = 0                 # speculative launches proven inactive a priori

    @property
    def touchdown_hidden_fraction(self) -> float:
        """Fraction of total touchdown wall the device never saw (it was
        executing another chunk at the time). 0.0 for the serial order
        (depth=1), approaching 1.0 when every touchdown hides behind the next
        chunk's execution."""
        if self.touchdown_seconds <= 0.0:
            return 0.0
        return self.overlap_seconds / self.touchdown_seconds


@dataclasses.dataclass
class _InFlight:
    index: int
    copy: "HostCopy"
    out_state: Any
    t_dispatch: float


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        mapped = [_map_leaves(fn, t) for t in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    if isinstance(tree, list):
        return [_map_leaves(fn, t) for t in tree]
    return fn(tree)


class HostCopy:
    """A chunk's outputs on their way to the host: ``tree`` holds pinned
    host tensors (for CUDA leaves; anything else is kept as it was), valid
    once :meth:`wait` has returned."""

    def __init__(self, tree: Any, event: Optional["torch.cuda.Event"]):
        self._tree = tree
        self._event = event

    def wait(self) -> Any:
        """Block until the copies have landed (on their event, not on the
        device) and return the host-side tree."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._tree


def start_host_copy(tree: Any) -> HostCopy:
    """Queue a non-blocking device-to-host copy of every CUDA tensor in
    ``tree`` (nested tuples and lists) into fresh pinned buffers on the
    current stream, and record an event behind them. The copy completes under
    the next chunk's execution, so the touchdown finds the bytes on the host.
    Leaves that are not CUDA tensors (CPU tensors of the eager chunk, plain
    ints of a test's fake dispatch) pass through."""
    device = None

    def to_host(leaf):
        nonlocal device
        if not (torch.is_tensor(leaf) and leaf.is_cuda):
            return leaf
        device = leaf.device
        host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        host.copy_(leaf, non_blocking=True)
        return host

    host_tree = _map_leaves(to_host, tree)
    event = None
    if device is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return HostCopy(host_tree, event)


class ChunkDriveControl:
    """Stop/veto/checkpoint arithmetic for chunked experiment drivers (host
    arithmetic, as in the JAX package, whose forest and neural loops share
    it): when a speculative dispatch is provably inactive
    (:meth:`may_dispatch` — max_rounds bound, or the labeled-count lattice
    reaching the label cap), when to stop after a chunk's scalars arrive
    (:meth:`continue_after` — short chunk / cap reached / round quota spent),
    and the first-touchdown-at-or-after-each-multiple checkpoint cadence.
    One implementation here keeps the two drivers from drifting.

    The lattice veto is SAFE, never lossy: pre-reveal counts advance by
    exactly ``window`` per active round except at pool-exhaustion short
    reveals — and after a short reveal the count equals the pool size, so
    every later round is inactive anyway. Hence ``lattice >= cap`` implies
    the real round is inactive too.
    """

    def __init__(
        self,
        chunk_size: int,
        window: int,
        label_cap: int,
        max_rounds: Optional[int],
        n_known: int,
        start_round: int = 0,
    ):
        self.chunk_size = chunk_size
        self.window = window
        self.label_cap = label_cap
        self.max_rounds = max_rounds
        self.n_known = n_known
        self.rounds_done = 0
        self.round_idx = start_round
        self._ckpt_mark = start_round

    @property
    def already_done(self) -> bool:
        """True when not even the first chunk should launch."""
        return self.n_known >= self.label_cap or (
            self.max_rounds is not None and self.max_rounds <= 0
        )

    def veto_reason(self, idx: int) -> Optional[str]:
        """Why chunk ``idx`` would be vetoed (None = dispatchable). The
        reason string rides the driver's ``launch_veto`` JSONL event, so the
        auditor's runtime counterpart can assert veto counts per cause
        instead of inferring them from missing launches."""
        if self.max_rounds is not None and idx * self.chunk_size >= self.max_rounds:
            return "max_rounds_bound"
        if self.n_known + idx * self.chunk_size * self.window >= self.label_cap:
            return "label_cap_lattice"
        return None

    def may_dispatch(self, idx: int) -> bool:
        return self.veto_reason(idx) is None

    def continue_after(self, n_labeled_after: int, n_active: int) -> bool:
        self.rounds_done += n_active
        if n_active < self.chunk_size:
            return False  # an in-chunk round hit the budget/pool/end stop
        if n_labeled_after >= self.label_cap:
            return False
        if self.max_rounds is not None and self.rounds_done >= self.max_rounds:
            return False
        return True

    # -- chunk-boundary checkpoint cadence (runtime/checkpoint.py notes):
    # saved at the first touchdown at/after each checkpoint_every multiple.

    def note_round(self, round_idx: int) -> None:
        """Record the last active round a touchdown appended."""
        self.round_idx = round_idx

    def checkpoint_due(self, every: int) -> bool:
        return self.round_idx // every > self._ckpt_mark // every

    def checkpoint_done(self) -> None:
        self._ckpt_mark = self.round_idx


class CarrySnapshots:
    """Dispatch-time copies of the carry fields a checkpoint needs, keyed by
    chunk index.

    A CUDA graph writes its new carry back into the same static buffers at
    every replay, so with ``depth = 2`` chunk N + 1 has overwritten chunk
    N's mask, key and round before chunk N's touchdown runs. ``take`` runs
    right after chunk N's dispatch: ``snap_fn`` (``runtime.loop.
    ckpt_snapshot``) clones the fields into fresh buffers on the chunk's
    stream, which orders the copy after chunk N and before chunk N + 1, and
    their host copy is queued behind it. ``pop`` at chunk N's touchdown
    hands back the host tensors.
    """

    def __init__(self, snap_fn):
        self._snap = snap_fn
        self._held: dict = {}

    def take(self, index: int, *leaves) -> None:
        self._held[index] = start_host_copy(self._snap(*leaves))

    def pop(self, index: int):
        """The host copy of the snapshot taken at ``index``'s dispatch (None
        if none was taken). Call from EVERY touchdown, also those that do
        not checkpoint, so each snapshot is released."""
        copy = self._held.pop(index, None)
        return None if copy is None else copy.wait()


def run_pipelined(
    state: Any,
    *,
    dispatch: Callable[[Any, int], tuple],
    touchdown: Callable[[int, int, int, Any, Any, float], None],
    continue_after: Callable[[int, int], bool],
    depth: int = 2,
    on_launch: Optional[Callable[..., None]] = None,
    may_dispatch: Optional[Callable[[int], bool]] = None,
    on_veto: Optional[Callable[[int], None]] = None,
) -> tuple:
    """Drive chunk launches with up to ``depth`` in flight; returns
    ``(final_state, PipelineStats)``.

    - ``dispatch(state, chunk_index) -> (new_state, ChunkExtras, ys)`` must be
      non-blocking (a graph replay). The returned state is device-resident
      and threads into the next dispatch; the pipeline never reads it.
    - ``continue_after(n_labeled_after, n_active) -> bool`` is the host stop
      decision, called once per chunk IN ORDER with the two scalars as plain
      ints. Returning False stops further dispatch; chunks already in flight
      still get their touchdown (they are wholly-inactive no-ops).
    - ``touchdown(chunk_index, n_labeled_after, n_active, ys, out_state,
      launch_seconds)`` does the host bookkeeping (record append, logging)
      on the host copies of the ys. Runs strictly in chunk order, overlapped
      with in-flight execution when ``depth > 1``. ``out_state`` is that
      chunk's output carry, which a later dispatch updates in place (see the
      module docstring).
    - ``on_launch(seconds=, touchdown_seconds=, overlap_seconds=,
      touchdown_hidden_fraction=)`` (optional) receives per-chunk timing once
      the chunk's touchdown finished (the hook a launch tracker hangs on).
    - ``may_dispatch(chunk_index) -> bool`` (optional) vetoes a dispatch the
      caller can PROVE would be wholly inactive (a-priori bounds: max_rounds,
      or the labeled-count lattice reaching the label cap) — the loop then
      skips the speculative launch instead of burning a masked no-op chunk.
      Must be monotone (once False, False forever). Stops the host can NOT
      predict (pool exhaustion short-reveals) still rely on speculation +
      masked no-ops, which stay bit-exact.
    - ``on_veto(chunk_index)`` (optional) fires ONCE per vetoed index, at the
      moment the veto first blocks a would-be dispatch — the structured
      record of the speculative launch that never happened.
      Vetoes are also tallied in ``PipelineStats.vetoed``. A veto observed
      after the stop decision is NOT recorded: nothing would have been
      dispatched regardless, so counting it would overstate the vetoes.

    ``depth=1`` degenerates to the serial launch -> block -> touchdown order:
    no speculation, no overlap, bit-identical behavior AND ordering to the
    pre-pipeline driver.
    """
    if depth < 1:
        raise ValueError(f"pipeline depth must be >= 1, got {depth}")
    stats = PipelineStats()
    inflight: deque = deque()
    stop = False
    next_index = 0
    last_ready = None  # when the previous chunk's scalars resolved
    vetoed_seen = set()  # indices whose veto was already recorded

    def _can_dispatch():
        if stop:
            return False
        if may_dispatch is None or may_dispatch(next_index):
            return True
        if next_index not in vetoed_seen:
            # First observation of this index's veto: the fill loops re-probe
            # the same index every iteration, but the skipped launch happened
            # (didn't happen) exactly once.
            vetoed_seen.add(next_index)
            stats.vetoed += 1
            if on_veto is not None:
                on_veto(next_index)
        return False

    def _dispatch_one():
        nonlocal state, next_index
        t0 = time.perf_counter()
        state, extras, ys = dispatch(state, next_index)
        # Queue the copy of everything the host will read right behind the
        # launch, before a later dispatch can overwrite the device buffers.
        copy = start_host_copy((extras, ys))
        inflight.append(_InFlight(next_index, copy, state, t0))
        # Live ops plane: the in-flight depth a /metrics scrape shows moving.
        obs.gauge("pipeline_inflight", "chunk launches currently in flight").set(len(inflight))
        telemetry.flight_record("dispatch", index=next_index, inflight=len(inflight), depth=depth)
        next_index += 1

    while True:
        # Fill the launch window. The chunk beyond the oldest un-consumed one
        # is speculative (its predecessor's outcome is unknown) — masked
        # no-op rounds make an overrun free and bit-exact. The capacity check
        # runs FIRST: _can_dispatch records vetoes, and a veto only counts
        # when a launch slot was actually open for the skipped dispatch.
        while len(inflight) < depth and _can_dispatch():
            _dispatch_one()
        if not inflight:
            break
        head = inflight.popleft()
        # The ONLY blocking wait: the event behind this chunk's host copy.
        # The chunk must finish for its two scalars to resolve.
        extras, ys = head.copy.wait()
        n_labeled_after = int(extras.n_labeled_after)
        n_active = int(extras.n_active)
        ready = time.perf_counter()
        # Wall attributed to THIS chunk: from the later of its dispatch and
        # the previous chunk's completion, to its own completion. At depth 1
        # that is plain dispatch->ready; at depth >= 2 a chunk dispatched
        # while its predecessor still executed must not re-count the
        # predecessor's device time (naive dispatch->ready would ~double
        # every per-launch/per-round figure and make launch seconds sum past
        # real wall clock).
        since = (
            head.t_dispatch
            if last_ready is None
            else max(head.t_dispatch, last_ready)
        )
        launch_wall = ready - since
        last_ready = ready
        if not stop and not continue_after(n_labeled_after, n_active):
            stop = True
        # Refill BEFORE the touchdown so the host bookkeeping below overlays
        # the refilled chunk's execution: the popped chunk has completed, so
        # the launch window has a free slot and chunk N+2 can dispatch now —
        # the device never waits out a long touchdown. depth=1 skips this
        # (the serial contract is touchdown-before-next-dispatch).
        while depth > 1 and len(inflight) < depth and _can_dispatch():
            _dispatch_one()
        t_td = time.perf_counter()
        telemetry.flight_record("touchdown", index=head.index, n_active=n_active,
                                n_labeled_after=n_labeled_after, inflight=len(inflight))
        touchdown(
            head.index, n_labeled_after, n_active, ys, head.out_state,
            launch_wall,
        )
        td_wall = time.perf_counter() - t_td
        overlapped = td_wall if inflight else 0.0
        stats.chunks += 1
        stats.launch_seconds += launch_wall
        stats.touchdown_seconds += td_wall
        stats.overlap_seconds += overlapped
        # Live ops plane: a fresh pipeline_touchdown heartbeat is /healthz's
        # proof the driver completes work, not only dispatches it.
        obs.heartbeat("pipeline_touchdown")
        obs.gauge("pipeline_inflight", "chunk launches currently in flight").set(len(inflight))
        obs.gauge("touchdown_hidden_ratio",
                  "fraction of host-touchdown wall hidden under device execution",
                  ).set(round(stats.touchdown_hidden_fraction, 6))
        obs.counter("pipeline_chunks", "chunk touchdowns completed").inc()
        if on_launch is not None:
            on_launch(
                seconds=launch_wall,
                touchdown_seconds=td_wall,
                overlap_seconds=overlapped,
                touchdown_hidden_fraction=(
                    overlapped / td_wall if td_wall > 0 else 0.0
                ),
            )
    return state, stats
