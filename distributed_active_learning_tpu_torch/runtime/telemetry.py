"""Device-resident telemetry: per-round metrics computed on the device, a
structured JSONL sink, a launch flight recorder (the port of
``runtime/telemetry.py``).

Four layers, as in the JAX module:

1. **Round metrics on the device**: :class:`RoundMetrics`, a few tensors
   computed inside the round (:func:`compute_round_metrics`) and, in the
   chunked driver, stacked ``[K, ...]`` as the chunk's sixth y inside its
   CUDA graph: the selection-score summary (min/mean/max of the picked
   window, margin to the best unpicked candidate), the mean predictive
   entropy over the pool, the picked-class histogram and the labeled
   fraction. The host reads K rounds of metrics in the chunk's one
   touchdown copy. Nothing here syncs with the host (no ``.item()``, no
   data-dependent shapes), so the metrics capture into the graph. The
   pool-entropy pass needs the pool's leaf values, which the round already
   computes for its score: the round evaluates the pool once
   (:func:`~..ops.forest_eval.evaluated`) and both read it, so metrics add
   no leaf-kernel launch.
2. **Trace attribution**: the driver's phases are
   ``torch.profiler.record_function`` spans (``runtime/debugger.py``), and
   :func:`profile_session` wraps a run in a ``torch.profiler`` trace
   (``run.py --profile-dir``).
3. **Structured sink**: :class:`MetricsWriter` writes rank-tagged JSONL
   events (meta, rounds, counters, gauges, launches) behind ``run.py
   --metrics-out``: launch accounting with the chunk graph's captures as
   the recompile signal, host transfer bytes at chunk touchdowns, and the
   card's memory watermarks (:func:`device_memory_gauges`).
   ``benches/summarize_metrics.py`` renders the stream.
4. **Flight recorder**: :class:`FlightRecorder`, a bounded ring of launch /
   touchdown / veto / recompile events dumped as one JSON artifact on
   SIGUSR1, SIGTERM, an unhandled crash or a normal exit (``run.py
   --flight-recorder``).

The writer's rank is the process index: in a multi-process job only rank 0
writes, and ``gauges(allgather=True)`` gathers every rank's values first, as
the JAX writer does.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from distributed_active_learning_tpu_torch.runtime import obs


# ---------------------------------------------------------------------------
# Layer 1: round metrics on the device
# ---------------------------------------------------------------------------


class RoundMetrics(NamedTuple):
    """Per-round device metrics: the JAX package's fields in its order.

    Every field is a 0-d tensor except ``picked_hist`` (``[n_classes]``
    int32); stacked over a chunk each gains a leading ``[K]``.
    ``rare_recall`` (a ``rare_event`` run's recall of its rare class) and
    ``cost_spent`` (a ``cost_budget`` run's spend this round) are None
    outside their scenario; the dict converters emit a key only for a field
    that is there.
    """

    score_min: torch.Tensor     # worst picked score (selection-order sense)
    score_mean: torch.Tensor    # mean picked score
    score_max: torch.Tensor     # best picked score
    score_margin: torch.Tensor  # gap from worst picked to best unpicked candidate
    pool_entropy: torch.Tensor  # mean predictive entropy over valid pool rows (bits)
    labeled_frac: torch.Tensor  # pre-reveal labeled fraction of the real pool
    picked_hist: torch.Tensor   # [n_classes] int32 oracle classes of the window
    rare_recall: Optional[torch.Tensor] = None
    cost_spent: Optional[torch.Tensor] = None


def compute_round_metrics(
    forest,
    state,
    picked: torch.Tensor,
    picked_vals: torch.Tensor,
    scores: torch.Tensor,
    *,
    higher_is_better: bool,
    n_classes: int,
) -> RoundMetrics:
    """:class:`RoundMetrics` of one round, on the device.

    ``state`` is the PRE-reveal pool state, ``picked``/``picked_vals`` the
    selected window and its scores, ``scores`` the full score vector. The
    per-round and chunked drivers both call this from the round body
    (``runtime.loop.make_round_fn``), so their metrics agree bit for bit.
    Pass the round's :func:`~..ops.forest_eval.evaluated` forest: the pool's
    probabilities then come from the leaf values the score was computed
    from, with no second pass over the pool.
    """
    from distributed_active_learning_tpu_torch.ops import forest_eval, trees_multi

    valid = state.valid_mask
    if trees_multi.is_multi(forest):
        ent = _entropy_sum_multi([forest_eval.leaves(p, state.x) for p in forest.planes], valid)
    else:
        ent = _entropy_sum(forest_eval.leaves(forest, state.x), valid)
    return _round_metrics(state, picked, picked_vals, scores, higher_is_better, n_classes, ent)


def selection_metrics(
    state,
    picked: torch.Tensor,
    picked_vals: torch.Tensor,
    scores: torch.Tensor,
    *,
    higher_is_better: bool,
    n_classes: int,
    pool_entropy: torch.Tensor,
) -> RoundMetrics:
    """The model-agnostic half of :func:`compute_round_metrics`: everything
    but the pool-entropy pass is a function of the selection, so the neural
    round (``runtime/neural_loop.py``) passes its own per-row predictive
    entropy ``pool_entropy [n]`` (MC-dropout entropy, in nats), summed over
    the valid rows in XLA's reduce order."""
    from distributed_active_learning_tpu_torch.ops.xla_f32 import row_sum

    valid = state.valid_mask
    ent = row_sum(torch.where(valid, pool_entropy, 0.0)[None])[0]
    return _round_metrics(state, picked, picked_vals, scores, higher_is_better, n_classes, ent)


def _round_metrics(state, picked, picked_vals, scores, higher_is_better: bool, n_classes: int,
                   ent: torch.Tensor) -> RoundMetrics:
    """The RoundMetrics of a selection, ``ent`` the valid rows' summed
    entropy."""
    from distributed_active_learning_tpu_torch.ops.xla_f32 import div_const, row_sum
    from distributed_active_learning_tpu_torch.runtime import state as state_lib

    inf = math.inf
    valid = state.valid_mask
    # Short final windows: when fewer than window_size unlabeled rows remain,
    # the select pads with +/-inf sentinel values whose indices point at
    # already-labeled rows. Every statistic masks to the FINITE picks.
    finite = torch.isfinite(picked_vals)
    n_finite = torch.clamp_min(finite.sum(dtype=torch.int32), 1)
    lo = torch.where(finite, picked_vals, inf).min()
    hi = torch.where(finite, picked_vals, -inf).max()
    # The picked window's sum in XLA's reduce order (a 1-D reduce is a row of
    # one).
    score_mean = row_sum(torch.where(finite, picked_vals, 0.0)[None])[0] / n_finite.to(torch.float32)
    # Margin to the best unpicked candidate: unlabeled real rows minus the
    # window just picked.
    remaining = (~state.labeled_mask).scatter(0, picked, False) & valid
    if higher_is_better:
        best_rest = torch.where(remaining, scores, -inf).max()
        margin = lo - best_rest
    else:
        best_rest = torch.where(remaining, scores, inf).min()
        margin = best_rest - hi
    # No finite picks / no remaining candidates: 0 rather than the
    # arithmetic of sentinels.
    score_min = torch.where(torch.isfinite(lo), lo, 0.0)
    score_max = torch.where(torch.isfinite(hi), hi, 0.0)
    margin = torch.where(torch.isfinite(margin), margin, 0.0)

    # The real-row count: static for a batch pool, where the JAX code divides
    # by a constant (XLA multiplies by its f32 reciprocal); behind a fill
    # watermark (a grid's padded pool) the count of the valid rows, and a
    # true division, as the JAX code's.
    if state.n_filled is None:
        n_real = state.n_valid

        def per_row(v):
            return div_const(v, n_real)
    else:
        n_real = torch.clamp_min(valid.sum(dtype=torch.int32), 1).to(torch.float32)

        def per_row(v):
            return v / n_real
    ent_mean = per_row(ent)
    # A one-hot sum into a fixed [n_classes] buffer (no bincount: its length
    # would depend on the data); sentinel picks count nothing.
    classes = torch.arange(n_classes, device=picked.device, dtype=torch.int32)
    one_hot = (state.oracle_y[picked][:, None] == classes).to(torch.int32)
    hist = (one_hot * finite[:, None].to(torch.int32)).sum(dim=0, dtype=torch.int32)
    labeled_frac = per_row(state_lib.labeled_count(state).to(torch.float32))
    f32 = torch.float32
    return RoundMetrics(
        score_min=score_min.to(f32),
        score_mean=score_mean.to(f32),
        score_max=score_max.to(f32),
        score_margin=margin.to(f32),
        pool_entropy=ent_mean.to(f32),
        labeled_frac=labeled_frac,
        picked_hist=hist,
    )


# The pool entropy's bound against the JAX package's value, relative: the
# port computes it in native float32 operations (the tree mean, log2, the
# pool's sum), each within a few ulp of XLA's spelling, so the mean over the
# pool differs from JAX's in its last bits only.
POOL_ENTROPY_RTOL = 1e-5


def _entropy_sum(leaves: torch.Tensor, valid: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The binary entropy (bits) of the mean leaf value of each row, summed
    over the valid rows: ``scoring.full_entropy`` of ``forest_eval.proba``
    in one reduction over the trees, a few elementwise passes and one sum.
    The scores keep the bit-exact spelling of XLA's float32 (the trees added
    in XLA's order, Cephes' log with float64 FMAs), which takes a few
    hundred passes over the pool: a metric that decides no pick does not
    need it."""
    p = torch.clamp(leaves.mean(dim=1), eps, 1.0 - eps)
    q = 1.0 - p
    return -torch.where(valid, p * torch.log2(p) + q * torch.log2(q), 0.0).sum()


def _entropy_sum_multi(plane_leaves: List[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """The multiclass form of :func:`_entropy_sum`: each class's probability
    the mean leaf value of its plane, ``-sum_c p_c log2(p_c + 1e-12)`` a
    row (``trees_multi.entropy_multi``'s formula in native float32), summed
    over the valid rows."""
    p = torch.stack([leaves.mean(dim=1) for leaves in plane_leaves], dim=-1)
    ent = -(p * torch.log2(p + 1e-12)).sum(dim=-1)
    return torch.where(valid, ent, 0.0).sum()


def stack_metrics(per_round: List[RoundMetrics]) -> RoundMetrics:
    """A chunk's rounds of metrics stacked ``[K, ...]`` field by field
    (None fields stay None)."""
    return RoundMetrics(*[
        None if col[0] is None else torch.stack(col) for col in zip(*per_round)])


# The one source of truth for the metric field names: the dict converters
# derive from it. picked_hist is the only vector field (list-valued).
_METRIC_FIELDS = RoundMetrics._fields


def _present_fields(host_rm) -> tuple:
    return tuple(name for name in _METRIC_FIELDS if getattr(host_rm, name) is not None)


def _field_to_py(host_rm, name: str, idx=None):
    leaf = getattr(host_rm, name)
    if idx is not None:
        leaf = leaf[idx]
    if name == "picked_hist":
        return [int(c) for c in np.asarray(leaf)]
    return float(leaf)


def _to_host(rm: RoundMetrics) -> RoundMetrics:
    """One wait for every field: the copies are queued together behind one
    event (CUDA) or are the tensors themselves (CPU)."""
    from distributed_active_learning_tpu_torch.runtime.pipeline import start_host_copy

    return start_host_copy(rm).wait()


def metrics_to_dict(rm: RoundMetrics) -> Dict[str, Any]:
    """One round's metrics as plain JSON-serializable Python values."""
    host = _to_host(rm)
    return {name: _field_to_py(host, name) for name in _present_fields(host)}


def stacked_metrics_to_dicts(rm_stacked: RoundMetrics, active: np.ndarray) -> List[Dict[str, Any]]:
    """Chunk-touchdown conversion: stacked ``[K, ...]`` metrics (host copies
    at a touchdown) -> one plain dict per ACTIVE round."""
    host = _to_host(rm_stacked)
    fields = _present_fields(host)
    return [
        {name: _field_to_py(host, name, int(i)) for name in fields}
        for i in np.flatnonzero(np.asarray(active))
    ]


def stacked_sweep_metrics_to_dicts(rm_stacked: RoundMetrics,
                                   active: np.ndarray) -> List[List[Dict[str, Any]]]:
    """Sweep-touchdown conversion: ``[K, E, ...]`` metrics (host copies at a
    touchdown) -> one dict list per EXPERIMENT (or grid cell), each holding
    that experiment's active rounds in order."""
    host = _to_host(rm_stacked)
    active = np.asarray(active)
    fields = _present_fields(host)
    return [
        [{name: _field_to_py(host, name, (int(i), e)) for name in fields}
         for i in np.flatnonzero(active[:, e])]
        for e in range(active.shape[1])
    ]


def metrics_nbytes(rm_stacked: RoundMetrics) -> int:
    """Bytes the stacked metrics add to a chunk touchdown copy (shape times
    item size; reads nothing)."""
    return int(sum(t.numel() * t.element_size() for t in rm_stacked if t is not None))


# ---------------------------------------------------------------------------
# Layer 2: trace attribution helpers
# ---------------------------------------------------------------------------


def prepare_profile_dir(log_dir: str) -> str:
    """Validate a ``--profile-dir`` target BEFORE the run starts (the trace
    is written only when the run ends). Creates the directory and probes
    writability; raises ``ValueError`` with the OS error otherwise."""
    import tempfile

    try:
        os.makedirs(log_dir, exist_ok=True)
        fd, probe = tempfile.mkstemp(prefix=".write_probe.", dir=log_dir)
        os.close(fd)
        os.remove(probe)
    except OSError as e:
        raise ValueError(f"--profile-dir {log_dir!r} is not a writable directory: {e}") from e
    return log_dir


@contextlib.contextmanager
def profile_session(log_dir: Optional[str]):
    """A ``torch.profiler`` trace over a block (:func:`runtime.debugger.
    profiler_trace`), with the writability check done first. ``None`` = no-op."""
    if log_dir is None:
        yield
        return
    from distributed_active_learning_tpu_torch.runtime.debugger import profiler_trace

    prepare_profile_dir(log_dir)
    with profiler_trace(log_dir):
        yield


def jit_cache_size(fn) -> Optional[int]:
    """The port's counterpart of the JAX package's compiled-executable
    count: the CUDA graph captures of a chunk (``runtime.loop.GraphedChunk.
    captures``). Growth between two observations of the same chunk is a
    recapture, the port's recompile. None where there is no graph (the
    eager chunk on the CPU)."""
    captures = getattr(fn, "captures", None)
    return int(captures) if captures is not None else None


def device_memory_gauges() -> Dict[str, int]:
    """The cards' allocator watermarks (``torch.cuda.memory_stats``:
    ``allocated_bytes.all.current`` and ``.peak``), the max over the
    process's cards: the binding constraint is the fullest card. ``{}``
    without CUDA, as the JAX function gives on the CPU."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    per_dev = [torch.cuda.memory_stats(d) for d in range(torch.cuda.device_count())]
    out = {}
    for key, name in (("allocated_bytes.all.current", "device_bytes_in_use"),
                      ("allocated_bytes.all.peak", "device_peak_bytes_in_use")):
        vals = [int(s[key]) for s in per_dev if key in s]
        if vals:
            out[name] = max(vals)
    return out


# ---------------------------------------------------------------------------
# Layer 3: structured metrics sink
# ---------------------------------------------------------------------------


class MetricsWriter:
    """Rank-tagged JSONL event stream, one line per event: ``{"ts": <unix
    s>, "kind": ..., "rank": <rank>, ...payload}``. ``rank`` defaults to the
    process index (``parallel.multihost``); only rank 0 holds the file
    (another rank counts and writes nothing).

    The file opens in APPEND mode: a checkpoint-resumed run with the same
    ``--metrics-out`` extends the interrupted run's stream; each run starts
    with a ``meta`` event, so consumers can segment runs.

    ``flush_every`` batches flushes: the default 1 flushes every event (a
    crash loses nothing written); the streaming service, which emits one
    ``serve_latency`` event a query, passes a larger value and relies on
    :func:`install_exit_flush` (SIGTERM and atexit) to keep the buffered
    tail on a kill.
    """

    def __init__(self, path: str, rank: Optional[int] = None, flush_every: int = 1):
        self.path = path
        if rank is None:
            from distributed_active_learning_tpu_torch.parallel.multihost import process_index

            rank = process_index()
        self.rank = int(rank)
        self.flush_every = max(int(flush_every), 1)
        self._since_flush = 0
        self.counters: Dict[str, float] = {}
        self._f = None
        # Serializes line writes between threads (the service's dispatcher
        # and its precompile worker). Reentrant: install_exit_flush's SIGTERM
        # handler may interrupt an event() that holds it.
        self._lock = threading.RLock()
        if self.rank == 0:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    @staticmethod
    def _json_safe(v):
        """Strict-JSON floats: non-finite values become None."""
        if isinstance(v, float) and not math.isfinite(v):
            return None
        if isinstance(v, list):
            return [MetricsWriter._json_safe(x) for x in v]
        if isinstance(v, dict):
            return {k: MetricsWriter._json_safe(x) for k, x in v.items()}
        return v

    def event(self, kind: str, **fields) -> None:
        if self._f is None:
            return
        line = {"ts": round(time.time(), 3), "kind": kind, "rank": self.rank}
        line.update(fields)
        text = json.dumps(self._json_safe(line)) + "\n"
        with self._lock:
            if self._f is None:  # closed between the fast check and here
                return
            self._f.write(text)
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._f.flush()
                self._since_flush = 0

    # -- the event vocabulary ------------------------------------------------

    def meta(self, **fields) -> None:
        """Run-identity header (config, backend, devices): first line."""
        self.event("meta", **fields)

    def round(self, **fields) -> None:
        """One AL round: counts, accuracy, phase times, RoundMetrics."""
        self.event("round", **fields)

    def counter(self, name: str, value: float) -> None:
        """Monotonic counter increment; the event carries the running total."""
        self.counters[name] = self.counters.get(name, 0.0) + value
        self.event("counter", name=name, value=value, total=self.counters[name])

    def gauge(self, name: str, value) -> None:
        self.event("gauge", name=name, value=value)

    def gauges(self, values: Dict[str, float], allgather: bool = False) -> None:
        """Emit a dict of gauges. With ``allgather=True`` in a multi-process
        job the values are all-gathered first (COLLECTIVE: every rank calls
        it), and the primary writes one event a gauge carrying the sum and
        the per-rank vector (``per_host``); in one process, plain gauges."""
        from distributed_active_learning_tpu_torch.parallel import multihost

        if allgather and multihost.process_count() > 1:
            for name, vec in multihost.gather_scalar_gauges(values).items():
                self.event("gauge", name=name, value=sum(vec), per_host=vec)
            return
        for name, value in values.items():
            self.gauge(name, value)

    def launch(self, program: str, seconds: float, first_call: bool,
               cache_size: Optional[int] = None, recompiled: bool = False, **extra) -> None:
        """Launch accounting: the first call (capture included) is reported
        apart from the replays; ``recompiled`` flags a graph recapture on a
        later call; ``extra`` carries the pipelined driver's overlap
        accounting."""
        self.event(
            "launch", program=program, seconds=round(seconds, 6), first_call=first_call,
            cache_size=cache_size, recompiled=recompiled,
            **{k: (round(v, 6) if isinstance(v, float) else v) for k, v in extra.items()},
        )

    def roofline(self, program: str, **fields) -> None:
        """Per-program roofline attribution (``analysis/roofline.py``): the
        counted FLOPs and bytes joined with measured seconds into achieved
        rates, the shares of the card's peaks and the bound verdict, once a
        program at run end (the count runs the program again, so it never
        rides the hot path)."""
        self.event("roofline", program=program, **fields)

    # -- lifecycle -----------------------------------------------------------

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._since_flush = 0

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def install_exit_flush(writer: MetricsWriter) -> None:
    """Flush ``writer`` on SIGTERM and at interpreter exit (a buffered
    stream, ``flush_every > 1``, would otherwise lose its tail to an
    orchestrator's kill). The SIGTERM handler flushes and then chains to the
    handler installed before it, so the process's shutdown is unchanged.
    Idempotent per writer."""
    import atexit
    import signal

    if getattr(writer, "_exit_flush_installed", False):
        return
    writer._exit_flush_installed = True
    atexit.register(writer.flush)

    prev = signal.getsignal(signal.SIGTERM)
    if prev is None:
        return  # a handler installed from C: leave it; atexit still flushes

    def _flush_and_chain(signum, frame):
        try:
            writer.flush()
        except RuntimeError:
            pass  # the signal landed inside the io stack's own write
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.raise_signal(signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, _flush_and_chain)
    except ValueError:
        pass  # not the main thread: atexit still covers clean exits


# ---------------------------------------------------------------------------
# Layer 4: the launch flight recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded in-process ring of runtime events, the post-mortem: every
    launch / touchdown / veto / recompile event appends a small dict (no
    I/O, no device reads), and :meth:`dump` writes the last N as one JSON
    artifact. Library code records through :func:`flight_record`, a no-op
    until :func:`install_flight_recorder` runs."""

    def __init__(self, path: Optional[str] = None, capacity: int = 256):
        self.path = path
        self.capacity = int(capacity)
        self._events: collections.deque = collections.deque(maxlen=self.capacity)
        # Reentrant: dump() runs from signal handlers, which may interrupt
        # record()'s locked block.
        self._lock = threading.RLock()
        self._seq = 0
        self._dumped_reasons: List[str] = []

    def record(self, kind: str, **fields) -> None:
        ev = {"seq": 0, "ts": round(time.time(), 3), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        """Events that aged out of the ring."""
        with self._lock:
            return self._seq - len(self._events)

    def dump(self, reason: str) -> Optional[str]:
        """Write the ring to ``self.path`` as one JSON artifact (atomic
        rename) and return the path; None without a path. Each dump keeps
        the reasons of the earlier ones."""
        if not self.path:
            return None
        with self._lock:
            payload = {
                "schema": 1,
                "reason": reason,
                "reasons": self._dumped_reasons + [reason],
                "pid": os.getpid(),
                "dumped_ts": round(time.time(), 3),
                "capacity": self.capacity,
                "recorded_total": self._seq,
                "dropped": self._seq - len(self._events),
                "events": [MetricsWriter._json_safe(e) for e in self._events],
            }
            self._dumped_reasons.append(reason)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)
        return self.path


_FLIGHT_RECORDER: Optional[FlightRecorder] = None


def flight_recorder() -> Optional[FlightRecorder]:
    return _FLIGHT_RECORDER


def flight_record(kind: str, **fields) -> None:
    """Record into the installed flight recorder; no-op without one."""
    rec = _FLIGHT_RECORDER
    if rec is not None:
        rec.record(kind, **fields)


def flight_dump(reason: str) -> Optional[str]:
    """Dump the installed recorder (None without one)."""
    rec = _FLIGHT_RECORDER
    return rec.dump(reason) if rec is not None else None


#: Default ring capacity; ``DAL_FLIGHT_RING`` overrides it process-wide.
_DEFAULT_FLIGHT_RING = 256


def flight_ring_capacity(capacity: Optional[int] = None) -> int:
    """The ring's capacity: an explicit argument, else the
    ``DAL_FLIGHT_RING`` environment variable, else 256. A value that is not
    a positive integer raises (a zero ring would record nothing)."""
    if capacity is None:
        raw = os.environ.get("DAL_FLIGHT_RING", "")
        if raw.strip():
            try:
                capacity = int(raw)
            except ValueError:
                raise ValueError(f"DAL_FLIGHT_RING={raw!r} is not an integer") from None
        else:
            capacity = _DEFAULT_FLIGHT_RING
    if capacity <= 0:
        raise ValueError(f"flight ring capacity must be positive, got {capacity}")
    return int(capacity)


def install_flight_recorder(path: Optional[str], signals: bool = True,
                            capacity: Optional[int] = None) -> FlightRecorder:
    """Install the process-wide flight recorder (replacing any previous
    one), its ring :func:`flight_ring_capacity` events long. With ``signals=True`` also arm the dump triggers: SIGUSR1 dumps
    and keeps running; SIGTERM dumps, then chains to the previous handler;
    ``sys.excepthook`` dumps on an unhandled crash, then chains. A handler
    only writes the ring's host-side dicts: it never touches the device."""
    import signal
    import sys

    global _FLIGHT_RECORDER
    rec = FlightRecorder(path, flight_ring_capacity(capacity))
    _FLIGHT_RECORDER = rec
    if not signals:
        return rec

    def _usr1(_signum, _frame):
        try:
            rec.dump("sigusr1")
        except OSError:
            pass  # a probe of a live run must never kill it

    try:
        signal.signal(signal.SIGUSR1, _usr1)
    except (ValueError, AttributeError):
        pass  # not the main thread / no SIGUSR1 on this platform

    prev_term = signal.getsignal(signal.SIGTERM)

    def _term(signum, frame):
        try:
            rec.dump("sigterm")
        except OSError:
            pass
        if callable(prev_term):
            prev_term(signum, frame)
        elif prev_term == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.raise_signal(signal.SIGTERM)

    if prev_term is not None:
        try:
            signal.signal(signal.SIGTERM, _term)
        except ValueError:
            pass

    prev_hook = sys.excepthook

    def _crash_hook(exc_type, exc, tb):
        try:
            rec.dump(f"crash:{exc_type.__name__}")
        except OSError:
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _crash_hook
    return rec


def uninstall_flight_recorder() -> None:
    """Detach the recorder from :func:`flight_record` (signal handlers armed
    by a ``signals=True`` install keep their own recorder)."""
    global _FLIGHT_RECORDER
    _FLIGHT_RECORDER = None


def program_obs_feeds(program: str):
    """The three ops-plane children every launch tracker feeds, one
    definition of the JAX package's (family, help) pairs:
    ``(launches_counter, seconds_histogram, recompiles_counter)``. Touching
    the recompile counter here makes it render 0 from the first scrape."""
    return (
        obs.counter("launches", "jitted program launches", program=program),
        obs.histogram("launch_seconds", "per-launch wall seconds", program=program),
        obs.counter("recompiles_after_warmup", "jit-cache growths past each program's first call"),
    )


class LaunchTracker:
    """Per-program first-call-vs-replay split and recapture detection
    around the chunked driver's launches: one ``launch`` event per call."""

    def __init__(self, writer: Optional[MetricsWriter], program: str, fn=None):
        self.writer = writer
        self.program = program
        self.fn = fn
        self.calls = 0
        self.vetoes = 0
        self.seconds_total = 0.0
        self.first_seconds: Optional[float] = None  # the capturing call's wall
        self._last_cache = None
        self._obs_launches, self._obs_seconds, self._obs_recompiles = program_obs_feeds(program)

    def veto(self, index: int, reason: Optional[str]) -> None:
        """One vetoed speculative launch (``run_pipelined``'s ``on_veto``)."""
        self.vetoes += 1
        obs.counter("launch_vetoes", "speculative launches proven inactive a priori",
                    program=self.program).inc()
        flight_record("launch_veto", program=self.program, index=index, reason=reason or "unknown")
        if self.writer is not None:
            self.writer.event("launch_veto", program=self.program, index=index,
                              reason=reason or "unknown")

    def record(self, seconds: float, **extra) -> None:
        """One launch observation; ``extra`` rides the JSONL event."""
        self.calls += 1
        self.seconds_total += seconds
        if self.calls == 1:
            self.first_seconds = seconds
        cache = jit_cache_size(self.fn) if self.fn is not None else None
        recompiled = (self.calls > 1 and cache is not None and self._last_cache is not None
                      and cache > self._last_cache)
        self._last_cache = cache
        self._obs_launches.inc()
        self._obs_seconds.observe(seconds)
        flight_record("launch", program=self.program, call=self.calls, seconds=round(seconds, 6),
                      first_call=self.calls == 1, recompiled=recompiled)
        if recompiled:
            self._obs_recompiles.inc()
            flight_record("recompile", program=self.program, call=self.calls, cache_size=cache)
        if self.writer is None:
            return
        self.writer.launch(self.program, seconds, first_call=self.calls == 1, cache_size=cache,
                           recompiled=recompiled, **extra)

    def steady_seconds_mean(self) -> Optional[float]:
        """Mean wall a launch, the first call (warm-up and graph capture)
        left out; the first call itself when it is all there is; None before
        any launch."""
        if self.calls == 0:
            return None
        if self.calls == 1 or self.first_seconds is None:
            return self.seconds_total / self.calls
        return (self.seconds_total - self.first_seconds) / (self.calls - 1)


def emit_roofline(writer, tracker: LaunchTracker, fn, args, n_devices: int = 1) -> Optional[dict]:
    """Join ``fn``'s counted cost with ``tracker``'s steady launch seconds
    and emit one ``roofline`` event (and a flight-recorder echo), the JAX
    package's. Called after a chunked run (``run.py --roofline``): the count
    runs ``fn(*args)`` once more, eagerly, so it never sits in a timed
    region; ``fn`` is the chunk's eager body, which a CUDA graph replays
    kernel for kernel. ``n_devices`` is the mesh's size (the shares divide
    by the aggregate peak). A failure becomes an event carrying ``error``:
    attribution must not kill a finished run. Returns the attribution, or
    None on failure."""
    from distributed_active_learning_tpu_torch.analysis import roofline as roofline_lib

    seconds = tracker.steady_seconds_mean()
    try:
        cost = roofline_lib.program_cost(fn, *args)
    except Exception as e:  # noqa: BLE001 — diagnostics must not raise
        if writer is not None:
            writer.roofline(tracker.program, error=f"{type(e).__name__}: {e}")
        flight_record("roofline", program=tracker.program, error=type(e).__name__)
        return None
    attr = roofline_lib.attribute_card(cost, seconds, n_devices=n_devices)
    if writer is not None:
        writer.roofline(tracker.program, calls=tracker.calls, **attr)
    flight_record("roofline", program=tracker.program, bound=attr["bound"], mfu=attr["mfu"])
    return attr
