"""Multi-tenant AL as a service: N resident forests in one process on one
device (the port of ``serving/tenants.py``).

- **Tenant**: what one resident dataset x model owns: its slab-paged pool
  (``serving/slab.py``), drift monitor (``serving/drift.py``), the program
  set of each capacity it reached, the resident fitted forest, and its
  stats, records and telemetry. :class:`~.service.ALService` is a 1-tenant
  manager, so there is one event loop.

- **TenantManager**: N tenants and the two cross-tenant paths:

  * **Grouped scoring** (:meth:`TenantManager.score_many`): concurrent
    score requests of tenants whose forests share one signature (forest
    structure x score width x feature width) run as one group a width-round,
    each member's forest over its own block (plain PyTorch, where the JAX
    package vmaps its gemm and gather forms). Tenants no group can hold fall
    back to per-tenant launches with a NAMED reason: ``kernel`` for
    ``kernel="pallas"`` (the JAX package's reason: its Pallas evaluator does
    not stack over a tenant axis, and the port adds no stacked K1 score
    path), ``singleton_signature``, ``single_tenant``.

  * **Batched re-fit**: the drift re-fits of same-configuration tenants that
    fire together run as ONE grid chunk (``runtime/sweep.py
    make_grid_chunk_fn``) with the tenants on the dataset axis (G = 1, D =
    T, E = 1): pools stacked and padded to the group's largest capacity,
    unequal fills on the watermark, non-candidates as masked no-ops. Each
    tenant's picks equal an independent service's.

- **One CUDA graph a capacity.** A capacity's program set is its slab
  buffers, the in-place ingest, the device fit and the re-fit chunk as one
  :class:`~..runtime.loop.GraphedChunk` captured on those buffers (the
  graph of a round, replayed ``refit_rounds`` times a dispatch: a capture a
  capacity costs one round, which lets the worker keep pace with a growth
  every few dozen queries). When the
  watermark comes within ``precompile_headroom_slabs`` of capacity, a
  background worker allocates the next capacity's slab, pads the seed mask
  and captures that capacity's chunk (on its own stream, in thread-local
  capture mode); growth copies the filled rows into the captured buffers
  and swaps them in. A capacity's set, its graph and the graph's private
  pool are released once the slab has grown past it (after the touchdown
  of a re-fit still running on it), so a tenant holds at most two chunk
  graphs: the current capacity's and the next one's. On the CPU there is no
  graph: the precompile is the allocation and the program build, counted
  the same way.

- **Streams.** Ingest, the chunk and the resident fit run on the
  dispatcher's stream, so an ingest stays ordered after a chunk already
  queued. The score endpoint reads only the resident forest and runs on a
  stream of its own that waits on an event recorded after the newest
  resident fit: a query issued while a chunk is in flight does not wait for
  the chunk. On the card the endpoint is itself one CUDA graph
  (``slab.GraphedScore``: its eager body is ~800 small launches).
- **One capturing thread.** Every chunk graph is captured by the worker, on
  one stream of its own (warmed up once a chunk body): ahead of a growth,
  or, for a set the request path found uncaptured, at the dispatcher's
  request while it waits (``recompiles_after_warmup`` counts those after
  :meth:`TenantManager.mark_warmup_complete`). A tenant's next capacity
  goes before a tenant-axis chunk in the worker's queue.

- **Async re-fit.** A dispatch replays the chunk's graph and queues the
  copy of its outputs (extras and ys) to pinned host memory behind it, with
  an event; a poll asks ``event.query()`` (always ready on the CPU) and
  touches down when ready, or after ``refit_poll_events`` polls. The copies
  are made at dispatch, so a later replay of the same graph cannot
  overwrite them.

Threading: device work (score, ingest, dispatch and touchdown) runs on ONE
thread, the frontend's dispatcher (``serving/frontend.py``); the precompile
worker only builds program sets and captures graphs, and installs them
under the tenant's lock. Its launch counts stay its own
(``kernels.capture_tally`` is per thread).
"""

from __future__ import annotations

import atexit
import dataclasses
import queue as queue_lib
import re
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import ExperimentConfig, ServeConfig
from distributed_active_learning_tpu_torch.device import resolve_device
from distributed_active_learning_tpu_torch.runtime import obs
from distributed_active_learning_tpu_torch.runtime import state as state_lib
from distributed_active_learning_tpu_torch.runtime import telemetry
from distributed_active_learning_tpu_torch.serving import drift as drift_lib
from distributed_active_learning_tpu_torch.serving import slab as slab_lib

_TENANT_ID_RE = re.compile(r"[A-Za-z0-9._-]+")

# A precompile worker stopped in the middle of a capture at interpreter
# teardown can abort the process, so every manager registers here and atexit
# drains their workers first. WeakSet: a collected manager must not be kept
# alive by its own shutdown hook.
_LIVE_MANAGERS: "weakref.WeakSet[TenantManager]" = weakref.WeakSet()


@atexit.register
def _shutdown_precompile_workers() -> None:
    for manager in list(_LIVE_MANAGERS):
        manager.close()


#: Eval kernels whose forests the grouped score path takes (the JAX
#: package's list: its "pallas" evaluator does not stack over a tenant axis).
_BATCHABLE_KERNELS = ("gemm", "gather")


class _ProgramTracker:
    """Per-program launch accounting with a recompile COUNT: a chunk
    program's graph recaptures (``telemetry.jit_cache_size``; a
    :class:`~..runtime.loop.GraphedChunk` never recaptures, it raises on
    other tensors instead), 0 for programs without a graph. Emits the same
    ``launch`` JSONL events and ops-plane series as
    ``telemetry.LaunchTracker``."""

    def __init__(self, writer, program: str, fn):
        self.writer = writer
        self.program = program
        self.fn = fn
        self.calls = 0
        self.recompiles = 0
        self._last_cache = None
        self._obs_launches, self._obs_seconds, self._obs_recompiles = (
            telemetry.program_obs_feeds(program))

    def record(self, seconds: float, **extra) -> None:
        self.calls += 1
        cache = telemetry.jit_cache_size(self.fn)
        recompiled = (self.calls > 1 and cache is not None and self._last_cache is not None
                      and cache > self._last_cache)
        self._obs_launches.inc()
        self._obs_seconds.observe(seconds)
        if recompiled:
            self.recompiles += 1
            self._obs_recompiles.inc()
            telemetry.flight_record("recompile", program=self.program, call=self.calls,
                                    cache_size=cache)
        self._last_cache = cache
        if self.writer is not None:
            self.writer.launch(self.program, seconds, first_call=self.calls == 1,
                               cache_size=cache, recompiled=recompiled, **extra)


@dataclasses.dataclass
class _CapacityPrograms:
    """One slab capacity's program set: the slab buffers the chunk is
    captured on, the seed mask padded to the capacity, the in-place ingest,
    the device fit and the re-fit chunk (a GraphedChunk on CUDA, the eager
    chunk on the CPU). ``precompiled`` sets were built (and captured) by
    the worker ahead of the growth."""

    capacity: int
    slab: slab_lib.SlabPool
    seed_mask: Optional[torch.Tensor]
    ingest: object
    chunk: object
    fit: object
    ingest_tracker: _ProgramTracker
    chunk_tracker: _ProgramTracker
    fit_tracker: _ProgramTracker
    precompiled: bool = False
    # The bin-edge epoch the fit and chunk were built on (they hold the
    # edges): a refresh bumps the tenant's epoch, and _install_programs
    # refuses a set of an older epoch.
    edges_epoch: int = 0

    def graph_stats(self) -> Optional[dict]:
        """The chunk graph's counts (``GraphedChunk.stats``), None on the
        CPU."""
        stats = getattr(self.chunk, "stats", None)
        return stats() if stats is not None else None


@dataclasses.dataclass
class ServeStats:
    """Host-side per-tenant service counters (plain ints, no device reads)."""

    queries: int = 0
    scored_points: int = 0
    # Score requests that raised before producing a result: the
    # availability half of the SLO.
    query_failures: int = 0
    ingest_blocks: int = 0
    ingested_points: int = 0
    refits: int = 0
    refit_rounds: int = 0
    refits_skipped_fit_budget: int = 0
    slab_growths: int = 0
    # Growths whose new capacity's programs were resident already (the
    # precompile landed in time): the swap fast path.
    growths_precompiled: int = 0
    # Drift-triggered bin-edge refreshes.
    bin_refreshes: int = 0


def make_batched_score_fn():
    """The grouped scoring program: ``score(forests, queries[G, W, d]) ->
    (scores[G, W], entropy[G, W])``, :func:`~.slab.score_body` of each
    member's forest over its own block (a loop over the group: the JAX
    package vmaps the same body, which for the gemm and gather forms is
    plain XLA)."""

    def score(forests, queries: torch.Tensor):
        outs = [slab_lib.score_body(f, queries[i]) for i, f in enumerate(forests)]
        return torch.stack([s for s, _ in outs]), torch.stack([e for _, e in outs])

    return score


class _ScoreGroup:
    """One same-signature group of the grouped score path: the key is what
    the group's shapes depend on (forest signature, score width, feature
    width); ``tids`` in registration order is its stable tenant axis."""

    def __init__(self, key: tuple, tids: List[str], metrics):
        self.key = key
        self.tids = list(tids)
        self.fn = make_batched_score_fn()
        self.tracker = _ProgramTracker(metrics, "serve_batched_score", self.fn)
        self.launches = 0

    @property
    def width(self) -> int:
        return self.key[1]

    @property
    def features(self) -> int:
        return self.key[2]


def _upload(a, dtype, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``. On the card it goes through pinned memory as
    an asynchronous copy: a copy from pageable memory would hold the host
    until everything queued before it on the stream has run, an in-flight
    re-fit chunk included."""
    t = torch.as_tensor(np.ascontiguousarray(np.asarray(a)), dtype=dtype)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _forest_signature(forest) -> tuple:
    """Structure, shapes and dtypes of a forest's tensors (capacity-free:
    the fit window is fixed)."""
    from distributed_active_learning_tpu_torch.runtime.checkpoint import forest_leaves

    return (repr(type(forest)), tuple((tuple(t.shape), str(t.dtype))
                                      for t in forest_leaves(forest)))


class Tenant:
    """One resident dataset x model: slab pool, drift monitor, per-capacity
    programs, resident forest: the single-tenant event loop's whole state.

    ``cfg`` supplies the model, strategy and seeding (``forest.fit`` must be
    ``"device"``); ``serve`` the streaming knobs; ``train_x/train_y`` the
    cold-start corpus; ``test_x/test_y`` the chunk's accuracy eval.
    ``ckpt_name`` is the tenant axis of the serve checkpoint format (None
    keeps the single-tenant file names). ``device`` defaults to CUDA and
    raises without a card unless it is ``"cpu"``.
    """

    def __init__(
        self,
        tenant_id: str,
        cfg: ExperimentConfig,
        serve: ServeConfig,
        train_x,
        train_y,
        test_x,
        test_y,
        metrics=None,
        checkpoint_dir: Optional[str] = None,
        ckpt_name: Optional[str] = None,
        manager: Optional["TenantManager"] = None,
        device=None,
    ):
        from distributed_active_learning_tpu_torch.ops import trees_train
        from distributed_active_learning_tpu_torch.runtime.loop import build_aux
        from distributed_active_learning_tpu_torch.runtime.results import ExperimentResult
        from distributed_active_learning_tpu_torch.strategies import get_strategy

        if cfg.forest.fit != "device":
            raise ValueError(
                "the streaming service needs ForestConfig.fit='device' — a "
                "host sklearn fit cannot live inside the resident loop"
            )
        self.tenant_id = tenant_id
        self.cfg = cfg
        self.serve = serve
        self.metrics = metrics
        self.checkpoint_dir = checkpoint_dir
        self._ckpt_name = ckpt_name
        self._manager = manager
        self._dev = resolve_device(device)
        self.stats = ServeStats()
        self.refit_reasons: Dict[str, int] = {}
        self.result = ExperimentResult()
        # Post-warmup latency-cause table (mark_warmup_complete zeroes it).
        self.cause_counts: Dict[str, int] = {}
        # Whether the last served query ran beside an in-flight re-fit (the
        # bench splits its latencies by it), and each re-fit chunk's (active
        # rounds, seconds: device time on the card, the call's host time on
        # the CPU).
        self.last_query_inflight = False
        self.chunk_seconds: List[Tuple[int, float]] = []
        self._obs_queries = obs.counter("serve_queries", "score queries served", tenant=tenant_id)
        self._obs_points = obs.counter("serve_scored_points", "points scored", tenant=tenant_id)
        self._obs_lat: Dict[str, obs.Histogram] = {}
        self.slo: Optional[obs.SLOTracker] = None
        self._slo_gauge_ts = 0.0
        self._obs_slo_comp: Optional[obs.Gauge] = None
        self._obs_slo_burn: Dict[str, obs.Gauge] = {}
        if getattr(serve, "slo_latency_ms", 0.0) > 0.0:
            self.slo = obs.SLOTracker(serve.slo_latency_ms / 1e3,
                                      target=getattr(serve, "slo_target", 0.99))

        host_y = np.asarray(train_y, np.int32)
        self.n_classes = max(int(host_y.max()) + 1, 2) if host_y.size else 2
        self._strategy = get_strategy(cfg.strategy)

        dev = self._dev
        state0 = state_lib.init_pool_state(train_x, train_y, prng.key(cfg.seed), dev)
        state0 = state_lib.set_start_state(state0, cfg.n_start, n_classes=self.n_classes)
        self._edges = trees_train.make_bins(state0.x, cfg.forest.max_bins).edges
        self._edges_epoch = 0
        self._oob_ema: Optional[float] = None
        self._fresh_since_refresh = 0
        self._set_edge_bounds()
        self._slab = slab_lib.init_slab_pool(state0.x, state0.oracle_y, state0.labeled_mask,
                                             self._edges, serve.slab_rows)
        self._key = state0.key.to(dev)
        self._round = torch.zeros((), dtype=torch.int32, device=dev)
        self._round_host = 0
        self._fill = int(state0.x.shape[0])
        self._labeled = int(state_lib.labeled_count(state0))
        # The cold-start seed mask, padded to each capacity's buffers by
        # that capacity's program set (strategies that read it dot it with
        # capacity-sized pool vectors).
        aux = build_aux(cfg, state0)
        self._seed_mask0 = None if aux.seed_mask is None else aux.seed_mask.clone()
        self._aux = dataclasses.replace(aux, seed_mask=self._padded_seed_mask(
            self._slab.capacity))
        self._fit_key = prng.key(cfg.seed + 0x5EED, dev)
        self._test_x = torch.as_tensor(np.asarray(test_x, np.float32)).to(dev)
        self._test_y = torch.as_tensor(np.asarray(test_y, np.int32)).to(dev)

        # The device fit's labeled window, FIXED across capacities; the
        # dispatch guard refuses a chunk that could outgrow it.
        self._fit_budget = (min(cfg.forest.fit_budget, self._slab.capacity)
                            if cfg.forest.fit_budget is not None else serve.slab_rows)
        self._fit_budget_exhausted = False

        self.drift = drift_lib.DriftMonitor(
            entropy_shift=serve.drift_entropy_shift,
            margin_shift=serve.drift_margin_shift,
            min_fresh=serve.drift_min_fresh,
            max_staleness=serve.max_staleness,
        )

        self._programs: Dict[int, _CapacityPrograms] = {}
        # Sets of capacities the slab grew past, released once no re-fit
        # runs on them; their graphs' counts stay in graph_log.
        self._retired: List[_CapacityPrograms] = []
        self.graph_log: List[dict] = []
        self._programs_lock = threading.Lock()
        cuda = dev.type == "cuda"
        # On the card the endpoint is one CUDA graph on a stream of its own.
        # High priority: latency-bound, and drawn from the other half of
        # PyTorch's stream pool than the precompile worker's capture streams
        # (a capture must never share a stream with live scoring).
        self._score_fn = slab_lib.GraphedScore() if cuda else slab_lib.make_score_fn()
        self._score_tracker = _ProgramTracker(metrics, f"serve_score@{tenant_id}", self._score_fn)
        self._score_stream = torch.cuda.Stream(dev, priority=-1) if cuda else None
        self._forest_ready = torch.cuda.Event() if cuda else None
        self._ingest_buf_x: list = []
        self._ingest_buf_y: list = []
        # An in-flight single re-fit is (host_copy, t0, reason, progs); a
        # tenant-axis batched one is the shared _BatchedRefit.
        self._inflight = None
        self._inflight_polls = 0
        self._latency_causes: set = set()

        self._refresh_forest()
        if checkpoint_dir:
            self._try_restore(checkpoint_dir)
        self._forest_sig = _forest_signature(self._forest)

    # -- identity ------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._dev

    def _padded_seed_mask(self, capacity: int) -> Optional[torch.Tensor]:
        """The cold-start seed mask padded (False) to ``capacity`` rows: slab
        rows past the cold-start pool were never seeded."""
        if self._seed_mask0 is None:
            return None
        out = torch.zeros(capacity, dtype=torch.bool, device=self._dev)
        out[: self._seed_mask0.shape[0]] = self._seed_mask0
        return out

    def _set_edge_bounds(self) -> None:
        """Host copies of the outermost edges per feature: what the ingest
        path's out-of-range check compares blocks against."""
        e = self._edges.cpu().numpy()
        self._edges_lo = e[:, 0]
        self._edges_hi = e[:, -1]

    @property
    def forest_fingerprint(self) -> str:
        """Identity of the resident forest's feature space: the bin edges and
        their epoch (a bin refresh bumps it)."""
        import hashlib

        h = hashlib.sha256()
        h.update(self._edges.cpu().numpy().astype(np.float32).tobytes())
        h.update(str(self._edges_epoch).encode())
        return h.hexdigest()[:16]

    # -- drift-triggered bin-edge refresh ------------------------------------

    def _observe_block_range(self, bx: np.ndarray, count: int) -> None:
        """Fold one block's out-of-cold-start-range fraction (of its most
        drifted feature) into the EMA."""
        if getattr(self.serve, "bin_refresh_out_frac", 0.0) <= 0.0 or count == 0:
            return
        real = bx[:count]
        oob = float(np.max(np.mean((real < self._edges_lo) | (real > self._edges_hi), axis=0)))
        if self._oob_ema is None:
            self._oob_ema = oob
        else:
            self._oob_ema += 0.2 * (oob - self._oob_ema)
        self._fresh_since_refresh += count

    def _maybe_refresh_bins(self) -> None:
        thr = getattr(self.serve, "bin_refresh_out_frac", 0.0)
        if thr <= 0.0 or self._oob_ema is None:
            return
        if self._inflight is not None:
            return  # a chunk runs on the slab; defer
        if self._fresh_since_refresh < self.serve.drift_min_fresh:
            return
        if self._oob_ema > thr:
            self._refresh_bins()

    def _refresh_bins(self) -> None:
        """Re-quantile the bin edges from the live slab: edges from the
        filled rows' quantiles, the slab's codes re-coded in place, the
        program sets dropped (fit and chunk hold the old edges; the next use
        builds sets at the new epoch, which are warm-up by definition), the
        forest re-fit and its fingerprint bumped."""
        from distributed_active_learning_tpu_torch.ops import trees_train

        fill = self._fill
        self._edges = trees_train.make_bins(self._slab.x[:fill].clone(),
                                            self.cfg.forest.max_bins).edges
        self._edges_epoch += 1
        self._set_edge_bounds()
        self._slab.codes.copy_(trees_train.code_features(self._slab.x, self._edges))
        self._drop_programs()
        self.stats.bin_refreshes += 1
        obs.counter("bin_refreshes", "drift-triggered bin-edge re-quantiles",
                    tenant=self.tenant_id).inc()
        self._oob_ema = None
        self._fresh_since_refresh = 0
        self._latency_causes.add("bin_refresh_compile")
        telemetry.flight_record("bin_refresh", tenant=self.tenant_id, epoch=self._edges_epoch,
                                fill=fill, capacity=self._slab.capacity)
        if self.metrics is not None:
            self.metrics.event("bin_refresh", tenant=self.tenant_id, epoch=self._edges_epoch,
                               fill=fill, capacity=self._slab.capacity,
                               forest_fingerprint=self.forest_fingerprint)
        self._refresh_forest()
        self._schedule_precompile()

    def _chunk_signature(self) -> tuple:
        """What a tenant-axis batched re-fit groups on: tenants whose chunks
        run the same per-cell body may share one grid-chunk launch."""
        fc = self.cfg.forest
        return (
            self.cfg.strategy.name,
            self.cfg.strategy.window_size,
            tuple(sorted((k, str(v)) for k, v in self.cfg.strategy.options.items())),
            fc.n_trees, fc.max_depth, fc.max_bins, fc.kernel, fc.quantize,
            self.serve.refit_rounds,
            self.n_classes,
            self._fit_budget,
            int(self._slab.x.shape[1]),
            self.serve.slab_rows,
        )

    def _batchable_refit_reason(self) -> Optional[str]:
        """None if this tenant's re-fit may ride a tenant-axis batched
        launch; a named reason otherwise."""
        if self._aux.lal_forest is not None:
            return "lal_forest"  # the grid takes ONE regressor a group
        if self.cfg.forest.kernel not in _BATCHABLE_KERNELS:
            return f"kernel:{self.cfg.forest.kernel}"
        return None

    @property
    def refit_inflight(self) -> bool:
        return self._inflight is not None

    # -- program sets ----------------------------------------------------------

    def _build_programs(self, capacity: int, slab: Optional[slab_lib.SlabPool] = None,
                        precompile: bool = False) -> _CapacityPrograms:
        """One capacity's program set, on ``slab`` (the live slab, for the
        current capacity) or on fresh zeroed buffers. With ``precompile``
        (the worker) the chunk's graph is captured now, on those buffers, on
        the worker's capture stream; otherwise at its first dispatch."""
        from distributed_active_learning_tpu_torch.runtime.loop import (
            GraphedChunk,
            make_chunk_fn,
            make_device_fit,
        )

        edges_epoch, edges = self._edges_epoch, self._edges
        if slab is None:
            slab = slab_lib.empty_slab_pool(capacity, int(self._slab.x.shape[1]),
                                            self.serve.slab_rows, self._dev)
        seed_mask = self._padded_seed_mask(capacity)
        fit = make_device_fit(self.cfg, edges, self._fit_budget, self.n_classes)
        chunk = make_chunk_fn(self._strategy, self.cfg.strategy.window_size,
                              self.serve.refit_rounds, fit, label_cap=capacity,
                              with_metrics=True, n_classes=self.n_classes)
        if self._dev.type == "cuda":
            chunk = GraphedChunk(chunk)
            if precompile:
                dev = self._dev
                stream, warm_up = self._manager._capture_stream(("chunk",
                                                                 self._chunk_signature()))
                chunk.capture(
                    slab.codes,
                    slab_lib.flat_state(slab, torch.zeros(2, dtype=torch.int64, device=dev),
                                        torch.zeros((), dtype=torch.int32, device=dev)),
                    dataclasses.replace(self._aux, seed_mask=seed_mask), self._fit_key,
                    self._test_x, self._test_y, torch.zeros((), dtype=torch.int32, device=dev),
                    stream=stream, warm_up=warm_up)
        ingest = slab_lib.make_ingest_fn()
        m, tid = self.metrics, self.tenant_id
        return _CapacityPrograms(
            capacity=capacity, slab=slab, seed_mask=seed_mask,
            ingest=ingest, chunk=chunk, fit=fit,
            ingest_tracker=_ProgramTracker(m, f"serve_ingest@{tid}@{capacity}", ingest),
            chunk_tracker=_ProgramTracker(m, f"serve_chunk@{tid}@{capacity}", chunk),
            fit_tracker=_ProgramTracker(m, f"serve_fit@{tid}@{capacity}", fit),
            precompiled=precompile, edges_epoch=edges_epoch,
        )

    def _programs_for(self, capacity: int) -> _CapacityPrograms:
        """The set of ``capacity``, built on the request path if it is not
        resident (on the live slab when ``capacity`` is the slab's own)."""
        with self._programs_lock:
            progs = self._programs.get(capacity)
        if progs is not None:
            return progs
        live = capacity == self._slab.capacity
        progs = self._build_programs(capacity, slab=self._slab if live else None)
        if self._manager is not None:
            self._manager._note_request_path_build()
        with self._programs_lock:
            # the precompile worker may have landed meanwhile: its set wins
            # unless this capacity is the live slab's (whose buffers are the
            # ones in use)
            if live:
                self._programs[capacity] = progs  # audit: ok[DAL203] (the live set wins)
                return progs
            return self._programs.setdefault(capacity, progs)

    def _install_programs(self, capacity: int, progs: _CapacityPrograms) -> bool:
        with self._programs_lock:
            if progs.edges_epoch != self._edges_epoch:
                # built on pre-refresh edges: installing it would serve a
                # forest fit on a stale coding
                return False
            if capacity in self._programs or capacity <= self._slab.capacity:
                return False
            self._programs[capacity] = progs
            return True

    def _drop_programs(self) -> None:
        """Retire every set (a bin refresh or a restore: their closures or
        buffers are stale)."""
        with self._programs_lock:
            self._retired.extend(self._programs.values())
            self._programs = {}
        self._release_retired()

    def _retire_below(self, capacity: int) -> None:
        with self._programs_lock:
            for cap in [c for c in self._programs if c < capacity]:
                self._retired.append(self._programs.pop(cap))
        self._release_retired()

    def _release_retired(self) -> None:
        """Drop the retired sets once no re-fit runs on them: their graphs
        and the graphs' private pools go with the last reference."""
        if self._inflight is not None or not self._retired:
            return
        for p in self._retired:
            st = p.graph_stats()
            if st is not None and st["captures"]:
                self.graph_log.append(dict(capacity=p.capacity, precompiled=p.precompiled, **st))
        self._retired = []

    def live_graphs(self) -> int:
        """Chunk graphs this tenant holds: resident sets' captured graphs and
        retired ones not yet released."""
        with self._programs_lock:
            sets = list(self._programs.values()) + list(self._retired)
        return sum(1 for p in sets if getattr(p.chunk, "captures", 0))

    def program_stats(self) -> List[dict]:
        """Every captured chunk graph's counts (``GraphedChunk.stats``, with
        its capacity and whether the worker precompiled it), released ones
        first; empty on the CPU."""
        with self._programs_lock:
            sets = sorted(self._programs.items())
        live = [dict(capacity=cap, precompiled=p.precompiled, **st) for cap, p in sets
                if (st := p.graph_stats()) is not None and st["captures"]]
        return self.graph_log + live

    def _schedule_precompile(self) -> None:
        """Hand the NEXT capacity to the precompile worker once the
        watermark is within the headroom of the current capacity (and no
        retired graph is still waiting for its re-fit's touchdown: at most
        two chunk graphs a tenant)."""
        if self._manager is None or not self.serve.precompile_ahead or self._retired:
            return
        headroom = int(self.serve.precompile_headroom_slabs * self.serve.slab_rows)
        if self._slab.capacity - self._fill <= headroom:
            self._manager.schedule_precompile(self, self._slab.capacity + self.serve.slab_rows)

    # -- the three work sources ---------------------------------------------

    def score(self, queries) -> np.ndarray:
        """Score query points against the resident forest (the endpoint).
        Blocks only on its own batch; batches wider than ``score_width`` are
        served in width-sized sub-batches."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[0] == 0:
            return np.zeros((0,), np.float32)
        width = self.serve.score_width
        out = []
        for lo in range(0, q.shape[0], width):
            out.append(self._score_block(q[lo: lo + width]))
        return np.concatenate(out) if len(out) > 1 else out[0]

    def _score_stream_ctx(self):
        """The score stream, made to wait for the newest resident fit (the
        CPU: no stream)."""
        if self._score_stream is None:
            import contextlib

            return contextlib.nullcontext()
        self._score_stream.wait_event(self._forest_ready)
        return torch.cuda.stream(self._score_stream)

    def _score_block(self, q: np.ndarray) -> np.ndarray:
        self._poll_refit()
        n = q.shape[0]
        pad = self.serve.score_width - n
        qpad = np.pad(q, ((0, pad), (0, 0))) if pad else q
        t0 = time.perf_counter()
        with self._score_stream_ctx():
            scores, ent = self._score_fn(self._forest, _upload(qpad, torch.float32, self._dev))
            host = torch.stack([scores, ent]).cpu().numpy()  # the one blocking fetch
        dt = time.perf_counter() - t0
        self._score_tracker.record(dt, batch=n)
        self._finish_query(dt, n, float(np.mean(host[1, :n])))
        self._maybe_refit()
        return host[0, :n].copy()

    def _finish_query(self, dt: float, n: int, mean_entropy: float,
                      batched: bool = False) -> None:
        """Per-query bookkeeping shared by the single and grouped score
        paths: drift observation, stats, and the cause-tagged
        ``serve_latency`` event."""
        self.drift.observe_serve(mean_entropy)
        self.stats.queries += 1
        self.stats.scored_points += n
        self.last_query_inflight = self._inflight is not None
        if "slab_growth_compile" in self._latency_causes:
            cause = "slab_growth_compile"
        elif "bin_refresh_compile" in self._latency_causes:
            cause = "bin_refresh_compile"
        elif "refit_dispatch" in self._latency_causes or self._inflight is not None:
            cause = "refit_dispatch"
        else:
            cause = "none"
        self._latency_causes.clear()
        self.cause_counts[cause] = self.cause_counts.get(cause, 0) + 1
        self._obs_queries.inc()
        self._obs_points.inc(n)
        hist = self._obs_lat.get(cause)
        if hist is None:
            hist = self._obs_lat[cause] = obs.histogram(
                "serve_latency_seconds", "per-query scoring latency by concurrent cause",
                tenant=self.tenant_id, cause=cause)
        hist.observe(dt)
        obs.heartbeat("serve_query")
        if self.slo is not None:
            self.slo.observe(dt, ok=True)
            self._update_slo_gauges()
            if self.metrics is not None and self.stats.queries % 100 == 0:
                self._emit_slo_event()
        if self.metrics is not None:
            self.metrics.event("serve_latency", tenant=self.tenant_id, seconds=round(dt, 6),
                               batch=n, inflight_refit=self._inflight is not None, cause=cause,
                               batched=batched)

    def note_query_failure(self, error: Exception) -> None:
        """One score block that failed before producing a result
        (availability accounting: a failed query never meets the SLO)."""
        self.stats.query_failures += 1
        obs.counter("serve_query_failures", "score requests that raised",
                    tenant=self.tenant_id).inc()
        if self.slo is not None:
            self.slo.observe(None, ok=False)
            self._update_slo_gauges(force=True)
        if self.metrics is not None:
            self.metrics.event("serve_error", tenant=self.tenant_id, error=repr(error)[:200])

    def _update_slo_gauges(self, force: bool = False) -> None:
        """Refresh the compliance and burn gauges, at most once a second
        (failures refresh at once)."""
        now = time.monotonic()
        if not force and now - self._slo_gauge_ts < 1.0:
            return
        self._slo_gauge_ts = now
        comp = self.slo.compliance()
        if comp is not None:
            if self._obs_slo_comp is None:
                self._obs_slo_comp = obs.gauge(
                    "slo_compliance_ratio",
                    "lifetime fraction of queries meeting the tenant's SLO",
                    tenant=self.tenant_id)
            self._obs_slo_comp.set(round(comp, 6))
        for name, rate in self.slo.burn_rates().items():
            if rate is None:
                continue
            g = self._obs_slo_burn.get(name)
            if g is None:
                g = self._obs_slo_burn[name] = obs.gauge(
                    "slo_burn_rate", "windowed error-budget burn rate (1.0 = sustainable)",
                    tenant=self.tenant_id, window=name)
            g.set(round(rate, 4))

    def _emit_slo_event(self) -> None:
        if self.metrics is None or self.slo is None:
            return
        snap = self.slo.snapshot()
        burn = snap.pop("burn")
        self.metrics.event("slo", tenant=self.tenant_id, **snap,
                           **{f"burn_{name}": rate for name, rate in burn.items()})

    def submit(self, x, y) -> None:
        """Queue arriving points with their eventual oracle labels (hidden
        until an AL round reveals them)."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        y = np.asarray(y, np.int32).reshape(-1)
        if y.size and int(y.max()) >= self.n_classes:
            raise ValueError(
                f"ingested label {int(y.max())} is out of range for the "
                f"service's {self.n_classes} classes (fixed by the cold-start "
                "corpus); restart the service with a corpus covering every "
                "class"
            )
        self._ingest_buf_x.append(x)
        self._ingest_buf_y.append(y)
        self._poll_refit()
        self._drain_ingest()
        self._maybe_refit()

    def flush(self) -> None:
        """Drain any partial ingest block and force an in-flight re-fit's
        touchdown: the quiesce point (checkpoint, shutdown, test barriers)."""
        self._drain_ingest(force=True)
        self._poll_refit(force=True)
        if self.slo is not None and self.stats.queries:
            self._emit_slo_event()

    # -- ingest --------------------------------------------------------------

    def _drain_ingest(self, force: bool = False) -> None:
        if not self._ingest_buf_x:
            return
        bx = np.concatenate(self._ingest_buf_x)
        by = np.concatenate(self._ingest_buf_y)
        block = self.serve.ingest_block
        lo = 0
        while bx.shape[0] - lo >= block:
            self._ingest_block(bx[lo: lo + block], by[lo: lo + block], block)
            lo += block
        if force and lo < bx.shape[0]:
            px, py, count = slab_lib.pad_block(bx[lo:], by[lo:], block)
            self._ingest_block(px, py, count)
            lo = bx.shape[0]
        self._ingest_buf_x = [bx[lo:]] if lo < bx.shape[0] else []
        self._ingest_buf_y = [by[lo:]] if lo < bx.shape[0] else []

    def _ingest_block(self, bx: np.ndarray, by: np.ndarray, count: int) -> None:
        block = self.serve.ingest_block
        while self._fill + block > self._slab.capacity:
            self._grow()
        progs = self._programs_for(self._slab.capacity)
        t0 = time.perf_counter()
        progs.ingest(self._slab, self._edges, _upload(bx, torch.float32, self._dev),
                     _upload(by, torch.int32, self._dev), count, self._fill)
        dt = time.perf_counter() - t0  # enqueue wall: the writes are queued
        progs.ingest_tracker.record(dt, points=count)
        self._fill += count
        self.stats.ingest_blocks += 1
        self.stats.ingested_points += count
        obs.counter("ingest_points", "points ingested", tenant=self.tenant_id).inc(count)
        obs.gauge("slab_fill", "slab fill watermark (rows)", tenant=self.tenant_id).set(self._fill)
        obs.gauge("slab_capacity", "slab capacity (rows)",
                  tenant=self.tenant_id).set(self._slab.capacity)
        self.drift.observe_ingest(count)
        self._observe_block_range(bx, count)
        self._maybe_refresh_bins()
        if self.metrics is not None:
            self.metrics.event("ingest", tenant=self.tenant_id, points=count,
                               seconds=round(dt, 6), fill=self._fill,
                               capacity=self._slab.capacity)
        self._schedule_precompile()

    def _grow(self) -> None:
        """Grow by one slab: the next capacity's set (precompiled, or built
        now), the filled rows copied into its buffers, the old set
        retired."""
        cap = self._slab.capacity + self.serve.slab_rows
        with self._programs_lock:
            ready = cap in self._programs
        if not ready and self._manager is not None:
            # A precompile may be mid-flight: wait for it rather than build
            # the same set twice. The wait is still a growth stall.
            self._manager.wait_precompile(self, cap)
        progs = self._programs_for(cap)
        self._slab = slab_lib.grow_slab(self._slab, into=progs.slab)
        self._aux = dataclasses.replace(self._aux, seed_mask=progs.seed_mask)
        self._retire_below(cap)
        if self._manager is not None:
            self._manager._release_batched()
        self.stats.slab_growths += 1
        obs.counter("slab_growths", "slab capacity growths", tenant=self.tenant_id).inc()
        if ready:
            self.stats.growths_precompiled += 1
            obs.counter("slab_growths_precompiled",
                        "growths that swapped in precompiled programs",
                        tenant=self.tenant_id).inc()
        else:
            self._latency_causes.add("slab_growth_compile")
        telemetry.flight_record("slab_grow", tenant=self.tenant_id, capacity=cap, fill=self._fill,
                                buffered=sum(len(b) for b in self._ingest_buf_x),
                                precompiled=ready)
        if self.metrics is not None:
            self.metrics.event("slab_grow", tenant=self.tenant_id, capacity=cap, fill=self._fill,
                               precompiled=ready)
        self._schedule_precompile()

    # -- re-fit --------------------------------------------------------------

    def _refit_candidate(self) -> Optional[str]:
        """The drift decision plus every dispatch guard, without
        dispatching (the manager batches coinciding re-fits)."""
        if self._inflight is not None or self._fit_budget_exhausted:
            return None
        reason = self.drift.should_refit()
        if reason is None:
            return None
        return self._check_refit_guards(reason)

    def _check_refit_guards(self, reason: str) -> Optional[str]:
        if self._fill - self._labeled <= 0:
            return None  # nothing left to label
        K, window = self.serve.refit_rounds, self.cfg.strategy.window_size
        if self._labeled + K * window > self._fit_budget:
            # The device fit's labeled window is fixed; overrunning it would
            # truncate the fit. Refuse loudly, once.
            self._fit_budget_exhausted = True
            self.stats.refits_skipped_fit_budget += 1
            if self.metrics is not None:
                self.metrics.event("refit_skipped", tenant=self.tenant_id, reason="fit_budget",
                                   labeled=self._labeled, fit_budget=self._fit_budget)
            return None
        return reason

    def _maybe_refit(self) -> None:
        if self._manager is not None:
            self._manager._maybe_refit_group()
            return
        reason = self._refit_candidate()
        if reason is not None:
            self._dispatch_refit(reason)

    def refit_now(self, reason: str = "manual") -> bool:
        """Dispatch a re-fit chunk now (warmup, operator request), past the
        drift decision but not the guards; returns whether one launched."""
        if self._inflight is not None or self._fit_budget_exhausted:
            return False
        if self._check_refit_guards(reason) is None:
            return False
        self._dispatch_refit(reason)
        return True

    def _record_refit_dispatch(self, reason: str) -> None:
        self.stats.refits += 1
        self.refit_reasons[reason] = self.refit_reasons.get(reason, 0) + 1
        obs.counter("refits", "re-fit chunk dispatches by drift reason", tenant=self.tenant_id,
                    reason=reason).inc()
        obs.gauge("refit_inflight", "1 while a re-fit chunk is in flight",
                  tenant=self.tenant_id).set(1)
        self._latency_causes.add("refit_dispatch")
        telemetry.flight_record("refit", tenant=self.tenant_id, reason=reason,
                                rounds=self.serve.refit_rounds, labeled=self._labeled,
                                fill=self._fill, capacity=self._slab.capacity,
                                buffered=sum(len(b) for b in self._ingest_buf_x))
        if self.metrics is not None:
            self.metrics.event("refit", tenant=self.tenant_id, reason=reason,
                               rounds=self.serve.refit_rounds, labeled=self._labeled,
                               fill=self._fill, capacity=self._slab.capacity)

    def _dispatch_refit(self, reason: str) -> None:
        from distributed_active_learning_tpu_torch.runtime.pipeline import start_host_copy

        progs = self._programs_for(self._slab.capacity)
        state = slab_lib.flat_state(self._slab, self._key, self._round)
        end_round = torch.full((), self._round_host + self.serve.refit_rounds,
                               dtype=torch.int32, device=self._dev)
        args = (self._slab.codes, state, self._aux, self._fit_key, self._test_x, self._test_y,
                end_round)
        t0 = time.perf_counter()
        if getattr(progs.chunk, "captures", None) == 0 and self._manager is not None:
            # Not precompiled: the worker captures it now, on its stream.
            self._manager._capture_on_worker(progs.chunk, args, ("chunk", self._chunk_signature()))
        timing = _ChunkTiming(self._dev)
        out_state, extras, ys = progs.chunk(*args)
        timing.stop()
        # The extras and ys go to pinned host memory, queued behind the
        # replays.
        copy = start_host_copy((extras, ys))
        # The chunk's carry is the slab's mask from here on: later ingests
        # and the next dispatch queue behind the running chunk.
        self._slab = self._slab.replace(labeled_mask=out_state.labeled_mask)
        self._key = out_state.key
        self._round = out_state.round
        self._inflight = (copy, t0, reason, progs, timing)
        self._inflight_polls = 0
        self._record_refit_dispatch(reason)

    def _poll_refit(self, force: bool = False) -> None:
        if self._inflight is None:
            return
        if isinstance(self._inflight, _BatchedRefit):
            self._inflight.poll(force=force)
            return
        copy = self._inflight[0]
        self._inflight_polls += 1
        ready = True if force else copy.ready()
        if force or ready or self._inflight_polls >= self.serve.refit_poll_events:
            self._touchdown()

    def _touchdown(self) -> None:
        copy, t0, reason, progs, timing = self._inflight
        self._inflight = None
        extras, ys = copy.wait()  # blocks if the chunk still runs
        n_labeled_after = int(extras.n_labeled_after)
        n_active = int(extras.n_active)
        self.chunk_seconds.append((n_active, timing.seconds()))
        dt = time.perf_counter() - t0
        telemetry.flight_record("touchdown", tenant=self.tenant_id,
                                program=progs.chunk_tracker.program, reason=reason,
                                n_active=n_active, n_labeled_after=n_labeled_after,
                                seconds=round(dt, 6), polls=self._inflight_polls)
        progs.chunk_tracker.record(dt, reason=reason)
        self._labeled = n_labeled_after
        self._round_host += n_active
        self.stats.refit_rounds += n_active
        self._obs_refit_touchdown(n_active)
        self._release_retired()
        if n_active:
            rounds_y, labeled_y, acc_y, _picked_y, active_y = ys[:5]
            active_np = np.asarray(active_y)
            rounds_np = np.asarray(rounds_y)[active_np]
            labeled_np = np.asarray(labeled_y)[active_np]
            acc_np = np.asarray(acc_y)[active_np]
            round_dicts = telemetry.stacked_metrics_to_dicts(ys[5], active_np)
            self._absorb_rounds(rounds_np, labeled_np, acc_np, round_dicts, dt / n_active)
        self._schedule_precompile()

    def _obs_refit_touchdown(self, n_active: int) -> None:
        """Ops-plane echo of one re-fit touchdown (single and batched)."""
        obs.gauge("refit_inflight", "1 while a re-fit chunk is in flight",
                  tenant=self.tenant_id).set(0)
        obs.counter("refit_rounds", "AL rounds completed by re-fit chunks",
                    tenant=self.tenant_id).inc(n_active)
        obs.heartbeat("serve_touchdown")

    def _absorb_rounds(self, rounds_np, labeled_np, acc_np, round_dicts,
                       per_round_seconds) -> None:
        """Fold one touchdown's active rounds into records, drift and
        metrics, and refresh the resident forest (single and batched)."""
        self.result.extend_from_arrays(rounds_np, labeled_np,
                                       np.maximum(self._fill - labeled_np, 0), acc_np,
                                       total_time=per_round_seconds, metrics=round_dicts)
        self.drift.observe_chunk(round_dicts)
        if self.metrics is not None:
            for i in range(len(rounds_np)):
                self.metrics.round(tenant=self.tenant_id, round=int(rounds_np[i]),
                                   n_labeled=int(labeled_np[i]), accuracy=float(acc_np[i]),
                                   **round_dicts[i])
        self._refresh_forest()

    def _refresh_forest(self) -> None:
        """Re-fit the RESIDENT forest from the current labeled set, queued on
        the dispatcher's stream; the score stream waits on the event
        recorded behind it."""
        progs = self._programs_for(self._slab.capacity)
        state = slab_lib.flat_state(self._slab, self._key, self._round)
        t0 = time.perf_counter()
        self._forest = progs.fit(self._slab.codes, state,
                                 prng.fold_in(self._fit_key, self._round_host))
        if self._forest_ready is not None:
            self._forest_ready.record(torch.cuda.current_stream(self._dev))
        progs.fit_tracker.record(time.perf_counter() - t0)

    # -- persistence ---------------------------------------------------------

    def save_checkpoint(self) -> Optional[str]:
        """Persist the slab's filled rows, mask, watermark and the resident
        forest (``runtime/checkpoint.py save_serve``), so a killed service
        resumes without replaying ingest."""
        if not self.checkpoint_dir:
            return None
        from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

        self.flush()
        state = slab_lib.flat_state(self._slab, self._key, self._round)
        return ckpt_lib.save_serve(
            self.checkpoint_dir, state, self._forest, self.result,
            fingerprint=ckpt_lib.config_fingerprint(self.cfg), tenant=self._ckpt_name,
            edges=self._edges, edges_epoch=self._edges_epoch)

    def _try_restore(self, ckpt_dir: str) -> bool:
        from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

        restored = ckpt_lib.restore_latest_serve(
            ckpt_dir, self._forest, fingerprint=ckpt_lib.config_fingerprint(self.cfg),
            tenant=self._ckpt_name)
        if restored is None:
            return False
        x, y, mask, n_filled, key_data, rnd, forest, result, edges, edges_epoch = restored
        if edges is not None and int(edges_epoch) > self._edges_epoch:
            # The checkpointed service had refreshed its bin edges: its
            # forest was fitted on codes against those edges.
            self._edges = torch.as_tensor(np.asarray(edges, np.float32)).to(self._dev)
            self._edges_epoch = int(edges_epoch)
            self._set_edge_bounds()
        self._drop_programs()
        self._slab = slab_lib.init_slab_pool(x, y, mask, self._edges, self.serve.slab_rows)
        self._aux = dataclasses.replace(
            self._aux, seed_mask=self._padded_seed_mask(self._slab.capacity))
        self._fill = int(n_filled)
        self._key = torch.as_tensor(np.asarray(key_data, np.uint32).astype(np.int64)).to(self._dev)
        self._round = torch.tensor(int(rnd), dtype=torch.int32, device=self._dev)
        self._round_host = int(rnd)
        self._forest = forest
        if self._forest_ready is not None:
            self._forest_ready.record(torch.cuda.current_stream(self._dev))
        self.result = result
        self._labeled = int(np.asarray(mask).sum())
        return True

    # -- reporting -----------------------------------------------------------

    def recompiles_after_warmup(self) -> int:
        """Graph recaptures of every program instance (never expected: a
        GraphedChunk raises instead of recapturing)."""
        total = self._score_tracker.recompiles
        with self._programs_lock:
            progs_list = list(self._programs.values())
        for progs in progs_list:
            total += (progs.ingest_tracker.recompiles + progs.chunk_tracker.recompiles
                      + progs.fit_tracker.recompiles)
        return total

    def summary(self) -> Dict:
        out = {
            "tenant": self.tenant_id,
            "queries": self.stats.queries,
            "query_failures": self.stats.query_failures,
            "scored_points": self.stats.scored_points,
            "ingest_blocks": self.stats.ingest_blocks,
            "ingested_points": self.stats.ingested_points,
            "refits": self.stats.refits,
            "refit_rounds": self.stats.refit_rounds,
            "refit_reasons": dict(self.refit_reasons),
            "refits_skipped_fit_budget": self.stats.refits_skipped_fit_budget,
            "slab_growths": self.stats.slab_growths,
            "growths_precompiled": self.stats.growths_precompiled,
            "bin_refreshes": self.stats.bin_refreshes,
            "bin_epoch": self._edges_epoch,
            "forest_fingerprint": self.forest_fingerprint,
            "capacity": self._slab.capacity,
            "fill": self._fill,
            "labeled": self._labeled,
            "latency_causes": dict(self.cause_counts),
            "recompiles_after_warmup": self.recompiles_after_warmup(),
        }
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        return out


class _ChunkTiming:
    """A chunk call's time: CUDA events around its launches on the card
    (read at touchdown, once the chunk has run), the host clock around the
    call on the CPU, where the chunk runs inside it."""

    def __init__(self, dev: torch.device):
        self._events = None
        self._t0 = time.perf_counter()
        self._host = None
        if dev.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()

    def stop(self) -> None:
        if self._events is not None:
            self._events[1].record()
        else:
            self._host = time.perf_counter() - self._t0

    def seconds(self) -> float:
        if self._events is not None:
            return self._events[0].elapsed_time(self._events[1]) / 1e3
        return self._host


class _BatchedRefit:
    """One in-flight tenant-axis re-fit: the shared handle every
    participant's ``_inflight`` points at. The grid chunk's carry, extras and
    ys were queued to host memory at dispatch; touchdown unstacks them onto
    each participant (non-candidates rode as masked no-ops and are
    skipped)."""

    def __init__(self, manager: "TenantManager", members: List[Tenant],
                 participants: Dict[str, Tuple[int, str]], caps_at_dispatch: List[int],
                 copy, t0: float, entry: "_BatchedChunk"):
        self.manager = manager
        self.entry = entry
        self.members = members
        self.participants = participants
        self.caps_at_dispatch = caps_at_dispatch
        self.copy = copy
        self.t0 = t0
        self.tracker = entry.tracker
        self.polls = 0
        self.done = False
        self._poll_limit = min(t.serve.refit_poll_events for t in members)

    def poll(self, force: bool = False) -> None:
        if self.done:
            return
        self.polls += 1
        ready = True if force else self.copy.ready()
        if force or ready or self.polls >= self._poll_limit:
            self.touchdown()

    def touchdown(self) -> None:
        if self.done:
            return
        self.done = True
        (masks, keys, rounds), _extras, ys = self.copy.wait()
        active_all = np.asarray(ys[4])  # [K, T] bool
        dt = time.perf_counter() - self.t0
        dicts_by_cell = telemetry.stacked_sweep_metrics_to_dicts(ys[5], active_all)
        rounds_all, labeled_all, acc_all = (np.asarray(y) for y in ys[:3])
        masks, keys, rounds = (np.asarray(a) for a in (masks, keys, rounds))
        by_id = {t.tenant_id: (i, t) for i, t in enumerate(self.members)}
        for tid, (cell, reason) in self.participants.items():
            i, t = by_id[tid]
            t._inflight = None
            active_np = active_all[:, i]
            n_active = int(active_np.sum())
            cap_i = self.caps_at_dispatch[i]
            host_mask = np.zeros(t._slab.capacity, dtype=bool)  # the tenant may have grown
            host_mask[:cap_i] = masks[i, :cap_i]
            t._slab = t._slab.replace(labeled_mask=_upload(host_mask, torch.bool, t.device))
            t._key = _upload(keys[i], torch.int64, t.device)
            t._round = torch.full((), int(rounds[i]), dtype=torch.int32, device=t.device)
            t._labeled = int(host_mask[:cap_i].sum())
            t._round_host += n_active
            t.stats.refit_rounds += n_active
            t._obs_refit_touchdown(n_active)
            t._release_retired()
            telemetry.flight_record("touchdown", tenant=tid, program=self.tracker.program,
                                    reason=reason, n_active=n_active, n_labeled_after=t._labeled,
                                    seconds=round(dt, 6), polls=self.polls, batched=True)
            if n_active:
                sel = np.flatnonzero(active_np)
                t._absorb_rounds(rounds_all[sel, i], labeled_all[sel, i], acc_all[sel, i],
                                 dicts_by_cell[i], dt / n_active)
            t._schedule_precompile()
        self.tracker.record(dt, tenants=len(self.participants))
        self.entry.inflight -= 1
        self.manager._release_batched()


class _BatchedChunk:
    """The tenant-axis chunk of one signature group at one padded capacity:
    the grid chunk (a GraphedChunk on CUDA) and the stacked buffers it reads
    as constants, refilled in place from the members' slabs at every
    dispatch."""

    def __init__(self, chunk, tracker: _ProgramTracker, bufs: dict, cap_max: int):
        self.chunk = chunk
        self.tracker = tracker
        self.bufs = bufs
        self.cap_max = cap_max
        self.inflight = 0


@dataclasses.dataclass
class _PrecompileJob:
    kind: str                       # "capacity" | "batched_chunk" | "capture"
    tenant: Optional[Tenant]
    capacity: int
    group_key: Optional[tuple] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    ok: bool = False
    fn: Optional[object] = None     # a "capture" job's fn(stream, warm_up)
    error: Optional[BaseException] = None


class TenantManager:
    """N resident tenants, the cross-tenant paths, and the capacity
    precompile worker (module docstring):

    - ``add_tenant`` makes a dataset x model resident (restoring from its
      tenant-axis serve checkpoint when one exists);
    - ``score_many`` serves concurrent score requests as one grouped launch
      per same-signature group (named per-tenant fallback otherwise);
    - coinciding drift re-fits of same-configuration tenants run as one
      tenant-axis grid chunk;
    - slab growth swaps in a set the worker built and captured ahead.

    ``device`` defaults to CUDA and raises without a card unless it is
    ``"cpu"``.
    """

    def __init__(self, metrics=None, checkpoint_dir: Optional[str] = None, device=None):
        self.metrics = metrics
        self.checkpoint_dir = checkpoint_dir
        self.device = resolve_device(device)
        # The card the precompile worker's thread works on: the device's
        # index, or the creating thread's current card.
        self._device_index = (None if self.device.type != "cuda" else
                              self.device.index if self.device.index is not None
                              else torch.cuda.current_device())
        self._tenants: Dict[str, Tenant] = {}
        self._lock = threading.RLock()
        self._score_groups: Optional[Dict[tuple, _ScoreGroup]] = None
        self._prev_score_groups: Dict[tuple, _ScoreGroup] = {}
        self._score_fallback_by_tid: Dict[str, str] = {}
        self._retired_group_recompiles = 0
        self.batched_score_launches = 0
        self.score_fallback_reasons: Dict[str, int] = {}
        self._batched_chunks: Dict[tuple, _BatchedChunk] = {}
        self.batched_refit_launches = 0
        # (priority, order, job): a capture the dispatcher waits for, then a
        # tenant's next capacity (what a growth waits for), then a
        # tenant-axis chunk; None stops the worker.
        self._queue: "queue_lib.PriorityQueue" = queue_lib.PriorityQueue()
        self._order = 0
        self._stream = None  # the worker's capture stream, made in its thread
        self._warmed: set = set()
        self._pending: Dict[tuple, _PrecompileJob] = {}
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.precompiles = 0
        self.precompile_errors = 0
        # Program sets built, and graphs captured, on the request path after
        # mark_warmup_complete (the precompile's failures): the port's share
        # of recompiles_after_warmup.
        self._warm = False
        self.request_path_builds_after_warmup = 0
        self.request_path_captures_after_warmup = 0
        _LIVE_MANAGERS.add(self)

    # -- tenancy -------------------------------------------------------------

    def add_tenant(self, tenant_id: str, cfg: ExperimentConfig, serve: ServeConfig, train_x,
                   train_y, test_x, test_y, ckpt_name: str = "__tenant_id__") -> Tenant:
        """Make a tenant resident (cold start, or resumed from its
        tenant-axis serve checkpoint). ``ckpt_name`` defaults to the tenant
        id; ``None`` keeps the single-tenant file names."""
        if not _TENANT_ID_RE.fullmatch(tenant_id):
            raise ValueError(
                f"tenant id {tenant_id!r} must match {_TENANT_ID_RE.pattern} "
                "(it names checkpoint files and telemetry streams)"
            )
        if getattr(serve, "slo_weight", 1.0) <= 0.0:
            raise ValueError(
                f"tenant {tenant_id!r} has slo_weight="
                f"{serve.slo_weight}; weights must be > 0 (1.0 = served "
                "every contended cycle, 0.5 = every other one) — to pause "
                "a tenant, stop submitting to it"
            )
        if getattr(serve, "slo_priority", 0) < 0:
            raise ValueError(
                f"tenant {tenant_id!r} has slo_priority="
                f"{serve.slo_priority}; priorities are >= 0 (admission cap "
                "scales by 1 + priority)"
            )
        with self._lock:
            if tenant_id in self._tenants:
                raise ValueError(f"tenant {tenant_id!r} is already resident")
            tenant = Tenant(
                tenant_id, cfg, serve, train_x, train_y, test_x, test_y,
                metrics=self.metrics, checkpoint_dir=self.checkpoint_dir,
                ckpt_name=tenant_id if ckpt_name == "__tenant_id__" else ckpt_name,
                manager=self, device=self.device,
            )
            self._tenants[tenant_id] = tenant
            self._score_groups = None
        if self.metrics is not None:
            self.metrics.event("tenant_added", tenant=tenant_id, capacity=tenant._slab.capacity,
                               fill=tenant._fill, n_classes=tenant.n_classes,
                               strategy=cfg.strategy.name)
        tenant._schedule_precompile()
        return tenant

    def tenant(self, tenant_id: str) -> Tenant:
        return self._tenants[tenant_id]

    @property
    def tenant_ids(self) -> List[str]:
        return list(self._tenants)

    def __len__(self) -> int:
        return len(self._tenants)

    # -- scoring -------------------------------------------------------------

    def score(self, tenant_id: str, queries) -> np.ndarray:
        return self._tenants[tenant_id].score(queries)

    def submit(self, tenant_id: str, x, y) -> None:
        self._tenants[tenant_id].submit(x, y)

    def _tenant_group_key(self, t: Tenant) -> tuple:
        return (t._forest_sig, t.serve.score_width, int(t._slab.x.shape[1]))

    def _score_grouping(self) -> Tuple[Dict[tuple, _ScoreGroup], Dict[str, str]]:
        """Same-signature groups of >= 2 and a NAMED fallback reason for
        every other tenant; rebuilt only when the tenant set changes."""
        with self._lock:
            if self._score_groups is not None:
                return self._score_groups, self._score_fallback_by_tid
            members: Dict[tuple, List[str]] = {}
            fallback: Dict[str, str] = {}
            single = len(self._tenants) < 2
            for tid, t in self._tenants.items():
                if t.cfg.forest.kernel not in _BATCHABLE_KERNELS:
                    fallback[tid] = "kernel"
                    continue
                members.setdefault(self._tenant_group_key(t), []).append(tid)
            prev = self._prev_score_groups
            groups: Dict[tuple, _ScoreGroup] = {}
            for key, tids in members.items():
                if single:
                    fallback[tids[0]] = "single_tenant"
                elif len(tids) < 2:
                    fallback[tids[0]] = "singleton_signature"
                else:
                    old = prev.get(key)
                    groups[key] = (old if old is not None and old.tids == tids
                                   else _ScoreGroup(key, tids, self.metrics))
            for key, old in prev.items():
                if groups.get(key) is not old:
                    self._retired_group_recompiles += old.tracker.recompiles
            self._prev_score_groups = groups
            self._score_groups = groups
            self._score_fallback_by_tid = fallback
            return groups, fallback

    def score_groups(self) -> List[List[str]]:
        groups, _ = self._score_grouping()
        return [list(g.tids) for g in groups.values()]

    def _group_launch(self, group: _ScoreGroup, qpad: np.ndarray):
        """One grouped launch: every member's forest over its own block, on
        the first member's score stream, after every member's newest fit."""
        members = [self._tenants[tid] for tid in group.tids]
        lead = members[0]
        if lead._score_stream is None:
            ctx = lead._score_stream_ctx()
        else:
            for t in members:
                lead._score_stream.wait_event(t._forest_ready)
            ctx = torch.cuda.stream(lead._score_stream)
        with ctx:
            q = _upload(qpad, torch.float32, self.device)
            if lead._score_stream is None:
                scores, ents = group.fn([t._forest for t in members], q)
            else:  # each member's graphed endpoint, replayed on the lead's stream
                outs = [t._score_fn(t._forest, q[i]) for i, t in enumerate(members)]
                scores = torch.stack([o[0] for o in outs])
                ents = torch.stack([o[1] for o in outs])
            host = torch.stack([scores, ents]).cpu().numpy()
        return host[0], host[1]

    def score_many(self, requests: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Serve concurrent score requests from several tenants as grouped
        launches (one per group per width-round); tenants no group holds
        fall back to the per-tenant endpoint, each with a named reason."""
        order = [tid for tid in self._tenants if tid in requests]
        unknown = set(requests) - set(order)
        if unknown:
            raise KeyError(f"unknown tenants in score_many: {sorted(unknown)}")
        if not order:
            return {}
        groups, fallback_by_tid = self._score_grouping()
        arrays: Dict[str, np.ndarray] = {}
        for tid in order:
            q = np.asarray(requests[tid], np.float32)
            if q.ndim == 1:
                q = q[None, :]
            arrays[tid] = q
        outs: Dict[str, list] = {tid: [] for tid in order}
        pos = {tid: 0 for tid in order}

        def charge_failure(e: Exception, attempted) -> None:
            # Completion-aware availability accounting: the tenants of the
            # failed attempt and those with blocks never attempted.
            for tid in order:
                if tid in attempted or pos[tid] < arrays[tid].shape[0]:
                    self._tenants[tid].note_query_failure(e)

        for group in groups.values():
            in_play = [tid for tid in group.tids if tid in arrays]
            if not in_play:
                continue
            width, d = group.width, group.features
            while any(pos[tid] < arrays[tid].shape[0] for tid in in_play):
                self.poll()
                qpad = np.zeros((len(group.tids), width, d), np.float32)
                n_valid = [0] * len(group.tids)
                round_tids = set()
                for i, tid in enumerate(group.tids):
                    if tid not in arrays or pos[tid] >= arrays[tid].shape[0]:
                        continue
                    block = arrays[tid][pos[tid]: pos[tid] + width]
                    pos[tid] += block.shape[0]
                    qpad[i, : block.shape[0]] = block
                    n_valid[i] = block.shape[0]
                    round_tids.add(tid)
                try:
                    t0 = time.perf_counter()
                    scores_np, ents_np = self._group_launch(group, qpad)
                    dt = time.perf_counter() - t0
                except Exception as e:
                    charge_failure(e, round_tids)
                    raise
                group.tracker.record(dt, tenants=sum(1 for n in n_valid if n),
                                     group_size=len(group.tids))
                group.launches += 1
                self.batched_score_launches += 1
                for i, tid in enumerate(group.tids):
                    n = n_valid[i]
                    if not n:
                        continue
                    outs[tid].append(scores_np[i, :n].copy())
                    self._tenants[tid]._finish_query(dt, n, float(np.mean(ents_np[i, :n])),
                                                     batched=True)
                self._maybe_refit_group()
        for tid in order:
            reason = fallback_by_tid.get(tid)
            if reason is None:
                continue
            self.score_fallback_reasons[reason] = self.score_fallback_reasons.get(reason, 0) + 1
            try:
                outs[tid].append(self._tenants[tid].score(arrays[tid]))
                pos[tid] = arrays[tid].shape[0]
            except Exception as e:
                charge_failure(e, {tid})
                raise
        return {
            tid: (np.concatenate(outs[tid]) if len(outs[tid]) > 1
                  else outs[tid][0] if outs[tid]
                  else np.zeros((0,), np.float32))
            for tid in order
        }

    # -- re-fit grouping -------------------------------------------------------

    def _maybe_refit_group(self) -> None:
        """Collect drift-triggered candidates across tenants; same-signature
        groups of >= 2 dispatch as ONE tenant-axis chunk, the rest singly."""
        candidates: List[Tuple[Tenant, str]] = []
        for t in self._tenants.values():
            reason = t._refit_candidate()
            if reason is not None:
                candidates.append((t, reason))
        if candidates:
            self._dispatch_refits(candidates)

    def refit_now(self, reason: str = "manual") -> int:
        """Dispatch re-fits for every eligible tenant now (batched per
        signature group); returns how many tenants launched."""
        candidates = []
        for t in self._tenants.values():
            if t._inflight is not None or t._fit_budget_exhausted:
                continue
            if t._check_refit_guards(reason) is None:
                continue
            candidates.append((t, reason))
        self._dispatch_refits(candidates)
        return len(candidates)

    def _dispatch_refits(self, candidates: List[Tuple[Tenant, str]]) -> None:
        groups: Dict[tuple, List[Tuple[Tenant, str]]] = {}
        singles: List[Tuple[Tenant, str]] = []
        for t, reason in candidates:
            if t._batchable_refit_reason() is None:
                groups.setdefault(t._chunk_signature(), []).append((t, reason))
            else:
                singles.append((t, reason))
        for sig, members in groups.items():
            if len(members) >= 2:
                self._dispatch_batched_refit(sig, members)
            else:
                singles.extend(members)
        for t, reason in singles:
            t._dispatch_refit(reason)

    def _group_members(self, sig: tuple) -> List[Tenant]:
        """Every resident tenant sharing a chunk signature, in registration
        order: the stable tenant axis of a batched re-fit."""
        return [t for t in self._tenants.values()
                if t._batchable_refit_reason() is None and t._chunk_signature() == sig]

    def _batched_key(self, sig: tuple, members: List[Tenant], cap_max: int) -> tuple:
        t_max = max(int(t._test_x.shape[0]) for t in members)
        use_tf = len({int(t._test_x.shape[0]) for t in members}) > 1
        return (sig, len(members), cap_max, t_max, use_tf)

    def _batched_chunk_for(self, sig: tuple, members: List[Tenant], cap_max: int,
                           precompile: bool = False) -> _BatchedChunk:
        """The tenant-axis chunk of one signature group at one padded
        capacity: the grid chunk with tenants on the dataset axis (G = 1,
        D = T, E = 1), its stacked buffers, and on CUDA its graph (captured
        now with ``precompile``, else at its first dispatch)."""
        from distributed_active_learning_tpu_torch.runtime.loop import (
            GraphedChunk,
            _device_fit_core,
        )
        from distributed_active_learning_tpu_torch.runtime.sweep import (
            SweepState,
            make_grid_chunk_fn,
        )

        key = self._batched_key(sig, members, cap_max)
        with self._lock:
            cached = self._batched_chunks.get(key)
            job = None if precompile else self._pending.get(("batched", key))
        if job is not None:
            # The worker is building this very chunk: wait for it rather than
            # capture it a second time on the request path.
            self._wait_job(job, None)
            with self._lock:
                cached = self._batched_chunks.get(key)
        if cached is not None:
            return cached
        rep = members[0]
        T, dev = len(members), self.device
        t_max, use_test_fill = key[3], key[4]
        d = int(rep._slab.x.shape[1])
        body = make_grid_chunk_fn(
            [rep._strategy], rep.cfg.strategy.window_size, rep.serve.refit_rounds,
            _device_fit_core(rep.cfg, rep._fit_budget, rep.n_classes),
            n_datasets=T, n_seeds=1, use_fill=True, use_test_fill=use_test_fill,
            with_metrics=True, n_classes=rep.n_classes)
        bufs = dict(
            codes=torch.zeros((T, cap_max, d), dtype=torch.int32, device=dev),
            x=torch.zeros((T, cap_max, d), dtype=torch.float32, device=dev),
            oracle_y=torch.zeros((T, cap_max), dtype=torch.int32, device=dev),
            seed_masks=torch.zeros((T, cap_max), dtype=torch.bool, device=dev),
            fit_keys=torch.zeros((T, 2), dtype=torch.int64, device=dev),
            windows=torch.zeros(T, dtype=torch.int32, device=dev),
            test_x=torch.zeros((T, t_max, d), dtype=torch.float32, device=dev),
            test_y=torch.zeros((T, t_max), dtype=torch.int32, device=dev),
            edges=torch.zeros((T,) + tuple(rep._edges.shape), dtype=torch.float32, device=dev),
        )
        chunk = body
        if dev.type == "cuda":
            chunk = GraphedChunk(body, input_args=(10, 11, 13, 14))
            if precompile:
                zi = torch.zeros(T, dtype=torch.int32, device=dev)
                grid = SweepState(labeled_mask=torch.ones((T, cap_max), dtype=torch.bool,
                                                          device=dev),
                                  key=torch.zeros((T, 2), dtype=torch.int64, device=dev),
                                  round=zi.clone())
                stream, warm_up = self._capture_stream(("batched", sig, T))
                chunk.capture(*self._batched_args(bufs, grid, zi, zi, zi, zi), stream=stream,
                              warm_up=warm_up)
        tracker = _ProgramTracker(self.metrics, f"serve_chunk_multi@{T}x{cap_max}", chunk)
        with self._lock:
            return self._batched_chunks.setdefault(key, _BatchedChunk(chunk, tracker, bufs,
                                                                      cap_max))

    @staticmethod
    def _batched_args(bufs: dict, grid, end_rounds, label_caps, n_valids, test_ns) -> tuple:
        return (bufs["codes"], bufs["x"], bufs["oracle_y"], grid, bufs["seed_masks"], (None,),
                bufs["fit_keys"], bufs["windows"], bufs["test_x"], bufs["test_y"], end_rounds,
                label_caps, bufs["edges"], n_valids, test_ns)

    def _dispatch_batched_refit(self, sig: tuple,
                                candidates: List[Tuple[Tenant, str]]) -> None:
        from distributed_active_learning_tpu_torch.runtime.pipeline import start_host_copy
        from distributed_active_learning_tpu_torch.runtime.sweep import SweepState

        members = self._group_members(sig)
        want = {t.tenant_id: reason for t, reason in candidates}
        cap_max = max(t._slab.capacity for t in members)
        entry = self._batched_chunk_for(sig, members, cap_max)
        K = members[0].serve.refit_rounds
        dev, bufs = self.device, entry.bufs
        caps = [t._slab.capacity for t in members]
        masks = torch.ones((len(members), cap_max), dtype=torch.bool, device=dev)
        for i, (t, c) in enumerate(zip(members, caps)):
            # Rows past a tenant's own capacity are labeled sentinels (the
            # grid convention: never selectable; the watermark keeps them
            # out of every count).
            for name in ("codes", "x", "oracle_y"):
                bufs[name][i].zero_()
                bufs[name][i, :c].copy_(getattr(t._slab, name))
            masks[i, :c].copy_(t._slab.labeled_mask)
            bufs["seed_masks"][i].zero_()
            if t._aux.seed_mask is not None:
                bufs["seed_masks"][i, :c].copy_(t._aux.seed_mask)
            bufs["fit_keys"][i].copy_(t._fit_key)
            n_test = int(t._test_x.shape[0])
            bufs["test_x"][i].zero_()
            bufs["test_y"][i].zero_()
            bufs["test_x"][i, :n_test].copy_(t._test_x)
            bufs["test_y"][i, :n_test].copy_(t._test_y)
            bufs["edges"][i].copy_(t._edges)
        bufs["windows"].copy_(_upload([t.cfg.strategy.window_size for t in members],
                                      torch.int32, dev))
        grid = SweepState(labeled_mask=masks, key=torch.stack([t._key for t in members]),
                          round=torch.stack([t._round.to(torch.int32) for t in members]))
        # Non-candidates no-op from step one: end_round == their round.
        end_rounds = _upload([t._round_host + (K if t.tenant_id in want else 0)
                              for t in members], torch.int32, dev)
        label_caps = _upload(caps, torch.int32, dev)
        n_valids = torch.stack([t._slab.n_filled.to(torch.int32) for t in members])
        test_ns = _upload([int(t._test_x.shape[0]) for t in members], torch.int32, dev)
        args = self._batched_args(bufs, grid, end_rounds, label_caps, n_valids, test_ns)
        t0 = time.perf_counter()
        if getattr(entry.chunk, "captures", None) == 0:
            self._capture_on_worker(entry.chunk, args, ("batched", sig, len(members)))
        out_grid, extras, ys = entry.chunk(*args)
        copy = start_host_copy(((out_grid.labeled_mask, out_grid.key, out_grid.round),
                                extras, ys))
        participants = {t.tenant_id: (i, want[t.tenant_id]) for i, t in enumerate(members)
                        if t.tenant_id in want}
        entry.inflight += 1
        br = _BatchedRefit(self, members, participants, caps, copy, t0, entry)
        self.batched_refit_launches += 1
        for t, reason in candidates:
            t._inflight = br
            t._record_refit_dispatch(reason)

    def _release_batched(self) -> None:
        """Drop tenant-axis chunks (and their graphs) of a capacity below
        their group's current largest one, once no launch of theirs runs."""
        with self._lock:
            for key, entry in list(self._batched_chunks.items()):  # audit: ok[DAL104] (a snapshot)
                if entry.inflight:
                    continue
                members = self._group_members(key[0])
                if members and entry.cap_max < max(t._slab.capacity for t in members):
                    self._retired_group_recompiles += entry.tracker.recompiles
                    del self._batched_chunks[key]

    # -- lifecycle / shared ops ----------------------------------------------

    def poll(self, force: bool = False) -> None:
        """Non-blocking touchdown check for every in-flight re-fit
        (``force=True`` blocks); a batched launch is polled once per call."""
        seen: set = set()
        for t in self._tenants.values():
            inflight = t._inflight
            if isinstance(inflight, _BatchedRefit):
                if id(inflight) in seen:
                    continue
                seen.add(id(inflight))
            t._poll_refit(force=force)

    def flush(self) -> None:
        for t in self._tenants.values():
            t.flush()

    def save_checkpoints(self) -> Dict[str, Optional[str]]:
        """Persist every tenant's serve checkpoint (tenant-axis names)."""
        return {tid: t.save_checkpoint() for tid, t in self._tenants.items()}

    def mark_warmup_complete(self) -> None:
        """Zero the per-tenant latency-cause tables: every cause counted
        after this call is a post-warmup event (a cause still pending, such
        as a warmup growth's that found no precompiled set, is the next
        query's, as in the JAX package). From here on a program set built,
        or a graph captured, on the request path counts toward
        ``recompiles_after_warmup``."""
        for t in self._tenants.values():
            t.cause_counts.clear()
        self._warm = True

    def _note_request_path_build(self) -> None:
        if self._warm:
            self.request_path_builds_after_warmup += 1

    def _note_request_path_capture(self) -> None:
        if self._warm:
            self.request_path_captures_after_warmup += 1

    def recompiles_after_warmup(self) -> int:
        """Graph recaptures of every program, plus the graphs captured on the
        request path after :meth:`mark_warmup_complete`."""
        total = self._retired_group_recompiles + self.request_path_captures_after_warmup
        for g in (self._score_groups or {}).values():
            total += g.tracker.recompiles
        for entry in list(self._batched_chunks.values()):
            total += entry.tracker.recompiles
        for t in self._tenants.values():
            total += t.recompiles_after_warmup()
        return total

    def post_warmup_growth_compile_events(self) -> int:
        """``serve_latency`` events tagged ``slab_growth_compile`` since
        :meth:`mark_warmup_complete` (growths that found no precompiled
        set)."""
        return sum(t.cause_counts.get("slab_growth_compile", 0) for t in self._tenants.values())

    def live_graphs(self) -> Dict[str, int]:
        """Chunk graphs each tenant holds (``Tenant.live_graphs``), and the
        tenant-axis chunks' under ``"_batched"``."""
        out = {tid: t.live_graphs() for tid, t in self._tenants.items()}
        with self._lock:
            out["_batched"] = sum(1 for e in self._batched_chunks.values()
                                  if getattr(e.chunk, "captures", 0))
        return out

    def slo_summary(self) -> Optional[Dict]:
        with_slo = [t for t in self._tenants.values() if t.slo is not None]
        if not with_slo:
            return None
        good = sum(t.slo.good for t in with_slo)
        total = sum(t.slo.total for t in with_slo)
        return {
            "good": good,
            "total": total,
            "compliance": round(good / total, 6) if total else None,
            "per_tenant": {t.tenant_id: t.slo.snapshot() for t in with_slo},
        }

    def summary(self) -> Dict:
        per_tenant = {tid: t.summary() for tid, t in self._tenants.items()}
        agg = {
            k: sum(s[k] for s in per_tenant.values())
            for k in ("queries", "scored_points", "ingest_blocks", "ingested_points", "refits",
                      "refit_rounds", "slab_growths", "growths_precompiled")
        }
        slo = self.slo_summary()
        if slo is not None:
            agg["slo"] = slo
        return {
            "tenants": len(self._tenants),
            **agg,
            "batched_score_launches": self.batched_score_launches,
            "batched_refit_launches": self.batched_refit_launches,
            "score_fallback_reasons": dict(self.score_fallback_reasons),
            "score_groups": self.score_groups(),
            "precompiles": self.precompiles,
            "precompile_errors": self.precompile_errors,
            "post_warmup_growth_compile_events": self.post_warmup_growth_compile_events(),
            "recompiles_after_warmup": self.recompiles_after_warmup(),
            "per_tenant": per_tenant,
        }

    # -- the precompile worker -------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._stop.clear()
                self._worker = threading.Thread(target=self._worker_loop,
                                                name="serve-precompile", daemon=True)
                self._worker.start()

    def schedule_precompile(self, tenant: Tenant, capacity: int) -> bool:
        """Queue the build (and on CUDA the capture) of ``tenant``'s
        ``capacity`` set, and of the tenant-axis chunk at the group's
        resulting largest capacity. Dedups against pending jobs and resident
        sets; returns whether anything was queued."""
        queued = False
        with tenant._programs_lock:
            have = capacity in tenant._programs
        key = ("capacity", tenant.tenant_id, capacity)
        with self._lock:
            if not have and key not in self._pending:
                job = _PrecompileJob("capacity", tenant, capacity)
                self._pending[key] = job
                self._put(0, job)
                queued = True
        if tenant._batchable_refit_reason() is None:
            sig = tenant._chunk_signature()
            members = self._group_members(sig)
            if len(members) >= 2:
                cap_max = max([capacity] + [t._slab.capacity for t in members])
                ck = self._batched_key(sig, members, cap_max)
                with self._lock:
                    if ck not in self._batched_chunks and ("batched", ck) not in self._pending:
                        job = _PrecompileJob("batched_chunk", tenant, cap_max, group_key=ck)
                        self._pending[("batched", ck)] = job
                        self._put(1, job)
                        queued = True
        if queued:
            self._ensure_worker()
        return queued

    def wait_precompile(self, tenant: Tenant, capacity: int,
                        timeout: Optional[float] = None) -> bool:
        """Block until a pending precompile of ``tenant``'s ``capacity``
        lands (True); False when none is pending."""
        with self._lock:
            job = self._pending.get(("capacity", tenant.tenant_id, capacity))
        if job is None:
            return False
        return self._wait_job(job, None if timeout is None else time.monotonic() + timeout)

    def _wait_job(self, job: _PrecompileJob, deadline: Optional[float]) -> bool:
        """Wait for ``job`` until ``deadline``; False at the deadline or when
        the worker is gone (a job it never took would wait forever)."""
        while not job.done.wait(0.2):
            worker = self._worker
            if worker is None or not worker.is_alive():
                return False
            if deadline is not None and time.monotonic() >= deadline:
                return False
        return job.ok

    def wait_precompiles(self, timeout: Optional[float] = None) -> bool:
        """Test and bench barrier: wait for every queued precompile."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                jobs = list(self._pending.values())
            if not jobs:
                return True
            for job in jobs:
                self._wait_job(job, deadline)
                if not job.done.is_set():
                    return False

    def _put(self, priority: int, job: Optional[_PrecompileJob]) -> None:
        with self._lock:
            self._order += 1
            self._queue.put((priority, self._order, job))

    def _capture_on_worker(self, chunk, args: tuple, body_key: tuple) -> None:
        """Capture ``chunk``'s graph on ``args`` on the request path: by the
        worker, on its capture stream (so that one thread captures, on one
        stream; the dispatcher waits), or here on a stream of its own when
        the worker is gone. After :meth:`mark_warmup_complete` it counts
        toward ``recompiles_after_warmup``."""
        self._note_request_path_capture()
        job = _PrecompileJob("capture", None, 0, group_key=body_key,
                             fn=lambda stream, warm_up: chunk.capture(*args, stream=stream,
                                                                      warm_up=warm_up))
        self._ensure_worker()
        self._put(-1, job)
        self._wait_job(job, None)
        if job.error is not None:
            raise job.error
        if not job.done.is_set():
            chunk.capture(*args)

    def _capture_stream(self, body_key: tuple):
        """The worker's capture stream, and whether a capture of the body
        ``body_key`` names must warm up first (its first capture on that
        stream only)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        warm_up = body_key not in self._warmed
        self._warmed.add(body_key)
        return self._stream, warm_up

    def _worker_loop(self) -> None:
        if self._device_index is not None:
            torch.cuda.set_device(self._device_index)
        while True:
            _priority, _order, job = self._queue.get()
            if job is None or self._stop.is_set():
                with self._lock:
                    pending = list(self._pending.values())
                    self._pending.clear()
                for p in pending:
                    p.done.set()
                if job is not None:
                    job.done.set()
                return
            if job.kind == "capture":
                try:
                    job.fn(*self._capture_stream(job.group_key))
                    job.ok = True
                except Exception as e:  # noqa: BLE001 — the dispatcher re-raises it
                    job.error = e
                finally:
                    job.done.set()
                    self._queue.task_done()
                continue
            t0 = time.perf_counter()
            try:
                if job.kind == "capacity":
                    progs = job.tenant._build_programs(job.capacity, precompile=True)
                    job.ok = job.tenant._install_programs(job.capacity, progs)
                else:
                    sig, T, cap_max, _t_max, _use_tf = job.group_key
                    members = self._group_members(sig)
                    if len(members) == T:
                        self._batched_chunk_for(sig, members, cap_max, precompile=True)
                        job.ok = True
                self.precompiles += 1
                obs.counter("precompiles", "background capacity precompiles").inc()
                seconds = round(time.perf_counter() - t0, 3)
                telemetry.flight_record("precompile", target=job.kind,
                                        tenant=job.tenant.tenant_id, capacity=job.capacity,
                                        seconds=seconds, installed=job.ok)
                if self.metrics is not None:
                    self.metrics.event("precompile", target=job.kind,
                                       tenant=job.tenant.tenant_id, capacity=job.capacity,
                                       seconds=seconds, installed=job.ok)
            except Exception as e:  # noqa: BLE001 — a failed build must not kill the
                # worker: the request path still builds; the failure is a named,
                # lost optimization.
                self.precompile_errors += 1
                obs.counter("precompile_errors", "failed background precompiles").inc()
                telemetry.flight_record("precompile_error", target=job.kind,
                                        tenant=job.tenant.tenant_id, capacity=job.capacity,
                                        error=repr(e)[:200])
                if self.metrics is not None:
                    self.metrics.event("precompile_error", target=job.kind,
                                       tenant=job.tenant.tenant_id, capacity=job.capacity,
                                       error=repr(e)[:200])
            finally:
                with self._lock:
                    for k, v in list(self._pending.items()):  # audit: ok[DAL104] (a snapshot)
                        if v is job:
                            del self._pending[k]
                job.done.set()
                self._queue.task_done()

    def close(self) -> None:
        """Stop the precompile worker (idempotent; atexit calls it): a
        capture in progress finishes first (bounded wait)."""
        with self._lock:
            worker = self._worker
            self._worker = None
        self._stop.set()
        if worker is not None and worker.is_alive():
            self._put(-2, None)
            worker.join(timeout=30)
