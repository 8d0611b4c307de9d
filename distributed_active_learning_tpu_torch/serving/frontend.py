"""Thread-safe front queue for the multi-tenant service: admission,
fairness, backpressure (the port of ``serving/frontend.py``, whose logic is
pure Python and is kept as it is; the device work it dispatches is the
port's).

The service's event loop is single-threaded BY DESIGN — one caller interleaving
score/submit on one thread. Production clients are concurrent, so something
must make them actually contend: this module is that something, and it keeps
the one-device-thread discipline the whole serving stack assumes by funneling
every device-touching operation through ONE dispatcher thread.

- **Clients enqueue, the dispatcher executes.** ``submit_score`` /
  ``submit_ingest`` append to a per-tenant FIFO and return a
  ``concurrent.futures.Future``; blocking (``score``) and asyncio
  (``ascore``) wrappers ride the same futures. Request payloads never touch
  the device on the client thread.

- **Admission control.** A tenant whose queue already holds ``max_pending``
  requests (ServeConfig.max_pending) has new submissions refused with
  :class:`AdmissionError` — bounded memory, and the backpressure signal a
  client can act on.

- **Per-tenant fairness, weighted by SLO class.** Each dispatch cycle
  drains AT MOST one score request per tenant, rotating the starting tenant
  round-robin — a noisy tenant cannot occupy more than its slot in any
  fused launch while others wait. On top of the rotation, deficit weighted
  round-robin (``ServeConfig.slo_weight``): a tenant accrues ``weight``
  credits per contended cycle and a score slot costs 1, so weight 1.0 (the
  default) is served every cycle — exactly the pre-SLO fair rotation —
  while weight 0.5 is served every OTHER cycle its queue is nonempty. The
  collected slots coalesce into ONE cross-tenant batched launch
  (:meth:`~serving.tenants.TenantManager.score_many`).

- **Priority admission.** ``ServeConfig.slo_priority`` scales the admission
  cap: a priority-``p`` tenant tolerates ``max_pending * (1 + p)`` queued
  requests before :class:`AdmissionError`, so under global load the lower
  classes shed first and the gold class keeps enqueueing.

- **Burn-rate-driven admission.** The first consumer that ACTS on the
  burn gauges: a tenant whose 5-minute SLO burn rate
  (:meth:`~runtime.obs.SLOTracker.burn_rate`) reaches 1.0 has its effective
  WRR weight scaled by ``1 / (1 + burn)`` (dispatch deprioritization,
  always on), and once the burn crosses ``ServeConfig.burn_shed_threshold``
  (> 0 to enable) new SCORE submissions are refused with
  :class:`AdmissionError` before they queue — the SLO is already lost for
  the window, so shedding early keeps healthy tenants from waiting behind a
  doomed queue. Ingest is never burn-shed: fresh data is how a burning
  tenant recovers.

- **Re-fit backpressure.** While a tenant's re-fit chunk is in flight its
  INGEST requests are held (the slab's mask is the running chunk's
  carry; piling more device writes behind a
  long chunk just hides queueing in the device stream) — held requests stay
  queued, the queue fills, and admission pushes back on the producer.
  Scoring is deliberately NOT held: the resident forest stays hot through a
  re-fit (that asymmetry is the service's core latency guarantee), so score
  requests may overtake held ingests of the same tenant.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Deque, Dict, Optional

import numpy as np

from distributed_active_learning_tpu_torch.runtime import obs, telemetry
from distributed_active_learning_tpu_torch.serving.tenants import TenantManager

#: /healthz staleness bound for the dispatcher-loop heartbeat: the loop
#: beats at least every 0.1s when idle, but a fused launch (or a first-time
#: graph capture a cold tenant sneaks onto the dispatch path) can hold it for
#: seconds — the bound must catch a DEAD loop, not a busy one.
_LOOP_HEARTBEAT_MAX_AGE = 60.0


class AdmissionError(RuntimeError):
    """A tenant's front queue is full — the caller-visible backpressure
    signal (retry later, shed load, or slow the producer)."""


@dataclasses.dataclass
class _Request:
    kind: str            # "score" | "ingest"
    tenant: str
    x: np.ndarray
    y: Optional[np.ndarray]
    future: Future
    enqueued: float


class ServiceFrontend:
    """The concurrent front of a :class:`~serving.tenants.TenantManager`.

    Use as a context manager (or ``start()``/``stop()``); clients then call
    ``score``/``submit_score``/``submit_ingest``/``ascore`` from any thread
    or event loop. One dispatcher thread owns all device work.
    """

    def __init__(
        self,
        manager: TenantManager,
        max_pending: Optional[int] = None,
        idle_poll_seconds: float = 0.002,
    ):
        self.manager = manager
        self._max_pending = max_pending
        self._idle_poll = idle_poll_seconds
        self._queues: Dict[str, Deque[_Request]] = {}
        self._cond = threading.Condition()
        self._rr = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.dispatch_cycles = 0
        self.fused_launch_cycles = 0
        self.held_ingest_cycles = 0
        self.rejected: Dict[str, int] = {}
        # SLO accounting (deficit weighted round-robin; see _credit_ok):
        # score slots granted / deferred per tenant, and the running credit.
        self._credits: Dict[str, float] = {}
        self.slo_served: Dict[str, int] = {}
        self.slo_deferred: Dict[str, int] = {}
        # Burn-rate-driven admission/dispatch (the first consumer that ACTS
        # on the burn gauges): score submissions shed at admission
        # while the 5m burn says the SLO is already lost, and dispatch
        # cycles where the deficit WRR deprioritized a burning tenant.
        self.burn_shed: Dict[str, int] = {}
        self.burn_deprioritized: Dict[str, int] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServiceFrontend":
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="serve-frontend", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = 30.0) -> None:
        """Stop the dispatcher; ``drain=True`` first serves everything still
        queued (a held ingest drains once its tenant's re-fit touches down)."""
        if drain:
            deadline = None if timeout is None else time.monotonic() + timeout
            while self.pending() and (
                deadline is None or time.monotonic() < deadline
            ):
                time.sleep(self._idle_poll)
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # A cleanly-stopped dispatcher must not read as a liveness failure
        # on a scrape that arrives after shutdown.
        obs.registry().clear_heartbeat("frontend_loop")

    def __enter__(self) -> "ServiceFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client surface ------------------------------------------------------

    def _cap_for(self, tenant: str) -> int:
        serve = self.manager.tenant(tenant).serve
        base = (
            self._max_pending
            if self._max_pending is not None
            else serve.max_pending
        )
        # Priority admission: higher SLO classes tolerate deeper queues, so
        # under shared load the lower classes hit AdmissionError first.
        prio = max(int(getattr(serve, "slo_priority", 0)), 0)
        return base * (1 + prio)

    def _burn5(self, tenant: str) -> Optional[float]:
        """The tenant's 5-minute SLO burn rate, or None when the tracker has
        no observations in the window (a fresh or idle tenant is NOT
        burning)."""
        slo = getattr(self.manager.tenant(tenant), "slo", None)
        if slo is None:
            return None
        return slo.burn_rate(300.0)

    def _credit_ok(self, tenant: str) -> bool:
        """Deficit weighted round-robin: accrue ``slo_weight`` credits per
        contended cycle, spend 1 per score slot. Called at most once per
        tenant per dispatch cycle (and only when a score is actually
        queued), so the accrual rate IS the cycle rate. Weight >= 1 is
        always served (the pre-SLO behavior for the default 1.0); weight w
        in (0, 1) is served a w fraction of its contended cycles.

        Burn deprioritization: once the 5m burn rate reaches 1.0 (the error
        budget is being spent faster than sustainable), the tenant's
        effective weight is scaled by ``1 / (1 + burn)`` — a tenant burning
        at 2x accrues a third of its configured credits, so healthy tenants'
        slots stop queueing behind one that is already missing its SLO. The
        scale is continuous in the burn rate (no cliff at the threshold) and
        recovers automatically as good observations re-enter the window."""
        serve = self.manager.tenant(tenant).serve
        w = max(float(getattr(serve, "slo_weight", 1.0)), 0.0)
        burn = self._burn5(tenant)
        if burn is not None and burn >= 1.0:
            w = w / (1.0 + min(burn, 100.0))
            self.burn_deprioritized[tenant] = (
                self.burn_deprioritized.get(tenant, 0) + 1
            )
        c = min(self._credits.get(tenant, 0.0) + w, max(1.0, w))
        if c >= 1.0:
            self._credits[tenant] = c - 1.0
            self.slo_served[tenant] = self.slo_served.get(tenant, 0) + 1
            return True
        self._credits[tenant] = c
        self.slo_deferred[tenant] = self.slo_deferred.get(tenant, 0) + 1
        return False

    def _enqueue(self, req: _Request) -> Future:
        cap = self._cap_for(req.tenant)
        serve = self.manager.tenant(req.tenant).serve
        shed_at = float(getattr(serve, "burn_shed_threshold", 0.0))
        if req.kind == "score" and shed_at > 0.0:
            # Burn shedding: past the configured 5m burn rate the SLO is
            # already lost for this window — refusing new SCORE work early
            # keeps the doomed tenant's queue from delaying healthy ones.
            # Ingest is never shed: fresh data is how a burning tenant
            # recovers.
            burn = self._burn5(req.tenant)
            if burn is not None and burn >= shed_at:
                self.burn_shed[req.tenant] = (
                    self.burn_shed.get(req.tenant, 0) + 1
                )
                obs.counter(
                    "admission_burn_sheds",
                    "score submissions shed because the 5m SLO burn rate "
                    "crossed burn_shed_threshold",
                    tenant=req.tenant,
                ).inc()
                raise AdmissionError(
                    f"tenant {req.tenant!r} shed at admission: 5m burn rate "
                    f"{burn:.2f} >= burn_shed_threshold {shed_at:.2f}; the "
                    f"SLO budget is exhausted — retry after the window cools"
                )
        with self._cond:
            if not self._running:
                raise RuntimeError("frontend is not running (call start())")
            q = self._queues.setdefault(req.tenant, collections.deque())
            if len(q) >= cap:
                self.rejected[req.tenant] = self.rejected.get(req.tenant, 0) + 1
                obs.counter(
                    "admission_rejects", "requests refused by admission control",
                    tenant=req.tenant,
                ).inc()
                raise AdmissionError(
                    f"tenant {req.tenant!r} has {len(q)} pending requests "
                    f"(max_pending={cap}); backpressure — retry later"
                )
            q.append(req)
            obs.gauge(
                "frontend_queue_depth", "queued requests per tenant",
                tenant=req.tenant,
            ).set(len(q))
            self._cond.notify()
        return req.future

    def submit_score(self, tenant: str, queries) -> Future:
        """Enqueue a score request; the Future resolves to the scores array."""
        self.manager.tenant(tenant)  # KeyError now, not on the dispatcher
        q = np.asarray(queries, np.float32)
        return self._enqueue(
            _Request("score", tenant, q, None, Future(), time.perf_counter())
        )

    def submit_ingest(self, tenant: str, x, y) -> Future:
        """Enqueue an ingest block; the Future resolves to an ack dict."""
        self.manager.tenant(tenant)
        return self._enqueue(
            _Request(
                "ingest", tenant,
                np.asarray(x, np.float32), np.asarray(y, np.int32),
                Future(), time.perf_counter(),
            )
        )

    def score(self, tenant: str, queries, timeout: Optional[float] = None):
        """Blocking convenience wrapper: enqueue + wait."""
        return self.submit_score(tenant, queries).result(timeout)

    async def ascore(self, tenant: str, queries):
        """asyncio client surface over the same queue/futures."""
        return await asyncio.wrap_future(self.submit_score(tenant, queries))

    async def asubmit(self, tenant: str, x, y):
        return await asyncio.wrap_future(self.submit_ingest(tenant, x, y))

    def pending(self, tenant: Optional[str] = None) -> int:
        with self._cond:
            if tenant is not None:
                return len(self._queues.get(tenant, ()))
            return sum(len(q) for q in self._queues.values())

    # -- the dispatcher ------------------------------------------------------

    def _collect(self):
        """One fairness cycle under the lock: at most one score request per
        tenant (rotating start), ingest heads for tenants whose re-fit is
        NOT in flight. Returns (scores, ingests, held_any)."""
        scores: Dict[str, _Request] = {}
        ingests = []
        held = False
        tids = list(self._queues)
        n = len(tids)
        for k in range(n):
            tid = tids[(self._rr + k) % n]
            q = self._queues[tid]
            if not q:
                continue
            head = q[0]
            if head.kind == "ingest":
                if self.manager.tenant(tid).refit_inflight:
                    # backpressure: hold the ingest, but let a queued score
                    # overtake it — the resident forest stays hot
                    held = True
                    if any(r.kind == "score" for r in q) and self._credit_ok(tid):
                        for i, req in enumerate(q):
                            if req.kind == "score":
                                del q[i]
                                scores[tid] = req
                                break
                    continue
                ingests.append(q.popleft())
                # an ingest and a score from one tenant may share a cycle
                if q and q[0].kind == "score" and self._credit_ok(tid):
                    scores[tid] = q.popleft()
            elif self._credit_ok(tid):
                scores[tid] = q.popleft()
        for tid in tids:
            obs.gauge(
                "frontend_queue_depth", "queued requests per tenant",
                tenant=tid,
            ).set(len(self._queues[tid]))
        if n:
            self._rr = (self._rr + 1) % n
        return scores, ingests, held

    def _dispatch_loop(self) -> None:
        while True:
            # /healthz liveness: one beat per loop pass. The registered
            # staleness bound means a wedged dispatcher (deadlock, dead
            # thread) flips the health endpoint to 503 within a minute —
            # the "event-loop liveness" half of the ops plane.
            obs.heartbeat("frontend_loop", max_age_seconds=_LOOP_HEARTBEAT_MAX_AGE)
            with self._cond:
                while self._running and not any(self._queues.values()):
                    self._cond.wait(timeout=0.1)
                    obs.heartbeat("frontend_loop")
                if not self._running:
                    return
                scores, ingests, held = self._collect()
            self.dispatch_cycles += 1
            # A client may have cancelled a still-queued Future (asyncio
            # timeouts do); claiming it via set_running_or_notify_cancel
            # drops cancelled requests AND makes the set_result/set_exception
            # below safe — an unguarded InvalidStateError here would kill the
            # one thread serving everybody.
            ingests = [r for r in ingests if r.future.set_running_or_notify_cancel()]
            scores = {
                tid: r for tid, r in scores.items()
                if r.future.set_running_or_notify_cancel()
            }
            for req in ingests:
                try:
                    self.manager.submit(req.tenant, req.x, req.y)
                    req.future.set_result(
                        {"tenant": req.tenant, "points": int(req.x.shape[0])}
                    )
                except Exception as e:  # noqa: BLE001 — the error belongs to
                    # the submitting client, not the shared dispatcher
                    req.future.set_exception(e)
            if scores:
                self.fused_launch_cycles += 1
                try:
                    results = self.manager.score_many(
                        {tid: req.x for tid, req in scores.items()}
                    )
                    for tid, req in scores.items():
                        req.future.set_result(results[tid])
                except Exception as e:  # noqa: BLE001
                    # availability accounting happens INSIDE score_many
                    # (completion-aware: only tenants whose blocks did not
                    # finish are charged — see tenants.py); here the error
                    # just routes to the waiting callers
                    for req in scores.values():
                        if not req.future.done():
                            req.future.set_exception(e)
                    telemetry.flight_record(
                        "frontend_error", error=repr(e)[:200],
                        tenants=sorted(scores),
                    )
            if held:
                self.held_ingest_cycles += 1
            if not scores and not ingests:
                # everything queued is held behind in-flight re-fits: poll
                # for their touchdowns so held ingests eventually release
                self.manager.poll()
                time.sleep(self._idle_poll)
