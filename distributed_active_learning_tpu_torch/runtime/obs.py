"""Live ops plane: in-process metrics registry + pull-based HTTP exporter
(the port of ``runtime/obs.py``, a stdlib-only copy: the same classes, the
same ``dal_`` series names and the same text, so a scraper that reads the
JAX package's series reads the port's).

Two layers, neither of which imports torch or touches the device (the
exporter must answer from any thread, also while the device is busy):

1. **Registry**: named :class:`Counter` / :class:`Gauge` /
   :class:`Histogram` families with Prometheus-style labels
   (``registry().counter("launches", program="chunk_scan").inc()``).
   Histograms use FIXED log-scale buckets (:data:`LATENCY_BUCKETS`, 5 per
   decade from 10us to 100s): bounded memory per series, counts merge
   exactly across threads and shards (integer adds), and p50/p99 come from
   the bucket counts, never from stored samples. Everything renders two
   ways: :meth:`Registry.render_prometheus` (the ``/metrics`` text format)
   and :meth:`Registry.snapshot` (the ``/varz`` JSON). Heartbeats
   (:meth:`Registry.heartbeat`) are timestamps with an optional staleness
   bound: the ``/healthz`` liveness source.

2. **Ops endpoint**: :class:`OpsServer`, a ``ThreadingHTTPServer`` bound to
   localhost (``run.py --ops-port``, off by default):

   - ``/metrics``  Prometheus text format;
   - ``/healthz``  liveness + last-touchdown age (200/503);
   - ``/varz``     the full registry snapshot as JSON;
   - ``/flightz``  trigger + return a flight-recorder dump (lazy import of
     the port's ``runtime.telemetry``; 404 when no recorder is installed).

The registry is fed by ``runtime.telemetry.LaunchTracker`` (launches,
recompiles, vetoes) and ``runtime.pipeline.run_pipelined`` (in-flight depth,
touchdown heartbeat, touchdown-hidden fraction, chunk count). Recording is
host-side dict/int work only: the disabled-by-default ops *endpoint* gates
the HTTP listener, never the (cheap, bounded) counting.
"""

from __future__ import annotations

import bisect
import collections
import json
import math
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "OpsServer",
    "registry",
    "counter",
    "gauge",
    "histogram",
    "heartbeat",
    "SLOTracker",
]

#: Metric-name prefix on every exported series — one namespace to scrape-
#: filter on (``dal`` = distributed active learning).
PROM_PREFIX = "dal_"

#: Fixed log-scale latency bucket upper bounds (seconds): 5 per decade from
#: 10 microseconds to 100 seconds (36 edges; one-bucket width = a factor of
#: 10^(1/5) ~= 1.58x). Fixed — never adapted to the data — so two histograms
#: of the same family ALWAYS merge exactly, across threads, tenants, and
#: processes; the MLPerf-logging/Prometheus discipline.
LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 5.0), 12) for e in range(-25, 11)
)

_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(
            f"metric name {name!r} must match [a-zA-Z_][a-zA-Z0-9_]* "
            "(it becomes a Prometheus series name)"
        )
    return name


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r"\"")
    )


def _fmt_value(v: float) -> str:
    """Prometheus sample values: integers render bare, floats via repr."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


class Counter:
    """Monotonic counter. ``inc`` only — a counter that goes down is a gauge."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self.value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n

    def dec(self, n=1) -> None:
        with self._lock:
            self.value -= n


class Histogram:
    """Fixed-bucket histogram: bounded memory, exactly mergeable, percentiles
    from bucket counts.

    ``edges`` are ascending upper bounds; counts hold ``len(edges) + 1``
    integer cells (cell i covers ``(edges[i-1], edges[i]]``, the last cell is
    the ``+Inf`` overflow). ``observe`` is a bisect + two adds — cheap enough
    for a per-query hot path. Merging two histograms of identical edges adds
    their integer counts, which is why shard-merged percentiles are
    bit-identical to single-shard ingestion (pinned in the JAX package's tests/test_obs.py).
    """

    __slots__ = ("edges", "counts", "sum", "_lock")

    def __init__(self, edges: Tuple[float, ...] = LATENCY_BUCKETS):
        edges = tuple(float(e) for e in edges)
        if len(edges) < 2 or any(b <= a for a, b in zip(edges, edges[1:])):
            # >= 2 edges: the first bucket's interpolation width is inferred
            # from the edge RATIO, which a single edge cannot supply
            raise ValueError("histogram edges must be >= 2 and ascending")
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v

    @property
    def count(self) -> int:
        return sum(self.counts)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s counts into this histogram (identical edges
        required — fixed buckets exist so this can never be a re-binning)."""
        if other.edges != self.edges:
            raise ValueError("cannot merge histograms with different edges")
        with self._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.sum += other.sum
        return self

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-derived percentile (``q`` in [0, 1]): find the bucket the
        rank falls in, interpolate geometrically inside it (linear in log
        space — the buckets are log-spaced). The estimate is within one
        bucket width (a factor of ``edges[i+1]/edges[i]``) of the exact
        sample percentile by construction; None on an empty histogram."""
        with self._lock:
            counts = list(self.counts)
        return self._percentile_from(counts, q)

    def _percentile_from(self, counts: List[int], q: float) -> Optional[float]:
        """Percentile over an already-copied counts list — so a snapshot's
        derived percentiles describe the SAME observation set as its
        count/sum fields, not whatever concurrent observes added since."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"percentile q must be in [0, 1], got {q}")
        total = sum(counts)
        if total == 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c > 0:
                if i == len(self.edges):
                    # overflow bucket: no upper bound to interpolate toward
                    return self.edges[-1]
                hi = self.edges[i]
                if i == 0:
                    lo = hi / (self.edges[1] / self.edges[0])
                else:
                    lo = self.edges[i - 1]
                frac = (rank - (cum - c)) / c
                frac = min(max(frac, 0.0), 1.0)
                if lo <= 0.0:
                    return hi * frac
                return lo * (hi / lo) ** frac
        return self.edges[-1]

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self.counts)
            total_sum = self.sum
        total = sum(counts)
        out = {"count": total, "sum": round(total_sum, 9), "counts": counts}
        if total:
            out["p50"] = self._percentile_from(counts, 0.50)
            out["p90"] = self._percentile_from(counts, 0.90)
            out["p99"] = self._percentile_from(counts, 0.99)
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric family: kind + labeled children."""

    __slots__ = ("name", "kind", "help", "children", "buckets")

    def __init__(self, name, kind, help_text, buckets=None):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.buckets = buckets
        self.children: Dict[Tuple[Tuple[str, str], ...], object] = {}


class Registry:
    """Thread-safe registry of metric families, heartbeats, and health.

    ``counter``/``gauge``/``histogram`` are get-or-create: the first call
    fixes the family's kind (a name re-used across kinds is refused loudly),
    later calls with the same labels return the SAME child, so callers may
    cache children on hot paths or just re-look-them-up on cold ones.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        # name -> (wall_ts, monotonic_ts, max_age_seconds)
        self._heartbeats: Dict[str, Tuple[float, float, Optional[float]]] = {}
        self._created = time.time()
        self._created_mono = time.monotonic()

    # -- metric creation -----------------------------------------------------

    def _child(self, kind: str, name: str, help_text: str, labels: dict,
               buckets=None):
        _check_name(name)
        for k in labels:
            _check_name(k)
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_text, buckets)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} is a {fam.kind}, not a {kind}"
                )
            child = fam.children.get(key)
            if child is None:
                if kind == "histogram":
                    child = Histogram(fam.buckets or LATENCY_BUCKETS)
                else:
                    child = _KINDS[kind]()
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child("gauge", name, help, labels)

    def histogram(
        self, name: str, help: str = "", buckets=None, **labels
    ) -> Histogram:
        return self._child("histogram", name, help, labels, buckets=buckets)

    # -- heartbeats / health -------------------------------------------------

    def heartbeat(self, name: str, max_age_seconds: Optional[float] = None) -> None:
        """Mark ``name`` alive now. A heartbeat with ``max_age_seconds`` set
        participates in the ``/healthz`` verdict: staler than its bound =>
        the whole process reports unhealthy (503)."""
        _check_name(name)
        with self._lock:
            if max_age_seconds is None and name in self._heartbeats:
                max_age_seconds = self._heartbeats[name][2]
            self._heartbeats[name] = (
                time.time(), time.monotonic(), max_age_seconds
            )

    def clear_heartbeat(self, name: str) -> None:
        """Forget a heartbeat (a cleanly-stopped loop must not read as a
        liveness failure forever after)."""
        with self._lock:
            self._heartbeats.pop(name, None)

    def health(self) -> dict:
        """The ``/healthz`` document: per-heartbeat ages, the minimum
        touchdown age (how long since ANY event loop last completed a unit
        of work), and the overall verdict."""
        now_mono = time.monotonic()
        with self._lock:
            beats = dict(self._heartbeats)
        ok = True
        out_beats = {}
        touchdown_ages = []
        for name, (_wall, mono, max_age) in sorted(beats.items()):
            age = now_mono - mono
            fresh = max_age is None or age <= max_age
            ok = ok and fresh
            out_beats[name] = {
                "age_seconds": round(age, 3),
                "max_age_seconds": max_age,
                "fresh": fresh,
            }
            if name.endswith("touchdown"):
                touchdown_ages.append(age)
        return {
            "ok": ok,
            "uptime_seconds": round(now_mono - self._created_mono, 3),
            "last_touchdown_age_seconds": (
                round(min(touchdown_ages), 3) if touchdown_ages else None
            ),
            "heartbeats": out_beats,
        }

    # -- rendering -----------------------------------------------------------

    @staticmethod
    def _labels_text(key, extra: str = "") -> str:
        parts = [f'{k}="{_escape_label(v)}"' for k, v in key]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render_prometheus(self) -> str:
        """The ``/metrics`` payload (Prometheus text exposition format
        0.0.4). Counters gain the conventional ``_total`` suffix; histograms
        render cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``
        — exactly the shape promtool and every scraper expect."""
        lines: List[str] = []
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            prom = PROM_PREFIX + name
            if fam.kind == "counter" and not prom.endswith("_total"):
                prom += "_total"
            if fam.help:
                lines.append(f"# HELP {prom} {fam.help}")
            lines.append(f"# TYPE {prom} {fam.kind}")
            with self._lock:
                children = sorted(fam.children.items())
            for key, child in children:
                if fam.kind == "histogram":
                    with child._lock:
                        counts = list(child.counts)
                        h_sum = child.sum
                    cum = 0
                    for i, edge in enumerate(child.edges):
                        cum += counts[i]
                        le = self._labels_text(key, f'le="{_fmt_value(edge)}"')
                        lines.append(f"{prom}_bucket{le} {cum}")
                    cum += counts[-1]
                    le = self._labels_text(key, 'le="+Inf"')
                    lines.append(f"{prom}_bucket{le} {cum}")
                    lt = self._labels_text(key)
                    lines.append(f"{prom}_sum{lt} {_fmt_value(h_sum)}")
                    lines.append(f"{prom}_count{lt} {cum}")
                else:
                    lt = self._labels_text(key)
                    lines.append(f"{prom}{lt} {_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """The ``/varz`` document: every family/child as plain JSON values
        (histograms include their bucket counts and derived percentiles)."""
        out: Dict[str, dict] = {}
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            fam_out = {"kind": fam.kind, "series": []}
            with self._lock:
                children = sorted(fam.children.items())
            for key, child in children:
                entry: dict = {"labels": dict(key)}
                if fam.kind == "histogram":
                    entry.update(child.snapshot())
                else:
                    entry["value"] = child.value
                fam_out["series"].append(entry)
            out[name] = fam_out
        return {"metrics": out, "health": self.health()}


# ---------------------------------------------------------------------------
# The process-wide default registry (the flight-recorder discipline: library
# code feeds the module-level hooks unconditionally; they are cheap host-side
# dict/int work whether or not anything ever scrapes).
# ---------------------------------------------------------------------------

_DEFAULT = Registry()


def registry() -> Registry:
    return _DEFAULT


def counter(name: str, help: str = "", **labels) -> Counter:
    return _DEFAULT.counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return _DEFAULT.gauge(name, help, **labels)


def histogram(name: str, help: str = "", buckets=None, **labels) -> Histogram:
    return _DEFAULT.histogram(name, help, buckets=buckets, **labels)


def heartbeat(name: str, max_age_seconds: Optional[float] = None) -> None:
    _DEFAULT.heartbeat(name, max_age_seconds)


# ---------------------------------------------------------------------------
# SLO accounting
# ---------------------------------------------------------------------------

#: Burn-rate windows (seconds) and their display names — the SRE-workbook
#: short/medium/long alerting trio, bounded at one hour so the windowed
#: state stays a few hundred slots per tenant.
SLO_WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("1m", 60.0), ("5m", 300.0), ("1h", 3600.0),
)


class SLOTracker:
    """One tenant's latency/availability objective and its burn accounting.

    A query is GOOD when it succeeded AND answered within
    ``objective_seconds`` (the combined latency+availability SLI — a failed
    query can never be good, however fast it failed). Tracked two ways:

    - lifetime ``good/total`` -> :meth:`compliance` (the ratio the service
      summary and the bench's ``slo_compliance`` key report);
    - time-sloted window counts -> :meth:`burn_rate`: the window's bad
      fraction divided by the error budget ``1 - target``. Burn 1.0 means
      the budget is being spent exactly at the sustainable rate; >> 1 is the
      page. Slots are ``slot_seconds`` wide and pruned past the longest
      window, so memory is bounded regardless of query rate.
    """

    def __init__(
        self,
        objective_seconds: float,
        target: float = 0.99,
        windows: Tuple[Tuple[str, float], ...] = SLO_WINDOWS,
        slot_seconds: float = 5.0,
        clock=time.monotonic,
    ):
        if objective_seconds <= 0:
            raise ValueError(
                f"SLO objective must be > 0 seconds, got {objective_seconds}"
            )
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"SLO target must be a fraction in (0, 1), got {target} — "
                "1.0 leaves no error budget to burn"
            )
        self.objective_seconds = float(objective_seconds)
        self.target = float(target)
        self.windows = tuple(windows)
        self.slot_seconds = float(slot_seconds)
        self._clock = clock
        self._lock = threading.Lock()
        self.good = 0
        self.total = 0
        # (slot_index, good, total) triples, oldest first
        self._slots: collections.deque = collections.deque()
        self._horizon_slots = int(
            math.ceil(max(w for _, w in self.windows) / self.slot_seconds)
        ) + 1

    def observe(self, seconds: Optional[float], ok: bool = True) -> bool:
        """Record one query; returns whether it counted as good. ``seconds``
        None means the query never produced a latency (it failed before
        completing) — always bad."""
        good = bool(ok) and seconds is not None and seconds <= self.objective_seconds
        slot = int(self._clock() / self.slot_seconds)
        with self._lock:
            self.total += 1
            self.good += int(good)
            if self._slots and self._slots[-1][0] == slot:
                _s, g, t = self._slots[-1]
                self._slots[-1] = (slot, g + int(good), t + 1)
            else:
                self._slots.append((slot, int(good), 1))
            while self._slots and self._slots[0][0] < slot - self._horizon_slots:
                self._slots.popleft()
        return good

    def compliance(self) -> Optional[float]:
        with self._lock:
            return self.good / self.total if self.total else None

    def window_counts(self, window_seconds: float) -> Tuple[int, int]:
        now_slot = int(self._clock() / self.slot_seconds)
        first = now_slot - int(math.ceil(window_seconds / self.slot_seconds))
        g = t = 0
        with self._lock:
            for slot, sg, st in self._slots:
                if slot > first:
                    g += sg
                    t += st
        return g, t

    def burn_rate(self, window_seconds: float) -> Optional[float]:
        """``bad_fraction / (1 - target)`` over the window; None when the
        window holds no queries (no data is not the same as no burn)."""
        g, t = self.window_counts(window_seconds)
        if t == 0:
            return None
        return ((t - g) / t) / (1.0 - self.target)

    def burn_rates(self) -> Dict[str, Optional[float]]:
        return {name: self.burn_rate(w) for name, w in self.windows}

    def snapshot(self) -> dict:
        comp = self.compliance()
        return {
            "objective_ms": round(self.objective_seconds * 1e3, 3),
            "target": self.target,
            "good": self.good,
            "total": self.total,
            "compliance": round(comp, 6) if comp is not None else None,
            "burn": {
                name: (round(b, 4) if b is not None else None)
                for name, b in self.burn_rates().items()
            },
        }


class OpsServer:
    """``ThreadingHTTPServer`` serving the registry on localhost.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` — the
    bench's self-scrape route); ``start()`` spawns a daemon serve thread so
    a dying process never hangs on its own exporter. Every successful GET of
    a known endpoint increments ``dal_ops_scrapes_total`` — the bench's
    ``ops_scrapes`` key and the proof in its own ``/metrics`` output that
    something is actually watching.
    """

    def __init__(self, port: int = 0):
        self._want_port = int(port)
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def start(self) -> "OpsServer":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        if self._httpd is not None:
            return self
        reg = _DEFAULT

        class _Handler(BaseHTTPRequestHandler):
            server_version = "dal-ops/1"

            def log_message(self, *_args):  # quiet: stderr is the run's log
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server's naming
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        reg.counter("ops_scrapes").inc()
                        body = reg.render_prometheus().encode()
                        self._send(
                            200, body,
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/healthz":
                        health = reg.health()
                        reg.counter("ops_scrapes").inc()
                        self._send(
                            200 if health["ok"] else 503,
                            (json.dumps(health) + "\n").encode(),
                            "application/json",
                        )
                    elif path == "/varz":
                        reg.counter("ops_scrapes").inc()
                        self._send(
                            200,
                            (json.dumps(reg.snapshot()) + "\n").encode(),
                            "application/json",
                        )
                    elif path == "/flightz":
                        # the SIGUSR1 probe over HTTP: dump the installed
                        # flight recorder (writes its artifact when it has a
                        # path) and return the ring in the response
                        from distributed_active_learning_tpu_torch.runtime import (
                            telemetry,
                        )

                        rec = telemetry.flight_recorder()
                        if rec is None:
                            self._send(
                                404,
                                b'{"error": "no flight recorder installed"}\n',
                                "application/json",
                            )
                            return
                        try:
                            artifact = rec.dump("flightz")
                        except OSError:
                            artifact = None  # a probe must not kill the run
                        reg.counter("ops_scrapes").inc()
                        body = json.dumps({
                            "artifact": artifact,
                            "capacity": rec.capacity,
                            "dropped": rec.dropped,
                            "events": rec.snapshot(),
                        }) + "\n"
                        self._send(200, body.encode(), "application/json")
                    else:
                        self._send(
                            404,
                            b"not found; endpoints: /metrics /healthz /varz"
                            b" /flightz\n",
                            "text/plain",
                        )
                except BrokenPipeError:
                    pass  # scraper hung up mid-response; its problem

        httpd = ThreadingHTTPServer(("127.0.0.1", self._want_port), _Handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        self.port = int(httpd.server_address[1])
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="dal-ops-server",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "OpsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
