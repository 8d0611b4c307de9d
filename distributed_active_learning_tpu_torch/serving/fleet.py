"""Shared-nothing serve fleet: N worker processes behind a consistent-hash
router (the port of the JAX package's ``serving/fleet.py``; the process
axis of the serve scale-out, on top of the signature-group axis inside each
worker's :class:`~serving.tenants.TenantManager`).

Topology: one host, N + 1 processes, no shared state.

- **Workers** (:func:`_worker_main`, spawned): each is a whole serving
  stack on its ``device`` (default the card): its own ``TenantManager``
  (grouped scores over each tenant's graphed endpoint), its own
  :class:`~serving.frontend.ServiceFrontend` (one dispatcher thread owning
  that process's device work), its own ops plane (``/metrics`` and
  ``/healthz`` through :class:`~runtime.obs.OpsServer`) and a small HTTP
  score endpoint. A worker owns its tenants outright: slabs, forests and
  captured graphs never cross a process boundary. On one card each worker
  holds its own CUDA context and caching allocator.
- **Router** (:class:`RouterServer`, its own process under :class:`Fleet`):
  consistent hashing on the tenant id (:class:`HashRing`: SHA-1, virtual
  nodes) picks the owning worker; forwarding is gated by the worker's own
  ``/healthz`` (a probe cached for a TTL) and walks the ring past unhealthy
  workers (``nodes_for`` order). Its ``/metrics`` is every worker's registry
  with a ``worker="wN"`` label on each series plus the router's own
  counters, and its ``/healthz`` is up while ANY worker is. The router
  never touches the device: nothing on its path calls ``torch.cuda``.
- **Placement is routing.** :class:`Fleet` assigns tenants to workers with
  the ring the router routes by, so the first hop is the owner.

The multiprocessing context is always ``spawn``: a worker makes its own
CUDA context, which a forked child of a process that has one cannot.

The data plane is keep-alive HTTP/1.1 on both hops with two wire forms for
``POST /score``: JSON, and raw float32 (an ``<II>`` rows/features header,
the tenant in the query string, so the router relays the payload without
parsing it; the scores round-trip bit for bit).

Entry point: ``python -m distributed_active_learning_tpu_torch.bench --mode
serve-fleet`` (the 1 -> N worker scaling leg).
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import http.client
import json
import multiprocessing as mp
import os
import socket
import struct
import threading
import time
import traceback
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Tuple

import numpy as np

#: The router's budget for one forwarded score call; above a worker's worst
#: case.
_FORWARD_TIMEOUT = 120.0
#: Health probes are cheap but not free: one per worker per TTL window.
_HEALTH_TTL = 1.0
_HEALTH_TIMEOUT = 3.0


# ---------------------------------------------------------------------------
# Consistent hashing
# ---------------------------------------------------------------------------


class HashRing:
    """SHA-1 consistent-hash ring with virtual nodes.

    ``vnodes`` points per node smooth the arc lengths so small fleets still
    split keys roughly evenly; SHA-1 (not :func:`hash`) makes the mapping
    stable across processes and Python runs, and equal to the JAX package's
    ring byte for byte. Adding or removing a node moves only the keys on the
    arcs it owned (~1/N of them).
    """

    def __init__(self, nodes=(), vnodes: int = 64):
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []  # sorted (hash, node)
        self._nodes: List[str] = []
        for node in nodes:
            self.add(node)

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")

    @property
    def nodes(self) -> List[str]:
        return sorted(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.append(node)
        for v in range(self.vnodes):
            bisect.insort(self._points, (self._hash(f"{node}#{v}"), node))

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.remove(node)
        self._points = [(h, n) for h, n in self._points if n != node]

    def lookup(self, key: str) -> Optional[str]:
        """The node owning ``key``: the first ring point clockwise of its
        hash."""
        owners = self.nodes_for(key, n=1)
        return owners[0] if owners else None

    def nodes_for(self, key: str, n: Optional[int] = None) -> List[str]:
        """Distinct nodes in ring order from ``key``'s position: index 0 is
        the owner, the rest is the failover walk."""
        if not self._points:
            return []
        want = len(self._nodes) if n is None else min(int(n), len(self._nodes))
        start = bisect.bisect(self._points, (self._hash(key), ""))
        out: List[str] = []
        for i in range(len(self._points)):
            node = self._points[(start + i) % len(self._points)][1]
            if node not in out:
                out.append(node)
                if len(out) >= want:
                    break
        return out


# ---------------------------------------------------------------------------
# Tenant specs (the picklable worker boot payload)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Everything a worker needs to cold-start one tenant, as plain data:
    the spawn boundary carries these, never tensors or managers. The worker
    draws the tenant's pool and test data from (seed, shift), the serve
    benches' shifted-gaussian convention."""

    tenant_id: str
    features: int = 16
    pool_rows: int = 256
    shift: float = 0.0
    seed: int = 0
    n_trees: int = 6
    max_depth: int = 3
    kernel: str = "gemm"
    slab_rows: int = 256
    score_width: int = 32
    ingest_block: int = 32


def _spec_data(spec: TenantSpec):
    r = np.random.default_rng(spec.seed)
    x = r.normal(size=(spec.pool_rows, spec.features)).astype(np.float32)
    x += spec.shift
    y = (x[:, 0] + 0.3 * x[:, 1] > spec.shift).astype(np.int32)
    n_test = min(spec.pool_rows, 512)
    tx = r.normal(size=(n_test, spec.features)).astype(np.float32) + spec.shift
    ty = (tx[:, 0] + 0.3 * tx[:, 1] > spec.shift).astype(np.int32)
    return x, y, tx, ty


def spec_configs(spec: TenantSpec, index: int):
    """``(ExperimentConfig, ServeConfig)`` of the ``index``-th tenant on a
    worker, as :func:`_worker_main` adds it. Score-only traffic: drift can
    never fire and staleness never forces a re-fit, so the resident forest
    and its captured graphs are immutable after warmup."""
    from distributed_active_learning_tpu_torch.config import (
        ExperimentConfig,
        ForestConfig,
        ServeConfig,
        StrategyConfig,
    )

    serve = ServeConfig(
        slab_rows=spec.slab_rows, ingest_block=spec.ingest_block, score_width=spec.score_width,
        refit_rounds=2, drift_entropy_shift=99.0, max_staleness=0, precompile_ahead=False,
        max_pending=4096, slo_latency_ms=60_000.0, slo_target=0.9)
    cfg = ExperimentConfig(
        forest=ForestConfig(n_trees=spec.n_trees, max_depth=spec.max_depth, kernel=spec.kernel,
                            fit="device", fit_budget=spec.slab_rows),
        strategy=StrategyConfig(name="uncertainty", window_size=16),
        n_start=max(spec.pool_rows // 8, 4), log_every=0, seed=spec.seed + index)
    return cfg, serve


def build_manager(specs: List[TenantSpec], device=None):
    """A worker's ``TenantManager`` over ``specs`` on ``device``, warmed up
    (one ``score_many`` over every tenant: the endpoints' graphs are
    captured here) and marked warm: what each fleet worker serves from."""
    from distributed_active_learning_tpu_torch.serving.tenants import TenantManager

    manager = TenantManager(device=device)
    try:
        for i, spec in enumerate(specs):
            manager.add_tenant(spec.tenant_id, *spec_configs(spec, i), *_spec_data(spec))
        warm = {spec.tenant_id: _spec_data(spec)[2][: spec.score_width] for spec in specs}
        if warm:
            manager.score_many(warm)
        manager.mark_warmup_complete()
    except BaseException:
        manager.close()
        raise
    return manager


# Each CUDA kernel's launch counter in the port: (module, attribute), by the
# kernel's name (its csrc/<name>.cu).
_KERNEL_COUNTERS = {
    "forest_leaves": ("ops.trees_pallas", "launches"),
    "round_megakernel": ("ops.round_fused", "launches"),
    "fused_votes": ("ops.round_fused", "votes_launches"),
    "ring_hop": ("ops.ring_topk", "launches"),
    "forest_leaves_transposed": ("benches.pallas_variants", "transposed_launches"),
    "forest_leaves_segmented": ("benches.pallas_variants", "segmented_launches"),
    "threefry": ("ops.threefry", "launches"),
}


def _launch_tally() -> Dict[str, int]:
    """This process's kernel launch counts, by kernel."""
    import importlib

    return {name: int(getattr(importlib.import_module(
                f"distributed_active_learning_tpu_torch.{mod}"), attr))
            for name, (mod, attr) in _KERNEL_COUNTERS.items()}


# ---------------------------------------------------------------------------
# The worker process
# ---------------------------------------------------------------------------


def _worker_main(worker_id: str, specs: List[dict], device: str, conn) -> None:
    """A whole serving stack in one spawned process.

    Boot: build the manager from ``specs`` on ``device`` (:func:`build_manager`:
    every graph is captured here), then bring up the frontend, the ops plane
    and the score endpoint and report the bound ports over ``conn``; a boot
    that fails reports its traceback instead (``{"error": ...}``). Serve
    until the parent sends ``"stop"``, then ship a JSON-safe final summary
    (the recompile, fallback, group and kernel-launch evidence the bench
    gates on) back over the pipe. ``kernel_launches`` counts the wrappers'
    launches since warmup; ``boot_seconds`` splits the boot after the
    imports into the device's context and :func:`build_manager`.
    """
    # The spawned interpreter runs none of its parent's set-up: cuBLAS's
    # fixed workspace must be chosen before this process's first product,
    # as every entry point on the card does.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch

        from distributed_active_learning_tpu_torch.runtime import obs
        from distributed_active_learning_tpu_torch.serving.frontend import (
            AdmissionError,
            ServiceFrontend,
        )

        specs = [TenantSpec(**s) for s in specs]
        t0 = time.perf_counter()
        on_card = torch.device(device).type == "cuda"
        if not on_card:
            # A CPU worker's work is many small ops, which a pool of every
            # core's threads does not speed up; N workers each with such a
            # pool oversubscribe the host, and on a loaded host a worker
            # with one slowed by 50x and more (its build and its scores).
            torch.set_num_threads(1)
        if on_card and torch.cuda.is_available():
            torch.zeros(1, device=device)  # the context, timed apart from the build
            torch.cuda.synchronize(device)  # audit: ok[DAL101] (boot timing)
        t1 = time.perf_counter()
        manager = build_manager(specs, device=device)
        if on_card:
            torch.cuda.synchronize(manager.device)  # audit: ok[DAL101] (boot timing)
        boot = {"cuda_context": round(t1 - t0, 3),
                "build_manager": round(time.perf_counter() - t1, 3)}
        launches0 = _launch_tally()
        frontend = ServiceFrontend(manager).start()
        ops = obs.OpsServer(port=0).start()
    except BaseException:
        conn.send({"worker": worker_id, "error": traceback.format_exc()})
        raise
    obs.gauge("fleet_worker_tenants", "tenants resident on this fleet worker",
              worker=worker_id).set(len(specs))

    lat_lock = threading.Lock()
    latencies: List[float] = []

    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _ScoreHandler(BaseHTTPRequestHandler):
        server_version = "dal-fleet-worker/1"
        # Keep-alive (every response carries Content-Length): the router's
        # pooled connections each pin one handler thread here.
        protocol_version = "HTTP/1.1"
        # Nagle and delayed ACK would add ~40 ms to every response on these
        # persistent connections.
        disable_nagle_algorithm = True

        def log_message(self, *_args):
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = (json.dumps(payload) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802 (http.server's naming)
            path, _, query = self.path.partition("?")
            if path.rstrip("/") != "/score":
                self._send(404, {"error": "POST /score only"})
                return
            # Two wire forms. JSON: {"tenant", "queries"}. Binary
            # (application/octet-stream, the tenant in the query string): an
            # <II> (rows, features) header and raw float32 rows.
            binary = self.headers.get("Content-Type", "") == "application/octet-stream"
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if binary:
                    tid = str(urllib.parse.parse_qs(query)["tenant"][0])
                    w, d = struct.unpack("<II", body[:8])
                    queries = np.frombuffer(body, np.float32, offset=8).reshape(w, d).copy()
                else:
                    req = json.loads(body)
                    tid = str(req["tenant"])
                    queries = np.asarray(req["queries"], np.float32)
            except (ValueError, KeyError, TypeError, struct.error) as e:
                self._send(400, {"error": f"bad request: {e!r}"})
                return
            if tid not in manager.tenant_ids:
                self._send(404, {"error": f"tenant {tid!r} not on worker {worker_id}"})
                return
            t0 = time.perf_counter()
            try:
                scores = frontend.score(tid, queries)
            except AdmissionError as e:
                self._send(429, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 (the error is this request's
                # client's; the worker keeps serving)
                self._send(500, {"error": repr(e)[:200]})
                return
            dt = time.perf_counter() - t0
            with lat_lock:
                latencies.append(dt)
            if binary:
                out = np.ascontiguousarray(np.asarray(scores, np.float32)).tobytes()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)
                return
            self._send(200, {"tenant": tid, "worker": worker_id,
                             "scores": np.asarray(scores).tolist()})

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _ScoreHandler)
    httpd.daemon_threads = True
    score_port = int(httpd.server_address[1])
    serve_thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.25},
                                    name=f"fleet-{worker_id}-score", daemon=True)
    serve_thread.start()

    conn.send({"worker": worker_id, "ops_port": ops.port, "score_port": score_port,
               "tenants": [spec.tenant_id for spec in specs]})

    try:
        while True:
            if conn.poll(0.25):
                if conn.recv() == "stop":
                    break
            manager.poll()
    except (EOFError, KeyboardInterrupt):
        pass

    # The dispatcher is joined, so no replay is in flight past this point.
    frontend.stop(drain=True, timeout=30.0)
    manager.close()
    if on_card:
        torch.cuda.synchronize(manager.device)  # audit: ok[DAL101] (drained at exit)
    with lat_lock:
        lat = sorted(latencies)

    def _pct(q: float) -> Optional[float]:
        if not lat:
            return None
        return round(lat[min(int(q * len(lat)), len(lat) - 1)] * 1e3, 3)

    now = _launch_tally()
    final = {
        "worker": worker_id,
        "tenants": [spec.tenant_id for spec in specs],
        "queries": len(lat),
        "p50_ms": _pct(0.50),
        "p99_ms": _pct(0.99),
        "recompiles_after_warmup": int(manager.recompiles_after_warmup()),
        "batched_score_launches": int(manager.batched_score_launches),
        "score_fallback_reasons": {k: int(v) for k, v in manager.score_fallback_reasons.items()},
        "score_groups": manager.score_groups(),
        "device": str(manager.device),
        "boot_seconds": boot,
        "kernel_launches": {k: now[k] - launches0[k] for k in now},
        "peak_reserved_mib": (round(torch.cuda.max_memory_reserved(manager.device) / 2**20, 1)
                              if on_card else None),
    }
    try:
        conn.send(final)
    except (BrokenPipeError, OSError):
        pass
    httpd.shutdown()
    httpd.server_close()
    ops.stop()
    conn.close()


# ---------------------------------------------------------------------------
# Keep-alive HTTP client (the fleet data plane)
# ---------------------------------------------------------------------------


class _KeepAliveClient:
    """Thread-local persistent HTTP/1.1 connections, keyed by endpoint.

    A pooled connection can go stale (peer restarted, socket reaped): one
    fresh-connection retry tells "my cached socket died" from "the peer is
    down". Safe because ``POST /score`` is a pure read.
    """

    def __init__(self, timeout: float):
        self._timeout = float(timeout)
        self._local = threading.local()

    def _conn(self, host: str, port: int, fresh: bool = False) -> http.client.HTTPConnection:
        pool = getattr(self._local, "pool", None)
        if pool is None:
            pool = self._local.pool = {}
        key = (host, int(port))
        conn = pool.get(key)
        if fresh and conn is not None:
            conn.close()
            conn = None
        if conn is None:
            conn = http.client.HTTPConnection(host, int(port), timeout=self._timeout)
            conn.connect()
            # Nagle and delayed ACK turn every small request on a keep-alive
            # connection into a ~40 ms stall.
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            pool[key] = conn
        return conn

    def request(self, host: str, port: int, method: str, path: str,
                body: Optional[bytes] = None,
                ctype: str = "application/json") -> Tuple[int, bytes, str]:
        """``(status, body, content_type)``; raises ``OSError`` or
        ``HTTPException`` only when the endpoint is unreachable on a fresh
        connection too."""
        for attempt in (0, 1):
            conn = self._conn(host, port, fresh=attempt > 0)
            try:
                headers = {"Content-Type": ctype} if body is not None else {}
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                out_ctype = resp.headers.get("Content-Type", "application/json")
                return resp.status, resp.read(), out_ctype
            except (http.client.HTTPException, OSError, ValueError):
                conn.close()
                if attempt:
                    raise
        raise OSError("unreachable")  # pragma: no cover (the loop always exits)


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


class RouterServer:
    """The fleet's single front door: consistent-hash forwarding with
    health gating, plus the aggregated ops plane.

    ``workers`` maps worker id -> ``{"host", "score_port", "ops_port"}``.
    Endpoints:

    - ``POST /score``: JSON ``{"tenant": ..., "queries": [[...]]}``, or the
      binary form (``?tenant=...`` and an ``application/octet-stream`` body,
      relayed without parsing), forwarded to the ring owner; an unhealthy
      (TTL-cached ``/healthz`` probe) or unreachable worker is walked past
      in ring order. A worker's 400/404/429 is relayed as it is (the worker
      answered; the verdict is the client's); 5xx and connection errors
      advance the walk; 503 when no healthy worker remains.
    - ``GET /metrics``: every worker's registry with a ``worker="wN"``
      label on each series, plus the router's ``dal_fleet_router_*``
      counters.
    - ``GET /healthz``: 200 while ANY worker is healthy (per-worker verdicts
      in the body).
    - ``GET /workers``: the endpoint map.
    - ``GET /summary``: the routing counters as JSON.

    Runs in-process too (the tests run it against stub workers on local
    threads); :class:`Fleet` runs it in its own process (:func:`_router_main`).
    """

    def __init__(self, workers: Dict[str, Dict], port: int = 0, host: str = "127.0.0.1",
                 vnodes: int = 64, health_ttl: float = _HEALTH_TTL,
                 forward_timeout: float = _FORWARD_TIMEOUT):
        self.workers = {str(w): dict(ep) for w, ep in workers.items()}
        self.ring = HashRing(sorted(self.workers), vnodes=vnodes)
        self._host = host
        self._want_port = int(port)
        self._health_ttl = float(health_ttl)
        self._forward_timeout = float(forward_timeout)
        self._health_cache: Dict[str, Tuple[float, bool]] = {}
        self._probing: set = set()
        self._fwd = _KeepAliveClient(self._forward_timeout)
        self._lock = threading.Lock()
        self.routed: Dict[str, int] = {}
        self.rerouted = 0
        self.unhealthy_skips = 0
        self.unroutable = 0
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def _url(self, wid: str, which: str) -> str:
        ep = self.workers[wid]
        return f"http://{ep.get('host', '127.0.0.1')}:{ep[which]}"

    def _mark_unhealthy(self, wid: str) -> None:
        with self._lock:
            self._health_cache[wid] = (time.monotonic() + self._health_ttl, False)

    def healthy(self, wid: str) -> bool:
        """TTL-cached ``/healthz`` probe of one worker's own ops plane.

        Single-flight with stale-while-revalidate: when the TTL lapses under
        concurrent traffic, ONE request re-probes while the rest keep the
        stale verdict.
        """
        now = time.monotonic()
        with self._lock:
            cached = self._health_cache.get(wid)
            if cached is not None and cached[0] > now:
                return cached[1]
            if wid in self._probing and cached is not None:
                return cached[1]
            self._probing.add(wid)
        try:
            try:
                with urllib.request.urlopen(self._url(wid, "ops_port") + "/healthz",
                                            timeout=_HEALTH_TIMEOUT) as r:
                    ok = r.status == 200
            except (urllib.error.URLError, OSError, ValueError):
                ok = False
        finally:
            with self._lock:
                self._probing.discard(wid)
        with self._lock:
            # The TTL test and this install are separate lock scopes (the probe
            # ran unlocked); the single-flight `_probing` set above makes one
            # installer per worker, so no install overwrites another.
            self._health_cache[wid] = (  # audit: ok[DAL203]
                time.monotonic() + self._health_ttl, ok)
        return ok

    def route(self, tenant: str) -> List[str]:
        """The forwarding walk for a tenant: the owner first, then the
        failovers."""
        return self.ring.nodes_for(str(tenant))

    def summary(self) -> Dict:
        with self._lock:
            return {
                "workers": sorted(self.workers),
                "routed": dict(self.routed),
                "rerouted": self.rerouted,
                "unhealthy_skips": self.unhealthy_skips,
                "unroutable": self.unroutable,
            }

    def _aggregate_metrics(self) -> str:
        """One Prometheus payload for the fleet: each worker's series with a
        ``worker`` label (comment lines dropped: N workers would repeat every
        HELP/TYPE header), then the router's own counters."""
        lines: List[str] = []
        for wid in sorted(self.workers):
            try:
                with urllib.request.urlopen(self._url(wid, "ops_port") + "/metrics",
                                            timeout=_HEALTH_TIMEOUT) as r:
                    text = r.read().decode()
            except (urllib.error.URLError, OSError, ValueError):
                lines.append(f'dal_fleet_worker_up{{worker="{wid}"}} 0')
                continue
            lines.append(f'dal_fleet_worker_up{{worker="{wid}"}} 1')
            for line in text.splitlines():
                if not line or line.startswith("#"):
                    continue
                head, sep, val = line.rpartition(" ")
                if not sep:
                    continue
                if head.endswith("}"):
                    head = head[:-1] + f',worker="{wid}"}}'
                else:
                    head = head + f'{{worker="{wid}"}}'
                lines.append(head + " " + val)
        with self._lock:
            for wid in sorted(self.workers):
                lines.append(f'dal_fleet_router_requests_total{{worker="{wid}"}} '
                             f"{self.routed.get(wid, 0)}")
            lines.append(f"dal_fleet_router_rerouted_total {self.rerouted}")
            lines.append(f"dal_fleet_router_unhealthy_skips_total {self.unhealthy_skips}")
            lines.append(f"dal_fleet_router_unroutable_total {self.unroutable}")
        return "\n".join(lines) + "\n"

    def start(self) -> "RouterServer":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        if self._httpd is not None:
            return self
        router = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "dal-fleet-router/1"
            protocol_version = "HTTP/1.1"  # keep-alive: every response has a length
            disable_nagle_algorithm = True

            def log_message(self, *_args):
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, payload: dict) -> None:
                self._send(code, (json.dumps(payload) + "\n").encode(), "application/json")

            def do_GET(self):  # noqa: N802
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/metrics":
                    self._send(200, router._aggregate_metrics().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    verdicts = {wid: router.healthy(wid) for wid in sorted(router.workers)}
                    ok = any(verdicts.values())
                    self._send_json(200 if ok else 503, {"ok": ok, "workers": verdicts})
                elif path == "/workers":
                    self._send_json(200, router.workers)
                elif path == "/summary":
                    self._send_json(200, router.summary())
                else:
                    self._send(404, b"not found; endpoints: /score (POST) /metrics"
                               b" /healthz /workers /summary\n", "text/plain")

            def do_POST(self):  # noqa: N802
                path, _, query = self.path.partition("?")
                if path.rstrip("/") != "/score":
                    self._send_json(404, {"error": "POST /score only"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                req_ctype = self.headers.get("Content-Type", "application/json")
                # The routing key: ?tenant=... when present (the binary form:
                # the payload is never parsed here), else the JSON body's.
                tenant = urllib.parse.parse_qs(query).get("tenant", [None])[0]
                if tenant is None:
                    try:
                        tenant = str(json.loads(body)["tenant"])
                    except (ValueError, KeyError, TypeError) as e:
                        self._send_json(400, {"error": f"bad request: {e!r}"})
                        return
                for hop, wid in enumerate(router.route(tenant)):
                    if not router.healthy(wid):
                        with router._lock:
                            router.unhealthy_skips += 1
                        continue
                    ep = router.workers[wid]
                    try:
                        status, out, out_ctype = router._fwd.request(
                            ep.get("host", "127.0.0.1"), ep["score_port"], "POST", self.path,
                            body=body, ctype=req_ctype)
                    except (http.client.HTTPException, OSError, ValueError):
                        router._mark_unhealthy(wid)
                        continue
                    if status in (400, 404, 429):
                        # the worker answered; the verdict is the client's
                        self._send(status, out, out_ctype)
                        return
                    if status != 200:
                        router._mark_unhealthy(wid)
                        continue
                    with router._lock:
                        router.routed[wid] = router.routed.get(wid, 0) + 1
                        if hop > 0:
                            router.rerouted += 1
                    self._send(200, out, out_ctype)
                    return
                with router._lock:
                    router.unroutable += 1
                self._send_json(503, {"error": f"no healthy worker for tenant {tenant!r}"})

        httpd = ThreadingHTTPServer((self._host, self._want_port), _Handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        self.port = int(httpd.server_address[1])
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        kwargs={"poll_interval": 0.25},
                                        name="dal-fleet-router", daemon=True)
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

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def _router_main(port: int, conn) -> None:
    """The router as its own process: wait for the workers' endpoints (it
    boots beside them), start, report the bound port, serve until
    ``"stop"``, ship the routing summary back."""
    try:
        router = RouterServer(conn.recv(), port=port).start()
    except BaseException:
        conn.send({"error": traceback.format_exc()})
        raise
    conn.send({"router_port": router.port})
    try:
        while True:
            if conn.poll(0.25) and conn.recv() == "stop":
                break
    except (EOFError, KeyboardInterrupt):
        pass
    summary = router.summary()
    router.stop()
    try:
        conn.send(summary)
    except (BrokenPipeError, OSError):
        pass
    conn.close()


# A spawned child unpickles its target by importing the target's module, so
# a child that cannot import the port would die before it could say why.
# The children's target is therefore ``exec`` (a builtin) on this code,
# which imports the port inside a ``try`` and sends the traceback of a
# failed import over the pipe.
_CHILD_BOOT = """
try:
    from distributed_active_learning_tpu_torch.serving import fleet
except BaseException:
    import traceback
    conn.send({"error": traceback.format_exc()})
    raise
getattr(fleet, entry)(*args, conn)
"""


def _spawn(ctx, entry: str, args: tuple, name: str):
    """Start ``fleet.<entry>(*args, conn)`` in a spawned child; returns
    ``(process, parent_end_of_the_pipe)``."""
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=exec, args=(_CHILD_BOOT, {"conn": child, "entry": entry,
                                                        "args": args}),
                       name=name, daemon=True)
    proc.start()
    child.close()
    return proc, parent


def _ready(proc, conn, what: str, deadline: float, timeout: float) -> dict:
    """The child's first message, or a ``RuntimeError`` carrying its error:
    its traceback, its exit, or the start timeout."""
    remaining = deadline - time.monotonic()
    if remaining <= 0 or not conn.poll(remaining):
        raise RuntimeError(f"{what} did not report ready within {timeout:.0f}s")
    try:
        msg = conn.recv()
    except EOFError:
        proc.join(timeout=5)
        raise RuntimeError(f"{what} exited with code {proc.exitcode} before reporting ready "
                           "(its traceback is on its standard error)") from None
    if "error" in msg:
        raise RuntimeError(f"{what} failed to start:\n{msg['error']}")
    return msg


# ---------------------------------------------------------------------------
# The fleet orchestrator
# ---------------------------------------------------------------------------


class Fleet:
    """Spawn the workers, place the tenants, front them with the router.

    Placement uses the :class:`HashRing` (same worker ids, same ``vnodes``)
    the router routes by, so the router's first hop is the owner.
    ``device`` is where every worker serves (a string; default the card): a
    worker that cannot take it (no card for ``"cuda"``) fails ``start`` with
    its error, it never serves on the CPU instead. ``start()`` builds the
    CUDA kernels the specs need once, here (``kernel="pallas"`` needs K1's
    library), then blocks until every worker reports its ports (workers warm
    up, capturing their graphs, before reporting; ``ready_seconds`` holds
    each worker's seconds from its spawn to that report); ``stop()``
    collects each worker's final summary and the router's routing counters.
    """

    def __init__(self, specs: List[TenantSpec], n_workers: int, router_port: int = 0,
                 vnodes: int = 64, start_timeout: float = 600.0, device: str = "cuda"):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.specs = list(specs)
        self.n_workers = int(n_workers)
        self.device = str(device)
        self._router_port = int(router_port)
        self._vnodes = int(vnodes)
        self._start_timeout = float(start_timeout)
        self.worker_ids = [f"w{i}" for i in range(self.n_workers)]
        ring = HashRing(self.worker_ids, vnodes=self._vnodes)
        self.assignment: Dict[str, str] = {
            spec.tenant_id: ring.lookup(spec.tenant_id) for spec in self.specs}
        self._procs: Dict[str, mp.process.BaseProcess] = {}
        self._conns: Dict[str, object] = {}
        self._client = _KeepAliveClient(_FORWARD_TIMEOUT)
        self.endpoints: Dict[str, Dict] = {}
        self.ready_seconds: Dict[str, float] = {}
        self._router_proc: Optional[mp.process.BaseProcess] = None
        self._router_conn = None
        self.router_port: Optional[int] = None

    def specs_for(self, worker_id: str) -> List[TenantSpec]:
        return [spec for spec in self.specs if self.assignment[spec.tenant_id] == worker_id]

    def start(self) -> "Fleet":
        if self.device.startswith("cuda") and any(s.kernel == "pallas" for s in self.specs):
            from distributed_active_learning_tpu_torch import kernels

            kernels.build_all(["forest_leaves"])
        ctx = mp.get_context("spawn")
        t0 = time.monotonic()
        deadline = t0 + self._start_timeout
        try:
            for wid in self.worker_ids:
                specs = [dataclasses.asdict(s) for s in self.specs_for(wid)]
                self._procs[wid], self._conns[wid] = _spawn(
                    ctx, "_worker_main", (wid, specs, self.device), f"dal-fleet-{wid}")
            # The router's interpreter boots beside the workers'; it gets
            # their endpoints once they have all reported.
            self._router_proc, self._router_conn = _spawn(
                ctx, "_router_main", (self._router_port,), "dal-fleet-router")
            for wid in self.worker_ids:
                ready = _ready(self._procs[wid], self._conns[wid], f"fleet worker {wid}",
                               deadline, self._start_timeout)
                self.ready_seconds[wid] = round(time.monotonic() - t0, 3)
                self.endpoints[wid] = {"host": "127.0.0.1", "score_port": ready["score_port"],
                                       "ops_port": ready["ops_port"], "tenants": ready["tenants"]}
            self._router_conn.send(self.endpoints)
            self.router_port = _ready(self._router_proc, self._router_conn, "fleet router",
                                      deadline, self._start_timeout)["router_port"]
        except BaseException:
            self._kill_all()
            raise
        return self

    def _kill_all(self) -> None:
        procs = list(self._procs.values())
        if self._router_proc is not None:
            procs.append(self._router_proc)
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
        for proc in procs:
            proc.join(timeout=5)

    def score(self, tenant: str, queries) -> np.ndarray:
        """Score through the router, the fleet's one client surface: the
        binary wire form over a thread-local keep-alive connection. A
        non-200 status raises ``urllib.error.HTTPError``."""
        q = np.ascontiguousarray(np.asarray(queries, np.float32))
        if q.ndim == 1:
            q = q[None, :]
        body = struct.pack("<II", q.shape[0], q.shape[1]) + q.tobytes()
        path = "/score?tenant=" + urllib.parse.quote(str(tenant), safe="")
        status, out, _ = self._client.request("127.0.0.1", self.router_port, "POST", path,
                                              body=body, ctype="application/octet-stream")
        if status != 200:
            raise urllib.error.HTTPError(f"http://127.0.0.1:{self.router_port}{path}", status,
                                         out.decode(errors="replace")[:200], hdrs=None, fp=None)
        return np.frombuffer(out, np.float32).copy()

    def worker_metrics(self, worker_id: str) -> str:
        """One worker's OWN ``/metrics`` payload (the per-worker recompile
        gate scrapes this, not the router's aggregate)."""
        url = f"http://127.0.0.1:{self.endpoints[worker_id]['ops_port']}/metrics"
        with urllib.request.urlopen(url, timeout=_HEALTH_TIMEOUT) as r:
            return r.read().decode()

    def stop(self) -> Dict:
        """Stop everything; returns ``{"workers": {...}, "router": {...}}``,
        each worker's final summary and the router's counters (a worker that
        died has no entry)."""
        finals: Dict[str, Dict] = {}
        for conn in self._conns.values():
            try:
                conn.send("stop")
            except (BrokenPipeError, OSError):
                continue
        for wid, conn in self._conns.items():
            try:
                if conn.poll(60.0):
                    finals[wid] = conn.recv()
            except (EOFError, OSError):
                pass
        router_summary = None
        if self._router_conn is not None:
            try:
                self._router_conn.send("stop")
                if self._router_conn.poll(30.0):
                    router_summary = self._router_conn.recv()
            except (BrokenPipeError, EOFError, OSError):
                pass
        self._kill_all()
        return {"workers": finals, "router": router_summary}

    def __enter__(self) -> "Fleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
