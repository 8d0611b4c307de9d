"""CLI for the streaming AL service: a simulated stream over a dataset (the
port of the JAX package's ``serving/__main__.py``, with its flags).

    python -m distributed_active_learning_tpu_torch.serving \
        --dataset checkerboard2x2 --queries 500 --ingest-every 4 \
        --metrics-out results/serve.jsonl [--device cpu]

Splits the registry dataset into a cold-start pool and a held-back arrival
stream, then drives the service with interleaved score queries (drawn from
the test split) and ingest blocks (the held-back stream), printing one JSON
summary line: sustained queries/sec, p50/p99 scoring latency, ingest
throughput, re-fit counts by drift reason, and the no-silent-recompile
counter. ``--checkpoint-dir`` saves the slab + resident forest at shutdown
and resumes from it at startup (no ingest replay); either package's
checkpoint resumes in the other. ``--device`` defaults to ``cuda`` and
refuses to start without a card unless it is ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_active_learning_tpu_torch.serving",
        description="streaming AL service over a simulated arrival stream",
    )
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the service runs (default cuda; refuses without a card)")
    ap.add_argument("--dataset", default="checkerboard2x2")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--strategy", default="uncertainty")
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--kernel", choices=["gemm", "pallas", "gather"], default="gemm")
    ap.add_argument("--n-start", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--initial-frac", type=float, default=0.5,
        help="fraction of the train split seeding the pool; the rest arrives "
        "as the ingest stream",
    )
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument(
        "--ingest-every", type=int, default=4,
        help="submit one ingest block every N queries (0 = no ingest)",
    )
    ap.add_argument("--slab-rows", type=int, default=None)
    ap.add_argument("--ingest-block", type=int, default=None)
    ap.add_argument("--score-width", type=int, default=None)
    ap.add_argument("--refit-rounds", type=int, default=None)
    ap.add_argument("--drift-entropy-shift", type=float, default=None)
    ap.add_argument("--drift-margin-shift", type=float, default=None)
    ap.add_argument("--max-staleness", type=int, default=None)
    ap.add_argument("--fit-budget", type=int, default=None)
    ap.add_argument("--metrics-out", default=None, metavar="PATH")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument(
        "--ops-port", type=int, default=None, metavar="PORT",
        help="serve the live ops plane (runtime/obs.py) on localhost:PORT — "
        "/metrics (Prometheus text), /healthz, /varz, /flightz; 0/absent = "
        "off (ServeConfig.ops_port)",
    )
    ap.add_argument(
        "--slo-latency-ms", type=float, default=None, metavar="MS",
        help="per-query latency objective: queries answering within MS count "
        "toward the SLO; enables compliance + burn-rate gauges and the "
        "summary's slo block (ServeConfig.slo_latency_ms; absent = no SLO)",
    )
    ap.add_argument(
        "--slo-target", type=float, default=None, metavar="FRAC",
        help="SLO compliance target in (0, 1), e.g. 0.99 "
        "(ServeConfig.slo_target)",
    )
    return ap


def _serve_config(args):
    import dataclasses

    from distributed_active_learning_tpu_torch.config import ServeConfig

    overrides = {
        name: getattr(args, flag)
        for name, flag in (
            ("slab_rows", "slab_rows"),
            ("ingest_block", "ingest_block"),
            ("score_width", "score_width"),
            ("refit_rounds", "refit_rounds"),
            ("drift_entropy_shift", "drift_entropy_shift"),
            ("drift_margin_shift", "drift_margin_shift"),
            ("max_staleness", "max_staleness"),
            ("ops_port", "ops_port"),
            ("slo_latency_ms", "slo_latency_ms"),
            ("slo_target", "slo_target"),
        )
        if getattr(args, flag) is not None
    }
    return dataclasses.replace(ServeConfig(), **overrides)


def drive_stream(service, stream_x, stream_y, test_x, *,
                 queries: int, ingest_every: int, block: int, rng):
    """Interleave score queries with ingest blocks; returns per-query
    latencies (seconds). ``bench.py --mode serve`` drives the same shape but
    with its own loop (it shifts the QUERY distribution mid-run to exercise
    the entropy trigger, which this dataset-backed drive cannot); a latency
    here is one ``service.score`` call wall — including any re-fit dispatch
    (and its graph capture) that call performs — matching the bench's definition."""
    latencies = []
    stream_pos = 0
    for i in range(queries):
        if (
            ingest_every
            and i % ingest_every == 0
            and stream_pos < stream_x.shape[0]
        ):
            hi = min(stream_pos + block, stream_x.shape[0])
            service.submit(stream_x[stream_pos:hi], stream_y[stream_pos:hi])
            stream_pos = hi
        idx = rng.integers(0, test_x.shape[0], size=min(service.serve.score_width, test_x.shape[0]))
        t0 = time.perf_counter()
        service.score(test_x[idx])
        latencies.append(time.perf_counter() - t0)
    return latencies


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from distributed_active_learning_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card: refuse before any work

    from distributed_active_learning_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        ForestConfig,
        StrategyConfig,
    )
    from distributed_active_learning_tpu_torch.data.datasets import get_dataset
    from distributed_active_learning_tpu_torch.serving.service import ALService

    bundle = get_dataset(
        DataConfig(name=args.dataset, path=args.data_path, seed=args.seed)
    )
    x = np.asarray(bundle.train_x, np.float32)
    y = np.asarray(bundle.train_y, np.int32)
    n0 = max(int(x.shape[0] * args.initial_frac), args.n_start + 2)
    serve = _serve_config(args)
    cfg = ExperimentConfig(
        data=DataConfig(name=args.dataset, path=args.data_path, seed=args.seed),
        forest=ForestConfig(
            n_trees=args.trees, max_depth=args.depth, kernel=args.kernel,
            fit="device", fit_budget=args.fit_budget,
        ),
        strategy=StrategyConfig(name=args.strategy, window_size=args.window),
        n_start=args.n_start,
        seed=args.seed,
    )

    writer = None
    if args.metrics_out:
        from distributed_active_learning_tpu_torch.runtime.telemetry import (
            MetricsWriter,
            install_exit_flush,
        )

        # Buffered writes (serve_latency is per-query — hot path), with the
        # SIGTERM/atexit flush so a killed service keeps its tail events.
        writer = MetricsWriter(args.metrics_out, flush_every=64)
        install_exit_flush(writer)

    # Live ops plane: bind BEFORE the service builds so /healthz answers
    # during cold-start captures (a 503-until-warm endpoint is still an
    # endpoint; a connection refused is "is it even running?").
    ops_server = None
    if serve.ops_port > 0:
        from distributed_active_learning_tpu_torch.runtime.obs import OpsServer

        ops_server = OpsServer(port=serve.ops_port).start()
        print(
            f"# ops plane: http://127.0.0.1:{ops_server.port}/metrics "
            "(/healthz /varz /flightz)",
            flush=True,
        )

    service = ALService(
        cfg, serve, x[:n0], y[:n0], bundle.test_x, bundle.test_y,
        metrics=writer, checkpoint_dir=args.checkpoint_dir, device=args.device,
    )
    rng = np.random.default_rng(args.seed)
    test_x = np.asarray(bundle.test_x, np.float32)

    t0 = time.perf_counter()
    latencies = drive_stream(
        service, x[n0:], y[n0:], test_x,
        queries=args.queries, ingest_every=args.ingest_every,
        block=serve.ingest_block, rng=rng,
    )
    service.flush()
    wall = time.perf_counter() - t0

    if args.checkpoint_dir:
        service.save_checkpoint()
    if writer is not None:
        writer.close()
    if ops_server is not None:
        ops_server.stop()

    lat = np.asarray(latencies)
    payload = {
        "serve_qps": round(len(latencies) / wall, 2) if wall > 0 else None,
        "serve_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
        "serve_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
        "ingest_points_per_sec": round(service.stats.ingested_points / wall, 1)
        if wall > 0
        else None,
        **service.summary(),
    }
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
