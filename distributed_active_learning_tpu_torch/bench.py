"""The port's own bench: one JSON line on stdout, always.

    python -m distributed_active_learning_tpu_torch.bench --mode score|density|round|variants|neural
        [--device cpu] [--kernel pallas|gemm|gather] [--pool N] [--trees T] ...

The counterpart of the repo-root ``bench.py`` (the JAX package's, which stays
as it is) for what the port carries:

- ``--mode score``: votes, uncertainty score and masked bottom-k over the
  pool (``bench_score``). ``value`` is scores per second from device time.
  ``--kernel gather`` scores through the gather form (``ops/trees.py``).
- ``--mode density``: the density acquisition (``bench_density``): votes,
  one-sided entropy times the similarity mass over the unlabeled pool, then
  the masked top-k; ``value`` is scores per second from device time. Its
  forest is the device fit's, as in score mode, where the JAX bench fits
  with scikit-learn: the machine with the card has no scikit-learn.
- ``--mode round``: one full AL round with the device fit (``bench_round``:
  ``round_seconds``, ``round_fit_seconds``, ``round_score_seconds``); the
  chunked driver against the per-round driver over the same K rounds
  (``rounds_per_launch``, ``scan_seconds_per_round``,
  ``per_round_driver_seconds_per_round``, ``scan_fusion_speedup``,
  ``chunk_first_call_seconds``). As in the JAX bench the chunk computes its
  RoundMetrics (``scan_metrics_enabled: true``); the same chunk without them
  is timed beside it (``scan_seconds_per_round_metrics_off``,
  ``scan_metrics_overhead``). Then three metrics-on chunks through
  ``run_pipelined`` at depth 1 and 2 (``pipelined_seconds_per_round``,
  ``pipelined_serial_seconds_per_round``, ``touchdown_hidden_fraction``); and
  the fused round against the unfused one through the same chunk program
  (``fused_scan_seconds_per_round``, ``unfused_scan_seconds_per_round``,
  ``fused_round_speedup``).
- ``--mode variants``: the leaf-eval kernel variants side by side
  (``benches/pallas_variants.py``).
- ``--mode lal``: one LAL query at the reference's scale (``bench_lal``: a
  50-tree depth-8 base forest, a 2,000-tree depth-8 regressor, a 1,000-row
  pool, 100 labeled): the base fit on the device, the five features, the
  regressor over them and the top-1 pick with its reveal
  (``lal_query_seconds`` wall, ``lal_query_device_seconds`` from CUDA
  events, ``vs_baseline`` against the reference's 1,654.16 s query). The
  regressor is ``--lal-model PATH`` (a forest file) or, where scikit-learn
  is installed, fitted from the committed reference-format fixture. The
  host-fit leg (``lal_query_seconds_host_fit``: the base forest fitted with
  scikit-learn each query) needs scikit-learn; where it is missing the line
  says so under ``lal_host_fit_skipped``.

- ``--mode sweep``: E experiments (``--sweep-experiments``, default 8) over
  one shared pool (``--sweep-pool``, default the bench pool) for K rounds
  (one chunk of ``--rounds-per-launch``) through ``runtime.sweep.run_sweep``
  against the E serial ``run_experiment`` calls it replaces, each arm
  whole, graph capture included, as the JAX bench times its compiles
  (``sweep_experiments_rounds_per_second``,
  ``serial_experiments_rounds_per_second``, ``sweep_speedup``). At the
  bench width: 100 trees of depth 8, kernel "pallas", where the JAX bench's
  depth 4 and 100,000 rows are smoke sizes of its own.
- ``--mode grid``: the ``--grid-strategies`` x ``--grid-experiments``
  seeds grid (2 chunks of K = 2) through ``runtime.sweep.run_grid`` against
  the serial cells (``grid_cells_rounds_per_second``,
  ``serial_cells_rounds_per_second``, ``grid_speedup``,
  ``recompiles_after_warmup``: graph captures after the first, must be 0).
  Then the JAX bench's scenario leg: the axis none, ``noisy_oracle`` (flip
  0.1, abstain 0.25), ``cost_budget`` (2.5 x window), ``rare_event`` (class
  1) and ``drift`` (0.2) x entropy x the seeds as one stream
  (``scenario_cells_rounds_per_second``, ``scenario_launches``,
  ``scenario_recompiles_after_warmup``: must be 0). ``--no-baseline`` skips
  the serial arm of both modes (``baseline_skipped`` says so).

- ``--mode neural``: one deep-AL round of each BASELINE stretch config
  (``bench_neural``, the JAX bench's): a SmallCNN over the
  ``make_synthetic_images`` pool with MC-dropout entropy and window 100
  (``cnn_round_seconds``), and ``TransformerClassifier(vocab_size=4096,
  max_len=64, n_classes=4)`` over the ``make_synthetic_tokens`` pool with
  BatchBALD and window 50 (``transformer_batchbald_round_seconds``): the fit
  of ``--train-steps`` minibatches, the ``--mc-samples`` MC passes and the
  select, on ``--neural-pool`` rows (2,000, 300 steps, 8 samples on CUDA),
  each round's device seconds from CUDA events (median of ``--iters``, at
  most 3), run eagerly.

Sizes default to the JAX bench's: its accelerator table on CUDA (pool
284,807 x 30, 100 trees, 5,000 labeled rows, 10 iterations, 8 rounds per
launch) and its smoke table under ``--device cpu`` (``cpu_smoke_sizes`` is
then true in the line, so a smoke-scale line cannot pass for a measurement).

Device time is CUDA events around the call; the JAX bench's differential
batching cancels a per-call latency of its rig that a local card does not
have. Wall times are the host clock around a call that ends in a
synchronize. The line carries the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit`` prints them.

``--metrics-out PATH`` appends JSONL events of the round mode's depth-2
pipelined drive (a ``meta`` event, one ``round`` event per round with its
RoundMetrics, one ``launch`` event per chunk) for
``benches/summarize_metrics.py``. ``--flight-recorder PATH`` installs the
flight recorder (off by default): mode and timing marks (``bench_start``,
``bench_compile``, ``bench_timing_start``/``_end`` with the timed program's
label) and the drive's launches, dumped on SIGTERM, SIGUSR1, a crash and a
normal exit.

Not carried yet, each with the slice it waits for: the score mode's
host-fit leg (the bench runs where the card is, which has no scikit-learn; a
host-fit forest would come as a forest file), the roofline section
(pre-flight slice), the pod legs (mesh-and-pod slice), ``--audit`` and
``--compare-to`` (pre-flight slice), the grid's scenario leg (scenario
slice), and the modes serve* (their own slice).
``--kernel gather`` is carried by the score and density modes.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

_CUDA_SIZES = dict(pool=284_807, trees=100, train_rows=5000, iters=10, rounds_per_launch=8,
                   lal_trees=2000, lal_pool=1000, sweep_experiments=8, sweep_pool=284_807,
                   grid_experiments=8, neural_pool=2000, train_steps=300)
_CPU_SIZES = dict(pool=10_000, trees=10, train_rows=500, iters=2, rounds_per_launch=4,
                  lal_trees=50, lal_pool=200, sweep_experiments=8, sweep_pool=500,
                  grid_experiments=8, neural_pool=200, train_steps=25)
# The reference's one LAL query on Spark (classes/RESULTS.txt), the JAX
# bench's baseline.
SPARK_LAL_QUERY_SEC = 1654.16


def card_line(dev: torch.device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them (None on
    the CPU)."""
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _flight(kind: str, **fields) -> None:
    """Record into the flight recorder when one is installed (a no-op
    otherwise)."""
    from distributed_active_learning_tpu_torch.runtime.telemetry import flight_record

    flight_record(kind, **fields)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall(fn: Callable[[], object], dev: torch.device) -> float:
    """Host seconds of one call, its queued device work included."""
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


def _median_wall(fn, iters: int, dev, label: Optional[str] = None) -> float:
    """Median host seconds of ``fn``; ``label`` names the timed program in
    the flight recorder, so a killed bench's artifact says what was running."""
    if label:
        _flight("bench_timing_start", label=label, iters=iters)
    times = [_wall(fn, dev) for _ in range(max(iters, 1))]
    if label:
        _flight("bench_timing_end", label=label, seconds=round(sum(times), 4))
    return statistics.median(times)


def _median_device(fn, iters: int, dev) -> float:
    """Median device seconds of a call (CUDA events; the host clock on the
    CPU, where the two are one)."""
    from distributed_active_learning_tpu_torch.benches.pallas_variants import time_call

    return statistics.median(time_call(fn, dev) for _ in range(max(iters, 1)))


def _make_pool(args, rng):
    pool = rng.normal(size=(args.pool, args.features)).astype(np.float32)
    train_x = rng.normal(size=(args.train_rows, args.features)).astype(np.float32)
    train_y = (train_x[:, 0] + 0.3 * train_x[:, 1] > 0).astype(np.int32)
    return pool, train_x, train_y


def _wrap(gf, kernel: str):
    from distributed_active_learning_tpu_torch.ops.trees_pallas import PallasForest

    return PallasForest(gf=gf) if kernel == "pallas" else gf


def _fit_bench_forest(args, dev, train_x, train_y):
    """The device fit on the bench's labeled rows, in ``--kernel``'s form."""
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.ops import trees_train

    tx = torch.from_numpy(train_x).to(dev)
    binned = trees_train.make_bins(tx, 32)
    f, th, v = trees_train.fit_forest_device(
        binned.codes, torch.from_numpy(train_y).to(dev), torch.ones(args.train_rows, device=dev),
        binned.edges, prng.key(0), n_trees=args.trees, max_depth=args.depth)
    if args.kernel == "gather":
        return trees_train.heap_packed_forest(f, th, v, args.depth)
    return _wrap(trees_train.heap_gemm_forest(f, th, v, args.depth), args.kernel)


def bench_score(args, dev) -> dict:
    from distributed_active_learning_tpu_torch.ops import forest_eval, scoring
    from distributed_active_learning_tpu_torch.ops.topk import select_bottom_k

    rng = np.random.default_rng(0)
    pool, train_x, train_y = _make_pool(args, rng)
    forest = _fit_bench_forest(args, dev, train_x, train_y)
    pool_dev = torch.from_numpy(pool).to(dev)
    unlabeled = torch.ones(args.pool, dtype=torch.bool, device=dev)

    def acquisition():
        votes = forest_eval.votes(forest, pool_dev)
        scores = scoring.uncertainty_score(
            scoring.VoteFraction(votes.to(torch.float32), forest.n_trees))
        _, idx = select_bottom_k(scores, unlabeled, args.window)
        return scores, idx

    _wall(acquisition, dev)  # builds and warms
    wall_sec = _median_wall(acquisition, args.iters, dev)
    device_sec = _median_device(acquisition, args.iters, dev)
    return {
        "metric": "acquisition_scores_per_sec",
        "value": round(args.pool / device_sec, 1),
        "unit": f"scores/s from device time ({args.pool}x{args.features} pool, {args.trees} "
                f"trees, depth {args.depth}, {args.kernel} kernel)",
        "kernel": args.kernel,
        "device_time_method": "cuda_events" if dev.type == "cuda" else "host_clock",
        "device_seconds_per_query": device_sec,
        "wall_seconds_per_query": round(wall_sec, 6),
        "wall_scores_per_sec": round(args.pool / wall_sec, 1),
    }


def bench_density(args, dev) -> dict:
    """Density-weighted acquisition over the whole unlabeled pool: the
    density strategy's score (votes, one-sided entropy, similarity mass to
    the power beta = 1) and the masked top-k."""
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.config import StrategyConfig
    from distributed_active_learning_tpu_torch.ops.topk import select_top_k
    from distributed_active_learning_tpu_torch.runtime.state import PoolState
    from distributed_active_learning_tpu_torch.strategies import StrategyAux, get_strategy

    rng = np.random.default_rng(0)
    pool, train_x, train_y = _make_pool(args, rng)
    forest = _fit_bench_forest(args, dev, train_x, train_y)
    pool_dev = torch.from_numpy(pool).to(dev)
    state = PoolState(x=pool_dev, oracle_y=torch.zeros(args.pool, dtype=torch.int32, device=dev),
                      labeled_mask=torch.zeros(args.pool, dtype=torch.bool, device=dev),
                      key=prng.key(0))
    strategy = get_strategy(StrategyConfig(name="density", window_size=args.window))

    def acquisition():
        scores = strategy.score(forest, state, None, StrategyAux())
        return select_top_k(scores, state.unlabeled_mask, args.window)

    _wall(acquisition, dev)  # builds and warms
    wall_sec = _median_wall(acquisition, args.iters, dev)
    device_sec = _median_device(acquisition, args.iters, dev)
    return {
        "metric": "density_scores_per_sec",
        "value": round(args.pool / device_sec, 1),
        "unit": f"scores/s from device time ({args.pool}x{args.features} pool, {args.trees} "
                f"trees, depth {args.depth}, {args.kernel} kernel, device fit)",
        "kernel": args.kernel,
        "density_time_method": "cuda_events" if dev.type == "cuda" else "host_clock",
        "device_seconds_per_query": device_sec,
        "density_wall_scores_per_sec": round(args.pool / wall_sec, 1),
    }


def _chunk_setup(args, dev, pool, pool_y, mask0, binned, fused: bool, with_metrics: bool = False):
    """The production chunk program on the bench pool: ``(chunk_fn, carry,
    aux, fit_key, tx, ty, device_fit, strategy)``; a CUDA graph on the card."""
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.config import (
        ExperimentConfig, ForestConfig, StrategyConfig,
    )
    from distributed_active_learning_tpu_torch.runtime import loop, state as state_lib
    from distributed_active_learning_tpu_torch.strategies import StrategyAux, get_strategy

    K, window = args.rounds_per_launch, args.window
    ecfg = ExperimentConfig(
        forest=ForestConfig(
            n_trees=args.trees, max_depth=args.depth, kernel=args.kernel, fit="device",
            # Labels grow by K windows per launch, and the pipelined drive
            # threads up to 4 chunks of growth.
            fit_budget=1 << (args.train_rows + 5 * K * window).bit_length(),
        ),
        strategy=StrategyConfig(name="uncertainty", window_size=window),
    )
    state0 = state_lib.init_pool_state(pool, pool_y, prng.key(0), dev)
    state0 = state_lib.as_carry(state0.replace(labeled_mask=torch.from_numpy(mask0).to(dev)))
    device_fit = loop.make_device_fit(ecfg, binned.edges, ecfg.forest.fit_budget)
    strategy = get_strategy(ecfg.strategy)
    aux = StrategyAux(seed_mask=state0.labeled_mask.clone())
    chunk_fn = loop.make_chunk_fn(strategy, window, K, device_fit, label_cap=state0.n_valid,
                                  fused_round=fused, with_metrics=with_metrics)
    if dev.type == "cuda":
        chunk_fn = loop.GraphedChunk(chunk_fn)
    # A small held-out set, so the chunk includes the accuracy eval that
    # run_experiment performs.
    tx, ty = state0.x[:2048], state0.oracle_y[:2048]
    return chunk_fn, state0, aux, prng.key(7, dev), tx, ty, device_fit, strategy


def _end_round(value: int, dev) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int32).to(dev)


def _bench_scan_fusion(args, dev, pool, pool_y, mask0, binned, writer=None) -> dict:
    """K rounds in one launch and one touchdown against the per-round
    driver's three syncs a round (fit, round, accuracy) over the same K
    rounds from the same state. The chunk computes its RoundMetrics, as the
    JAX bench's does; the metrics-off chunk is timed beside it, its reps
    interleaved with the metrics-on chunk's."""
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.runtime import loop, pipeline, telemetry

    K = args.rounds_per_launch
    chunk_fn, state0, aux, fit_key, tx, ty, device_fit, strategy = _chunk_setup(
        args, dev, pool, pool_y, mask0, binned, fused=False, with_metrics=True)
    off_fn = _chunk_setup(args, dev, pool, pool_y, mask0, binned, fused=False)[0]
    round_fn = loop.make_round_fn(strategy, args.window)
    end = _end_round(np.iinfo(np.int32).max, dev)

    def chunked(fn):
        def run():
            _, extras, ys = fn(binned.codes, state0, aux, fit_key, tx, ty, end)
            pipeline.start_host_copy((extras, ys)).wait()  # the one touchdown per chunk
        return run

    run_chunked, run_off = chunked(chunk_fn), chunked(off_fn)

    def run_per_round():
        st = state0
        for r in range(1, K + 1):
            forest = device_fit(binned.codes, st, prng.fold_in(fit_key, r))
            _sync(dev)
            st, picked, _ = round_fn(forest, st, aux)
            _sync(dev)
            float(loop._accuracy(forest, tx, ty))

    _flight("bench_compile", label="round/chunk_scan")
    chunk_first_call = _wall(run_chunked, dev)  # warm-up step, capture and first replay
    _flight("bench_compile", label="round/chunk_scan_metrics_off")
    _wall(run_off, dev)
    run_per_round()
    reps = max(min(args.iters, 5), 2)
    _flight("bench_timing_start", label="round/chunk_scan/interleaved", iters=reps)
    on_times, off_times = [], []
    for _ in range(reps):
        on_times.append(_wall(run_chunked, dev))
        off_times.append(_wall(run_off, dev))
    _flight("bench_timing_end", label="round/chunk_scan/interleaved",
            seconds=round(sum(on_times) + sum(off_times), 4))
    chunk_sec = statistics.median(on_times) / K
    off_sec = statistics.median(off_times) / K
    per_round_sec = _median_wall(run_per_round, reps, dev, label="round/per_round_driver") / K
    out = {
        "rounds_per_launch": K,
        "scan_seconds_per_round": round(chunk_sec, 6),
        "scan_seconds_per_round_metrics_off": round(off_sec, 6),
        "scan_metrics_overhead": round(chunk_sec / off_sec - 1.0, 4),
        "per_round_driver_seconds_per_round": round(per_round_sec, 6),
        "scan_fusion_speedup": round(per_round_sec / chunk_sec, 3),
        "scan_metrics_enabled": True,
        "chunk_first_call_seconds": round(chunk_first_call, 4),
        "chunk_capture_overhead_seconds": round(max(chunk_first_call - chunk_sec * K, 0.0), 4),
    }
    if isinstance(chunk_fn, loop.GraphedChunk):
        out["chunk_graph"] = chunk_fn.stats()
        out["chunk_graph_metrics_off"] = off_fn.stats()
    del off_fn
    out.update(_bench_pipelined(args, dev, chunk_fn, state0, aux, binned, fit_key, tx, ty,
                                writer=writer))
    out.update(telemetry.device_memory_gauges())
    return out


def _bench_pipelined(args, dev, chunk_fn, state0, aux, binned, fit_key, tx, ty,
                     writer=None) -> dict:
    """Three chunks through ``run_pipelined`` at depth 2 and depth 1 with the
    production touchdown body (record append, metrics dict conversion).
    ``touchdown_hidden_fraction`` > 0 means chunk touchdowns ran while
    another chunk executed; depth 1 pins it at 0. ``writer`` gets the depth-2
    drive's round and launch events."""
    from distributed_active_learning_tpu_torch.runtime import telemetry
    from distributed_active_learning_tpu_torch.runtime.pipeline import run_pipelined
    from distributed_active_learning_tpu_torch.runtime.results import ExperimentResult

    K, chunks = args.rounds_per_launch, 3
    # Bound the drive inside the chunk (end_round), as run_experiment bounds
    # max_rounds, so both depths run the same three chunks.
    total = chunks * K
    end = _end_round(total, dev)

    def drive(depth, writer=None):
        result = ExperimentResult()
        done = {"rounds": 0}
        tracker = telemetry.LaunchTracker(writer, "chunk_scan", fn=chunk_fn)

        def dispatch(st, _idx):
            return chunk_fn(binned.codes, st, aux, fit_key, tx, ty, end)

        def continue_after(_n_labeled_after, n_active):
            done["rounds"] += n_active
            return n_active == K and done["rounds"] < total

        def touchdown(_idx, _nla, n_active, ys, _out_state, wall):
            if n_active == 0:
                return
            rounds_y, labeled_y, acc_y, _picked_y, active_y = ys[:5]
            active_np = active_y.numpy()
            labeled_np = labeled_y.numpy()[active_np]
            dicts = telemetry.stacked_metrics_to_dicts(ys[5], active_np) if len(ys) > 5 else None
            result.extend_from_arrays(
                rounds_y.numpy()[active_np], labeled_np, labeled_np * 0,
                acc_y.numpy()[active_np], total_time=wall / n_active, metrics=dicts)
            if writer is not None:
                for rec in result.records[-len(labeled_np):]:
                    writer.round(round=rec.round, n_labeled=rec.n_labeled,
                                 accuracy=rec.accuracy, **(rec.metrics or {}))

        t0 = time.perf_counter()
        _, stats = run_pipelined(
            state0, dispatch=dispatch, touchdown=touchdown, continue_after=continue_after,
            depth=depth, on_launch=tracker.record, may_dispatch=lambda idx: idx * K < total)
        _sync(dev)
        wall = time.perf_counter() - t0
        if len(result.records) != total:
            raise RuntimeError(f"pipelined drive appended {len(result.records)} rounds, want {total}")
        return wall / total, stats

    serial_spr, serial_stats = drive(1)
    piped_spr, piped_stats = drive(2, writer)
    return {
        "pipeline_depth": 2,
        "pipelined_seconds_per_round": round(piped_spr, 6),
        "pipelined_serial_seconds_per_round": round(serial_spr, 6),
        "pipeline_speedup": round(serial_spr / piped_spr, 3),
        "touchdown_hidden_fraction": round(piped_stats.touchdown_hidden_fraction, 4),
        "overlap_seconds": round(piped_stats.overlap_seconds, 6),
        "pipeline_touchdown_seconds": round(piped_stats.touchdown_seconds, 6),
        "serial_touchdown_hidden_fraction": round(serial_stats.touchdown_hidden_fraction, 4),
    }


def _bench_fused_round(args, dev, pool, pool_y, mask0, binned) -> dict:
    """The round megakernel against the unfused chain: both legs drive the
    production chunk program on identical inputs; the only difference is
    ``fused_round``. Reps of the two legs are interleaved, the speedup is the
    median of per-pair ratios, and each leg reports its best rep."""
    from distributed_active_learning_tpu_torch.runtime import pipeline

    K = args.rounds_per_launch
    end = _end_round(np.iinfo(np.int32).max, dev)
    legs, runs = {}, {}
    for name, fused in (("unfused", False), ("fused", True)):
        chunk_fn, state0, aux, fit_key, tx, ty, _, _ = _chunk_setup(
            args, dev, pool, pool_y, mask0, binned, fused)

        def run(chunk_fn=chunk_fn, state0=state0, aux=aux, fit_key=fit_key, tx=tx, ty=ty):
            _, extras, ys = chunk_fn(binned.codes, state0, aux, fit_key, tx, ty, end)
            pipeline.start_host_copy((extras, ys)).wait()

        runs[name] = run
        _flight("bench_compile", label=f"round/fused_round/{name}")
        legs[name] = {"first_call": _wall(run, dev)}
    reps = 5
    times = {name: [] for name in runs}
    _flight("bench_timing_start", label="round/fused_round/interleaved", iters=reps)
    for _ in range(reps):
        for name, run in runs.items():
            times[name].append(_wall(run, dev))
    _flight("bench_timing_end", label="round/fused_round/interleaved",
            seconds=round(sum(map(sum, times.values())), 4))
    for name in runs:
        legs[name]["seconds_per_round"] = min(times[name]) / K
    speedup = statistics.median(u / f for u, f in zip(times["unfused"], times["fused"]))
    return {
        "fused_round_kernel": args.kernel,
        "fused_scan_seconds_per_round": round(legs["fused"]["seconds_per_round"], 6),
        "unfused_scan_seconds_per_round": round(legs["unfused"]["seconds_per_round"], 6),
        "fused_round_speedup": round(speedup, 3),
        "fused_round_compile_seconds": round(legs["fused"]["first_call"], 4),
    }


def bench_round(args, dev) -> dict:
    """One full AL round: fit + score + select + reveal, with the device fit."""
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.ops import forest_eval, scoring, trees_train
    from distributed_active_learning_tpu_torch.ops.topk import select_bottom_k

    rng = np.random.default_rng(0)
    pool, _, _ = _make_pool(args, rng)
    pool_y = (pool[:, 0] + 0.3 * pool[:, 1] > 0).astype(np.int32)
    n = args.pool
    mask0 = np.zeros(n, dtype=bool)
    mask0[rng.permutation(n)[: args.train_rows]] = True
    pool_dev = torch.from_numpy(pool).to(dev)
    y_dev = torch.from_numpy(pool_y).to(dev)
    mask_dev = torch.from_numpy(mask0).to(dev)
    window = args.window
    binned = trees_train.make_bins(pool_dev, 32)
    budget = 1 << (args.train_rows + window - 1).bit_length()
    key = prng.key(0)

    def fit_heap():
        c, yy, w = trees_train.gather_fit_window(binned.codes, y_dev, mask_dev, budget)
        return trees_train.fit_forest_device(
            c, yy, w, binned.edges, key, n_trees=args.trees, max_depth=args.depth)

    def device_round():
        f, th, v = fit_heap()
        forest = _wrap(trees_train.heap_gemm_forest(f, th, v, args.depth), args.kernel)
        votes = forest_eval.votes(forest, pool_dev)
        scores = scoring.uncertainty_score(
            scoring.VoteFraction(votes.to(torch.float32), forest.n_trees))
        _, idx = select_bottom_k(scores, ~mask_dev, window)
        return mask_dev.index_fill(0, idx, True)

    _flight("bench_compile", label="round/device_round")
    _wall(device_round, dev)  # builds and warms
    round_sec = _median_wall(device_round, args.iters, dev, label="round/device_round")
    round_dev_sec = _median_device(device_round, args.iters, dev)
    fit_sec = _median_wall(fit_heap, args.iters, dev, label="round/fit")
    result = {
        "metric": "al_round_seconds",
        "value": round(round_sec, 6),
        "unit": f"s/round (device fit + score + select, {args.pool} pool, {args.trees} trees)",
        "kernel": args.kernel,
        "round_seconds": round(round_sec, 6),
        "round_device_seconds": round(round_dev_sec, 6),
        "round_time_method": "cuda_events" if dev.type == "cuda" else "host_clock",
        "round_fit_seconds": round(fit_sec, 6),
        "round_score_seconds": round(max(round_sec - fit_sec, 0.0), 6),
    }
    del pool_dev, y_dev, mask_dev
    writer = None
    if args.metrics_out:
        from distributed_active_learning_tpu_torch.runtime.telemetry import MetricsWriter

        writer = MetricsWriter(args.metrics_out)
        writer.meta(bench_mode="round", sizes={k: getattr(args, k) for k in (
            "pool", "features", "trees", "depth", "window", "train_rows", "rounds_per_launch")},
            backend=dev.type, n_devices=1, process_count=1)
    try:
        result.update(_bench_scan_fusion(args, dev, pool, pool_y, mask0, binned, writer=writer))
    finally:
        if writer is not None:
            writer.close()
    gc.collect()  # drop the scan legs' graphs and their memory pools
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result.update(_bench_fused_round(args, dev, pool, pool_y, mask0, binned))
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return result


def bench_variants(args, dev) -> dict:
    from distributed_active_learning_tpu_torch.benches import pallas_variants

    rng = np.random.default_rng(0)
    pool, _, _ = _make_pool(args, rng)
    x = torch.from_numpy(pool).to(dev)
    gf = pallas_variants.fit_bench_forest(
        args.train_rows, args.features, args.trees, args.depth, dev)
    names = (args.variants or pallas_variants.DEFAULT_VARIANTS).split(",")
    rows = pallas_variants.run_sweep(gf, x, names, args.iters)
    best = max(rows, key=lambda r: r["scores_per_second"])
    return {
        "metric": "leaf_variant_scores_per_sec",
        "value": round(best["scores_per_second"], 1),
        "unit": f"scores/s of the fastest variant ({best['variant']}; {args.pool}x{args.features} "
                f"pool, {args.trees} trees, depth {args.depth})",
        "variants": rows,
        "launches": {"forest_leaves_transposed": pallas_variants.transposed_launches,
                     "forest_leaves_segmented": pallas_variants.segmented_launches},
    }


def _lal_regressor(args, dev):
    """The bench's LAL regressor (depth 8): the forest file ``--lal-model``,
    or fitted with scikit-learn from the committed reference-format fixture
    (``lal_trees`` trees, the JAX bench's options)."""
    import os

    if args.lal_model:
        from distributed_active_learning_tpu_torch.models.forest_io import load_forest

        return load_forest(args.lal_model, dev)[0]
    from distributed_active_learning_tpu_torch.models.lal_training import (
        load_or_train_lal_regressor,
    )

    fixture = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
                           "fixtures", "lal_simulatedunbalanced_big.txt")
    return load_or_train_lal_regressor(
        {"lal_trees": args.lal_trees, "lal_depth": 8, "lal_experiments": 20,
         "lal_data_path": fixture}, dev)


def bench_lal(args, dev) -> dict:
    """One LAL query at the reference's scale: a 50-tree depth-8 base forest
    fitted on the device over 100 labeled rows of a ``lal_pool``-row
    checkerboard pool, the five features, the regressor over them (in
    ``--kernel``'s form) and the top-1 pick with its reveal."""
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.config import ForestConfig
    from distributed_active_learning_tpu_torch.ops import forest_eval, trees_pallas, trees_train
    from distributed_active_learning_tpu_torch.ops.topk import select_top_k
    from distributed_active_learning_tpu_torch.runtime import state as state_lib
    from distributed_active_learning_tpu_torch.strategies.lal import lal_features

    lal_forest = forest_eval.for_kernel(_lal_regressor(args, dev), args.kernel)
    rng = np.random.default_rng(0)
    pool_x = rng.uniform(size=(args.lal_pool, 2)).astype(np.float32)
    pool_y = ((pool_x[:, 0] > 0.5) ^ (pool_x[:, 1] > 0.5)).astype(np.int32)
    state = state_lib.set_start_state(
        state_lib.init_pool_state(pool_x, pool_y, prng.key(0), dev), 100)
    base_cfg = ForestConfig(n_trees=50, max_depth=8)

    def lal_query(forest):
        scores = forest_eval.value(lal_forest, lal_features(forest, state))
        _, picked = select_top_k(scores, ~state.labeled_mask, 1)
        return state_lib.reveal(state, picked), scores

    binned = trees_train.make_bins(state.x, base_cfg.max_bins)
    budget = 1 << (127).bit_length()  # 100 labeled rows and headroom
    key = prng.key(1)

    def lal_query_device():
        c, yy, w = trees_train.gather_fit_window(binned.codes, state.oracle_y,
                                                 state.labeled_mask, budget)
        f, th, v = trees_train.fit_forest_device(
            c, yy, w, binned.edges, key, n_trees=base_cfg.n_trees,
            max_depth=base_cfg.max_depth, n_bins=base_cfg.max_bins)
        return lal_query(_wrap(trees_train.heap_gemm_forest(f, th, v, base_cfg.max_depth),
                               args.kernel))

    _wall(lal_query_device, dev)  # builds and warms
    before = trees_pallas.launches
    _wall(lal_query_device, dev)
    k1_launches = trees_pallas.launches - before
    device_sec = _median_wall(lal_query_device, args.iters, dev, label="lal_query_device")
    lal_dev_sec = _median_device(lal_query_device, args.iters, dev)
    out = {
        "metric": "lal_query_seconds",
        "value": device_sec,
        "unit": f"s/query ({args.lal_pool} pool, 50-tree base, {args.lal_trees}-tree "
                f"regressor, device fit, {args.kernel} kernel)",
        "lal_query_seconds": device_sec,
        "lal_query_device_seconds": lal_dev_sec,
        "lal_time_method": "cuda_events" if dev.type == "cuda" else "host_clock",
        "vs_baseline": round(SPARK_LAL_QUERY_SEC / device_sec, 1),
        "vs_baseline_device": round(SPARK_LAL_QUERY_SEC / lal_dev_sec, 1),
        "lal_trees": lal_forest.n_trees,
        "lal_k1_launches_per_query": k1_launches,
        "spark_lal_query_seconds": SPARK_LAL_QUERY_SEC,
    }
    try:
        from distributed_active_learning_tpu_torch.models import forest as forest_lib

        forest_lib.require_sklearn()
    except ImportError as e:
        out["lal_query_seconds_host_fit"] = None
        out["lal_host_fit_skipped"] = str(e)
        return out
    mask_host = state.labeled_mask.cpu().numpy()

    def run_host():
        # The reference's leg: the base forest fitted on the host each query.
        packed = forest_lib.fit_forest_classifier(pool_x[mask_host], pool_y[mask_host], base_cfg)
        return lal_query(forest_eval.for_kernel(packed, args.kernel).to(dev))

    _wall(run_host, dev)
    out["lal_query_seconds_host_fit"] = _median_wall(run_host, args.iters, dev,
                                                     label="lal_query_host_fit")
    return out


def _batched_setup(args, n: int, window: int, rounds: int, K: int, name: str, strategy: str):
    """The sweep and grid modes' pool (normal rows, labels ``x0 + 0.3 x1 >
    0``, a test set of up to 2,048 rows) and base configuration: n_start one
    window, the fit window pinned to cover every round."""
    from distributed_active_learning_tpu_torch.config import (
        DataConfig, ExperimentConfig, ForestConfig, StrategyConfig,
    )
    from distributed_active_learning_tpu_torch.data.datasets import DataBundle

    rng = np.random.default_rng(0)
    pool = rng.normal(size=(n, args.features)).astype(np.float32)
    test = rng.normal(size=(min(n, 2048), args.features)).astype(np.float32)
    bundle = DataBundle(train_x=pool, train_y=(pool[:, 0] + 0.3 * pool[:, 1] > 0).astype(np.int32),
                        test_x=test, test_y=(test[:, 0] + 0.3 * test[:, 1] > 0).astype(np.int32),
                        name=name)
    cfg = ExperimentConfig(
        data=DataConfig(name=name),
        forest=ForestConfig(n_trees=args.trees, max_depth=args.depth, kernel=args.kernel,
                            fit="device",
                            fit_budget=1 << (window + (rounds + 1) * window).bit_length()),
        strategy=StrategyConfig(name=strategy, window_size=window),
        n_start=window, max_rounds=rounds, rounds_per_launch=K, log_every=0,
    )
    return bundle, cfg


def _baseline_skip(args) -> Optional[dict]:
    return {"reason": "no_baseline_flag"} if args.no_baseline else None


def bench_sweep(args, dev) -> dict:
    """E experiments over one shared pool, K rounds, two ways through the
    production drivers: ``run_sweep`` (one launch stream, one CUDA graph a
    chunk, the E forests walked by one stacked K1 launch a pass) against
    the E serial ``run_experiment`` calls (each capturing its own chunk
    graph). Both arms share the bundle; experiments x rounds per second is
    the headline."""
    from distributed_active_learning_tpu_torch.runtime.loop import run_experiment
    from distributed_active_learning_tpu_torch.runtime.sweep import run_sweep

    E, K, n = args.sweep_experiments, args.rounds_per_launch, args.sweep_pool
    window = min(args.window, max(n // (4 * K), 1))
    bundle, cfg = _batched_setup(args, n, window, K, K, "bench_sweep", "uncertainty")
    seeds = list(range(E))
    _flight("bench_timing_start", label="sweep/run_sweep", experiments=E)
    sweep_sec = _wall(lambda: run_sweep(cfg, seeds, bundle=bundle, device=dev), dev)
    _flight("bench_timing_end", label="sweep/run_sweep", seconds=round(sweep_sec, 3))
    er = E * K
    out = {
        "metric": "sweep_experiments_rounds_per_second",
        "value": round(er / sweep_sec, 2),
        "unit": f"experiment-rounds/s ({E} experiments x {K} rounds, {n} pool, {args.trees} "
                f"trees of depth {args.depth}, {args.kernel} kernel, capture included)",
        "sweep_experiments": E,
        "sweep_rounds_per_launch": K,
        "sweep_pool": n,
        "sweep_window": window,
        "sweep_experiments_rounds_per_second": round(er / sweep_sec, 2),
    }
    skip = _baseline_skip(args)
    if skip is None:
        _flight("bench_timing_start", label="sweep/serial_loop", experiments=E)
        serial_sec = _wall(lambda: [run_experiment(dataclasses.replace(cfg, seed=s), bundle=bundle,
                                                   device=dev) for s in seeds], dev)
        _flight("bench_timing_end", label="sweep/serial_loop", seconds=round(serial_sec, 3))
        out["serial_experiments_rounds_per_second"] = round(er / serial_sec, 2)
        out["sweep_speedup"] = round(serial_sec / sweep_sec, 2)
    else:
        out["baseline_skipped"] = out["sweep_baseline_skipped"] = skip
    return out


def bench_grid(args, dev) -> dict:
    """The strategies x seeds grid over one shared pool, 2 chunks of K = 2
    rounds (two launches, so ``recompiles_after_warmup`` means something),
    through ``run_grid`` against the serial S x E ``run_experiment`` loop;
    ``grid_cells_rounds_per_second`` is the headline. Then the JAX bench's
    scenario leg over the same pool (``scenario_*`` keys)."""
    from distributed_active_learning_tpu_torch.runtime.loop import run_experiment
    from distributed_active_learning_tpu_torch.runtime.sweep import run_grid

    strategies = [x.strip() for x in args.grid_strategies.split(",") if x.strip()]
    E, K = args.grid_experiments, 2
    n = args.sweep_pool
    window = min(args.window, max(n // (8 * K), 1))
    rounds = 2 * K
    bundle, cfg = _batched_setup(args, n, window, rounds, K, "bench_grid", strategies[0])
    seeds = list(range(E))
    cells = len(strategies) * E
    _flight("bench_timing_start", label="grid/run_grid", cells=cells)
    t0 = time.perf_counter()
    grid = run_grid(cfg, strategies, seeds, bundles={"bench_grid": bundle}, device=dev)
    _sync(dev)
    grid_sec = time.perf_counter() - t0
    _flight("bench_timing_end", label="grid/run_grid", seconds=round(grid_sec, 3))
    out = {
        "metric": "grid_cells_rounds_per_second",
        "value": round(cells * rounds / grid_sec, 2),
        "unit": f"cell-rounds/s ({len(strategies)} strategies x {E} seeds x {rounds} rounds, "
                f"{n} pool, {args.trees} trees of depth {args.depth}, {args.kernel} kernel, "
                "capture included)",
        "grid_strategies": strategies,
        "grid_seeds": E,
        "grid_cells": cells,
        "grid_rounds_per_launch": K,
        "grid_rounds": rounds,
        "grid_pool": n,
        "grid_window": window,
        "grid_seconds": round(grid_sec, 3),
        "grid_cells_rounds_per_second": round(cells * rounds / grid_sec, 2),
        "grid_launches": grid.launches,
        "recompiles_after_warmup": grid.recompiles_after_warmup,
        "grid_recompiles_after_warmup": grid.recompiles_after_warmup,
        "grid_graph": grid.graph_stats,
    }
    skip = _baseline_skip(args)
    if skip is None:
        _flight("bench_timing_start", label="grid/serial_loop", cells=cells)

        def serial():
            for st in strategies:
                scfg = dataclasses.replace(cfg, strategy=dataclasses.replace(cfg.strategy, name=st))
                for e in seeds:
                    run_experiment(dataclasses.replace(scfg, seed=e), bundle=bundle, device=dev)

        serial_sec = _wall(serial, dev)
        _flight("bench_timing_end", label="grid/serial_loop", seconds=round(serial_sec, 3))
        out["serial_cells_rounds_per_second"] = round(cells * rounds / serial_sec, 2)
        out["grid_speedup"] = round(serial_sec / grid_sec, 2)
    else:
        out["baseline_skipped"] = out["grid_baseline_skipped"] = skip

    # The scenario leg: the JAX bench's axis (none, a noisy oracle, a cost
    # budget, a rare class, drift) x entropy x the seeds, one launch stream;
    # one graph captured for the whole table (recompiles after warm-up 0).
    from distributed_active_learning_tpu_torch.config import ScenarioConfig

    scenario_axis = [
        ScenarioConfig(),
        ScenarioConfig(kind="noisy_oracle", flip_prob=0.1, abstain_prob=0.25),
        ScenarioConfig(kind="cost_budget", cost_budget=2.5 * window),
        ScenarioConfig(kind="rare_event", rare_class=1),
        ScenarioConfig(kind="drift", drift_rate=0.2),
    ]
    scn_cfg = dataclasses.replace(cfg, strategy=dataclasses.replace(cfg.strategy, name="entropy"))
    scn_cells = len(scenario_axis) * E
    _flight("bench_timing_start", label="grid/scenario_axis", cells=scn_cells)
    t0 = time.perf_counter()
    scn_grid = run_grid(scn_cfg, ["entropy"], seeds, scenarios=scenario_axis,
                        bundles={"bench_grid": bundle}, device=dev)
    _sync(dev)
    scn_sec = time.perf_counter() - t0
    _flight("bench_timing_end", label="grid/scenario_axis", seconds=round(scn_sec, 3))
    out.update({
        "scenario_axis": [sc.kind for sc in scenario_axis],
        "scenario_cells": scn_cells,
        "scenario_seconds": round(scn_sec, 3),
        "scenario_cells_rounds_per_second": round(scn_cells * rounds / scn_sec, 2),
        "scenario_launches": scn_grid.launches,
        "scenario_recompiles_after_warmup": scn_grid.recompiles_after_warmup,
        "scenario_graph": scn_grid.graph_stats,
    })
    return out


def bench_neural(args, dev) -> dict:
    """One deep-AL round of configs 4 and 5 (the JAX bench's ``bench_neural``):
    fit ``train_steps`` minibatches, draw the MC samples over the pool, select
    (entropy top-k for the CNN, BatchBALD for the encoder)."""
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.data.synthetic import (
        make_synthetic_images,
        make_synthetic_tokens,
    )
    from distributed_active_learning_tpu_torch.device import deterministic_cuda
    from distributed_active_learning_tpu_torch.models.neural import NeuralLearner, SmallCNN
    from distributed_active_learning_tpu_torch.models.transformer import TransformerClassifier
    from distributed_active_learning_tpu_torch.ops.topk import select_top_k
    from distributed_active_learning_tpu_torch.strategies import deep

    if dev.type == "cuda":
        deterministic_cuda()
    n = args.neural_pool

    def round_seconds(learner, x, y, strat, window):
        n_start = min(args.window, max(1, n // 8))
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        mask[:n_start] = True
        net = learner.init(prng.key(0))

        def run(seed):
            k = prng.key(seed, dev)
            st = learner.fit_on_mask(net, x, y, mask, prng.fold_in(k, 1))
            probs = learner.predict_proba_samples(st, x, prng.fold_in(k, 2))
            if strat == "batchbald":
                return deep.batchbald_select(probs, ~mask, window, 4096, 512)[0]
            return select_top_k(deep.predictive_entropy(probs), ~mask, window)[1]

        run(1)  # builds K7 and warms the allocator
        return _median_device(lambda: run(2), min(args.iters, 3), dev)

    kx, kt = prng.split(prng.key(0, dev))  # the stand-ins drawn where the run is
    ix, iy = make_synthetic_images(kx, n)
    cnn = NeuralLearner(SmallCNN(n_classes=10), (32, 32, 3), train_steps=args.train_steps,
                        mc_samples=args.mc_samples, device=dev)
    cnn_sec = round_seconds(cnn, ix.to(dev), iy.to(dev), "entropy", min(100, max(1, n // 4)))
    tx, ty = make_synthetic_tokens(kt, n)
    enc = NeuralLearner(TransformerClassifier(vocab_size=4096, max_len=64, n_classes=4), (64,),
                        train_steps=args.train_steps, mc_samples=args.mc_samples, device=dev)
    enc_sec = round_seconds(enc, tx.to(dev), ty.to(dev), "batchbald", min(50, max(1, n // 4)))
    return {
        "metric": "neural_round_seconds", "value": round(cnn_sec, 4),
        "unit": (f"s/round (SmallCNN entropy, {n} pool, {args.train_steps} steps, "
                 f"{args.mc_samples} MC)"),
        "neural_pool": n, "train_steps": args.train_steps, "mc_samples": args.mc_samples,
        "cnn_round_seconds": round(cnn_sec, 4),
        "transformer_batchbald_round_seconds": round(enc_sec, 4),
        "time_method": "cuda_events" if dev.type == "cuda" else "host_clock",
    }


_MODES = {"score": bench_score, "density": bench_density, "round": bench_round,
          "variants": bench_variants, "lal": bench_lal, "sweep": bench_sweep, "grid": bench_grid,
          "neural": bench_neural}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_active_learning_tpu_torch.bench",
        description="the PyTorch/CUDA port's bench: one JSON line on stdout",
    )
    ap.add_argument("--mode", choices=sorted(_MODES), default="score")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--pool", type=int, default=None)
    ap.add_argument("--features", type=int, default=30)
    ap.add_argument("--trees", type=int, default=None)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--window", type=int, default=100)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--train-rows", type=int, default=None)
    ap.add_argument("--kernel", choices=["gemm", "pallas", "gather"], default="pallas",
                    help="forest evaluation: pallas (the hand-written CUDA kernels), gemm "
                    "(the plain path-matrix form) or gather (the traversal form; score and "
                    "density modes)")
    ap.add_argument("--rounds-per-launch", type=int, default=None,
                    help="round mode: AL rounds per chunk launch (default 8 on CUDA, 4 under "
                    "--device cpu)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="round mode: append JSONL events of the depth-2 pipelined drive "
                    "(meta, one round event per round with its RoundMetrics, one launch event "
                    "per chunk) for benches/summarize_metrics.py")
    ap.add_argument("--flight-recorder", default=None, metavar="PATH",
                    help="install the launch flight recorder: mode, compile and timing marks and "
                    "the drive's launches in a bounded ring, dumped as one JSON artifact at PATH "
                    "on SIGTERM, SIGUSR1, a crash and a normal exit (default: off)")
    ap.add_argument("--lal-trees", type=int, default=None,
                    help="lal mode: regressor trees when it is fitted here (default 2000 on "
                    "CUDA, 50 under --device cpu)")
    ap.add_argument("--lal-pool", type=int, default=None,
                    help="lal mode: pool rows (default 1000 on CUDA, 200 under --device cpu)")
    ap.add_argument("--lal-model", default=None, metavar="PATH",
                    help="lal mode: the regressor as a forest file (models/forest_io.py); "
                    "without it the regressor is fitted with scikit-learn")
    ap.add_argument("--sweep-experiments", type=int, default=None,
                    help="sweep mode: experiments in the batch (default 8)")
    ap.add_argument("--sweep-pool", type=int, default=None,
                    help="sweep and grid modes: shared pool rows (default 284,807 on CUDA, 500 "
                    "under --device cpu)")
    ap.add_argument("--grid-experiments", type=int, default=None,
                    help="grid mode: seeds per strategy (default 8; cells = strategies x seeds)")
    ap.add_argument("--grid-strategies", default="uncertainty,margin,density", metavar="A,B,...",
                    help="grid mode: the strategy groups of the one launch stream")
    ap.add_argument("--no-baseline", action="store_true",
                    help="sweep and grid modes: skip the serial arm (the speedup denominator); "
                    "baseline_skipped says so")
    ap.add_argument("--neural-pool", type=int, default=None,
                    help="neural mode: pool rows of both configs (default 2,000 on CUDA, 200 "
                    "under --device cpu)")
    ap.add_argument("--train-steps", type=int, default=None,
                    help="neural mode: minibatch steps a round (default 300 on CUDA, 25 under "
                    "--device cpu)")
    ap.add_argument("--mc-samples", type=int, default=8, help="neural mode: MC-dropout samples")
    ap.add_argument("--variants", default=None,
                    help="variants mode: names from benches.pallas_variants.VARIANTS "
                    "(default: its DEFAULT_VARIANTS)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    payload = {"mode": args.mode}
    rc = 0
    from distributed_active_learning_tpu_torch.runtime import telemetry

    if args.flight_recorder:
        telemetry.install_flight_recorder(args.flight_recorder)
        _flight("bench_start", mode=args.mode)
    try:
        from distributed_active_learning_tpu_torch.device import resolve_device

        dev = resolve_device(args.device)
        if args.kernel == "gather" and args.mode not in ("score", "density"):
            raise ValueError(f"--kernel gather is carried by --mode score and density, "
                             f"not by --mode {args.mode}")
        cpu = dev.type == "cpu"
        for name, value in (_CPU_SIZES if cpu else _CUDA_SIZES).items():
            if getattr(args, name) is None:
                setattr(args, name, value)
        payload["device"] = "cpu" if cpu else torch.cuda.get_device_name(dev)
        payload["card"] = card_line(dev)
        payload["cpu_smoke_sizes"] = cpu
        payload["sizes"] = {k: getattr(args, k) for k in
                            ("pool", "features", "trees", "depth", "window", "train_rows", "iters")}
        t0 = time.perf_counter()
        payload.update(_MODES[args.mode](args, dev))
        payload["bench_seconds"] = round(time.perf_counter() - t0, 2)
    except Exception as e:  # the line is printed whatever happened; the exit code says it failed
        payload["metric"] = "bench_failed"
        payload["error"] = f"{type(e).__name__}: {e}"
        rc = 1
    if args.flight_recorder:
        payload["flight_recorder"] = telemetry.flight_dump(
            "exit" if rc == 0 else f"crash:{payload['error'].split(':', 1)[0]}")
    print(json.dumps(payload))
    sys.stdout.flush()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
