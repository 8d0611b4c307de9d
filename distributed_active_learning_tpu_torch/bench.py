"""The port's own bench: one JSON line on stdout, always.

    python -m distributed_active_learning_tpu_torch.bench [--mode all|score|density|round|...]
        [--device cpu] [--kernel pallas|gemm|gather] [--pool N] [--trees T] [--deadline S]
        [--audit] [--profile-dir DIR] [--compare-to BASELINE.json] ...

The counterpart of the repo-root ``bench.py`` (the JAX package's, which stays
as it is) for what the port carries:

- ``--mode score``: votes, uncertainty score and masked bottom-k over the
  pool (``bench_score``). ``value`` is scores per second from device time.
  ``--kernel gather`` scores through the gather form (``ops/trees.py``).
  ``--mesh-data D --mesh-model M`` scores through the mesh, as the JAX
  bench does: the pool padded to the data axis (its padding rows
  unselectable) and sharded over it, the trees over ``model``, every shard
  on the first D x M cards or on ``--mesh-devices``' list; ``kernel`` gains
  ``+meshDxM`` and ``mesh_devices`` counts the shards.
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
  ``fused_round_speedup``). Then the JAX bench's two pod legs, over 1, 2,
  4 and 8 data shards (on as many visible cards, or on the one card
  repeated; the CPU repeated under ``--device cpu``): the pod select
  (``_bench_pod_select``: the round's forest on an (S, 1) mesh at 512 rows
  a shard, one ``fused_score_select`` a leg, K3 on each shard and S - 1 K4
  ring steps; ``pod_select_seconds_by_shards``,
  ``pod_select_points_per_second``, ``pod_select_flat_ratio``; skipped at
  depth > 10) and the pod ingest (``_bench_pod_ingest``: a router-addressed
  64-row append into an S x 512-row slab pool, then one rebalance epoch at
  the largest S after skewing shard 0; ``pod_ingest_seconds_by_shards``,
  ``pod_ingest_points_per_second``, ``pod_rebalance_seconds``).
  ``recompiles_after_warmup`` counts the round chunk graphs' captures after
  the first, with ``pod_recompiles_after_warmup`` and
  ``pod_ingest_recompiles_after_warmup`` folded in, as in the JAX bench:
  the CUDA graphs captured (``runtime.loop.graph_captures``) in each pod
  leg after its warm-up calls (the legs run eagerly, so any is a fault).
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

- ``--mode serve``: the streaming service (``bench_serve``, the JAX
  bench's body and keys): 2,000 queries of 64 against a cold-start pool of
  8,192 x 30 (100 trees of depth 4, uncertainty, window 20, kernel as
  ``--kernel``), an ingest block of 64 every 4th query, the second half
  shifted by 2.5; ``serve_qps``, p50/p99, ``recompiles_after_warmup``
  (must be 0) and the port's p99 split by an in-flight re-fit, K1
  launches, a chunk's wall per round and the graphs' capture seconds and
  pools.
- ``--mode serve-multi``: 4 tenants through the frontend with concurrent
  client threads (``bench_serve_multi``, the JAX bench's body and keys;
  kernel gemm unless ``--kernel gather``): the gates
  ``serve_multi_recompiles_after_warmup`` and
  ``serve_multi_growth_compile_events`` (0), ``serve_multi_growths_
  precompiled`` (>= 1).
- ``--mode serve-fleet``: the shared-nothing fleet (``bench_serve_fleet``,
  the JAX bench's body and keys): 8 tenants behind the consistent-hash
  router on 1, then ``--fleet-workers`` (default 4) spawned worker
  processes on the one device, a closed-loop client at concurrency 1; the
  gates ``serve_fleet_recompiles_after_warmup``, each worker's scraped
  ``dal_recompiles_after_warmup_total`` and
  ``serve_fleet_shared_sig_fallbacks`` (0). Not part of any "all" mode.

- ``--mode all`` (the default, as in the JAX bench): score, density,
  round, sweep, grid, serve, serve-multi, lal and neural in turn, each
  gated on ``--deadline`` (seconds from the start; default the
  ``DAL_BENCH_DEADLINE`` variable, else 420; 0 disables): a mode the
  deadline would cut is skipped and named under ``modes_skipped``, and the
  line lands for what completed: each finished mode's keys are kept as it
  finishes, so a later mode that raises, or a SIGTERM or SIGINT (an outer
  ``timeout``), still prints them beside the ``error``.

The round mode's ``roofline`` section attributes each phase (``fit``,
``round``, ``score_select`` = round - fit, ``chunk`` and ``fused_round``, a
launch of K rounds): the program's counted FLOPs and bytes
(``analysis/roofline.py``, the kernels at their declared work) joined with
its measured seconds into achieved rates, the shares of the card's peaks
(``mfu`` of the bf16 table, ``mfu_f32`` of the float32 one,
``bandwidth_util``) and the bound verdict. ``--audit`` prices the programs
the mode launches before it runs (``analysis/memory.py``; the verdict under
``audit``), ``--profile-dir DIR`` traces the run with ``torch.profiler`` on
the card and adds ``device_seconds_by_phase`` (kernel time under each
``bench/`` range; a trace without device time is an error), and
``--compare-to PATH`` adds the regression sentinel's verdict against a
baseline line (``benches/compare_bench.py``, the port's copy).

Not carried: the score mode's host-fit leg (the bench runs where the card
is, which has no scikit-learn; a host-fit forest would come as a forest
file). ``--kernel gather`` is carried by the score and density modes.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

_CUDA_SIZES = dict(pool=284_807, trees=100, train_rows=5000, iters=10, rounds_per_launch=8,
                   lal_trees=2000, lal_pool=1000, sweep_experiments=8, sweep_pool=284_807,
                   grid_experiments=8, neural_pool=2000, train_steps=300, serve_queries=2000,
                   serve_pool=8192, serve_tenants=4, fleet_workers=4)
_CPU_SIZES = dict(pool=10_000, trees=10, train_rows=500, iters=2, rounds_per_launch=4,
                  lal_trees=50, lal_pool=200, sweep_experiments=8, sweep_pool=500,
                  grid_experiments=8, neural_pool=200, train_steps=25, serve_queries=220,
                  serve_pool=256, serve_tenants=4, fleet_workers=4)
# The reference's one LAL query on Spark (classes/RESULTS.txt), the JAX
# bench's baseline.
SPARK_LAL_QUERY_SEC = 1654.16

# What ``--mode all`` has finished so far, kept as each mode completes, so
# that main() prints it if a later mode raises or a signal ends the run.
_PARTIAL: dict = {}


class BenchInterrupted(BaseException):
    """Raised by the SIGTERM/SIGINT handler, so that an outer ``timeout``
    (which sends SIGTERM before SIGKILL) unwinds through main()'s JSON
    line."""


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
    kernel_used, n_mesh = args.kernel, args.mesh_data * args.mesh_model
    if n_mesh > 1:
        from distributed_active_learning_tpu_torch.ops.trees_pallas import attach_mesh
        from distributed_active_learning_tpu_torch.parallel import make_mesh, shard_forest, shard_rows

        mesh = make_mesh(data=args.mesh_data, model=args.mesh_model, device=dev,
                         devices=args.mesh_devices.split(",") if args.mesh_devices else None)
        forest = attach_mesh(shard_forest(forest, mesh), mesh)
        # The pool padded to the data axis (its padding rows unselectable);
        # throughput counts the real rows only.
        row_pad = (-args.pool) % args.mesh_data
        pool_dev = shard_rows(torch.nn.functional.pad(pool_dev, (0, 0, 0, row_pad)), mesh,
                              replicate=True)
        unlabeled = torch.nn.functional.pad(unlabeled, (0, row_pad))
        kernel_used += f"+mesh{args.mesh_data}x{args.mesh_model}"

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
                f"trees, depth {args.depth}, {kernel_used} kernel)",
        "kernel": kernel_used,
        "device_time_method": "cuda_events" if dev.type == "cuda" else "host_clock",
        "device_seconds_per_query": device_sec,
        "wall_seconds_per_query": round(wall_sec, 6),
        "wall_scores_per_sec": round(args.pool / wall_sec, 1),
        **({"mesh_devices": n_mesh} if n_mesh > 1 else {}),
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
    out["roofline_chunk"] = _roofline_launch(chunk_fn, (binned.codes, state0, aux, fit_key, tx, ty,
                                                        end), chunk_sec * K, K)
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
        if fused:
            fused_inputs = {"fn": chunk_fn,
                            "args": (binned.codes, state0, aux, fit_key, tx, ty, end)}
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
    fused_args = fused_inputs["args"]
    return {
        "roofline_fused_round": _roofline_launch(
            fused_inputs["fn"], fused_args, legs["fused"]["seconds_per_round"] * K, K),
        "fused_round_kernel": args.kernel,
        "fused_scan_seconds_per_round": round(legs["fused"]["seconds_per_round"], 6),
        "unfused_scan_seconds_per_round": round(legs["unfused"]["seconds_per_round"], 6),
        "fused_round_speedup": round(speedup, 3),
        "fused_round_compile_seconds": round(legs["fused"]["first_call"], 4),
    }


def _roofline_launch(chunk_fn, args, seconds: float, K: int) -> dict:
    """The roofline row of one chunk launch (K rounds): the chunk's eager
    body (what its CUDA graph replays) counted on copies of its carry,
    joined with the launch's seconds; an error becomes ``{"error": ...}``."""
    from distributed_active_learning_tpu_torch.analysis import roofline as roofline_lib
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.runtime.pipeline import _map_leaves

    body = getattr(chunk_fn, "_fn", chunk_fn)
    args = list(args)
    args[1] = args[1].replace(**{f: _map_leaves(torch.clone, getattr(args[1], f))
                                 for f in loop.CARRY_FIELDS})
    try:
        attr = roofline_lib.attribute_card(roofline_lib.program_cost(body, *args), seconds)
    except Exception as e:  # noqa: BLE001 — attribution must not kill a bench
        return {"error": f"{type(e).__name__}: {e}"}
    attr["rounds_per_launch"] = K
    attr["time_method"] = "wall_median_per_launch"
    return attr


def _roofline_round(fit_fn, round_fn, fit_sec: float, round_sec: float, score_sec: float,
                    dev) -> dict:
    """The round mode's per-phase roofline table, the JAX bench's: the fit,
    the whole round and the score + select half (round minus fit), each
    naming its time basis."""
    from distributed_active_learning_tpu_torch.analysis import roofline as roofline_lib

    try:
        fit_cost = roofline_lib.program_cost(fit_fn)
        round_cost = roofline_lib.program_cost(round_fn)
    except Exception as e:  # noqa: BLE001 — attribution must not kill a bench
        return {"error": f"{type(e).__name__}: {e}"}
    out = {"fit": roofline_lib.attribute_card(fit_cost, fit_sec),
           "round": roofline_lib.attribute_card(round_cost, round_sec)}
    out["fit"]["time_method"] = "wall_median"
    out["round"]["time_method"] = "cuda_events" if dev.type == "cuda" else "host_clock"
    flops = max(round_cost["flops"] - fit_cost["flops"], 0.0) or None
    nbytes = max(round_cost["bytes_accessed"] - fit_cost["bytes_accessed"], 0.0) or None
    score_cost = {"flops": flops, "bytes_accessed": nbytes,
                  "flops_per_byte": round(flops / nbytes, 4) if flops and nbytes else None}
    out["score_select"] = roofline_lib.attribute_card(score_cost,
                                                      score_sec if score_sec > 0 else None)
    out["score_select"]["derived"] = "round - fit"
    out["score_select"]["time_method"] = "derived_wall"
    return out


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
    roofline = _roofline_round(fit_heap, device_round, fit_sec, round_dev_sec,
                               max(round_sec - fit_sec, 0.0), dev)
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
        # Per-phase roofline attribution (fit / round / score_select, then
        # the chunk and the fused round below).
        "roofline": roofline,
    }
    del pool_dev, y_dev, mask_dev
    writer = None
    if args.metrics_out:
        from distributed_active_learning_tpu_torch.parallel import multihost
        from distributed_active_learning_tpu_torch.runtime.telemetry import MetricsWriter

        writer = MetricsWriter(args.metrics_out)
        writer.meta(bench_mode="round", sizes={k: getattr(args, k) for k in (
            "pool", "features", "trees", "depth", "window", "train_rows", "rounds_per_launch")},
            backend=dev.type, n_devices=1, **multihost.run_meta())
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
    for key, name in (("roofline_chunk", "chunk"), ("roofline_fused_round", "fused_round")):
        attr = result.pop(key, None)
        if attr is not None and isinstance(result["roofline"], dict):
            result["roofline"][name] = attr
    graphs = [result.get(k) for k in ("chunk_graph", "chunk_graph_metrics_off")]
    result["recompiles_after_warmup"] = sum(max(g["captures"] - 1, 0) for g in graphs if g)
    result.update(_bench_pod_select(args, dev, pool, binned, y_host=pool_y, mask0=mask0))
    result.update(_bench_pod_ingest(args, dev, pool, pool_y, mask0, binned))
    # The recompile gate covers every round-mode leg (the JAX bench folds
    # the pod legs' counts in the same way).
    for key in ("pod_recompiles_after_warmup", "pod_ingest_recompiles_after_warmup"):
        if isinstance(result.get(key), int):
            result["recompiles_after_warmup"] += result[key]
    return result


def _pod_devices(dev: torch.device, n_shards: int):
    """The devices of an S-shard pod leg: the first S cards when that many
    are visible, else the one device repeated."""
    if dev.type == "cuda" and torch.cuda.device_count() >= n_shards:
        return [torch.device("cuda", i) for i in range(n_shards)]
    return [dev] * n_shards


def _sync_all(devs) -> None:
    for d in sorted(set(devs), key=str):
        _sync(d)


def _pod_events(args, kind: str, rows) -> None:
    """``--metrics-out``: the pod legs' JSONL events, one a shard count."""
    if not args.metrics_out:
        return
    from distributed_active_learning_tpu_torch.runtime.telemetry import MetricsWriter

    with MetricsWriter(args.metrics_out) as writer:
        for fields in rows:
            writer.event(kind, **fields)


def _bench_pod_select(args, dev, pool, binned, y_host, mask0) -> dict:
    """The pod select (the JAX bench's ``_bench_pod_select``): the round's
    device-fit forest as a ``ShardedPallasForest`` on an (S, 1) mesh for S in
    1, 2, 4, 8, a pool of 512 rows a shard (weak scaling: the pool grows with
    S), and one ``fused_score_select`` a leg: K3 on each shard, the
    per-shard window, S - 1 K4 ring steps. Interleaved reps, the best rep's
    host-clock seconds a leg."""
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.ops import round_fused, trees_train
    from distributed_active_learning_tpu_torch.ops.trees_pallas import PallasForest, attach_mesh
    from distributed_active_learning_tpu_torch.parallel import make_mesh, shard_rows
    from distributed_active_learning_tpu_torch.runtime import loop

    window = args.window
    if args.depth > 10:
        return {"pod_select_skipped": f"depth {args.depth} has no gemm form"}
    budget = 1 << (args.train_rows + window - 1).bit_length()
    y_dev = torch.from_numpy(y_host).to(dev)
    mask_dev = torch.from_numpy(mask0).to(dev)
    c, yy, w = trees_train.gather_fit_window(binned.codes, y_dev, mask_dev, budget)
    f, th, v = trees_train.fit_forest_device(c, yy, w, binned.edges, prng.key(11),
                                             n_trees=args.trees, max_depth=args.depth)
    gf = trees_train.heap_gemm_forest(f, th, v, args.depth)
    del y_dev, mask_dev
    rows = 512
    shard_counts = [1, 2, 4, 8]
    rng = np.random.default_rng(3)
    runs, legs = {}, {}
    for S in shard_counts:
        devs = _pod_devices(dev, S)
        mesh = make_mesh(S, 1, devices=devs, device=dev)
        forest = attach_mesh(PallasForest(gf=gf), mesh)
        n = rows * S
        x_np = np.tile(pool, (-(-n // pool.shape[0]), 1))[:n]
        x = shard_rows(torch.from_numpy(x_np), mesh, replicate=True)
        sel = shard_rows(torch.from_numpy(rng.integers(0, 2, size=n).astype(bool)), mesh)

        def run(forest=forest, x=x, sel=sel, devs=devs):
            round_fused.fused_score_select(forest, x, sel, "uncertainty", window)
            _sync_all(devs)

        runs[S] = run
        _flight("bench_compile", label=f"round/pod_select/s{S}")
        t0 = time.perf_counter()
        run()  # builds and loads the kernels at the first leg
        legs[S] = {"first_call": time.perf_counter() - t0}
    captures0 = loop.graph_captures  # graph captures after the warm-up legs
    reps = 3
    times = {S: [] for S in shard_counts}
    _flight("bench_timing_start", label="round/pod_select/interleaved", iters=reps)
    for _ in range(reps):
        for S, run in runs.items():
            t0 = time.perf_counter()
            run()
            times[S].append(time.perf_counter() - t0)
    _flight("bench_timing_end", label="round/pod_select/interleaved",
            seconds=round(sum(map(sum, times.values())), 4))
    for S in shard_counts:
        legs[S]["seconds"] = min(times[S])
    s_max = shard_counts[-1]
    sec_max = legs[s_max]["seconds"]
    _pod_events(args, "pod_select", [dict(
        shards=S, per_shard_rows=rows, per_shard_candidates=min(window, rows), ring_hops=S - 1,
        select_seconds=round(legs[S]["seconds"], 6),
        points_per_second=round(rows * S / legs[S]["seconds"], 1)) for S in shard_counts])
    return {
        "pod_select_shard_counts": shard_counts,
        "pod_select_per_shard_rows": rows,
        "pod_select_devices": len({d for d in _pod_devices(dev, s_max)}),
        "pod_select_seconds_by_shards": {str(S): round(legs[S]["seconds"], 6)
                                         for S in shard_counts},
        "pod_select_points_per_second": round(rows * s_max / sec_max, 1),
        "pod_select_flat_ratio": round(sec_max / legs[shard_counts[0]]["seconds"], 3),
        "pod_recompiles_after_warmup": loop.graph_captures - captures0,
    }


def _bench_pod_ingest(args, dev, pool, pool_y, mask0, binned) -> dict:
    """The pod ingest (the JAX bench's ``_bench_pod_ingest``): for S in 1, 2,
    4, 8 an S x 512-row slab pool over an (S, 1) mesh, holding 32 start
    rows, and one router-addressed 64-row append a call (the host reads the
    ``[S]`` fills, routes to the least filled shard, the append writes that
    shard's block in place); then, at the largest S, shard 0 skewed with two
    direct appends and one rebalance epoch, its second call timed."""
    from distributed_active_learning_tpu_torch.parallel import make_mesh
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.serving import slab

    rows, block, n0 = 512, 64, 32
    shard_counts = [1, 2, 4, 8]
    rng = np.random.default_rng(5)
    edges = binned.edges

    def _block(i):
        idx = (np.arange(block) + i * 79) % pool.shape[0]
        return (torch.from_numpy(pool[idx]).to(dev),
                torch.from_numpy(rng.integers(0, 2, size=block).astype(np.int32)).to(dev))

    fns, pools, runs, legs, meshes = {}, {}, {}, {}, {}
    for S in shard_counts:
        devs = _pod_devices(dev, S)
        meshes[S] = make_mesh(S, 1, devices=devs, device=dev)
        base = slab.init_slab_pool(pool[:n0], pool_y[:n0], mask0[:n0], edges, slab_rows=rows * S)
        pools[S] = slab.shard_slab_pool(base, meshes[S])
        fns[S] = slab.make_sharded_ingest_fn(meshes[S])

        def run(S=S, devs=devs):
            p = pools[S]
            fills = p.n_filled.cpu().numpy().copy()
            bx, by = _block(int(fills.sum()) // block)
            p, _ = fns[S](p, edges, bx, by, block, slab.route_to_shard(fills))
            _sync_all(devs)
            pools[S] = p

        runs[S] = run
        _flight("bench_compile", label=f"round/pod_ingest/s{S}")
        t0 = time.perf_counter()
        run()
        legs[S] = {"first_call": time.perf_counter() - t0}
    captures0 = loop.graph_captures  # graph captures after the warm-up appends
    reps = 3
    times = {S: [] for S in shard_counts}
    _flight("bench_timing_start", label="round/pod_ingest/interleaved", iters=reps)
    for _ in range(reps):
        for S, run in runs.items():
            t0 = time.perf_counter()
            run()
            times[S].append(time.perf_counter() - t0)
    _flight("bench_timing_end", label="round/pod_ingest/interleaved",
            seconds=round(sum(map(sum, times.values())), 4))
    for S in shard_counts:
        legs[S]["seconds"] = min(times[S])
        legs[S]["fills"] = pools[S].n_filled.cpu().numpy().copy()
    s_max = shard_counts[-1]
    devs = _pod_devices(dev, s_max)
    for i in range(2):
        bx, by = _block(i)
        pools[s_max], _ = fns[s_max](pools[s_max], edges, bx, by, block, 0)
    rebalance = slab.make_rebalance_fn(meshes[s_max], block_rows=block)
    p, _, _ = rebalance(pools[s_max])  # the moving epoch
    _sync_all(devs)
    t0 = time.perf_counter()
    p, _, _ = rebalance(p)
    _sync_all(devs)
    rebalance_sec = time.perf_counter() - t0
    captures = loop.graph_captures - captures0
    fills = p.n_filled.cpu().numpy().copy()
    sec_max = legs[s_max]["seconds"]
    _pod_events(args, "pod_ingest", [dict(
        shards=S, per_shard_rows=rows, block_rows=block,
        ingest_seconds=round(legs[S]["seconds"], 6),
        points_per_second=round(block / legs[S]["seconds"], 1),
        fill_max=int(legs[S]["fills"].max()), fill_min=int(legs[S]["fills"].min()))
        for S in shard_counts])
    _pod_events(args, "rebalance", [dict(
        shards=s_max, per_shard_rows=rows, block_rows=block,
        rebalance_seconds=round(rebalance_sec, 6), fill_max=int(fills.max()),
        fill_min=int(fills.min()))])
    return {
        "pod_ingest_shard_counts": shard_counts,
        "pod_ingest_per_shard_rows": rows,
        "pod_ingest_block_rows": block,
        "pod_ingest_seconds_by_shards": {str(S): round(legs[S]["seconds"], 6)
                                         for S in shard_counts},
        "pod_ingest_points_per_second": round(block / sec_max, 1),
        "pod_ingest_flat_ratio": round(sec_max / legs[shard_counts[0]]["seconds"], 3),
        "pod_ingest_recompiles_after_warmup": captures,
        "pod_rebalance_seconds": round(rebalance_sec, 6),
        "pod_rebalance_fills": [int(f) for f in fills],
    }


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


def _serve_k1_launches() -> int:
    from distributed_active_learning_tpu_torch.ops import trees_pallas

    return trees_pallas.launches


def _sync_stream(dev: torch.device) -> None:
    """Wait for this thread's stream, not the whole device: the serve modes'
    precompile worker may be capturing a graph on a stream of its own."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _split_p99(latencies, inflight) -> dict:
    """p99 (ms) of the queries served beside an in-flight re-fit and of the
    others (None where a side holds no query)."""
    lat, fl = np.asarray(latencies), np.asarray(inflight, dtype=bool)
    return {
        "serve_p99_ms_refit_inflight": (round(float(np.percentile(lat[fl], 99)) * 1e3, 3)
                                        if fl.any() else None),
        "serve_p99_ms_no_refit": (round(float(np.percentile(lat[~fl], 99)) * 1e3, 3)
                                  if (~fl).any() else None),
        "serve_queries_refit_inflight": int(fl.sum()),
    }


def _graph_report(tenants, dev) -> dict:
    """Chunk-graph counts of the tenants' capacities (captures' host seconds
    and private pools) and the allocator's peak reserve."""
    stats = [st for t in tenants for st in t.program_stats()]
    out = {"serve_graphs_captured": len(stats)}
    if stats:
        out["serve_capture_seconds"] = [round(st["capture_seconds"], 4) for st in stats]
        out["serve_graph_pool_mib"] = [round(st["pool_bytes"] / 2**20, 1) for st in stats]
    if dev.type == "cuda":
        out["peak_reserved_mib"] = round(torch.cuda.max_memory_reserved(dev) / 2**20, 1)
    return out


def bench_serve(args, dev) -> dict:
    """The streaming service (``serving/``, the JAX bench's ``bench_serve``
    body and key set): sustained queries/s and p50/p99 scoring latency
    under concurrent ingest, over a stream whose second half is shifted by
    2.5 so the drift monitor's entropy trigger fires for real. Warmup (the
    first score, ingest and a forced re-fit) is reported apart;
    ``recompiles_after_warmup`` must stay 0. Slab growths happen inside the
    timed window, as in production. Beside JAX's keys: p99 with and without
    a re-fit in flight, the K1 launches of the timed window, the most chunk
    graphs the tenant held, the re-fit chunks' time per active round
    (device time on the card), the chunk graphs' capture seconds and
    private pools per capacity, and the peak reserve."""
    out, service, _ = run_serve(args, dev)
    service.manager.close()
    return out


def run_serve(args, dev, depth: int = 4):
    """:func:`bench_serve`'s drive at forest depth ``depth`` (the JAX
    bench's 4); returns ``(line, service, (x0, y0, test_x, test_y))``, the
    service still open, with its cold-start corpus and test set."""
    from distributed_active_learning_tpu_torch.config import (
        ExperimentConfig,
        ForestConfig,
        ServeConfig,
        StrategyConfig,
    )
    from distributed_active_learning_tpu_torch.serving.service import ALService

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)  # the peak reserve of this drive
    rng = np.random.default_rng(0)
    d = args.features
    n0 = args.serve_pool
    queries = args.serve_queries

    def make(n, shift=0.0):
        x = rng.normal(size=(n, d)).astype(np.float32) + shift
        y = (x[:, 0] + 0.3 * x[:, 1] > shift).astype(np.int32)
        return x, y

    x0, y0 = make(n0)
    test_x, test_y = make(min(n0, 1024))
    window = min(args.window, 20)
    serve = ServeConfig(slab_rows=1024, ingest_block=64, score_width=64, refit_rounds=4,
                        drift_entropy_shift=0.15, drift_min_fresh=64, max_staleness=100)
    cfg = ExperimentConfig(
        forest=ForestConfig(n_trees=args.trees, max_depth=depth, kernel=args.kernel, fit="device",
                            fit_budget=serve.slab_rows),
        strategy=StrategyConfig(name="uncertainty", window_size=window),
        n_start=min(20, max(n0 // 8, 4)),
        log_every=0,
    )
    service = ALService(cfg, serve, x0, y0, test_x, test_y, device=dev)
    live_graphs = service.manager.live_graphs
    ingest_every = 4
    n_stream = (queries // ingest_every + 1) * serve.ingest_block
    sx1, sy1 = make(n_stream // 2)
    sx2, sy2 = make(n_stream - n_stream // 2, shift=2.5)
    stream_x = np.concatenate([sx1, sx2])
    stream_y = np.concatenate([sy1, sy2])
    test_shift_x, _ = make(min(n0, 1024), shift=2.5)

    t0 = time.perf_counter()
    service.score(test_x[: serve.score_width])
    service.submit(stream_x[: serve.ingest_block], stream_y[: serve.ingest_block])
    service.refit_now("warmup")
    service.flush()
    _sync_stream(dev)
    warmup_sec = time.perf_counter() - t0

    stream_pos = serve.ingest_block
    latencies, inflight = [], []
    max_graphs = live_graphs()["default"]
    k1_before = _serve_k1_launches()
    t0 = time.perf_counter()
    for i in range(queries):
        if i % ingest_every == 0 and stream_pos < stream_x.shape[0]:
            hi = stream_pos + serve.ingest_block
            service.submit(stream_x[stream_pos:hi], stream_y[stream_pos:hi])
            stream_pos = hi
            max_graphs = max(max_graphs, live_graphs()["default"])
        src = test_x if i < queries // 2 else test_shift_x
        idx = rng.integers(0, src.shape[0], size=serve.score_width)
        tq = time.perf_counter()
        service.score(src[idx])
        latencies.append(time.perf_counter() - tq)
        inflight.append(service._tenant.last_query_inflight)
    service.flush()
    _sync_stream(dev)
    wall = time.perf_counter() - t0
    k1_window = _serve_k1_launches() - k1_before

    lat = np.asarray(latencies)
    summary = service.summary()
    out = {
        "metric": "serve_qps", "value": round(queries / wall, 2),
        "unit": f"score queries/s ({queries} queries of {serve.score_width} under ingest)",
        "serve_qps": round(queries / wall, 2),
        "serve_queries": queries,
        "serve_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
        "serve_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
        "serve_scores_per_sec": round(queries * serve.score_width / wall, 1),
        "ingest_points_per_sec": round((summary["ingested_points"] - serve.ingest_block) / wall, 1),
        "serve_warmup_seconds": round(warmup_sec, 3),
        "recompiles_after_warmup": summary["recompiles_after_warmup"],
        "refits": summary["refits"],
        "refit_rounds": summary["refit_rounds"],
        "refit_reasons": summary["refit_reasons"],
        "slab_growths": summary["slab_growths"],
        "slab_capacity": summary["capacity"],
        "pool_fill": summary["fill"],
        "pool_labeled": summary["labeled"],
        **_split_p99(latencies, inflight),
        "serve_k1_launches": k1_window,
        "serve_growths_precompiled": service.stats.growths_precompiled,
        "serve_latency_causes": dict(service._tenant.cause_counts),
        "serve_kernel": args.kernel,
        "serve_depth": depth,
        "serve_max_live_graphs": max_graphs,
    }
    # The re-fit chunks' own time (device time on the card), per active round.
    rounds = sum(n for n, _ in service._tenant.chunk_seconds)
    if rounds:
        out["refit_chunk_seconds_per_round"] = round(
            sum(sec for _, sec in service._tenant.chunk_seconds) / rounds, 6)
    out.update(_graph_report([service._tenant], dev))
    return out, service, (x0, y0, test_x, test_y)


def bench_serve_multi(args, dev) -> dict:
    """Multi-tenant serving (the JAX bench's ``bench_serve_multi`` body and
    key set): ``--serve-tenants`` tenants of one forest configuration under
    mixed ingest and re-fit load, driven by concurrent client threads
    through the frontend (``serving/frontend.py``), with the ops plane
    served on ``--ops-port`` (ephemeral when unset) and scraped on
    localhost while the clients contend. Warmup waits for the cold start's
    precompiles, runs a grouped score, an ingest block a tenant and a
    batched re-fit, and waits out the background precompiles; the gates are ``recompiles_after_warmup == 0``
    (graph recaptures, and captures on the request path after warmup) and
    ``serve_multi_growth_compile_events == 0`` (no post-warmup query paid
    for a growth whose next capacity was not precompiled). The kernel is
    gemm or gather, as the JAX bench forces (a pallas tenant scores
    per-tenant, named)."""
    import threading
    import urllib.request

    from distributed_active_learning_tpu_torch.config import (
        ExperimentConfig,
        ForestConfig,
        ServeConfig,
        StrategyConfig,
    )
    from distributed_active_learning_tpu_torch.runtime.obs import OpsServer
    from distributed_active_learning_tpu_torch.serving.frontend import (
        AdmissionError,
        ServiceFrontend,
    )
    from distributed_active_learning_tpu_torch.serving.tenants import TenantManager

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)  # the peak reserve of this drive
    d = args.features
    n0 = args.serve_pool
    T = max(int(args.serve_tenants), 2)
    per_tenant_queries = max(args.serve_queries // T, 40)
    kernel = args.kernel if args.kernel in ("gemm", "gather") else "gemm"
    window = min(args.window, 20)
    serve = ServeConfig(
        slab_rows=1024, ingest_block=64, score_width=64, refit_rounds=4,
        drift_entropy_shift=0.15, drift_min_fresh=64, max_staleness=100,
        precompile_ahead=True, precompile_headroom_slabs=1.0,
        max_pending=max(per_tenant_queries, 64),
        slo_latency_ms=10_000.0, slo_target=0.95,
    )
    # The primary binds (run.py's --ops-port contract): in a multi-process
    # job every rank runs this body, and N ranks binding one port collide.
    from distributed_active_learning_tpu_torch.parallel import multihost

    ops_server = OpsServer(port=args.ops_port or 0).start() if multihost.is_primary() else None

    def make(n, shift=0.0, seed_off=0):
        r = np.random.default_rng(seed_off)
        x = r.normal(size=(n, d)).astype(np.float32) + shift
        y = (x[:, 0] + 0.3 * x[:, 1] > shift).astype(np.int32)
        return x, y

    manager = TenantManager(device=dev)
    tids = [f"t{i}" for i in range(T)]
    data = {}
    ingest_every = 4
    n_stream = (per_tenant_queries // ingest_every + 1) * serve.ingest_block
    for i, tid in enumerate(tids):
        shift = 0.4 * i
        x0, y0 = make(n0, shift, seed_off=10 + i)
        test_x, test_y = make(min(n0, 1024), shift, seed_off=40 + i)
        cfg = ExperimentConfig(
            forest=ForestConfig(n_trees=args.trees, max_depth=4, kernel=kernel, fit="device",
                                fit_budget=serve.slab_rows),
            strategy=StrategyConfig(name="uncertainty", window_size=window),
            n_start=min(20, max(n0 // 8, 4)),
            log_every=0,
            seed=i,
        )
        manager.add_tenant(tid, cfg, serve, x0, y0, test_x, test_y)
        sx1, sy1 = make(n_stream // 2, shift, seed_off=70 + i)
        sx2, sy2 = make(n_stream - n_stream // 2, shift + 2.5, seed_off=100 + i)
        shifted_x, _ = make(min(n0, 1024), shift + 2.5, seed_off=130 + i)
        data[tid] = {"test_x": test_x, "shift_x": shifted_x,
                     "stream_x": np.concatenate([sx1, sx2]),
                     "stream_y": np.concatenate([sy1, sy2])}

    t0 = time.perf_counter()
    # The cold start scheduled each tenant's next capacity, and the warmup's
    # first ingest block grows into it: the warmup waits for those sets
    # first. A growth that finds none leaves its slab_growth_compile cause
    # pending for the next query, here the first measured one (the
    # counter's meaning in both packages).
    manager.wait_precompiles(timeout=300)
    manager.score_many({tid: data[tid]["test_x"][: serve.score_width] for tid in tids})
    for tid in tids:
        manager.submit(tid, data[tid]["stream_x"][: serve.ingest_block],
                       data[tid]["stream_y"][: serve.ingest_block])
    manager.refit_now("warmup")
    manager.flush()
    manager.wait_precompiles(timeout=300)
    manager.mark_warmup_complete()
    _sync_stream(dev)
    warmup_sec = time.perf_counter() - t0

    latencies = {tid: [] for tid in tids}
    ingest_futures = []
    admission_rejections = [0]
    frontend = ServiceFrontend(manager)
    scrapes = [0]
    stop_scrape = threading.Event()

    def scraper():
        if ops_server is None:
            return
        base = f"http://127.0.0.1:{ops_server.port}"
        while not stop_scrape.is_set():
            try:
                with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
                    r.read()
                with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
                    r.read()
                scrapes[0] += 1
            except Exception:  # noqa: BLE001 — a missed scrape is a count, not a crash
                pass
            stop_scrape.wait(0.25)

    def client(tid):
        r = np.random.default_rng(1000 + tids.index(tid))
        stream_pos = serve.ingest_block
        dt = data[tid]
        for q in range(per_tenant_queries):
            if q % ingest_every == 0 and stream_pos < dt["stream_x"].shape[0]:
                hi = stream_pos + serve.ingest_block
                try:
                    ingest_futures.append(frontend.submit_ingest(
                        tid, dt["stream_x"][stream_pos:hi], dt["stream_y"][stream_pos:hi]))
                    stream_pos = hi
                except AdmissionError:
                    admission_rejections[0] += 1
            src = dt["test_x"] if q < per_tenant_queries // 2 else dt["shift_x"]
            idx = r.integers(0, src.shape[0], size=serve.score_width)
            tq = time.perf_counter()
            frontend.score(tid, src[idx])
            latencies[tid].append(time.perf_counter() - tq)

    t0 = time.perf_counter()
    scrape_thread = threading.Thread(target=scraper, name="ops-scraper", daemon=True)
    scrape_thread.start()
    with frontend:
        threads = [threading.Thread(target=client, args=(tid,), name=f"client-{tid}")
                   for tid in tids]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    stop_scrape.set()
    scrape_thread.join(timeout=10)
    manager.flush()
    _sync_stream(dev)
    wall = time.perf_counter() - t0
    ingest_failed = sum(1 for f in ingest_futures if f.exception() is not None)

    summary = manager.summary()
    all_lat = np.concatenate([np.asarray(latencies[tid]) for tid in tids])
    per_p50 = {tid: round(float(np.percentile(latencies[tid], 50)) * 1e3, 3) for tid in tids}
    per_p99 = {tid: round(float(np.percentile(latencies[tid], 99)) * 1e3, 3) for tid in tids}
    total_queries = T * per_tenant_queries
    graphs = _graph_report([manager.tenant(tid) for tid in tids], dev)
    live = manager.live_graphs()
    manager.close()
    if ops_server is not None:
        ops_server.stop()
    slo = summary.get("slo") or {}
    if slo.get("compliance") is None:
        raise RuntimeError(
            "serve-multi SLO accounting produced no compliance ratio "
            f"(slo summary: {slo!r}) despite configured objectives and "
            f"{total_queries} served queries")
    return {
        "metric": "serve_multi_qps", "value": round(total_queries / wall, 2),
        "unit": f"score queries/s over {T} tenants (frontend, concurrent clients)",
        "serve_multi_qps": round(total_queries / wall, 2),
        "serve_multi_tenants": T,
        "serve_multi_queries": total_queries,
        "serve_multi_p50_ms": round(float(np.percentile(all_lat, 50)) * 1e3, 3),
        "serve_multi_p99_ms": round(float(np.percentile(all_lat, 99)) * 1e3, 3),
        "serve_multi_tenant_p50_ms": per_p50,
        "serve_multi_tenant_p99_ms": per_p99,
        "serve_multi_worst_tenant_p99_ms": max(per_p99.values()),
        "serve_multi_scores_per_sec": round(total_queries * serve.score_width / wall, 1),
        "serve_multi_ingest_points_per_sec": round(
            (summary["ingested_points"] - T * serve.ingest_block) / wall, 1),
        "serve_multi_warmup_seconds": round(warmup_sec, 3),
        "serve_multi_batched_score_launches": summary["batched_score_launches"],
        "serve_multi_batched_refit_launches": summary["batched_refit_launches"],
        "serve_multi_score_fallback_reasons": summary["score_fallback_reasons"],
        "serve_multi_refits": summary["refits"],
        "serve_multi_refit_rounds": summary["refit_rounds"],
        "serve_multi_slab_growths": summary["slab_growths"],
        "serve_multi_growths_precompiled": summary["growths_precompiled"],
        "serve_multi_precompiles": summary["precompiles"],
        "serve_multi_precompile_errors": summary["precompile_errors"],
        "recompiles_after_warmup": summary["recompiles_after_warmup"],
        "serve_multi_recompiles_after_warmup": summary["recompiles_after_warmup"],
        "serve_multi_growth_compile_events": summary["post_warmup_growth_compile_events"],
        "serve_multi_admission_rejections": admission_rejections[0],
        "serve_multi_ingest_failures": ingest_failed,
        "slo_compliance": slo.get("compliance"),
        "serve_multi_slo_per_tenant": {tid: snap.get("compliance")
                                       for tid, snap in slo.get("per_tenant", {}).items()},
        "ops_scrapes": scrapes[0],
        "ops_port": ops_server.port if ops_server is not None else None,
        "serve_multi_tenant_summaries": {
            tid: {k: summary["per_tenant"][tid][k]
                  for k in ("queries", "ingested_points", "refits", "slab_growths",
                            "growths_precompiled", "fill", "capacity", "labeled",
                            "latency_causes")}
            for tid in tids
        },
        "serve_multi_kernel": kernel,
        "serve_multi_live_graphs": live,
        **graphs,
    }


def _fleet_device(dev: torch.device) -> str:
    """The fleet workers' device, as the string that crosses the spawn
    boundary."""
    return "cpu" if dev.type == "cpu" else str(dev)


def bench_serve_fleet(args, dev) -> dict:
    """The shared-nothing fleet's scaling leg (the JAX bench's
    ``bench_serve_fleet`` body and key set): 8 tenants ``u0..u7`` behind the
    consistent-hash router (``serving/fleet.py``), first on 1 worker process,
    then on ``--fleet-workers`` (default 4), all on ``dev``, driven over the
    binary keep-alive score path by a closed-loop concurrency-1 client,
    round-robin over the tenants. A grouped score replays every member's
    graphed endpoint, absent members included, so 1 worker pays 8 replays a
    request and each of 4 workers 2. The hard zeros: every worker's
    ``recompiles_after_warmup`` (the in-process tally, and
    ``dal_recompiles_after_warmup_total`` scraped from each worker's own
    ``/metrics``) and ``serve_fleet_shared_sig_fallbacks``. ``--ops-port``
    pins the router port of the largest leg; ``--fleet-linger`` holds that
    leg up after its traffic for an external scraper. Beside the JAX keys,
    ``serve_fleet_by_workers`` holds each leg's queries served, client
    p50, scraped recompiles and routing counters, and each worker's own
    p50/p99 (its frontend's time, without the two HTTP hops), peak reserved
    device memory, kernel launches since warmup, seconds from spawn to ready
    and its boot's split. Not part of any "all"
    mode: each leg spawns N + 1 interpreters."""
    import re as re_lib
    import urllib.request

    from distributed_active_learning_tpu_torch.runtime import telemetry
    from distributed_active_learning_tpu_torch.serving.fleet import Fleet, TenantSpec

    d = args.features
    T = 8
    tids = [f"u{i}" for i in range(T)]
    max_workers = max(int(args.fleet_workers or 4), 1)
    worker_counts = sorted({1, max_workers})
    per_tenant_queries = max(args.serve_queries // T, 40)
    total_queries = T * per_tenant_queries
    # The grouped path needs a stackable eval form (a pallas tenant scores
    # per tenant, named): the JAX bench's rule.
    kernel = args.kernel if args.kernel in ("gemm", "gather") else "gemm"
    pool_rows = min(args.serve_pool, 256)
    score_width = 128
    n_trees = 24
    specs = [TenantSpec(tenant_id=tid, features=d, pool_rows=pool_rows, shift=0.4 * i,
                        seed=10 + i, n_trees=n_trees, max_depth=6, kernel=kernel,
                        slab_rows=pool_rows, score_width=score_width)
             for i, tid in enumerate(tids)]

    legs = {}
    for n in worker_counts:
        router_port = (args.ops_port or 0) if n == max_workers else 0
        fleet = Fleet(specs, n_workers=n, router_port=router_port, device=_fleet_device(dev))
        t0 = time.perf_counter()
        fleet.start()
        warmup_sec = time.perf_counter() - t0
        _flight("serve_fleet_leg_start", workers=n, router_port=fleet.router_port)
        try:
            # Closed loop, concurrency 1, round-robin: each request's latency
            # is its service time, so qps reads what each topology charges a
            # request.
            latencies = {tid: [] for tid in tids}
            rngs = {tid: np.random.default_rng(500 + i) for i, tid in enumerate(tids)}
            queries_by_tid = {
                tid: [(rngs[tid].normal(size=(score_width, d)) + 0.4 * i).astype(np.float32)
                      for _ in range(per_tenant_queries)]
                for i, tid in enumerate(tids)}
            t0 = time.perf_counter()
            for k in range(per_tenant_queries):
                for tid in tids:
                    t1 = time.perf_counter()
                    fleet.score(tid, queries_by_tid[tid][k])
                    latencies[tid].append(time.perf_counter() - t1)
            wall = time.perf_counter() - t0
            # The per-worker gate reads each worker's OWN /metrics over HTTP.
            worker_recompile_metric = {}
            for wid in fleet.worker_ids:
                m = re_lib.search(r"^dal_recompiles_after_warmup_total (\d+)$",
                                  fleet.worker_metrics(wid), re_lib.M)
                worker_recompile_metric[wid] = int(m.group(1)) if m else None
            base = f"http://127.0.0.1:{fleet.router_port}"
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                agg = r.read().decode()
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                health_ok = r.status == 200
            agg_ok = all(f'worker="{wid}"' in agg for wid in fleet.worker_ids)
            linger = float(args.fleet_linger or 0)
            if n == max_workers and linger > 0:
                time.sleep(linger)  # an external scraper's window
        finally:
            final = fleet.stop()
        legs[n] = {
            "qps": round(total_queries / wall, 2),
            "wall": wall,
            "warmup": round(warmup_sec, 3),
            "final": final,
            "served": sum(f.get("queries", 0) for f in final["workers"].values()),
            "worker_recompile_metric": worker_recompile_metric,
            "agg_ok": agg_ok,
            "health_ok": health_ok,
            "router_port": fleet.router_port,
            "ready_seconds": fleet.ready_seconds,
            "latencies": latencies,
        }

    big = legs[max_workers]
    workers_final = big["final"]["workers"]
    ratio = (round(big["qps"] / legs[1]["qps"], 3)
             if len(worker_counts) > 1 and legs[1]["qps"] > 0 else None)
    total_recompiles = sum(f.get("recompiles_after_warmup", 0)
                           for leg in legs.values() for f in leg["final"]["workers"].values())
    merged_fallbacks = {}
    shared_sig_fallbacks = 0
    for f in workers_final.values():
        for reason, cnt in f.get("score_fallback_reasons", {}).items():
            merged_fallbacks[reason] = merged_fallbacks.get(reason, 0) + cnt
        # every spec shares one signature: a worker hosting >= 2 tenants
        # must hold them all in one group
        if len(f.get("tenants", [])) >= 2:
            shared_sig_fallbacks += sum(f.get("score_fallback_reasons", {}).values())
    def _pct_of(latencies, q):
        lat = sorted(v for per in latencies.values() for v in per)
        return round(lat[min(int(q * len(lat)), len(lat) - 1)] * 1e3, 3)

    def _pct(q):
        return _pct_of(big["latencies"], q)

    if args.metrics_out:
        writer = telemetry.MetricsWriter(args.metrics_out)
        for wid, f in sorted(workers_final.items()):
            writer.event("fleet_worker", worker=wid, workers=max_workers,
                         tenants=len(f.get("tenants", [])),
                         qps=round(f.get("queries", 0) / big["wall"], 2), p99_ms=f.get("p99_ms"),
                         groups=len(f.get("score_groups", [])),
                         fallbacks=sum(f.get("score_fallback_reasons", {}).values()))
        writer.close()

    router = big["final"]["router"] or {}
    return {
        "metric": "serve_fleet_qps",
        "value": big["qps"],
        "unit": (f"score queries/s through the consistent-hash router across {max_workers} "
                 f"worker processes ({T} tenants, {total_queries} queries)"),
        "serve_fleet_qps": big["qps"],
        "serve_fleet_workers": max_workers,
        "serve_fleet_worker_counts": worker_counts,
        "serve_fleet_tenants": T,
        "serve_fleet_queries": total_queries,
        "serve_fleet_queries_served": big["served"],
        "serve_fleet_qps_by_workers": {str(n): legs[n]["qps"] for n in worker_counts},
        "fleet_qps_scaling_ratio": ratio,
        "serve_fleet_p50_ms": _pct(0.50),
        "serve_fleet_p99_ms": _pct(0.99),
        "serve_fleet_warmup_seconds_by_workers": {str(n): legs[n]["warmup"]
                                                  for n in worker_counts},
        "serve_fleet_recompiles_after_warmup": total_recompiles,
        "serve_fleet_worker_recompiles": {wid: f.get("recompiles_after_warmup")
                                          for wid, f in sorted(workers_final.items())},
        "serve_fleet_worker_recompile_metric": big["worker_recompile_metric"],
        "serve_fleet_score_fallback_reasons": merged_fallbacks,
        "serve_fleet_shared_sig_fallbacks": shared_sig_fallbacks,
        "serve_fleet_groups": {wid: f.get("score_groups", [])
                               for wid, f in sorted(workers_final.items())},
        "serve_fleet_group_count": sum(len(f.get("score_groups", []))
                                       for f in workers_final.values()),
        "serve_fleet_batched_score_launches": sum(f.get("batched_score_launches", 0)
                                                  for f in workers_final.values()),
        "serve_fleet_router": big["final"]["router"],
        "serve_fleet_rerouted": router.get("rerouted"),
        "serve_fleet_unroutable": router.get("unroutable"),
        "serve_fleet_router_metrics_aggregated": big["agg_ok"],
        "serve_fleet_router_healthy": big["health_ok"],
        "ops_port": big["router_port"],
        # Beside the JAX keys, each leg's own gates and numbers.
        "serve_fleet_by_workers": {str(n): {
            "served": legs[n]["served"],
            "p50_ms": _pct_of(legs[n]["latencies"], 0.50),
            "worker_recompile_metric": legs[n]["worker_recompile_metric"],
            "router": legs[n]["final"]["router"],
            "workers": {wid: {**{k: f.get(k) for k in ("p50_ms", "p99_ms", "peak_reserved_mib",
                                                       "kernel_launches", "boot_seconds")},
                              "ready_seconds": legs[n]["ready_seconds"].get(wid)}
                        for wid, f in sorted(legs[n]["final"]["workers"].items())},
        } for n in worker_counts},
        "serve_fleet_kernel": kernel,
    }


_MODES = {"score": bench_score, "density": bench_density, "round": bench_round,
          "variants": bench_variants, "lal": bench_lal, "sweep": bench_sweep, "grid": bench_grid,
          "neural": bench_neural, "serve": bench_serve, "serve-multi": bench_serve_multi,
          "serve-fleet": bench_serve_fleet}

#: ``--mode all``: the JAX bench's set and order of modes.
ALL_MODES = ("score", "density", "round", "sweep", "grid", "serve", "serve-multi", "lal",
             "neural")

#: Rough wall seconds of each mode at the CPU smoke sizes (the JAX bench's
#: table): under ``--mode all`` a mode that cannot finish inside the
#: ``--deadline`` is skipped up front on the CPU. On the card the modes
#: take seconds at the bench width, so only the deadline itself skips.
_CPU_COST = {"score": 30, "density": 25, "round": 380, "sweep": 90, "grid": 170, "serve": 120,
             "serve-multi": 180, "lal": 30, "neural": 260}


def bench_all(args, dev) -> dict:
    """``--mode all``: the JAX bench's modes one after another, each gated
    on ``--deadline`` (seconds from the bench's start): a mode the deadline
    would cut is skipped and recorded under ``modes_skipped`` (mode, reason,
    seconds elapsed at the skip), so the line always lands for whatever
    completed. The first completed mode's ``metric`` and ``value`` head the
    line; every mode's keys are merged in, and ``modes`` keeps each one's
    headline."""
    t0, deadline = args._start_time, args.deadline
    skipped, heads = [], {}
    _PARTIAL.clear()
    out = _PARTIAL
    out["modes"] = heads
    for mode in ALL_MODES:
        elapsed = time.perf_counter() - t0
        est = _CPU_COST[mode] if dev.type == "cpu" else 0
        if deadline and elapsed + est > deadline:
            entry = {"mode": mode,
                     "reason": "deadline_exceeded" if elapsed > deadline else "predicted_overrun",
                     "elapsed_at_skip_seconds": round(elapsed, 2), "deadline_seconds": deadline}
            if entry["reason"] == "predicted_overrun":
                entry["estimated_mode_seconds"] = est
            skipped.append(entry)
            out["modes_skipped"] = skipped
            _flight("bench_mode_skip", **entry)
            continue
        with torch.profiler.record_function(f"bench/{mode}"):  # --profile-dir's phases
            r = _MODES[mode](args, dev)
        heads[mode] = {k: r.get(k) for k in ("metric", "value", "unit")}
        for k in ("metric", "value", "unit"):
            out.setdefault(k, r.get(k))
        out.update({k: v for k, v in r.items() if k not in ("metric", "value", "unit")})
    if "metric" not in out:
        out.update(metric="none_completed_before_deadline", value=None)
    return dict(out)


_MODES["all"] = bench_all


def _profiled(args, dev, run) -> dict:
    """``--profile-dir``: ``run()`` under ``torch.profiler`` on the card,
    the trace written to the directory, and the device time of the kernels
    under each ``bench/`` range as ``device_seconds_by_phase``. The
    profiler's CUPTI path must give device time: a trace without any is an
    error, never zeros or another clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributed_active_learning_tpu_torch.runtime import telemetry

    if dev.type != "cuda":
        raise ValueError("--profile-dir times the card's kernels (device_seconds_by_phase); "
                         "the CPU has no device time")
    telemetry.prepare_profile_dir(args.profile_dir)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(f"bench/{args.mode}"):
            payload = run()
        torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(args.profile_dir, f"bench_trace_{os.getpid()}.json"))
    events = prof.key_averages()
    total = sum(_device_us(e, "self_") for e in events
                if e.device_type == DeviceType.CUDA and not e.key.startswith(_RANGES))
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time on this machine (its CUPTI "
                           "tracing gave no kernel rows): device_seconds_by_phase cannot be "
                           "measured here; time with CUDA events instead")
    # A host range's device time is the kernels launched inside it.
    payload["device_seconds_by_phase"] = {
        e.key: round(_device_us(e) / 1e6, 6) for e in events
        if e.device_type == DeviceType.CPU and e.key.startswith(_RANGES)}
    payload["device_seconds_total"] = round(total / 1e6, 6)
    return payload


_RANGES = ("bench/", "al_phase/")


def _device_us(event, prefix: str = "") -> float:
    """A profiler row's device microseconds (``self_`` for its own)."""
    value = getattr(event, f"{prefix}device_time_total", None)
    if value is None:
        value = getattr(event, f"{prefix}cuda_time_total", 0.0)
    return float(value)


def _audit(args, dev) -> dict:
    """``--audit``: the pre-flight of ``run.py --audit`` over the programs
    the selected modes launch, each family at its own sizes (the round's
    chunk at the bench pool, the sweep's at ``--sweep-pool``, the neural
    chunk at ``--neural-pool``, the service's at ``--serve-pool``), on the
    meta device before any mode runs: the program auditor
    (``analysis/auditor.py``), the recompile-hazard lint
    (``analysis/lint.py``) and the memory pre-flight
    (``analysis/memory.py``). An error finding raises (the line still
    prints, carrying the error); the verdict, its counts and the ``memory``
    section ride the line under ``audit``."""
    import dataclasses as dc

    from distributed_active_learning_tpu_torch import analysis
    from distributed_active_learning_tpu_torch.analysis import memory as memory_lib
    from distributed_active_learning_tpu_torch.analysis import programs as programs_lib

    modes = ALL_MODES if args.mode == "all" else (args.mode,)
    cfg = dc.replace(programs_lib.BENCH_CONFIG,
                     forest=dc.replace(programs_lib.BENCH_CONFIG.forest, n_trees=args.trees,
                                       max_depth=args.depth, kernel=args.kernel),
                     strategy=dc.replace(programs_lib.BENCH_CONFIG.strategy,
                                         window_size=args.window),
                     n_start=args.train_rows, rounds_per_launch=args.rounds_per_launch)
    specs = []
    for mode, rows in (("round", args.pool), ("sweep", args.sweep_pool),
                       ("grid", args.sweep_pool)):
        if mode in modes or (mode == "round" and any(m in modes for m in ("score", "density"))):
            shapes = programs_lib.ForestShapes(rows, args.features, min(rows, 2048))
            specs += [dc.replace(spec, name=f"{mode}:{spec.name}") for spec in
                      programs_lib.specs_for_experiment(cfg, shapes, kinds=("chunk",))]
    if "neural" in modes:
        specs.append(programs_lib.ProgramSpec(
            "neural:neural_chunk/deep.entropy/cnn", "neural_chunk",
            programs_lib.neural_chunk_program(programs_lib.NeuralShapes(
                "cnn", (32, 32, 3), args.neural_pool, max(500, args.neural_pool // 5), 10,
                train_steps=args.train_steps, mc_samples=args.mc_samples))))
    if any(m in modes for m in ("serve", "serve-multi", "serve-fleet")):
        for kind in ("serve_score", "serve_chunk"):
            specs.append(programs_lib.ProgramSpec(
                f"serve:{kind}/{args.serve_pool}", kind, programs_lib.serve_program(
                    kind, programs_lib.serve_config(4), programs_lib.SERVE_CONFIG,
                    -(-args.serve_pool // 1024) * 1024, args.features, 2048)))
    budget = memory_lib.budget_from_env_or()
    report, table = analysis.preflight(specs, budget)
    memory = memory_lib.memory_section(
        table, [f for f in report.findings if f.rule in memory_lib.MEMORY_RULES], budget)
    if report.gate("error"):
        print(report.render_table(), file=sys.stderr)
        raise RuntimeError(f"pre-flight failed before benching: {report.counts()} (findings "
                           "on stderr; reproduce with `python -m "
                           "distributed_active_learning_tpu_torch.analysis` and `--memory`)")
    return {"programs_audited": len(specs), "counts": report.counts(), "memory": memory}


def _compare_to(path: str, payload: dict) -> dict:
    """``--compare-to``: the port's own copy of the regression sentinel
    (``benches/compare_bench.py``, stdlib only) on this line against the
    baseline at ``path``; an error becomes ``{"error": ...}`` (the line must
    land)."""
    from distributed_active_learning_tpu_torch.benches import compare_bench

    try:
        return compare_bench.compare_payloads(compare_bench.load_payload(path), payload,
                                              baseline_name=path)
    except BaseException as e:  # noqa: BLE001 — SystemExit from the loader included
        return {"error": f"{type(e).__name__}: {e}"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_active_learning_tpu_torch.bench",
        description="the PyTorch/CUDA port's bench: one JSON line on stdout",
    )
    ap.add_argument("--mode", choices=sorted([*_MODES]), default="all",
                    help="the bench to run; all (the JAX bench's default) runs "
                    f"{', '.join(ALL_MODES)} in turn under --deadline")
    ap.add_argument("--deadline", type=float, default=None,
                    help="wall-seconds budget for --mode all: a mode that would start past it "
                    "is skipped (modes_skipped) and the line lands for the modes that "
                    "completed. Default: the DAL_BENCH_DEADLINE variable, else 420; 0 disables")
    ap.add_argument("--audit", action="store_true",
                    help="price the programs the mode launches before running it (the memory "
                    "pre-flight, analysis/memory.py); an error finding fails the bench, the "
                    "verdict rides the line under 'audit'")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="trace the run with torch.profiler on the card into DIR and fold the "
                    "kernels' device time under each bench/ and al_phase/ range into the line as "
                    "device_seconds_by_phase")
    ap.add_argument("--compare-to", default=None, metavar="PATH",
                    help="regression sentinel (benches/compare_bench.py, the port's copy): the "
                    "verdict of this line against the bench JSON at PATH rides under "
                    "'regression' (the bench itself never fails on it)")
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
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="score mode: pool rows over this many data shards (with --mesh-model)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="score mode: trees over this many model shards")
    ap.add_argument("--mesh-devices", default=None, metavar="D0,D1,...",
                    help="score mode: the mesh's devices, filled row by row (a list may repeat "
                    "a card: cuda:0,cuda:0,...); default the first data x model cards, or every "
                    "shard on the CPU")
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
    ap.add_argument("--serve-queries", type=int, default=None,
                    help="serve modes: score queries (default 2,000 on CUDA, 220 under "
                    "--device cpu; serve-multi splits them over the tenants)")
    ap.add_argument("--serve-pool", type=int, default=None,
                    help="serve modes: cold-start pool rows a tenant (default 8,192 on CUDA, "
                    "256 under --device cpu)")
    ap.add_argument("--serve-tenants", type=int, default=None,
                    help="serve-multi mode: resident tenants (default 4)")
    ap.add_argument("--ops-port", type=int, default=None,
                    help="serve-multi mode: the ops plane's localhost port; serve-fleet mode: "
                    "the router's port of the largest leg (default ephemeral)")
    ap.add_argument("--fleet-workers", type=int, default=None,
                    help="serve-fleet mode: worker processes of the second leg (default 4; the "
                    "first leg has 1)")
    ap.add_argument("--fleet-linger", type=float, default=0.0, metavar="SECONDS",
                    help="serve-fleet mode: hold the largest leg's fleet up this long after its "
                    "traffic (an external scraper's window)")
    ap.add_argument("--variants", default=None,
                    help="variants mode: names from benches.pallas_variants.VARIANTS "
                    "(default: its DEFAULT_VARIANTS)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args._start_time = time.perf_counter()
    if args.deadline is None:
        args.deadline = float(os.environ.get("DAL_BENCH_DEADLINE", "420"))
    if args.deadline <= 0:
        args.deadline = None
    payload = {"mode": args.mode}
    rc = 0
    _PARTIAL.clear()
    from distributed_active_learning_tpu_torch.runtime import telemetry

    def _interrupted(signum, _frame):
        # One-shot: a second signal while the line is printed is ignored.
        for s in (signal.SIGTERM, signal.SIGINT):
            signal.signal(s, signal.SIG_IGN)
        raise BenchInterrupted(f"signal {signum}")

    # Armed before the flight recorder, whose SIGTERM hook dumps and then
    # chains here; restored when the line is out.
    try:
        handlers = {s: signal.signal(s, _interrupted) for s in (signal.SIGTERM, signal.SIGINT)}
    except ValueError:  # not the main thread: no signal unwind
        handlers = {}
    if args.flight_recorder:
        telemetry.install_flight_recorder(args.flight_recorder)
        _flight("bench_start", mode=args.mode)
    try:
        from distributed_active_learning_tpu_torch.device import resolve_device

        dev = resolve_device(args.device)
        if args.kernel == "gather" and args.mode not in ("score", "density", "serve",
                                                         "serve-multi", "serve-fleet"):
            raise ValueError(f"--kernel gather is carried by --mode score and density, "
                             f"not by --mode {args.mode}")
        cpu = dev.type == "cpu"
        if args.mesh_data * args.mesh_model > 1 and args.mode != "score":
            raise ValueError(f"--mesh-data/--mesh-model are carried by --mode score, not by "
                             f"--mode {args.mode}")
        for name, value in (_CPU_SIZES if cpu else _CUDA_SIZES).items():
            if getattr(args, name) is None:
                setattr(args, name, value)
        payload["device"] = "cpu" if cpu else torch.cuda.get_device_name(dev)
        payload["card"] = card_line(dev)
        payload["cpu_smoke_sizes"] = cpu
        payload["sizes"] = {k: getattr(args, k) for k in
                            ("pool", "features", "trees", "depth", "window", "train_rows", "iters")}
        if args.audit:
            payload["audit"] = _audit(args, dev)
        t0 = time.perf_counter()
        if args.profile_dir:
            payload.update(_profiled(args, dev, lambda: _MODES[args.mode](args, dev)))
        else:
            payload.update(_MODES[args.mode](args, dev))
        payload["bench_seconds"] = round(time.perf_counter() - t0, 2)
    except BaseException as e:  # noqa: BLE001 — the line is printed whatever happened
        payload.update(_PARTIAL)
        payload["error"] = f"{type(e).__name__}: {e}"
        interrupted = isinstance(e, BenchInterrupted)
        payload.setdefault("metric", "bench_interrupted" if interrupted else "bench_failed")
        payload.setdefault("value", None)
        rc = 0 if interrupted else 1
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    if args.flight_recorder:
        payload["flight_recorder"] = telemetry.flight_dump(
            "exit" if "error" not in payload else f"crash:{payload['error'].split(':', 1)[0]}")
    if args.compare_to and "error" not in payload:
        payload["regression"] = _compare_to(args.compare_to, payload)
    print(json.dumps(payload))
    sys.stdout.flush()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
