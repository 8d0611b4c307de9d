"""The port's own bench: one JSON line on stdout, always.

    python -m distributed_active_learning_tpu_torch.bench --mode score|density|round|variants
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
  ``chunk_first_call_seconds``); three chunks through ``run_pipelined`` at
  depth 1 and 2 (``pipelined_seconds_per_round``,
  ``pipelined_serial_seconds_per_round``, ``touchdown_hidden_fraction``); and
  the fused round against the unfused one through the same chunk program
  (``fused_scan_seconds_per_round``, ``unfused_scan_seconds_per_round``,
  ``fused_round_speedup``).
- ``--mode variants``: the leaf-eval kernel variants side by side
  (``benches/pallas_variants.py``).

Sizes default to the JAX bench's: its accelerator table on CUDA (pool
284,807 x 30, 100 trees, 5,000 labeled rows, 10 iterations, 8 rounds per
launch) and its smoke table under ``--device cpu`` (``cpu_smoke_sizes`` is
then true in the line, so a smoke-scale line cannot pass for a measurement).

Device time is CUDA events around the call; the JAX bench's differential
batching cancels a per-call latency of its rig that a local card does not
have. Wall times are the host clock around a call that ends in a
synchronize. The line carries the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit`` prints them.

Not carried yet, each with the slice it waits for: the host-fit leg (the
bench runs where the card is, which has no scikit-learn; a host-fit forest
would come as a forest file), the roofline section (pre-flight slice), the
metrics-on chunk and the flight recorder (telemetry slice), the pod legs
(mesh-and-pod slice), ``--audit`` and ``--compare-to`` (pre-flight slice),
and the modes lal, neural, sweep, grid, serve* (their own slices).
``--kernel gather`` is carried by the score and density modes.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

_CUDA_SIZES = dict(pool=284_807, trees=100, train_rows=5000, iters=10, rounds_per_launch=8)
_CPU_SIZES = dict(pool=10_000, trees=10, train_rows=500, iters=2, rounds_per_launch=4)


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


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall(fn: Callable[[], object], dev: torch.device) -> float:
    """Host seconds of one call, its queued device work included."""
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


def _median_wall(fn, iters: int, dev) -> float:
    return statistics.median(_wall(fn, dev) for _ in range(max(iters, 1)))


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


def _chunk_setup(args, dev, pool, pool_y, mask0, binned, fused: bool):
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
                                  fused_round=fused)
    if dev.type == "cuda":
        chunk_fn = loop.GraphedChunk(chunk_fn)
    # A small held-out set, so the chunk includes the accuracy eval that
    # run_experiment performs.
    tx, ty = state0.x[:2048], state0.oracle_y[:2048]
    return chunk_fn, state0, aux, prng.key(7, dev), tx, ty, device_fit, strategy


def _end_round(value: int, dev) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int32).to(dev)


def _bench_scan_fusion(args, dev, pool, pool_y, mask0, binned) -> dict:
    """K rounds in one launch and one touchdown against the per-round
    driver's three syncs a round (fit, round, accuracy) over the same K
    rounds from the same state."""
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.runtime import loop, pipeline

    K = args.rounds_per_launch
    chunk_fn, state0, aux, fit_key, tx, ty, device_fit, strategy = _chunk_setup(
        args, dev, pool, pool_y, mask0, binned, fused=False)
    round_fn = loop.make_round_fn(strategy, args.window)
    end = _end_round(np.iinfo(np.int32).max, dev)

    def run_chunked():
        _, extras, ys = chunk_fn(binned.codes, state0, aux, fit_key, tx, ty, end)
        pipeline.start_host_copy((extras, ys)).wait()  # the one touchdown per chunk

    def run_per_round():
        st = state0
        for r in range(1, K + 1):
            forest = device_fit(binned.codes, st, prng.fold_in(fit_key, r))
            _sync(dev)
            st, picked, _ = round_fn(forest, st, aux)
            _sync(dev)
            float(loop._accuracy(forest, tx, ty))

    chunk_first_call = _wall(run_chunked, dev)  # warm-up step, capture and first replay
    run_per_round()
    reps = max(min(args.iters, 5), 2)
    chunk_sec = _median_wall(run_chunked, reps, dev) / K
    per_round_sec = _median_wall(run_per_round, reps, dev) / K
    out = {
        "rounds_per_launch": K,
        "scan_seconds_per_round": round(chunk_sec, 6),
        "per_round_driver_seconds_per_round": round(per_round_sec, 6),
        "scan_fusion_speedup": round(per_round_sec / chunk_sec, 3),
        "scan_metrics_enabled": False,
        "chunk_first_call_seconds": round(chunk_first_call, 4),
        "chunk_capture_overhead_seconds": round(max(chunk_first_call - chunk_sec * K, 0.0), 4),
    }
    if isinstance(chunk_fn, loop.GraphedChunk):
        out["chunk_graph"] = chunk_fn.stats()
    out.update(_bench_pipelined(args, dev, chunk_fn, state0, aux, binned, fit_key, tx, ty))
    return out


def _bench_pipelined(args, dev, chunk_fn, state0, aux, binned, fit_key, tx, ty) -> dict:
    """Three chunks through ``run_pipelined`` at depth 2 and depth 1 with the
    production touchdown body. ``touchdown_hidden_fraction`` > 0 means chunk
    touchdowns ran while another chunk executed; depth 1 pins it at 0."""
    from distributed_active_learning_tpu_torch.runtime.pipeline import run_pipelined
    from distributed_active_learning_tpu_torch.runtime.results import ExperimentResult

    K, chunks = args.rounds_per_launch, 3
    # Bound the drive inside the chunk (end_round), as run_experiment bounds
    # max_rounds, so both depths run the same three chunks.
    total = chunks * K
    end = _end_round(total, dev)

    def drive(depth):
        result = ExperimentResult()
        done = {"rounds": 0}

        def dispatch(st, _idx):
            return chunk_fn(binned.codes, st, aux, fit_key, tx, ty, end)

        def continue_after(_n_labeled_after, n_active):
            done["rounds"] += n_active
            return n_active == K and done["rounds"] < total

        def touchdown(_idx, _nla, n_active, ys, _out_state, wall):
            if n_active == 0:
                return
            rounds_y, labeled_y, acc_y, _picked_y, active_y = ys
            active_np = active_y.numpy()
            labeled_np = labeled_y.numpy()[active_np]
            result.extend_from_arrays(
                rounds_y.numpy()[active_np], labeled_np, labeled_np * 0,
                acc_y.numpy()[active_np], total_time=wall / n_active)

        t0 = time.perf_counter()
        _, stats = run_pipelined(
            state0, dispatch=dispatch, touchdown=touchdown, continue_after=continue_after,
            depth=depth, may_dispatch=lambda idx: idx * K < total)
        _sync(dev)
        wall = time.perf_counter() - t0
        if len(result.records) != total:
            raise RuntimeError(f"pipelined drive appended {len(result.records)} rounds, want {total}")
        return wall / total, stats

    serial_spr, serial_stats = drive(1)
    piped_spr, piped_stats = drive(2)
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
        legs[name] = {"first_call": _wall(run, dev)}
    reps = 5
    times = {name: [] for name in runs}
    for _ in range(reps):
        for name, run in runs.items():
            times[name].append(_wall(run, dev))
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

    _wall(device_round, dev)  # builds and warms
    round_sec = _median_wall(device_round, args.iters, dev)
    round_dev_sec = _median_device(device_round, args.iters, dev)
    fit_sec = _median_wall(fit_heap, args.iters, dev)
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
    for leg in (_bench_scan_fusion, _bench_fused_round):
        result.update(leg(args, dev, pool, pool_y, mask0, binned))
        gc.collect()  # drop the leg's graphs and their memory pools
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


_MODES = {"score": bench_score, "density": bench_density, "round": bench_round,
          "variants": bench_variants}


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
    ap.add_argument("--variants", default=None,
                    help="variants mode: names from benches.pallas_variants.VARIANTS "
                    "(default: its DEFAULT_VARIANTS)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    payload = {"mode": args.mode}
    rc = 0
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
    print(json.dumps(payload))
    sys.stdout.flush()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
