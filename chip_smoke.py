"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, in order; any failure exits nonzero
and prints no result:

1. build the CUDA kernels from ``distributed_active_learning_tpu_torch/csrc``
   (one nvcc per source, started together) and print the card's name and
   power limit;
2. the leaf kernel (csrc/forest_leaves.cu) against its plain PyTorch version
   at full width (284,807 x 30 pool, 100-tree depth-8 device-fit forest,
   32 bins) and at one ragged shape (13 trees, 1,700 rows): bit-equal;
3. the round megakernel (csrc/round_megakernel.cu) against its plain version
   for uncertainty, entropy, full_entropy and margin (5,000-row labeled
   mask, k = 100): per-tile candidates and merged picks bit-equal;
4. the main path: ``run_experiment`` at the benchmark width (pool 284,807 x
   30, test draw 85,443 rows, 100 trees, depth 8, 32 bins, device fit,
   kernel "pallas", uncertainty, window 100, n_start 5,000, 3 rounds), once
   with ``fused_round`` and once without, the launch counts set to 0 just
   before each run and read just after it: the fused run must launch the
   megakernel and the leaf kernel once a round each, the unfused run the leaf
   kernel twice a round. The two runs' records and final labeled masks must
   be identical. Then a small
   checkerboard run on the card must equal the same run on the CPU (plain
   versions);
5. per-kernel median times at the phase-2 and phase-3 shapes beside the
   plain versions' and the bound; one fused and one unfused main-path round
   under torch.profiler (device time by kernel, device busy share).

The last three lines are a JSON object of per-kernel numbers (``launches``
is the fused run's count, ``launches_by_path`` each run's), the card's name
and power limit, and ``{"ok": true, "device": {...}}``.

It exits nonzero without a CUDA device, and when the port's package is not
beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): device memory and
# float32 operations outside the tensor cores (the compares of a tree walk).
# The bounds below are stated against these.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_POOL, N_TEST, N_FEAT = 284_807, 85_443, 30
TREES, DEPTH, BINS = 100, 8, 32
WINDOW, N_START, ROUNDS = 100, 5_000, 3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float):
    """The least time (ms) the card could take, and what bounds it: the
    larger of the bytes at the memory rate and the operations at the f32
    rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def labels(x: np.ndarray) -> np.ndarray:
    return (x[:, 0] + 0.3 * x[:, 1] > 0).astype(np.int32)


def profile_round(loop, cfg, bundle, dev, label: str) -> None:
    """One main-path round under torch.profiler: device time by kernel and
    the device's busy share of the round's wall time."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    one = dataclasses.replace(cfg, max_rounds=1)
    loop.run_experiment(one, bundle=bundle, device=dev)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run_experiment(one, bundle=bundle, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        # Device-side events only (kernels, copies): host ops and the
        # al_phase/* spans (which the profiler also mirrors onto the device
        # timeline as annotations) carry the time of the kernels under them.
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(evt, "is_user_annotation", False) or evt.key.startswith("al_phase/"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"# profile {label} round (run_experiment incl. set-up): wall {wall:.4f}s, "
          f"device busy {busy:.4f}s ({100 * busy / wall:.1f}%)")
    for us, key, count in rows[:12]:
        print(f"#   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributed_active_learning_tpu_torch import kernels, prng
    from distributed_active_learning_tpu_torch.config import (
        DataConfig, ExperimentConfig, ForestConfig, StrategyConfig,
    )
    from distributed_active_learning_tpu_torch.data.datasets import DataBundle
    from distributed_active_learning_tpu_torch.device import resolve_device
    from distributed_active_learning_tpu_torch.ops import round_fused, trees_pallas, trees_train
    from distributed_active_learning_tpu_torch.ops.topk import merge_tile_topk
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.runtime.debugger import Debugger

    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_all = time.perf_counter()

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all(verbose=True)
    print(f"# build: {time.perf_counter() - t0:.1f}s (nvcc, sm_90a)")
    for name, log in kernels.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"# card: {kind} | nvidia-smi: {smi}")

    # -- phase 2: the leaf kernel against its plain version ----------------
    rng = np.random.default_rng(args.seed)
    pool_np = rng.normal(size=(N_POOL, N_FEAT)).astype(np.float32)
    train_np = rng.normal(size=(N_START, N_FEAT)).astype(np.float32)
    test_np = rng.normal(size=(N_TEST, N_FEAT)).astype(np.float32)
    pool = torch.from_numpy(pool_np).to(dev)
    train_x = torch.from_numpy(train_np).to(dev)
    train_y = torch.from_numpy(labels(train_np)).to(dev)

    def fit(n_trees: int):
        binned = trees_train.make_bins(train_x, BINS)
        f, th, v = trees_train.fit_forest_device(
            binned.codes, train_y, torch.ones(N_START, device=dev), binned.edges,
            prng.key(args.seed + 1), n_trees=n_trees, max_depth=DEPTH, n_bins=BINS,
        )
        return trees_train.heap_gemm_forest(f, th, v, DEPTH)

    gf = fit(TREES)
    gf13 = fit(13)
    shapes = {"full": (gf, pool), "ragged": (gf13, pool[:1700])}
    k1_err = 0.0
    for label, (g, x) in shapes.items():
        got = trees_pallas.predict_leaves_pallas(g, x)
        ref = trees_pallas.predict_leaves_plain(g, x)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.equal(got, ref):
            bad = (got != ref).sum().item() if got.shape == ref.shape else "shape"
            fail(f"forest_leaves != plain at {label} {tuple(x.shape)}: {bad} entries differ")
        k1_err = max(k1_err, float((got - ref).abs().max()))
        print(f"# forest_leaves {label} n={x.shape[0]} T={g.n_trees}: bit-equal to plain")

    # -- phase 3: the megakernel against its plain version -----------------
    labeled = torch.zeros(N_POOL, dtype=torch.bool)
    labeled[torch.from_numpy(rng.choice(N_POOL, size=N_START, replace=False))] = True
    selectable = (~labeled).to(dev)
    ops = trees_pallas.forest_operands(gf)
    k2_err = 0.0
    for strategy in ("uncertainty", "entropy", "full_entropy", "margin"):
        table = round_fused.score_table(TREES, strategy, dev)
        tv, ti = round_fused._launch_megakernel(ops, pool, selectable, table, WINDOW)
        pv, pi = round_fused.megakernel_plain(gf, pool, selectable, table, WINDOW)
        torch.cuda.synchronize()
        if not (torch.equal(tv, pv) and torch.equal(ti, pi)):
            fail(f"round_megakernel != plain per-tile candidates for {strategy}")
        mv, mi = merge_tile_topk(tv, ti, WINDOW)
        rv, ri = merge_tile_topk(pv, pi, WINDOW)
        if not (torch.equal(mv, rv) and torch.equal(mi, ri)) or not torch.isfinite(mv).all():
            fail(f"round_megakernel merged picks differ or are not finite for {strategy}")
        finite = torch.isfinite(pv)
        k2_err = max(k2_err, float(torch.where(finite, tv - pv, 0.0).abs().max()))
        print(f"# round_megakernel {strategy}: per-tile (vals, idx) bit-equal to plain")

    # -- phase 4: the main path ------------------------------------------
    bundle = DataBundle(
        train_x=pool_np, train_y=labels(pool_np), test_x=test_np, test_y=labels(test_np),
        name="bench_pool",
    )

    def cfg(fused: bool) -> ExperimentConfig:
        return ExperimentConfig(
            forest=ForestConfig(n_trees=TREES, max_depth=DEPTH, max_bins=BINS,
                                fit="device", kernel="pallas"),
            strategy=StrategyConfig(name="uncertainty", window_size=WINDOW),
            n_start=N_START, max_rounds=ROUNDS, fused_round=fused, seed=args.seed,
        )

    # Each path's launches are counted from 0 over its own run: the fused
    # round launches the megakernel to score and the leaf kernel for test
    # accuracy; the unfused round launches the leaf kernel for both.
    want_launches = {
        "fused": {"forest_leaves": ROUNDS, "round_megakernel": ROUNDS},
        "unfused": {"forest_leaves": 2 * ROUNDS, "round_megakernel": 0},
    }
    launches = {}
    runs = {}
    for fused in (True, False):
        path = "fused" if fused else "unfused"
        dbg = Debugger(enabled=False)
        trees_pallas.launches = 0
        round_fused.launches = 0
        t0 = time.perf_counter()
        res = loop.run_experiment(cfg(fused), bundle=bundle, debugger=dbg, device=dev)
        wall = time.perf_counter() - t0
        launches[path] = {"forest_leaves": trees_pallas.launches,
                          "round_megakernel": round_fused.launches}
        runs[fused] = res
        print(f"# main path {path}: {wall:.2f}s wall, launches {launches[path]}")
        if launches[path] != want_launches[path]:
            fail(f"main path {path} launched {launches[path]}, want {want_launches[path]}")
        for r in res.records:
            print(f"#   round {r.round}: n_labeled={r.n_labeled} accuracy={r.accuracy:.6f} "
                  f"fit={r.train_time:.4f}s round={r.score_time:.4f}s eval={r.eval_time:.4f}s")
    recs = {f: [(r.round, r.n_labeled, r.accuracy) for r in runs[f].records] for f in runs}
    if recs[True] != recs[False]:
        fail(f"fused and unfused records differ: {recs[True]} vs {recs[False]}")
    want = [N_START + i * WINDOW for i in range(ROUNDS)]
    if [r[1] for r in recs[True]] != want:
        fail(f"n_labeled {[r[1] for r in recs[True]]} != {want}")
    if not all(np.isfinite(r[2]) and 0.0 <= r[2] <= 1.0 for r in recs[True]):
        fail("accuracy records are not finite fractions")
    masks = {f: runs[f].final_labeled_mask for f in runs}
    n_final = N_START + ROUNDS * WINDOW
    if not torch.equal(masks[True], masks[False]) or int(masks[True].sum()) != n_final:
        fail(f"fused and unfused final labeled masks differ or do not hold {n_final} rows")
    print(f"# main path: fused == unfused (records and final mask, "
          f"{int(masks[True].sum())} labeled)")

    small = ExperimentConfig(
        data=DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
        strategy=StrategyConfig(name="uncertainty", window_size=15),
        n_start=10, max_rounds=3, fused_round=True,
    )
    on_card = loop.run_experiment(small, device=dev).to_reference_log()
    on_cpu = loop.run_experiment(small, device="cpu").to_reference_log()
    if on_card != on_cpu:
        fail(f"small run on the card != plain CPU run:\n{on_card}\n{on_cpu}")
    print("# small checkerboard run: card == CPU plain versions")

    # -- phase 5: times ----------------------------------------------------
    x_full = pool.contiguous()
    out_bytes = TREES * N_POOL * 4
    T = gf.n_trees
    depth = gf.value.shape[1].bit_length() - 1  # a heap forest: L = 2 ** depth
    # The least work of the leaf function: a row reaches its leaf in a tree
    # by one compare per level of its root-to-leaf path. The megakernel adds
    # one vote compare per (row, tree).
    k1_ops = N_POOL * T * depth
    k2_ops = N_POOL * T * (depth + 1)
    op_bytes = nbytes(ops.feat, ops.thr, ops.plus, ops.minus, ops.tgt, ops.val)
    k1_ms = cuda_ms(lambda: trees_pallas._launch_leaves(ops, x_full))
    k1_plain = cuda_ms(lambda: trees_pallas.predict_leaves_plain(gf, x_full), reps=3)
    k1_bound, k1_by = bound(nbytes(x_full) + op_bytes + out_bytes, k1_ops)
    table = round_fused.score_table(TREES, "uncertainty", dev)
    k2_ms = cuda_ms(lambda: round_fused._launch_megakernel(ops, x_full, selectable, table, WINDOW))
    k2_plain = cuda_ms(
        lambda: round_fused.megakernel_plain(gf, x_full, selectable, table, WINDOW), reps=3)
    ni = -(-N_POOL // round_fused.TILE_ROWS)
    k2_bound, k2_by = bound(nbytes(x_full, selectable, table) + op_bytes + ni * WINDOW * 8, k2_ops)
    for name, ms, plain, lim, by in (("forest_leaves", k1_ms, k1_plain, k1_bound, k1_by),
                                     ("round_megakernel", k2_ms, k2_plain, k2_bound, k2_by)):
        print(f"# time {name}: {ms:.4f} ms kernel, {plain:.4f} ms plain, bound {lim:.4f} ms "
              f"by {by} ({100 * lim / ms:.3f}% of it; {kind}, {smi})")
    for fused in (True, False):
        profile_round(loop, cfg(fused), bundle, dev, "fused" if fused else "unfused")
    print(f"# total {time.perf_counter() - t_all:.1f}s")

    pkg = "distributed_active_learning_tpu_torch/csrc"
    print(json.dumps({"kernels": [
        {"name": "forest_leaves", "route": "cuda", "source": f"{pkg}/forest_leaves.cu",
         "replaces": "distributed_active_learning_tpu/ops/trees_pallas.py:204",
         "launches": launches["fused"]["forest_leaves"],
         "launches_by_path": {p: launches[p]["forest_leaves"] for p in launches},
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "round_megakernel", "route": "cuda", "source": f"{pkg}/round_megakernel.cu",
         "replaces": "distributed_active_learning_tpu/ops/round_fused.py:166",
         "launches": launches["fused"]["round_megakernel"],
         "launches_by_path": {p: launches[p]["round_megakernel"] for p in launches},
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
