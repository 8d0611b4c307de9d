"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, in order; any failure exits nonzero
and prints no result:

1. build the six CUDA kernels from ``distributed_active_learning_tpu_torch/
   csrc`` (one nvcc per source, started together) and print the card's name
   and power limit;
2. the leaf kernel K1 (csrc/forest_leaves.cu, a heap walk over the forest
   staged in shared memory) against both plain PyTorch versions, the
   path-matrix form and the walk over the heap operands, at full width
   (284,807 x 30 pool, 100-tree depth-8 device-fit forest, 32 bins), on the
   85,443-row test draw, on one 50-tree model shard of the 4 x 2 mesh
   (71,202 rows), at one ragged shape (13 trees, 1,700 rows) and over a
   depth sweep 1-8 on rows that hold NaN, infinities and features on node
   thresholds: bit-equal; a path matrix that is not a heap is refused;
2b. the vote kernel K3 (csrc/fused_votes.cu, a heap walk over the forest
   held in shared memory, csrc/heap_votes.cuh) against both plain versions,
   the path-matrix form and the walk over the heap operands with packed vote
   bits, at full width, at one 50-tree model shard of the 4 x 2 mesh (71,202
   rows), at the ragged shape, over phase 2's depth sweep on edge rows and at
   one streamed shape (256 trees of depth 8 over the pool, too many to stay
   resident): bit-equal, each with its launch configuration and mode;
2c. the layout variants K5 (csrc/forest_leaves_transposed.cu) and K6
   (csrc/forest_leaves_segmented.cu), heap walks on csrc/heap_tiles.cuh,
   against their plain versions at full width: K5 for both leaf payloads
   (hi + lo, exact f32), tree_outer on and off, at (bn, bt) = (512, 16) and
   (2048, 8), and each ablation stage; K6 at (2048, 8) and (1024, 8); all
   bit-equal, and K5 with the f32 payload equal to K1's leaves. Both also
   bit-equal to the walks of their own arithmetic at full width, and to
   their plain versions over phase 2's depth sweep 1-8 on edge rows, at the
   ragged 13-tree shape, and on a forest with -inf and NaN thresholds against
   rows that are -inf there (where K6, which gives such nodes no slot, must
   differ from K5); a path matrix that is not a heap is refused by both with
   no launch;
2d. K1 on a host-fit-shaped forest: 100 trees of max_depth 8 made with numpy
   in the shapes a scikit-learn fit packs into (leaves at depths 1-8,
   single-leaf trees; the card's machine has no scikit-learn), written with
   ``save_forest`` and loaded onto the card with ``load_forest``, then
   ``for_kernel(..., "pallas")`` (its trees packed into complete heaps): K1
   at the pool plus 4,099 edge rows bit-equal to ``predict_leaves_plain`` on
   the depth-first path matrix and to the walk of the heaps, and on the
   bf16-exact pool equal to the gather form; its launch is printed;
3. the round megakernel K2 (csrc/round_megakernel.cu, the same walk as K3)
   against both plain versions for uncertainty, entropy, full_entropy and
   margin at full width (5,000-row labeled mask, k = 100), then for
   uncertainty at phase 2b's other shapes: per-tile candidates and merged
   picks bit-equal; a path matrix that is not a heap is refused by K2 and K3
   before any launch;
3b. the ring copy K4 (csrc/ring_hop.cu): a 4-shard ring of k = 100 windows
   on the card (four shards on cuda:0), each hop and one ring step of all
   four windows (one launch) bit-equal to the plain copies and the merge
   equal to the global stable top-k; the same across two cards (peer
   stores) when two are visible, else a line saying it did not run;
4. the main path: ``run_experiment`` at the benchmark width (pool 284,807 x
   30, test draw 85,443 rows, 100 trees, depth 8, 32 bins, device fit,
   kernel "pallas", uncertainty, window 100, n_start 5,000, 3 rounds), once
   with ``fused_round`` and once without, the launch counts set to 0 just
   before each run and read just after it: the fused run must launch K2 and
   K1 once a round each, the unfused run K1 twice a round. The two runs'
   records and final labeled masks must be identical. Then a small
   checkerboard run on the card must equal the same run on the CPU (plain
   versions);
4b. the mesh path: the phase-4 configuration with ``MeshConfig(data=4,
   model=2)`` on ``devices=[cuda:0] * 8`` (284,807 rows padded to 284,808;
   100 trees as 2 x 50), fused and unfused, counted from 0 per run: fused
   K3 8, K4 3 (one a ring step) and K1 8 launches a round and no K2;
   unfused K1 16 a round
   and no K3 or K4. Records and final masks must equal phase 4's. With two
   or more visible cards the same mesh runs again spread over them (shard
   (s, m) on card (s + m) mod n), else a line says it did not run. Then a
   small checkerboard mesh run on the card must equal the same mesh on the
   CPU;
4c. the chunked driver at the benchmark width: ``rounds_per_launch = 4``,
   ``max_rounds = 6`` (a stop inside the second chunk), fused and unfused,
   ``pipeline_depth`` 1 and 2. Records and the final mask must equal the
   per-round run of the same configuration; each run must capture one CUDA
   graph and replay it twice (kernel launches: one eager warm-up round plus 4
   rounds per replay). The chunk body runs once eagerly under
   ``torch.cuda.set_sync_debug_mode("error")``: it must not sync with the
   host (also the bodies of phases 4d and 4e). Then seconds per round of the
   per-round driver and of the chunked driver at depth 1 and 2 over 12 rounds
   (rounds 5-12: the first chunk holds the capture);
4d. the deep gather path: phase 4's configuration at ``max_depth=12`` with
   ``kernel="gather"`` (the device fit emits the gather form; no kernel of
   the port runs on it, so every launch count stays 0), unfused, 3 rounds,
   per round and chunked (K = 4): records and final mask equal, one graph
   capture and one replay; small checkerboard runs at depth 12, per round
   and chunked, equal on the card and on the CPU;
4e. density: phase 4's configuration with ``strategy="density"``, unfused,
   3 rounds, per round and chunked (K = 4), K1 counted from 0 (twice a
   round): records and final mask equal; small checkerboard runs equal on
   the card and on the CPU (picks, records, mask), and the similarity mass
   of the card within ``similarity.MASS_RTOL`` of the largest |mass| of the
   CPU's, on the small pool and the bench pool;
5. per-kernel median times at the phase-2/2b/2c/3/3b shapes beside the plain
   versions' and the bound (one call between CUDA events; for K1, K2, K3,
   K5 and K6 also the device time of the call captured in a CUDA graph and
   replayed back to back): K1 at the pool, the test draw and one mesh
   shard; K2 at the pool and K3 at a mesh shard and the pool, each also at
   other thread-group counts a block than its own choice, and both at the
   streamed shape; a K4 ring step of four k = 100 windows beside four
   ``Tensor.copy_`` pairs into preallocated buffers; K5 and K6 at (bn, bt) =
   (2048, 8) on the pool; ``merge_tile_topk`` at
   the fused round's shape; ``forest_eval.votes`` of a depth-12 gather form
   and ``similarity_mass`` at the pool beside their byte bounds, and the
   host milliseconds of packing phase 2d's forest into heaps; then one fused
   and one unfused main-path round and one mesh fused round under
   torch.profiler (device time by kernel, device busy share);
6. the port's bench at the benchmark width: ``--mode score``, ``--mode
   round`` and ``--mode variants`` (K1, two K5 tilings, one K6), each JSON
   line printed on a line of its own. K5's and K6's launch counts are read
   over the variants run, counted from 0.

The last three lines are a JSON object of per-kernel numbers (``launches``
is the count of the kernel's main path, single-device fused for K1 and K2,
mesh fused for K3 and K4, the bench's variants mode for K5 and K6;
``launches_by_path`` every path's, phases 4d and 4e included;
``launch_config`` for K1, K2 and K3; ``new_paths`` phase 5's new times and
the fit / round / eval split of each round of phases 4d and 4e),
the card's name
and power limit, and ``{"ok": true, "device": {...}}``.

It exits nonzero without a CUDA device, and when the port's package is not
beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
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
DEEP = 12  # the deep device fit's depth (the gather form), phase 4d
WINDOW, N_START, ROUNDS = 100, 5_000, 3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median device time of ``fn`` over ``reps`` timings of ``inner``
    back-to-back calls each (CUDA events), per call, after one warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, reps: int = 9, inner: int = 20) -> float:
    """Median device time of ``fn`` captured once in a CUDA graph and
    replayed ``inner`` times back to back: the kernel's own time, without
    the host work of its wrapper between launches (which ``cuda_ms`` of one
    call includes when the kernel is shorter than that work)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cuda_ms(g.replay, reps=reps, inner=inner)


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


def edge_rows(gf, rng, n: int) -> torch.Tensor:
    """Normal rows of N_FEAT features in which every eighth row is all NaN,
    +inf or -inf (or one feature of it is), and others hold a node's
    threshold exactly or the bf16 tie above its rounding."""
    x = rng.normal(size=(n, N_FEAT)).astype(np.float32)
    feat, thr = gf.feat_ids.cpu().numpy(), gf.thresholds.cpu().numpy()
    for r in range(n):
        kind = r % 8
        if kind < 3:
            x[r, rng.integers(N_FEAT) if r % 16 >= 8 else slice(None)] = (np.nan, np.inf, -np.inf)[kind]
        elif kind < 5:
            t, i = rng.integers(feat.shape[0]), rng.integers(feat.shape[1])
            v = thr[t, i:i + 1]
            if kind == 4:
                v = (((v.view(np.uint32) + 0x7FFF) & 0xFFFF0000) | 0x8000).view(np.float32)
            x[r, feat[t, i]] = v[0]
    return torch.from_numpy(x)


def profile_round(loop, cfg, bundle, dev, label: str, devices=None) -> None:
    """One main-path round under torch.profiler: device time by kernel and
    the device's busy share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile

    one = dataclasses.replace(cfg, max_rounds=1)
    loop.run_experiment(one, bundle=bundle, device=dev, devices=devices)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run_experiment(one, bundle=bundle, device=dev, devices=devices)
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
    from distributed_active_learning_tpu_torch import bench, kernels, prng
    from distributed_active_learning_tpu_torch.benches import pallas_variants as lv
    from distributed_active_learning_tpu_torch.config import (
        DataConfig, ExperimentConfig, ForestConfig, MeshConfig, StrategyConfig,
    )
    from distributed_active_learning_tpu_torch.data.datasets import DataBundle, get_dataset
    from distributed_active_learning_tpu_torch.device import resolve_device
    from distributed_active_learning_tpu_torch.models import forest as forest_lib
    from distributed_active_learning_tpu_torch.models import forest_io
    from distributed_active_learning_tpu_torch.ops import (
        forest_eval, ring_topk, round_fused, similarity, trees_pallas, trees_train,
    )
    from distributed_active_learning_tpu_torch.ops import trees as trees_lib
    from distributed_active_learning_tpu_torch.ops.topk import merge_tile_topk, stable_top_k
    from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.runtime import state as state_lib
    from distributed_active_learning_tpu_torch.strategies import StrategyAux, get_strategy
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
    test_x = torch.from_numpy(test_np).to(dev)
    n_shard = -(-N_POOL // 4)  # one data shard of the 4 x 2 mesh (284,808 / 4)
    gf_shard = mesh_lib.shard_forest(gf, mesh_lib.make_mesh(1, 2, devices=[dev, dev]))[0][0]
    k1_err = 0.0

    def check_k1(g, x, label):
        nonlocal k1_err
        got = trees_pallas.predict_leaves_pallas(g, x)
        ref = trees_pallas.predict_leaves_plain(g, x)
        walked = trees_pallas.walk_leaves_plain(trees_pallas.heap_operands(g), x)
        torch.cuda.synchronize()
        for name, want_ in (("plain", ref), ("walk_leaves_plain", walked)):
            if got.shape != want_.shape or not torch.equal(got, want_):
                bad = (got != want_).sum().item() if got.shape == want_.shape else "shape"
                fail(f"forest_leaves != {name} at {label} {tuple(x.shape)}: {bad} entries differ")
        k1_err = max(k1_err, float((got - ref).abs().max()))

    for label, (g, x) in {"full": (gf, pool), "test": (gf, test_x),
                          "mesh shard": (gf_shard, pool[:n_shard]),
                          "ragged": (gf13, pool[:1700])}.items():
        check_k1(g, x, label)
        print(f"# forest_leaves {label} n={x.shape[0]} T={g.n_trees}: bit-equal to plain and to "
              "walk_leaves_plain")
    sweep = {}  # depth -> (16-tree forest, edge rows), for K1, K2 and K3
    for depth_ in range(1, DEPTH + 1):
        binned = trees_train.make_bins(train_x, BINS)
        f, th, v = trees_train.fit_forest_device(
            binned.codes, train_y, torch.ones(N_START, device=dev), binned.edges,
            prng.key(args.seed + depth_), n_trees=16, max_depth=depth_, n_bins=BINS)
        g = trees_train.heap_gemm_forest(f, th, v, depth_)
        sweep[depth_] = (g, edge_rows(g, rng, 4099).to(dev))
        check_k1(*sweep[depth_], f"depth {depth_}")
    print(f"# forest_leaves depths 1-{DEPTH} (16 trees, 4,099 rows with NaN, +-inf and features "
          "on node thresholds): bit-equal to plain and to walk_leaves_plain")
    swapped = dataclasses.replace(gf13, path=gf13.path[:, :, [1, 0, *range(2, 2 ** DEPTH)]])
    before = trees_pallas.launches
    try:
        trees_pallas.predict_leaves_pallas(swapped, pool[:10])
        fail("forest_leaves took a path matrix that is not a heap")
    except ValueError as e:
        if "host fit" not in str(e) or trees_pallas.launches != before:
            fail(f"a non-heap path matrix was not refused by name: {e}")
    print("# forest_leaves: a non-heap path matrix is refused (ValueError), no launch")
    k1_cfg = trees_pallas.leaves_launch_config(trees_pallas.heap_operands(gf), N_POOL, N_FEAT, dev)
    print(f"# forest_leaves launch at full width: {k1_cfg}")

    # -- phase 2b: K3 against both plain versions ---------------------------
    gf256 = fit(256)  # 270,336 bytes of packed heap form: the streamed mode
    # 60,000 depth-1 trees, drawn at random: more trees than a [T + 1] score
    # table beside the tile would leave room for, so K2 must read it where
    # it lies.
    gen = torch.Generator(device=dev).manual_seed(args.seed + 60_000)
    gf60k = trees_train.heap_gemm_forest(
        torch.randint(0, N_FEAT, (60_000, 1), generator=gen, device=dev, dtype=torch.int32),
        torch.randn(60_000, 1, generator=gen, device=dev),
        torch.rand(60_000, 3, generator=gen, device=dev), 1)
    vote_shapes = {"full": (gf, pool), "shard": (gf_shard, pool[:n_shard]),
                   "ragged": (gf13, pool[:1700]),
                   **{f"depth {d_} edge rows": sweep[d_] for d_ in sweep},
                   "streamed 256 trees": (gf256, pool),
                   "streamed 60,000 depth-1 trees": (gf60k, pool[:1025])}
    walked_votes = {}
    for label, (g, x) in vote_shapes.items():
        h = trees_pallas.heap_operands(g)
        got = round_fused.fused_votes(g, x)
        walked_votes[label] = round_fused.walk_votes_plain(h, x)
        ref = round_fused.fused_votes_plain(g, x)
        torch.cuda.synchronize()
        for name, want_ in (("plain", ref), ("walk_votes_plain", walked_votes[label])):
            if got.dtype != torch.int32 or not torch.equal(got, want_):
                fail(f"fused_votes != {name} at {label} n={x.shape[0]} T={g.n_trees}")
        cfg_ = round_fused.launch_config("fused_votes", h, *x.shape, dev)
        if (cfg_["mode"] == "streamed") != label.startswith("streamed"):
            fail(f"fused_votes at {label} launches in {cfg_['mode']} mode")
        print(f"# fused_votes {label} n={x.shape[0]} T={g.n_trees}: bit-equal to plain and to "
              f"walk_votes_plain; launch {cfg_}")
    k3_err = 0.0  # integer votes, compared for equality above

    # -- phase 2c: K5 and K6 against their plain versions -------------------
    k1_leaves = trees_pallas.predict_leaves_pallas(gf, pool)
    k5_err = 0.0
    for leaf_f32 in (False, True):
        want = lv.predict_leaves_transposed_plain(gf, pool, leaf_f32=leaf_f32)
        for tree_outer in (False, True):
            for bn, bt in ((512, 16), (2048, 8)):
                got = lv.predict_leaves_transposed(
                    gf, pool, bn=bn, bt=bt, tree_outer=tree_outer, leaf_f32=leaf_f32)
                torch.cuda.synchronize()
                if got.shape != want.shape or not torch.equal(got, want):
                    fail(f"forest_leaves_transposed != plain (leaf_f32={leaf_f32}, "
                         f"tree_outer={tree_outer}, bn={bn}, bt={bt})")
                k5_err = max(k5_err, float((got - want).abs().max()))
                if leaf_f32 and not torch.equal(got, k1_leaves):
                    fail("forest_leaves_transposed with the f32 payload != forest_leaves")
        del want
    for stage in lv.ABLATE[1:]:
        got = lv.predict_leaves_transposed(gf, pool, bn=4096, bt=8, ablate=stage)
        want = lv.predict_leaves_transposed_plain(gf, pool, ablate=stage)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"forest_leaves_transposed != plain at ablation stage {stage}")
    print("# forest_leaves_transposed full width: bit-equal to plain for hi + lo and f32 "
          "payloads, tree_outer on and off, (bn, bt) = (512, 16) and (2048, 8), and the "
          "stages sel, cmp, main, eq; the f32 payload == forest_leaves")
    k6_err = 0.0
    for bn, bt in ((2048, 8), (1024, 8)):
        got = lv.predict_leaves_segmented(gf, pool, bn=bn, bt=bt)
        want = lv.predict_leaves_segmented_plain(gf, pool, bn=bn, bt=bt)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"forest_leaves_segmented != plain (bn={bn}, bt={bt})")
        k6_err = max(k6_err, float((got - want).abs().max()))
    seg_S = lv._segmented_operands(gf, pool, 2048, 8).S
    print(f"# forest_leaves_segmented full width (S = {seg_S} slots a feature): bit-equal to "
          "plain at (bn, bt) = (2048, 8) and (1024, 8)")
    del got, want, k1_leaves

    def bits_equal(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    def check_k5_k6(g, x, label, k5_tilings, k6_tilings):
        for bn, bt, tree_outer in k5_tilings:
            for leaf_f32 in (False, True):
                got = lv.predict_leaves_transposed(g, x, bn=bn, bt=bt, tree_outer=tree_outer,
                                                   leaf_f32=leaf_f32)
                if not bits_equal(got, lv.predict_leaves_transposed_plain(g, x, leaf_f32)):
                    fail(f"forest_leaves_transposed != plain at {label} (bn={bn}, bt={bt}, "
                         f"tree_outer={tree_outer}, leaf_f32={leaf_f32})")
            for stage in lv.ABLATE[1:]:
                got = lv.predict_leaves_transposed(g, x, bn=bn, bt=bt, ablate=stage)
                if not bits_equal(got, lv.predict_leaves_transposed_plain(g, x, ablate=stage)):
                    fail(f"forest_leaves_transposed != plain at {label}, stage {stage}")
        for bn, bt in k6_tilings:
            got = lv.predict_leaves_segmented(g, x, bn=bn, bt=bt)
            if not bits_equal(got, lv.predict_leaves_segmented_plain(g, x, bn=bn, bt=bt)):
                fail(f"forest_leaves_segmented != plain at {label} (bn={bn}, bt={bt})")
        torch.cuda.synchronize()

    # The walks of the kernels' own arithmetic at full width, then depths
    # 1-8 on edge rows (16 trees, 4,099 rows: ragged against every tile), the
    # ragged 13-tree shape, and -inf/NaN thresholds against -inf rows.
    p5 = lv._prep_transposed(gf, pool, 2048, 8)
    if not bits_equal(lv._launch_transposed(p5, 2048, 8), lv.walk_transposed_plain(p5).T):
        fail("forest_leaves_transposed != walk_transposed_plain at full width")
    p6 = lv._segmented_operands(gf, pool, 2048, 8)
    if not bits_equal(lv._launch_segmented(p6, 2048, 8), lv.walk_segmented_plain(p6).T):
        fail("forest_leaves_segmented != walk_segmented_plain at full width")
    del p5, p6
    for depth_, (g, x) in sweep.items():
        check_k5_k6(g, x, f"depth {depth_} edge rows", [(2048, 8, False), (512, 16, True)],
                    [(2048, 8)])
    check_k5_k6(gf13, pool[:1700], "13 trees x 1,700 rows", [(512, 8, False)], [(1024, 8)])
    g8, x8 = sweep[DEPTH]
    thr_odd = g8.thresholds.clone()
    thr_odd[:, 1::5], thr_odd[:, 3::7] = float("-inf"), float("nan")
    g_odd = dataclasses.replace(g8, thresholds=thr_odd)
    x_odd = x8.clone()
    rows = torch.arange(3, x_odd.shape[0], 2, device=dev)
    x_odd[rows, g8.feat_ids[rows % g8.n_trees, 1 + 5 * (rows % 50)].long()] = float("-inf")
    check_k5_k6(g_odd, x_odd, "-inf/NaN thresholds, -inf rows", [(2048, 8, False)], [(2048, 8)])
    if torch.equal(lv.predict_leaves_segmented(g_odd, x_odd),
                   lv.predict_leaves_transposed(g_odd, x_odd)):
        fail("K6 sent -inf rows left at -inf thresholds (no node was dropped)")
    before = (lv.transposed_launches, lv.segmented_launches)
    for fn in (lv.predict_leaves_transposed, lv.predict_leaves_segmented):
        try:
            fn(swapped, pool[:10])
            fail(f"{fn.__name__} took a path matrix that is not a heap")
        except ValueError as e:
            if "host fit" not in str(e):
                fail(f"{fn.__name__}: a non-heap path matrix was not refused by name: {e}")
    if (lv.transposed_launches, lv.segmented_launches) != before:
        fail("a non-heap forest launched K5 or K6")
    print(f"# forest_leaves_transposed / _segmented: bit-equal to walk_*_plain at full width; "
          f"to plain at depths 1-{DEPTH} on edge rows ((2048, 8) and (512, 16) tree_outer for "
          "K5, both payloads, every stage; (2048, 8) for K6), at 13 trees x 1,700 rows, and "
          "with -inf/NaN thresholds against -inf rows (K6 != K5 there, as its slots drop "
          "those nodes); a non-heap path matrix is refused by both, no launch")

    # -- phase 2d: host-fit-shaped forests through K1 -----------------------
    t_phase = time.perf_counter()
    # The card's machine has no scikit-learn: the forest is made with numpy
    # in the shapes a host fit packs into (depth-first node ids, leaves at
    # depths 1-8, single-leaf trees) and reaches the card as a forest file.
    host_packed = forest_lib.synthetic_forest(
        np.random.default_rng(args.seed + 2), TREES, DEPTH, N_FEAT, single_leaf_every=9)
    forest_file = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                               "chip_smoke_host_forest.npz")
    forest_io.save_forest(forest_file, host_packed, meta=f"synthetic, seed {args.seed + 2}")
    host_loaded, meta = forest_io.load_forest(forest_file, device=dev)
    if meta != f"synthetic, seed {args.seed + 2}" or not all(
            torch.equal(getattr(host_loaded, f).cpu(), getattr(host_packed, f))
            for f in ("feature", "threshold", "left", "right", "value")):
        fail("the forest file did not round-trip")
    host_pf = forest_eval.for_kernel(host_loaded, "pallas")
    if host_pf.prepacked is None or host_pf.heap.depth != DEPTH:
        fail("for_kernel(..., 'pallas') did not pack the host-fit forest into heaps")
    leaf = host_packed.feature == -1
    reached = set()
    for t in range(TREES):  # the depth of every reachable leaf
        todo = [(0, 0)]
        while todo:
            v, dd = todo.pop()
            if leaf[t, v]:
                reached.add(dd)
            else:
                todo += [(int(host_packed.left[t, v]), dd + 1), (int(host_packed.right[t, v]), dd + 1)]
    x_2d = torch.cat([pool, edge_rows(host_pf.gf, rng, 4099).to(dev)])
    before = trees_pallas.launches
    got = trees_pallas.predict_leaves_pallas(host_pf, x_2d)
    if trees_pallas.launches != before + 1:
        fail("K1 did not launch on the host-fit forest")
    for name, want_ in (("predict_leaves_plain (depth-first path matrix)",
                         trees_pallas.predict_leaves_plain(host_pf.gf, x_2d)),
                        ("walk_leaves_plain", trees_pallas.walk_leaves_plain(host_pf.heap, x_2d))):
        torch.cuda.synchronize()
        if not torch.equal(got, want_):
            fail(f"forest_leaves on the host-fit heaps != {name}: "
                 f"{(got != want_).sum().item()} entries differ")
        k1_err = max(k1_err, float((got - want_).abs().max()))
    x_bf16 = pool.to(torch.bfloat16).float()
    if not torch.equal(trees_pallas.predict_leaves_pallas(host_pf, x_bf16),
                       trees_lib.predict_leaves(host_loaded, x_bf16)):
        fail("forest_leaves on the host-fit heaps != the gather form on bf16-exact rows")
    host_cfg = trees_pallas.leaves_launch_config(host_pf.heap, *x_2d.shape, dev)
    print(f"# forest_leaves on a host-fit-shaped forest ({TREES} trees, max_depth {DEPTH}, leaves "
          f"at depths {sorted(reached)}, {int(leaf[:, 0].sum())} single-leaf trees; through "
          f"save_forest/load_forest and for_kernel(..., 'pallas')) at {x_2d.shape[0]} rows "
          "(the pool and 4,099 edge rows): bit-equal to predict_leaves_plain on the depth-first "
          "path matrix and to walk_leaves_plain on the packed heaps; on the bf16-exact pool "
          f"equal to the gather form; launch {host_cfg}")
    del got, want_, x_2d, x_bf16
    print(f"# phase 2d: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 3: the megakernel against its plain version -----------------
    labeled = torch.zeros(N_POOL, dtype=torch.bool)
    labeled[torch.from_numpy(rng.choice(N_POOL, size=N_START, replace=False))] = True
    selectable = (~labeled).to(dev)
    heap = trees_pallas.heap_operands(gf)
    k2_err = 0.0

    def check_k2(g, x, sel, strategy, label):
        nonlocal k2_err
        h = trees_pallas.heap_operands(g)
        table = round_fused.score_table(g.n_trees, strategy, dev)
        tv, ti = round_fused._launch_megakernel(h, x, sel, table, WINDOW)
        pv, pi = round_fused.megakernel_plain(g, x, sel, table, WINDOW)
        wv, wi = round_fused.tile_topk_plain(walked_votes[label], sel, table, WINDOW)
        torch.cuda.synchronize()
        for name, (rv, ri) in (("plain", (pv, pi)), ("walk_votes_plain", (wv, wi))):
            if not (torch.equal(tv, rv) and torch.equal(ti, ri)):
                fail(f"round_megakernel != {name} per-tile candidates for {strategy} at {label}")
        mv, mi = merge_tile_topk(tv, ti, WINDOW)
        rv, ri = merge_tile_topk(pv, pi, WINDOW)
        if not (torch.equal(mv, rv) and torch.equal(mi, ri)) or not torch.isfinite(mv).all():
            fail(f"round_megakernel merged picks differ or are not finite for {strategy} at {label}")
        finite = torch.isfinite(pv)
        k2_err = max(k2_err, float(torch.where(finite, tv - pv, 0.0).abs().max()))

    for strategy in ("uncertainty", "entropy", "full_entropy", "margin"):
        check_k2(gf, pool, selectable, strategy, "full")
        print(f"# round_megakernel full {strategy}: per-tile (vals, idx) bit-equal to plain and "
              "to walk_votes_plain")
    for label, (g, x) in vote_shapes.items():
        if label == "full":
            continue
        check_k2(g, x, selectable[:x.shape[0]], "uncertainty", label)
        cfg_ = round_fused.launch_config("round_megakernel", trees_pallas.heap_operands(g),
                                         *x.shape, dev)
        if (cfg_["mode"] == "streamed") != label.startswith("streamed"):
            fail(f"round_megakernel at {label} launches in {cfg_['mode']} mode")
        print(f"# round_megakernel {label} n={x.shape[0]} T={g.n_trees} uncertainty: bit-equal "
              f"to plain and to walk_votes_plain; launch {cfg_}")
    k2_cfg = round_fused.launch_config("round_megakernel", heap, N_POOL, N_FEAT, dev)
    k3_cfg = round_fused.launch_config("fused_votes", trees_pallas.heap_operands(gf_shard),
                                       n_shard, N_FEAT, dev)
    print(f"# round_megakernel launch at full width: {k2_cfg}; fused_votes at a mesh shard: "
          f"{k3_cfg}")
    before = (round_fused.launches, round_fused.votes_launches)
    for name, call in (
            ("round_megakernel", lambda: round_fused.fused_score_select(
                trees_pallas.PallasForest(gf=swapped), pool[:10], selectable[:10], "uncertainty",
                5)),
            ("fused_votes", lambda: round_fused.fused_votes(
                trees_pallas.PallasForest(gf=swapped), pool[:10]))):
        try:
            call()
            fail(f"{name} took a path matrix that is not a heap")
        except ValueError as e:
            if "host fit" not in str(e) or (round_fused.launches,
                                             round_fused.votes_launches) != before:
                fail(f"a non-heap path matrix was not refused by name by {name}: {e}")
    print("# round_megakernel, fused_votes: a non-heap path matrix is refused (ValueError), "
          "no launch")
    del walked_votes, gf60k, vote_shapes

    # -- phase 3b: K4 and the ring -----------------------------------------
    def ring_windows(devs, scores, sel):
        n_local = scores.shape[0] // len(devs)
        out = []
        for s_, d_ in enumerate(devs):
            blk = slice(s_ * n_local, (s_ + 1) * n_local)
            work = torch.where(sel[blk], scores[blk], float("-inf"))
            v, i = stable_top_k(work, min(WINDOW, n_local))
            out.append(ring_topk.pad_window(v.to(d_), (i + s_ * n_local).to(torch.int32).to(d_),
                                            WINDOW))
        return out

    def check_ring(devs, label):
        # Hard-vote scores tie everywhere: 101 levels over 4 x 71,202 rows.
        g = torch.Generator().manual_seed(args.seed)
        scores = torch.randint(0, TREES + 1, (4 * n_shard,), generator=g).float() / TREES
        sel = torch.rand(4 * n_shard, generator=g) < 0.9
        windows = ring_windows(devs, scores, sel)
        for s_, (v, i) in enumerate(windows):
            right = devs[(s_ + 1) % len(devs)]
            hv, hi = ring_topk.hop(v, i, right)
            pv, pi = ring_topk.hop_plain(v, i, right)
            torch.cuda.synchronize()
            if not (torch.equal(hv, pv) and torch.equal(hi, pi)):
                fail(f"ring_hop != plain copy ({label}, shard {s_})")
        # One ring step: each shard's window into a buffer on its right
        # neighbour, one launch per sending card.
        def buffers():
            return [(torch.full((WINDOW,), float("nan"), device=devs[(s_ + 1) % len(devs)]),
                     torch.full((WINDOW,), -1, dtype=torch.int32,
                                device=devs[(s_ + 1) % len(devs)])) for s_ in range(len(devs))]
        got_, ref_ = buffers(), buffers()
        before = ring_topk.launches
        for d_ in dict.fromkeys(devs):
            shards = [s_ for s_ in range(len(devs)) if devs[s_] == d_]
            ring_topk.ring_step([windows[s_] for s_ in shards], [got_[s_] for s_ in shards])
        step_launches = ring_topk.launches - before
        ring_topk.ring_step_plain(windows, ref_)
        torch.cuda.synchronize()
        if step_launches != len(set(devs)):
            fail(f"a ring step launched {step_launches} times over {len(set(devs))} sending cards")
        for s_, ((gv, gi), (rv, ri)) in enumerate(zip(got_, ref_)):
            if not (torch.equal(gv, rv) and torch.equal(gi, ri)):
                fail(f"ring_step != plain copy ({label}, shard {s_})")
        want_v, want_i = stable_top_k(torch.where(sel, scores, float("-inf")), WINDOW)
        for s_, (v, i) in enumerate(ring_topk.ring_topk(windows, WINDOW)):
            if not (torch.equal(v.cpu(), want_v) and torch.equal(i.cpu().long(), want_i)):
                fail(f"ring_topk != global stable top-k ({label}, shard {s_})")
        print(f"# ring_hop {label}: every hop and a ring step ({step_launches} launch(es)) "
              f"bit-equal to the plain copies; ring_topk (k={WINDOW}) == global stable top-k on "
              "every shard")
        return windows

    ring_dev = [dev] * 4
    hop_windows = check_ring(ring_dev, "4 shards on one card")
    k4_err = 0.0  # copies, compared for equality above
    if torch.cuda.device_count() >= 2:
        two = [torch.device("cuda", 0), torch.device("cuda", 1)] * 2
        mesh_lib.make_mesh(4, 1, devices=two)  # enables peer access on the ring
        check_ring(two, "4 shards on two cards (peer stores)")
        peer_run = True
    else:
        print("# ring_hop across two cards: NOT RUN (one card visible); the peer path "
              "is unverified here")
        peer_run = False

    # -- phase 4: the main path ------------------------------------------
    bundle = DataBundle(
        train_x=pool_np, train_y=labels(pool_np), test_x=test_np, test_y=labels(test_np),
        name="bench_pool",
    )

    def cfg(fused: bool, mesh=(1, 1), **kw) -> ExperimentConfig:
        return dataclasses.replace(_cfg(fused, mesh), **kw)

    def _cfg(fused: bool, mesh=(1, 1)) -> ExperimentConfig:
        return ExperimentConfig(
            forest=ForestConfig(n_trees=TREES, max_depth=DEPTH, max_bins=BINS,
                                fit="device", kernel="pallas"),
            strategy=StrategyConfig(name="uncertainty", window_size=WINDOW),
            mesh=MeshConfig(*mesh),
            n_start=N_START, max_rounds=ROUNDS, fused_round=fused, seed=args.seed,
        )

    def counts():
        return {"forest_leaves": trees_pallas.launches, "round_megakernel": round_fused.launches,
                "fused_votes": round_fused.votes_launches, "ring_hop": ring_topk.launches}

    def zero_counts():
        trees_pallas.launches = round_fused.launches = 0
        round_fused.votes_launches = ring_topk.launches = 0

    # Each path's launches are counted from 0 over its own run. Single
    # device: the fused round launches K2 to score and K1 for test accuracy,
    # the unfused round K1 for both. Mesh 4 x 2: the fused round launches K3
    # on each of the 8 shards, one K4 per ring step (3 steps, every sender
    # on the one card) and K1 per shard for accuracy;
    # the unfused round K1 per shard to score and again for accuracy.
    want_launches = {
        "fused": {"forest_leaves": ROUNDS, "round_megakernel": ROUNDS,
                  "fused_votes": 0, "ring_hop": 0},
        "unfused": {"forest_leaves": 2 * ROUNDS, "round_megakernel": 0,
                    "fused_votes": 0, "ring_hop": 0},
        "mesh_fused": {"forest_leaves": 8 * ROUNDS, "round_megakernel": 0,
                       "fused_votes": 8 * ROUNDS, "ring_hop": 3 * ROUNDS},
        "mesh_unfused": {"forest_leaves": 16 * ROUNDS, "round_megakernel": 0,
                         "fused_votes": 0, "ring_hop": 0},
    }
    launches = {}
    runs = {}

    def drive(path: str, fused: bool, mesh=(1, 1), devices=None, **kw):
        dbg = Debugger(enabled=False)
        zero_counts()
        t0 = time.perf_counter()
        res = loop.run_experiment(cfg(fused, mesh, **kw), bundle=bundle, debugger=dbg, device=dev,
                                  devices=devices)
        wall = time.perf_counter() - t0
        launches[path] = counts()
        runs[path] = res
        print(f"# main path {path}: {wall:.2f}s wall, launches {launches[path]}")
        if launches[path] != want_launches[path]:
            fail(f"main path {path} launched {launches[path]}, want {want_launches[path]}")
        for r in res.records:
            print(f"#   round {r.round}: n_labeled={r.n_labeled} accuracy={r.accuracy:.6f} "
                  f"fit={r.train_time:.4f}s round={r.score_time:.4f}s eval={r.eval_time:.4f}s")

    for fused in (True, False):
        drive("fused" if fused else "unfused", fused)
    recs = {f: [(r.round, r.n_labeled, r.accuracy) for r in runs["fused" if f else "unfused"].records]
            for f in (True, False)}
    if recs[True] != recs[False]:
        fail(f"fused and unfused records differ: {recs[True]} vs {recs[False]}")
    want = [N_START + i * WINDOW for i in range(ROUNDS)]
    if [r[1] for r in recs[True]] != want:
        fail(f"n_labeled {[r[1] for r in recs[True]]} != {want}")
    if not all(np.isfinite(r[2]) and 0.0 <= r[2] <= 1.0 for r in recs[True]):
        fail("accuracy records are not finite fractions")
    masks = {f: runs["fused" if f else "unfused"].final_labeled_mask for f in (True, False)}
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

    # -- phase 4b: the mesh path -------------------------------------------
    one_card = [dev] * 8
    for fused in (True, False):
        path = "mesh_fused" if fused else "mesh_unfused"
        drive(path, fused, mesh=(4, 2), devices=one_card)
        got = [(r.round, r.n_labeled, r.accuracy) for r in runs[path].records]
        if got != recs[True]:
            fail(f"{path} records differ from the single-device run: {got} vs {recs[True]}")
        if not torch.equal(runs[path].final_labeled_mask, masks[True]):
            fail(f"{path} final labeled mask differs from the single-device run")
    print("# mesh 4 x 2 on one card: fused and unfused == single device (records and final "
          f"{N_POOL}-row mask)")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        # The same mesh spread over the visible cards, shard (s, m) on card
        # (s + m) mod n: ring hops and model-shard sums cross cards.
        spread = [torch.device("cuda", (s_ + m) % n_cards) for s_ in range(4) for m in range(2)]
        for fused in (True, False):
            path = "mesh_cards_fused" if fused else "mesh_cards_unfused"
            want_launches[path] = dict(want_launches["mesh_fused" if fused else "mesh_unfused"])
            if fused:  # one K4 per sending card and ring step (model column 0 sends)
                want_launches[path]["ring_hop"] = 3 * len({spread[2 * s_] for s_ in range(4)}) * ROUNDS
            drive(path, fused, mesh=(4, 2), devices=spread)
            got = [(r.round, r.n_labeled, r.accuracy) for r in runs[path].records]
            if got != recs[True] or not torch.equal(
                    runs[path].final_labeled_mask.to(dev), masks[True]):
                fail(f"{path} differs from the single-device run")
        print(f"# mesh 4 x 2 across {n_cards} cards: fused and unfused == single device")
    else:
        print("# mesh 4 x 2 across cards: NOT RUN (one card visible)")
    small_mesh = dataclasses.replace(small, mesh=MeshConfig(4, 2), fused_round=True)
    for fused in (True, False):
        c = dataclasses.replace(small_mesh, fused_round=fused)
        on_card = loop.run_experiment(c, device=dev, devices=one_card).to_reference_log()
        on_cpu = loop.run_experiment(c, device="cpu").to_reference_log()
        if on_card != on_cpu:
            fail(f"small mesh run (fused={fused}) on the card != CPU mesh:\n{on_card}\n{on_cpu}")
    print("# small checkerboard mesh run 4 x 2: card == CPU plain versions, fused and unfused")

    # -- phase 4c: the chunked driver ---------------------------------------
    K, CHUNK_ROUNDS = 4, 6
    n_chunks = -(-CHUNK_ROUNDS // K)
    for fused in (True, False):
        name = "fused" if fused else "unfused"
        per_kernel = 1 if fused else 2  # K1 launches a round; K2 launches once when fused
        ref_path = f"per_round_{name}_{CHUNK_ROUNDS}"
        want_launches[ref_path] = {
            "forest_leaves": per_kernel * CHUNK_ROUNDS,
            "round_megakernel": CHUNK_ROUNDS if fused else 0, "fused_votes": 0, "ring_hop": 0}
        drive(ref_path, fused, max_rounds=CHUNK_ROUNDS)
        ref = runs[ref_path]
        ref_recs = [(r.round, r.n_labeled, r.accuracy) for r in ref.records]
        for depth in (1, 2):
            path = f"chunked_{name}_depth{depth}"
            # One eager warm-up round, then K rounds per replay (a replay is
            # counted as the launches its capture recorded).
            rounds_run = 1 + n_chunks * K
            want_launches[path] = {
                "forest_leaves": per_kernel * rounds_run,
                "round_megakernel": rounds_run if fused else 0, "fused_votes": 0, "ring_hop": 0}
            drive(path, fused, max_rounds=CHUNK_ROUNDS, rounds_per_launch=K, pipeline_depth=depth)
            res = runs[path]
            got = [(r.round, r.n_labeled, r.accuracy) for r in res.records]
            if got != ref_recs:
                fail(f"{path} records differ from the per-round run: {got} vs {ref_recs}")
            if not torch.equal(res.final_labeled_mask, ref.final_labeled_mask):
                fail(f"{path} final labeled mask differs from the per-round run")
            g = res.graph_stats
            if g is None or g["captures"] != 1 or g["replays"] != n_chunks:
                fail(f"{path}: graph captures/replays {g}, want 1 capture and {n_chunks} replays")
            st = res.pipeline_stats
            print(f"#   {path}: graph captures {g['captures']}, replays {g['replays']}, private "
                  f"pool {g['pool_bytes'] / 2**20:.0f} MiB, launches per replay "
                  f"{g['launches_per_replay']}; chunks {st.chunks}, vetoed {st.vetoed}, "
                  f"touchdown hidden {st.touchdown_hidden_fraction:.3f}")
    print(f"# chunked driver (K = {K}, max_rounds = {CHUNK_ROUNDS}): fused and unfused, depth 1 "
          f"and 2 == per-round (records and final {N_POOL}-row mask); each chunk a graph replay")

    # The chunk body, eagerly, with host syncs turned into errors.
    st0 = state_lib.set_start_state(
        state_lib.init_pool_state(bundle.train_x, bundle.train_y, prng.key(args.seed), dev),
        N_START)
    binned0 = trees_train.make_bins(st0.x, BINS)
    tx_dev = torch.from_numpy(test_np).to(dev)
    ty_dev = torch.from_numpy(labels(test_np)).to(dev)
    deep_forest = ForestConfig(n_trees=TREES, max_depth=DEEP, max_bins=BINS, fit="device",
                               kernel="gather")
    density = StrategyConfig(name="density", window_size=WINDOW)
    for c in (cfg(True), cfg(False), cfg(False, forest=deep_forest),
              cfg(False, strategy=density)):
        fused = c.fused_round
        body = loop.make_chunk_fn(
            get_strategy(c.strategy), WINDOW, 2,
            loop.make_device_fit(c, binned0.edges, N_START + 4 * WINDOW), N_POOL, fused_round=fused)
        body_args = (binned0.codes, state_lib.as_carry(st0),
                     StrategyAux(seed_mask=st0.labeled_mask.clone()), prng.key(7, dev),
                     tx_dev, ty_dev, torch.as_tensor(99, dtype=torch.int32).to(dev))
        body(*body_args)  # constants cached, kernels loaded
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, extras, _ = body(*body_args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if int(extras.n_active) != 2:
            fail("the eager chunk body did not run two active rounds")
    del st0, binned0, tx_dev, ty_dev, body_args
    print("# chunk body, eager, torch.cuda.set_sync_debug_mode('error'): no host sync, fused, "
          f"unfused, the depth-{DEEP} gather form and density")

    # Seconds per round, steady state: rounds 5-12 of a 12-round run (chunks 2
    # and 3 of 3; the first chunk holds the warm-up round and the capture).
    TIMED = 12
    chunk_times = {}
    for fused in (True, False):
        name = "fused" if fused else "unfused"
        for label, kw in (("per_round", {}),
                          ("chunked_depth1", dict(rounds_per_launch=K, pipeline_depth=1)),
                          ("chunked_depth2", dict(rounds_per_launch=K, pipeline_depth=2))):
            t0 = time.perf_counter()
            res = loop.run_experiment(cfg(fused, max_rounds=TIMED, **kw), bundle=bundle, device=dev)
            wall = time.perf_counter() - t0
            steady = [r.total_time for r in res.records[K:]]
            chunk_times[f"{name}_{label}"] = sum(steady) / len(steady)
            print(f"# seconds per round, {name} {label}: {chunk_times[f'{name}_{label}']:.5f} "
                  f"(rounds {K + 1}-{TIMED}; whole run {wall:.2f}s incl. set-up; {kind}, {smi})")

    # -- phase 4d: the deep gather path --------------------------------------
    t_phase = time.perf_counter()
    # Depth 12 is past the path-matrix limit (10): the device fit emits the
    # gather form and no kernel of the port runs on this path. The fit window
    # is the label cap, N_START + ROUNDS * WINDOW rows, in both drivers.
    zero = {"forest_leaves": 0, "round_megakernel": 0, "fused_votes": 0, "ring_hop": 0}
    want_launches["gather_deep"] = dict(zero)
    drive("gather_deep", False, forest=deep_forest)
    # One eager warm-up round, then one replay of a K-round chunk.
    want_launches["gather_deep_chunked"] = dict(zero)
    drive("gather_deep_chunked", False, forest=deep_forest, rounds_per_launch=K)

    def check_chunked(path, ref_path):
        got = [(r.round, r.n_labeled, r.accuracy) for r in runs[path].records]
        want_ = [(r.round, r.n_labeled, r.accuracy) for r in runs[ref_path].records]
        if got != want_ or [r[1] for r in got] != [N_START + i * WINDOW for i in range(ROUNDS)]:
            fail(f"{path} records differ from the per-round run: {got} vs {want_}")
        if not torch.equal(runs[path].final_labeled_mask, runs[ref_path].final_labeled_mask):
            fail(f"{path} final labeled mask differs from the per-round run")
        g = runs[path].graph_stats
        if g is None or g["captures"] != 1 or g["replays"] != 1:
            fail(f"{path}: graph captures/replays {g}, want 1 and 1")
        print(f"#   {path}: == per-round (records and final mask); graph private pool "
              f"{g['pool_bytes'] / 2**20:.0f} MiB, launches per replay {g['launches_per_replay']}")

    check_chunked("gather_deep_chunked", "gather_deep")
    window_rows = loop._resolve_fit_budget(cfg(False, forest=deep_forest), N_POOL, N_START)
    small_deep = dataclasses.replace(
        small, fused_round=False,
        forest=dataclasses.replace(small.forest, kernel="gather", max_depth=DEEP))
    for c in (small_deep, dataclasses.replace(small_deep, rounds_per_launch=2)):
        on_card = loop.run_experiment(c, device=dev)
        on_cpu = loop.run_experiment(c, device="cpu")
        if on_card.to_reference_log() != on_cpu.to_reference_log() or not torch.equal(
                on_card.final_labeled_mask.cpu(), on_cpu.final_labeled_mask):
            fail(f"small depth-{DEEP} gather run (rounds_per_launch "
                 f"{c.rounds_per_launch}) on the card != CPU")
    print(f"# deep gather path (depth {DEEP}, kernel 'gather', fit window {window_rows} rows): "
          f"chunked (K = {K}) == per-round; small checkerboard runs, per round and chunked: "
          "card == CPU")
    print(f"# phase 4d: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 4e: density ----------------------------------------------------
    t_phase = time.perf_counter()
    # K1 scores (votes) and evaluates: twice a round; chunked, one eager
    # warm-up round and one replay of K rounds.
    want_launches["density"] = dict(zero, forest_leaves=2 * ROUNDS)
    drive("density", False, strategy=density)
    want_launches["density_chunked"] = dict(zero, forest_leaves=2 * (1 + K))
    drive("density_chunked", False, strategy=density, rounds_per_launch=K)
    check_chunked("density_chunked", "density")
    small_dens = dataclasses.replace(small, fused_round=False,
                                     strategy=StrategyConfig(name="density", window_size=15))
    for c in (small_dens, dataclasses.replace(small_dens, rounds_per_launch=2)):
        on_card = loop.run_experiment(c, device=dev)
        on_cpu = loop.run_experiment(c, device="cpu")
        if on_card.to_reference_log() != on_cpu.to_reference_log() or not torch.equal(
                on_card.final_labeled_mask.cpu(), on_cpu.final_labeled_mask):
            fail(f"small density run (rounds_per_launch {c.rounds_per_launch}) on the card != CPU")
    small_x = torch.from_numpy(np.ascontiguousarray(
        get_dataset(small.data).train_x, dtype=np.float32))
    mass_err = {}
    for label, (x_, mask_) in {"small pool": (small_x, torch.arange(small_x.shape[0]) % 3 > 0),
                               "bench pool": (pool, selectable)}.items():
        on_card = similarity.similarity_mass(x_.to(dev), mask_.to(dev)).cpu()
        on_cpu = similarity.similarity_mass(x_.cpu(), mask_.cpu())
        scale = float(on_cpu.abs().max())
        mass_err[label] = float((on_card - on_cpu).abs().max()) / scale
        if not mass_err[label] <= similarity.MASS_RTOL:
            fail(f"similarity_mass at the {label}: card - CPU reaches {mass_err[label]:.3g} of "
                 f"the largest |mass|, over MASS_RTOL = {similarity.MASS_RTOL}")
    print(f"# density: chunked (K = {K}) == per-round at the bench width; small checkerboard runs, "
          "per round and chunked: card == CPU (picks, records, final mask); similarity_mass card "
          f"vs CPU, largest difference over the largest |mass|: {mass_err} (MASS_RTOL "
          f"{similarity.MASS_RTOL})")
    print(f"# phase 4e: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 5: times ----------------------------------------------------
    x_full = pool.contiguous()
    out_bytes = TREES * N_POOL * 4
    T = gf.n_trees
    depth = gf.value.shape[1].bit_length() - 1  # a heap forest: L = 2 ** depth
    # The least work of the leaf function: a row reaches its leaf in a tree
    # by one compare per level of its root-to-leaf path; the bytes count the
    # forest in its heap form.
    k1_ops = N_POOL * T * depth
    k1 = {}
    for label, (g, x) in (("pool", (gf, x_full)), ("test", (gf, test_x.contiguous())),
                          ("mesh shard", (gf_shard, pool[:n_shard].contiguous()))):
        h = trees_pallas.heap_operands(g)
        ms = cuda_ms(lambda: trees_pallas._launch_leaves(h, x), reps=9)
        dev_ms = graph_ms(lambda: trees_pallas._launch_leaves(h, x))
        plain = cuda_ms(lambda: trees_pallas.predict_leaves_plain(g, x), reps=3)
        walk_plain = cuda_ms(lambda: trees_pallas.walk_leaves_plain(h, x), reps=3)
        lim, by = bound(nbytes(x, h.nodes, h.val) + g.n_trees * x.shape[0] * 4,
                        x.shape[0] * g.n_trees * depth)
        k1[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, walk_plain_ms=walk_plain,
                         bound_ms=lim, bound_by=by)
        print(f"# time forest_leaves {label} (n={x.shape[0]}, T={g.n_trees}): {ms:.4f} ms kernel "
              f"({dev_ms:.4f} ms device, graph-replayed), "
              f"{plain:.4f} ms plain, {walk_plain:.4f} ms walk_leaves_plain, bound {lim:.4f} ms "
              f"by {by} ({100 * lim / dev_ms:.3f}% of it in device time; launch "
              f"{trees_pallas.leaves_launch_config(h, *x.shape, dev)}; {kind}, {smi})")
    # K1 on phase 2d's host-fit heaps: the same kernel and shapes as the
    # device-fit forest at the pool, other trees.
    hh = host_pf.heap
    h_ms = cuda_ms(lambda: trees_pallas._launch_leaves(hh, x_full), reps=9)
    h_dev = graph_ms(lambda: trees_pallas._launch_leaves(hh, x_full))
    h_plain = cuda_ms(lambda: trees_pallas.predict_leaves_plain(host_pf.gf, x_full), reps=3)
    k1["host-fit heaps"] = dict(ms=h_ms, device_ms=h_dev, plain_ms=h_plain,
                                bound_ms=k1["pool"]["bound_ms"], bound_by=k1["pool"]["bound_by"])
    print(f"# time forest_leaves on the host-fit heaps (n={N_POOL}, T={TREES}, depth {DEPTH}): "
          f"{h_ms:.4f} ms kernel ({h_dev:.4f} ms device, graph-replayed; the device-fit forest "
          f"{k1['pool']['device_ms']:.4f}), {h_plain:.4f} ms plain ({kind}, {smi})")
    k1_ms, k1_plain = k1["pool"]["ms"], k1["pool"]["plain_ms"]
    k1_bound, k1_by = k1["pool"]["bound_ms"], k1["pool"]["bound_by"]
    # K2 and K3: bytes are x once, the forest's heap form once (nodes, and
    # the leaf values the vote bits come from), the mask and the table (K2)
    # and what is written (K2's per-tile candidates, K3's [n] int32 votes);
    # the least work is the walk and the vote per (row, tree). Each is also
    # timed at the streamed shape.
    table = round_fused.score_table(TREES, "uncertainty", dev)
    kk = min(WINDOW, round_fused.TILE_ROWS)

    def time_votes(name, g, x):
        h = trees_pallas.heap_operands(g)
        sel = selectable[:x.shape[0]]
        tab = round_fused.score_table(g.n_trees, "uncertainty", dev)
        if name == "round_megakernel":
            def launch():
                return round_fused._launch_megakernel(h, x, sel, tab, WINDOW)
            plain = cuda_ms(lambda: round_fused.megakernel_plain(g, x, sel, tab, WINDOW), reps=3)
            walk_plain = cuda_ms(lambda: round_fused.tile_topk_plain(
                round_fused.walk_votes_plain(h, x), sel, tab, WINDOW), reps=3)
            io = nbytes(sel, tab) + -(-x.shape[0] // round_fused.TILE_ROWS) * kk * 8
        else:
            def launch():
                return round_fused._launch_votes(h, x)
            plain = cuda_ms(lambda: round_fused.fused_votes_plain(g, x), reps=3)
            walk_plain = cuda_ms(lambda: round_fused.walk_votes_plain(h, x), reps=3)
            io = 4 * x.shape[0]
        lim, by = bound(nbytes(x, h.nodes, h.val) + io, x.shape[0] * g.n_trees * (depth + 1))
        ms = cuda_ms(launch, reps=9)
        dev_ms = graph_ms(launch)
        cfg0 = round_fused.launch_config(name, h, *x.shape, dev)
        print(f"# time {name} (n={x.shape[0]}, T={g.n_trees}): {ms:.4f} ms kernel ({dev_ms:.4f} "
              f"ms device, graph-replayed), {plain:.4f} ms plain, {walk_plain:.4f} ms walk plain, "
              f"bound {lim:.4f} ms by {by} ({100 * lim / dev_ms:.3f}% of it in device time); "
              f"launch {cfg0} ({kind}, {smi})")
        return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, walk_plain_ms=walk_plain,
                    bound_ms=lim, bound_by=by, launch_config=cfg0)

    k2 = {"pool": time_votes("round_megakernel", gf, x_full),
          "streamed 256 trees": time_votes("round_megakernel", gf256, x_full)}
    k2_ms, k2_plain = k2["pool"]["ms"], k2["pool"]["plain_ms"]
    k2_bound, k2_by = k2["pool"]["bound_ms"], k2["pool"]["bound_by"]
    # The fused round's tile merge: a stable sort of n_tiles x k candidates.
    tv, ti = round_fused._launch_megakernel(heap, x_full, selectable, table, WINDOW)
    merge_ms = cuda_ms(lambda: merge_tile_topk(tv, ti, WINDOW), reps=9)
    merge_dev = graph_ms(lambda: merge_tile_topk(tv, ti, WINDOW))
    k2_dev = k2["pool"]["device_ms"]
    print(f"# time merge_tile_topk ({tv.shape[0]} tiles x {tv.shape[1]} candidates, k={WINDOW}): "
          f"{merge_ms:.4f} ms ({merge_dev:.4f} ms device, graph-replayed: "
          f"{100 * merge_dev / (merge_dev + k2_dev):.1f}% of K2 + merge in device time) "
          f"({kind}, {smi})")
    # K3 at the mesh's per-shard shape (its main path: 71,202 rows x 50
    # trees), at the full width and at the streamed shape.
    k3 = {"shard": time_votes("fused_votes", gf_shard, pool[:n_shard].contiguous()),
          "full": time_votes("fused_votes", gf, x_full),
          "streamed 256 trees": time_votes("fused_votes", gf256, x_full)}
    # K4: one ring step of the mesh on the card, four k = 100 windows (800
    # bytes read and 800 written each) into preallocated buffers, timed over
    # 100 back-to-back steps; the library yardstick is four Tensor.copy_
    # pairs into the same buffers. A hop is a quarter of a step.
    step_dst = [(torch.empty_like(v), torch.empty_like(i)) for v, i in hop_windows]
    step_ms = cuda_ms(lambda: ring_topk.ring_step(hop_windows, step_dst), reps=9, inner=100)
    step_plain = cuda_ms(lambda: ring_topk.ring_step_plain(hop_windows, step_dst), reps=9,
                         inner=100)
    lib_step_ms = cuda_ms(lambda: [(dv.copy_(v), di.copy_(i))
                                   for (v, i), (dv, di) in zip(hop_windows, step_dst)],
                          reps=9, inner=100)
    hv, hi = hop_windows[0]
    hop_ms = cuda_ms(lambda: ring_topk.hop(hv, hi, dev), reps=9, inner=100)
    n_win = len(hop_windows)
    k4_ms, k4_plain, k4_lib = step_ms / n_win, step_plain / n_win, lib_step_ms / n_win
    k4_bound, k4_by = bound(2 * nbytes(hv, hi), 0)
    print(f"# time ring_step ({n_win} windows, k={WINDOW}, one launch): step_ms {step_ms:.4f}, "
          f"ms a hop {k4_ms:.4f}; plain copies {step_plain:.4f} ms a step; {n_win} Tensor.copy_ "
          f"pairs {lib_step_ms:.4f} ms; a lone hop (fresh buffers) {hop_ms:.4f} ms; bound "
          f"{k4_bound:.7f} ms a hop by {k4_by} ({kind}, {smi})")
    if step_ms > lib_step_ms:
        print(f"# NOTE ring_step ({step_ms:.4f} ms) is slower than {n_win} Tensor.copy_ pairs "
              f"({lib_step_ms:.4f} ms) in this run")
    # K5 and K6 on packed operands at (bn, bt) = (2048, 8), the hi + lo
    # payload. The bound is the function's, as K1's: x^T read once, the
    # forest once in its heap form, the [T, n] f32 output written once; the
    # least work is K1's walk. The bound of the earlier ancestor-count kernels
    # counted the path-matrix operands they read (node slots padded to 32,
    # plus and minus masks, targets, the two payload planes; K6's over 32 S
    # slots), printed beside.
    heap_bytes = nbytes(heap.nodes, heap.val)
    t_pad, L = -(-T // 8) * 8, 2 ** depth
    p5 = lv._prep_transposed(gf, x_full, 2048, 8)
    k5_ms = cuda_ms(lambda: lv._launch_transposed(p5, 2048, 8))
    k5_dev = graph_ms(lambda: lv._launch_transposed(p5, 2048, 8))
    k5_outer_ms = cuda_ms(lambda: lv._launch_transposed(p5, 2048, 8, tree_outer=True))
    k5_outer_dev = graph_ms(lambda: lv._launch_transposed(p5, 2048, 8, tree_outer=True))
    k5_call_ms = cuda_ms(lambda: lv.predict_leaves_transposed(gf, x_full, bn=2048, bt=8))
    k5_plain = cuda_ms(lambda: lv.predict_leaves_transposed_plain(gf, x_full), reps=3)
    k5_walk_plain = cuda_ms(lambda: lv.walk_transposed_plain(p5), reps=3)
    k5_bound, k5_by = bound(nbytes(p5.xT) + heap_bytes + out_bytes, k1_ops)
    i_pad = -(-(L - 1) // 32) * 32
    k5_count_bound, _ = bound(nbytes(p5.xT) + out_bytes + t_pad * (
        8 * i_pad + 8 * L * i_pad // 32 + 4 * L + 4 * L), k1_ops)
    p6 = lv._segmented_operands(gf, pool, 2048, 8)
    k6_ms = cuda_ms(lambda: lv._launch_segmented(p6, 2048, 8))
    k6_dev = graph_ms(lambda: lv._launch_segmented(p6, 2048, 8))
    k6_plain = cuda_ms(lambda: lv._segmented_plain(p6), reps=3)
    k6_walk_plain = cuda_ms(lambda: lv.walk_segmented_plain(p6), reps=3)
    k6_bound, k6_by = bound(nbytes(p6.xT) + heap_bytes + out_bytes, k1_ops)
    k6_count_bound, _ = bound(nbytes(p6.xT) + out_bytes + t_pad * (
        4 * 32 * p6.S + 8 * L * p6.S + 4 * L + 4 * L), k1_ops)
    print(f"# time forest_leaves_transposed (bn 2048, bt 8): {k5_ms:.4f} ms kernel ({k5_dev:.4f} "
          f"ms device, graph-replayed), tree_outer {k5_outer_ms:.4f} ({k5_outer_dev:.4f} device); "
          f"{k5_call_ms:.4f} ms a predict_leaves_transposed call (x^T relayout included); "
          f"{k5_plain:.4f} ms plain, {k5_walk_plain:.4f} ms walk_transposed_plain; bound "
          f"{k5_bound:.4f} ms by {k5_by} ({100 * k5_bound / k5_dev:.3f}% of it in device time; "
          f"ancestor-count operand bound {k5_count_bound:.4f} ms; {kind}, {smi})")
    print(f"# time forest_leaves_segmented (bn 2048, bt 8, S = {p6.S}): {k6_ms:.4f} ms kernel "
          f"({k6_dev:.4f} ms device, graph-replayed), {k6_plain:.4f} ms plain, "
          f"{k6_walk_plain:.4f} ms walk_segmented_plain; bound {k6_bound:.4f} ms by {k6_by} "
          f"({100 * k6_bound / k6_dev:.3f}% of it in device time; ancestor-count operand bound "
          f"{k6_count_bound:.4f} ms; {kind}, {smi})")
    del p5, p6
    t_phase = time.perf_counter()
    # The new paths' evaluation: votes of the depth-12 gather form at the
    # pool (plain PyTorch, no kernel: bytes are x, the five node arrays and
    # the [n] votes; the least work one compare a level per (row, tree)),
    # the similarity mass (x, the mask and the [n] mass), and the host's
    # packing of a host-fit forest into heaps (from the card and back).
    binned_d = trees_train.make_bins(train_x, BINS)
    deep_f = trees_train.heap_packed_forest(*trees_train.fit_forest_device(
        binned_d.codes, train_y, torch.ones(N_START, device=dev), binned_d.edges,
        prng.key(args.seed + DEEP), n_trees=TREES, max_depth=DEEP, n_bins=BINS), DEEP)
    gather_ms = cuda_ms(lambda: forest_eval.votes(deep_f, x_full), reps=5)
    gather_dev = graph_ms(lambda: forest_eval.votes(deep_f, x_full), reps=5, inner=5)
    node_bytes = sum(nbytes(getattr(deep_f, f).contiguous())
                     for f in ("feature", "threshold", "left", "right", "value"))
    gather_bound, gather_by = bound(nbytes(x_full) + node_bytes + 4 * N_POOL, N_POOL * TREES * DEEP)
    print(f"# time forest_eval.votes, gather form (n={N_POOL}, T={TREES}, depth {DEEP}, plain "
          f"PyTorch): {gather_ms:.4f} ms ({gather_dev:.4f} ms device, graph-replayed), bound "
          f"{gather_bound:.4f} ms by {gather_by} ({100 * gather_bound / gather_dev:.3f}% of it in "
          f"device time; {kind}, {smi})")
    mass_ms = cuda_ms(lambda: similarity.similarity_mass(x_full, selectable), reps=9)
    mass_dev = graph_ms(lambda: similarity.similarity_mass(x_full, selectable))
    mass_bound, mass_by = bound(nbytes(x_full, selectable) + 4 * N_POOL, 7 * N_POOL * N_FEAT)
    print(f"# time similarity_mass (n={N_POOL}, d={N_FEAT}): {mass_ms:.4f} ms ({mass_dev:.4f} ms "
          f"device, graph-replayed), bound {mass_bound:.4f} ms by {mass_by} "
          f"({100 * mass_bound / mass_dev:.3f}% of it in device time; {kind}, {smi})")
    pack_times = []
    for _ in range(7):
        t0 = time.perf_counter()
        trees_pallas.heap_from_packed(host_loaded)
        torch.cuda.synchronize()
        pack_times.append(1e3 * (time.perf_counter() - t0))
    pack_ms = statistics.median(pack_times)
    print(f"# time heap_from_packed ({TREES} host-fit-shaped trees, max_depth {DEPTH}, from the "
          f"card to numpy and back): {pack_ms:.3f} ms host, median of 7 ({kind}, {smi})")
    new_paths = {
        "gather_votes": dict(ms=gather_ms, device_ms=gather_dev, bound_ms=gather_bound,
                             bound_by=gather_by, depth=DEEP),
        "similarity_mass": dict(ms=mass_ms, device_ms=mass_dev, bound_ms=mass_bound,
                                bound_by=mass_by, card_vs_cpu_over_max=mass_err),
        "heap_pack_host_ms": pack_ms,
        "rounds": {p: [dict(fit=r.train_time, round=r.score_time, eval=r.eval_time)
                       for r in runs[p].records] for p in ("gather_deep", "density")},
    }
    del deep_f, binned_d
    print(f"# phase 5, the new paths' times: {time.perf_counter() - t_phase:.1f}s")
    for fused in (True, False):
        profile_round(loop, cfg(fused), bundle, dev, "fused" if fused else "unfused")
    profile_round(loop, cfg(True, (4, 2)), bundle, dev, "mesh 4 x 2 fused", devices=one_card)

    # -- phase 6: the port's bench ------------------------------------------
    for mode, extra in (("score", []), ("round", []), ("variants", ["--variants", "v0,v1,v8,r1"])):
        if mode == "variants":
            lv.transposed_launches = lv.segmented_launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--mode", mode, *extra])
        lines = out.getvalue().splitlines()
        if rc != 0 or len(lines) != 1:
            fail(f"bench --mode {mode} exited {rc} and printed {len(lines)} lines: {lines[-1:]}")
        print(lines[0])
        payload = json.loads(lines[0])
        if "error" in payload or not payload.get("value", 0) > 0 or payload.get("card") != smi:
            fail(f"bench --mode {mode}: bad line")
        print(f"# bench --mode {mode}: {time.perf_counter() - t0:.1f}s, {payload['metric']} = "
              f"{payload['value']}")
    variant_launches = {"forest_leaves_transposed": lv.transposed_launches,
                        "forest_leaves_segmented": lv.segmented_launches}
    print(f"# bench --mode variants launches, counted from 0: {variant_launches}")
    if not (lv.transposed_launches > 0 and lv.segmented_launches > 0):
        fail(f"the variants bench launched K5 {lv.transposed_launches} and K6 "
             f"{lv.segmented_launches} times")
    print(f"# total {time.perf_counter() - t_all:.1f}s")

    pkg = "distributed_active_learning_tpu_torch/csrc"
    print(json.dumps({"kernels": [
        {"name": "forest_leaves", "route": "cuda", "source": f"{pkg}/forest_leaves.cu",
         "replaces": "distributed_active_learning_tpu/ops/trees_pallas.py:204",
         "launches": launches["fused"]["forest_leaves"],
         "launches_by_path": {p: launches[p]["forest_leaves"] for p in launches},
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "by_shape": k1, "launch_config": k1_cfg},
        {"name": "round_megakernel", "route": "cuda", "source": f"{pkg}/round_megakernel.cu",
         "replaces": "distributed_active_learning_tpu/ops/round_fused.py:166",
         "launches": launches["fused"]["round_megakernel"],
         "launches_by_path": {p: launches[p]["round_megakernel"] for p in launches},
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "by_shape": k2, "launch_config": k2["pool"]["launch_config"]},
        {"name": "fused_votes", "route": "cuda", "source": f"{pkg}/fused_votes.cu",
         "replaces": "distributed_active_learning_tpu/ops/round_fused.py:286",
         "launches": launches["mesh_fused"]["fused_votes"],
         "launches_by_path": {p: launches[p]["fused_votes"] for p in launches},
         "max_abs_err": k3_err, "ms": k3["shard"]["ms"], "plain_ms": k3["shard"]["plain_ms"],
         "bound_ms": k3["shard"]["bound_ms"], "bound_by": k3["shard"]["bound_by"],
         "library_ms": None, "by_shape": k3, "launch_config": k3["shard"]["launch_config"],
         "full_width": {key: k3["full"][key] for key in ("ms", "plain_ms", "bound_ms",
                                                        "bound_by")}},
        {"name": "ring_hop", "route": "cuda", "source": f"{pkg}/ring_hop.cu",
         "replaces": "distributed_active_learning_tpu/ops/ring_topk.py:109",
         "launches": launches["mesh_fused"]["ring_hop"],
         "launches_by_path": {p: launches[p]["ring_hop"] for p in launches},
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": k4_lib,
         "step_ms": step_ms, "library_step_ms": lib_step_ms, "hop_ms": hop_ms,
         "peer_path_run": peer_run},
        {"name": "forest_leaves_transposed", "route": "cuda",
         "source": f"{pkg}/forest_leaves_transposed.cu",
         "replaces": "benches/pallas_variants.py:116",
         "launches": variant_launches["forest_leaves_transposed"],
         "max_abs_err": k5_err, "ms": k5_ms, "device_ms": k5_dev, "plain_ms": k5_plain,
         "bound_ms": k5_bound, "bound_by": k5_by, "library_ms": None,
         "tree_outer_ms": k5_outer_ms, "tree_outer_device_ms": k5_outer_dev,
         "call_ms": k5_call_ms, "walk_plain_ms": k5_walk_plain},
        {"name": "forest_leaves_segmented", "route": "cuda",
         "source": f"{pkg}/forest_leaves_segmented.cu",
         "replaces": "benches/pallas_variants.py:359",
         "launches": variant_launches["forest_leaves_segmented"],
         "max_abs_err": k6_err, "ms": k6_ms, "device_ms": k6_dev, "plain_ms": k6_plain,
         "bound_ms": k6_bound, "bound_by": k6_by, "library_ms": None,
         "segment_slots": seg_S, "walk_plain_ms": k6_walk_plain},
    ], "seconds_per_round": chunk_times, "new_paths": new_paths, "merge_tile_topk_ms": merge_ms,
        "merge_tile_topk_device_ms": merge_dev}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
