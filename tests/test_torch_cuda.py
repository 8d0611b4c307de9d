"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU (sm_90a build): the kernels in
distributed_active_learning_tpu_torch/csrc have no CPU or interpret mode, so
without a card every test here skips with that reason. On a machine with a
card and without JAX, run them as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(the repo's conftest.py configures JAX). The file imports no JAX. The module
also carries the ``slow`` marker: every test here skips without a card, so in
the CPU suite's ``-m 'not slow'`` run it would only spend the collection's
time budget; the command above passes no ``-m`` and runs them all.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.ops import ring_topk, round_fused, trees_pallas, trees_train
from distributed_active_learning_tpu_torch.ops.topk import merge_tile_topk
from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib

pytestmark = [pytest.mark.cuda, pytest.mark.slow]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels under "
            "distributed_active_learning_tpu_torch/csrc have no CPU mode"
        )
    from distributed_active_learning_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _forest(n_trees, depth, d, dev, seed=0, m=2000, quantize="none"):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev)
    y = (x[:, 0] + 0.3 * x[:, 1] > 0).to(torch.int32)
    b = trees_train.make_bins(x, 32, quantize=quantize)
    f, th, v = trees_train.fit_forest_device(
        b.codes, y, torch.ones(m, device=dev), b.edges, prng.key(seed),
        n_trees=n_trees, max_depth=depth)
    gf = trees_train.heap_gemm_forest(f, th, v, depth)
    return trees_train.quantize_forest(gf, quantize), rng


def _edge_rows(gf, rng, n, d):
    """Normal rows, then rows of NaN, +inf and -inf (whole rows and single
    features), then rows whose features sit exactly on node thresholds (the
    f32 threshold and the bf16 tie above its rounding)."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    feat, thr = gf.feat_ids.cpu().numpy(), gf.thresholds.float().cpu().numpy()
    for r in range(n):
        kind = r % 8
        if kind < 3:
            x[r, rng.integers(d) if r % 16 >= 8 else slice(None)] = (np.nan, np.inf, -np.inf)[kind]
        elif kind < 5 and feat.shape[1]:
            t, i = rng.integers(feat.shape[0]), rng.integers(feat.shape[1])
            v = thr[t, i:i + 1]
            if kind == 4:
                v = (((v.view(np.uint32) + 0x7FFF) & 0xFFFF0000) | 0x8000).view(np.float32)
            x[r, feat[t, i]] = v[0]
    return torch.from_numpy(x)


def test_forest_leaves_kernel_matches_plain(cuda):
    """K1 (csrc/forest_leaves.cu) against both plain versions: the path-
    matrix form and the heap walk, at depths 1-8, on edge rows, at row
    counts around a tile and one past a full persistent wave."""
    cases = [(20, 8, 30, 3001), (13, 4, 7, 1700), (5, 5, 3, 100), (7, 8, 300, 2000)]
    cases += [(9, depth, 6, 1000) for depth in range(1, 9)]
    cases += [(12, 8, 30, n) for n in (1, 127, 129)]
    for n_trees, depth, d, n in cases:
        gf, rng = _forest(n_trees, depth, d, cuda, seed=n_trees + depth)
        x = _edge_rows(gf, rng, n, d).to(cuda)
        _check_leaves(gf, x, (n_trees, depth, d, n))
    # One row past a full wave of the persistent grid: the last tile's unit
    # falls to a block that already ran one.
    gf, rng = _forest(20, 8, 30, cuda, seed=7)
    cfg = trees_pallas.leaves_launch_config(trees_pallas.heap_operands(gf), 10**7, 30, cuda)
    n = cfg["grid"] * cfg["rows"] + 1
    _check_leaves(gf, _edge_rows(gf, rng, n, 30).to(cuda), ("wave", cfg, n))


def _check_leaves(gf, x, label):
    before = trees_pallas.launches
    got = trees_pallas.predict_leaves_pallas(gf, x)
    assert trees_pallas.launches == before + 1
    want = trees_pallas.predict_leaves_plain(gf, x)
    walked = trees_pallas.walk_leaves_plain(trees_pallas.heap_operands(gf), x)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (x.shape[0], gf.n_trees)
    assert torch.equal(got, want) and torch.equal(got, walked), label


def test_non_heap_forest_is_refused_on_the_card(cuda):
    """K1, K2 and K3 raise on a path matrix that is not a heap, before any
    launch."""
    import dataclasses

    gf, rng = _forest(4, 3, 5, cuda)
    swapped = dataclasses.replace(gf, path=gf.path[:, :, [1, 0, *range(2, 8)]].contiguous())
    x = torch.from_numpy(rng.normal(size=(10, 5)).astype(np.float32)).to(cuda)
    sel = torch.ones(10, dtype=torch.bool, device=cuda)
    calls = (lambda: trees_pallas.predict_leaves_pallas(swapped, x),
             lambda: round_fused.fused_score_select(
                 trees_pallas.PallasForest(gf=swapped), x, sel, "uncertainty", 5),
             lambda: round_fused.fused_votes(trees_pallas.PallasForest(gf=swapped), x))
    for call in calls:
        before = (trees_pallas.launches, round_fused.launches, round_fused.votes_launches)
        with pytest.raises(ValueError, match="host fit"):
            call()
        assert (trees_pallas.launches, round_fused.launches, round_fused.votes_launches) == before


def _check_votes(gf, x, sel, label, mode=None):
    """K3 and K2 (for two strategies, k below and above the tile) against
    both plain versions: the path-matrix form and the walk over the heap
    operands with packed vote bits; ``mode`` is the launch mode expected."""
    heap = trees_pallas.heap_operands(gf)
    for name in ("fused_votes", "round_megakernel"):
        cfg = round_fused.launch_config(name, heap, *x.shape, x.device)
        assert mode is None or cfg["mode"] == mode, (label, name, cfg)
    before = round_fused.votes_launches
    got = round_fused.fused_votes(trees_pallas.PallasForest(gf=gf), x)
    assert round_fused.votes_launches == before + 1
    walked = round_fused.walk_votes_plain(heap, x)
    assert torch.equal(got, round_fused.fused_votes_plain(gf, x)), label
    assert torch.equal(got, walked), label
    for name in ("uncertainty", "entropy"):
        table = round_fused.score_table(gf.n_trees, name, x.device)
        for k in (50, 200):  # 200 > the 128-row tile: each tile gives all rows
            before = round_fused.launches
            tv, ti = round_fused._launch_megakernel(heap, x, sel, table, k)
            assert round_fused.launches == before + 1
            pv, pi = round_fused.megakernel_plain(gf, x, sel, table, k)
            wv, wi = round_fused.tile_topk_plain(walked, sel, table, k)
            torch.cuda.synchronize()
            assert torch.equal(tv, pv) and torch.equal(ti, pi), (label, name, k)
            assert torch.equal(tv, wv) and torch.equal(ti, wi), (label, name, k)


def test_round_megakernel_matches_plain(cuda):
    """K2 (csrc/round_megakernel.cu) and K3 (csrc/fused_votes.cu) against
    both plain versions: every strategy, a depth sweep 1-8 on edge rows, and
    the streamed mode (wide rows, many trees)."""
    gf, rng = _forest(16, 8, 30, cuda, seed=3)
    n = 5000
    x = torch.from_numpy(rng.normal(size=(n, 30)).astype(np.float32)).to(cuda)
    sel = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    heap = trees_pallas.heap_operands(gf)
    for name in ("uncertainty", "entropy", "full_entropy", "margin"):
        table = round_fused.score_table(gf.n_trees, name, cuda)
        for k in (50, 200):
            tv, ti = round_fused._launch_megakernel(heap, x, sel, table, k)
            pv, pi = round_fused.megakernel_plain(gf, x, sel, table, k)
            torch.cuda.synchronize()
            assert torch.equal(tv, pv) and torch.equal(ti, pi), (name, k)
            v1, i1 = merge_tile_topk(tv, ti, k)
            v2, i2 = merge_tile_topk(pv, pi, k)
            assert torch.equal(v1, v2) and torch.equal(i1, i2)
        vals, idx = round_fused.fused_score_select(
            trees_pallas.PallasForest(gf=gf), x, sel, name, 50)
        assert bool(sel[idx.long()].all()) and bool(torch.isfinite(vals).all())
    for depth in range(1, 9):
        gf, rng = _forest(9, depth, 6, cuda, seed=20 + depth)
        x = _edge_rows(gf, rng, 1000, 6).to(cuda)
        _check_votes(gf, x, torch.from_numpy(rng.random(1000) < 0.7).to(cuda), ("depth", depth),
                     mode="resident")
    # Streamed: a 128-row tile of 512 features leaves room for ~95 resident
    # depth-8 trees (1,056 bytes each), and 256 such trees take 270,336 bytes.
    for n_trees, d, n in ((120, 512, 700), (256, 30, 3001)):
        gf, rng = _forest(n_trees, 8, d, cuda, seed=n_trees)
        x = _edge_rows(gf, rng, n, d).to(cuda)
        _check_votes(gf, x, torch.from_numpy(rng.random(n) < 0.7).to(cuda), (n_trees, d),
                     mode="streamed")
    # Trees past the count whose [T + 1] score table would fit in shared
    # memory beside a 512-feature tile (~23,000) or a 30-feature one
    # (~54,000): a random depth-1 heap forest at each width.
    for n_trees, d in ((24_000, 512), (60_000, 30)):
        rng = np.random.default_rng(n_trees)
        f = torch.from_numpy(rng.integers(0, d, size=(n_trees, 1), dtype=np.int32))
        th = torch.from_numpy(rng.normal(size=(n_trees, 1)).astype(np.float32))
        v = torch.from_numpy(rng.random((n_trees, 3), dtype=np.float32))
        gf = trees_train.heap_gemm_forest(f.to(cuda), th.to(cuda), v.to(cuda), 1)
        x = _edge_rows(gf, rng, 300, d).to(cuda)
        _check_votes(gf, x, torch.from_numpy(rng.random(300) < 0.7).to(cuda), (n_trees, d),
                     mode="streamed")


def test_mesh_kernels_match_plain(cuda):
    """K3 (csrc/fused_votes.cu) and K4 (csrc/ring_hop.cu: a hop and the ring
    step) against their plain versions, and the 4 x 2 mesh on one card
    against the CPU mesh."""
    for n_trees, depth, d, n in ((20, 8, 30, 3001), (13, 4, 7, 1700), (50, 8, 30, 1)):
        gf, rng = _forest(n_trees, depth, d, cuda, seed=n_trees)
        x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
        _check_votes(gf, x, torch.from_numpy(rng.random(n) < 0.7).to(cuda), (n_trees, n))

    rng = np.random.default_rng(1)
    k = 24
    windows = []
    for s in range(4):  # 16 rows a shard, k past them: sentinel-padded windows
        v = torch.from_numpy(rng.choice(np.float32([-1.5, 0.0, 0.25, 3.0]), size=16))
        sv, si = torch.sort(v, descending=True, stable=True)
        windows.append(ring_topk.pad_window(sv.to(cuda), (si + 16 * s).to(torch.int32).to(cuda), k))
    before = ring_topk.launches
    hv, hi = ring_topk.hop(*windows[0], cuda)
    assert ring_topk.launches == before + 1
    pv, pi = ring_topk.hop_plain(*windows[0], cuda)
    assert torch.equal(hv, pv) and torch.equal(hi, pi)
    merged = ring_topk.ring_topk(windows, k)
    assert ring_topk.launches == before + 1 + 3  # one launch a step on one card
    cpu = ring_topk.ring_topk([(v.cpu(), i.cpu()) for v, i in windows], k)
    for (mv, mi), (cv, ci) in zip(merged, cpu):
        assert torch.equal(mv.cpu(), cv) and torch.equal(mi.cpu(), ci)

    # The ring step: 1-4 windows in one launch against the plain copies.
    for kk in (1, 100, 300):
        for m in range(1, 5):
            src = [(torch.randn(kk, device=cuda),
                    torch.randint(0, 2**31 - 1, (kk,), dtype=torch.int32, device=cuda))
                   for _ in range(m)]
            dst = [(torch.full((kk,), float("nan"), device=cuda),
                    torch.full((kk,), -1, dtype=torch.int32, device=cuda)) for _ in range(m)]
            ref = [(torch.empty_like(v), torch.empty_like(i)) for v, i in src]
            before = ring_topk.launches
            ring_topk.ring_step(src, dst)
            assert ring_topk.launches == before + 1
            ring_topk.ring_step_plain(src, ref)
            torch.cuda.synchronize()
            for (dv, di), (rv, ri) in zip(dst, ref):
                assert torch.equal(dv, rv) and torch.equal(di, ri), (kk, m)

    # The fused mesh selection: 4 x 2 shards on one card against the CPU mesh.
    gf, rng = _forest(8, 4, 5, cuda, seed=2)
    x = torch.from_numpy(rng.normal(size=(999, 5)).astype(np.float32))
    sel = torch.from_numpy(rng.random(999) < 0.7)
    on_card = trees_pallas.attach_mesh(
        trees_pallas.PallasForest(gf=gf), mesh_lib.make_mesh(4, 2, devices=[cuda] * 8))
    on_cpu = trees_pallas.attach_mesh(
        trees_pallas.PallasForest(gf=_to_cpu(gf)), mesh_lib.make_mesh(4, 2, device="cpu"))
    cv, ci = round_fused.fused_score_select(on_card, x.to(cuda), sel.to(cuda), "uncertainty", 40)
    pv, pi = round_fused.fused_score_select(on_cpu, x, sel, "uncertainty", 40)
    assert torch.equal(cv.cpu(), pv) and torch.equal(ci.cpu(), pi)


def test_ring_and_mesh_across_cards(cuda):
    """K4 across cards (peer stores, events between distinct cards only):
    the ring over two and over every visible card equals the CPU ring, one
    launch per sending card and step; a ring step into another card's
    buffers equals the plain copies; and the 4 x 2 mesh spread over the
    cards equals the CPU mesh, fused and unfused."""
    import dataclasses

    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.runtime import loop

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more cards: the ring's peer stores cross cards")
    rng = np.random.default_rng(5)
    k = 100
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    for ring in ([cards[0], cards[1]] * 2, cards):
        mesh_lib.make_mesh(len(ring), 1, devices=ring)  # enables peer access on the ring
        windows = []
        for s, d in enumerate(ring):
            v = torch.from_numpy(rng.choice(np.float32([-1.5, 0.0, 0.25, 3.0]), size=300))
            sv, si = torch.sort(v, descending=True, stable=True)
            windows.append((sv[:k].to(d), (si[:k] + 300 * s).to(torch.int32).to(d)))
        before = ring_topk.launches
        merged = ring_topk.ring_topk(windows, k)
        assert ring_topk.launches == before + (len(ring) - 1) * len(set(ring))
        cpu = ring_topk.ring_topk([(v.cpu(), i.cpu()) for v, i in windows], k)
        for (mv, mi), (cv, ci) in zip(merged, cpu):
            assert torch.equal(mv.cpu(), cv) and torch.equal(mi.cpu(), ci)
        dst = [(torch.empty(k, device=ring[(s + 1) % len(ring)]),
                torch.empty(k, dtype=torch.int32, device=ring[(s + 1) % len(ring)]))
               for s in range(len(ring))]
        for d in dict.fromkeys(ring):
            shards = [s for s in range(len(ring)) if ring[s] == d]
            ring_topk.ring_step([windows[s] for s in shards], [dst[s] for s in shards])
        torch.cuda.synchronize()
        for (v, i), (dv, di) in zip(windows, dst):
            assert torch.equal(v.cpu(), dv.cpu()) and torch.equal(i.cpu(), di.cpu())

    spread = [torch.device("cuda", (s + m) % n_cards) for s in range(4) for m in range(2)]
    base = config.ExperimentConfig(
        data=config.DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=config.ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
        strategy=config.StrategyConfig(name="uncertainty", window_size=15),
        mesh=config.MeshConfig(4, 2), n_start=10, max_rounds=3)
    for fused in (True, False):
        c = dataclasses.replace(base, fused_round=fused)
        on_cards = loop.run_experiment(c, device=cards[0], devices=spread)
        on_cpu = loop.run_experiment(c, device="cpu")
        assert on_cards.to_reference_log() == on_cpu.to_reference_log(), fused


def test_variant_kernels_match_plain(cuda):
    """K5 (csrc/forest_leaves_transposed.cu) and K6
    (csrc/forest_leaves_segmented.cu) against their plain versions and the
    walks of their own arithmetic, bit for bit: four tilings of K5 (one with
    bn not a multiple of the 256-row sub-tile) with each payload and
    ablation stage, three of K6, at depths 1-8 on edge rows and ragged
    shapes; K5 on rows of 200 and 300 features; then a forest with -inf and
    NaN thresholds against
    rows that are -inf at those nodes (K6 gives such nodes no slot); a
    forest that is not a heap is refused by both with no launch."""
    import dataclasses

    from distributed_active_learning_tpu_torch.benches import pallas_variants as pv

    def same(got, want):
        return got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                        want.view(torch.int32))

    cases = [(20, 8, 30, 3001), (13, 4, 7, 1700)] + [(9, depth, 6, 1000) for depth in range(1, 9)]
    for n_trees, depth, d, n in cases:
        gf, rng = _forest(n_trees, depth, d, cuda, seed=n_trees + depth)
        x = _edge_rows(gf, rng, n, d).to(cuda)
        k1 = trees_pallas.predict_leaves_pallas(gf, x)
        before = pv.transposed_launches
        flag_sets = [dict(), dict(bn=1024, bt=8), dict(bn=2048, bt=4, tree_outer=True),
                     dict(bn=1000, bt=5), dict(leaf_f32=True)]
        flag_sets += [dict(ablate=a) for a in pv.ABLATE[1:]]
        for flags in flag_sets:
            got = pv.predict_leaves_transposed(gf, x, **flags)
            want = pv.predict_leaves_transposed_plain(
                gf, x, flags.get("leaf_f32", False), flags.get("ablate", "full"))
            assert got.shape == (n, n_trees) and same(got, want), (depth, flags)
            if flags.get("leaf_f32"):
                assert torch.equal(got, k1)
        assert pv.transposed_launches == before + len(flag_sets)
        before = pv.segmented_launches
        for bn in (1000, 1024, 4096):
            got = pv.predict_leaves_segmented(gf, x, bn=bn, bt=8)
            assert same(got, pv.predict_leaves_segmented_plain(gf, x, bn=bn, bt=8)), (depth, bn)
        assert pv.segmented_launches == before + 3
        assert same(got, pv.walk_segmented_plain(pv._segmented_operands(gf, x, 4096, 8)))

    # Wide rows: sub-tiles of 128 and 64 rows, the block's threads split over
    # two and four groups of trees.
    for trees_w, depth_w, d_w, n_w in ((9, 6, 200, 1500), (7, 8, 300, 2000)):
        g, rng_w = _forest(trees_w, depth_w, d_w, cuda, seed=d_w)
        xw = _edge_rows(g, rng_w, n_w, d_w).to(cuda)
        for flags in (dict(), dict(bn=1000, bt=5, tree_outer=True), dict(ablate="main")):
            got = pv.predict_leaves_transposed(g, xw, **flags)
            want = pv.predict_leaves_transposed_plain(g, xw, ablate=flags.get("ablate", "full"))
            assert same(got, want), (d_w, flags)

    # -inf and NaN thresholds; rows -inf at those nodes' features.
    thr = gf.thresholds.clone()
    thr[:, 1::5], thr[:, 3::7] = float("-inf"), float("nan")
    odd = dataclasses.replace(gf, thresholds=thr)
    x = _edge_rows(gf, rng, 1000, 6)
    feat = gf.feat_ids.cpu()
    for r in range(3, 1000, 2):
        x[r, feat[r % feat.shape[0], 1 + 5 * (r % 50)]] = float("-inf")
    x = x.to(cuda)
    for leaf_f32 in (False, True):
        got = pv.predict_leaves_transposed(odd, x, bn=1024, bt=8, leaf_f32=leaf_f32)
        assert same(got, pv.predict_leaves_transposed_plain(odd, x, leaf_f32)), leaf_f32
    seg = pv.predict_leaves_segmented(odd, x, bn=1024, bt=8)
    assert same(seg, pv.predict_leaves_segmented_plain(odd, x, bn=1024, bt=8))
    assert not torch.equal(seg, pv.predict_leaves_transposed_plain(odd, x))

    # Not a heap: refused before any launch.
    swapped = dataclasses.replace(gf, path=gf.path[:, :, [1, 0, *range(2, 2 ** depth)]])
    before = (pv.transposed_launches, pv.segmented_launches)
    with pytest.raises(ValueError, match="host fit"):
        pv.predict_leaves_transposed(swapped, x)
    with pytest.raises(ValueError, match="host fit"):
        pv.predict_leaves_segmented(swapped, x)
    assert (pv.transposed_launches, pv.segmented_launches) == before


def test_chunked_graph_matches_per_round(cuda):
    """The chunked driver on the card (one CUDA graph per chunk, replayed)
    against the per-round driver there and the eager chunk on the CPU."""
    import dataclasses

    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.runtime import loop

    base = config.ExperimentConfig(
        data=config.DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=config.ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
        strategy=config.StrategyConfig(name="uncertainty", window_size=15),
        n_start=10, max_rounds=5)
    for fused in (False, True):
        per_round = loop.run_experiment(dataclasses.replace(base, fused_round=fused), device=cuda)
        for depth in (1, 2):
            c = dataclasses.replace(base, fused_round=fused, rounds_per_launch=3,
                                    pipeline_depth=depth)
            got = loop.run_experiment(c, device=cuda)
            assert got.to_reference_log() == per_round.to_reference_log()
            assert torch.equal(got.final_labeled_mask, per_round.final_labeled_mask)
            assert got.graph_stats["captures"] == 1 and got.graph_stats["replays"] == 2
            on_cpu = loop.run_experiment(c, device="cpu")
            assert on_cpu.to_reference_log() == got.to_reference_log()


def test_metrics_chunk_and_resume_on_the_card(cuda, tmp_path):
    """RoundMetrics in the graphed chunk (depth 1 and 2) equal the per-round
    driver's on the card, and the CPU's (pool_entropy, a sum in another
    order, to ``telemetry.POOL_ENTROPY_RTOL``), and metrics change no pick; a run
    stopped at 2 rounds and resumed to 5 on the card, chunked and per round
    from the chunk's checkpoint, equals the uninterrupted run."""
    import dataclasses
    import os

    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.runtime.telemetry import POOL_ENTROPY_RTOL

    base = config.ExperimentConfig(
        data=config.DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=config.ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas",
                                   fit_budget=96),
        strategy=config.StrategyConfig(name="uncertainty", window_size=15),
        n_start=10, max_rounds=5, collect_metrics=True)
    per_round = loop.run_experiment(base, device=cuda)
    on_cpu = loop.run_experiment(base, device="cpu")
    plain = loop.run_experiment(dataclasses.replace(base, collect_metrics=False), device=cuda)
    assert per_round.to_reference_log() == plain.to_reference_log() == on_cpu.to_reference_log()
    for a, b in zip(per_round.records, on_cpu.records, strict=True):
        assert {k: v for k, v in a.metrics.items() if k != "pool_entropy"} == {
            k: v for k, v in b.metrics.items() if k != "pool_entropy"}, a.round
        assert abs(a.metrics["pool_entropy"] - b.metrics["pool_entropy"]) <= (
            POOL_ENTROPY_RTOL * abs(b.metrics["pool_entropy"])), a.round
    for depth in (1, 2):
        c = dataclasses.replace(base, rounds_per_launch=3, pipeline_depth=depth)
        before = trees_pallas.launches
        got = loop.run_experiment(c, device=cuda)
        # One eager warm-up round and two replays of 3: K1 twice a round.
        assert trees_pallas.launches - before == 2 * (1 + 2 * 3)
        assert got.graph_stats["captures"] == 1 and got.graph_stats["replays"] == 2
        assert [r.metrics for r in got.records] == [r.metrics for r in per_round.records]
        assert torch.equal(got.final_labeled_mask, plain.final_labeled_mask)
    ck = str(tmp_path / "ck")
    chunked = dataclasses.replace(base, rounds_per_launch=3, checkpoint_dir=ck,
                                  checkpoint_every=1)
    loop.run_experiment(dataclasses.replace(chunked, max_rounds=2), device=cuda)
    assert os.listdir(ck) == ["alstate_2.npz"]
    os.makedirs(tmp_path / "ck2")
    os.link(os.path.join(ck, "alstate_2.npz"), tmp_path / "ck2" / "alstate_2.npz")
    for c in (chunked, dataclasses.replace(chunked, rounds_per_launch=1,
                                           checkpoint_dir=str(tmp_path / "ck2"))):
        resumed = loop.run_experiment(dataclasses.replace(c, max_rounds=3), device=cuda)
        assert resumed.to_reference_log() == plain.to_reference_log()
        assert [r.metrics for r in resumed.records] == [r.metrics for r in per_round.records]
        assert torch.equal(resumed.final_labeled_mask, plain.final_labeled_mask)


def test_host_fit_heaps_through_k1_match_plain(cuda, tmp_path):
    """Host-fit-shaped forests (made with numpy: the machine with the card
    has no scikit-learn), carried to the card through a forest file:
    ``for_kernel(..., "pallas")`` packs their trees into heaps, and K1 on
    those equals the plain version on the depth-first path matrix and the
    walk of the heaps, at depths 1-8 on edge rows; on bf16-exact rows it
    also equals the gather form."""
    from distributed_active_learning_tpu_torch.models import forest as forest_lib
    from distributed_active_learning_tpu_torch.models import forest_io
    from distributed_active_learning_tpu_torch.ops import forest_eval, trees

    rng = np.random.default_rng(3)
    for depth in range(1, 9):
        packed = forest_lib.synthetic_forest(rng, 23, depth, 30, single_leaf_every=5)
        forest_io.save_forest(str(tmp_path / "f.npz"), packed)
        packed, _ = forest_io.load_forest(str(tmp_path / "f.npz"), device=cuda)
        pf = forest_eval.for_kernel(packed, "pallas")
        assert pf.prepacked is not None and pf.heap.nodes.device.type == "cuda"
        x = _edge_rows(pf.gf, rng, 3001, 30).to(cuda)
        before = trees_pallas.launches
        got = trees_pallas.predict_leaves_pallas(pf, x)
        assert trees_pallas.launches == before + 1
        assert torch.equal(got, trees_pallas.predict_leaves_plain(pf.gf, x)), depth
        assert torch.equal(got, trees_pallas.walk_leaves_plain(pf.heap, x)), depth
        xb = x[torch.isfinite(x).all(dim=1)].to(torch.bfloat16).float()
        assert torch.equal(trees_pallas.predict_leaves_pallas(pf, xb),
                           trees.predict_leaves(packed, xb)), depth
    # A bare path matrix of such a forest is no heap: refused, no launch.
    before = trees_pallas.launches
    with pytest.raises(ValueError, match="host fit"):
        trees_pallas.predict_leaves_pallas(pf.gf, x)
    assert trees_pallas.launches == before


def test_gather_and_density_on_the_card_match_the_cpu(cuda):
    """The gather form (a depth-11 device fit) and the density strategy on
    the card against the same runs on the CPU, per round and chunked (one
    CUDA graph per chunk): records, logs and final masks equal."""
    import dataclasses

    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.runtime import loop

    base = config.ExperimentConfig(
        data=config.DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=config.ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
        strategy=config.StrategyConfig(name="uncertainty", window_size=15),
        n_start=10, max_rounds=5)
    for change in (dict(forest=dataclasses.replace(base.forest, kernel="gather", max_depth=11)),
                   dict(strategy=config.StrategyConfig(name="density", window_size=15))):
        cfg = dataclasses.replace(base, **change)
        on_cpu = loop.run_experiment(cfg, device="cpu")
        for k in (1, 3):
            got = loop.run_experiment(dataclasses.replace(cfg, rounds_per_launch=k), device=cuda)
            assert got.to_reference_log() == on_cpu.to_reference_log(), (change, k)
            assert torch.equal(got.final_labeled_mask.cpu(), on_cpu.final_labeled_mask)


def test_quantized_payloads_match_plain(cuda):
    """K1, K2 and K3 on quantized forests (``quantize_forest``: thresholds
    bf16, leaf values bf16 or on the int8 grid) read the narrow payload in
    their own bodies: leaves, votes and per-tile candidates bit-equal to
    their plain versions at depths 1-8 on edge rows (an int8 depth-1 tree's
    two leaves padded to 16 bytes), resident and streamed; the streamed
    stage's bytes follow the payload's width. A payload dtype the kernels
    were not built for raises before any launch."""
    import dataclasses

    widths = {"int8": (torch.int8, 16), "bf16": (torch.bfloat16, 8)}
    for mode, (dtype, per16) in widths.items():
        for depth in range(1, 9):
            gf, rng = _forest(9, depth, 6, cuda, seed=40 + depth, quantize=mode)
            heap = trees_pallas.heap_operands(gf)
            assert heap.val.dtype == dtype and heap.val.shape[1] % per16 == 0
            assert gf.thresholds.dtype == torch.bfloat16
            x = _edge_rows(gf, rng, 1000, 6).to(cuda)
            _check_leaves(gf, x, (mode, depth))
            _check_votes(gf, x, torch.from_numpy(rng.random(1000) < 0.7).to(cuda),
                         (mode, depth), mode="resident")
        for n_trees, d, n in ((120, 512, 700), (256, 30, 3001)):
            gf, rng = _forest(n_trees, 8, d, cuda, seed=n_trees, quantize=mode)
            x = _edge_rows(gf, rng, n, d).to(cuda)
            _check_leaves(gf, x, (mode, n_trees, d))
            _check_votes(gf, x, torch.from_numpy(rng.random(n) < 0.7).to(cuda),
                         (mode, n_trees, d), mode="streamed")
            heap = trees_pallas.heap_operands(gf)
            f32 = dataclasses.replace(heap, val=heap.values().contiguous())
            for name in ("fused_votes", "round_megakernel"):
                narrow = round_fused.launch_config(name, heap, n, d, cuda)
                wide = round_fused.launch_config(name, f32, n, d, cuda)
                assert narrow["trees_per_chunk"] >= wide["trees_per_chunk"], (mode, name)
    gf, rng = _forest(4, 3, 5, cuda)
    heap = trees_pallas.heap_operands(gf)
    half = dataclasses.replace(heap, val=heap.val.to(torch.float16))
    x = torch.zeros(10, 5, device=cuda)
    before = (trees_pallas.launches, round_fused.votes_launches)
    for call in (lambda: trees_pallas._launch_leaves(half, x),
                 lambda: round_fused._launch_votes(half, x)):
        with pytest.raises(ValueError, match="f32, bf16 or int8"):
            call()
    assert (trees_pallas.launches, round_fused.votes_launches) == before


def test_quantized_multiclass_and_lal_runs_match_the_cpu(cuda, tmp_path):
    """Quantized storage (fused and unfused, per round and chunked, and the
    fused 2 x 2 mesh on the one card), a 4-class pool (per round with
    RoundMetrics, chunked, and the unfused mesh) and the lal strategy (its
    regressor from a forest file, per round and chunked) on the card
    against the same runs on the CPU: logs and final masks equal. K1
    launches 2 x 4 times a round on the 4-class metrics path."""
    import dataclasses

    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.data.datasets import DataBundle
    from distributed_active_learning_tpu_torch.models import forest as forest_lib
    from distributed_active_learning_tpu_torch.models import forest_io, lal_training
    from distributed_active_learning_tpu_torch.runtime import loop

    base = config.ExperimentConfig(
        data=config.DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=config.ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
        strategy=config.StrategyConfig(name="uncertainty", window_size=15),
        n_start=10, max_rounds=5)
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(400, 4)).astype(np.float32)
    s = xs[:, 0] + 0.3 * xs[:, 1]
    ys = np.digitize(s, np.quantile(s, [0.25, 0.5, 0.75])).astype(np.int32)
    four = DataBundle(xs[:300], ys[:300], xs[300:], ys[300:])
    path = str(tmp_path / "lal.npz")
    forest_io.save_forest(path, forest_lib.synthetic_forest(rng, 12, 6, 5),
                          meta=lal_training.lal_meta({"lal_model_path": path}))
    mesh = config.MeshConfig(data=2, model=2)
    runs = []
    for q in ("int8", "bf16"):
        forest = dataclasses.replace(base.forest, quantize=q)
        runs += [(dict(forest=forest, fused_round=f, rounds_per_launch=k), None)
                 for f in (False, True) for k in (1, 3)]
        runs.append((dict(forest=forest, fused_round=True, mesh=mesh), None))
    runs += [(dict(collect_metrics=True), four), (dict(rounds_per_launch=3), four),
             (dict(mesh=mesh), four)]
    lal = config.StrategyConfig(name="lal", window_size=15, options={"lal_model_path": path})
    runs += [(dict(strategy=lal, rounds_per_launch=k), None) for k in (1, 3)]
    for change, bundle in runs:
        cfg = dataclasses.replace(base, **change)
        on_cpu = loop.run_experiment(cfg, bundle=bundle, device="cpu")
        devices = [cuda] * 4 if "mesh" in change else None
        before = trees_pallas.launches
        got = loop.run_experiment(cfg, bundle=bundle, device=cuda, devices=devices)
        assert got.to_reference_log() == on_cpu.to_reference_log(), change
        assert torch.equal(got.final_labeled_mask.cpu(), on_cpu.final_labeled_mask), change
        if change == dict(collect_metrics=True):
            assert trees_pallas.launches - before == 2 * 4 * 5


def _to_cpu(gf):
    import dataclasses

    return dataclasses.replace(
        gf, **{f.name: getattr(gf, f.name).cpu() for f in dataclasses.fields(gf)})


def test_sweep_and_grid_on_the_card(cuda):
    """Sweeps and grids on the card (one CUDA graph a chunk): records and
    final masks equal the same runs on the CPU and the card's serial runs;
    one graph capture a run; K1 launches twice a round step per dataset
    (pool and test set) whatever the number of experiments, so a replay of
    K rounds stands for 2 x K launches of one dataset's sweep or grid and
    4 x K of a two-dataset grid (unequal widths: the fill watermark)."""
    import dataclasses

    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.data.datasets import DataBundle
    from distributed_active_learning_tpu_torch.runtime import loop, sweep

    K = 2
    base = config.ExperimentConfig(
        data=config.DataConfig(name="checkerboard2x2", n_samples=160, seed=2),
        forest=config.ForestConfig(n_trees=6, max_depth=3, fit="device", kernel="pallas",
                                   fit_budget=160),
        strategy=config.StrategyConfig(name="uncertainty", window_size=10),
        n_start=10, max_rounds=3, rounds_per_launch=K, collect_metrics=True)

    def rounds(res):
        return [(r.round, r.n_labeled, r.n_unlabeled, r.accuracy) for r in res.records]

    for seeds, windows in (([0, 1], None), ([0, 1, 2], [10, 6, 10])):
        got = sweep.run_sweep(base, seeds, windows=windows, device=cuda)
        on_cpu = sweep.run_sweep(base, seeds, windows=windows, device="cpu")
        g = got[0].graph_stats
        assert g["captures"] == 1 and g["launches_per_replay"]["trees_pallas.launches"] == 2 * K
        for i, (res, cpu_res) in enumerate(zip(got, on_cpu, strict=True)):
            assert rounds(res) == rounds(cpu_res)
            assert torch.equal(res.final_labeled_mask.cpu(), cpu_res.final_labeled_mask)
            w = windows[i] if windows else 10
            serial = loop.run_experiment(dataclasses.replace(
                base, seed=seeds[i], rounds_per_launch=1,
                strategy=dataclasses.replace(base.strategy, window_size=w)), device=cuda)
            assert rounds(res) == rounds(serial)
            assert [r.metrics for r in res.records] == [r.metrics for r in serial.records]
            assert torch.equal(res.final_labeled_mask, serial.final_labeled_mask)

    grid = sweep.run_grid(base, ["uncertainty", "margin"], [0, 1], device=cuda)
    on_cpu = sweep.run_grid(base, ["uncertainty", "margin"], [0, 1], device="cpu")
    assert grid.recompiles_after_warmup == 0 and grid.graph_stats["captures"] == 1
    assert grid.graph_stats["launches_per_replay"]["trees_pallas.launches"] == 2 * K
    for a, b in zip(grid.cells, on_cpu.cells, strict=True):
        assert rounds(a.result) == rounds(b.result)
        assert torch.equal(a.result.final_labeled_mask.cpu(), b.result.final_labeled_mask)

    rng = np.random.default_rng(3)
    bundles = {}
    for n in (120, 200):
        x = rng.normal(size=(n, 6)).astype(np.float32)
        tx = rng.normal(size=(100 + n // 10, 6)).astype(np.float32)
        bundles[f"p{n}"] = DataBundle(x, (x[:, 0] + 0.3 * x[:, 1] > 0).astype(np.int32), tx,
                                      (tx[:, 0] + 0.3 * tx[:, 1] > 0).astype(np.int32), f"p{n}")
    wide = dataclasses.replace(base, data=config.DataConfig(name="p120"), max_rounds=2,
                               forest=dataclasses.replace(base.forest, fit_budget=96))
    grids = [sweep.run_grid(wide, ["uncertainty", "margin"], [0], datasets=["p120", "p200"],
                            bundles=bundles, device=dev) for dev in (cuda, "cpu")]
    assert grids[0].graph_stats["launches_per_replay"]["trees_pallas.launches"] == 4 * K
    for a, b in zip(grids[0].cells, grids[1].cells, strict=True):
        assert rounds(a.result) == rounds(b.result)
        assert torch.equal(a.result.final_labeled_mask.cpu(), b.result.final_labeled_mask)


def test_scenarios_on_the_card(cuda):
    """The scenario engine on the card at the CPU tests' size (checkerboard
    of 96 rows, 4 trees of depth 3, window 8, entropy, metrics on), for each
    family (a noisy oracle flipping and abstaining, a rare class, a
    mean-shift and a rotation drift, a cost budget, and none): the graphed
    chunk (K = 2) equals the per-round driver on the card (records, every
    metric, final mask), and both equal the CPU's plain versions (the pool
    entropy, native float32 on each device, to POOL_ENTROPY_RTOL); the
    scenario grid (the families but rotation x 2 seeds, one CUDA graph a
    chunk) equals its serial cells and the CPU's grid, K1 launching 4 times a
    round step (pool, steady test sets, the two drift cells' own) and no
    graph captured again. The scenario draws (flips, costs, the drift
    direction through erfinv_f32, drift_apply) and the knapsack are the
    CPU's bits."""
    import dataclasses

    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.ops.topk import knapsack_top_k
    from distributed_active_learning_tpu_torch.runtime import loop, sweep
    from distributed_active_learning_tpu_torch.scenarios import engine

    K = 2
    base = config.ExperimentConfig(
        data=config.DataConfig(name="checkerboard2x2", n_samples=96, seed=2),
        forest=config.ForestConfig(n_trees=4, max_depth=3, fit="device", kernel="pallas",
                                   fit_budget=96),
        strategy=config.StrategyConfig(name="entropy", window_size=8), n_start=8, max_rounds=3,
        rounds_per_launch=K, collect_metrics=True, log_every=0)
    families = [
        config.ScenarioConfig(),
        config.ScenarioConfig(kind="noisy_oracle", flip_prob=0.2, abstain_prob=0.3),
        config.ScenarioConfig(kind="rare_event", rare_class=1),
        config.ScenarioConfig(kind="drift", drift_rate=0.3),
        config.ScenarioConfig(kind="cost_budget", cost_budget=6.0),
        config.ScenarioConfig(kind="drift", drift_rate=0.3, drift_kind="rotation"),
    ]

    from distributed_active_learning_tpu_torch.runtime.telemetry import POOL_ENTROPY_RTOL

    def full(res):
        return [(r.round, r.n_labeled, r.accuracy, r.metrics) for r in res.records]

    def same_as_cpu(res, cpu_res):
        """Records and final mask equal; metrics equal but the pool entropy,
        native float32 on each device, to POOL_ENTROPY_RTOL."""
        assert [x[:3] for x in full(res)] == [x[:3] for x in full(cpu_res)]
        for a, b in zip(res.records, cpu_res.records, strict=True):
            for field, v in b.metrics.items():
                if field == "pool_entropy":
                    assert abs(a.metrics[field] - v) <= POOL_ENTROPY_RTOL * abs(v)
                else:
                    assert a.metrics[field] == v, (a.round, field)
        assert torch.equal(res.final_labeled_mask.cpu(), cpu_res.final_labeled_mask)

    for scn in families:
        c = dataclasses.replace(base, scenario=scn)
        chunked = loop.run_experiment(c, device=cuda)
        per_round = loop.run_experiment(dataclasses.replace(c, rounds_per_launch=1), device=cuda)
        on_cpu = loop.run_experiment(c, device="cpu")
        assert chunked.graph_stats["captures"] == 1, scn
        assert full(chunked) == full(per_round), scn
        assert torch.equal(chunked.final_labeled_mask, per_round.final_labeled_mask)
        same_as_cpu(chunked, on_cpu)

    axis = families[:5]
    grid = sweep.run_grid(base, ["entropy"], [0, 1], scenarios=axis, device=cuda)
    grid_cpu = sweep.run_grid(base, ["entropy"], [0, 1], scenarios=axis, device="cpu")
    assert grid.recompiles_after_warmup == 0 and grid.graph_stats["captures"] == 1
    assert grid.graph_stats["launches_per_replay"]["trees_pallas.launches"] == 4 * K
    for a, b in zip(grid.cells, grid_cpu.cells, strict=True):
        same_as_cpu(a.result, b.result)
        serial = loop.run_experiment(dataclasses.replace(
            base, seed=a.seed, scenario=axis[[s.kind for s in axis].index(a.scenario)]),
            device=cuda)
        assert full(a.result) == full(serial), a.scenario
        assert torch.equal(a.result.final_labeled_mask, serial.final_labeled_mask)

    for draw in (lambda d: engine.flip_mask(families[1], 3, 5000, d),
                 lambda d: engine.make_costs(dataclasses.replace(families[4], cost_spread=3.3),
                                             5000, "x", d),
                 lambda d: engine.drift_direction(families[3], 30, d),
                 lambda d: prng.normal(prng.key(11), (5000,), d)):
        assert torch.equal(draw(cuda).cpu(), draw("cpu"))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(500, 30)).astype(np.float32))
    for scn in (families[3], families[5]):
        for r in range(6):
            a = engine.drift_apply(scn, x.to(cuda), torch.tensor(r, dtype=torch.int32,
                                                                 device=cuda))
            assert torch.equal(a.cpu(), engine.drift_apply(scn, x, torch.tensor(r)))
    rng = np.random.default_rng(1)
    scores = torch.from_numpy(rng.choice([0.0, 0.5, 1.0], 5000).astype(np.float32))
    costs = engine.make_costs(families[4], 5000, "x")
    mask = torch.from_numpy(rng.random(5000) < 0.7)
    got = knapsack_top_k(scores.to(cuda), costs.to(cuda), mask.to(cuda), 100, 60.0)
    want = knapsack_top_k(scores, costs, mask, 100, 60.0)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def test_file_path_on_the_card(cuda, tmp_path):
    """The data slice on the card: a credit-card CSV in the Kaggle layout
    (2,000 rows) read by the native loader into ``credit_card_fraud``; the
    fused (K2, K1 for eval), unfused and chunked (K = 2, one CUDA graph)
    runs of 8 trees of depth 4 give equal records and final masks, equal to
    the CPU's plain versions; the ``checkerboard2x2_file`` fixtures and a
    4-experiment ``generate_lal_dataset`` give the CPU's records and rows."""
    import dataclasses

    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.data import formats
    from distributed_active_learning_tpu_torch.models import lal_training
    from distributed_active_learning_tpu_torch.runtime import loop

    csv = str(tmp_path / "creditcard.csv")
    formats.write_credit_card_csv(csv, n_rows=2000, n_fraud=60, seed=4)
    base = config.ExperimentConfig(
        data=config.DataConfig(name="credit_card_fraud", path=csv, seed=1),
        forest=config.ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
        strategy=config.StrategyConfig(name="uncertainty", window_size=15), n_start=10,
        max_rounds=3, fused_round=True)

    def recs(res):
        return [(r.round, r.n_labeled, r.accuracy) for r in res.records]

    cpu = loop.run_experiment(base, device="cpu")
    trees_pallas.launches = round_fused.launches = 0
    fused = loop.run_experiment(base, device=cuda)
    assert (trees_pallas.launches, round_fused.launches) == (3, 3)
    unfused = loop.run_experiment(dataclasses.replace(base, fused_round=False), device=cuda)
    chunked = loop.run_experiment(dataclasses.replace(base, rounds_per_launch=2), device=cuda)
    assert chunked.graph_stats["captures"] == 1
    for res in (fused, unfused, chunked):
        assert recs(res) == recs(cpu)
        assert torch.equal(res.final_labeled_mask.cpu(), cpu.final_labeled_mask)
    fixtures = config.DataConfig(name="checkerboard2x2_file", path="tests/fixtures/reference_data")
    c = dataclasses.replace(base, data=fixtures)
    assert loop.run_experiment(c, device=cuda).to_reference_log() == \
        loop.run_experiment(c, device="cpu").to_reference_log()
    for a, b in zip(lal_training.generate_lal_dataset(n_experiments=4, device=cuda),
                    lal_training.generate_lal_dataset(n_experiments=4, device="cpu")):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_neural_path_on_the_card(cuda):
    """K7 (csrc/threefry.cu) bit-equal to ``prng``; on the card, under
    deterministic cuDNN, the neural chunk (one CUDA graph a chunk) equal to
    the per-round driver and a seed sweep's lanes equal to their serial runs
    bit for bit, for the MLP, the SmallCNN and the encoder; and the small MLP
    and CNN runs equal to the CPU's (picks equal, the first round's
    probabilities within ``NEURAL_TRAIN_RTOL``)."""
    from distributed_active_learning_tpu_torch.models.neural import (
        MLP, NEURAL_TRAIN_RTOL, NeuralLearner, SmallCNN,
    )
    from distributed_active_learning_tpu_torch.models.transformer import TransformerClassifier
    from distributed_active_learning_tpu_torch.ops import threefry
    from distributed_active_learning_tpu_torch.runtime import neural_loop as nl

    ks = prng.split(prng.key(3, cuda), 3)
    for shape in ((7,), (64, 16, 16, 32), (3, 1000)):
        assert torch.equal(threefry.uniform(ks[0], shape), prng.uniform(ks[0], shape, cuda))
    assert torch.equal(threefry.uniform(ks[1], (33,)), prng.uniform(ks[1], (33,), cuda))
    with pytest.raises(ValueError, match="one int64 key"):
        threefry.uniform(prng.split(ks[1], 5), (33,))
    mask = torch.rand(5000, device=cuda) < 0.05
    logits = torch.where(mask, 0.0, float("-inf"))
    assert torch.equal(threefry.categorical(ks[2], logits, 64),
                       prng.categorical(ks[2], logits, (64,)))
    per_row = torch.randn(256, 4, device=cuda)
    assert torch.equal(threefry.categorical(ks[2], per_row, 256),
                       prng.categorical(ks[2], per_row, (256,)))

    rs = np.random.RandomState(0)
    cases = [
        (MLP(hidden=(16,)), (4,), rs.randn(300, 4).astype(np.float32), "entropy"),
        (SmallCNN(n_classes=2, dropout_rate=0.1), (8, 8, 3),
         rs.randn(300, 8, 8, 3).astype(np.float32), "density"),
        (TransformerClassifier(vocab_size=64, max_len=8, d_model=16, n_heads=2, n_layers=1,
                               d_ff=32), (8,), rs.randint(0, 64, (300, 8)).astype(np.int32),
         "batchbald"),
    ]
    for module, shape, x, strat in cases:
        flat = x.reshape(len(x), -1).astype(np.float32)
        y = ((flat[:, 0] < 32) if x.dtype == np.int32
             else (flat[:, 0] + 0.5 * flat[:, 1] > 0)).astype(np.int32)
        lr = NeuralLearner(module, shape, train_steps=10, mc_samples=2, device=cuda)
        cfg = nl.NeuralExperimentConfig(strategy=strat, window_size=5, n_start=10, max_rounds=4,
                                        seed=1, batchbald_max_configs=8)
        per = nl.run_neural_experiment(cfg, lr, x, y, x[:80], y[:80])
        chunked_cfg = dataclasses.replace(cfg, rounds_per_launch=2)
        chk = nl.run_neural_experiment(chunked_cfg, lr, x, y, x[:80], y[:80])
        recs = [[(r.round, r.n_labeled, r.accuracy) for r in res.records] for res in (per, chk)]
        assert recs[0] == recs[1], (type(module).__name__, recs)
        assert torch.equal(per.final_labeled_mask, chk.final_labeled_mask)
        assert chk.graph_stats["captures"] == 1 and chk.graph_stats["replays"] == 2
        lanes = nl.run_neural_sweep(chunked_cfg, lr, x, y, x[:80], y[:80], seeds=[1, 2])
        serial2 = nl.run_neural_experiment(dataclasses.replace(cfg, seed=2), lr, x, y, x[:80],
                                           y[:80])
        for lane, serial in zip(lanes, (per, serial2)):
            assert [(r.round, r.n_labeled, r.accuracy) for r in lane.records] == \
                [(r.round, r.n_labeled, r.accuracy) for r in serial.records]
            assert torch.equal(lane.final_labeled_mask, serial.final_labeled_mask)
        if isinstance(module, TransformerClassifier):
            continue
        on_cpu = nl.run_neural_experiment(
            cfg, NeuralLearner(module, shape, train_steps=10, mc_samples=2, device="cpu"),
            x, y, x[:80], y[:80])
        assert torch.equal(per.final_labeled_mask.cpu(), on_cpu.final_labeled_mask)
        probs = []
        for d in (cuda, torch.device("cpu")):
            lr_d = NeuralLearner(module, shape, train_steps=10, mc_samples=2, device=d)
            m = torch.zeros(300, dtype=torch.bool, device=d)
            m[:10] = True
            st = lr_d.fit_on_mask(lr_d.init(prng.key(3)), torch.as_tensor(x).to(d),
                                  torch.as_tensor(y).to(d), m, prng.key(4, d))
            probs.append(lr_d.predict_proba(st, torch.as_tensor(x).to(d)).cpu())
        assert float(((probs[0] - probs[1]).abs() / probs[1].abs()).max()) < NEURAL_TRAIN_RTOL
