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
import json
import os
import subprocess
import sys
import time

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
    cards equals the CPU mesh, fused and unfused, per round and chunked
    (the chunk runs eagerly across cards: ``graph_stats["mode"]`` says
    "eager" and names the cards)."""
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
        for k in (1, 2):
            c = dataclasses.replace(base, fused_round=fused, rounds_per_launch=k)
            on_cards = loop.run_experiment(c, device=cards[0], devices=spread)
            on_cpu = loop.run_experiment(c, device="cpu")
            assert on_cards.to_reference_log() == on_cpu.to_reference_log(), (fused, k)
            assert torch.equal(on_cards.final_labeled_mask.cpu(), on_cpu.final_labeled_mask)
            if k > 1:
                g = on_cards.graph_stats
                print(f"chunked mesh across {n_cards} cards (fused={fused}): mode {g['mode']}: "
                      f"{g['mode_reason']}")
                assert g["mode"] == "eager" and g["captures"] == 0


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
    against the per-round driver there and the eager chunk on the CPU; and
    a graphed chunk refuses a replay whose carry holds another tensor
    outside its carry fields (the pool's ``x``, ``oracle_y``, ``n_filled``,
    which the graph reads where they lay at its capture), while the same
    tensors written in place replay."""
    import dataclasses

    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.runtime import state as state_lib
    from distributed_active_learning_tpu_torch.strategies import StrategyAux, get_strategy

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

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(256, 4)).astype(np.float32)).to(cuda)
    y = (x[:, 0] > 0).to(torch.int32)
    b = trees_train.make_bins(x, 8)
    fc = config.ExperimentConfig(forest=config.ForestConfig(n_trees=4, max_depth=3, max_bins=8,
                                                            fit="device", kernel="pallas"))
    body = loop.make_chunk_fn(get_strategy(config.StrategyConfig(window_size=4)), 4, 2,
                              loop.make_device_fit(fc, b.edges, 64), label_cap=256)
    mask = torch.zeros(256, dtype=torch.bool, device=cuda)
    mask[:8] = True
    carry = state_lib.PoolState(x=x, oracle_y=y, labeled_mask=mask, key=prng.key(1, cuda),
                                round=torch.zeros((), dtype=torch.int32, device=cuda),
                                n_filled=torch.full((), 200, dtype=torch.int32, device=cuda))
    end = torch.full((), 10, dtype=torch.int32, device=cuda)
    fit_key = prng.key(2, cuda)
    graphed = loop.GraphedChunk(body)
    out, _, ys = graphed(b.codes, carry, StrategyAux(), fit_key, x, y, end)
    x.mul_(1.0)  # an in-place write keeps the tensor: the replay reads it
    carry.n_filled.add_(8)
    out, _, ys = graphed(b.codes, out, StrategyAux(), fit_key, x, y, end)
    assert int(ys[4].sum()) == 2
    with pytest.raises(ValueError, match=r"carry tensors .* \['x'\]"):
        graphed(b.codes, out.replace(x=x.clone()), StrategyAux(), fit_key, x, y, end)


def test_chunked_mesh_on_the_card_matches_the_cpu(cuda):
    """The chunk under a 4 x 2 mesh on one card (``devices=[cuda:0] * 8``,
    300 rows padded to 304) is ONE CUDA graph of a round, replayed: fused
    and unfused, its records and final mask equal the same chunked mesh run
    on the CPU (plain versions) and the single-device run on the card; a
    replay (K = 3 rounds) launches K3 8, K4 3 and K1 8 times a round fused,
    K1 16 times unfused. The graph mode is printed."""
    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.runtime import loop

    base = config.ExperimentConfig(
        data=config.DataConfig(name="checkerboard2x2", n_samples=301, seed=1),
        forest=config.ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
        strategy=config.StrategyConfig(name="uncertainty", window_size=15),
        mesh=config.MeshConfig(4, 2), n_start=10, max_rounds=5, rounds_per_launch=3)
    K = base.rounds_per_launch
    for fused in (True, False):
        c = dataclasses.replace(base, fused_round=fused)
        got = loop.run_experiment(c, device=cuda, devices=[cuda] * 8)
        on_cpu = loop.run_experiment(c, device="cpu")
        single = loop.run_experiment(dataclasses.replace(c, mesh=config.MeshConfig()), device=cuda)
        assert got.to_reference_log() == on_cpu.to_reference_log() == single.to_reference_log()
        assert torch.equal(got.final_labeled_mask.cpu(), on_cpu.final_labeled_mask)
        assert torch.equal(got.final_labeled_mask, single.final_labeled_mask)
        g = got.graph_stats
        print(f"chunked mesh 4 x 2 on one card (fused={fused}): mode {g['mode']}, captures "
              f"{g['captures']}, replays {g['replays']}, launches a replay "
              f"{g['launches_per_replay']}")
        assert (g["mode"], g["captures"], g["replays"]) == ("graph", 1, 2)
        want = ({"trees_pallas.launches": 8 * K, "round_fused.votes_launches": 8 * K,
                 "ring_topk.launches": 3 * K} if fused else
                {"trees_pallas.launches": 16 * K, "round_fused.votes_launches": 0,
                 "ring_topk.launches": 0})
        assert {k: g["launches_per_replay"][k] for k in want} == want
        assert g["launches_per_replay"]["round_fused.launches"] == 0  # no K2 on the mesh


def test_metrics_chunk_and_resume_on_the_card(cuda, tmp_path):
    """RoundMetrics in the graphed chunk (depth 1 and 2) equal the per-round
    driver's on the card, and the CPU's (pool_entropy, a sum in another
    order, to ``telemetry.POOL_ENTROPY_RTOL``), and metrics change no pick;
    ``round_stream`` events (depth 2) are each chunk's records, written
    before its touchdown, with the launches of the run without them; a run
    stopped at 2 rounds and resumed to 5 on the card, chunked and per round
    from the chunk's checkpoint, equals the uninterrupted run."""
    import dataclasses
    import os

    import json

    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.runtime.telemetry import (
        POOL_ENTROPY_RTOL,
        MetricsWriter,
    )

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
        # At depth 2 with round_stream events: the same launches, and each
        # chunk's events (the records' values) written before its touchdown
        # writes its first round event.
        stream = depth == 2
        writer = MetricsWriter(str(tmp_path / "m.jsonl")) if stream else None
        c = dataclasses.replace(base, rounds_per_launch=3, pipeline_depth=depth,
                                stream_round_events=stream)
        before = trees_pallas.launches
        got = loop.run_experiment(c, device=cuda, metrics=writer)
        # One eager warm-up round and two replays of 3: K1 twice a round.
        assert trees_pallas.launches - before == 2 * (1 + 2 * 3)
        assert got.graph_stats["captures"] == 1 and got.graph_stats["replays"] == 2
        assert [r.metrics for r in got.records] == [r.metrics for r in per_round.records]
        assert torch.equal(got.final_labeled_mask, plain.final_labeled_mask)
        if stream:
            writer.close()
            with open(tmp_path / "m.jsonl") as f:
                events = [json.loads(line) for line in f]
            ev = [(e["round"], e["n_labeled"], e["accuracy"]) for e in events
                  if e["kind"] == "round_stream"]
            assert ev == [(r.round, r.n_labeled, r.accuracy) for r in got.records]
            at = {(e["kind"], e["round"]): i for i, e in enumerate(events) if "round" in e}
            assert at[("round_stream", 3)] < at[("round", 1)]
            assert at[("round_stream", 5)] < at[("round", 4)]
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


def test_serving_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The streaming service on the card (K1 at the score width, the
    re-fit chunk as one graph a capacity, captured ahead by the precompile
    worker) against the same service on the CPU: a small pallas service's
    scores, summary, mask, key and records bit-equal through a stream that
    crosses slab growths, and its checkpoint resuming on the other device;
    three gemm tenants' grouped scores and batched re-fit bit-equal, a
    growth that swaps in a precompiled graph, at most two chunk graphs a
    tenant, no capture on the request path after warmup."""
    import os
    import shutil

    from distributed_active_learning_tpu_torch import config
    from distributed_active_learning_tpu_torch.serving.service import ALService
    from distributed_active_learning_tpu_torch.serving.tenants import TenantManager

    def points(n, seed, shift=0.0):
        r = np.random.default_rng(seed)
        x = r.normal(size=(n, 4)).astype(np.float32) + shift
        return x, (x[:, 0] + 0.3 * x[:, 1] > shift).astype(np.int32)

    def cfgs(kernel, seed=0, **kw):
        cfg = config.ExperimentConfig(
            forest=config.ForestConfig(n_trees=6, max_depth=3, max_bins=8, fit="device",
                                       fit_budget=64, kernel=kernel),
            strategy=config.StrategyConfig(window_size=4), n_start=6, log_every=0, seed=seed)
        return cfg, config.ServeConfig(**{**dict(
            slab_rows=64, ingest_block=16, score_width=16, refit_rounds=2,
            drift_entropy_shift=0.2, drift_min_fresh=8, max_staleness=5, refit_poll_events=1),
            **kw})

    x0, y0 = points(48, 0)
    tx, ty = points(32, 1)
    runs = []
    for dev in (cuda, "cpu"):
        cfg, serve = cfgs("pallas")
        ck = str(tmp_path / f"ck_{len(runs)}")
        svc = ALService(cfg, serve, x0, y0, tx, ty, checkpoint_dir=ck, device=dev)
        rng = np.random.default_rng(2)
        sx, sy = points(192, 3, 2.0)
        scores = []
        for i in range(20):
            if i % 3 == 0:
                svc.submit(sx[16 * (i // 3): 16 * (i // 3 + 1)], sy[16 * (i // 3): 16 * (i // 3 + 1)])
            scores.append(svc.score(tx[rng.integers(0, 32, size=8)]))
        svc.flush()
        svc.save_checkpoint()
        runs.append((svc, scores, ck))
    (gs, g_scores, g_ck), (cs, c_scores, c_ck) = runs
    for a, b in zip(g_scores, c_scores, strict=True):
        np.testing.assert_array_equal(a, b)
    assert gs.summary() == cs.summary() and gs.summary()["slab_growths"] >= 2
    assert torch.equal(gs._slab.labeled_mask.cpu(), cs._slab.labeled_mask)
    assert torch.equal(gs._tenant._key.cpu(), cs._tenant._key)
    assert gs.result.to_reference_log() == cs.result.to_reference_log()
    assert gs.manager.live_graphs()["default"] <= 2
    q = points(16, 77)[0]
    for src, ref, dev in ((g_ck, cs, "cpu"), (c_ck, gs, cuda)):
        dst = str(tmp_path / f"x_{os.path.basename(src)}")
        shutil.copytree(src, dst)
        cfg, serve = cfgs("pallas")
        other = ALService(cfg, serve, x0, y0, tx, ty, checkpoint_dir=dst, device=dev)
        np.testing.assert_array_equal(other.score(q), ref.score(q))
        other.manager.close()
    gs.manager.close()

    mgrs = []
    for dev in (cuda, "cpu"):
        mgr = TenantManager(device=dev)
        for i in range(3):
            cfg, serve = cfgs("gemm", seed=i, max_staleness=0, drift_entropy_shift=99.0)
            mgr.add_tenant(f"t{i}", cfg, serve, *points(40, 10 + i, 0.3 * i),
                           *points(24, 50 + i, 0.3 * i))
        out = [mgr.score_many({f"t{i}": points(10, 90 + i)[0] for i in range(3)})]
        for i in range(3):
            mgr.submit(f"t{i}", *points(16, 70 + i, 0.3 * i))
        assert mgr.refit_now("test") == 3 and mgr.batched_refit_launches == 1
        mgr.flush()
        assert mgr.wait_precompiles(timeout=300)
        mgr.mark_warmup_complete()
        mgr.submit("t0", *points(64, 200))
        out.append(mgr.score_many({f"t{i}": points(8, 120 + i)[0] for i in range(3)}))
        s = mgr.summary()
        assert s["recompiles_after_warmup"] == 0 and s["post_warmup_growth_compile_events"] == 0
        assert s["per_tenant"]["t0"]["growths_precompiled"] == s["per_tenant"]["t0"]["slab_growths"] >= 1
        assert all(n <= 2 for tid, n in mgr.live_graphs().items() if tid != "_batched")
        mgrs.append((mgr, out))
    (gm, g_out), (cm, c_out) = mgrs
    for a, b in zip(g_out, c_out, strict=True):
        for tid in a:
            np.testing.assert_array_equal(a[tid], b[tid])
    for tid in gm.tenant_ids:
        assert torch.equal(gm.tenant(tid)._slab.labeled_mask.cpu(),
                           cm.tenant(tid)._slab.labeled_mask)
    assert gm.tenant("t0").program_stats()  # the captured graphs' counts
    for mgr, _ in mgrs:
        mgr.close()


def test_fleet_on_the_card_matches_in_process_and_the_cpu(cuda):
    """A spawned 2-worker fleet on the card (``serving/fleet.py``): 4 small
    gemm tenants' scores through the router bit-equal to each worker's
    manager built in process on the card and on the CPU; every worker on
    the card, no recompile after warmup, its groups the ring's placement."""
    from distributed_active_learning_tpu_torch.serving import fleet as fleet_lib

    specs = [fleet_lib.TenantSpec(f"u{i}", features=4, pool_rows=64, shift=0.3 * i, seed=20 + i,
                                  n_trees=6, max_depth=3, slab_rows=64, score_width=16,
                                  ingest_block=16) for i in range(4)]
    queries = {s.tenant_id: np.random.default_rng(600 + i).normal(size=(21, 4)).astype(np.float32)
               for i, s in enumerate(specs)}
    fleet = fleet_lib.Fleet(specs, n_workers=2, device="cuda").start()
    try:
        got = {tid: fleet.score(tid, q) for tid, q in queries.items()}
    finally:
        final = fleet.stop()
    for dev in (cuda, "cpu"):
        for wid in fleet.worker_ids:
            mgr = fleet_lib.build_manager(fleet.specs_for(wid), device=dev)
            try:
                for s in fleet.specs_for(wid):
                    want = mgr.score_many({s.tenant_id: queries[s.tenant_id]})[s.tenant_id]
                    np.testing.assert_array_equal(got[s.tenant_id], want)
            finally:
                mgr.close()
    for wid, f in final["workers"].items():
        assert f["device"].startswith("cuda") and f["recompiles_after_warmup"] == 0, f
        placed = [s.tenant_id for s in fleet.specs_for(wid)]
        assert f["score_groups"] == ([placed] if len(placed) > 1 else []), f
    assert final["router"]["unroutable"] == 0


def test_pod_ring_attention_and_neural_mesh_across_cards(cuda):
    """The rest of the single-process mesh with its shards spread over the
    visible cards (peer copies between them), each equal to the CPU: the
    pod slab pool (routed ingest, a rebalance epoch, a growth, the fused
    select: K3 on each card, K4 across them), ring attention over an
    8-shard ring, and the neural loop under ``MeshConfig(data=8)``, per
    round and chunked (the chunk runs eagerly across cards:
    ``graph_stats["mode"]`` says "eager")."""
    from distributed_active_learning_tpu_torch.config import MeshConfig
    from distributed_active_learning_tpu_torch.models.neural import MLP, NeuralLearner
    from distributed_active_learning_tpu_torch.ops import ring_attention as ra
    from distributed_active_learning_tpu_torch.runtime import neural_loop as nl
    from distributed_active_learning_tpu_torch.serving import slab

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more cards: the shards' blocks cross cards")
    cards = [torch.device("cuda", s % n_cards) for s in range(8)]
    rng = np.random.default_rng(11)

    # The pod: 4 shards (test_pod_pool.py's sizes) on the cards and on the CPU.
    x0 = rng.normal(size=(32, 4)).astype(np.float32)
    y0 = (x0[:, 0] > 0).astype(np.int32)
    m0 = rng.random(32) < 0.4
    xa = rng.normal(size=(40, 4)).astype(np.float32)
    ya = (xa[:, 0] > 0).astype(np.int32)
    gf = _forest(8, 3, 4, torch.device("cpu"), seed=3)[0]
    pods = {}
    for side, devs in (("cards", cards[:4]), ("cpu", [torch.device("cpu")] * 4)):
        d0 = devs[0]
        mesh = mesh_lib.make_mesh(4, 1, devices=devs, device=d0.type)
        edges = trees_train.make_bins(torch.from_numpy(x0).to(d0), 8).edges
        pod = slab.shard_slab_pool(slab.init_slab_pool(x0, y0, m0, edges, 64), mesh)
        ingest = slab.make_sharded_ingest_fn(mesh)
        for lo, hi in ((0, 8), (8, 16), (16, 24)):
            pod, _ = ingest(pod, edges, torch.from_numpy(xa[lo:hi]).to(d0),
                            torch.from_numpy(ya[lo:hi]).to(d0), hi - lo,
                            slab.route_to_shard(pod.n_filled.cpu().clone()))
        pod, msrc, mdst = slab.make_rebalance_fn(mesh, 8)(pod)
        sel = mesh_lib.Sharded(tuple(
            (~pod.labeled_mask.block(s) & (torch.arange(16, device=devs[s]) < int(pod.n_filled[s])),)
            for s in range(4)), pod.capacity)
        picked = round_fused.fused_score_select(
            trees_pallas.attach_mesh(trees_pallas.PallasForest(gf=gf).to(d0), mesh), pod.x, sel,
            "uncertainty", 7)
        grown = slab.grow_sharded_slab(pod, mesh)
        pods[side] = [mesh_lib.gather(getattr(grown, f)).cpu() for f in
                      ("x", "oracle_y", "labeled_mask", "codes", "n_filled")]
        pods[side] += [msrc.cpu(), mdst.cpu(), picked[0].cpu(), picked[1].cpu()]
    for a, b in zip(pods["cards"], pods["cpu"]):
        assert torch.equal(a, b)

    # Ring attention over 8 shards on the cards, against the CPU's ring and
    # full attention (the JAX test's 2e-4).
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 32, 4, 8)).astype(np.float32))
               for _ in range(3))
    mesh8 = mesh_lib.make_mesh(8, 1, devices=cards)
    for causal in (False, True):
        got = ra.ring_attention(q.to(cuda), k.to(cuda), v.to(cuda), mesh8, causal=causal).cpu()
        want = ra.ring_attention(q, k, v, mesh_lib.make_mesh(8, 1, device="cpu"), causal=causal)
        assert torch.allclose(got, want, rtol=0, atol=1e-5)
        assert torch.allclose(got, ra.full_attention(q, k, v, causal=causal), rtol=0, atol=2e-4)

    # The neural loop under MeshConfig(data=8) over the cards == the CPU.
    x = rng.normal(size=(250, 4)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32)
    for strat in ("entropy", "coreset"):
        for K in (1, 2):
            cfg = nl.NeuralExperimentConfig(strategy=strat, window_size=5, n_start=10,
                                            max_rounds=3, seed=1, rounds_per_launch=K,
                                            mesh=MeshConfig(data=8))
            res = {}
            for side, dev, devs in (("cards", cuda, cards), ("cpu", torch.device("cpu"), None)):
                lr = NeuralLearner(MLP(hidden=(16,)), (4,), train_steps=10, mc_samples=2,
                                   device=dev)
                res[side] = nl.run_neural_experiment(cfg, lr, x, y, x[:60], y[:60], devices=devs)
            assert [(r.round, r.n_labeled) for r in res["cards"].records] == \
                [(r.round, r.n_labeled) for r in res["cpu"].records], (strat, K)
            assert torch.equal(res["cards"].final_labeled_mask.cpu(),
                               res["cpu"].final_labeled_mask), (strat, K)
            if K > 1:
                assert res["cards"].graph_stats["mode"] == "eager"


# -- the mesh over processes (parallel/multihost.py) --------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_preflight_on_the_card(cuda):
    """chip_smoke.py phase 4t (a), (b) and (d) at a reduced size: the
    fused round step's count on the card equals its count on the CPU and on
    the meta device (the kernels at their declared work, whatever computes
    them), and no share of the card's peaks is above 1.0 in a graph
    replay's time; the memory pre-flight's predictions (meta device) are not
    below the eager step's ``max_memory_allocated`` nor its graph capture's
    pool, for the forest round step, a serving capacity and a small CNN
    chunk step, whose convolutions are priced by cuDNN's own workspace
    answer (``csrc/cudnn_workspace.cu``) to within 1.15 of the peak and 1.40
    of the pool; the shared-memory mirrors equal the C configuration. And
    phase 4t (e): each of those programs traced on the card audits clean
    (``analysis/auditor.py``), and the forest chunk's and a 4 x 2 mesh
    chunk's traced launches equal their capture's tally; ``run.py --audit``
    refuses a planted ``.item()`` in the chunk body by its rule id; the
    lint over the port finds nothing."""
    import ctypes
    import gc

    from distributed_active_learning_tpu_torch import kernels
    from distributed_active_learning_tpu_torch.analysis import (
        auditor, lint, memory, programs, roofline,
    )
    from distributed_active_learning_tpu_torch.device import deterministic_cuda
    from distributed_active_learning_tpu_torch.runtime import loop, neural_loop

    cfg = dataclasses.replace(programs.BENCH_CONFIG, n_start=500)
    head = programs.forest_program("chunk", cfg, programs.ForestShapes(20_000, 30, 4_000), seed=3)
    counted = {}
    for dev in (cuda, torch.device("cpu"), torch.device("meta")):
        unit = head(dev)
        unit.fn(*unit.args)  # warm: a device's constants are uploaded at its first call
        counted[dev.type] = roofline.program_cost(unit.fn, *unit.args)
    for key in ("flops", "bytes_accessed", "kernels"):
        assert counted["cuda"][key] == counted["cpu"][key] == counted["meta"][key], key
    unit = head(cuda)
    step = loop.GraphedChunk(loop.chunk_of(unit.fn, lambda rows, *a: (None, rows), 1))
    step(*unit.args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        step(*unit.args)
    end.record()
    end.synchronize()
    attr = roofline.attribute_card(counted["cuda"], start.elapsed_time(end) / 5e3)
    assert all(v <= 1.0 for v in roofline.shares(attr).values()), attr
    assert attr["bound"] in ("bandwidth-bound", "compute-bound")
    del step, unit

    deterministic_cuda()
    cases = (
        (head, loop.CARRY_FIELDS),
        (programs.serve_program("serve_chunk", programs.serve_config(4), programs.SERVE_CONFIG,
                                8_192, 30, 2_048), loop.CARRY_FIELDS),
        (programs.neural_chunk_program(programs.NeuralShapes(
            "cnn", (32, 32, 3), 2_000, 500, 10, train_steps=10, mc_samples=2, window=20)),
         neural_loop.NEURAL_CARRY_FIELDS),
    )
    for i, (make, fields) in enumerate(cases):
        memory._workspaces.clear()
        pred = memory.program_memory(*(lambda u: (u.fn, *u.args))(make(torch.device("meta"))))
        unit = make(cuda)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            unit.fn(*unit.args)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        inputs = sum(memory.block_bytes(n) for n in {
            t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in memory.tensor_leaves(unit.args) if t.is_cuda}.values())
        torch.cuda.reset_peak_memory_stats()
        with torch.cuda.stream(side):
            res = unit.fn(*unit.args)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base + inputs
        del res
        stats = {}
        found = auditor.audit_unit(auditor.AuditUnit.of(f"case {i}", unit), stats=stats)
        assert not found, [str(f) for f in found]
        graph = loop.GraphedChunk(loop.chunk_of(unit.fn, lambda rows, *a: (None, rows), 1),
                                  carry_fields=fields)
        graph.capture(*unit.args)
        if i == 0:  # the forest chunk: what the auditor reads is what the card runs
            assert stats["launches"] == auditor.kernel_launches(graph.launches_per_replay)
        assert pred["peak_hbm_bytes"] >= measured, (pred, measured)
        assert pred["pool_bytes"] >= graph.pool_bytes, (pred, graph.pool_bytes)
        if i == 2:  # the CNN: each convolution's workspace is cuDNN's own answer
            assert memory._workspaces, "no convolution was priced by cuDNN's query"
            assert pred["peak_hbm_bytes"] <= 1.15 * measured, (pred, measured)
            assert pred["pool_bytes"] <= 1.40 * graph.pool_bytes, (pred, graph.pool_bytes)
        del graph, unit
        gc.collect()
        torch.cuda.empty_cache()

    from distributed_active_learning_tpu_torch import run as run_cli
    from distributed_active_learning_tpu_torch.config import MeshConfig
    from distributed_active_learning_tpu_torch.runtime import state as state_lib

    mesh = programs.forest_program("chunk", dataclasses.replace(cfg, mesh=MeshConfig(4, 2)),
                                   programs.ForestShapes(20_000, 30, 4_000), seed=3)(cuda)
    stats = {}
    assert not auditor.audit_unit(auditor.AuditUnit.of("mesh", mesh), stats=stats)
    graph = loop.GraphedChunk(loop.chunk_of(mesh.fn, lambda rows, *a: (None, rows), 1))
    graph.capture(*mesh.args)
    assert graph.stats()["mode"] == "graph"
    assert stats["launches"] == auditor.kernel_launches(graph.launches_per_replay) == {
        "fused_votes": 8, "ring_hop": 3, "forest_leaves": 8}
    del graph, mesh
    count = state_lib.labeled_count

    def read_back(state):
        n = count(state)
        n.item()
        return n

    state_lib.labeled_count = read_back
    try:
        with pytest.raises(SystemExit, match="audit failed"):
            run_cli.main(["--fit", "device", "--kernel", "pallas", "--n-samples", "300",
                          "--trees", "8", "--window", "15", "--rounds", "4",
                          "--rounds-per-launch", "2", "--quiet", "--audit"])
    finally:
        state_lib.labeled_count = count
    assert lint.lint_paths(lint.default_lint_targets()) == []

    optin = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    for n, d, T, depth in ((20_000, 30, 100, 8), (20_000, 30, 256, 8), (64, 30, 100, 4)):
        for item, code in ((4, 0), (2, 1), (1, 2)):
            L = 1 << depth
            N, Lp = max(L, 2), -(-L // (16 // item)) * (16 // item)
            got = (ctypes.c_int * 6)()
            kernels.check("cfg", kernels.load("forest_leaves").forest_leaves_config(
                n, d, code, T, depth, N, Lp, got))
            mine = memory.smem_for_launch("forest_leaves", n, d, T, depth, item, optin)
            assert [mine["rows"], mine["trees_per_chunk"], mine["smem_bytes"]] == list(got)[:3]
            for name in ("round_megakernel", "fused_votes"):
                kernels.check("cfg", getattr(kernels.load(name), f"{name}_config")(
                    n, d, code, T, depth, N, Lp, got))
                mine = memory.smem_for_launch(name, n, d, T, depth, item, optin)
                assert [mine["mode"], mine["groups"], mine["trees_per_chunk"],
                        mine["smem_bytes"]] == [("resident", "streamed")[got[0]], *list(got)[1:4]]


def _run_ranks(n, mode, tmp_path, local_ranks, timeout=600):
    """This file's ``__main__`` as ``n`` ranks of a gloo job (the JAX
    package's env trio, a ``file://`` rendezvous), rank ``r`` on
    ``cuda:local_ranks[r]``; every rank's JSON result, in rank order. A rank
    past ``timeout`` kills them all and fails."""
    from distributed_active_learning_tpu_torch import kernels

    kernels.build_all()  # once here, not once a rank
    tmp_path.mkdir(parents=True, exist_ok=True)
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"file://{tmp_path}/rendezvous",
                   JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(r), LOCAL_RANK=str(local_ranks[r]),
                   PYTHONPATH=os.pathsep.join([_REPO, os.environ.get("PYTHONPATH", "")]))
        logs.append(tmp_path / f"rank{r}.log")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), mode],
                                          env=env, cwd=_REPO, stdout=log,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:  # the others would wait in a collective
            for p in procs:
                p.kill()
                p.wait()
            if not failed:
                pytest.fail(f"a rank of {n} hung past {timeout}s")
            break
        time.sleep(0.05)
    got = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        out = log.read_text()
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        got.append(json.loads(next(ln for ln in out.splitlines()
                                   if ln.startswith(f"RANK_OK {r} ")).split(" ", 2)[2]))
    return got


def _mp_forest_cfg(n, K, mesh=None):
    from distributed_active_learning_tpu_torch import config

    return config.ExperimentConfig(
        data=config.DataConfig(name="checkerboard2x2", n_samples=301, seed=1),
        forest=config.ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
        strategy=config.StrategyConfig(name="uncertainty", window_size=15),
        mesh=config.MeshConfig(*(mesh or (n, 2))), n_start=10, max_rounds=3, fused_round=True,
        rounds_per_launch=K)


#: The mesh whose model axis spans the job's ranks, one cell a rank: a row
#: over the 2 ranks of one card, two rows of 2 over 4 cards.
_MP_MODEL_AXIS = {2: (1, 2), 4: (2, 2)}


def _check_multi_process(cuda, tmp_path, n, local_ranks):
    """K4 through CUDA IPC against the plain gloo hop (also on a ring with
    repeated members, rank 0 holding two consecutive windows), and the fused mesh run
    (per round, and chunked at K = 2: eager) against the single-process
    mesh run on the card; then the mesh whose model axis spans the ranks
    (one cell a rank: K3 once a round, K4 ``data - 1`` times a round in its
    column ring), against the same run."""
    from distributed_active_learning_tpu_torch.runtime import loop

    for r, g in enumerate(_run_ranks(n, "ring", tmp_path / "ring", local_ranks)):
        assert g["ipc_equals_gloo"] and g["equals_single_process"], (r, g)
        assert g["launches"] == n - 1, (r, g)  # one K4 a step the rank sends
        assert g["repeated_ipc_equals_gloo"] and g["repeated_equals_single_process"], (r, g)
        assert g["repeated_launches"] == n, (r, g)  # n + 1 windows: n steps
        assert g["device"] == f"cuda:{local_ranks[r]}", (r, g)
    got = _run_ranks(n, "forest", tmp_path / "forest", local_ranks)
    for K in (1, 2):
        want = loop.run_experiment(_mp_forest_cfg(n, K), device=cuda, devices=[cuda] * (2 * n))
        for r, g in enumerate(got):
            assert g[f"records_{K}"] == [[x.round, x.n_labeled, x.accuracy] for x in want.records]
            assert g[f"mask_{K}"] == torch.nonzero(want.final_labeled_mask).flatten().tolist()
            steps = K * -(-3 // K)  # a chunk's inactive tail steps run too
            assert g[f"launches_{K}"]["fused_votes"] == 2 * steps, (r, K, g)
            assert g[f"launches_{K}"]["ring_hop"] == (n - 1) * steps, (r, K, g)
        assert got[0]["mode_2"] == "eager" and "processes" in got[0]["mode_reason_2"]
        if K == 1:
            data = _MP_MODEL_AXIS[n][0]
            for r, g in enumerate(got):
                assert g["records_model"] == [[x.round, x.n_labeled, x.accuracy]
                                              for x in want.records], (r, g)
                assert g["mask_model"] == torch.nonzero(
                    want.final_labeled_mask).flatten().tolist()
                assert g["launches_model"] == {"forest_leaves": 3, "fused_votes": 3,
                                               "ring_hop": (data - 1) * 3}, (r, g)


def test_multi_process_mesh_on_one_card(cuda, tmp_path):
    """Two processes on one card, as a one-card machine has it: K4's
    cross-process hop through CUDA IPC equals the plain gloo hop bit for
    bit, and a short forest run over the 2 x 2 mesh of the two processes,
    and over ``MeshConfig(1, 2)`` (the model axis across them), equals the
    single-process run."""
    _check_multi_process(cuda, tmp_path, 2, [0, 0])


def test_multi_process_mesh_across_cards(cuda, tmp_path):
    """Four processes on four cards (``LOCAL_RANK`` r on ``cuda:r``): the
    IPC hop crosses cards with peer access, and the run equals the
    single-process run, also on ``MeshConfig(2, 2)`` (one cell a card, the
    layout four-card users run: each column ring's hop crosses cards)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: one rank a card, the IPC hop crossing cards")
    _check_multi_process(cuda, tmp_path, 4, [0, 1, 2, 3])


def _rank_main(mode):
    """One rank of :func:`_run_ranks`: prints ``RANK_OK <rank> {json}``."""
    from distributed_active_learning_tpu_torch.device import resolve_device
    from distributed_active_learning_tpu_torch.parallel import multihost
    from distributed_active_learning_tpu_torch.runtime import loop

    assert multihost.maybe_initialize()
    rank, n = multihost.process_index(), multihost.process_count()
    dev = resolve_device(None)
    out = {"device": str(dev)}
    if mode == "ring":
        k, rows = 100, 3000
        windows = []
        for s in range(n):  # every rank's window, from one seed: rank s's on the card
            rng = np.random.default_rng(100 + s)
            v = torch.from_numpy(np.round(rng.normal(size=rows), 1).astype(np.float32))
            top = torch.sort(v, descending=True, stable=True)
            windows.append((top.values[:k].contiguous(),
                            (top.indices[:k] + s * rows).to(torch.int32)))
        mine = [(windows[rank][0].to(dev), windows[rank][1].to(dev))]
        ring_topk.launches = 0
        got_ipc, got_gloo = [], []
        merged = ring_topk.ring_topk(mine, k, members=range(n), received=got_ipc)[0]
        out["launches"] = ring_topk.launches
        plain = ring_topk.ring_topk(mine, k, members=range(n), plain=True, received=got_gloo)[0]
        out["ipc_equals_gloo"] = all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(got_ipc + [merged], got_gloo + [plain]))
        want = ring_topk.ring_topk(windows, k)[0]  # one process, the CPU's copies
        out["equals_single_process"] = (torch.equal(merged[0].cpu(), want[0])
                                        and torch.equal(merged[1].cpu(), want[1]))
        # A ring with repeated members, as a mesh whose ranks' cells cross a
        # row boundary makes (column 0 of (3, 2) over 2 ranks: 0, 0, 1):
        # rank 0 holds two consecutive windows, its hop between them stays
        # on the rank, the others cross by K4 through IPC.
        reps = (0, *range(n))
        rep_windows = []
        for s in range(len(reps)):
            rng = np.random.default_rng(200 + s)
            v = torch.from_numpy(np.round(rng.normal(size=rows), 1).astype(np.float32))
            top = torch.sort(v, descending=True, stable=True)
            rep_windows.append((top.values[:k].contiguous(),
                                (top.indices[:k] + s * rows).to(torch.int32)))
        mine = [(v.to(dev), i.to(dev)) for (v, i), r in zip(rep_windows, reps) if r == rank]
        ring_topk.launches = 0
        got_ipc, got_gloo = [], []
        merged = ring_topk.ring_topk(mine, k, members=reps, received=got_ipc)
        out["repeated_launches"] = ring_topk.launches
        plain = ring_topk.ring_topk(mine, k, members=reps, plain=True, received=got_gloo)
        out["repeated_ipc_equals_gloo"] = len(got_ipc) == len(got_gloo) and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(got_ipc + merged, got_gloo + plain))
        want = ring_topk.ring_topk(rep_windows, k)[0]
        out["repeated_equals_single_process"] = all(
            torch.equal(m[0].cpu(), want[0]) and torch.equal(m[1].cpu(), want[1])
            for m in merged)
    else:
        for K in (1, 2):
            for m in (trees_pallas, round_fused, ring_topk):
                m.launches = 0
            round_fused.votes_launches = 0
            res = loop.run_experiment(_mp_forest_cfg(n, K), device=dev)
            out[f"records_{K}"] = [[r.round, r.n_labeled, r.accuracy] for r in res.records]
            out[f"mask_{K}"] = torch.nonzero(res.final_labeled_mask).flatten().tolist()
            out[f"launches_{K}"] = {"forest_leaves": trees_pallas.launches,
                                    "fused_votes": round_fused.votes_launches,
                                    "ring_hop": ring_topk.launches}
            if K > 1:
                out["mode_2"] = res.graph_stats["mode"]
                out["mode_reason_2"] = res.graph_stats["mode_reason"]
        for m in (trees_pallas, round_fused, ring_topk):
            m.launches = 0
        round_fused.votes_launches = 0
        res = loop.run_experiment(_mp_forest_cfg(n, 1, _MP_MODEL_AXIS[n]), device=dev)
        out["records_model"] = [[r.round, r.n_labeled, r.accuracy] for r in res.records]
        out["mask_model"] = torch.nonzero(res.final_labeled_mask).flatten().tolist()
        out["launches_model"] = {"forest_leaves": trees_pallas.launches,
                                 "fused_votes": round_fused.votes_launches,
                                 "ring_hop": ring_topk.launches}
    print(f"RANK_OK {rank} {json.dumps(out)}", flush=True)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
