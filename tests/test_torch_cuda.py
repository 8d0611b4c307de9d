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


def _forest(n_trees, depth, d, dev, seed=0, m=2000):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev)
    y = (x[:, 0] + 0.3 * x[:, 1] > 0).to(torch.int32)
    b = trees_train.make_bins(x, 32)
    f, th, v = trees_train.fit_forest_device(
        b.codes, y, torch.ones(m, device=dev), b.edges, prng.key(seed),
        n_trees=n_trees, max_depth=depth)
    return trees_train.heap_gemm_forest(f, th, v, depth), rng


def _edge_rows(gf, rng, n, d):
    """Normal rows, then rows of NaN, +inf and -inf (whole rows and single
    features), then rows whose features sit exactly on node thresholds (the
    f32 threshold and the bf16 tie above its rounding)."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    feat, thr = gf.feat_ids.cpu().numpy(), gf.thresholds.cpu().numpy()
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
    (csrc/forest_leaves_segmented.cu) against their plain versions."""
    from distributed_active_learning_tpu_torch.benches import pallas_variants as pv

    for n_trees, depth, d, n in ((20, 8, 30, 3001), (13, 4, 7, 1700)):
        gf, rng = _forest(n_trees, depth, d, cuda, seed=n_trees)
        x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
        k1 = trees_pallas.predict_leaves_pallas(gf, x)
        before = pv.transposed_launches
        flag_sets = [dict(), dict(bn=1024, bt=8), dict(bn=2048, bt=4, tree_outer=True),
                     dict(leaf_f32=True)] + [dict(ablate=a) for a in pv.ABLATE[1:]]
        for flags in flag_sets:
            got = pv.predict_leaves_transposed(gf, x, **flags)
            want = pv.predict_leaves_transposed_plain(
                gf, x, flags.get("leaf_f32", False), flags.get("ablate", "full"))
            assert got.shape == (n, n_trees) and torch.equal(got, want), flags
            if flags.get("leaf_f32"):
                assert torch.equal(got, k1)
        assert pv.transposed_launches == before + len(flag_sets)
        before = pv.segmented_launches
        for bn in (1024, 4096):
            got = pv.predict_leaves_segmented(gf, x, bn=bn, bt=8)
            assert torch.equal(got, pv.predict_leaves_segmented_plain(gf, x, bn=bn, bt=8)), bn
        assert pv.segmented_launches == before + 2


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


def _to_cpu(gf):
    import dataclasses

    return dataclasses.replace(
        gf, **{f.name: getattr(gf, f.name).cpu() for f in dataclasses.fields(gf)})
