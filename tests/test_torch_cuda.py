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


def test_forest_leaves_kernel_matches_plain(cuda):
    for n_trees, depth, d, n in ((20, 8, 30, 3001), (13, 4, 7, 1700), (5, 5, 3, 100)):
        gf, rng = _forest(n_trees, depth, d, cuda, seed=n_trees)
        x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
        before = trees_pallas.launches
        got = trees_pallas.predict_leaves_pallas(gf, x)
        assert trees_pallas.launches == before + 1
        want = trees_pallas.predict_leaves_plain(gf, x)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (n, n_trees)
        assert torch.equal(got, want), (n_trees, depth, d, n)


def test_round_megakernel_matches_plain(cuda):
    gf, rng = _forest(16, 8, 30, cuda, seed=3)
    n = 5000
    x = torch.from_numpy(rng.normal(size=(n, 30)).astype(np.float32)).to(cuda)
    sel = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    ops = trees_pallas.forest_operands(gf)
    for name in ("uncertainty", "entropy", "full_entropy", "margin"):
        table = round_fused.score_table(gf.n_trees, name, cuda)
        for k in (50, 200):  # 200 > the 128-row tile: each tile gives all rows
            tv, ti = round_fused._launch_megakernel(ops, x, sel, table, k)
            pv, pi = round_fused.megakernel_plain(gf, x, sel, table, k)
            torch.cuda.synchronize()
            assert torch.equal(tv, pv) and torch.equal(ti, pi), (name, k)
            v1, i1 = merge_tile_topk(tv, ti, k)
            v2, i2 = merge_tile_topk(pv, pi, k)
            assert torch.equal(v1, v2) and torch.equal(i1, i2)
        vals, idx = round_fused.fused_score_select(
            trees_pallas.PallasForest(gf=gf), x, sel, name, 50)
        assert bool(sel[idx.long()].all()) and bool(torch.isfinite(vals).all())


def test_mesh_kernels_match_plain(cuda):
    """K3 (csrc/fused_votes.cu) and K4 (csrc/ring_hop.cu) against their plain
    versions, and the 4 x 2 mesh on one card against the CPU mesh."""
    for n_trees, depth, d, n in ((20, 8, 30, 3001), (13, 4, 7, 1700)):
        gf, rng = _forest(n_trees, depth, d, cuda, seed=n_trees)
        x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
        before = round_fused.votes_launches
        got = round_fused.fused_votes(trees_pallas.PallasForest(gf=gf), x)
        assert round_fused.votes_launches == before + 1
        assert torch.equal(got, round_fused.fused_votes_plain(gf, x)), (n_trees, n)

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
    assert ring_topk.launches == before + 1 + 4 * 3
    cpu = ring_topk.ring_topk([(v.cpu(), i.cpu()) for v, i in windows], k)
    for (mv, mi), (cv, ci) in zip(merged, cpu):
        assert torch.equal(mv.cpu(), cv) and torch.equal(mi.cpu(), ci)

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
