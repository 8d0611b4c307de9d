"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU (sm_90a build): the kernels in
distributed_active_learning_tpu_torch/csrc have no CPU or interpret mode, so
without a card every test here skips with that reason. On a machine with a
card and without JAX, run them as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(the repo's conftest.py configures JAX). The file imports no JAX.
"""

import numpy as np
import pytest
import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.ops import round_fused, trees_pallas, trees_train
from distributed_active_learning_tpu_torch.ops.topk import merge_tile_topk

pytestmark = pytest.mark.cuda


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
