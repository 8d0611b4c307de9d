"""The port's two kernel modules on the CPU, against the JAX package's Pallas
kernels in interpret mode on the same forest and pool:

- K1 (ops/trees_pallas.py): the plain version of csrc/forest_leaves.cu equals
  ``trees_pallas.predict_leaves_pallas(..., interpret=True)`` bit for bit;
  past the tile limits both packages take the exact gemm form;
- the kernels' packed operands (bit masks of the path matrix) reproduce the
  plain version when the kernel's arithmetic is emulated from them, and so
  does K1's heap walk over its heap operands (``walk_leaves_plain``), on
  rows with NaN, infinities and features equal to thresholds; so do K2's
  and K3's walk and packed vote bits (``walk_votes_plain``): the plain
  versions' votes and per-tile candidates; a path matrix that is not a heap
  is refused;
- K2 (ops/round_fused.py): ``fused_score_select`` on a pallas forest equals
  the JAX megakernel's ``(vals, idx)``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from distributed_active_learning_tpu.ops import round_fused as j_fused
from distributed_active_learning_tpu.ops import trees_pallas as j_pallas
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu_torch import interop
from distributed_active_learning_tpu_torch.ops import round_fused as t_fused
from distributed_active_learning_tpu_torch.ops import trees_pallas as t_pallas


def _forest(n_trees, depth, seed, n_fit=400, d=5):
    """A JAX device-fit forest (heap layout) and the port's copy of it."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_fit, d)).astype(np.float32)
    y = (x[:, 0] + 0.3 * x[:, 1] + 0.5 * rng.normal(size=n_fit) > 0).astype(np.int32)
    b = j_train.make_bins(jnp.asarray(x), 32)
    mask = jnp.asarray(rng.random(n_fit) < 0.4)
    c, yy, w = j_train.gather_fit_window(b.codes, jnp.asarray(y), mask, n_fit)
    f, th, v = j_train.fit_forest_device(
        c, yy, w, b.edges, jax.random.key(seed), n_trees=n_trees, max_depth=depth)
    gf = j_train.heap_gemm_forest(f, th, v, depth)
    arrays = [np.array(a) for a in (gf.feat_ids, gf.thresholds, gf.path, gf.target, gf.value)]
    return gf, interop.gemm_forest_from_numpy(*arrays), rng


@pytest.mark.parametrize("n_trees,n", [
    (10, 300), (13, 1700),
    pytest.param(10, 1700, marks=pytest.mark.slow),
    pytest.param(13, 300, marks=pytest.mark.slow),
])
def test_k1_plain_matches_pallas_interpret(n_trees, n):
    # 13 trees: not a multiple of the TPU kernel's 8-tree block; n = 1700:
    # above the 1536-row switch to its 2048-row tile.
    gf, tf, rng = _forest(n_trees, 4, seed=n_trees)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    want = np.asarray(j_pallas.predict_leaves_pallas(gf, jnp.asarray(x), interpret=True))
    got = t_pallas.predict_leaves_pallas(tf, torch.from_numpy(x))
    assert got.shape == (n, n_trees)
    np.testing.assert_array_equal(want.view(np.int32), got.numpy().view(np.int32))


def test_k1_depth9_takes_the_gemm_route_in_both_packages():
    gf, tf, rng = _forest(3, 9, seed=9)
    x = rng.normal(size=(257, 5)).astype(np.float32)
    want = np.asarray(j_pallas.predict_leaves_pallas(gf, jnp.asarray(x), interpret=True))
    before = t_pallas.gemm_route_calls
    got = t_pallas.predict_leaves_pallas(tf, torch.from_numpy(x))
    assert t_pallas.gemm_route_calls == before + 1
    np.testing.assert_array_equal(want.view(np.int32), got.numpy().view(np.int32))


def _unpack(words, i_pad):
    w = words.to(torch.int64) & 0xFFFFFFFF
    return ((w[..., None] >> torch.arange(32)) & 1).reshape(*words.shape[:-1], i_pad).float()


def test_kernel_operands_reproduce_the_plain_version():
    """K5 reads the forest as padded node slots and plus/minus bit masks;
    counting from those operands exactly as csrc/forest_eval.cuh does must
    give the plain version's leaves. K1, K2 and K3 walk the heap form: K1's
    leaves, and K2's and K3's votes from the vote bits they pack, must give
    the plain versions' leaves, votes and per-tile candidates."""
    _, tf, rng = _forest(11, 5, seed=4)  # I = 31 slots -> one 32-bit word
    _, tf8, _ = _forest(5, 8, seed=5)    # I = 255 slots -> eight words
    for gf in (tf, tf8):
        x = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32))
        ops = t_pallas.forest_operands(gf)
        assert ops.i_pad % 32 == 0 and ops.plus.dtype == torch.int32
        fv = x.to(torch.bfloat16).float()[:, ops.feat.long()]
        c = (fv <= ops.thr[None]).float()
        count = (torch.einsum("nti,tli->ntl", c, _unpack(ops.plus, ops.i_pad))
                 - torch.einsum("nti,tli->ntl", c, _unpack(ops.minus, ops.i_pad)))
        hit = (count == ops.tgt[None]).float()
        got = torch.einsum("ntl,tl->nt", hit, ops.val)
        assert torch.equal(got, t_pallas.predict_leaves_plain(gf, x))
    bad = interop.gemm_forest_from_numpy(
        np.zeros((1, 1)), np.zeros((1, 1)), np.full((1, 1, 2), 2.0), np.zeros((1, 2)),
        np.zeros((1, 2)))
    with pytest.raises(ValueError, match="-1, 0 or \\+1"):
        t_pallas.forest_operands(bad)

    # K1's heap form: the walk over it equals the plain version bit for bit.
    # These forests arrive as full path tensors, so the heap check runs by
    # value.
    _, tf1, _ = _forest(4, 1, seed=6)
    # Thresholds that bf16 represents, so that a feature set to one compares
    # equal after rounding (the <= of the walk, not <).
    tf8_b = dataclasses.replace(tf8, thresholds=tf8.thresholds.to(torch.bfloat16).float())
    for gf, depth in ((tf, 5), (tf8, 8), (tf1, 1), (tf8_b, 8)):
        heap = t_pallas.heap_operands(gf)
        assert heap.depth == depth and heap.nodes.dtype == torch.int64
        assert torch.equal(heap.feat, gf.feat_ids.to(torch.int32))
        assert torch.equal(heap.thr, gf.thresholds)
        x = _edge_rows(gf, rng)
        want = t_pallas.predict_leaves_plain(gf, x)
        got = t_pallas.walk_leaves_plain(heap, x)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), depth
        # K2 and K3: one vote bit a leaf (value > 0.5), 32 to a word.
        assert t_fused.vote_bits(heap).shape == (gf.n_trees, -(-(1 << depth) // 32))
        votes = t_fused.walk_votes_plain(heap, x)
        assert votes.dtype == torch.int32
        assert torch.equal(votes, t_fused.fused_votes_plain(gf, x)), depth
        sel = torch.from_numpy(rng.random(x.shape[0]) < 0.7)
        for name in ("uncertainty", "entropy"):
            table = t_fused.score_table(gf.n_trees, name, "cpu")
            for k in (10, 200):  # 200 > the 128-row tile: each tile gives all rows
                tv, ti = t_fused.tile_topk_plain(votes, sel, table, k)
                pv, pi = t_fused.megakernel_plain(gf, x, sel, table, k)
                assert torch.equal(tv, pv) and torch.equal(ti, pi), (depth, name, k)
    swapped = interop.gemm_forest_from_numpy(
        tf8.feat_ids.numpy(), tf8.thresholds.numpy(), tf8.path.numpy()[:, :, [1, 0, *range(2, 256)]],
        tf8.target.numpy(), tf8.value.numpy())
    with pytest.raises(ValueError, match="not a complete heap|host fit"):
        t_pallas.heap_operands(swapped)


def _edge_rows(gf, rng, n=300):
    """Normal rows, then rows of NaN, +inf and -inf (whole rows and single
    features), and rows whose features sit exactly on node thresholds: the
    f32 threshold itself and the bf16 tie just above its bf16 rounding."""
    d = 5
    x = rng.normal(size=(n, d)).astype(np.float32)
    for j, v in enumerate((np.nan, np.inf, -np.inf)):
        x[j] = v
        x[3 + j, j % d] = v
    feat = gf.feat_ids.numpy()
    thr = gf.thresholds.numpy()
    T, I = feat.shape
    for r in range(6, n, 2):
        t, i = rng.integers(T), rng.integers(I)
        x[r, feat[t, i]] = thr[t, i]
        tie = ((thr[t, i:i + 1].view(np.uint32) + 0x7FFF) & 0xFFFF0000) | 0x8000
        x[r + 1, feat[t, i]] = tie.view(np.float32)[0]
    return torch.from_numpy(x)


def _fused_pair(gf, tf, x, sel, name, k):
    vj, ij = j_fused.fused_score_select(
        j_pallas.PallasForest(gf=gf), jnp.asarray(x), jnp.asarray(sel), name, k)
    vt, it = t_fused.fused_score_select(
        t_pallas.PallasForest(gf=tf), torch.from_numpy(x), torch.from_numpy(sel), name, k)
    return np.asarray(vj), np.asarray(ij), vt.numpy(), it.numpy()


def test_k2_fused_score_select_exact_for_rational_scores():
    """uncertainty and margin are rational in the vote fraction: vals and idx
    equal exactly (every tree count is covered by
    tests/test_torch_scoring.py; 13 trees there)."""
    gf, tf, rng = _forest(8, 4, seed=28)
    x = rng.normal(size=(400, 5)).astype(np.float32)
    sel = rng.random(400) < 0.8
    before = t_fused.stream_route_calls
    for name in ("uncertainty", "margin"):
        for k in (10, 60):
            vj, ij, vt, it = _fused_pair(gf, tf, x, sel, name, k)
            np.testing.assert_array_equal(ij, it)
            np.testing.assert_array_equal(vj, vt)
    assert t_fused.stream_route_calls == before  # the megakernel route, not the stream


def test_k2_fused_score_select_entropies_within_4_ulp():
    """entropy and full_entropy go through log2: the port computes it as
    XLA's CPU code does (ops/xla_f32.py), so vals and idx equal exactly,
    well inside the 4 ulp this test once allowed, also for windows that
    reach past the top score group into full_entropy's v / T - v ties."""
    gf, tf, rng = _forest(8, 4, seed=28)
    x = rng.normal(size=(400, 5)).astype(np.float32)
    sel = rng.random(400) < 0.8
    for name in ("entropy", "full_entropy"):
        for k in (10, 60):
            vj, ij, vt, it = _fused_pair(gf, tf, x, sel, name, k)
            np.testing.assert_array_equal(ij, it)
            np.testing.assert_array_equal(vj.view(np.int32), vt.view(np.int32))
