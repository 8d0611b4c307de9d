"""The port's two kernel modules on the CPU, against the JAX package's Pallas
kernels in interpret mode on the same forest and pool:

- K1 (ops/trees_pallas.py): the plain version of csrc/forest_leaves.cu equals
  ``trees_pallas.predict_leaves_pallas(..., interpret=True)`` bit for bit;
  past the tile limits both packages take the exact gemm form; host-fit
  forests (scikit-learn packing, forest files, the gather and path-matrix
  forms, K1 through their heap packing) equal the JAX package's;
- the kernels' packed operands reproduce the plain versions when the
  kernels' arithmetic is emulated from them: K5's heap words and payload
  (``walk_transposed_plain``), K1's heap walk (``walk_leaves_plain``), K2's
  and K3's walk and packed vote bits (``walk_votes_plain``: the plain
  versions' votes and per-tile candidates), on rows with NaN, infinities
  and features equal to thresholds; a path matrix that is not a heap is
  refused;
- K2 (ops/round_fused.py): ``fused_score_select`` on a pallas forest equals
  the JAX megakernel's ``(vals, idx)``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from distributed_active_learning_tpu import config as j_config
from distributed_active_learning_tpu.models import forest as j_forest
from distributed_active_learning_tpu.models import forest_io as j_io
from distributed_active_learning_tpu.ops import forest_eval as j_eval
from distributed_active_learning_tpu.ops import round_fused as j_fused
from distributed_active_learning_tpu.ops import trees as j_trees
from distributed_active_learning_tpu.ops import trees_gemm as j_gemm
from distributed_active_learning_tpu.ops import trees_pallas as j_pallas
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu_torch import config as t_config
from distributed_active_learning_tpu_torch import interop
from distributed_active_learning_tpu_torch.benches import pallas_variants as t_var
from distributed_active_learning_tpu_torch.models import forest as t_forest
from distributed_active_learning_tpu_torch.models import forest_io as t_io
from distributed_active_learning_tpu_torch.ops import forest_eval as t_eval
from distributed_active_learning_tpu_torch.ops import round_fused as t_fused
from distributed_active_learning_tpu_torch.ops import trees as t_trees
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


def test_k1_depth9_takes_the_gemm_route_in_both_packages(tmp_path):
    """Past K1's tile limits both packages take the exact gemm form. Then
    host-fit forests, which are no heaps: scikit-learn fits packed by both
    packages are the same arrays (depths 4 and 8, and a single-class fit),
    and forest files cross both ways; from there the port's path-matrix
    form (``gemm_forest_from_packed``), its gather form (leaves, proba,
    votes, value, ``pad_forest``) and K1 through ``for_kernel(..., "pallas")``
    equal the JAX package's (K1 against JAX's Pallas kernel in interpret
    mode on finite rows, against its gemm form on bf16-rounded rows with a
    NaN or an infinity; gather and gemm exact in f32 on every row) on rows
    with NaN, infinities and features on thresholds, and walking the heaps that ``heap_from_packed``
    builds gives K1's plain version exactly."""
    gf, tf, rng = _forest(3, 9, seed=9)
    x = rng.normal(size=(257, 5)).astype(np.float32)
    want = np.asarray(j_pallas.predict_leaves_pallas(gf, jnp.asarray(x), interpret=True))
    before = t_pallas.gemm_route_calls
    got = t_pallas.predict_leaves_pallas(tf, torch.from_numpy(x))
    assert t_pallas.gemm_route_calls == before + 1
    np.testing.assert_array_equal(want.view(np.int32), got.numpy().view(np.int32))

    x_fit = rng.normal(size=(150, 5)).astype(np.float32)
    y_fit = (x_fit[:, 0] + 0.3 * x_fit[:, 1] + 0.4 * rng.normal(size=150) > 0).astype(np.int32)
    fits = [(4, y_fit), (8, y_fit), (3, np.zeros(150, dtype=np.int32))]
    packed = None
    for depth, y in fits:
        jp = j_forest.fit_forest_classifier(
            x_fit, y, j_config.ForestConfig(n_trees=9, max_depth=depth), seed=depth)
        tp = t_forest.fit_forest_classifier(
            x_fit, y, t_config.ForestConfig(n_trees=9, max_depth=depth), seed=depth)
        _packed_equal(jp, tp)
        # Forest files both ways: the JAX package's file loads in the port
        # and the port's in the JAX package, with their meta strings.
        j_io.save_forest(str(tmp_path / "j.npz"), jp, meta=f"jax {depth}")
        tp_file, meta = t_io.load_forest(str(tmp_path / "j.npz"), device="cpu")
        assert meta == f"jax {depth}"
        _packed_equal(jp, tp_file)
        t_io.save_forest(str(tmp_path / "t.npz"), tp, meta="port")
        jp_file, meta = j_io.load_forest(str(tmp_path / "t.npz"))
        assert meta == "port"
        _packed_equal(jp_file, tp)
        # load_or_train: trains and saves when the file is missing or its
        # meta differs, loads otherwise.
        calls = []

        def train(tp=tp):
            calls.append(1)
            return tp

        path = str(tmp_path / f"lot{depth}.npz")
        for meta in ("a", "a", "b"):
            _packed_equal(jp, t_io.load_or_train(path, train, meta=meta, device="cpu"))
        assert len(calls) == 2

        jg = j_gemm.gemm_forest_from_packed(jp, 2**depth - 1, 2**depth)
        tg = t_eval.for_kernel(tp_file, "gemm")
        for field in ("feat_ids", "thresholds", "path", "target", "value"):
            _bits_equal(getattr(jg, field), getattr(tg, field))
        x = np.concatenate([_edge_rows(tg, rng).numpy(),
                            rng.normal(size=(64, 5)).astype(np.float32)])
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        for fn in ("leaves", "proba", "votes", "value"):
            for jf, tf_ in ((jp, tp_file), (jp_file, tp), (jg, tg)):
                _bits_equal(getattr(j_eval, fn)(jf, xj), getattr(t_eval, fn)(tf_, xt))
        _packed_equal(j_trees.pad_forest(jp, 700), t_trees.pad_forest(tp, 700))
        # K1: on finite rows against JAX's Pallas kernel. Its one-hot
        # selection product turns a row with any non-finite feature into NaN
        # at every node (0 * inf), a fault of the TPU kernel (ROADMAP queue
        # 3); such rows are held against JAX's gemm form on bf16 rows, the
        # function the kernel stands for.
        tpf = t_eval.for_kernel(tp_file, "pallas")
        got = t_pallas.predict_leaves_pallas(tpf, xt).numpy()
        fin = np.isfinite(x).all(axis=1)
        want = j_pallas.predict_leaves_pallas(j_eval.for_kernel(jp, "pallas").gf, xj[fin],
                                              interpret=True)
        _bits_equal(want, got[fin])
        x_bf16 = xj[~fin].astype(jnp.bfloat16).astype(jnp.float32)
        _bits_equal(j_gemm.predict_leaves_gemm(jg, x_bf16), got[~fin])
        heap = tpf.heap
        assert heap.depth == depth and heap is tpf.prepacked
        _bits_equal(t_pallas.predict_leaves_plain(tg, xt), t_pallas.walk_leaves_plain(heap, xt))
        if not y.any():  # a single-class fit: every heap leaf holds the root's value, 0
            assert not heap.val.any() and not t_eval.votes(tpf, xt).any()
        packed = tp if depth == 8 else packed
    # A tree deeper than the forest's max_depth has no heap of that depth.
    with pytest.raises(ValueError, match="deeper than its max_depth"):
        t_pallas.heap_from_packed(dataclasses.replace(packed, max_depth=1))


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _packed_equal(jp, tp):
    """A JAX ``PackedForest`` and the port's: the same five arrays, bit for
    bit, and the same depth."""
    for field in ("feature", "threshold", "left", "right", "value"):
        _bits_equal(getattr(jp, field), getattr(tp, field))
    assert jp.max_depth == tp.max_depth


def test_kernel_operands_reproduce_the_plain_version():
    """K5 reads the forest as K1's heap words padded to its tree tile, with
    the leaf payload beside them: walking those operands as the kernel does
    (``walk_transposed_plain``) must give the plain version's leaves for both
    payloads on rows with NaN, infinities and features on thresholds. K1, K2
    and K3 walk the heap form: K1's leaves, and K2's and K3's votes from the
    vote bits they pack, must give the plain versions' leaves, votes and
    per-tile candidates. A path matrix that is not a heap is refused by every
    walking kernel's packing (K5's before any operand is built, K6's at its
    launch)."""
    _, tf, rng = _forest(11, 5, seed=4)
    _, tf8, _ = _forest(5, 8, seed=5)
    for gf in (tf, tf8):
        x = _edge_rows(gf, rng)
        for leaf_f32 in (False, True):
            p = t_var._prep_transposed(gf, x, 256, 4, leaf_f32)
            assert p.nodes.dtype == torch.int64 and p.nodes.shape[0] % 4 == 0
            assert torch.equal(p.nodes[:gf.n_trees], t_pallas.heap_operands(gf).nodes)
            want = t_var.predict_leaves_transposed_plain(gf, x, leaf_f32)
            got = t_var.walk_transposed_plain(p)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), leaf_f32

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
    x = torch.zeros(3, 5)
    with pytest.raises(ValueError, match="host fit"):
        t_var._prep_transposed(swapped, x, 256, 4)
    with pytest.raises(ValueError, match="host fit"):
        t_var._launch_segmented(t_var._prep_segmented(swapped, x, 256, 8), 256, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        t_var._launch_transposed(t_var._prep_transposed(tf, x, 100, 4), 100, 4)


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
