"""Data, pool state and the device fit of the port against the JAX package:
bundles, bin edges and codes (also snapped to bf16 for quantized storage),
start masks, fitted forests and their gather form (depth 4 and 11), a
3-class fit's planes (a MultiForest) and quantized storage are
bit-identical on the same inputs (CPU, plain PyTorch)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from distributed_active_learning_tpu.config import DataConfig as JDataConfig
from distributed_active_learning_tpu.data import get_dataset as j_get_dataset
from distributed_active_learning_tpu.ops import forest_eval as j_eval
from distributed_active_learning_tpu.ops import trees as j_trees
from distributed_active_learning_tpu.ops import trees_multi as j_multi
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu.runtime import state as j_state
from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import DataConfig as TDataConfig
from distributed_active_learning_tpu_torch.data import get_dataset as t_get_dataset
from distributed_active_learning_tpu_torch.ops import forest_eval as t_eval
from distributed_active_learning_tpu_torch.ops import trees as t_trees
from distributed_active_learning_tpu_torch.ops import trees_multi as t_multi
from distributed_active_learning_tpu_torch.ops import trees_train as t_train
from distributed_active_learning_tpu_torch.runtime import state as t_state


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if b.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 against torch's bits
        b = b.view(np.int16)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_checkerboard2x2_bundle_bit_identical():
    for kw in ({}, {"n_samples": 300, "seed": 1}):
        a = j_get_dataset(JDataConfig(name="checkerboard2x2", **kw))
        b = t_get_dataset(TDataConfig(name="checkerboard2x2", **kw))
        for field in ("train_x", "train_y", "test_x", "test_y"):
            _bits_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("n,d", [(300, 2), (1000, 5)])
def test_make_bins_edges_and_codes_bit_identical(n, d):
    x = np.random.default_rng(n + d).normal(size=(n, d)).astype(np.float32)
    for quantize in ("none", "int8"):  # int8 storage snaps the edges onto bf16
        bj = j_train.make_bins(jnp.asarray(x), 32, quantize=quantize)
        bt = t_train.make_bins(torch.from_numpy(x), 32, quantize=quantize)
        _bits_equal(bj.edges, bt.edges.numpy())
        _bits_equal(bj.codes, bt.codes.numpy())
    snapped = bt.edges.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(snapped, bt.edges)


def _bf16_bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_set_start_state_masks_identical():
    b = t_get_dataset(TDataConfig(name="checkerboard2x2", n_samples=300, seed=1))
    for seed, n_start in ((0, 10), (3, 57)):
        sj = j_state.set_start_state(
            j_state.init_pool_state(b.train_x, b.train_y, jax.random.key(seed)), n_start)
        st = t_state.set_start_state(
            t_state.init_pool_state(b.train_x, b.train_y, prng.key(seed), "cpu"), n_start)
        np.testing.assert_array_equal(np.asarray(sj.labeled_mask), st.labeled_mask.numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(sj.key)).astype(np.int64), st.key.numpy())
        assert int(st.labeled_mask.sum()) == n_start


@pytest.mark.parametrize("n_trees", [10, 20])  # 20: not a multiple of tree_chunk=16
def test_fit_forest_device_bit_identical(n_trees):
    """The fit's heap arrays, then the fit's gather form
    (``heap_packed_forest``) and its leaves, proba, votes and value on rows
    with NaN and infinities, and ``pad_forest``. The 20-tree case fits deep
    (depth 11, past the path-matrix form's limit of 10), where the loop
    evaluates the gather form."""
    depth = 11 if n_trees == 20 else 4
    rng = np.random.default_rng(n_trees)
    x = rng.normal(size=(400, 6)).astype(np.float32)
    y = (x[:, 0] + 0.3 * x[:, 1] > 0).astype(np.int32)
    mask = rng.random(400) < 0.5
    bj = j_train.make_bins(jnp.asarray(x), 32)
    bt = t_train.make_bins(torch.from_numpy(x), 32)
    cj, yj, wj = j_train.gather_fit_window(bj.codes, jnp.asarray(y), jnp.asarray(mask), 300)
    ct, yt, wt = t_train.gather_fit_window(
        bt.codes, torch.from_numpy(y), torch.from_numpy(mask), 300)
    _bits_equal(cj, ct.numpy())
    _bits_equal(wj, wt.numpy())
    fj = j_train.fit_forest_device(
        cj, yj, wj, bj.edges, jax.random.key(5), n_trees=n_trees, max_depth=depth)
    ft = t_train.fit_forest_device(
        ct, yt, wt, bt.edges, prng.key(5), n_trees=n_trees, max_depth=depth)
    for a, b in zip(fj, ft):  # (feature, threshold, value)
        _bits_equal(a, b.numpy())

    pj = j_train.heap_packed_forest(*fj, depth)
    pt = t_train.heap_packed_forest(*ft, depth)
    xe = rng.normal(size=(500, 6)).astype(np.float32)
    xe[:3] = np.array([np.nan, np.inf, -np.inf], dtype=np.float32)[:, None]
    xe[3:300:3, rng.integers(6)] = np.nan
    xe[4:300:3, rng.integers(6)] = np.inf
    xe[5:300:3, rng.integers(6)] = -np.inf
    for padded in (False, True):
        if padded:
            pj, pt = j_trees.pad_forest(pj, pj.n_nodes + 7), t_trees.pad_forest(pt, pt.n_nodes + 7)
        for field in ("feature", "threshold", "left", "right", "value"):
            _bits_equal(getattr(pj, field), getattr(pt, field).numpy())
        assert pj.max_depth == pt.max_depth == depth
        for fn in ("leaves", "proba", "votes", "value"):
            _bits_equal(getattr(j_eval, fn)(pj, jnp.asarray(xe)),
                        getattr(t_eval, fn)(pt, torch.from_numpy(xe)).numpy())

    # A 3-class fit: the value planes of a MultiForest (one a class, in the
    # gather and path-matrix forms), their class probabilities and predicted
    # classes; then quantized storage of the path-matrix forms (bf16
    # thresholds, int8 and bf16 leaves; thresholds fitted on bf16-snapped
    # edges), its leaves in the gemm form widened where they are read.
    if depth != 4:
        return
    y3 = np.digitize(x[:, 0] + 0.3 * x[:, 1], [-0.5, 0.5]).astype(np.int32)
    bj = j_train.make_bins(jnp.asarray(x), 32, quantize="int8")
    bt = t_train.make_bins(torch.from_numpy(x), 32, quantize="int8")
    cj, yj, wj = j_train.gather_fit_window(bj.codes, jnp.asarray(y3), jnp.asarray(mask), 300)
    ct, yt, wt = t_train.gather_fit_window(
        bt.codes, torch.from_numpy(y3), torch.from_numpy(mask), 300)
    fj = j_train.fit_forest_device(cj, yj, wj, bj.edges, jax.random.key(6), n_trees=n_trees,
                                   max_depth=depth, n_classes=3)
    ft = t_train.fit_forest_device(ct, yt, wt, bt.edges, prng.key(6), n_trees=n_trees,
                                   max_depth=depth, n_classes=3)
    for a, b in zip(fj, ft):
        _bits_equal(a, b.numpy())
    xj, xt = jnp.asarray(xe[300:]), torch.from_numpy(xe[300:])
    for build in ("heap_packed_forest", "heap_gemm_forest"):
        mj = getattr(j_train, build)(*fj, depth)
        mt = getattr(t_train, build)(*ft, depth)
        assert isinstance(mt, t_multi.MultiForest) and mt.n_classes == 3
        for pj_, pt_ in zip(mj.planes, mt.planes):
            _bits_equal(getattr(j_eval, "leaves")(pj_, xj), t_eval.leaves(pt_, xt).numpy())
        _bits_equal(j_multi.proba_multi(mj, xj), t_multi.proba_multi(mt, xt).numpy())
        _bits_equal(j_multi.predict_class(mj, xj), t_multi.predict_class(mt, xt).numpy())
        if build == "heap_packed_forest":
            continue
        for mode in ("int8", "bf16"):
            qj = j_train.quantize_forest(mj, mode)
            qt = t_train.quantize_forest(mt, mode)
            for pj_, pt_ in zip(qj.planes, qt.planes):
                _bits_equal(pj_.thresholds, _bf16_bits(pt_.thresholds))
                _bits_equal(pj_.value, _bf16_bits(pt_.value))
                _bits_equal(j_eval.leaves(pj_, xj), t_eval.leaves(pt_, xt).numpy())
            _bits_equal(j_multi.proba_multi(qj, xj), t_multi.proba_multi(qt, xt).numpy())
    with pytest.raises(ValueError, match="path-matrix"):
        t_train.quantize_forest(t_train.heap_packed_forest(*ft, depth).planes[0], "int8")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        t_train.quantize_forest(mt, "fp4")
