"""Data, pool state and the device fit of the port against the JAX package:
bundles, bin edges and codes, start masks and fitted forests are
bit-identical on the same inputs (CPU, plain PyTorch)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from distributed_active_learning_tpu.config import DataConfig as JDataConfig
from distributed_active_learning_tpu.data import get_dataset as j_get_dataset
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu.runtime import state as j_state
from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import DataConfig as TDataConfig
from distributed_active_learning_tpu_torch.data import get_dataset as t_get_dataset
from distributed_active_learning_tpu_torch.ops import trees_train as t_train
from distributed_active_learning_tpu_torch.runtime import state as t_state


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
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
    bj = j_train.make_bins(jnp.asarray(x), 32)
    bt = t_train.make_bins(torch.from_numpy(x), 32)
    _bits_equal(bj.edges, bt.edges.numpy())
    _bits_equal(bj.codes, bt.codes.numpy())


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
        cj, yj, wj, bj.edges, jax.random.key(5), n_trees=n_trees, max_depth=4)
    ft = t_train.fit_forest_device(
        ct, yt, wt, bt.edges, prng.key(5), n_trees=n_trees, max_depth=4)
    for a, b in zip(fj, ft):  # (feature, threshold, value)
        _bits_equal(a, b.numpy())
