"""The port's threefry (distributed_active_learning_tpu_torch/prng.py) against
jax.random in partitionable mode: split, fold_in, raw bits and uniform must be
bit-identical, since every pick and bootstrap weight of the AL loop derives
from them."""

import numpy as np
import jax
import torch

import distributed_active_learning_tpu  # noqa: F401  (pins partitionable threefry)
from distributed_active_learning_tpu_torch import prng


def test_prng_bits_split_fold_in_uniform_match_jax():
    for seed in (0, 1, 7, 0x5EED + 3, 2**31 + 5):
        kj, kt = jax.random.key(seed), prng.key(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(kj)).astype(np.int64), kt.numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jax.random.split(kj, 5))), prng.split(kt, 5).numpy())
        for data in (0, 1, 17, 2**32 - 1):
            np.testing.assert_array_equal(
                np.asarray(jax.random.key_data(jax.random.fold_in(kj, data))),
                prng.fold_in(kt, data).numpy())
        for shape in ((1,), (5,), (3, 7), (16, 4, 3), (1001,)):
            np.testing.assert_array_equal(
                np.asarray(jax.random.bits(kj, shape)).astype(np.int64),
                prng.random_bits(kt, shape).numpy())
            uj = np.asarray(jax.random.uniform(kj, shape))
            ut = prng.uniform(kt, shape).numpy()
            np.testing.assert_array_equal(uj.view(np.int32), ut.view(np.int32))
    # A batch of keys draws what each key draws alone (the fit's chunk batch).
    keys_j = jax.random.split(jax.random.key(3), 4)
    batched = prng.uniform(prng.split(prng.key(3), 4), (2, 3)).numpy()
    for i, k in enumerate(keys_j):
        np.testing.assert_array_equal(np.asarray(jax.random.uniform(k, (2, 3))), batched[i])
    assert prng.uniform(prng.key(0), (4,)).dtype == torch.float32
