"""The port's chunked driver against its own per-round driver and the JAX
package's chunked driver, on the CPU: checkerboard2x2 (300 rows), 8 trees of
depth 4, device fit, kernel "pallas", uncertainty, window 15, n_start 10,
3 rounds per launch. Records and the reference log are bit-equal across all
three, the final mask across the port's two drivers (the JAX result does not
carry one), fused and unfused, at pipeline depth 1 and 2, with ``max_rounds``
not a multiple of the chunk and with a ``label_budget`` that stops inside a
chunk. Also the raw chunk program: its stacked ys and its carried-out state
(picked, active, mask, key data, round) equal the JAX chunk's."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from distributed_active_learning_tpu import config as j_config
from distributed_active_learning_tpu.data import get_dataset as j_get_dataset
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu.runtime import loop as j_loop
from distributed_active_learning_tpu.runtime import state as j_state
from distributed_active_learning_tpu.strategies import StrategyAux as JAux
from distributed_active_learning_tpu.strategies import get_strategy as j_strategy
from distributed_active_learning_tpu_torch import config as t_config
from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.data import get_dataset as t_get_dataset
from distributed_active_learning_tpu_torch.ops import trees_train as t_train
from distributed_active_learning_tpu_torch.runtime import loop as t_loop
from distributed_active_learning_tpu_torch.runtime import state as t_state
from distributed_active_learning_tpu_torch.strategies import StrategyAux as TAux
from distributed_active_learning_tpu_torch.strategies import get_strategy as t_strategy

K = 3


def _cfgs(fused, **kw):
    j = j_config.ExperimentConfig(
        data=j_config.DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=j_config.ForestConfig(n_trees=8, max_depth=4, kernel="pallas", fit="device"),
        strategy=j_config.StrategyConfig(name="uncertainty", window_size=15),
        n_start=10, fused_round=fused, **kw,
    )
    return j, t_config.from_dict(dataclasses.asdict(j))


def _key(res):
    return [(r.round, r.n_labeled, r.n_unlabeled, r.accuracy) for r in res.records]


def _raw_chunk_parity(fused):
    """One chunk of K rounds with the round quota ending inside it
    (end_round = 2): ys and carry against the JAX chunk program's."""
    jcfg, tcfg = _cfgs(fused, max_rounds=5)
    window, budget = 15, 10 + (K + 1) * 15

    b = j_get_dataset(jcfg.data)
    js = j_state.set_start_state(
        j_state.init_pool_state(b.train_x, b.train_y, jax.random.key(0)), jcfg.n_start)
    jb = j_train.make_bins(jnp.asarray(js.x), jcfg.forest.max_bins)
    j_chunk = j_loop.make_chunk_fn(
        j_strategy(jcfg.strategy), window, K, j_loop.make_device_fit(jcfg, jb.edges, budget),
        label_cap=js.n_valid, donate=False, fused_round=fused)
    j_out, j_extras, j_ys = j_chunk(
        jb.codes, js, JAux(seed_mask=js.labeled_mask), jax.random.key(0x5EED),
        jnp.asarray(b.test_x), jnp.asarray(b.test_y), jnp.int32(2))

    tb = t_get_dataset(tcfg.data)
    ts = t_state.set_start_state(
        t_state.init_pool_state(tb.train_x, tb.train_y, prng.key(0), "cpu"), tcfg.n_start)
    tbins = t_train.make_bins(ts.x, tcfg.forest.max_bins)
    t_chunk = t_loop.make_chunk_fn(
        t_strategy(tcfg.strategy), window, K, t_loop.make_device_fit(tcfg, tbins.edges, budget),
        label_cap=ts.n_valid, fused_round=fused)
    t_out, t_extras, t_ys = t_chunk(
        tbins.codes, t_state.as_carry(ts), TAux(seed_mask=ts.labeled_mask.clone()),
        prng.key(0x5EED), torch.from_numpy(tb.test_x), torch.from_numpy(tb.test_y),
        torch.tensor(2, dtype=torch.int32))

    names = ("rounds", "n_labeled", "accuracy", "picked", "active")
    for name, jy, ty in zip(names, j_ys, t_ys):
        jy, ty = np.asarray(jy), ty.numpy()
        assert jy.shape == ty.shape, name
        np.testing.assert_array_equal(jy.view(np.int32) if jy.dtype == np.float32 else jy,
                                      ty.view(np.int32) if ty.dtype == np.float32 else ty, name)
    assert t_ys[4].tolist() == [True, True, False]
    assert int(t_extras.n_active) == int(j_extras.n_active) == 2
    assert int(t_extras.n_labeled_after) == int(j_extras.n_labeled_after) == 40
    np.testing.assert_array_equal(np.asarray(j_out.labeled_mask), t_out.labeled_mask.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(j_out.key)).astype(np.int64), t_out.key.numpy())
    assert int(j_out.round) == int(t_out.round) == 2


def test_chunked_matches_jax():
    cases = {
        "max_rounds 5 (not a multiple of 3)": dict(max_rounds=5),
        "label_budget 70 (stops inside the second chunk)": dict(label_budget=70),
    }
    for fused in (False, True):
        for what, kw in cases.items():
            jcfg, tcfg = _cfgs(fused, **kw)
            per_round = t_loop.run_experiment(tcfg, device="cpu")
            assert per_round.pipeline_stats is None
            want_labeled = [10, 25, 40, 55, 70][: len(per_round.records)]
            assert [r.n_labeled for r in per_round.records] == want_labeled, what
            for depth in (1, 2):
                got = t_loop.run_experiment(
                    dataclasses.replace(tcfg, rounds_per_launch=K, pipeline_depth=depth),
                    device="cpu")
                assert _key(got) == _key(per_round), (fused, what, depth)
                assert got.to_reference_log() == per_round.to_reference_log()
                assert torch.equal(got.final_labeled_mask, per_round.final_labeled_mask)
                assert got.pipeline_stats.chunks >= 2
                if depth == 1:
                    assert got.pipeline_stats.touchdown_hidden_fraction == 0.0
            # The JAX chunked driver on the same configuration (the budget
            # case once: it compiles a program per call).
            if fused and "budget" in what:
                continue
            want = j_loop.run_experiment(dataclasses.replace(jcfg, rounds_per_launch=K))
            assert _key(got) == _key(want), (fused, what)
            assert got.to_reference_log() == want.to_reference_log()
        _raw_chunk_parity(fused)
