"""End to end: the port's per-round AL loop against the JAX package's on the
same configuration (checkerboard2x2, 300-row pool, 8 trees of depth 4, device
fit, kernel "pallas", uncertainty, window 15, n_start 10, 3 rounds), with the
fused round on and off. Records, the reference-format log, every round's
picks, the final mask and the test-set probabilities (a mean over trees in
XLA's summation order) are identical. Also: the port runs in a fresh
interpreter without importing JAX or the JAX package (the bench, the
pipeline and the kernel-variant sweep included), and refuses what it does
not carry yet by name."""

import dataclasses
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from distributed_active_learning_tpu import config as j_config
from distributed_active_learning_tpu.data import get_dataset as j_get_dataset
from distributed_active_learning_tpu.ops import forest_eval as j_eval
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu.runtime import loop as j_loop
from distributed_active_learning_tpu.runtime import state as j_state
from distributed_active_learning_tpu.strategies import get_strategy as j_strategy
from distributed_active_learning_tpu_torch import config as t_config
from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.data import get_dataset as t_get_dataset
from distributed_active_learning_tpu_torch.ops import forest_eval as t_eval
from distributed_active_learning_tpu_torch.ops import trees_train as t_train
from distributed_active_learning_tpu_torch.runtime import loop as t_loop
from distributed_active_learning_tpu_torch.runtime import state as t_state
from distributed_active_learning_tpu_torch.strategies import get_strategy as t_strategy


def _cfgs(fused):
    j = j_config.ExperimentConfig(
        data=j_config.DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=j_config.ForestConfig(n_trees=8, max_depth=4, kernel="pallas", fit="device"),
        strategy=j_config.StrategyConfig(name="uncertainty", window_size=15),
        n_start=10, max_rounds=3, fused_round=fused,
    )
    # One asdict builds both packages' configs: the fields are the same.
    return j, t_config.from_dict(dataclasses.asdict(j))


def _drive_jax(cfg):
    b = j_get_dataset(cfg.data)
    st = j_state.set_start_state(
        j_state.init_pool_state(b.train_x, b.train_y, jax.random.key(cfg.seed)), cfg.n_start)
    binned = j_train.make_bins(jnp.asarray(b.train_x), cfg.forest.max_bins)
    window = cfg.strategy.window_size
    fit = j_loop.make_device_fit(cfg, binned.edges, cfg.n_start + cfg.max_rounds * window)
    round_fn = j_loop.make_round_fn(j_strategy(cfg.strategy), window, fused=cfg.fused_round)
    aux = j_loop.build_aux(cfg, st)
    fit_key = jax.random.key(cfg.seed + 0x5EED)
    picks = []
    for r in range(1, cfg.max_rounds + 1):
        forest = fit(binned.codes, st, jax.random.fold_in(fit_key, r))
        st, picked, _ = round_fn(forest, st, aux)
        picks.append(np.asarray(picked))
    proba = np.asarray(j_eval.proba(forest, jnp.asarray(b.test_x)))
    return picks, np.asarray(st.labeled_mask), proba


def _drive_port(cfg):
    b = t_get_dataset(cfg.data)
    st = t_state.set_start_state(
        t_state.init_pool_state(b.train_x, b.train_y, prng.key(cfg.seed), "cpu"), cfg.n_start)
    binned = t_train.make_bins(st.x, cfg.forest.max_bins)
    window = cfg.strategy.window_size
    fit = t_loop.make_device_fit(cfg, binned.edges, cfg.n_start + cfg.max_rounds * window)
    round_fn = t_loop.make_round_fn(t_strategy(cfg.strategy), window, fused=cfg.fused_round)
    aux = t_loop.build_aux(cfg, st)
    fit_key = prng.key(cfg.seed + 0x5EED)
    picks = []
    for r in range(1, cfg.max_rounds + 1):
        forest = fit(binned.codes, st, prng.fold_in(fit_key, r))
        st, picked, _ = round_fn(forest, st, aux)
        picks.append(picked.numpy())
    proba = t_eval.proba(forest, torch.from_numpy(b.test_x)).numpy()
    return picks, st.labeled_mask.numpy(), proba


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_run_experiment_matches_jax(fused):
    jcfg, tcfg = _cfgs(fused)
    want = j_loop.run_experiment(jcfg)
    got = t_loop.run_experiment(tcfg, device="cpu")
    key = lambda res: [(r.round, r.n_labeled, r.n_unlabeled, r.accuracy) for r in res.records]
    assert key(got) == key(want)
    assert [r.n_labeled for r in got.records] == [10, 25, 40]
    assert got.to_reference_log() == want.to_reference_log()

    j_picks, j_mask, j_proba = _drive_jax(jcfg)
    t_picks, t_mask, t_proba = _drive_port(tcfg)
    for a, b in zip(j_picks, t_picks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j_mask, t_mask)
    np.testing.assert_array_equal(got.final_labeled_mask.numpy(), j_mask)
    np.testing.assert_array_equal(t_proba, j_proba)


_ISOLATION = """
import sys
from distributed_active_learning_tpu_torch import bench, parallel, run
from distributed_active_learning_tpu_torch.benches import pallas_variants
from distributed_active_learning_tpu_torch.ops import ring_topk
from distributed_active_learning_tpu_torch.parallel import collectives, kernels, mesh
from distributed_active_learning_tpu_torch.runtime import pipeline
rc = run.main(["--device", "cpu", "--fit", "device", "--kernel", "pallas",
               "--fused-round", "--n-samples", "200", "--trees", "4",
               "--window", "5", "--rounds", "2", "--quiet"])
assert rc == 0
rc = run.main(["--device", "cpu", "--fit", "device", "--kernel", "pallas",
               "--mesh-data", "2", "--n-samples", "201", "--trees", "4",
               "--window", "5", "--rounds", "2", "--quiet"])
assert rc == 0
rc = run.main(["--device", "cpu", "--fit", "device", "--kernel", "pallas",
               "--rounds-per-launch", "3", "--pipeline-depth", "2", "--n-samples", "200",
               "--trees", "4", "--window", "5", "--rounds", "2", "--quiet"])
assert rc == 0
try:
    run.main(["--device", "cpu", "--fit", "host"])
except SystemExit as e:
    assert e.code == 2
else:
    raise AssertionError("--fit host was not refused")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "distributed_active_learning_tpu"))
assert not bad, bad
print("ISOLATED")
"""


def test_port_runs_without_jax_in_a_fresh_interpreter():
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATION], capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout
    assert out.stdout.count("Iteration") == 6
    assert "not ported yet" in out.stderr


def test_unported_features_are_refused_by_name():
    _, base = _cfgs(False)
    cases = [
        (dict(rounds_per_launch=4, mesh=t_config.MeshConfig(data=2)), "under a device mesh needs"),
        (dict(rounds_per_launch=4, checkpoint_dir="ckpt", checkpoint_every=1), "checkpoint slice"),
        (dict(forest=dataclasses.replace(base.forest, fit="host")), "scikit-learn"),
        (dict(mesh=t_config.MeshConfig(data=2),
              forest=dataclasses.replace(base.forest, kernel="gemm")), "under a device mesh"),
        (dict(forest=dataclasses.replace(base.forest, quantize="bf16")), "quantization"),
        (dict(forest=dataclasses.replace(base.forest, kernel="gather")), "gather-kernel"),
        (dict(checkpoint_dir="ckpt", checkpoint_every=1), "checkpoint slice"),
    ]
    for change, why in cases:
        with pytest.raises(NotImplementedError, match=why):
            t_loop.run_experiment(dataclasses.replace(base, **change), device="cpu")
    # The chunked driver itself is carried: 3 rounds in one launch of 4.
    chunked = t_loop.run_experiment(dataclasses.replace(base, rounds_per_launch=4), device="cpu")
    assert [r.n_labeled for r in chunked.records] == [10, 25, 40]
    with pytest.raises(ValueError, match="fused_round unavailable"):
        t_loop.run_experiment(
            dataclasses.replace(base, fused_round=True,
                                strategy=t_config.StrategyConfig(name="random")),
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_loop.run_experiment(base)
