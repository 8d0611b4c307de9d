"""End to end: the port's per-round AL loop against the JAX package's on the
same configuration (checkerboard2x2, 300-row pool, 8 trees of depth 4, device
fit, kernel "pallas", uncertainty, window 15, n_start 10, 3 rounds), with the
fused round on and off; unfused also with the host (scikit-learn) fit under
kernels gemm, pallas and gather, a depth-11 device fit (the gather form) and
the density strategy. Records, the reference-format log, every round's
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
from distributed_active_learning_tpu.models import forest as j_forest
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


def _cfgs(fused, strategy="uncertainty", options=None, **forest):
    forest = {"n_trees": 8, "max_depth": 4, "kernel": "pallas", "fit": "device", **forest}
    j = j_config.ExperimentConfig(
        data=j_config.DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=j_config.ForestConfig(**forest),
        strategy=j_config.StrategyConfig(name=strategy, window_size=15, options=options or {}),
        n_start=10, max_rounds=3, fused_round=fused,
    )
    # One asdict builds both packages' configs: the fields are the same.
    return j, t_config.from_dict(dataclasses.asdict(j))


# Configurations the unfused case also holds against the JAX package: the
# host (scikit-learn) fit under each kernel, a deep device fit in the gather
# form, and the density strategy.
_UNFUSED_ONLY = {
    "host fit, gemm": dict(fit="host", kernel="gemm"),
    "host fit, pallas": dict(fit="host", kernel="pallas"),
    "host fit, gather": dict(fit="host", kernel="gather"),
    "device fit, depth 11 (gather form)": dict(max_depth=11),
    "density, pallas": dict(strategy="density"),
    "density, mass over the non-seed rows, host fit": dict(
        strategy="density", options={"mass_over": "non_seed"}, fit="host"),
}


def _drive_jax(cfg):
    b = j_get_dataset(cfg.data)
    st = j_state.set_start_state(
        j_state.init_pool_state(b.train_x, b.train_y, jax.random.key(cfg.seed)), cfg.n_start)
    window = cfg.strategy.window_size
    if cfg.forest.fit == "host":
        def fit(st, r):
            lx, ly = j_loop._labeled_subset(st, b.train_x, b.train_y)
            packed = j_forest.fit_forest_classifier(lx, ly, cfg.forest, seed=cfg.seed + r)
            return j_eval.for_kernel(packed, cfg.forest.kernel)
    else:
        binned = j_train.make_bins(jnp.asarray(b.train_x), cfg.forest.max_bins)
        device_fit = j_loop.make_device_fit(
            cfg, binned.edges, cfg.n_start + cfg.max_rounds * window)
        fit_key = jax.random.key(cfg.seed + 0x5EED)

        def fit(st, r):
            return device_fit(binned.codes, st, jax.random.fold_in(fit_key, r))
    round_fn = j_loop.make_round_fn(j_strategy(cfg.strategy), window, fused=cfg.fused_round)
    aux = j_loop.build_aux(cfg, st)
    picks = []
    for r in range(1, cfg.max_rounds + 1):
        forest = fit(st, r)
        st, picked, _ = round_fn(forest, st, aux)
        picks.append(np.asarray(picked))
    proba = np.asarray(j_eval.proba(forest, jnp.asarray(b.test_x)))
    return picks, np.asarray(st.labeled_mask), proba


def _drive_port(cfg):
    b = t_get_dataset(cfg.data)
    st = t_state.set_start_state(
        t_state.init_pool_state(b.train_x, b.train_y, prng.key(cfg.seed), "cpu"), cfg.n_start)
    window = cfg.strategy.window_size
    if cfg.forest.fit == "host":
        fit = t_loop.make_host_fit(cfg, b.train_x, b.train_y, 2, "cpu")
    else:
        binned = t_train.make_bins(st.x, cfg.forest.max_bins)
        device_fit = t_loop.make_device_fit(
            cfg, binned.edges, cfg.n_start + cfg.max_rounds * window)
        fit_key = prng.key(cfg.seed + 0x5EED)

        def fit(st, r):
            return device_fit(binned.codes, st, prng.fold_in(fit_key, r))
    round_fn = t_loop.make_round_fn(t_strategy(cfg.strategy), window, fused=cfg.fused_round)
    aux = t_loop.build_aux(cfg, st)
    picks = []
    for r in range(1, cfg.max_rounds + 1):
        forest = fit(st, r)
        st, picked, _ = round_fn(forest, st, aux)
        picks.append(picked.numpy())
    proba = t_eval.proba(forest, torch.from_numpy(b.test_x)).numpy()
    return picks, st.labeled_mask.numpy(), proba


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_run_experiment_matches_jax(fused):
    cases = {"device fit, pallas": {}, **({} if fused else _UNFUSED_ONLY)}
    for what, change in cases.items():
        jcfg, tcfg = _cfgs(fused, **change)
        want = j_loop.run_experiment(jcfg)
        got = t_loop.run_experiment(tcfg, device="cpu")
        key = lambda res: [(r.round, r.n_labeled, r.n_unlabeled, r.accuracy) for r in res.records]
        assert key(got) == key(want), what
        assert [r.n_labeled for r in got.records] == [10, 25, 40]
        assert got.to_reference_log() == want.to_reference_log()

        j_picks, j_mask, j_proba = _drive_jax(jcfg)
        t_picks, t_mask, t_proba = _drive_port(tcfg)
        for a, b in zip(j_picks, t_picks):
            np.testing.assert_array_equal(a, b, what)
        np.testing.assert_array_equal(j_mask, t_mask, what)
        np.testing.assert_array_equal(got.final_labeled_mask.numpy(), j_mask, what)
        np.testing.assert_array_equal(t_proba, j_proba, what)


_ISOLATION = """
import sys
from distributed_active_learning_tpu_torch import bench, parallel, run
from distributed_active_learning_tpu_torch.benches import pallas_variants
from distributed_active_learning_tpu_torch.models import forest_io
from distributed_active_learning_tpu_torch.ops import ring_topk
from distributed_active_learning_tpu_torch.parallel import collectives, kernels, mesh
from distributed_active_learning_tpu_torch.runtime import pipeline
small = ["--device", "cpu", "--n-samples", "200", "--trees", "4", "--window", "5",
         "--rounds", "2", "--quiet"]
for extra in (["--fit", "device", "--kernel", "pallas", "--fused-round"],
              ["--fit", "device", "--kernel", "pallas", "--mesh-data", "2", "--n-samples", "201"],
              ["--fit", "device", "--kernel", "pallas", "--rounds-per-launch", "3",
               "--pipeline-depth", "2"],
              ["--fit", "host", "--kernel", "pallas"],
              ["--fit", "device", "--kernel", "gather", "--depth", "11"],
              ["--fit", "device", "--kernel", "pallas", "--strategy", "density"]):
    assert run.main(small + extra) == 0, extra
assert "sklearn" in sys.modules  # the host fit ran
try:
    run.main(small + ["--fit", "host", "--kernel", "pallas", "--mesh-data", "2"])
except NotImplementedError as e:
    print("REFUSED", e)
else:
    raise AssertionError("the host fit under a mesh was not refused")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "distributed_active_learning_tpu"))
assert not bad, bad
print("ISOLATED")
"""


def test_port_runs_without_jax_in_a_fresh_interpreter():
    """The CLI's paths (fused, mesh, chunked, host fit, deep gather form,
    density) run in a fresh interpreter, and neither the port nor
    scikit-learn pulls in JAX or the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATION], capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout
    assert out.stdout.count("Iteration") == 12
    assert "REFUSED" in out.stdout and "mesh-and-pod slice" in out.stdout


def test_unported_features_are_refused_by_name():
    _, base = _cfgs(False)
    mesh = t_config.MeshConfig(data=2)
    cases = [
        (dict(rounds_per_launch=4, mesh=mesh), "under a device mesh needs"),
        (dict(rounds_per_launch=4, checkpoint_dir="ckpt", checkpoint_every=1), "checkpoint slice"),
        (dict(mesh=mesh, forest=dataclasses.replace(base.forest, kernel="gemm")),
         "under a device mesh"),
        (dict(forest=dataclasses.replace(base.forest, quantize="bf16")), "quantization"),
        (dict(checkpoint_dir="ckpt", checkpoint_every=1), "checkpoint slice"),
        # The mesh halves of the gather form, the host fit and density.
        (dict(mesh=mesh, forest=dataclasses.replace(base.forest, kernel="gather")),
         "gather form .* mesh-and-pod slice"),
        (dict(mesh=mesh, forest=dataclasses.replace(base.forest, max_depth=12)),
         "gather form .* mesh-and-pod slice"),
        (dict(mesh=mesh, forest=dataclasses.replace(base.forest, fit="host")),
         "host fit under a device mesh .* mesh-and-pod slice"),
        (dict(mesh=mesh, strategy=t_config.StrategyConfig(name="density", window_size=15)),
         "density strategy under a device mesh .* mesh-and-pod slice"),
    ]
    for change, why in cases:
        with pytest.raises(NotImplementedError, match=why):
            t_loop.run_experiment(dataclasses.replace(base, **change), device="cpu")
    # The chunked driver itself is carried: 3 rounds in one launch of 4.
    chunked = t_loop.run_experiment(dataclasses.replace(base, rounds_per_launch=4), device="cpu")
    assert [r.n_labeled for r in chunked.records] == [10, 25, 40]
    # The host fit takes the per-round driver whatever rounds_per_launch says.
    host = dataclasses.replace(base, forest=dataclasses.replace(base.forest, fit="host"))
    per_round = t_loop.run_experiment(host, device="cpu")
    chunked = t_loop.run_experiment(dataclasses.replace(host, rounds_per_launch=4), device="cpu")
    assert chunked.pipeline_stats is None
    assert chunked.to_reference_log() == per_round.to_reference_log()
    assert torch.equal(chunked.final_labeled_mask, per_round.final_labeled_mask)
    # Without scikit-learn the host fit fails by name, before any set-up.
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "sklearn", None)
        with pytest.raises(ImportError, match="needs scikit-learn"):
            t_loop.run_experiment(host, device="cpu")
    for change in (dict(fused_round=True, strategy=t_config.StrategyConfig(name="random")),
                   dict(fused_round=True, forest=host.forest),
                   dict(fused_round=True, forest=dataclasses.replace(base.forest, kernel="gather")),
                   dict(fused_round=True, strategy=t_config.StrategyConfig(name="density"))):
        with pytest.raises(ValueError, match="fused_round unavailable"):
            t_loop.run_experiment(dataclasses.replace(base, **change), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_loop.run_experiment(base)
