"""End to end: the port's per-round AL loop against the JAX package's on the
same configuration (checkerboard2x2, 300-row pool, 8 trees of depth 4, device
fit, kernel "pallas", uncertainty, window 15, n_start 10, 3 rounds), with the
fused round on and off, each also with int8 and bf16 forest storage; unfused
also with the host (scikit-learn) fit under kernels gemm, pallas and gather,
a depth-11 device fit (the gather form), the density strategy, a 4-class
pool (device and host fit) and the lal strategy (a regressor fitted from the
committed reference-format fixture, and one read from a forest file). Records, the reference-format log, every round's
picks, the final mask and the test-set probabilities (a mean over trees in
XLA's summation order) are identical. Unfused, the RoundMetrics of every
round equal the JAX package's field by field (bit-equal), the MetricsWriter
JSONL has the JAX writer's event kinds and keys, and a checkpointed run
resumes to the uninterrupted run's records, metrics and final mask. Each
scenario family of the JAX package's scenario tests (and the rotation
drift) runs per round with metrics equal to the JAX package's run, and the
fused round refuses a scenario with JAX's reason. Also:
the port runs in a fresh interpreter without importing JAX or the JAX
package (the bench, the pipeline, telemetry, checkpoints, the ops plane and
the kernel-variant sweep included; its metrics JSONL renders through
``benches/summarize_metrics.py``), its ops-plane registry renders the JAX
registry's Prometheus text, and it refuses what it does not carry yet by
name (a mesh whose ranks' cells cross a data row partway, naming item 8
of the mesh slice), and refuses what the JAX
package refuses of scenarios with its messages (under a mesh, every kind
but the noisy oracle, and a grid's scenario axis)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from distributed_active_learning_tpu import config as j_config
from distributed_active_learning_tpu.data import get_dataset as j_get_dataset
from distributed_active_learning_tpu.data.datasets import DataBundle as JBundle
from distributed_active_learning_tpu.models import forest as j_forest
from distributed_active_learning_tpu.ops import forest_eval as j_eval
from distributed_active_learning_tpu.ops import trees_multi as j_multi
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu.runtime import loop as j_loop
from distributed_active_learning_tpu.runtime import obs as j_obs
from distributed_active_learning_tpu.runtime import state as j_state
from distributed_active_learning_tpu.runtime import telemetry as j_telemetry
from distributed_active_learning_tpu.strategies import get_strategy as j_strategy
from distributed_active_learning_tpu_torch import config as t_config
from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.data import get_dataset as t_get_dataset
from distributed_active_learning_tpu_torch.data.datasets import DataBundle as TBundle
from distributed_active_learning_tpu_torch.ops import forest_eval as t_eval
from distributed_active_learning_tpu_torch.ops import trees_multi as t_multi
from distributed_active_learning_tpu_torch.ops import trees_train as t_train
from distributed_active_learning_tpu_torch.runtime import loop as t_loop
from distributed_active_learning_tpu_torch.runtime import obs as t_obs
from distributed_active_learning_tpu_torch.runtime import state as t_state
from distributed_active_learning_tpu_torch.runtime import telemetry as t_telemetry
from distributed_active_learning_tpu_torch.strategies import get_strategy as t_strategy
from tests.torch_threads import capped_torch_threads  # noqa: F401  (autouse)


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


def _four_classes(seed=3, n=300, m=128):
    """A 4-class pool made with numpy: classes by quartile of x0 + 0.3 x1."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n + m, 4)).astype(np.float32)
    s = x[:, 0] + 0.3 * x[:, 1]
    y = np.digitize(s, np.quantile(s, [0.25, 0.5, 0.75])).astype(np.int32)
    return x[:n], y[:n], x[n:], y[n:]


_FOUR = _four_classes()
_LAL_OPTIONS = {"lal_data_path": os.path.join(os.path.dirname(__file__), "fixtures",
                                              "lal_simulatedunbalanced_big.txt"),
                "lal_trees": 12, "lal_depth": 6}

# Configurations both cases hold against the JAX package: quantized storage.
_QUANTIZED = {"int8 storage": dict(quantize="int8"), "bf16 storage": dict(quantize="bf16")}

# Configurations the unfused case also holds against the JAX package: the
# host (scikit-learn) fit under each kernel, a deep device fit in the gather
# form, the density strategy, a 4-class pool (``bundle``) and lal.
_UNFUSED_ONLY = {
    "host fit, gemm": dict(fit="host", kernel="gemm"),
    "host fit, pallas": dict(fit="host", kernel="pallas"),
    "host fit, gather": dict(fit="host", kernel="gather"),
    "device fit, depth 11 (gather form)": dict(max_depth=11),
    "density, pallas": dict(strategy="density"),
    "density, mass over the non-seed rows, host fit": dict(
        strategy="density", options={"mass_over": "non_seed"}, fit="host"),
    "4 classes, device fit": dict(bundle=_FOUR),
    "4 classes, host fit, entropy": dict(bundle=_FOUR, fit="host", strategy="entropy"),
    "lal, regressor fitted from the fixture": dict(strategy="lal", options=_LAL_OPTIONS),
}


# The JAX package's scenario families and their configuration
# (tests/test_scenarios.py: SCENARIOS, _cfg).
_SCENARIOS = [
    j_config.ScenarioConfig(),
    j_config.ScenarioConfig(kind="noisy_oracle", flip_prob=0.2, abstain_prob=0.3),
    j_config.ScenarioConfig(kind="rare_event", rare_class=1),
    j_config.ScenarioConfig(kind="drift", drift_rate=0.3),
    j_config.ScenarioConfig(kind="cost_budget", cost_budget=6.0),
]


def _scenario_cfg(scenario, **kw):
    return j_config.ExperimentConfig(
        data=j_config.DataConfig(name="checkerboard2x2", n_samples=96, seed=2),
        forest=j_config.ForestConfig(n_trees=4, max_depth=3, fit="device", fit_budget=96),
        strategy=j_config.StrategyConfig(name=kw.pop("strategy", "entropy"), window_size=8),
        n_start=8, max_rounds=3, log_every=0, scenario=scenario, **kw)


def _n_classes(y):
    return max(int(y.max()) + 1, 2)


def _jax_proba(forest, x):
    if j_multi.is_multi(forest):
        return np.asarray(j_multi.proba_multi(forest, x))
    return np.asarray(j_eval.proba(forest, x))


def _drive_jax(cfg, bundle=None):
    b = JBundle(*bundle) if bundle else j_get_dataset(cfg.data)
    C = _n_classes(b.train_y)
    st = j_state.set_start_state(
        j_state.init_pool_state(b.train_x, b.train_y, jax.random.key(cfg.seed)), cfg.n_start,
        n_classes=C)
    window = cfg.strategy.window_size
    if cfg.forest.fit == "host":
        def fit(st, r):
            lx, ly = j_loop._labeled_subset(st, b.train_x, b.train_y)
            packed = j_forest.fit_forest_classifier(lx, ly, cfg.forest, seed=cfg.seed + r,
                                                    n_classes=C)
            return j_eval.for_kernel(packed, cfg.forest.kernel)
    else:
        binned = j_train.make_bins(jnp.asarray(b.train_x), cfg.forest.max_bins,
                                   quantize=cfg.forest.quantize)
        device_fit = j_loop.make_device_fit(
            cfg, binned.edges, cfg.n_start + cfg.max_rounds * window, n_classes=C)
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
    return picks, np.asarray(st.labeled_mask), _jax_proba(forest, jnp.asarray(b.test_x))


def _drive_port(cfg, bundle=None):
    b = TBundle(*bundle) if bundle else t_get_dataset(cfg.data)
    C = _n_classes(b.train_y)
    st = t_state.set_start_state(
        t_state.init_pool_state(b.train_x, b.train_y, prng.key(cfg.seed), "cpu"), cfg.n_start,
        n_classes=C)
    window = cfg.strategy.window_size
    if cfg.forest.fit == "host":
        fit = t_loop.make_host_fit(cfg, b.train_x, b.train_y, C, "cpu")
    else:
        binned = t_train.make_bins(st.x, cfg.forest.max_bins, quantize=cfg.forest.quantize)
        device_fit = t_loop.make_device_fit(
            cfg, binned.edges, cfg.n_start + cfg.max_rounds * window, n_classes=C)
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
    test_x = torch.from_numpy(b.test_x)
    # A forest evaluated once (the metrics path's; a multiclass forest plane
    # by plane) gives the same bits, and refuses any other input than its
    # own instead of evaluating again.
    ev = t_eval.evaluated(forest, test_x)
    if t_multi.is_multi(forest):
        proba = t_multi.proba_multi(forest, test_x).numpy()
        np.testing.assert_array_equal(t_multi.proba_multi(ev, test_x).numpy(), proba)
        with pytest.raises(TypeError, match="trees_multi"):
            t_eval.proba(forest, test_x)
        ev = ev.planes[0]
    else:
        proba = t_eval.proba(forest, test_x).numpy()
        np.testing.assert_array_equal(t_eval.proba(ev, test_x).numpy(), proba)
    with pytest.raises(ValueError, match="another"):
        t_eval.votes(ev, test_x.clone())
    return picks, st.labeled_mask.numpy(), proba


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _metrics_match_jax(tmp_path):
    """RoundMetrics, per round, against the JAX package's: bit-equal in
    every field (score_mean included: its sum takes XLA's reduce order
    through ``xla_f32.row_sum``) but pool_entropy, which the port computes
    with the native log2 and holds to ``telemetry.POOL_ENTROPY_RTOL`` of
    JAX's value. Lower- and higher-is-better
    strategies, the host fit, a window of 40 picks (a sum past 32
    terms) and a 4-class pool. The density score itself is the JAX package's only to
    ``similarity.MASS_RTOL`` of the largest |mass| (its picks are equal), so
    under density the four score fields are held to twice that of the
    largest |score| (a margin is a difference of two scores); the other
    fields stay bit-equal. The writers' event streams have the same kinds
    and keys."""
    from distributed_active_learning_tpu_torch.ops.similarity import MASS_RTOL

    score_fields = ("score_min", "score_mean", "score_max", "score_margin")
    cases = {
        "device fit, pallas": ({}, 15),
        "density (higher is better)": (dict(strategy="density"), 15),
        "host fit, gemm": (dict(fit="host", kernel="gemm"), 15),
        "window 40": ({}, 40),
        "4 classes (the multiclass pool entropy, a 4-bin picked_hist)": (dict(bundle=_FOUR), 15),
    }
    for i, (what, (change, window)) in enumerate(cases.items()):
        change = dict(change)
        bundle = change.pop("bundle", None)
        jcfg, _ = _cfgs(False, **change)
        jcfg = dataclasses.replace(jcfg, max_rounds=2 if window > 15 else 3, strategy=(
            dataclasses.replace(jcfg.strategy, window_size=window)))
        tcfg = t_config.from_dict(dataclasses.asdict(jcfg))
        jw = j_telemetry.MetricsWriter(str(tmp_path / f"j{i}.jsonl"))
        want = j_loop.run_experiment(jcfg, metrics=jw, bundle=JBundle(*bundle) if bundle else None)
        jw.close()
        tw = t_telemetry.MetricsWriter(str(tmp_path / f"t{i}.jsonl"))
        got = t_loop.run_experiment(tcfg, metrics=tw, device="cpu",
                                    bundle=TBundle(*bundle) if bundle else None)
        tw.close()
        assert got.to_reference_log() == want.to_reference_log(), what
        for a, b in zip(got.records, want.records):
            assert list(a.metrics) == list(b.metrics), what
            scale = max(abs(b.metrics["score_min"]), abs(b.metrics["score_max"]))
            for field in b.metrics:  # floats from float32: == is bit-equality
                if "density" in what and field in score_fields:
                    assert abs(a.metrics[field] - b.metrics[field]) <= 2 * MASS_RTOL * scale, (
                        what, a.round, field)
                elif field == "pool_entropy":
                    assert abs(a.metrics[field] - b.metrics[field]) <= (
                        t_telemetry.POOL_ENTROPY_RTOL * abs(b.metrics[field])), (what, a.round)
                else:
                    assert a.metrics[field] == b.metrics[field], (what, a.round, field)
        assert sum(got.records[0].metrics["picked_hist"]) == window
        assert len(got.records[0].metrics["picked_hist"]) == (4 if bundle else 2)
        j_ev, t_ev = _events(tmp_path / f"j{i}.jsonl"), _events(tmp_path / f"t{i}.jsonl")
        assert [e["kind"] for e in t_ev] == [e["kind"] for e in j_ev], what
        assert [sorted(e) for e in t_ev] == [sorted(e) for e in j_ev], what
        for te, je in zip(t_ev, j_ev):
            if te["kind"] == "round":
                assert te["train_time"] > 0 and te["eval_time"] > 0
                assert {k: te[k] for k in ("round", "n_labeled", "accuracy")} == {
                    k: je[k] for k in ("round", "n_labeled", "accuracy")}


def _per_round_resume(tmp_path):
    """A checkpointed per-round run stopped at 2 rounds and resumed to 5
    equals the uninterrupted 5-round run: records with their metrics (the
    first two from the checkpoint's records_json), final mask. The fit
    window is pinned, so that both runs fit the same window."""
    _, tcfg = _cfgs(False, fit_budget=96)
    tcfg = dataclasses.replace(tcfg, collect_metrics=True)
    full = t_loop.run_experiment(dataclasses.replace(tcfg, max_rounds=5), device="cpu")
    ck = str(tmp_path / "ckpt")
    resumable = dataclasses.replace(tcfg, checkpoint_dir=ck, checkpoint_every=1)
    first = t_loop.run_experiment(dataclasses.replace(resumable, max_rounds=2), device="cpu")
    assert sorted(os.listdir(ck)) == ["alstate_1.npz", "alstate_2.npz"]
    with np.load(os.path.join(ck, "alstate_2.npz")) as z:
        assert z["labeled_mask"].dtype == np.bool_ and z["labeled_mask"].shape == (300,)
        assert z["key"].dtype == np.uint32 and z["round"].dtype == np.int32
    resumed = t_loop.run_experiment(dataclasses.replace(resumable, max_rounds=3), device="cpu")
    key = lambda res: [(r.round, r.n_labeled, r.accuracy, r.metrics) for r in res.records]
    assert key(resumed) == key(full) and key(first) == key(full)[:2]
    assert torch.equal(resumed.final_labeled_mask, full.final_labeled_mask)
    # A finished run resumes to itself: nothing left to do.
    again = t_loop.run_experiment(dataclasses.replace(resumable, max_rounds=0), device="cpu")
    assert key(again) == key(full)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_run_experiment_matches_jax(fused, tmp_path):
    cases = {"device fit, pallas": {}, **_QUANTIZED, **({} if fused else _UNFUSED_ONLY)}
    if not fused:
        # LAL with its regressor from a forest file (the card's way: it has
        # no scikit-learn), written by the port and read by both packages.
        from distributed_active_learning_tpu_torch.models import forest as t_forest
        from distributed_active_learning_tpu_torch.models import forest_io as t_io
        from distributed_active_learning_tpu_torch.models.lal_training import lal_meta

        path = str(tmp_path / "lal.npz")
        t_io.save_forest(path, t_forest.synthetic_forest(np.random.default_rng(9), 12, 6, 5),
                         meta=lal_meta({"lal_model_path": path}))
        cases["lal, regressor from a forest file"] = dict(
            strategy="lal", options={"lal_model_path": path})
    for what, change in cases.items():
        change = dict(change)
        bundle = change.pop("bundle", None)
        jcfg, tcfg = _cfgs(fused, **change)
        want = j_loop.run_experiment(jcfg, bundle=JBundle(*bundle) if bundle else None)
        got = t_loop.run_experiment(tcfg, bundle=TBundle(*bundle) if bundle else None,
                                    device="cpu")
        key = lambda res: [(r.round, r.n_labeled, r.n_unlabeled, r.accuracy) for r in res.records]
        assert key(got) == key(want), what
        assert [r.n_labeled for r in got.records] == [10, 25, 40]
        assert got.to_reference_log() == want.to_reference_log()

        j_picks, j_mask, j_proba = _drive_jax(jcfg, bundle)
        t_picks, t_mask, t_proba = _drive_port(tcfg, bundle)
        for a, b in zip(j_picks, t_picks):
            np.testing.assert_array_equal(a, b, what)
        np.testing.assert_array_equal(j_mask, t_mask, what)
        np.testing.assert_array_equal(got.final_labeled_mask.numpy(), j_mask, what)
        np.testing.assert_array_equal(t_proba, j_proba, what)
    if not fused:
        _metrics_match_jax(tmp_path)
        _per_round_resume(tmp_path)
        _scenarios_match_jax(tmp_path)
    else:
        # The fused round refuses a scenario with the JAX package's reason.
        from distributed_active_learning_tpu.config import ScenarioConfig as JScn

        jcfg, _ = _cfgs(True)
        jcfg = dataclasses.replace(jcfg, scenario=JScn(kind="drift", drift_rate=0.2))
        with pytest.raises(ValueError) as want:
            j_loop.run_experiment(jcfg)
        with pytest.raises(ValueError) as got:
            t_loop.run_experiment(t_config.from_dict(dataclasses.asdict(jcfg)), device="cpu")
        assert str(got.value) == str(want.value)
        assert "fused_round unavailable: scenario 'drift'" in str(got.value)


def _scenarios_match_jax(tmp_path):
    """Each scenario family of the JAX package's tests (``SCENARIOS`` on its
    ``_cfg``: the clean run, a noisy oracle flipping and abstaining, a rare
    class, a mean-shift drift and a cost budget; and the rotation drift),
    run per round with RoundMetrics against the JAX package's run:
    records, every metric field (``rare_recall`` and ``cost_spent`` where
    they belong) but pool_entropy bit-equal, pool_entropy to
    ``POOL_ENTROPY_RTOL``, final masks equal (JAX's from its last
    checkpoint)."""
    from distributed_active_learning_tpu.config import ScenarioConfig as JScn
    from distributed_active_learning_tpu.runtime import checkpoint as j_ckpt

    for i, scn in enumerate(_SCENARIOS + [JScn(kind="drift", drift_rate=0.3,
                                                drift_kind="rotation")]):
        ck = str(tmp_path / f"scn{i}")
        jcfg = _scenario_cfg(scn, rounds_per_launch=1, collect_metrics=True)
        want = j_loop.run_experiment(dataclasses.replace(jcfg, checkpoint_dir=ck,
                                                         checkpoint_every=1))
        got = t_loop.run_experiment(t_config.from_dict(dataclasses.asdict(jcfg)), device="cpu")
        assert got.to_reference_log() == want.to_reference_log(), scn
        for a, b in zip(got.records, want.records, strict=True):
            assert list(a.metrics) == list(b.metrics), scn
            for field, v in b.metrics.items():
                if field == "pool_entropy":
                    assert abs(a.metrics[field] - v) <= t_telemetry.POOL_ENTROPY_RTOL * abs(v)
                else:
                    assert a.metrics[field] == v, (scn.kind, a.round, field)
        assert ("rare_recall" in got.records[0].metrics) == (scn.kind == "rare_event")
        assert ("cost_spent" in got.records[0].metrics) == (scn.kind == "cost_budget")
        with np.load(os.path.join(ck, f"alstate_{j_ckpt.latest_step(ck)}.npz")) as z:
            np.testing.assert_array_equal(got.final_labeled_mask.numpy(), z["labeled_mask"])


_ISOLATION = """
import contextlib, io, json, os, runpy, sys, tempfile


class _NoJax:  # any import of JAX or the JAX package fails here
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "distributed_active_learning_tpu"):
            raise ImportError(name + " is blocked")


sys.meta_path.insert(0, _NoJax())
from distributed_active_learning_tpu_torch import bench, parallel, run
from distributed_active_learning_tpu_torch.analysis import auditor, lint, rules
from distributed_active_learning_tpu_torch.benches import pallas_variants
from distributed_active_learning_tpu_torch.models import forest_io
from distributed_active_learning_tpu_torch.ops import ring_topk
from distributed_active_learning_tpu_torch.parallel import collectives, kernels, mesh
from distributed_active_learning_tpu_torch.runtime import checkpoint, obs, pipeline, sweep, telemetry
from distributed_active_learning_tpu_torch.serving import fleet
import torch
assert not torch.cuda.is_initialized()  # the fleet's router process imports this much
small = ["--device", "cpu", "--n-samples", "200", "--trees", "4", "--window", "5",
         "--rounds", "2", "--quiet"]
tmp = tempfile.mkdtemp()
m_out, ck, fr = (os.path.join(tmp, p) for p in ("m.jsonl", "ckpt", "flight.json"))
observed = ["--fit", "device", "--kernel", "pallas", "--rounds-per-launch", "2",
            "--metrics-out", m_out, "--checkpoint-dir", ck, "--checkpoint-every", "1",
            "--flight-recorder", fr]
assert run.main(small + observed) == 0
assert os.listdir(ck) == ["alstate_2.npz"]  # one chunk, one touchdown
assert json.load(open(fr))["reasons"] == ["exit"]
kinds = [json.loads(line)["kind"] for line in open(m_out)]
assert kinds.count("round") == 2 and kinds.count("launch") == 1, kinds
summary = io.StringIO()
with contextlib.redirect_stdout(summary):
    sys.argv = ["summarize_metrics.py", m_out]
    try:
        runpy.run_path(os.path.join("benches", "summarize_metrics.py"), run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code
assert "== rounds ==" in summary.getvalue() and "chunk_scan" in summary.getvalue()
telemetry.uninstall_flight_recorder()
for extra in (["--fit", "device", "--kernel", "pallas", "--fused-round", "--audit"],
              ["--fit", "device", "--kernel", "pallas", "--mesh-data", "2", "--n-samples", "201"],
              ["--fit", "device", "--kernel", "pallas", "--rounds-per-launch", "3",
               "--pipeline-depth", "2"],
              ["--fit", "host", "--kernel", "pallas"],
              ["--fit", "device", "--kernel", "gather", "--depth", "11"],
              ["--fit", "device", "--kernel", "pallas", "--strategy", "density"],
              ["--fit", "device", "--kernel", "pallas", "--quantize", "int8", "--fused-round"],
              ["--fit", "device", "--kernel", "pallas", "--strategy", "lal",
               "--strategy-option", "lal_data_path=tests/fixtures/lal_simulatedunbalanced_big.txt",
               "--strategy-option", "lal_trees=4", "--strategy-option", "lal_depth=4"]):
    assert run.main(small + extra) == 0, extra
# A 2-seed sweep and a 2-cell grid, each one batched launch stream; a
# scenario run, and a scenario axis crossed with 2 seeds.
for extra in (["--sweep-seeds", "2"], ["--strategies", "uncertainty,margin"],
              ["--scenario", "noisy_oracle", "--flip-prob", "0.1", "--abstain-prob", "0.25"],
              ["--scenarios", "none,drift", "--drift-rate", "0.2", "--sweep-seeds", "2"]):
    assert run.main(small + ["--fit", "device", "--kernel", "pallas", "--rounds-per-launch", "2",
                             *extra]) == 0, extra
assert "sklearn" in sys.modules  # the host fit ran
# The streaming service's CLI, as `python -m ...serving --device cpu`: a
# short stream, saved and resumed from its checkpoint; without a card and
# without --device cpu it refuses to start.
serve_argv = ["serving", "--device", "cpu", "--queries", "12", "--slab-rows", "64",
              "--ingest-block", "16", "--score-width", "16", "--refit-rounds", "2",
              "--max-staleness", "5", "--trees", "4", "--window", "4",
              "--checkpoint-dir", os.path.join(tmp, "serve_ckpt")]
lines = []
for _ in range(2):
    served = io.StringIO()
    with contextlib.redirect_stdout(served):
        sys.argv = serve_argv
        try:
            runpy.run_module("distributed_active_learning_tpu_torch.serving", run_name="__main__")
        except SystemExit as e:
            assert not e.code, e.code
    lines.append(json.loads(served.getvalue().splitlines()[-1]))
assert lines[0]["queries"] == 12 and lines[0]["recompiles_after_warmup"] == 0, lines
assert lines[1]["fill"] > lines[0]["fill"], lines  # resumed, then ingested more
from distributed_active_learning_tpu_torch.serving import __main__ as serving_cli
try:
    serving_cli.main(serve_argv[3:])
except RuntimeError as e:
    assert "no CUDA device" in str(e), e
    print("SERVED", lines[0]["refits"], lines[1]["fill"])
else:
    raise AssertionError("the serving CLI started without a card and without --device cpu")
# Under a mesh: the chunk with metrics and the gemm form, the host fit with
# density, a 2-seed sweep and the noisy oracle.
for extra in (["--fit", "device", "--kernel", "gemm", "--rounds-per-launch", "2",
               "--metrics-out", os.path.join(tmp, "mesh.jsonl")],
              ["--fit", "host", "--kernel", "pallas", "--strategy", "density"],
              ["--fit", "device", "--kernel", "pallas", "--sweep-seeds", "2",
               "--rounds-per-launch", "2"],
              ["--fit", "device", "--kernel", "pallas", "--scenario", "noisy_oracle",
               "--flip-prob", "0.1", "--abstain-prob", "0.25", "--rounds-per-launch", "2"]):
    assert run.main(small + ["--mesh-data", "2", "--mesh-model", "2"] + extra) == 0, extra
print("MESHED")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "distributed_active_learning_tpu"))
assert not bad, bad
print("ISOLATED")
"""


def test_port_runs_without_jax_in_a_fresh_interpreter():
    """The CLI's paths (fused, mesh, chunked, host fit, deep gather form,
    density, int8 storage, lal, a 2-seed sweep, a 2-cell grid, a noisy
    oracle and a 2-scenario x 2-seed grid; on a 2 x 2 mesh a chunk with
    metrics in the gemm form, the host fit with density, a 2-seed sweep and
    the noisy oracle) and the streaming service's CLI
    (a stream, and its resume) run in a fresh interpreter, and neither the
    port nor scikit-learn pulls in JAX or the JAX package; importing the
    fleet (``serving.fleet``) initializes no CUDA."""
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATION], capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout and "SERVED" in out.stdout
    assert out.stdout.count("Iteration") == 46
    assert out.stdout.count("# sweep seed") == 4 and out.stdout.count("# grid cell") == 6
    assert out.stdout.count("# grid cell uncertainty/checkerboard2x2/drift/seed") == 2
    assert "MESHED" in out.stdout
    # The ops plane: one sequence of counter, gauge, histogram and heartbeat
    # calls renders the same Prometheus text in both packages (JAX's obs.py
    # imports no JAX, but its package does: this runs outside the isolated
    # interpreter).
    renders = []
    for obs in (j_obs, t_obs):
        reg = obs.Registry()
        reg.counter("launches", "jitted program launches", program="chunk_scan").inc(3)
        reg.counter("recompiles_after_warmup", "jit-cache growths past each program's first call")
        reg.gauge("pipeline_inflight", "chunk launches currently in flight").set(2)
        h = reg.histogram("launch_seconds", "per-launch wall seconds", program="chunk_scan")
        for v in (3e-5, 0.0021, 0.0226, 0.5, 250.0):
            h.observe(v)
        reg.heartbeat("pipeline_touchdown", max_age_seconds=60)
        renders.append(reg.render_prometheus())
        assert obs.PROM_PREFIX == "dal_" and obs.LATENCY_BUCKETS == j_obs.LATENCY_BUCKETS
    assert renders[0] == renders[1]
    assert "dal_recompiles_after_warmup_total 0" in renders[1]


def test_unported_features_are_refused_by_name(tmp_path, capsys):
    _, base = _cfgs(False)
    mesh = t_config.MeshConfig(data=2)
    # A multi-process launch runs a mesh over processes (its parity with the
    # JAX package's runs: tests/test_torch_mesh.py): here the CLI on 2 ranks
    # over gloo, where the primary alone binds --ops-port, and with its
    # model axis across the 2 ranks, and with ranks whose cells cross a data
    # row partway (3 rows of 2 cells over 2 ranks), each of which prints the
    # same log. The pod half of the slab
    # pool is ported (its parity with the JAX package:
    # tests/test_torch_serving.py) and exported as JAX exports it.
    import socket

    from tests.test_torch_mesh import spawn_ranks, wait_ranks

    from distributed_active_learning_tpu_torch import serving as t_serving
    from distributed_active_learning_tpu_torch.serving import slab as t_slab_mod

    assert t_serving.RebalanceHysteresis is t_slab_mod.RebalanceHysteresis
    assert callable(t_slab_mod.shard_slab_pool) and t_slab_mod.MOVED_SENTINEL == -1
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        ops_port = sock.getsockname()[1]
    cli = ["-m", "distributed_active_learning_tpu_torch.run", "--device", "cpu", "--dataset",
           "checkerboard2x2", "--n-samples", "120", "--trees", "4", "--depth", "3", "--window",
           "5", "--rounds", "2", "--seed", "3"]
    jobs = {}
    for name, extra in (("run", ["--mesh-data", "2", "--ops-port", str(ops_port)]),
                        ("model", ["--mesh-data", "1", "--mesh-model", "2"]),
                        ("crossing", ["--mesh-data", "3", "--mesh-model", "2"])):
        (tmp_path / name).mkdir()
        jobs[name] = spawn_ranks(2, cli + extra, tmp_path / name)
    runs = wait_ranks(jobs["run"])
    assert [rc for rc, _ in runs] == [0, 0], runs
    logs = [[ln for ln in out.splitlines() if ln.startswith("Iteration")] for _, out in runs]
    assert len(logs[0]) == 2 and logs[0] == logs[1], logs
    assert "# ops plane: http://127.0.0.1:" in runs[0][1]
    assert "# ops plane: skipped on host 1 (primary host binds --ops-port)" in runs[1][1]
    model = wait_ranks(jobs["model"])
    assert [rc for rc, _ in model] == [0, 0], model
    assert [[ln for ln in out.splitlines() if ln.startswith("Iteration")]
            for _, out in model] == logs, model
    crossing = wait_ranks(jobs["crossing"])
    assert [rc for rc, _ in crossing] == [0, 0], crossing
    assert [[ln for ln in out.splitlines() if ln.startswith("Iteration")]
            for _, out in crossing] == logs, crossing
    # A LAL run with neither a data file nor a forest file synthesizes its
    # regressor's training rows and fits it with scikit-learn: without
    # scikit-learn (the card's machine) it is refused by name, before the
    # experiments run.
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "sklearn", None)
        with pytest.raises(ImportError, match="scikit-learn"):
            t_loop.run_experiment(dataclasses.replace(base, strategy=t_config.StrategyConfig(
                name="lal", window_size=15)), device="cpu")
    # Quantized storage: what the JAX package refuses, the port refuses with
    # the same reasons.
    for change, why in ((dict(fit="host"), "requires the device fit"),
                        (dict(kernel="gather"), "path-matrix kernels, not 'gather'"),
                        (dict(max_depth=11), "no gather-form dequantizer"),
                        (dict(quantize="fp4"), "unknown ForestConfig.quantize")):
        jcfg, tcfg = _cfgs(False, **{"quantize": "int8", **change})
        for run in (j_loop.run_experiment, lambda c: t_loop.run_experiment(c, device="cpu")):
            with pytest.raises(ValueError, match=why):
                run(jcfg if run is j_loop.run_experiment else tcfg)
    # The CLI refuses half a checkpoint request, as the JAX package's does
    # (--roofline is ported: tests/test_torch_bench.py runs it).
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        from distributed_active_learning_tpu_torch import run as t_run

        with pytest.raises(SystemExit):
            t_run.main(["--device", "cpu", "--checkpoint-dir", "ck"])
        assert "both --checkpoint-dir and" in capsys.readouterr().err
    # Sweeps and grids refuse stream_round_events before any work (the JAX
    # package's ValueError); under a mesh they run (tests/test_torch_scoring.py).
    from distributed_active_learning_tpu.runtime import sweep as j_sweep
    from distributed_active_learning_tpu_torch.runtime import sweep as t_sweep

    for kind, run in (("sweep", lambda c: t_sweep.run_sweep(c, [0, 1], device="cpu")),
                      ("grid", lambda c: t_sweep.run_grid(c, ["uncertainty"], [0, 1],
                                                          device="cpu"))):
        with pytest.raises(ValueError, match=f"not supported by the batched {kind} chunk"):
            run(dataclasses.replace(base, stream_round_events=True))
    # What the JAX package refuses of a scenario, the port refuses with its
    # message: a host fit (a run and a grid's axis), a scenario as a batched
    # seed sweep, duplicate kinds on the axis; under a mesh every kind but
    # the noisy oracle (a run) and a grid's scenario axis (the noisy oracle
    # on a mesh runs: tests/test_torch_serving.py).
    jbase, _ = _cfgs(False)
    jscn = j_config.ScenarioConfig(kind="noisy_oracle", flip_prob=0.1)
    host_j = dataclasses.replace(jbase, forest=dataclasses.replace(jbase.forest, fit="host"))
    j_mesh_cfg = dataclasses.replace(jbase, mesh=j_config.MeshConfig(data=2))
    refusals = (
        (lambda c: c, dataclasses.replace(host_j, scenario=jscn), "run"),
        (lambda c: c, dataclasses.replace(jbase, scenario=jscn), "sweep"),
        (lambda c: c, host_j, "grid axis"),
        (lambda c: c, jbase, "duplicate"),
        (lambda c: c, dataclasses.replace(j_mesh_cfg, scenario=j_config.ScenarioConfig(
            kind="drift", drift_rate=0.1)), "run"),
        (lambda c: c, dataclasses.replace(j_mesh_cfg, scenario=j_config.ScenarioConfig(
            kind="cost_budget", cost_budget=20.0), strategy=dataclasses.replace(
                jbase.strategy, name="entropy")), "run"),
        (lambda c: c, j_mesh_cfg, "grid axis"),
    )
    for _, jcfg, what in refusals:
        tcfg = t_config.from_dict(dataclasses.asdict(jcfg))
        if what == "run":
            calls = (lambda: j_loop.run_experiment(jcfg),
                     lambda: t_loop.run_experiment(tcfg, device="cpu"))
        elif what == "sweep":
            calls = (lambda: j_sweep.run_sweep(jcfg, [0, 1]),
                     lambda: t_sweep.run_sweep(tcfg, [0, 1], device="cpu"))
        else:
            axis = ["noisy_oracle"] if what == "grid axis" else ["drift", "drift"]
            calls = (lambda: j_sweep.run_grid(jcfg, ["uncertainty"], [0], scenarios=axis),
                     lambda: t_sweep.run_grid(tcfg, ["uncertainty"], [0], scenarios=axis,
                                              device="cpu"))
        errs = []
        for call in calls:
            with pytest.raises(ValueError) as err:
                call()
            errs.append(str(err.value))
        assert errs[0] == errs[1], what
    # The fused round refuses metrics with the JAX package's reason.
    with pytest.raises(ValueError, match="fused_round unavailable: RoundMetrics consume"):
        t_loop.run_experiment(dataclasses.replace(base, fused_round=True, collect_metrics=True),
                              device="cpu")
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
