"""The port's chunked driver against its own per-round driver and the JAX
package's chunked driver, on the CPU: checkerboard2x2 (300 rows), 8 trees of
depth 4, device fit, kernel "pallas", uncertainty, window 15, n_start 10,
3 rounds per launch. Records and the reference log are bit-equal across all
three, the final mask across the port's two drivers (the JAX result does not
carry one), fused and unfused, at pipeline depth 1 and 2, with ``max_rounds``
not a multiple of the chunk and with a ``label_budget`` that stops inside a
chunk; unfused also with a depth-11 device fit (the gather form), the
density strategy, bf16 storage, a 4-class pool and the lal strategy (its
regressor fitted from the committed fixture), fused with int8 storage. Also
the raw chunk program: its stacked ys and its carried-out state
(picked, active, mask, key data, round) equal the JAX chunk's.

Telemetry and checkpoints: the metrics-on chunk's RoundMetrics equal the
per-round driver's, and the JAX chunked driver's (pool_entropy to
``telemetry.POOL_ENTROPY_RTOL``; depth 1 and 2, K = 3), and
metrics change no pick; ``config_fingerprint`` is the same in both packages;
a checkpoint written by the JAX chunked driver resumes in the port and one
written by the port resumes in JAX, each resumed curve and final mask equal
to the other package's uninterrupted run; a chunked checkpoint resumes under
the per-round driver; a checkpoint written on a 2 x 1 mesh resumes on
one device; and an int8-storage chunked run stopped and resumed equals its
uninterrupted run (the fingerprint holds the storage mode, as JAX's).

Sweeps and grids (``runtime/sweep.py``), at the sizes of the JAX package's
``tests/test_grid.py`` (checkerboard2x2 of 160 rows, 6 trees of depth 3,
``fit_budget`` pinned, K = 2): ``run_sweep`` over 3 seeds with windows
[10, 6, 10], metrics on, kernels "pallas" and "gemm", each seed's records
(metrics included) and final mask equal to the port's serial
``run_experiment``, and to the JAX package's ``run_sweep`` and serial runs
(pool_entropy to ``POOL_ENTROPY_RTOL``); ``run_grid`` over uncertainty,
margin and density x 2 seeds against the serial cells of both packages
(density's score fields to ``similarity.MASS_RTOL``); a grid of two datasets
of unequal widths (120 and 200 rows, the fill watermark) against the JAX
package's ``run_grid`` and both packages' serial cells; sweep and grid
checkpoints written by either package resumed by the other to the same
records; a ``gridstate_`` resume refused for another strategy axis; the
batched fingerprints equal in both packages.

Scenarios: each family of the JAX package's scenario tests (and the rotation
drift) chunked at K = 2 with metrics equals the port's per-round run and the
JAX package's chunked run."""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from distributed_active_learning_tpu import config as j_config
from distributed_active_learning_tpu.data import get_dataset as j_get_dataset
from distributed_active_learning_tpu.data.datasets import DataBundle as JBundle
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu.runtime import checkpoint as j_ckpt
from distributed_active_learning_tpu.runtime import loop as j_loop
from distributed_active_learning_tpu.runtime import state as j_state
from distributed_active_learning_tpu.runtime import sweep as j_sweep
from distributed_active_learning_tpu.runtime import telemetry as j_telemetry
from distributed_active_learning_tpu.strategies import StrategyAux as JAux
from distributed_active_learning_tpu.strategies import get_strategy as j_strategy
from distributed_active_learning_tpu_torch import config as t_config
from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.data import get_dataset as t_get_dataset
from distributed_active_learning_tpu_torch.data.datasets import DataBundle as TBundle
from distributed_active_learning_tpu_torch.ops import trees_train as t_train
from distributed_active_learning_tpu_torch.runtime import checkpoint as t_ckpt
from distributed_active_learning_tpu_torch.runtime import loop as t_loop
from distributed_active_learning_tpu_torch.runtime import state as t_state
from distributed_active_learning_tpu_torch.runtime import sweep as t_sweep
from distributed_active_learning_tpu_torch.runtime import telemetry as t_telemetry
from distributed_active_learning_tpu_torch.strategies import StrategyAux as TAux
from distributed_active_learning_tpu_torch.strategies import get_strategy as t_strategy
from tests.torch_threads import capped_torch_threads  # noqa: F401  (autouse)

K = 3


def _cfgs(fused, max_depth=4, strategy="uncertainty", fit_budget=None, quantize="none",
          options=None, **kw):
    j = j_config.ExperimentConfig(
        data=j_config.DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=j_config.ForestConfig(n_trees=8, max_depth=max_depth, kernel="pallas",
                                     fit="device", fit_budget=fit_budget, quantize=quantize),
        strategy=j_config.StrategyConfig(name=strategy, window_size=15, options=options or {}),
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
    # A probe stream_cb: round r's event fires after step r (its fit) and
    # before step r + 1 runs.
    log = []
    fit = t_loop.make_device_fit(tcfg, tbins.edges, budget)

    def logged_fit(codes, carry, key):
        log.append(("step", int(carry.round) + 1))
        return fit(codes, carry, key)

    t_chunk = t_loop.make_chunk_fn(
        t_strategy(tcfg.strategy), window, K, logged_fit, label_cap=ts.n_valid,
        fused_round=fused, stream_cb=lambda *row: log.append(("event", *row)))
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
    rows = list(zip(*(y.tolist() for y in (t_ys[0], t_ys[1], t_ys[2], t_ys[4]))))
    assert log == [e for r, row in enumerate(rows) for e in (("step", r + 1), ("event", *row))]
    assert int(t_extras.n_active) == int(j_extras.n_active) == 2
    assert int(t_extras.n_labeled_after) == int(j_extras.n_labeled_after) == 40
    np.testing.assert_array_equal(np.asarray(j_out.labeled_mask), t_out.labeled_mask.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(j_out.key)).astype(np.int64), t_out.key.numpy())
    assert int(j_out.round) == int(t_out.round) == 2


def _metrics_chunk_parity():
    """Metrics on: the chunk (depth 1 and 2) == the per-round driver == the
    JAX chunked driver, field by field (pool_entropy, the port's native
    log2, to ``POOL_ENTROPY_RTOL`` of JAX's); picks and records as without
    metrics."""
    from distributed_active_learning_tpu_torch.runtime.telemetry import POOL_ENTROPY_RTOL

    jcfg, tcfg = _cfgs(False, max_rounds=5, collect_metrics=True)
    plain = t_loop.run_experiment(dataclasses.replace(tcfg, collect_metrics=False), device="cpu")
    per_round = t_loop.run_experiment(tcfg, device="cpu")
    assert _key(per_round) == _key(plain)
    assert torch.equal(per_round.final_labeled_mask, plain.final_labeled_mask)
    want = j_loop.run_experiment(dataclasses.replace(jcfg, rounds_per_launch=K))
    for a, b in zip(per_round.records, want.records, strict=True):
        assert {k: v for k, v in a.metrics.items() if k != "pool_entropy"} == {
            k: v for k, v in b.metrics.items() if k != "pool_entropy"}, a.round
        assert abs(a.metrics["pool_entropy"] - b.metrics["pool_entropy"]) <= (
            POOL_ENTROPY_RTOL * abs(b.metrics["pool_entropy"])), a.round
    for depth in (1, 2):
        got = t_loop.run_experiment(
            dataclasses.replace(tcfg, rounds_per_launch=K, pipeline_depth=depth), device="cpu")
        assert _key(got) == _key(plain), depth
        assert [r.metrics for r in got.records] == [r.metrics for r in per_round.records], depth
        assert torch.equal(got.final_labeled_mask, plain.final_labeled_mask)
    assert all(sum(r.metrics["picked_hist"]) == 15 for r in got.records)


def _stream_events_match(t_path, j_path, got):
    """The port's ``round_stream`` events are JAX's, one an active round in
    round order, and each chunk's are all written before its touchdown
    writes its first ``round`` event."""
    def read(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    t_ev, j_ev = read(t_path), read(j_path)
    seq = [(e["round"], e["n_labeled"], e["accuracy"]) for e in t_ev if e["kind"] == "round_stream"]
    assert seq == [(e["round"], e["n_labeled"], e["accuracy"])
                   for e in j_ev if e["kind"] == "round_stream"]
    assert seq == [(r.round, r.n_labeled, r.accuracy) for r in got.records]
    at = {(e["kind"], e["round"]): i for i, e in enumerate(t_ev) if "round" in e}
    last = got.records[-1].round
    for r in range(1, last + 1):
        chunk_end = min(-(-r // K) * K, last)
        assert at[("round_stream", chunk_end)] < at[("round", r)], r


def _fingerprints_agree():
    """The same experiment hashes to the same fingerprint in both packages,
    a scenario's included."""
    variants = [
        {},
        dict(max_depth=11),
        dict(strategy="density"),
        dict(fit_budget=96, max_rounds=7, rounds_per_launch=3, label_budget=70),
    ]
    variants += [dict(quantize="int8"), dict(strategy="lal", options=_LAL_OPTIONS)]
    for kw in variants:
        jcfg, tcfg = _cfgs(False, **kw)
        assert t_ckpt.config_fingerprint(tcfg) == j_ckpt.config_fingerprint(jcfg), kw
        assert t_ckpt.accepted_fingerprints(tcfg) == j_ckpt.accepted_fingerprints(jcfg), kw
        assert t_ckpt.kernel_ident(tcfg) == j_ckpt.kernel_ident(jcfg)
    # Loop controls stay out of the identity; the strategy is in it.
    assert (t_ckpt.config_fingerprint(_cfgs(False, max_rounds=3)[1])
            == t_ckpt.config_fingerprint(_cfgs(False, max_rounds=9, rounds_per_launch=3)[1]))
    assert (t_ckpt.config_fingerprint(_cfgs(False)[1])
            != t_ckpt.config_fingerprint(_cfgs(False, strategy="margin")[1]))
    # An active scenario widens the identity as in JAX; "none" leaves it.
    jbase, tbase = _cfgs(False)
    prints = set()
    for kw in _SCENARIO_KW:
        jcfg = dataclasses.replace(jbase, scenario=j_config.ScenarioConfig(**kw))
        tcfg = t_config.from_dict(dataclasses.asdict(jcfg))
        assert t_ckpt.config_fingerprint(tcfg) == j_ckpt.config_fingerprint(jcfg), kw
        prints.add(t_ckpt.config_fingerprint(tcfg))
    assert len(prints) == len(_SCENARIO_KW)
    assert t_ckpt.config_fingerprint(tbase) == t_ckpt.config_fingerprint(
        dataclasses.replace(tbase, scenario=t_config.ScenarioConfig()))


def _final_mask(ckpt_dir):
    with np.load(os.path.join(ckpt_dir, f"alstate_{j_ckpt.latest_step(ckpt_dir)}.npz")) as z:
        return z["labeled_mask"]


def _checkpoints_cross_packages(tmp_path):
    """Stop at 2 rounds, resume to 5, across the packages, chunked (K = 3):
    JAX writes and the port resumes, the port writes and JAX resumes; a
    chunk's checkpoint resumes under the per-round driver and a 2 x 1 mesh
    checkpoint on one device. The fit window is pinned (fit_budget), so that
    every run fits the same window; final masks of the JAX runs are read
    from their last checkpoint."""
    jcfg, tcfg = _cfgs(False, fit_budget=96, rounds_per_launch=K, pipeline_depth=2)
    ckd = lambda name: dict(checkpoint_dir=str(tmp_path / name), checkpoint_every=1)
    t_full = t_loop.run_experiment(dataclasses.replace(tcfg, max_rounds=5), device="cpu")
    j_full = j_loop.run_experiment(dataclasses.replace(jcfg, max_rounds=5, **ckd("j_full")))
    assert _key(t_full) == _key(j_full)
    np.testing.assert_array_equal(_final_mask(tmp_path / "j_full"),
                                  t_full.final_labeled_mask.numpy())

    # JAX writes, the port resumes.
    j_loop.run_experiment(dataclasses.replace(jcfg, max_rounds=2, **ckd("j2t")))
    resumed = t_loop.run_experiment(dataclasses.replace(tcfg, max_rounds=3, **ckd("j2t")),
                                    device="cpu")
    assert _key(resumed) == _key(j_full)
    np.testing.assert_array_equal(resumed.final_labeled_mask.numpy(),
                                  _final_mask(tmp_path / "j_full"))
    # The port writes, JAX resumes.
    first = t_loop.run_experiment(dataclasses.replace(tcfg, max_rounds=2, **ckd("t2j")),
                                  device="cpu")
    assert sorted(os.listdir(tmp_path / "t2j")) == ["alstate_2.npz"]  # one chunk boundary
    resumed = j_loop.run_experiment(dataclasses.replace(jcfg, max_rounds=3, **ckd("t2j")))
    assert _key(resumed) == _key(t_full)
    np.testing.assert_array_equal(_final_mask(tmp_path / "t2j"), t_full.final_labeled_mask.numpy())
    # The port's chunk checkpoint resumes under its per-round driver.
    per_round = dataclasses.replace(tcfg, rounds_per_launch=1)
    t_loop.run_experiment(dataclasses.replace(tcfg, max_rounds=2, **ckd("chunk2round")),
                          device="cpu")
    resumed = t_loop.run_experiment(
        dataclasses.replace(per_round, max_rounds=3, **ckd("chunk2round")), device="cpu")
    assert _key(resumed) == _key(t_full) and _key(first) == _key(t_full)[:2]
    assert torch.equal(resumed.final_labeled_mask, t_full.final_labeled_mask)
    # A 2 x 1 mesh checkpoint (per round: the chunk under a mesh is not
    # ported) resumes on one device.
    mesh = dataclasses.replace(per_round, mesh=t_config.MeshConfig(data=2), max_rounds=2,
                               **ckd("mesh"))
    t_loop.run_experiment(mesh, device="cpu")
    assert _final_mask(tmp_path / "mesh").shape == (300,)
    resumed = t_loop.run_experiment(
        dataclasses.replace(tcfg, max_rounds=3, **ckd("mesh")), device="cpu")
    assert _key(resumed) == _key(t_full)
    assert torch.equal(resumed.final_labeled_mask, t_full.final_labeled_mask)
    # Another experiment's checkpoint is refused.
    other = dataclasses.replace(tcfg, strategy=t_config.StrategyConfig(name="margin",
                                                                        window_size=15))
    with pytest.raises(ValueError, match="refusing to resume a different experiment"):
        t_loop.run_experiment(dataclasses.replace(other, max_rounds=1, **ckd("mesh")),
                              device="cpu")


def test_chunked_matches_jax(tmp_path):
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
            # round_stream events in one case, written by both packages.
            stream = not fused and "max_rounds" in what
            for depth in (1, 2):
                writer = (t_telemetry.MetricsWriter(str(tmp_path / "t_stream.jsonl"))
                          if stream and depth == 2 else None)
                got = t_loop.run_experiment(
                    dataclasses.replace(tcfg, rounds_per_launch=K, pipeline_depth=depth,
                                        stream_round_events=writer is not None),
                    device="cpu", metrics=writer)
                if writer is not None:
                    writer.close()
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
            jwriter = (j_telemetry.MetricsWriter(str(tmp_path / "j_stream.jsonl"))
                       if stream else None)
            want = j_loop.run_experiment(
                dataclasses.replace(jcfg, rounds_per_launch=K, stream_round_events=stream),
                metrics=jwriter)
            assert _key(got) == _key(want), (fused, what)
            assert got.to_reference_log() == want.to_reference_log()
            if stream:
                jwriter.close()
                _stream_events_match(str(tmp_path / "t_stream.jsonl"),
                                     str(tmp_path / "j_stream.jsonl"), got)
        _raw_chunk_parity(fused)

    # The gather form (a depth-11 device fit), density, quantized storage, a
    # 4-class pool and lal inside the chunk: equal to the per-round driver
    # and to the JAX chunked driver.
    four = _four_classes()
    for what, (fused, kw) in {
            "depth 11 (gather form)": (False, dict(max_depth=11)),
            "density": (False, dict(strategy="density")),
            "int8 storage, fused": (True, dict(quantize="int8")),
            "bf16 storage": (False, dict(quantize="bf16")),
            "4 classes": (False, dict(bundle=four)),
            "lal": (False, dict(strategy="lal", options=_LAL_OPTIONS))}.items():
        kw = dict(kw)
        bundle = kw.pop("bundle", None)
        jb, tb = (JBundle(*bundle), TBundle(*bundle)) if bundle else (None, None)
        jcfg, tcfg = _cfgs(fused, max_rounds=5, **kw)
        per_round = t_loop.run_experiment(tcfg, bundle=tb, device="cpu")
        got = t_loop.run_experiment(dataclasses.replace(tcfg, rounds_per_launch=K), bundle=tb,
                                    device="cpu")
        assert _key(got) == _key(per_round), what
        assert [r.n_labeled for r in got.records] == [10, 25, 40, 55, 70], what
        assert torch.equal(got.final_labeled_mask, per_round.final_labeled_mask), what
        want = j_loop.run_experiment(dataclasses.replace(jcfg, rounds_per_launch=K), bundle=jb)
        assert got.to_reference_log() == want.to_reference_log(), what

    _metrics_chunk_parity()
    _fingerprints_agree()
    _checkpoints_cross_packages(tmp_path)
    _quantized_resume(tmp_path)
    _sweep_matches_serial_and_jax(tmp_path)
    _grid_matches_serial_cells()
    _grid_unequal_widths_and_checkpoints(tmp_path)
    _scenario_chunks_match()


# The JAX package's scenario families (tests/test_scenarios.py SCENARIOS) and
# the rotation drift.
_SCENARIO_KW = [
    dict(),
    dict(kind="noisy_oracle", flip_prob=0.2, abstain_prob=0.3),
    dict(kind="rare_event", rare_class=1),
    dict(kind="drift", drift_rate=0.3),
    dict(kind="cost_budget", cost_budget=6.0),
    dict(kind="drift", drift_rate=0.3, drift_kind="rotation"),
]


def _scenario_chunks_match():
    """Each scenario family chunked (K = 2, metrics on, the JAX package's
    scenario test configuration) equals the port's per-round run (records,
    every metric, final mask) and the JAX package's chunked run (records;
    metrics but pool_entropy bit-equal, pool_entropy to
    ``POOL_ENTROPY_RTOL``)."""
    from distributed_active_learning_tpu_torch.runtime.telemetry import POOL_ENTROPY_RTOL

    for kw in _SCENARIO_KW:
        jcfg = j_config.ExperimentConfig(
            data=j_config.DataConfig(name="checkerboard2x2", n_samples=96, seed=2),
            forest=j_config.ForestConfig(n_trees=4, max_depth=3, fit="device", fit_budget=96),
            strategy=j_config.StrategyConfig(name="entropy", window_size=8), n_start=8,
            max_rounds=3, rounds_per_launch=2, log_every=0, collect_metrics=True,
            scenario=j_config.ScenarioConfig(**kw))
        tcfg = t_config.from_dict(dataclasses.asdict(jcfg))
        got = t_loop.run_experiment(tcfg, device="cpu")
        per_round = t_loop.run_experiment(dataclasses.replace(tcfg, rounds_per_launch=1),
                                          device="cpu")
        assert got.pipeline_stats is not None and per_round.pipeline_stats is None
        assert _key(got) == _key(per_round), kw
        assert [r.metrics for r in got.records] == [r.metrics for r in per_round.records], kw
        assert torch.equal(got.final_labeled_mask, per_round.final_labeled_mask), kw
        want = j_loop.run_experiment(jcfg)
        assert got.to_reference_log() == want.to_reference_log(), kw
        for a, b in zip(got.records, want.records, strict=True):
            assert {k: v for k, v in a.metrics.items() if k != "pool_entropy"} == {
                k: v for k, v in b.metrics.items() if k != "pool_entropy"}, (kw, a.round)
            assert abs(a.metrics["pool_entropy"] - b.metrics["pool_entropy"]) <= (
                POOL_ENTROPY_RTOL * abs(b.metrics["pool_entropy"])), (kw, a.round)


def _quantized_resume(tmp_path):
    """int8 storage, chunked (K = 3): stopped at 2 rounds and resumed to 5,
    equal to the uninterrupted run (the fit window pinned)."""
    _, tcfg = _cfgs(False, fit_budget=96, rounds_per_launch=K, quantize="int8")
    full = t_loop.run_experiment(dataclasses.replace(tcfg, max_rounds=5), device="cpu")
    ck = dict(checkpoint_dir=str(tmp_path / "q"), checkpoint_every=1)
    t_loop.run_experiment(dataclasses.replace(tcfg, max_rounds=2, **ck), device="cpu")
    resumed = t_loop.run_experiment(dataclasses.replace(tcfg, max_rounds=3, **ck), device="cpu")
    assert _key(resumed) == _key(full)
    assert torch.equal(resumed.final_labeled_mask, full.final_labeled_mask)


def _four_classes(seed=3, n=300, m=128):
    """A 4-class pool made with numpy: classes by quartile of x0 + 0.3 x1."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n + m, 4)).astype(np.float32)
    s = x[:, 0] + 0.3 * x[:, 1]
    y = np.digitize(s, np.quantile(s, [0.25, 0.5, 0.75])).astype(np.int32)
    return x[:n], y[:n], x[n:], y[n:]


_LAL_OPTIONS = {"lal_data_path": os.path.join(os.path.dirname(__file__), "fixtures",
                                              "lal_simulatedunbalanced_big.txt"),
                "lal_trees": 12, "lal_depth": 6}


def _grid_cfgs(kernel="pallas", **kw):
    """The JAX package's tests/test_grid.py configuration, in both packages."""
    data = kw.pop("data", j_config.DataConfig(name="checkerboard2x2", n_samples=160, seed=2))
    j = j_config.ExperimentConfig(
        data=data,
        forest=j_config.ForestConfig(n_trees=6, max_depth=3, fit="device", kernel=kernel,
                                     fit_budget=kw.pop("fit_budget", 160)),
        strategy=j_config.StrategyConfig(name=kw.pop("strategy", "uncertainty"), window_size=10),
        n_start=10, max_rounds=kw.pop("max_rounds", 3), rounds_per_launch=2, log_every=0, **kw)
    return j, t_config.from_dict(dataclasses.asdict(j))


def _rounds(res):
    return [(r.round, r.n_labeled, r.n_unlabeled, r.accuracy) for r in res.records]


def _metrics_close(got, want, density=False):
    """RoundMetrics of two runs, as ``test_chunked_matches_jax`` holds them
    against JAX's: pool_entropy to ``POOL_ENTROPY_RTOL``, under density the
    four score fields to twice ``MASS_RTOL`` of the largest |score|, every
    other field bit-equal. Under density the picked window's class
    histogram may differ only in a round whose selection boundary is a tie
    at score 0 in both runs (``score_margin`` 0.0): rows of zero one-sided
    entropy score 0 whatever their mass, and a row's mass near 0 can clamp
    to 0 in one package and stay a few ulps above it in the other (the mass
    agrees to ``MASS_RTOL``, not bit for bit), so which tied rows are
    picked can differ (ROADMAP queue 3)."""
    from distributed_active_learning_tpu_torch.ops.similarity import MASS_RTOL
    from distributed_active_learning_tpu_torch.runtime.telemetry import POOL_ENTROPY_RTOL

    assert len(got.records) == len(want.records)
    for a, b in zip(got.records, want.records):
        assert list(a.metrics) == list(b.metrics)
        scale = max(abs(b.metrics["score_min"]), abs(b.metrics["score_max"]))
        for field, v in b.metrics.items():
            if density and field in ("score_min", "score_mean", "score_max", "score_margin"):
                assert abs(a.metrics[field] - v) <= 2 * MASS_RTOL * scale, (a.round, field)
            elif field == "pool_entropy":
                assert abs(a.metrics[field] - v) <= POOL_ENTROPY_RTOL * abs(v), a.round
            elif (density and field == "picked_hist" and a.metrics[field] != v):
                assert a.metrics["score_margin"] == b.metrics["score_margin"] == 0.0, a.round
                assert sum(a.metrics[field]) == sum(v), a.round
            else:
                assert a.metrics[field] == v, (a.round, field)


_SEEDS, _WINDOWS = [0, 1, 2], [10, 6, 10]


def _serial_cfg(cfg, seed, window=None, strategy=None, dataset=None):
    return dataclasses.replace(
        cfg, seed=seed, rounds_per_launch=1, checkpoint_dir=None, checkpoint_every=0,
        data=dataclasses.replace(cfg.data, name=dataset or cfg.data.name),
        strategy=dataclasses.replace(cfg.strategy, name=strategy or cfg.strategy.name,
                                     window_size=window or cfg.strategy.window_size))


def _drop_last(ckpt_dir, prefix):
    """Remove the newest ``<prefix>_<round>.npz``: the run then resumes from
    the one before, mid-run."""
    steps = sorted(int(f[len(prefix) + 1:-4]) for f in os.listdir(ckpt_dir))
    assert len(steps) >= 2, steps
    os.remove(os.path.join(ckpt_dir, f"{prefix}_{steps[-1]}.npz"))
    return steps[-2]


def _sweep_matches_serial_and_jax(tmp_path):
    """run_sweep over 3 seeds of windows [10, 6, 10], metrics on, at kernels
    pallas and gemm: each seed equals the port's serial run exactly (records,
    metrics, final mask) and the JAX package's run_sweep, and the seed of the
    narrower window (the padded path) the JAX package's serial run too. The
    pallas runs checkpoint every round: with each package's last file
    removed, the other package resumes from its round-2 file to the same
    records."""
    full = {}
    ck = lambda name, r: dict(checkpoint_dir=str(tmp_path / name), checkpoint_every=1,
                              max_rounds=r)
    for kernel in ("pallas", "gemm"):
        jcfg, tcfg = _grid_cfgs(kernel, collect_metrics=True)
        if kernel == "pallas":  # checkpointed every round, for the resumes below
            jcfg, tcfg = (dataclasses.replace(jcfg, **ck("sw_j", 3)),
                          dataclasses.replace(tcfg, **ck("sw_t", 3)))
        got = t_sweep.run_sweep(tcfg, _SEEDS, windows=_WINDOWS, device="cpu")
        want = j_sweep.run_sweep(jcfg, _SEEDS, windows=_WINDOWS)
        full[kernel] = (got, want)
        for s, w, res, jres in zip(_SEEDS, _WINDOWS, got, want):
            serial = t_loop.run_experiment(_serial_cfg(tcfg, s, w), device="cpu")
            assert _key(res) == _key(serial) and len(res.records) == 3, (kernel, s)
            assert [r.metrics for r in res.records] == [r.metrics for r in serial.records]
            assert torch.equal(res.final_labeled_mask, serial.final_labeled_mask), (kernel, s)
            assert res.final_labeled_mask.sum() == 10 + 3 * w
            assert _rounds(res) == _rounds(jres), (kernel, s)
            _metrics_close(res, jres)
            if kernel == "pallas" and w < max(_WINDOWS):  # the padded path
                jser = j_loop.run_experiment(_serial_cfg(jcfg, s, w))
                assert _rounds(res) == _rounds(jser), s
                _metrics_close(res, jser)
    assert t_ckpt.sweep_fingerprint(tcfg, _SEEDS, _WINDOWS) == j_ckpt.sweep_fingerprint(
        jcfg, _SEEDS, _WINDOWS)

    # Resumed for 1 round from the other package's round-2 file.
    jcfg, tcfg = _grid_cfgs(collect_metrics=True)
    t_full, j_full = full["pallas"]
    assert sorted(os.listdir(tmp_path / "sw_j")) == ["sweepstate_2.npz", "sweepstate_3.npz"]
    assert _drop_last(tmp_path / "sw_j", "sweepstate") == 2
    resumed = t_sweep.run_sweep(dataclasses.replace(tcfg, **ck("sw_j", 1)), _SEEDS,
                                windows=_WINDOWS, device="cpu")
    for res, want in zip(resumed, t_full):
        assert _rounds(res) == _rounds(want)
        _metrics_close(res, want)
        assert torch.equal(res.final_labeled_mask, want.final_labeled_mask)
    assert _drop_last(tmp_path / "sw_t", "sweepstate") == 2
    resumed = j_sweep.run_sweep(dataclasses.replace(jcfg, **ck("sw_t", 1)), _SEEDS,
                                windows=_WINDOWS)
    for res, want in zip(resumed, j_full):
        assert _rounds(res) == _rounds(want)
        _metrics_close(res, want)
    # Another batch (other windows) refuses the file.
    with pytest.raises(ValueError, match="refusing to resume a different sweep"):
        t_sweep.run_sweep(dataclasses.replace(tcfg, **ck("sw_t", 1)), _SEEDS, device="cpu")


def _grid_matches_serial_cells():
    """run_grid over uncertainty, margin and density x 2 seeds, metrics on:
    each cell equals the port's serial run exactly and the JAX package's
    serial cell (density's score fields to MASS_RTOL)."""
    jcfg, tcfg = _grid_cfgs(collect_metrics=True)
    grid = t_sweep.run_grid(tcfg, ["uncertainty", "margin", "density"], [0, 1], device="cpu")
    assert not grid.serial_fallback and grid.launches == 2
    assert [(c.strategy, c.seed) for c in grid.cells] == [
        (s, e) for s in ("uncertainty", "margin", "density") for e in (0, 1)]
    for cell in grid.cells:
        serial = t_loop.run_experiment(_serial_cfg(tcfg, cell.seed, strategy=cell.strategy),
                                       device="cpu")
        assert _key(cell.result) == _key(serial), (cell.strategy, cell.seed)
        assert [r.metrics for r in cell.result.records] == [r.metrics for r in serial.records]
        assert torch.equal(cell.result.final_labeled_mask, serial.final_labeled_mask)
        jser = j_loop.run_experiment(_serial_cfg(jcfg, cell.seed, strategy=cell.strategy))
        assert _rounds(cell.result) == _rounds(jser), (cell.strategy, cell.seed)
        _metrics_close(cell.result, jser, density=cell.strategy == "density")
    from distributed_active_learning_tpu_torch.runtime import obs as t_obs
    from distributed_active_learning_tpu_torch.runtime.results import grid_curves

    assert t_obs.gauge("grid_cells").value == 6 and t_obs.gauge("grid_eta_seconds").value == 0.0
    axis, accs = grid_curves(grid)[("margin", "checkerboard2x2")]
    assert axis == [10, 20, 30] and accs.shape == (2, 3)


def _unequal_bundle(n, seed, d=6):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d)).astype(np.float32)
    tx = r.normal(size=(100, d)).astype(np.float32)
    return (x, (x[:, 0] + 0.3 * x[:, 1] > 0).astype(np.int32), tx,
            (tx[:, 0] + 0.3 * tx[:, 1] > 0).astype(np.int32), f"p{n}")


def _grid_unequal_widths_and_checkpoints(tmp_path):
    """Two datasets of 120 and 200 rows in one grid (the pools padded to one
    slab, the real rows marked by the fill watermark), 3 rounds, metrics
    on: equal to the JAX package's run_grid (records, RoundMetrics), to its
    serial cells and to the port's (records, and the final mask over each
    dataset's real rows; RoundMetrics but for the watermark's two divisions,
    within one ulp). Both grids checkpoint every round: with each package's
    last file removed, the other package resumes from its round-2 file to
    the uninterrupted records; another strategy axis refuses the file."""
    raw = {"p120": _unequal_bundle(120, 1), "p200": _unequal_bundle(200, 2)}
    jb = {k: JBundle(*v) for k, v in raw.items()}
    tb = {k: TBundle(*v) for k, v in raw.items()}
    jcfg, tcfg = _grid_cfgs(data=j_config.DataConfig(name="p120"), fit_budget=96,
                            collect_metrics=True)
    axes = (["uncertainty"], [0])
    ds = dict(datasets=["p120", "p200"])
    ck = lambda name, r: dict(checkpoint_dir=str(tmp_path / name), checkpoint_every=1,
                              max_rounds=r)
    j_full = j_sweep.run_grid(dataclasses.replace(jcfg, **ck("g_j", 3)), *axes, bundles=jb, **ds)
    t_full = t_sweep.run_grid(dataclasses.replace(tcfg, **ck("g_t", 3)), *axes, bundles=tb,
                              device="cpu", **ds)
    for tc, jc in zip(t_full.cells, j_full.cells, strict=True):
        assert (tc.dataset, tc.seed) == (jc.dataset, jc.seed)
        assert _rounds(tc.result) == _rounds(jc.result), tc.dataset
        _metrics_close(tc.result, jc.result)
        assert [r.n_unlabeled for r in tc.result.records][0] == int(tc.dataset[1:]) - 10
        serial = t_loop.run_experiment(_serial_cfg(tcfg, 0, dataset=tc.dataset),
                                       bundle=tb[tc.dataset], device="cpu")
        assert _key(tc.result) == _key(serial)
        assert torch.equal(tc.result.final_labeled_mask, serial.final_labeled_mask)
        # The watermark's two divisions are true divisions by the count of
        # valid rows (JAX's grid spelling); a serial run multiplies by the
        # f32 reciprocal of its constant row count: one ulp apart at most.
        for a, b in zip(tc.result.records, serial.records):
            for field, v in b.metrics.items():
                if field in ("labeled_frac", "pool_entropy"):
                    assert abs(a.metrics[field] - v) <= np.spacing(np.float32(v)), field
                else:
                    assert a.metrics[field] == v, field
        jser = j_loop.run_experiment(_serial_cfg(jcfg, 0, dataset=jc.dataset),
                                     bundle=jb[jc.dataset])
        assert _rounds(tc.result) == _rounds(jser)
    assert t_ckpt.grid_fingerprint(tcfg, ["uncertainty", "margin"], [0, 3], ["p120", "p200"],
                                   [10, 12]) == j_ckpt.grid_fingerprint(
        jcfg, ["uncertainty", "margin"], [0, 3], ["p120", "p200"], [10, 12])

    assert sorted(os.listdir(tmp_path / "g_j")) == ["gridstate_2.npz", "gridstate_3.npz"]
    assert _drop_last(tmp_path / "g_j", "gridstate") == 2
    resumed = t_sweep.run_grid(dataclasses.replace(tcfg, **ck("g_j", 1)), *axes, bundles=tb,
                               device="cpu", **ds)
    for tc, want in zip(resumed.cells, t_full.cells):
        assert _rounds(tc.result) == _rounds(want.result)
        assert torch.equal(tc.result.final_labeled_mask, want.result.final_labeled_mask)
    assert _drop_last(tmp_path / "g_t", "gridstate") == 2
    resumed = j_sweep.run_grid(dataclasses.replace(jcfg, **ck("g_t", 1)), *axes, bundles=jb, **ds)
    for jc, want in zip(resumed.cells, j_full.cells):
        assert _rounds(jc.result) == _rounds(want.result)
    with pytest.raises(ValueError, match="refusing to resume a different grid"):
        t_sweep.run_grid(dataclasses.replace(tcfg, **ck("g_t", 1)), ["margin"], [0],
                         bundles=tb, device="cpu", **ds)
