"""The port's bench prints one parseable JSON line per mode (``--device cpu``
at tiny sizes; score and density also under ``--kernel gather``; lal with
its regressor fitted from the fixture, and from a forest file with and
without scikit-learn; sweep and grid, with and without the serial arm, the
grid with its scenario leg) with the keys the JAX bench uses for the same
legs; the scenario grid against the JAX package's ``run_grid`` and the serial
cells, its fingerprint and its checkpoints across both packages; and the
port's ``run_pipelined`` schedules as the JAX one does (the scheduling facts
of ``tests/test_pipeline.py`` on a fake, host-only dispatch). Also the CLI on
a file: ``--dataset credit_card_fraud --data-path`` prints the JAX CLI's log
line for line, and ``--plot`` and the five ``plot_*`` functions render PNGs
(each raising an ImportError naming matplotlib without it)."""

import contextlib
import io
import json

import numpy as np
import pytest

from distributed_active_learning_tpu_torch import bench
from distributed_active_learning_tpu_torch.runtime import telemetry
from distributed_active_learning_tpu_torch.runtime.pipeline import (
    ChunkDriveControl,
    ChunkExtras,
    run_pipelined,
)

_TINY = ["--device", "cpu", "--pool", "1500", "--trees", "6", "--depth", "4",
         "--train-rows", "200", "--window", "10", "--iters", "2"]


def _line(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    lines = out.getvalue().splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def _fake_chunk(state, k_active):
    new_state = state + k_active
    return new_state, ChunkExtras(
        n_labeled_after=np.int32(new_state), n_active=np.int32(k_active)
    ), {"rounds": list(range(state, new_state))}


def _drive(depth, total_rounds, k=3, may_dispatch=None, on_veto=None):
    calls, touched, done = [], [], {"rounds": 0}

    def dispatch(state, idx):
        calls.append(("dispatch", idx))
        return _fake_chunk(state, max(min(total_rounds - state, k), 0))

    def continue_after(n_labeled_after, n_active):
        done["rounds"] += n_active
        return n_active == k and done["rounds"] < total_rounds

    def touchdown(idx, nla, n_active, ys, out_state, wall):
        calls.append(("touchdown", idx))
        touched.extend(ys["rounds"])

    final, stats = run_pipelined(
        0, dispatch=dispatch, touchdown=touchdown, continue_after=continue_after,
        depth=depth, may_dispatch=may_dispatch, on_veto=on_veto)
    return calls, touched, final, stats


def _scenario_grid_matches_jax(tmp_path):
    """The scenario grid: the JAX package's scenario families (its
    ``tests/test_scenarios.py`` SCENARIOS and configuration) x entropy and
    density x seeds 0 and 1, 20 cells in one stream, metrics on. Each cell
    equals its serial ``run_experiment`` in the port (records, every metric,
    final mask). Against the JAX package's ``run_grid``: the entropy cells
    bit-equal (records; metrics but pool_entropy, which is held to
    ``POOL_ENTROPY_RTOL``), the density cells in their first round and their
    metric keys (a density pick can differ from JAX's at a tie at score 0,
    where the similarity mass clamps to 0 in one package and not in the other:
    ROADMAP queue 3; the mass agrees only to ``MASS_RTOL``). The scenario
    grid's fingerprint is JAX's, and its ``gridstate_`` files resume across
    both packages to the uninterrupted records."""
    import dataclasses
    import os

    import torch

    from distributed_active_learning_tpu import config as j_config
    from distributed_active_learning_tpu.runtime import checkpoint as j_ckpt
    from distributed_active_learning_tpu.runtime import sweep as j_sweep
    from distributed_active_learning_tpu_torch import config as t_config
    from distributed_active_learning_tpu_torch.runtime import checkpoint as t_ckpt
    from distributed_active_learning_tpu_torch.runtime import loop as t_loop
    from distributed_active_learning_tpu_torch.runtime import sweep as t_sweep
    from distributed_active_learning_tpu_torch.runtime.telemetry import POOL_ENTROPY_RTOL

    kinds = [dict(), dict(kind="noisy_oracle", flip_prob=0.2, abstain_prob=0.3),
             dict(kind="rare_event", rare_class=1), dict(kind="drift", drift_rate=0.3),
             dict(kind="cost_budget", cost_budget=6.0)]
    j_axis = [j_config.ScenarioConfig(**kw) for kw in kinds]
    t_axis = [t_config.ScenarioConfig(**kw) for kw in kinds]
    jcfg = j_config.ExperimentConfig(
        data=j_config.DataConfig(name="checkerboard2x2", n_samples=96, seed=2),
        forest=j_config.ForestConfig(n_trees=4, max_depth=3, fit="device", fit_budget=96),
        strategy=j_config.StrategyConfig(name="entropy", window_size=8), n_start=8,
        max_rounds=3, rounds_per_launch=2, log_every=0, collect_metrics=True)
    tcfg = t_config.from_dict(dataclasses.asdict(jcfg))
    axes = (["entropy", "density"], [0, 1])
    want = j_sweep.run_grid(jcfg, *axes, scenarios=j_axis)
    got = t_sweep.run_grid(tcfg, *axes, scenarios=t_axis, device="cpu")
    assert not got.serial_fallback and len(got.cells) == 20
    rounds = lambda res: [(r.round, r.n_labeled, r.accuracy) for r in res.records]
    for tc, jc in zip(got.cells, want.cells, strict=True):
        assert (tc.strategy, tc.seed, tc.scenario) == (jc.strategy, jc.seed, jc.scenario)
        scn = t_axis[[kw.get("kind", "none") for kw in kinds].index(tc.scenario)]
        serial = t_loop.run_experiment(dataclasses.replace(
            tcfg, seed=tc.seed, rounds_per_launch=1, scenario=scn,
            strategy=dataclasses.replace(tcfg.strategy, name=tc.strategy)), device="cpu")
        assert rounds(tc.result) == rounds(serial), (tc.strategy, tc.scenario, tc.seed)
        assert [r.metrics for r in tc.result.records] == [r.metrics for r in serial.records]
        assert torch.equal(tc.result.final_labeled_mask, serial.final_labeled_mask)
        assert [list(r.metrics) for r in tc.result.records] == [
            list(r.metrics) for r in jc.result.records]
        n = None if tc.strategy == "entropy" else 1
        assert rounds(tc.result)[:n] == rounds(jc.result)[:n], (tc.strategy, tc.scenario)
        if tc.strategy == "entropy":
            for a, b in zip(tc.result.records, jc.result.records):
                for field, v in b.metrics.items():
                    if field == "pool_entropy":
                        assert abs(a.metrics[field] - v) <= POOL_ENTROPY_RTOL * abs(v)
                    else:
                        assert a.metrics[field] == v, (tc.scenario, a.round, field)
    assert got.cell("entropy", "checkerboard2x2", 1, scenario="drift").scenario == "drift"
    assert len(got.results_for("density", scenario="cost_budget")) == 2
    names = [kw.get("kind", "none") for kw in kinds]
    fp_args = (["entropy"] * 5, [0, 1], ["checkerboard2x2"], [8] * 5)
    assert t_ckpt.grid_fingerprint(tcfg, *fp_args, scenarios=names) == j_ckpt.grid_fingerprint(
        jcfg, *fp_args, scenarios=names)
    assert t_ckpt.grid_fingerprint(tcfg, *fp_args) != t_ckpt.grid_fingerprint(
        tcfg, *fp_args, scenarios=names)

    # gridstate_ files across the packages: a noisy oracle and a cost budget
    # x entropy x 2 seeds, 3 rounds; each package's round-2 file resumed by
    # the other to the uninterrupted records.
    j_small, t_small = j_axis[1::3], t_axis[1::3]
    ck = lambda name, r: dict(checkpoint_dir=str(tmp_path / name), checkpoint_every=1,
                              max_rounds=r)
    j_full = j_sweep.run_grid(dataclasses.replace(jcfg, **ck("s_j", 3)), ["entropy"], [0, 1],
                              scenarios=j_small)
    t_full = t_sweep.run_grid(dataclasses.replace(tcfg, **ck("s_t", 3)), ["entropy"], [0, 1],
                              scenarios=t_small, device="cpu")
    assert [rounds(c.result) for c in t_full.cells] == [rounds(c.result) for c in j_full.cells]
    for name in ("s_j", "s_t"):
        os.remove(tmp_path / name / "gridstate_3.npz")
    resumed_t = t_sweep.run_grid(dataclasses.replace(tcfg, **ck("s_j", 1)), ["entropy"], [0, 1],
                                 scenarios=t_small, device="cpu")
    resumed_j = j_sweep.run_grid(dataclasses.replace(jcfg, **ck("s_t", 1)), ["entropy"], [0, 1],
                                 scenarios=j_small)
    for a, b, c in zip(resumed_t.cells, resumed_j.cells, t_full.cells, strict=True):
        assert rounds(a.result) == rounds(b.result) == rounds(c.result), c.scenario
        assert torch.equal(a.result.final_labeled_mask, c.result.final_labeled_mask)


def test_bench_modes_print_one_json_line(tmp_path):
    rc, score = _line(["--mode", "score", *_TINY])
    assert rc == 0 and score["metric"] == "acquisition_scores_per_sec"
    assert score["value"] > 0 and score["kernel"] == "pallas"
    assert score["wall_seconds_per_query"] > 0
    assert score["device"] == "cpu" and score["card"] is None and score["cpu_smoke_sizes"]

    rc, gather = _line(["--mode", "score", *_TINY, "--kernel", "gather"])
    assert rc == 0 and gather["kernel"] == "gather" and gather["value"] > 0
    for kernel in ("pallas", "gather"):
        rc, dens = _line(["--mode", "density", *_TINY, "--kernel", kernel])
        assert rc == 0 and dens["metric"] == "density_scores_per_sec", dens
        assert dens["value"] > 0 and dens["kernel"] == kernel
        assert dens["density_wall_scores_per_sec"] > 0
    rc, bad = _line(["--mode", "round", *_TINY, "--kernel", "gather"])
    assert rc == 1 and "carried by --mode score and density" in bad["error"]

    m_out, fr = str(tmp_path / "m.jsonl"), str(tmp_path / "flight.json")
    try:
        rc, rnd = _line(["--mode", "round", "--rounds-per-launch", "2", *_TINY,
                         "--metrics-out", m_out, "--flight-recorder", fr])
    finally:
        telemetry.uninstall_flight_recorder()
    assert rc == 0 and rnd["metric"] == "al_round_seconds"
    # The metrics stream of the depth-2 drive, and the flight recorder's
    # mode and timing marks, dumped at exit.
    with open(m_out) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds[0] == "meta" and "round" in kinds and "launch" in kinds, kinds
    assert rnd["flight_recorder"] == fr
    with open(fr) as f:
        flight = json.load(f)
    assert flight["reason"] == "exit"
    assert {"bench_start", "bench_timing_start", "bench_timing_end", "launch"} <= {
        e["kind"] for e in flight["events"]}
    for key in ("round_seconds", "round_fit_seconds", "round_score_seconds",
                "scan_seconds_per_round", "per_round_driver_seconds_per_round",
                "scan_fusion_speedup", "chunk_first_call_seconds",
                "pipelined_seconds_per_round", "pipelined_serial_seconds_per_round",
                "touchdown_hidden_fraction", "fused_scan_seconds_per_round",
                "unfused_scan_seconds_per_round", "fused_round_speedup"):
        assert isinstance(rnd[key], float) and rnd[key] >= 0.0, key
    assert rnd["rounds_per_launch"] == 2
    # The chunk computes its RoundMetrics, as the JAX bench's does; the
    # metrics-off chunk is timed beside it.
    assert rnd["scan_metrics_enabled"] is True
    assert rnd["scan_seconds_per_round_metrics_off"] > 0.0
    assert rnd["serial_touchdown_hidden_fraction"] == 0.0  # depth 1 hides nothing
    assert 0.0 <= rnd["touchdown_hidden_fraction"] <= 1.0

    # lal: the regressor fitted from the committed fixture, then read from a
    # forest file (the card's way: it has no scikit-learn), and without
    # scikit-learn the host-fit leg is reported skipped by name.
    lal_argv = ["--mode", "lal", *_TINY, "--lal-trees", "8", "--lal-pool", "150"]
    rc, lal = _line(lal_argv)
    assert rc == 0 and lal["metric"] == "lal_query_seconds", lal
    for key in ("lal_query_seconds", "lal_query_device_seconds", "lal_query_seconds_host_fit",
                "vs_baseline"):
        assert lal[key] > 0, key
    assert lal["lal_trees"] == 8
    from distributed_active_learning_tpu_torch.models import forest as forest_lib
    from distributed_active_learning_tpu_torch.models import forest_io

    path = str(tmp_path / "lal.npz")
    forest_io.save_forest(path, forest_lib.synthetic_forest(np.random.default_rng(0), 11, 8, 5))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(__import__("sys").modules, "sklearn", None)
        rc, lal = _line(lal_argv + ["--lal-model", path])
    assert rc == 0 and lal["lal_trees"] == 11 and lal["lal_query_seconds"] > 0, lal
    assert lal["lal_query_seconds_host_fit"] is None
    assert "scikit-learn" in lal["lal_host_fit_skipped"]

    # neural: one round of each stretch config (SmallCNN + entropy, encoder +
    # BatchBALD) at toy sizes, with the JAX bench's keys.
    rc, neural = _line(["--mode", "neural", *_TINY, "--neural-pool", "64", "--train-steps", "3",
                        "--mc-samples", "2"])
    assert rc == 0 and neural["cnn_round_seconds"] > 0, neural
    assert neural["transformer_batchbald_round_seconds"] > 0 and neural["neural_pool"] == 64

    # sweep and grid: the batched stream against the serial runs, with the
    # JAX bench's keys; the grid's scenario leg is reported skipped by name.
    batched = ["--sweep-pool", "200", "--trees", "4", "--depth", "3", "--rounds-per-launch", "2"]
    rc, sw = _line(["--mode", "sweep", *_TINY, *batched, "--sweep-experiments", "3"])
    assert rc == 0 and sw["metric"] == "sweep_experiments_rounds_per_second", sw
    assert (sw["sweep_experiments"], sw["sweep_rounds_per_launch"], sw["sweep_pool"]) == (3, 2, 200)
    for key in ("sweep_experiments_rounds_per_second", "serial_experiments_rounds_per_second",
                "sweep_speedup", "sweep_window"):
        assert sw[key] > 0, key
    rc, gr = _line(["--mode", "grid", *_TINY, *batched, "--grid-experiments", "2",
                    "--grid-strategies", "uncertainty,margin"])
    assert rc == 0 and gr["metric"] == "grid_cells_rounds_per_second", gr
    assert gr["grid_cells"] == 4 and gr["grid_strategies"] == ["uncertainty", "margin"]
    assert gr["grid_launches"] == 2 and gr["grid_rounds"] == 4
    assert gr["recompiles_after_warmup"] == gr["grid_recompiles_after_warmup"] == 0
    for key in ("grid_cells_rounds_per_second", "serial_cells_rounds_per_second", "grid_speedup",
                "grid_seconds"):
        assert gr[key] > 0, key
    # The scenario leg: the JAX bench's axis x entropy x the seeds, one stream.
    assert gr["scenario_axis"] == ["none", "noisy_oracle", "cost_budget", "rare_event", "drift"]
    assert gr["scenario_cells"] == 10 and gr["scenario_launches"] == 2
    assert gr["scenario_recompiles_after_warmup"] == 0
    assert gr["scenario_seconds"] > 0 and gr["scenario_cells_rounds_per_second"] > 0
    rc, gr = _line(["--mode", "grid", *_TINY, *batched, "--grid-experiments", "1",
                    "--grid-strategies", "uncertainty", "--no-baseline"])
    assert rc == 0 and gr["baseline_skipped"] == {"reason": "no_baseline_flag"}
    assert "grid_speedup" not in gr
    _cli_on_a_file_and_plots(tmp_path)


def _cli_on_a_file_and_plots(tmp_path):
    from distributed_active_learning_tpu import run as j_run
    from distributed_active_learning_tpu_torch import run as t_run
    from distributed_active_learning_tpu_torch.data import formats
    from distributed_active_learning_tpu_torch.runtime import results

    csv = str(tmp_path / "creditcard.csv")
    formats.write_credit_card_csv(csv, n_rows=1000, n_fraud=40, seed=3)
    argv = ["--dataset", "credit_card_fraud", "--data-path", csv, "--fit", "device", "--kernel",
            "pallas", "--fused-round", "--n-samples", "600", "--trees", "8", "--window", "15",
            "--rounds", "3", "--seed", "1", "--quiet"]
    logs = []
    for main, extra in ((j_run.main, []),
                        (t_run.main, ["--device", "cpu", "--plot", str(tmp_path / "run.png")])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert not main(argv + extra)
        logs.append(out.getvalue())
    assert logs[0] == logs[1] and logs[1].count("Iteration") == 3, logs
    # The plot functions: one run (the CLI's --plot above), a sweep's band,
    # a grid's bands, and bands and curves from reference-format logs.
    run = results.parse_reference_log(logs[1])
    assert run.to_reference_log() == logs[1]
    other = results.parse_reference_log(logs[1].replace("95.00", "93.50"))
    cells = [type("Cell", (), dict(strategy=s, dataset="cc", result=r))
             for s, r in (("uncertainty", run), ("uncertainty", other), ("random", other))]
    grid = type("Grid", (), dict(cells=cells))
    for i, r in enumerate((run, other)):
        r.save(str(tmp_path / f"log{i}.txt"))
    logs_ = [str(tmp_path / f"log{i}.txt") for i in range(2)]
    pngs = [str(tmp_path / "run.png"),
            results.plot_seed_band([run, other], str(tmp_path / "band.png")),
            results.plot_grid_bands(grid, str(tmp_path / "grid.png"), title="grid"),
            results.plot_mean_band([("us", logs_)], str(tmp_path / "mean.png")),
            results.plot_comparison([("a", logs_[0]), ("b", logs_[1])],
                                    str(tmp_path / "cmp.png"))]
    for png in pngs:
        with open(png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", png
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(__import__("sys").modules, "matplotlib", None)
        with pytest.raises(ImportError, match="matplotlib"):
            results.plot_result(run, str(tmp_path / "none.png"))

    _scenario_grid_matches_jax(tmp_path)

    rc, var = _line(["--mode", "variants", "--variants", "v0,v1,w12,r1,wf", *_TINY])
    assert rc == 0 and [r["variant"] for r in var["variants"]] == ["v0", "v1", "w12", "r1", "wf"]
    assert all(r["seconds"] > 0 and r["vote_agree"] == 1.0 for r in var["variants"])

    # A failure still prints one line, and the exit code says it failed.
    rc, bad = _line(["--mode", "variants", "--variants", "nope", *_TINY])
    assert rc == 1 and bad["metric"] == "bench_failed" and "nope" in bad["error"]
    rc, bad = _line(["--mode", "score", "--pool", "100", "--trees", "2"])
    if bad.get("metric") == "bench_failed":  # no card here: refused, not run on the CPU
        assert rc == 1 and "no CUDA device" in bad["error"]

    # Scheduling: depth 1 is the strict serial order.
    calls, touched, final, stats = _drive(depth=1, total_rounds=8)
    assert calls == [("dispatch", 0), ("touchdown", 0), ("dispatch", 1), ("touchdown", 1),
                     ("dispatch", 2), ("touchdown", 2)]
    assert touched == list(range(8))
    assert stats.overlap_seconds == 0.0 and stats.touchdown_hidden_fraction == 0.0
    # Depth 2 dispatches ahead of every touchdown and speculates exactly one chunk.
    calls, touched, final, stats = _drive(depth=2, total_rounds=6)
    assert calls == [("dispatch", 0), ("dispatch", 1), ("dispatch", 2), ("touchdown", 0),
                     ("touchdown", 1), ("touchdown", 2)]
    assert touched == list(range(6)) and final == 6
    _, _, _, stats = _drive(depth=2, total_rounds=30)
    assert 0.0 < stats.touchdown_hidden_fraction < 1.0 and stats.chunks == 11
    # A veto is counted once, with its index; none is recorded after the stop.
    vetoed = []
    calls, touched, final, stats = _drive(
        depth=2, total_rounds=9, may_dispatch=lambda idx: idx * 3 < 9, on_veto=vetoed.append)
    assert [i for kind, i in calls if kind == "dispatch"] == [0, 1, 2]
    assert vetoed == [3] and stats.vetoed == 1 and stats.chunks == 3 and final == 9
    with pytest.raises(ValueError, match="depth"):
        run_pipelined(0, dispatch=None, touchdown=None, continue_after=None, depth=0)

    # The chunked driver's veto arithmetic: the round quota and the label-cap lattice.
    ctl = ChunkDriveControl(chunk_size=3, window=15, label_cap=70, max_rounds=None, n_known=10)
    assert [ctl.veto_reason(i) for i in range(3)] == [None, None, "label_cap_lattice"]
    ctl = ChunkDriveControl(chunk_size=3, window=15, label_cap=300, max_rounds=5, n_known=10)
    assert [ctl.veto_reason(i) for i in range(3)] == [None, None, "max_rounds_bound"]
    assert ctl.continue_after(55, 3) and not ctl.continue_after(85, 2)
