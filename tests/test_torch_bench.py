"""The port's bench prints one parseable JSON line per mode (``--device cpu``
at tiny sizes; score and density also under ``--kernel gather``; lal with
its regressor fitted from the fixture, and from a forest file with and
without scikit-learn; sweep and grid, with and without the serial arm, the
grid with its scenario leg; serve, serve-multi and serve-fleet, the last
with spawned worker processes) with the keys the JAX bench uses for the
same legs; and the port's ``run_pipelined`` schedules as the JAX one does
(the scheduling facts of ``tests/test_pipeline.py`` on a fake, host-only
dispatch). The scenario grid against the JAX package's ``run_grid`` lives
in ``test_torch_scoring.py``, the CLI on a file and the plots in
``test_torch_data_fit.py`` (each file runs on one worker of the suite).

The CLI remainder and the pre-flight's surfaces too: ``--mode all`` under a
``--deadline`` names the modes it skipped; ``--audit`` carries the
``memory`` section; ``--profile-dir`` refuses the CPU (it times the card);
``--compare-to`` rides the port's copy of the comparison tool, whose
verdicts equal the repo's ``benches/compare_bench.py`` on one synthetic
pair of lines; ``run.py --budget N --json`` prints the JAX package's
``run.py`` records for the same flags (times aside) and ``--list`` its
registries; ``run.py --audit`` with a 1 MiB budget table refuses before the
first round, naming the overage; ``run.py --roofline`` writes a
``roofline`` event with the JAX package's keys (``indeterminate:
no-peak-table`` on the CPU); and ``python -m ...analysis`` lists, prints
its rules and prices."""

import contextlib
import io
import json
import re
import signal

import numpy as np
import pytest

from distributed_active_learning_tpu_torch import bench
from distributed_active_learning_tpu_torch.runtime import telemetry
from distributed_active_learning_tpu_torch.runtime.pipeline import (
    ChunkDriveControl,
    ChunkExtras,
    run_pipelined,
)
from tests.torch_threads import capped_torch_threads  # noqa: F401  (autouse)

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


def test_bench_modes_print_one_json_line(tmp_path, monkeypatch):
    rc, score = _line(["--mode", "score", *_TINY, "--audit"])
    assert rc == 0 and score["metric"] == "acquisition_scores_per_sec"
    audit = score["audit"]
    assert audit["counts"] == {"error": 0, "warn": 0, "info": 0}
    assert audit["memory"]["programs_priced"] == audit["programs_audited"] == 1
    assert audit["memory"]["max_peak_hbm_bytes"] > 0
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
    # The JAX bench's pod legs, with its keys, their recompile counts folded
    # into the headline one, their events in the metrics stream.
    for key in ("pod_select_shard_counts", "pod_select_per_shard_rows",
                "pod_select_seconds_by_shards", "pod_select_points_per_second",
                "pod_select_flat_ratio", "pod_recompiles_after_warmup",
                "pod_ingest_shard_counts", "pod_ingest_per_shard_rows", "pod_ingest_block_rows",
                "pod_ingest_seconds_by_shards", "pod_ingest_points_per_second",
                "pod_ingest_flat_ratio", "pod_ingest_recompiles_after_warmup",
                "pod_rebalance_seconds"):
        assert key in rnd, key
    assert rnd["pod_select_shard_counts"] == rnd["pod_ingest_shard_counts"] == [1, 2, 4, 8]
    assert rnd["recompiles_after_warmup"] == rnd["pod_recompiles_after_warmup"] == \
        rnd["pod_ingest_recompiles_after_warmup"] == 0
    assert len(set(rnd["pod_rebalance_fills"])) == 1  # the epochs balanced the skew
    assert {"pod_select", "pod_ingest", "rebalance"} <= set(kinds)

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
    _variants_failures_and_scheduling()
    _serve_modes()
    _cli_remainder(tmp_path, score, monkeypatch)


def _cli_remainder(tmp_path, score, monkeypatch):
    import importlib.util
    import os
    import sys

    from distributed_active_learning_tpu import run as j_run
    from distributed_active_learning_tpu_torch import run as t_run
    from distributed_active_learning_tpu_torch.analysis import __main__ as t_analysis
    from distributed_active_learning_tpu_torch.benches import compare_bench as t_cmp

    # --mode all under a deadline: what would overrun it is skipped by name,
    # and the line lands (here every mode's CPU estimate overruns 1 s).
    rc, every = _line(["--mode", "all", *_TINY, "--deadline", "1"])
    assert rc == 0 and every["metric"] == "none_completed_before_deadline", every
    assert [m["mode"] for m in every["modes_skipped"]] == list(bench.ALL_MODES)
    assert all(m["reason"] == "predicted_overrun" and m["estimated_mode_seconds"] > 1
               for m in every["modes_skipped"])
    # A mode that raises after score leaves score's keys on the line beside
    # the error; a SIGTERM unwinds through the line the same way.

    def boom(args, dev):
        raise RuntimeError("boom")

    def term(args, dev):
        assert signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, None)
        signal.raise_signal(signal.SIGTERM)

    handler = signal.getsignal(signal.SIGTERM)
    for fake, want_rc, want_error in ((boom, 1, "RuntimeError: boom"),
                                      (term, 0, f"BenchInterrupted: signal {signal.SIGTERM}")):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(bench, "ALL_MODES", ("score", "density"))
            mp.setitem(bench._MODES, "density", fake)
            rc, part = _line(["--mode", "all", *_TINY, "--deadline", "0"])
        assert rc == want_rc and part["error"] == want_error, part
        assert part["metric"] == score["metric"] and part["value"] > 0
        assert part["modes"] == {"score": {k: part[k] for k in ("metric", "value", "unit")}}
        assert part["wall_seconds_per_query"] > 0 and "density_scores_per_sec" not in part
        assert signal.getsignal(signal.SIGTERM) is handler
    rc, prof = _line(["--mode", "score", *_TINY, "--profile-dir", str(tmp_path / "prof")])
    assert rc == 1 and "the CPU has no device time" in prof["error"]
    # --compare-to: the port's copy gives the repo tool's verdicts.
    path = os.path.join(os.path.dirname(__file__), "..", "benches", "compare_bench.py")
    spec = importlib.util.spec_from_file_location("repo_compare_bench", path)
    repo_cmp = importlib.util.module_from_spec(spec)
    sys.modules["repo_compare_bench"] = repo_cmp
    spec.loader.exec_module(repo_cmp)
    base = {"metric": "al_round_seconds", "value": 100.0, "mfu": 0.1, "round_seconds": 1.0,
            "scan_seconds_per_round": 0.5, "recompiles_after_warmup": 0}
    cur = {**base, "value": 70.0, "round_seconds": 0.8, "recompiles_after_warmup": 1}
    assert t_cmp.compare_payloads(base, cur, baseline_name="b") == \
        repo_cmp.compare_payloads(base, cur, baseline_name="b")
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({**score, "value": score["value"] * 10}))
    rc, cmp_line = _line(["--mode", "score", *_TINY, "--compare-to", str(baseline)])
    assert rc == 0 and cmp_line["regression"]["verdict"].startswith("regression"), cmp_line

    # run.py: --budget/--json against the JAX package's run.py, --list.
    flags = ["--fit", "device", "--kernel", "pallas", "--n-samples", "300", "--trees", "8",
             "--window", "15", "--rounds", "4", "--seed", "1", "--budget", "40", "--json",
             "--quiet"]

    def records(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
        rows = [json.loads(line) for line in out.getvalue().splitlines()]
        return [{k: v for k, v in r.items() if not k.endswith("_time")} for r in rows]

    mine = records(t_run.main, ["--device", "cpu", *flags])
    assert mine == records(j_run.main, flags) and len(mine) == 2  # the budget stops it
    out = {}
    for name, main, argv in (("jax", j_run.main, ["--list"]),
                             ("port", t_run.main, ["--list"])):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert main(argv) == 0
        out[name] = buf.getvalue()
    assert out["port"] == out["jax"] and "deep strategies:" in out["port"]
    # --audit: a 1 MiB table refuses before the first round, naming the
    # overage; --roofline: the JAX package's event keys.
    small = ["--device", "cpu", "--fit", "device", "--kernel", "pallas", "--n-samples", "300",
             "--trees", "8", "--window", "15", "--rounds", "4", "--seed", "1"]

    def refused(hbm_bytes, extra=()):
        table.write_text(json.dumps({"hbm_bytes": hbm_bytes}))
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()) as so, contextlib.redirect_stderr(err):
            with pytest.raises(SystemExit, match="audit failed"):
                t_run.main([*small, *extra, "--audit", "--budget-table", str(table)])
        assert so.getvalue() == "" and "Iteration" not in err.getvalue()
        assert "hbm-over-budget" in err.getvalue() and "by " in err.getvalue(), err.getvalue()
        # The program audit and the lint ran first and found nothing.
        assert _error_rules(err.getvalue()) == {"hbm-over-budget"}, err.getvalue()
        return err.getvalue()

    table = tmp_path / "budget.json"
    refused(1 << 20)
    # A chunk runs as a CUDA graph: a budget above its eager peak but below
    # its resident inputs + captured pool refuses it, naming the graph.
    chunk = ("--rounds-per-launch", "2")
    eager, graph = (float(v) for v in re.search(
        r"eager peak ([\d.]+) MiB.*as a CUDA graph ([\d.]+) MiB", refused(1 << 20, chunk)).groups())
    assert graph > eager
    assert "the graph's footprint" in refused((eager + graph) / 2 * 2**20, chunk)
    # Each kind of run prices the program it launches, named for it: the
    # batched sweep, the grid of its exact cells, the scenario round, the
    # mesh at its shape (cells crossing a row), LAL with its regressor.
    kinds = {"sweep/uncertainty/seeds8": ("--sweep-seeds", "8", *chunk),
             "grid/uncertainty+margin/1x2": ("--strategies", "uncertainty,margin",
                                             "--sweep-seeds", "2", *chunk),
             "chunk/uncertainty/noisy_oracle": ("--scenario", "noisy_oracle", "--flip-prob",
                                                "0.1", *chunk),
             "chunk/entropy/cost_budget": ("--scenario", "cost_budget", "--cost-budget", "20",
                                           "--strategy", "entropy", *chunk),
             "chunk/uncertainty/mesh3x2": ("--mesh-data", "3", "--mesh-model", "2", *chunk),
             "chunk/lal": ("--strategy", "lal", "--strategy-option", "lal_trees=20", *chunk)}
    for name, extra in kinds.items():
        err = refused(1 << 20, extra)
        assert name in err and "memory-plan-unavailable" not in err, (name, err)
        assert "priced as one experiment" not in err, err
    # A budget above one experiment's price and below the sweep's refuses
    # the sweep, which holds 8 carries and one pool for the batch.
    from distributed_active_learning_tpu_torch.analysis import memory as t_memory
    from distributed_active_learning_tpu_torch.analysis import programs as t_programs
    from distributed_active_learning_tpu_torch.config import (
        DataConfig, ExperimentConfig, ForestConfig, StrategyConfig,
    )
    from distributed_active_learning_tpu_torch.data.datasets import get_dataset as t_dataset

    one_cfg = ExperimentConfig(  # the CLI's config of `small` + `chunk`
        data=DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=ForestConfig(n_trees=8, max_depth=4, kernel="pallas", fit="device"),
        strategy=StrategyConfig(name="uncertainty", window_size=15), max_rounds=4,
        rounds_per_launch=2, seed=1)
    data = t_dataset(one_cfg.data)
    shapes = [t_programs.ForestShapes(len(data.train_y), np.asarray(data.train_x).shape[1],
                                      len(data.test_y))]
    priced, _ = t_memory.memory_table(
        t_programs.specs_for_run(one_cfg, shapes) + t_programs.specs_for_run(
            one_cfg, shapes, n_seeds=8), t_memory.MemoryBudget(None, None, "none"))
    one, swept = (priced[k]["graph_hbm_bytes"] for k in ("chunk/uncertainty",
                                                         "sweep/uncertainty/seeds8"))
    assert swept > one, (one, swept)
    assert "sweep/uncertainty/seeds8" in refused((one + swept) / 2, kinds[
        "sweep/uncertainty/seeds8"])
    # --audit refuses a planted defect by its rule id, before the first
    # round: a .item() in the chunk body, an f64 op, the pool's mask
    # gathered whole on every shard of the mesh.
    from distributed_active_learning_tpu_torch.parallel import collectives
    from distributed_active_learning_tpu_torch.parallel.mesh import Sharded, Spread
    from distributed_active_learning_tpu_torch.runtime import loop as t_loop
    from distributed_active_learning_tpu_torch.runtime import state as t_state

    count, accuracy = t_state.labeled_count, t_loop._accuracy

    def read_back(state):
        n = count(state)
        n.item()
        return n

    def pool_gather(state):
        m = state.labeled_mask
        if isinstance(m, Sharded):
            collectives.owner_gather([r[0] for r in m.blocks], Spread(1, len(m.blocks), 1))
        return count(state)

    mesh = ("--mesh-data", "4", "--mesh-model", "2")
    for rule, attr, fn, extra in (
            ("host-callback-in-fast-path", "labeled_count", read_back, chunk),
            ("f64-aval", "_accuracy", lambda f, x, y: accuracy(f, x, y).double().float(), chunk),
            ("collective-in-shard-map", "labeled_count", pool_gather, mesh + chunk)):
        with monkeypatch.context() as mp:
            mp.setattr(t_loop if attr == "_accuracy" else t_state, attr, fn)
            err = io.StringIO()
            with contextlib.redirect_stdout(io.StringIO()) as so, contextlib.redirect_stderr(err):
                with pytest.raises(SystemExit, match="audit failed"):
                    t_run.main([*small, *extra, "--audit"])
        assert so.getvalue() == "" and "Iteration" not in err.getvalue()
        assert rule in _error_rules(err.getvalue()), (rule, err.getvalue())
    table.write_text(json.dumps({"hbm_bytes": 1 << 20}))
    m_out = tmp_path / "roof.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        assert t_run.main([*small, "--rounds-per-launch", "2", "--metrics-out", str(m_out),
                           "--roofline", "--quiet"]) == 0
    events = [json.loads(line) for line in m_out.read_text().splitlines()]
    roof = [e for e in events if e["kind"] == "roofline"]
    from distributed_active_learning_tpu.analysis import roofline as j_roof

    jax_keys = {"program", "calls", *j_roof.attribute(
        {"flops": 1.0, "bytes_accessed": 1.0, "flops_per_byte": 1.0}, 1.0,
        peak_flops_per_sec=1.0, peak_bytes_per_sec=1.0)}
    assert len(roof) == 1 and jax_keys <= set(roof[0]), roof
    assert roof[0]["bound"] == "indeterminate:no-peak-table" and roof[0]["flops"] > 0
    assert roof[0]["program"] == "chunk_scan" and roof[0]["calls"] == 2
    # The analysis CLI: the rule tables (every program rule and lint rule of
    # the JAX package's), the lint alone, the audit of a kind with the lint.
    from distributed_active_learning_tpu.analysis import lint as j_lint
    from distributed_active_learning_tpu.analysis import rules as j_rules

    for argv, want in ((["--list"], ["serve_chunk/8192"]),
                       (["--rules"], ["smem-over-budget", *j_rules.RULES, *j_lint.LINT_RULES])):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert t_analysis.main(argv) == 0
        assert all(w in buf.getvalue() for w in want), buf.getvalue()
    for argv in (["--no-audit", "--json", "--fail-on", "warn"],
                 ["--kinds", "eval", "--no-lint", "--json"]):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert t_analysis.main(argv) == 0
        payload = json.loads(buf.getvalue())
        assert payload["findings"] == [] and payload["programs_audited"] == (
            [] if "--no-audit" in argv else ["eval/uncertainty-fused"])
    with contextlib.redirect_stdout(io.StringIO()) as buf:  # the 1 MiB table
        assert t_analysis.main(["--memory", "--kinds", "serve_score", "--json",
                                "--budget-table", str(table)]) == 1
    section = json.loads(buf.getvalue())["memory"]
    assert section["programs_priced"] == 2 and section["counts"]["error"] == 1
    assert [(f["rule"], f["program"]) for f in section["findings"]] == [
        ("hbm-over-budget", "serve_score/291840")]


def _error_rules(table: str) -> set:
    """The rules of a report table's error rows (``Report.render_table``)."""
    return {line.split()[1] for line in table.splitlines() if line.startswith("error ")}


# The keys of the JAX bench's serve and serve-multi lines (bench.py).
_JAX_SERVE_KEYS = (
    "serve_qps", "serve_queries", "serve_p50_ms", "serve_p99_ms", "serve_scores_per_sec",
    "ingest_points_per_sec", "serve_warmup_seconds", "recompiles_after_warmup", "refits",
    "refit_rounds", "refit_reasons", "slab_growths", "slab_capacity", "pool_fill",
    "pool_labeled")
_JAX_SERVE_MULTI_KEYS = (
    "serve_multi_qps", "serve_multi_tenants", "serve_multi_queries", "serve_multi_p50_ms",
    "serve_multi_p99_ms", "serve_multi_tenant_p50_ms", "serve_multi_tenant_p99_ms",
    "serve_multi_worst_tenant_p99_ms", "serve_multi_scores_per_sec",
    "serve_multi_ingest_points_per_sec", "serve_multi_warmup_seconds",
    "serve_multi_batched_score_launches", "serve_multi_batched_refit_launches",
    "serve_multi_score_fallback_reasons", "serve_multi_refits", "serve_multi_refit_rounds",
    "serve_multi_slab_growths", "serve_multi_growths_precompiled", "serve_multi_precompiles",
    "serve_multi_precompile_errors", "recompiles_after_warmup",
    "serve_multi_recompiles_after_warmup", "serve_multi_growth_compile_events",
    "serve_multi_admission_rejections", "serve_multi_ingest_failures", "slo_compliance",
    "serve_multi_slo_per_tenant", "ops_scrapes", "ops_port", "serve_multi_tenant_summaries")


# The keys of the JAX bench's serve-fleet line (bench.py's bench_serve_fleet).
_JAX_SERVE_FLEET_KEYS = (
    "serve_fleet_qps", "serve_fleet_workers", "serve_fleet_worker_counts", "serve_fleet_tenants",
    "serve_fleet_queries", "serve_fleet_queries_served", "serve_fleet_qps_by_workers",
    "fleet_qps_scaling_ratio", "serve_fleet_p50_ms", "serve_fleet_p99_ms",
    "serve_fleet_warmup_seconds_by_workers", "serve_fleet_recompiles_after_warmup",
    "serve_fleet_worker_recompiles", "serve_fleet_worker_recompile_metric",
    "serve_fleet_score_fallback_reasons", "serve_fleet_shared_sig_fallbacks", "serve_fleet_groups",
    "serve_fleet_group_count", "serve_fleet_batched_score_launches", "serve_fleet_router",
    "serve_fleet_rerouted", "serve_fleet_unroutable", "serve_fleet_router_metrics_aggregated",
    "serve_fleet_router_healthy", "ops_port")


def _serve_modes():
    """``--mode serve``, ``--mode serve-multi`` and ``--mode serve-fleet``
    at CPU smoke sizes: the JAX bench's keys and the gates."""
    small = ["--device", "cpu", "--trees", "4"]
    rc, sv = _line(["--mode", "serve", *small, "--serve-queries", "60", "--serve-pool", "200"])
    assert rc == 0 and sv["metric"] == "serve_qps" and sv["value"] > 0, sv
    assert set(_JAX_SERVE_KEYS) <= set(sv) and sv["serve_queries"] == 60
    assert sv["recompiles_after_warmup"] == 0 and "entropy_shift" in sv["refit_reasons"]
    assert sv["slab_growths"] >= 1 and sv["refit_chunk_seconds_per_round"] > 0
    rc, sm = _line(["--mode", "serve-multi", *small, "--serve-queries", "160",
                    "--serve-pool", "900"])
    assert rc == 0 and sm["metric"] == "serve_multi_qps" and set(_JAX_SERVE_MULTI_KEYS) <= set(sm)
    assert sm["serve_multi_tenants"] == 4 and sm["serve_multi_kernel"] == "gemm"
    assert sm["serve_multi_recompiles_after_warmup"] == 0
    assert sm["serve_multi_growth_compile_events"] == 0
    assert sm["serve_multi_growths_precompiled"] >= 1 and sm["slo_compliance"] == 1.0
    assert sm["serve_multi_score_fallback_reasons"] == {} and sm["ops_scrapes"] >= 1
    # serve-fleet: spawned worker processes behind the router, the 1- and
    # 2-worker legs, with the JAX bench's keys and its hard zeros.
    rc, fl = _line(["--mode", "serve-fleet", "--device", "cpu", "--fleet-workers", "2",
                    "--serve-queries", "8"])
    assert rc == 0 and fl["metric"] == "serve_fleet_qps" and set(_JAX_SERVE_FLEET_KEYS) <= set(fl)
    assert fl["serve_fleet_worker_counts"] == [1, 2] and fl["serve_fleet_queries"] == 320
    assert {n: leg["served"] for n, leg in fl["serve_fleet_by_workers"].items()} == {
        "1": 320, "2": 320}
    assert fl["serve_fleet_by_workers"]["1"]["worker_recompile_metric"] == {"w0": 0}
    assert fl["serve_fleet_recompiles_after_warmup"] == 0
    assert fl["serve_fleet_worker_recompile_metric"] == {"w0": 0, "w1": 0}
    assert fl["serve_fleet_shared_sig_fallbacks"] == 0 and fl["serve_fleet_unroutable"] == 0
    assert fl["serve_fleet_rerouted"] == 0 and fl["serve_fleet_router_healthy"]
    assert fl["serve_fleet_router_metrics_aggregated"] and fl["serve_fleet_group_count"] == 2


def _variants_failures_and_scheduling():
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
