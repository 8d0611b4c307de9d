"""The port's bench prints one parseable JSON line per mode (``--device cpu``
at tiny sizes; score and density also under ``--kernel gather``) with the keys the JAX bench uses for the same legs, and the
port's ``run_pipelined`` schedules as the JAX one does (the scheduling facts
of ``tests/test_pipeline.py`` on a fake, host-only dispatch)."""

import contextlib
import io
import json

import numpy as np
import pytest

from distributed_active_learning_tpu_torch import bench
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


def test_bench_modes_print_one_json_line():
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

    rc, rnd = _line(["--mode", "round", "--rounds-per-launch", "2", *_TINY])
    assert rc == 0 and rnd["metric"] == "al_round_seconds"
    for key in ("round_seconds", "round_fit_seconds", "round_score_seconds",
                "scan_seconds_per_round", "per_round_driver_seconds_per_round",
                "scan_fusion_speedup", "chunk_first_call_seconds",
                "pipelined_seconds_per_round", "pipelined_serial_seconds_per_round",
                "touchdown_hidden_fraction", "fused_scan_seconds_per_round",
                "unfused_scan_seconds_per_round", "fused_round_speedup"):
        assert isinstance(rnd[key], float) and rnd[key] >= 0.0, key
    assert rnd["rounds_per_launch"] == 2
    assert rnd["serial_touchdown_hidden_fraction"] == 0.0  # depth 1 hides nothing
    assert 0.0 <= rnd["touchdown_hidden_fraction"] <= 1.0

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
