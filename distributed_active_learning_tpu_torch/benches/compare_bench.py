"""Bench-regression sentinel: diff two bench JSONs with per-metric thresholds.

The port's own copy of the repo's ``benches/compare_bench.py`` (stdlib only,
so the port reads nothing of the JAX package's tree): the same metrics,
thresholds and verdicts, for the port's bench lines. ``python -m
distributed_active_learning_tpu_torch.bench --compare-to BASELINE.json``
runs it in process; on its own:

    python -m distributed_active_learning_tpu_torch.benches.compare_bench \
        baseline.json current.json [--warn-only] [--json]

Inputs are either raw ``python bench.py`` payloads or the driver-captured
``BENCH_r*.json`` wrappers (the ``parsed`` key is unwrapped; a wrapper whose
``parsed`` is null — BENCH_r05's rc-124 death — is a load error, named as
such). Each known metric compares under its own direction and relative
threshold; counters (``recompiles_after_warmup``) regress on ANY increase
and are HARD by default — ``--warn-only`` downgrades timing regressions to
warnings (rc 0) but hard regressions still fail, which is how the tier-1
smoke gate runs it on CPU (timing there is noise; a silent recompile is
not).

Exit codes: 0 ok/improved (or soft regressions under --warn-only); non-zero
for regressions and load/usage errors. ``--json`` prints the machine verdict;
``--trajectory A.json B.json ...`` appends a cross-round trend table.

stdlib-only on purpose: it must run anywhere a JSON landed, without jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One comparable metric: which way is good, and how much drift in the
    bad direction fires. ``kind='counter'`` ignores ``rel_tol`` — any move
    in the bad direction fires (recompiles are events, not noise)."""

    key: str
    direction: str        # "higher" | "lower" is better
    rel_tol: float = 0.2  # fractional change tolerated in the bad direction
    kind: str = "timing"  # "timing" | "counter"
    hard: bool = False    # fails even under --warn-only


#: The sentinel's vocabulary. Thresholds are deliberately loose for wall
#: times (rig noise; the CPU CI runners doubly so) and tight for ratios the
#: architecture guarantees (MFU, recompiles). --threshold KEY=FRACTION
#: overrides per run.
DEFAULT_SPECS: List[MetricSpec] = [
    # headline scoring throughput + its roofline position
    MetricSpec("value", "higher", 0.20),
    MetricSpec("mfu", "higher", 0.20),
    MetricSpec("achieved_tflops", "higher", 0.20),
    MetricSpec("density_scores_per_sec", "higher", 0.25),
    # round mode
    MetricSpec("round_seconds", "lower", 0.30),
    MetricSpec("round_device_seconds", "lower", 0.30),
    MetricSpec("scan_seconds_per_round", "lower", 0.30),
    MetricSpec("per_round_driver_seconds_per_round", "lower", 0.35),
    MetricSpec("scan_fusion_speedup", "higher", 0.30),
    # the round megakernel: fused vs unfused chunk, same inputs
    MetricSpec("fused_scan_seconds_per_round", "lower", 0.30),
    MetricSpec("fused_round_speedup", "higher", 0.25),
    # pod-sharded selection (per-shard megakernel + ring-merged top-k):
    # throughput at the widest shard count, and the flat-in-shard-count
    # wall ratio (t_maxS / t_1; interpret-mode CPU smoke is noisy — loose)
    MetricSpec("pod_select_points_per_second", "higher", 0.30),
    MetricSpec("pod_select_flat_ratio", "lower", 0.50),
    # pod-sharded ingest (per-shard donation appends + the window-sized
    # rebalance epoch): same flat-in-shard-count story as pod_select
    MetricSpec("pod_ingest_points_per_second", "higher", 0.30),
    MetricSpec("pod_ingest_flat_ratio", "lower", 0.50),
    MetricSpec("pod_rebalance_seconds", "lower", 0.50),
    MetricSpec("pipelined_seconds_per_round", "lower", 0.30),
    MetricSpec("touchdown_hidden_fraction", "higher", 0.50),
    # sweep / grid / serve / lal / neural
    MetricSpec("sweep_experiments_rounds_per_second", "higher", 0.30),
    MetricSpec("sweep_speedup", "higher", 0.30),
    MetricSpec("grid_cells_rounds_per_second", "higher", 0.30),
    MetricSpec("grid_speedup", "higher", 0.30),
    # scenario-axis grid smoke (scenarios/; bench.py bench_grid scenario leg)
    MetricSpec("scenario_cells_rounds_per_second", "higher", 0.30),
    MetricSpec("serve_qps", "higher", 0.30),
    MetricSpec("serve_scores_per_sec", "higher", 0.30),
    MetricSpec("serve_p50_ms", "lower", 0.40),
    MetricSpec("serve_p99_ms", "lower", 0.50),
    MetricSpec("ingest_points_per_sec", "higher", 0.30),
    # multi-tenant serving: aggregate qps, the worst tenant's p99 at
    # 50% (the noisy-neighbor ceiling), and ingest under contention
    MetricSpec("serve_multi_qps", "higher", 0.30),
    MetricSpec("serve_multi_p50_ms", "lower", 0.40),
    MetricSpec("serve_multi_worst_tenant_p99_ms", "lower", 0.50),
    MetricSpec("serve_multi_ingest_points_per_sec", "higher", 0.30),
    # shared-nothing fleet: router-path qps at max workers, the
    # 1 -> N scaling ratio the mode exists to measure (loose — CPU CI
    # runners share cores with the workers), and the per-query tail over
    # the binary keep-alive wire
    MetricSpec("serve_fleet_qps", "higher", 0.30),
    MetricSpec("fleet_qps_scaling_ratio", "higher", 0.50),
    MetricSpec("serve_fleet_p99_ms", "lower", 0.50),
    MetricSpec("lal_query_seconds", "lower", 0.30),
    MetricSpec("lal_query_device_seconds", "lower", 0.30),
    MetricSpec("cnn_round_seconds", "lower", 0.40),
    MetricSpec("transformer_batchbald_round_seconds", "lower", 0.40),
    # architectural counters: any increase is a fired invariant, not noise
    MetricSpec("recompiles_after_warmup", "lower", 0.0, kind="counter", hard=True),
    # grid's namespaced twin: survives the --mode all merge where serve's
    # bare counter overwrites grid's (bench.py bench_grid)
    MetricSpec(
        "grid_recompiles_after_warmup", "lower", 0.0, kind="counter", hard=True
    ),
    # round mode's namespaced twin (same --mode all merge hazard)
    MetricSpec(
        "fused_round_recompiles_after_warmup", "lower", 0.0, kind="counter",
        hard=True,
    ),
    # the pod-sharded selection leg's twin: any executable-cache growth
    # across its interleaved shard-count reps is an architectural regression
    MetricSpec(
        "pod_recompiles_after_warmup", "lower", 0.0, kind="counter",
        hard=True,
    ),
    # the sharded data-path twin: ingest closures and the rebalance epoch
    # must hold one executable each across every shard-count leg
    MetricSpec(
        "pod_ingest_recompiles_after_warmup", "lower", 0.0, kind="counter",
        hard=True,
    ),
    # serve-multi's namespaced twin, plus the AOT-precompile acceptance gate:
    # any post-warmup query paying a slab-growth compile is an architectural
    # regression (the p99 spike of a compile on the query path), never noise
    MetricSpec(
        "scenario_recompiles_after_warmup", "lower", 0.0, kind="counter",
        hard=True,
    ),
    MetricSpec(
        "serve_multi_recompiles_after_warmup", "lower", 0.0, kind="counter",
        hard=True,
    ),
    MetricSpec(
        "serve_multi_growth_compile_events", "lower", 0.0, kind="counter",
        hard=True,
    ),
    # fleet twins: a post-warmup recompile on ANY worker, or a resident
    # tenant falling off the grouped stacked path on a multi-tenant worker,
    # is an architectural regression — never CPU-runner noise
    MetricSpec(
        "serve_fleet_recompiles_after_warmup", "lower", 0.0, kind="counter",
        hard=True,
    ),
    MetricSpec(
        "serve_fleet_shared_sig_fallbacks", "lower", 0.0, kind="counter",
        hard=True,
    ),
    # live ops plane: SLO compliance is an architectural ratio, not
    # rig noise — the serve-multi smoke objective is deliberately generous
    # (10s at target 0.95), so a >5% drop means queries stopped finishing:
    # hard. (Accounting that produces NO ratio is refused inside
    # bench_serve_multi itself — a null here would structurally land under
    # "skipped", since one-sided keys must skip for other modes' payloads.)
    # ops_scrapes only proves the pull path worked mid-flight; its rate
    # scales with wall time, so the threshold is loose and soft.
    MetricSpec("slo_compliance", "higher", 0.05, hard=True),
    MetricSpec("ops_scrapes", "higher", 0.90),
    MetricSpec("chunk_jit_cache_entries", "lower", 0.0, kind="counter"),
    # the audit surface itself: a payload that audited FEWER programs than
    # its baseline means the registry silently shrank (a kind dropped, a
    # program build broken into a skip) — caught here even if the hand-maintained
    # CI floor assert lags behind. Lifted from the nested `audit` section
    # by compare_payloads; any decrease fires, hard.
    MetricSpec(
        "programs_audited", "higher", 0.0, kind="counter", hard=True
    ),
]

#: "value" is mode-dependent; it only compares when both payloads agree on
#: what it measures, under that metric's own direction.
VALUE_DIRECTIONS = {
    "acquisition_scores_per_sec": "higher",
    "density_scores_per_sec": "higher",
    "sweep_experiments_rounds_per_second": "higher",
    "grid_cells_rounds_per_second": "higher",
    "serve_qps": "higher",
    "serve_multi_qps": "higher",
    "serve_fleet_qps": "higher",
    "al_round_seconds": "lower",
    "lal_query_seconds": "lower",
    "neural_round_seconds": "lower",
}


def load_payload(path: str) -> dict:
    """Read a bench JSON: a raw payload, a JSONL tail, or a driver
    ``BENCH_r*.json`` wrapper (unwrapped via its ``parsed`` key). A wrapper
    with ``parsed: null`` is the r05 failure shape — a named load error."""
    with open(path) as f:
        text = f.read().strip()
    try:
        doc = json.loads(text)
    except ValueError:
        # maybe a log with the JSON on its last non-empty line
        lines = [ln for ln in text.splitlines() if ln.strip()]
        try:
            doc = json.loads(lines[-1]) if lines else {}
        except ValueError:
            raise SystemExit(
                f"{path}: neither the file nor its last line parses as JSON "
                "— not a bench payload"
            ) from None
    if isinstance(doc, dict) and "parsed" in doc and ("rc" in doc or "cmd" in doc):
        if doc["parsed"] is None:
            raise SystemExit(
                f"{path}: driver wrapper holds no parseable bench payload "
                f"(rc={doc.get('rc')}) — the run died before printing JSON; "
                "nothing to compare"
            )
        return doc["parsed"]
    if not isinstance(doc, dict):
        raise SystemExit(f"{path}: not a bench payload (top level is not an object)")
    return doc


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else None


def _spec_table(
    thresholds: Optional[Dict[str, float]] = None,
    extra_hard: Optional[List[str]] = None,
) -> List[MetricSpec]:
    specs = []
    for s in DEFAULT_SPECS:
        tol = (thresholds or {}).get(s.key, s.rel_tol)
        hard = s.hard or s.key in (extra_hard or [])
        specs.append(dataclasses.replace(s, rel_tol=tol, hard=hard))
    return specs


def compare_payloads(
    baseline: dict,
    current: dict,
    thresholds: Optional[Dict[str, float]] = None,
    extra_hard: Optional[List[str]] = None,
    baseline_name: str = "baseline",
) -> dict:
    """Diff two payloads; returns the JSON verdict document.

    Findings cover every metric present (numerically) in BOTH payloads;
    one-sided metrics are listed under ``skipped`` so a vanished key (a mode
    that stopped running) is visible rather than silently uncompared.
    """
    findings, skipped, notes = [], [], []
    # bench payloads nest the audit verdict under "audit" (bench.py
    # _audit_gate); lift its counter to the top level so the spec table —
    # which reads flat keys — can compare it. Copies, never mutates the
    # caller's dicts.
    lifted = []
    for payload in (baseline, current):
        p = dict(payload)
        audit = p.get("audit")
        if (
            isinstance(audit, dict)
            and isinstance(audit.get("programs_audited"), int)
            and "programs_audited" not in p
        ):
            p["programs_audited"] = audit["programs_audited"]
        lifted.append(p)
    baseline, current = lifted
    if bool(baseline.get("cpu_smoke_sizes")) != bool(current.get("cpu_smoke_sizes")):
        notes.append(
            "size tables differ (cpu_smoke_sizes mismatch): one side ran "
            "smoke shapes, the other rig shapes — treat timing diffs as "
            "incomparable"
        )
    for flag_side, payload in (("baseline", baseline), ("current", current)):
        if payload.get("degraded_rig"):
            notes.append(
                f"{flag_side} run flagged degraded_rig — its numbers may "
                "reflect the rig, not the code"
            )
    for spec in _spec_table(thresholds, extra_hard):
        b, c = _num(baseline.get(spec.key)), _num(current.get(spec.key))
        direction = spec.direction
        if spec.key == "value":
            bm, cm = baseline.get("metric"), current.get("metric")
            if bm != cm:
                skipped.append({"metric": "value", "reason": f"metric differs ({bm} vs {cm})"})
                continue
            direction = VALUE_DIRECTIONS.get(bm, "higher")
        if b is None and c is None:
            continue
        if b is None or c is None:
            skipped.append({
                "metric": spec.key,
                "reason": f"missing in {'baseline' if b is None else 'current'}",
            })
            continue
        if spec.kind == "counter":
            bad = c > b if direction == "lower" else c < b
            rel = None if b == 0 else (c - b) / abs(b)
            status = "regression" if bad else ("ok" if c == b else "improvement")
        else:
            if b == 0:
                skipped.append({"metric": spec.key, "reason": "baseline is zero"})
                continue
            rel = (c - b) / abs(b)
            worse = rel < -spec.rel_tol if direction == "higher" else rel > spec.rel_tol
            better = rel > spec.rel_tol if direction == "higher" else rel < -spec.rel_tol
            status = "regression" if worse else ("improvement" if better else "ok")
        findings.append({
            "metric": spec.key if spec.key != "value" else f"value({current.get('metric')})",
            "baseline": b,
            "current": c,
            "change_pct": round(rel * 100, 1) if rel is not None else None,
            "threshold_pct": (
                round(spec.rel_tol * 100, 1) if spec.kind == "timing"
                else "any-increase" if direction == "lower" else "any-decrease"
            ),
            "direction": f"{direction}-is-better",
            "status": status,
            "hard": spec.hard,
        })
    regressions = [f for f in findings if f["status"] == "regression"]
    hard_regressions = [f for f in regressions if f["hard"]]
    improvements = [f for f in findings if f["status"] == "improvement"]
    if regressions:
        # the verdict NAMES the worst offender: most threshold-normalized
        # exceedance first, hard counters always outrank soft timings
        def _badness(f):
            pct, thr = f["change_pct"], f["threshold_pct"]
            over = abs(pct) / thr if isinstance(thr, (int, float)) and thr else float("inf")
            return (f["hard"], over)

        worst = max(regressions, key=_badness)
        verdict = f"regression:{worst['metric']}"
    elif improvements and not regressions:
        verdict = "improved"
    else:
        verdict = "ok"
    return {
        "schema": 1,
        "baseline": baseline_name,
        "verdict": verdict,
        "regressions": [f["metric"] for f in regressions],
        "hard_regressions": [f["metric"] for f in hard_regressions],
        "improvements": [f["metric"] for f in improvements],
        "notes": notes,
        "findings": findings,
        "skipped": skipped,
    }


def render(report: dict) -> str:
    lines = []
    for note in report["notes"]:
        lines.append(f"note: {note}")
    for f in report["findings"]:
        tag = {"regression": "REGRESSION", "improvement": "improved  ",
               "ok": "ok        "}[f["status"]]
        hard = " [hard]" if f["hard"] and f["status"] == "regression" else ""
        pct = f"{f['change_pct']:+.1f}%" if f["change_pct"] is not None else "n/a"
        thr = (
            f"{f['threshold_pct']}%" if isinstance(f["threshold_pct"], (int, float))
            else f["threshold_pct"]
        )
        lines.append(
            f"{tag}{hard} {f['metric']}: {f['baseline']} -> {f['current']} "
            f"({pct}; allowed {thr}, {f['direction']})"
        )
    for s in report["skipped"]:
        lines.append(f"skipped    {s['metric']}: {s['reason']}")
    lines.append(
        f"verdict: {report['verdict']} "
        f"({len(report['regressions'])} regressions "
        f"[{len(report['hard_regressions'])} hard], "
        f"{len(report['improvements'])} improvements)"
    )
    return "\n".join(lines)


def render_trajectory(paths: List[str]) -> str:
    """Cross-round trend of the headline metrics over BENCH_r*-style files
    (rows in the given order; unparseable artifacts show as dead rows rather
    than disappearing)."""
    cols = ("file", "metric", "value", "mfu", "round_seconds", "serve_p99_ms")
    rows = []
    for path in paths:
        try:
            p = load_payload(path)
            rows.append([
                path.rsplit("/", 1)[-1], str(p.get("metric", "?")),
                str(p.get("value")), str(p.get("mfu")),
                str(p.get("round_seconds")), str(p.get("serve_p99_ms")),
            ])
        except (SystemExit, OSError, ValueError) as e:
            rows.append([path.rsplit("/", 1)[-1], f"(unparseable: {e})", "", "", "", ""])
    widths = [max(len(cols[i]), *(len(r[i]) for r in rows)) for i in range(len(cols))]

    def _row(cells):
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths))

    return "\n".join(
        [_row(cols), _row(["-" * w for w in widths])] + [_row(r) for r in rows]
    )


def _parse_threshold(pair: str):
    if "=" not in pair:
        raise argparse.ArgumentTypeError(f"--threshold needs KEY=FRACTION, got {pair!r}")
    k, v = pair.split("=", 1)
    return k, float(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Diff two bench JSONs with per-metric regression thresholds"
    )
    ap.add_argument("baseline", help="baseline bench JSON (raw or BENCH_r* wrapper)")
    ap.add_argument("current", help="fresh bench JSON to judge")
    ap.add_argument("--json", action="store_true", help="machine-readable verdict")
    ap.add_argument(
        "--warn-only", action="store_true",
        help="soft (timing) regressions exit 0 with a warning; HARD metrics "
        "(recompiles_after_warmup, --hard additions) still exit 1 — the CI "
        "setting for noisy CPU runners",
    )
    ap.add_argument(
        "--hard", action="append", default=[], metavar="KEY",
        help="treat KEY as a hard metric (repeatable)",
    )
    ap.add_argument(
        "--threshold", action="append", default=[], metavar="KEY=FRACTION",
        type=_parse_threshold,
        help="override a metric's relative threshold, e.g. mfu=0.1",
    )
    ap.add_argument(
        "--trajectory", nargs="*", default=None, metavar="PATH",
        help="also print a trend table over these bench artifacts "
        "(e.g. BENCH_r0*.json)",
    )
    args = ap.parse_args(argv)

    report = compare_payloads(
        load_payload(args.baseline),
        load_payload(args.current),
        thresholds=dict(args.threshold),
        extra_hard=args.hard,
        baseline_name=args.baseline,
    )
    if args.json:
        print(json.dumps(report))
    else:
        print(render(report))
    if args.trajectory:
        print("\n== trajectory ==")
        print(render_trajectory(args.trajectory))

    if report["hard_regressions"]:
        return 1
    if report["regressions"]:
        if args.warn_only:
            print(
                f"warning: soft regressions under --warn-only: "
                f"{', '.join(report['regressions'])}",
                file=sys.stderr,
            )
            return 0
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
