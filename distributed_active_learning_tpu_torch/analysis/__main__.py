"""CLI of the port's pre-flight:

    python -m distributed_active_learning_tpu_torch.analysis [--kinds chunk,serve_chunk] \
        [--json] [--fail-on error|warn|info] [--no-lint] [--no-audit]
    python -m distributed_active_learning_tpu_torch.analysis --costs|--memory \
        [--kinds chunk,serve_chunk] [--budget-table F] [--json] [--fail-on error]
    python -m distributed_active_learning_tpu_torch.analysis --list|--rules

With no mode it runs the program auditor over the programs
(``analysis/auditor.py``: each traced on the meta device, the rules of
``analysis/rules.py``) and the recompile-hazard lint over the port's
``runtime/``, ``serving/`` and ``strategies/`` (``analysis/lint.py``), and
exits 1 when a finding reaches ``--fail-on`` (the JAX package's CLI).
``--rules`` prints the program rules, the lint rules and the memory rules.
``--costs`` prints each program's counted FLOPs, bytes and peak footprint
(``analysis/roofline.py``), ``--memory`` prices each program's footprint and
its kernels' shared memory against the budget (``analysis/memory.py``;
the card's, or ``--budget-table``'s, or ``DAL_MEMORY_BUDGET``'s) and exits 1
when a finding reaches ``--fail-on``. The programs are the registry of
``analysis/programs.py`` at the widths ``chip_smoke.py`` drives, built on
the meta device: nothing is allocated or launched, on the CPU or the card.
"""

from __future__ import annotations

import argparse
import json
import sys


def _csv(value):
    return [v.strip() for v in value.split(",") if v.strip()] if value else None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_active_learning_tpu_torch.analysis",
        description="the port's pre-flight: the program audit and lint, program costs and "
        "the memory gate")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--kinds", type=_csv, default=None,
                    help="comma-separated program kinds (analysis.programs.KINDS; default all)")
    ap.add_argument("--fail-on", choices=["info", "warn", "error"], default="error",
                    help="exit 1 when a finding is at or above this severity (default error)")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the recompile-hazard lint (program audit only)")
    ap.add_argument("--no-audit", action="store_true",
                    help="skip the program audit (lint only; nothing is traced)")
    ap.add_argument("--costs", action="store_true",
                    help="count each program's FLOPs and bytes (its kernels at their declared "
                    "work) and price its peak footprint")
    ap.add_argument("--memory", action="store_true",
                    help="price each program's peak device footprint and its kernels' shared "
                    "memory a block against the budget")
    ap.add_argument("--budget-table", default=None, metavar="PATH",
                    help='JSON budget {"hbm_bytes": N, "smem_bytes": N} in place of the card\'s')
    ap.add_argument("--list", action="store_true", help="list the programs and exit")
    ap.add_argument("--rules", action="store_true", help="print the rule tables and exit")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from distributed_active_learning_tpu_torch.analysis import memory as memory_lib
    from distributed_active_learning_tpu_torch.analysis import programs as programs_lib
    from distributed_active_learning_tpu_torch.analysis import roofline as roofline_lib
    from distributed_active_learning_tpu_torch.analysis.report import Report

    if args.rules:
        from distributed_active_learning_tpu_torch.analysis import lint as lint_lib
        from distributed_active_learning_tpu_torch.analysis import rules as rules_lib

        print("program rules:")
        for rule_id, severity, desc in rules_lib.rule_table():
            print(f"  {rule_id:28s} [{severity}] {desc}")
        print("lint rules:")
        for rule_id, severity, desc in lint_lib.iter_rule_table():
            print(f"  {rule_id:28s} [{severity}] {desc}")
        print("memory rules:")
        for rule_id, (severity, desc) in memory_lib.MEMORY_RULES.items():
            print(f"  {rule_id:28s} [{severity}] {desc}")
        return 0
    unknown = sorted(set(args.kinds or ()) - set(programs_lib.KINDS))
    if unknown:
        raise SystemExit(f"unknown program kinds {unknown}; one of {programs_lib.KINDS}")
    specs = programs_lib.build_registry(kinds=args.kinds)
    if args.list:
        for spec in specs:
            print(spec.name)
        return 0
    if args.costs:
        table = roofline_lib.cost_table(specs)
        if args.json:
            print(json.dumps({"schema": 1, "costs": table}))
        else:
            print(roofline_lib.render_cost_table(table))
        return 0
    if args.memory:
        try:
            budget = memory_lib.budget_from_env_or(args.budget_table)
        except (OSError, ValueError) as e:
            raise SystemExit(f"budget table: {e}") from None
        table, findings = memory_lib.memory_table(specs, budget)
        if args.json:
            print(json.dumps({"schema": 1,
                              "memory": memory_lib.memory_section(table, findings, budget)}))
        else:
            print(memory_lib.render_memory_table(table, budget))
            for f in findings:
                print(str(f))
        return 1 if Report(findings=list(findings)).gate(args.fail_on) else 0
    return audit_and_lint(specs, args)


def audit_and_lint(specs, args) -> int:
    """The default mode: the program audit of ``specs`` and the lint, one
    report, exit 1 at ``--fail-on``."""
    from distributed_active_learning_tpu_torch.analysis import preflight

    report, _ = preflight(specs, audit=not args.no_audit, lint=not args.no_lint)
    print(report.to_json() if args.json else report.render_table())
    return 1 if report.gate(args.fail_on) else 0


if __name__ == "__main__":
    sys.exit(main())
