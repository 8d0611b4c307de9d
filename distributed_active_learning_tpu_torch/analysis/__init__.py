"""Pre-flight and attribution of the port's programs.

- :mod:`.report`: findings and reports, rendered as JSON or a table (the
  JAX package's format);
- :mod:`.costs`: each kernel's declared work (operations and bytes) from
  the shapes its wrapper is given;
- :mod:`.roofline`: the card's peak tables, a program's cost counted under
  a dispatch mode (its kernels at their declared work) and the attribution
  of measured seconds to it (``run.py --roofline``, the bench's round-mode
  ``roofline`` section);
- :mod:`.memory`: the memory pre-flight, a program's peak device footprint
  priced on the meta device at its configured shapes, and the kernels'
  shared memory a block against the card's budget (``run.py --audit``,
  ``bench --audit``);
- :mod:`.programs`: the programs the port's drivers launch, built from an
  ``ExperimentConfig``;
- :mod:`.auditor` and :mod:`.rules`: the program auditor, the JAX
  package's program rules over a trace of the port's own program (its aten
  operations, kernel launches, collectives and carry, on the meta device);
- :mod:`.lint`: the recompile-hazard and host-concurrency lint over the
  port's driver code.

:func:`preflight` runs the three in their one order; ``run.py --audit``,
``bench --audit`` and the CLI call it. Entry point: ``python -m
distributed_active_learning_tpu_torch.analysis``.
"""

from distributed_active_learning_tpu_torch.analysis.report import (  # noqa: F401
    SEVERITIES,
    Finding,
    Report,
    severity_rank,
)


def preflight(specs, budget=None, audit: bool = True, lint: bool = True):
    """The pre-flight of a list of ``programs.ProgramSpec``: the program
    audit (:func:`.auditor.run_audit`), the lint over the port's driver code
    (:func:`.lint.lint_paths`), then, given a ``memory.MemoryBudget``, the
    memory pre-flight (:func:`.memory.memory_table`). Returns ``(report,
    table)``: one :class:`Report` of every finding, and the memory table
    (None without a budget)."""
    from distributed_active_learning_tpu_torch.analysis import lint as lint_lib
    from distributed_active_learning_tpu_torch.analysis import memory as memory_lib
    from distributed_active_learning_tpu_torch.analysis.auditor import run_audit

    report = run_audit(specs) if audit else Report()
    if lint:
        report.extend(lint_lib.lint_paths(lint_lib.default_lint_targets()))
    table = None
    if budget is not None:
        table, findings = memory_lib.memory_table(specs, budget)
        report.extend(findings)
    return report, table
