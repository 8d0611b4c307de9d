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
  ``ExperimentConfig``.

Entry point: ``python -m distributed_active_learning_tpu_torch.analysis``.
The JAX package's jaxpr passes (its auditor, lint and rules) check a traced
XLA program, which the port has none of; ROADMAP.md says what holds their
invariants here.
"""

from distributed_active_learning_tpu_torch.analysis.report import (  # noqa: F401
    SEVERITIES,
    Finding,
    Report,
    severity_rank,
)
