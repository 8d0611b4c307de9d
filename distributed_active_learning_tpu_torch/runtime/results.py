"""Per-round experiment records and the reference-format results log (the
port of ``runtime/results.py``; same line format, byte for byte)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class RoundRecord:
    round: int
    n_labeled: int
    n_unlabeled: int
    accuracy: float
    train_time: float = 0.0
    score_time: float = 0.0
    eval_time: float = 0.0
    total_time: float = 0.0
    metrics: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ExperimentResult:
    records: List[RoundRecord] = dataclasses.field(default_factory=list)
    # The pool's labeled mask after the last round ([n] bool, on the run's
    # device): the picks of every round together.
    final_labeled_mask: Optional[Any] = None

    def append(self, rec: RoundRecord) -> None:
        self.records.append(rec)

    @property
    def final_accuracy(self) -> Optional[float]:
        return self.records[-1].accuracy if self.records else None

    def to_reference_log(self) -> str:
        """The format of the reference's ``final_thesis/results/*.txt``::

            labeled =  10  unlabeled =  9990
            Iteration  1  -- accu =  85.05
        """
        lines = []
        for r in self.records:
            lines.append(f"labeled =  {r.n_labeled}  unlabeled =  {r.n_unlabeled}")
            lines.append(f"Iteration  {r.round}  -- accu =  {r.accuracy * 100:.2f}")
        return "\n".join(lines) + "\n"

    def save(self, path: str, fmt: str = "reference") -> None:
        if fmt != "reference":
            raise ValueError(f"only the reference log format is ported, got {fmt!r}")
        with open(path, "w") as f:
            f.write(self.to_reference_log())
