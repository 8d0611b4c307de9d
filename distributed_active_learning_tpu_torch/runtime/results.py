"""Per-round experiment records and the reference-format results log (the
port of ``runtime/results.py``; same line format, byte for byte), and the
seed-stacked learning curves of a sweep or grid (:func:`strategy_curves`,
:func:`grid_curves`). The ``plot_*`` helpers wait: the card's machine has no
matplotlib (ROADMAP)."""

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
    # A chunked run's overlap accounting (runtime.pipeline.PipelineStats) and,
    # on CUDA, its graph's counts (runtime.loop.GraphedChunk.stats: captures,
    # replays, pool bytes); None after a per-round run.
    pipeline_stats: Optional[Any] = None
    graph_stats: Optional[Dict[str, Any]] = None

    def append(self, rec: RoundRecord) -> None:
        self.records.append(rec)

    def extend_from_arrays(self, rounds, n_labeled, n_unlabeled, accuracy, total_time=None,
                           metrics: Optional[List[Dict[str, Any]]] = None) -> None:
        """Bulk append from stacked per-round arrays: the chunked driver's
        touchdown, where one launch returns K rounds of outputs and the host
        appends them at once. ``total_time`` (a scalar or one per round)
        lands in ``total_time`` with the per-phase splits zero: attributing
        phases inside a chunk would need the per-round host syncs the chunk
        exists to avoid. ``metrics`` (optional) is one plain dict per round,
        the chunk's RoundMetrics already converted
        (``telemetry.stacked_metrics_to_dicts``)."""
        n = len(rounds)
        times = total_time
        if times is None:
            times = [0.0] * n
        elif not hasattr(times, "__len__"):
            times = [float(times)] * n
        if metrics is not None and len(metrics) != n:
            raise ValueError(
                f"{len(metrics)} metric dicts for {n} rounds: the active-row filter must be "
                "applied to both before appending")
        for i in range(n):
            self.append(RoundRecord(
                round=int(rounds[i]),
                n_labeled=int(n_labeled[i]),
                n_unlabeled=int(n_unlabeled[i]),
                accuracy=float(accuracy[i]),
                total_time=float(times[i]),
                metrics=None if metrics is None else metrics[i],
            ))

    @classmethod
    def from_record_dicts(cls, records: List[Dict[str, Any]]) -> "ExperimentResult":
        """Rebuild the records of a checkpoint's ``records_json`` (either
        package's), dropping keys this :class:`RoundRecord` does not know: a
        field a newer writer added is observability, never loop state, so
        dropping it is lossless for the resume."""
        known = {f.name for f in dataclasses.fields(RoundRecord)}
        return cls(records=[RoundRecord(**{k: v for k, v in r.items() if k in known})
                            for r in records])

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


def strategy_curves(results):
    """Per-seed accuracy curves stacked on their shared labeled-count axis:
    ``(axis, accs [seeds, rounds])`` from one :class:`ExperimentResult` per
    seed (a sweep's output), the aggregation the paper's mean +/- sd
    learning curves are built from. Seeds whose labeled counts differ
    (other windows or stops) share no axis and raise."""
    import numpy as np

    if not results:
        raise ValueError("strategy_curves needs at least one result")
    axis = [r.n_labeled for r in results[0].records]
    for res in results[1:]:
        other = [r.n_labeled for r in res.records]
        if other != axis:
            raise ValueError(
                f"seed curves disagree on the labeled-count grid ({other[:3]}... vs "
                f"{axis[:3]}...): stack only same-window, same-stop runs")
    return axis, np.array([[r.accuracy for r in res.records] for res in results])


def grid_curves(grid):
    """``{(strategy, dataset): (axis, accs [seeds, rounds])}`` of a grid
    run (anything with ``.cells`` carrying ``strategy``, ``dataset`` and
    ``result``), each group through :func:`strategy_curves`."""
    groups = {}
    for cell in grid.cells:
        groups.setdefault((cell.strategy, cell.dataset), []).append(cell.result)
    return {key: strategy_curves(results) for key, results in groups.items()}
