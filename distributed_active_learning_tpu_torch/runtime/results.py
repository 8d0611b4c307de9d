"""Per-round experiment records and the reference-format results log (the
port of ``runtime/results.py``; same line format, byte for byte, and
:func:`parse_reference_log` reads it back), the seed-stacked learning curves
of a sweep or grid (:func:`strategy_curves`, :func:`grid_curves`) and their
PNG figures (the ``plot_*`` functions, matplotlib; where it is missing, as
on the card's machine, each raises an ImportError naming it)."""

from __future__ import annotations

import dataclasses
import json
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

    def to_jsonl(self) -> str:
        """One JSON object a record (``run.py --json``)."""
        return "\n".join(json.dumps(dataclasses.asdict(r)) for r in self.records) + "\n"

    def save(self, path: str, fmt: str = "reference") -> None:
        """Write the records as the reference log (``fmt="reference"``) or
        as JSON lines (``"jsonl"``)."""
        if fmt not in ("reference", "jsonl"):
            raise ValueError(f"fmt must be 'reference' or 'jsonl', got {fmt!r}")
        text = self.to_reference_log() if fmt == "reference" else self.to_jsonl()
        with open(path, "w") as f:
            f.write(text)


def parse_reference_log(text: str) -> ExperimentResult:
    """The records of a reference-format results log (the inverse of
    :meth:`ExperimentResult.to_reference_log`, accuracies to its two
    decimals)."""
    result = ExperimentResult()
    n_labeled = n_unlabeled = None
    for line in text.splitlines():
        parts = line.split()
        if line.startswith("labeled"):
            n_labeled, n_unlabeled = int(parts[2]), int(parts[5])
        elif line.startswith("Iteration") and n_labeled is not None:
            result.append(RoundRecord(round=int(parts[1]), n_labeled=n_labeled,
                                      n_unlabeled=n_unlabeled,
                                      accuracy=float(parts[-1]) / 100.0))
    return result


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


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend, or an ImportError
    naming matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the plot_* functions need matplotlib, which is not installed "
                          "here (the records and logs need nothing)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, ax, plt, path: str, title: str, legend: bool = True) -> str:
    ax.set_xlabel("labeled points")
    ax.set_ylabel("test accuracy (%)")
    ax.grid(True, alpha=0.3)
    if legend:
        ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def _band(ax, axis, accs, label: str) -> None:
    """A mean +/- 1 sd band of ``accs [seeds, rounds]`` (fractions)."""
    accs = accs * 100
    mean, sd = accs.mean(axis=0), accs.std(axis=0)
    (line,) = ax.plot(axis, mean, marker="o", ms=3, label=f"{label} (n={accs.shape[0]})")
    ax.fill_between(axis, mean - sd, mean + sd, alpha=0.2, color=line.get_color())


def plot_seed_band(results, path: str, title: str = "", label: str = "sweep") -> str:
    """A PNG of the mean +/- 1 sd accuracy band over a sweep's per-seed
    results (the in-memory twin of :func:`plot_mean_band`)."""
    plt = _pyplot()
    axis, accs = strategy_curves(results)
    fig, ax = plt.subplots(figsize=(7.5, 4.5))
    _band(ax, axis, accs, label)
    return _finish(fig, ax, plt, path, title)


def plot_grid_bands(grid, path: str, title: str = "") -> str:
    """A PNG of the mean +/- 1 sd accuracy band of every (strategy,
    dataset) group of a grid run: the strategy-comparison figure from one
    launch stream."""
    plt = _pyplot()
    curves = grid_curves(grid)
    multi_ds = len({ds for _s, ds in curves}) > 1
    fig, ax = plt.subplots(figsize=(7.5, 4.5))
    for (strat, ds), (axis, accs) in sorted(curves.items()):
        _band(ax, axis, accs, f"{strat}/{ds}" if multi_ds else strat)
    return _finish(fig, ax, plt, path, title)


def plot_result(result: ExperimentResult, path: str, title: str = "") -> str:
    """A PNG of one run's curves (the reference's per-run matplotlib
    artifact, ``classes/active_learner.py:369-384``): accuracy against
    labeled points, and the time of each round."""
    plt = _pyplot()
    labels = [r.n_labeled for r in result.records]
    accs = [r.accuracy * 100 for r in result.records]
    times = [r.total_time for r in result.records]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ax1.plot(labels, accs, marker="o", ms=3)
    ax1.set_xlabel("labeled points")
    ax1.set_ylabel("test accuracy (%)")
    ax1.set_title("accuracy vs labels")
    ax1.grid(True, alpha=0.3)
    ax2.plot(range(1, len(times) + 1), times, marker="o", ms=3, color="tab:orange")
    ax2.set_xlabel("iteration")
    ax2.set_ylabel("round time (s)")
    ax2.set_title("per-iteration time")
    ax2.grid(True, alpha=0.3)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def _read_log(path: str) -> ExperimentResult:
    with open(path) as f:
        return parse_reference_log(f.read())


def plot_mean_band(named_groups, path: str, title: str = "") -> str:
    """A PNG of each group's mean +/- 1 sd accuracy band, from
    reference-format logs: ``[(label, [log_path, ...]), ...]``, one group a
    strategy's seeds on one labeled-count grid."""
    import numpy as np

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7.5, 4.5))
    for label, log_paths in named_groups:
        runs = [_read_log(p) for p in log_paths]
        axis = [r.n_labeled for r in runs[0].records]
        accs = np.array([[r.accuracy for r in run.records] for run in runs])
        _band(ax, axis, accs, label)
    return _finish(fig, ax, plt, path, title)


def plot_comparison(named_logs, path: str, title: str = "") -> str:
    """A PNG overlaying accuracy-vs-labels curves from reference-format
    logs: ``[(label, log_path), ...]`` (the reference's distUS-vs-distRAND
    evidence, which it drew by hand)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, log_path in named_logs:
        res = _read_log(log_path)
        ax.plot([r.n_labeled for r in res.records], [r.accuracy * 100 for r in res.records],
                marker="o", ms=3, label=label)
    return _finish(fig, ax, plt, path, title)
