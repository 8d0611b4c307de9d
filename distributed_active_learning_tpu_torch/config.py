"""Experiment configuration dataclasses.

A copy of ``distributed_active_learning_tpu/config.py`` (the port imports
nothing of the JAX package): the same frozen dataclasses with the same field
names and defaults, so one ``dataclasses.asdict`` builds either package's
config. Fields whose feature is not ported yet are kept and refused at run
time by ``runtime.loop`` with the name of the slice that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """Random-forest base learner (``RandomForest.trainClassifier`` knobs in
    the reference: numTrees, maxDepth=4, maxBins=32, 'gini')."""

    n_trees: int = 10
    max_depth: int = 4
    max_bins: int = 32
    criterion: str = "gini"
    # Evaluation form: "gemm" is the plain path-matrix form
    # (ops/trees_gemm.py); "pallas" selects the hand-written leaf kernel
    # (ops/trees_pallas.py, csrc/forest_leaves.cu; features compare in bf16);
    # "gather" keeps the traversal form (ops/trees.py; f32 compares), which
    # every forest deeper than 10 takes.
    kernel: str = "gemm"
    # "host" fits scikit-learn's RandomForestClassifier on the labeled rows
    # (models/forest.py; scikit-learn is imported only there); "device" runs
    # the histogram trainer (ops/trees_train.py).
    fit: str = "host"
    fit_budget: Optional[int] = None
    node_budget: Optional[int] = None
    quantize: str = "none"
    seed: int = 0

    @property
    def resolved_node_budget(self) -> int:
        if self.node_budget is not None:
            return self.node_budget
        return 2 ** (self.max_depth + 1) - 1


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    """Query strategy: registry name, window (points queried per round),
    density weight ``beta`` and per-strategy options."""

    name: str = "uncertainty"
    window_size: int = 10
    beta: float = 1.0
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset selection and preprocessing (StandardScaler with ddof=1)."""

    name: str = "checkerboard2x2"
    path: Optional[str] = None
    standardize: bool = True
    scale_test_independently: Optional[bool] = None
    n_samples: Optional[int] = None
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Scenario-engine knobs (``scenarios/``): ``kind`` one of ``none``,
    ``noisy_oracle`` (``flip_prob``, ``abstain_prob``), ``cost_budget``
    (``cost_budget`` a round, costs in ``[1, 1 + cost_spread]``),
    ``rare_event`` (``rare_class``) and ``drift`` (``drift_kind``,
    ``drift_rate``); ``seed`` keys the scenario draws."""

    kind: str = "none"
    flip_prob: float = 0.0
    abstain_prob: float = 0.0
    cost_budget: float = 0.0
    cost_spread: float = 4.0
    rare_class: int = 1
    drift_kind: str = "mean_shift"
    drift_rate: float = 0.0
    seed: int = 0

    @property
    def active(self) -> bool:
        return self.kind != "none"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: pool rows over ``data``, trees over ``model``
    (``parallel/``)."""

    data: int = 1
    model: int = 1


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Streaming AL service knobs (``serving/``), the JAX package's fields and
    defaults.

    The service holds a slab-paged pool: capacity is allocated in fixed
    ``slab_rows``-row slabs (static shapes per capacity; growth is
    slab-at-a-time) and a dynamic fill watermark tracks how much of it holds
    real points, so per-arrival ingest never changes a program's shapes:
    arrivals never cause a graph capture. Ingest and scoring both run at fixed widths
    (``ingest_block`` / ``score_width``), padded per call, for the same
    reason.
    """

    slab_rows: int = 1024      # rows per slab (capacity growth quantum)
    ingest_block: int = 64     # static ingest write width (arrivals padded)
    score_width: int = 64      # static scoring batch width (queries padded)
    refit_rounds: int = 4      # AL rounds fused into one re-fit chunk launch
    # Drift-aware re-fit triggers (serving/drift.py), evaluated against the
    # last chunk's in-scan RoundMetrics baseline: a relative shift of the
    # serve-time prediction entropy or of the chunk's selection margin beyond
    # these thresholds dispatches a chunk instead of a fixed round cadence.
    drift_entropy_shift: float = 0.25
    drift_margin_shift: float = 0.5
    # Fresh (ingested, unlabeled) points required before a drift trigger may
    # fire — a re-fit with nothing new to label is wasted work.
    drift_min_fresh: int = 32
    # Staleness backstop: force a re-fit after this many scoring requests
    # without one (0 disables). The cadence-of-last-resort, not the trigger.
    max_staleness: int = 512
    # Pending score requests tolerated before an in-flight re-fit chunk's
    # touchdown is forced (the event loop otherwise polls non-blockingly).
    refit_poll_events: int = 64
    # Capacity precompile (serving/tenants.py): when the fill watermark
    # comes within ``precompile_headroom_slabs`` slabs of capacity, a
    # background thread allocates the NEXT capacity's slab and captures its
    # re-fit chunk as a CUDA graph (on the CPU: allocates and builds the
    # programs), so slab growth becomes a swap instead of a capture on the
    # request path — the ``slab_growth_compile`` p99 cause the serve bench
    # tags must vanish after warmup.
    precompile_ahead: bool = True
    precompile_headroom_slabs: float = 1.0
    # Frontend admission cap (serving/frontend.py): queued requests tolerated
    # per tenant before new submissions are refused with AdmissionError —
    # the backpressure signal concurrent clients actually observe.
    max_pending: int = 64
    # Per-tenant SLO class (serving/frontend.py): ``slo_weight`` is the
    # tenant's share of contended dispatch cycles under deficit weighted
    # round-robin — 1.0 (the default) serves the tenant every cycle exactly
    # like the pre-SLO fair rotation; 0.5 every other contended cycle.
    # ``slo_priority`` scales admission under load: a priority-p tenant's
    # effective queue cap is ``max_pending * (1 + p)``, so lower classes
    # shed load (AdmissionError) first.
    slo_weight: float = 1.0
    slo_priority: int = 0
    # Drift-aware bin-edge refresh (serving/tenants.py): the binning is
    # frozen at cold start; when the EMA fraction of ingested feature
    # values landing OUTSIDE the cold-start quantile edges exceeds
    # ``bin_refresh_out_frac`` (with at least ``drift_min_fresh`` fresh
    # points), the service re-quantiles the edges from the current slab,
    # re-codes the pool, rebuilds its fit/chunk programs against the new
    # edges, and bumps the forest fingerprint. In-distribution streams sit
    # near 2/max_bins out-of-range by construction, far under a typical
    # threshold of 0.35. <= 0 (the default) disables — the refresh is
    # opt-in, so services configured before it keep the frozen-edges
    # behavior and its jit-cache/latency profile byte-for-byte.
    bin_refresh_out_frac: float = 0.0
    # Live ops plane (runtime/obs.py): TCP port for the pull-based metrics
    # endpoint — /metrics (Prometheus text), /healthz (event-loop liveness +
    # last-touchdown age), /varz (full JSON snapshot), /flightz (flight-
    # recorder dump over HTTP). 0 (the default) = no listener; the CLI entry
    # points (serving.__main__, bench.py --mode serve-multi, run.py) honor
    # it / the --ops-port flag. The registry FEEDS are always on (cheap
    # host-side ints, bounded histograms); the port only gates the scrape.
    ops_port: int = 0
    # Per-tenant SLO objective (runtime/obs.py SLOTracker): a query is GOOD
    # when it succeeds AND answers within slo_latency_ms; the tracker keeps
    # the lifetime compliance ratio good/total and multi-window (1m/5m/1h)
    # burn rates bad_frac / (1 - slo_target) — the SRE-workbook alerting
    # form, surfaced as /metrics gauges, `slo` JSONL events, the service
    # summary, and the serve-multi bench's `slo_compliance` key. <= 0 (the
    # default) disables SLO accounting entirely.
    slo_latency_ms: float = 0.0
    slo_target: float = 0.99
    # Burn-rate-driven admission (serving/frontend.py): when the tenant's
    # 5-minute burn rate (SLOTracker — bad_frac / error budget; 1.0 = the
    # budget is being spent exactly at the sustainable rate) reaches this
    # threshold, NEW score submissions are shed at admission with
    # AdmissionError — the SLO is already lost for this window, so refusing
    # early keeps the doomed tenant's queue from delaying healthy ones.
    # Ingest is never shed (fresh data is how a burning tenant recovers).
    # <= 0 (the default) disables shedding; independent of the always-on
    # dispatch deprioritization, which scales a burning tenant's effective
    # slo_weight by 1 / (1 + burn) once burn >= 1.
    burn_shed_threshold: float = 0.0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Top-level AL experiment: dataset + model + strategy + loop controls."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    forest: ForestConfig = dataclasses.field(default_factory=ForestConfig)
    strategy: StrategyConfig = dataclasses.field(default_factory=StrategyConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    scenario: ScenarioConfig = dataclasses.field(default_factory=ScenarioConfig)
    n_start: int = 10
    label_budget: Optional[int] = None
    max_rounds: Optional[int] = None
    rounds_per_launch: int = 1
    pipeline_depth: int = 2
    sweep_seeds: int = 1
    stream_round_events: bool = False
    # Round megakernel (ops/round_fused.py): forest eval -> vote score ->
    # top-k in one pass over the pool; opt-in, refused with a named reason
    # where it cannot serve (runtime/loop.py _fused_round_reason).
    fused_round: bool = False
    seed: int = 0
    collect_metrics: bool = False
    roofline: bool = False
    log_every: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    results_path: Optional[str] = None


def from_dict(d: Mapping[str, Any]) -> ExperimentConfig:
    """Rebuild an :class:`ExperimentConfig` from ``dataclasses.asdict`` of
    this package's config or the JAX package's (the fields are the same)."""
    d = dict(d)
    sub = {
        "data": DataConfig, "forest": ForestConfig, "strategy": StrategyConfig,
        "mesh": MeshConfig, "scenario": ScenarioConfig,
    }
    for name, cls in sub.items():
        if name in d and isinstance(d[name], Mapping):
            d[name] = cls(**d[name])
    return ExperimentConfig(**d)
