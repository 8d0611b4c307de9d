"""Experiment configuration dataclasses.

A copy of ``distributed_active_learning_tpu/config.py`` (the port imports
nothing of the JAX package): the same frozen dataclasses with the same field
names and defaults, so one ``dataclasses.asdict`` builds either package's
config. ``ServeConfig`` waits for the serving slice. Fields whose feature is
not ported yet are kept and refused at run time by ``runtime.loop`` with the
name of the slice that brings them.
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
    """Scenario engine knobs; only ``kind="none"`` is ported."""

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
