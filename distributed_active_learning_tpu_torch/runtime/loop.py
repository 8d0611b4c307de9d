"""The AL driver loop (the port of ``runtime/loop.py``): the per-round branch
and the chunked branch.

Each round: fit the forest on the labeled window on the device
(``ops/trees_train.py``) or on the host with scikit-learn
(``models/forest.py``, then ``forest_eval.for_kernel`` and placement on the
device), score the pool and take the masked top-k (or run the round
megakernel, ``fused_round``), reveal, and measure test accuracy. A device
fit gives the path-matrix form (``kernel`` "gemm" or "pallas", depth <= 10)
or the gather form (``kernel="gather"``, or any depth > 10). With
``ForestConfig.quantize`` ("bf16" or "int8") the fit stores thresholds and
leaf values narrow before the forest leaves it, and every evaluation form
widens them where it reads them (K1, K2 and K3 in their own bodies). A pool
of more than two classes fits a :class:`~..ops.trees_multi.MultiForest`, one
value plane per class; the ``lal`` strategy scores the pool with the LAL
regressor its options name (``models/lal_training.py``), held fixed for the
run.
The PRNG stream, the fit, the picks and the records equal the JAX package's
bit for bit on the same configuration (``tests/test_torch_loop.py``).

With ``ExperimentConfig.mesh`` of ``data x model > 1`` the pool's rows
shard over ``data`` and the trees over ``model`` (``parallel/``): the pool is
padded to the data axis, every fit is sharded by trees, and the round runs
per shard (:func:`~..parallel.kernels.make_sharded_round_fn`). The records
and the final mask equal the single-device run's.

With ``rounds_per_launch = K > 1`` the run is chunked
(:func:`make_chunk_fn`): K rounds per launch, each a masked no-op once the
label cap or the round quota is reached, driven by
``runtime/pipeline.py::run_pipelined`` with up to ``pipeline_depth`` chunks
in flight. On CUDA a chunk is one CUDA graph (:class:`GraphedChunk`),
captured at the first call and replayed by every later one; on the CPU the
same body runs eagerly. Records and the final mask equal the per-round run's.

The host fit re-enters the host every round, so it always takes the
per-round driver, whatever ``rounds_per_launch`` says (as in the JAX
package).

Telemetry and checkpoints (``runtime/telemetry.py``,
``runtime/checkpoint.py``): with ``collect_metrics`` or a
:class:`~.telemetry.MetricsWriter` every round computes a
:class:`~.telemetry.RoundMetrics` on the device, the chunked driver as the
chunk's sixth y inside its graph; the writer gets one ``round`` event a
round, one ``launch`` event a chunk, transfer counters and memory gauges.
With ``checkpoint_dir`` and ``checkpoint_every`` a run resumes from the
newest ``alstate_<round>.npz`` (either package's) and writes one every
``checkpoint_every`` rounds, at chunk boundaries in the chunked driver.

The batched drivers (``runtime/sweep.py``: sweeps and grids) run the padded
round (:func:`make_padded_round_fn`: selection at the widest window, each
experiment's own window revealed), the fit body with the edges an argument
(:func:`_device_fit_core`) and the masked accuracy
(:func:`_accuracy_masked`), and capture their chunks with the same
:class:`GraphedChunk`.

Scenarios (``scenarios/``, ``ExperimentConfig.scenario``): a noisy oracle
(flips applied to the oracle after the start state is drawn; an abstaining
reveal from a third split of the round key), a cost budget (the greedy
knapsack over a per-point cost vector), a rare class (``rare_recall`` in the
metrics) and a drifting test set (the accuracy of round r measured on
``drift_apply(test_x, r - 1)``), in both drivers, each run equal to the JAX
package's. A scenario needs the device fit and refuses the fused round, as
in the JAX package.

Not ported yet, and refused with a ``NotImplementedError`` that names the
slice bringing them: under a mesh the chunked driver (and so sweeps and
grids), round metrics, scenarios, ``kernel`` "gemm" and "gather", depths
past 10, the host fit and the density and lal strategies; roofline
attribution. What the JAX package refuses of quantized storage
(:func:`_validate_quantize`) the port refuses with the same reasons.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import ExperimentConfig
from distributed_active_learning_tpu_torch.data.datasets import DataBundle, get_dataset
from distributed_active_learning_tpu_torch.device import resolve_device, synchronize
from distributed_active_learning_tpu_torch.ops import forest_eval
from distributed_active_learning_tpu_torch.ops.topk import (
    NEG_INF,
    POS_INF,
    knapsack_top_k,
    select_bottom_k,
    select_top_k,
)
from distributed_active_learning_tpu_torch.ops.xla_f32 import row_sum
from distributed_active_learning_tpu_torch.parallel.mesh import Sharded, gather
from distributed_active_learning_tpu_torch.runtime import state as state_lib
from distributed_active_learning_tpu_torch.runtime.debugger import Debugger
from distributed_active_learning_tpu_torch.runtime.pipeline import _map_leaves
from distributed_active_learning_tpu_torch.runtime.results import ExperimentResult, RoundRecord
from distributed_active_learning_tpu_torch.strategies import Strategy, StrategyAux, get_strategy


def _round_core(
    strategy: Strategy,
    window_size: int,
    with_metrics: bool,
    n_classes: int,
    forest: forest_eval.Forest,
    state: state_lib.PoolState,
    aux: StrategyAux,
    fused: bool = False,
    window=None,
    scenario=None,
    costs=None,
    emit_rare: bool = False,
    emit_cost: bool = False,
):
    """One AL round: split the key, score + select (or the fused round),
    reveal, and with ``with_metrics`` the round's
    :class:`~.telemetry.RoundMetrics`. The key is split even when the round
    is fused, so the carried stream is the unfused round's.

    With metrics the pool's leaf values are computed once
    (:func:`~..ops.forest_eval.evaluated`) and read by both the score and
    the pool entropy: the JAX package gets the same sharing from XLA, which
    merges the two identical evaluations of one program.

    ``window`` (a 0-d int tensor <= ``window_size``, the padded round of a
    sweep or grid) reveals only the first ``window`` picks of the top
    ``window_size`` selection: the selection is sorted, so they are exactly
    the top ``window`` selection. The picks past it are neutralized as a
    short window's sentinels are (values to -inf or +inf, indices onto the
    first pick), so the metrics see what a run at that window sees.

    ``scenario`` (an active :class:`~..config.ScenarioConfig`, or None) is
    the scenario engine's hook, as in the JAX package: ``cost_budget`` takes
    the greedy knapsack (``ops.topk.knapsack_top_k``) over ``costs`` instead
    of the top-k, its unaffordable picks neutralized like sentinels and the
    round's spend summed over the picks finally kept; ``noisy_oracle`` with
    ``abstain_prob > 0`` splits the key three ways and reveals through the
    abstain draw of the third key (the two-way split is untouched
    otherwise); ``rare_event`` (or ``emit_rare``) adds ``rare_recall`` and
    ``cost_budget`` (or ``emit_cost``) adds ``cost_spent`` to the metrics.
    The emit flags give a mixed-scenario grid one set of metric fields
    across its groups. ``scenario=None`` is the clean round."""
    scn_active = scenario is not None and scenario.active
    abstain = scenario.abstain_prob if scn_active and scenario.kind == "noisy_oracle" else 0.0
    if abstain > 0.0:
        keys = prng.split(state.key, 3)
        key, k_score, k_abstain = keys[..., 0, :], keys[..., 1, :], keys[..., 2, :]
    else:
        keys = prng.split(state.key)
        key, k_score, k_abstain = keys[0], keys[1], None
    state = state.replace(key=key)
    unlabeled = state.unlabeled_mask
    spent = cost_keep = None
    if fused:
        from distributed_active_learning_tpu_torch.ops import round_fused

        vals, picked = round_fused.fused_score_select(
            forest, state.x, unlabeled, strategy.name, window_size
        )
        scores = None
    else:
        if with_metrics:
            forest = forest_eval.evaluated(forest, state.x)
        scores = strategy.score(forest, state, k_score, aux)
        unlabeled = gather(unlabeled)  # a mesh's global select runs on its first device
        if scn_active and scenario.kind == "cost_budget":
            vals, picked, cost_keep, spent = knapsack_top_k(
                scores, costs, unlabeled, window_size, scenario.cost_budget)
        elif strategy.higher_is_better:
            vals, picked = select_top_k(scores, unlabeled, window_size)
        else:
            vals, picked = select_bottom_k(scores, unlabeled, window_size)
    keep = None
    if window is not None:
        keep = torch.arange(window_size, device=picked.device) < window
    if cost_keep is not None:
        keep = cost_keep if keep is None else keep & cost_keep
        # Spend over the picks finally kept: under a padded window the
        # knapsack ran at the pad width, and a pick past a cell's own window
        # is never revealed, so it must not count (one formula for serial
        # and grid keeps cost_spent equal between them).
        spent = row_sum(torch.where(keep, costs[picked], 0.0)[None])[0]
    if keep is not None:
        vals = torch.where(keep, vals, NEG_INF if strategy.higher_is_better else POS_INF)
        picked = torch.where(keep, picked, picked[0])
    if keep is None and k_abstain is None:
        new_state = state_lib.reveal(state, picked)
    else:
        if keep is None:
            keep = torch.ones(picked.shape, dtype=torch.bool, device=picked.device)
        new_state = state_lib.reveal_masked(state, picked, keep, abstain_key=k_abstain,
                                            abstain_prob=abstain)
    if not with_metrics:
        return new_state, picked, scores
    from distributed_active_learning_tpu_torch.runtime import telemetry

    rm = telemetry.compute_round_metrics(
        forest, state, picked, vals, scores,
        higher_is_better=strategy.higher_is_better, n_classes=n_classes,
    )
    if emit_rare or (scn_active and scenario.kind == "rare_event"):
        from distributed_active_learning_tpu_torch.scenarios.engine import rare_recall

        rm = rm._replace(rare_recall=rare_recall(
            new_state.labeled_mask, state.oracle_y, state.valid_mask,
            scenario.rare_class if scn_active else 1))
    if emit_cost or (scn_active and scenario.kind == "cost_budget"):
        rm = rm._replace(cost_spent=spent if spent is not None else torch.zeros(
            (), dtype=torch.float32, device=picked.device))
    return new_state, picked, scores, rm


def make_round_fn(strategy: Strategy, window_size: int, with_metrics: bool = False,
                  n_classes: int = 2, fused: bool = False, scenario=None):
    """The AL round ``round_fn(forest, state, aux) -> (new_state, picked,
    scores)``; with ``with_metrics`` a fourth output, the round's
    :class:`~.telemetry.RoundMetrics` (both drivers run this same body, so
    their metrics agree bit for bit). ``fused`` routes score + select
    through the round megakernel (``scores`` is then None); it cannot
    compute metrics, which reduce the full score vector the megakernel never
    materializes. ``scenario`` runs the scenario round (:func:`_round_core`);
    a ``cost_budget`` scenario appends the per-point cost vector to the
    signature, ``round_fn(forest, state, aux, costs)``."""
    if fused and with_metrics:
        raise ValueError(
            "fused_round cannot compute RoundMetrics: the metrics reductions "
            "consume the full score vector the megakernel avoids "
            "materializing; drop collect_metrics/--metrics-out or fused_round"
        )

    def round_fn(forest, state, aux, costs=None):
        return _round_core(strategy, window_size, with_metrics, n_classes, forest, state, aux,
                           fused=fused, scenario=scenario, costs=costs)

    return round_fn


def make_padded_round_fn(strategy: Strategy, window_pad: int, with_metrics: bool = False,
                         n_classes: int = 2, scenario=None, emit_rare: bool = False,
                         emit_cost: bool = False):
    """:func:`make_round_fn` with a per-call reveal width: ``round_fn(forest,
    state, aux, window[, costs])`` selects at ``window_pad`` and reveals the
    first ``window`` picks (a 0-d int tensor). A batched sweep runs it per
    experiment, so experiments of other windows share one program; at
    ``window == window_pad`` it is :func:`make_round_fn`'s round bit for
    bit. It is never fused: the JAX package's padded round has no fused
    form. ``scenario`` and the emit flags as :func:`_round_core`."""

    def round_fn(forest, state, aux, window, costs=None):
        return _round_core(strategy, window_pad, with_metrics, n_classes, forest, state, aux,
                           window=window, scenario=scenario, costs=costs,
                           emit_rare=emit_rare, emit_cost=emit_cost)

    return round_fn


def _fused_round_reason(cfg: ExperimentConfig, want_metrics: bool, n_classes: int) -> Optional[str]:
    """Why this config cannot take the round megakernel (None = it can); the
    same named refusals as the JAX package."""
    from distributed_active_learning_tpu_torch.ops import round_fused

    scn = cfg.scenario
    if scn is not None and scn.active:
        return (
            f"scenario {scn.kind!r} perturbs the round body (probabilistic "
            "reveal / knapsack selection / drifted eval); the megakernel "
            "fuses the clean eval -> score -> top-k chain only — a fused "
            "scenario spelling is a named ROADMAP follow-up"
        )
    if not round_fused.supports(cfg.strategy.name):
        return (
            f"strategy {cfg.strategy.name!r} is not a pure vote-fraction "
            f"score; fused: {sorted(round_fused.FUSED_STRATEGIES)}"
        )
    if cfg.forest.fit != "device":
        return "host fit re-enters the host every round; use --fit device"
    if cfg.forest.kernel not in ("gemm", "pallas"):
        return (
            f"kernel {cfg.forest.kernel!r} has no fused round; use 'gemm' "
            "(XLA stream) or 'pallas' (megakernel)"
        )
    if cfg.forest.max_depth > forest_eval._GEMM_MAX_DEPTH:
        return (
            f"max_depth {cfg.forest.max_depth} exceeds the path-matrix "
            f"budget ({forest_eval._GEMM_MAX_DEPTH}); the fit would emit a "
            "gather-form forest the fused round cannot evaluate"
        )
    if n_classes > 2:
        return "fused round scores binary vote fractions; pool is multiclass"
    if cfg.strategy.window_size > 2048:
        return (
            f"window {cfg.strategy.window_size} exceeds the fused per-tile "
            "top-k width (2048); the streaming merge keeps k candidates "
            "per row tile"
        )
    if want_metrics:
        return (
            "RoundMetrics consume the full score vector the megakernel "
            "avoids materializing; drop --metrics-out/collect_metrics"
        )
    return None


# Where what a mesh does not carry yet is queued.
_MESH_SLICE = "the mesh-and-pod slice (ROADMAP queue 1, \"Mesh and pod\")"


def _not_ported(cfg: ExperimentConfig, metrics, batched: Optional[str] = None,
                scenario_axis: bool = False) -> None:
    """Refuse what this slice does not carry, naming the slice that will.
    ``batched`` ("sweep" or "grid") adds the batched drivers' refusal under
    a mesh (their chunk is the chunk under a mesh); ``scenario_axis`` is a
    grid's active scenario axis, which a mesh refuses as an active
    ``cfg.scenario`` is."""
    mesh = cfg.mesh.data * cfg.mesh.model > 1
    scenario_on = (cfg.scenario is not None and cfg.scenario.active) or scenario_axis
    refusals = [
        (mesh and scenario_on,
         "a scenario under a device mesh (the per-shard reveal and flip_mask_block of "
         "noisy_oracle, the knapsack, drift and rare-recall plumbing on sharded pools) "
         f"comes with {_MESH_SLICE}, item 8"),
        (batched is not None and mesh,
         f"a {batched} under a device mesh runs its chunk under the mesh, which needs "
         "constrain_forest (the fit sharded by trees inside the chunk); it comes with "
         f"{_MESH_SLICE}, item 8"),
    ]
    refusals += [
        (cfg.rounds_per_launch > 1 and mesh,
         "rounds_per_launch > 1 under a device mesh needs constrain_forest "
         "(the fit sharded by trees inside the chunk); it comes with "
         f"{_MESH_SLICE}"),
        (mesh and cfg.forest.kernel == "gemm",
         "kernel 'gemm' under a device mesh (GSPMD-partitioned plain XLA in "
         "the JAX package, no kernel) is not ported yet; use kernel 'pallas'"),
        (mesh and (cfg.forest.kernel == "gather"
                   or cfg.forest.max_depth > forest_eval._GEMM_MAX_DEPTH),
         "the gather form (kernel 'gather', or max_depth > "
         f"{forest_eval._GEMM_MAX_DEPTH}) under a device mesh comes with {_MESH_SLICE}"),
        (mesh and cfg.forest.fit == "host",
         f"the host fit under a device mesh comes with {_MESH_SLICE}; use fit='device'"),
        (mesh and cfg.strategy.name == "density",
         "the density strategy under a device mesh (sharded_similarity_mass) "
         f"comes with {_MESH_SLICE}"),
        (mesh and cfg.strategy.name == "lal",
         f"the lal strategy under a device mesh comes with {_MESH_SLICE}"),
        (mesh and (metrics is not None or cfg.collect_metrics),
         "RoundMetrics under a device mesh (the metrics reductions over the "
         f"sharded pool) come with {_MESH_SLICE}; per-round records and "
         "checkpoints do run on the mesh"),
        (bool(cfg.roofline) and metrics is not None,
         "roofline attribution (--roofline) comes with the pre-flight slice "
         "(ROADMAP queue 1, \"Pre-flight equivalents\")"),
    ]
    for refused, why in refusals:
        if refused:
            raise NotImplementedError(why)


def _validate_quantize(cfg: ExperimentConfig) -> None:
    """Quantized storage needs the device fit (bf16-snapped bin-edge
    thresholds are what make bf16 storage lossless) and a path-matrix
    kernel form (the dequantizing eval bodies live in trees_gemm and the
    kernels K1, K2 and K3): the JAX package's refusals and reasons."""
    from distributed_active_learning_tpu_torch.models.forest import VALID_QUANTIZE_MODES

    q = cfg.forest.quantize
    if q not in VALID_QUANTIZE_MODES:
        raise ValueError(f"unknown ForestConfig.quantize {q!r}; one of {VALID_QUANTIZE_MODES}")
    if q == "none":
        return
    if cfg.forest.fit != "device":
        raise ValueError(
            "quantized forest storage requires the device fit (host-fit "
            "sklearn midpoints are not bf16-snapped bin edges, so bf16 "
            "threshold storage would silently move decision boundaries); "
            "use --fit device or quantize='none'"
        )
    if cfg.forest.kernel not in ("gemm", "pallas"):
        raise ValueError(
            f"quantized storage applies to the path-matrix kernels, not "
            f"{cfg.forest.kernel!r}; use kernel='gemm' or 'pallas'"
        )
    if cfg.forest.max_depth > forest_eval._GEMM_MAX_DEPTH:
        raise ValueError(
            f"max_depth {cfg.forest.max_depth} exceeds the path-matrix "
            f"budget ({forest_eval._GEMM_MAX_DEPTH}); quantized storage "
            "has no gather-form dequantizer"
        )


def _accuracy(forest, test_x, test_y: torch.Tensor) -> torch.Tensor:
    """Test accuracy on the device (``uncertainty_sampling.py:79-83``): the
    most probable class of a multiclass forest, else P(class 1) > 0.5; on a
    mesh ``test_x`` is the test set placed on every shard."""
    from distributed_active_learning_tpu_torch.ops import trees_multi
    from distributed_active_learning_tpu_torch.ops.xla_f32 import div_const

    if trees_multi.is_multi(forest):
        pred = trees_multi.predict_class(forest, test_x)
    else:
        pred = (forest_eval.proba(forest, test_x) > 0.5).to(torch.int32)
    return div_const((pred == test_y).to(torch.float32).sum(), test_y.shape[0])


def _accuracy_masked(forest, test_x, test_y: torch.Tensor, test_n: torch.Tensor) -> torch.Tensor:
    """:func:`_accuracy` over the first ``test_n`` rows (a 0-d int tensor) of
    a padded test set: a grid pads its datasets' test sets to one width, and
    the padding must not dilute the mean. A true division by the count, as
    the JAX package's (a grid whose test sets share one width takes
    :func:`_accuracy`)."""
    from distributed_active_learning_tpu_torch.ops import trees_multi

    if trees_multi.is_multi(forest):
        pred = trees_multi.predict_class(forest, test_x)
    else:
        pred = (forest_eval.proba(forest, test_x) > 0.5).to(torch.int32)
    ok = (pred == test_y) & (torch.arange(test_y.shape[0], device=test_y.device) < test_n)
    return ok.to(torch.float32).sum() / test_n.to(torch.float32)


def _resolve_fit_budget(cfg: ExperimentConfig, n_pool: int, n_labeled: int) -> int:
    """Static row capacity of the device trainer's labeled window: the
    experiment's label cap, so the window never truncates."""
    if cfg.forest.fit_budget is not None:
        return min(cfg.forest.fit_budget, n_pool)
    caps = [n_pool]
    if cfg.label_budget is not None:
        caps.append(cfg.label_budget + cfg.strategy.window_size)
    if cfg.max_rounds is not None:
        caps.append(n_labeled + cfg.max_rounds * cfg.strategy.window_size)
    return min(caps)


def _device_fit_core(cfg: ExperimentConfig, budget: int, n_classes: int):
    """Labeled-window gather + histogram fit + kernel-form conversion: the
    path-matrix form for kernels "gemm" and "pallas" up to depth 10 (its
    storage quantized inside the fit when ``quantize`` says so), the gather
    form otherwise; a multiclass fit gives one plane a class."""
    from distributed_active_learning_tpu_torch.ops import trees_train
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest
    from distributed_active_learning_tpu_torch.ops.trees_pallas import PallasForest

    fc = cfg.forest
    to_gemm = fc.kernel in ("gemm", "pallas") and fc.max_depth <= forest_eval._GEMM_MAX_DEPTH

    def wrap_pallas(forest):
        if isinstance(forest, MultiForest):
            return MultiForest(planes=tuple(PallasForest(gf=p) for p in forest.planes))
        return PallasForest(gf=forest)

    def fit_body(codes, edges, state: state_lib.PoolState, key: prng.Key):
        if isinstance(codes, Sharded):
            c, yy, w = trees_train.gather_fit_window_sharded(
                codes, state.oracle_y, state.labeled_mask, state.n_valid, budget)
        else:
            mask = state.labeled_mask & state.valid_mask
            c, yy, w = trees_train.gather_fit_window(codes, state.oracle_y, mask, budget)
        f, th, v = trees_train.fit_forest_device(
            c, yy, w, edges, key,
            n_trees=fc.n_trees, max_depth=fc.max_depth, n_bins=fc.max_bins,
            n_classes=n_classes,
        )
        if not to_gemm:
            return trees_train.heap_packed_forest(f, th, v, fc.max_depth)
        gf = trees_train.heap_gemm_forest(f, th, v, fc.max_depth)
        # Storage narrows inside the fit, so the forest leaves it (and a
        # captured chunk's fit) at the narrow dtypes.
        gf = trees_train.quantize_forest(gf, fc.quantize)
        return wrap_pallas(gf) if fc.kernel == "pallas" else gf

    return fit_body


def make_device_fit(cfg: ExperimentConfig, edges: torch.Tensor, budget: int, n_classes: int = 2):
    """The device train phase ``fit(codes, state, key) -> forest``."""
    fit_body = _device_fit_core(cfg, budget, n_classes)

    def fit(codes, state, key):
        return fit_body(codes, edges, state, key)

    return fit


def make_chunk_fn(
    strategy: Strategy,
    window_size: int,
    chunk_size: int,
    fit_fn,
    label_cap: int,
    fused_round: bool = False,
    with_metrics: bool = False,
    n_classes: int = 2,
    stream_cb=None,
    scenario=None,
    drift_direction=None,
):
    """``chunk_size`` AL rounds as one launch, on a single device.

    ``chunk_fn(codes, state, aux, fit_key, test_x, test_y, end_round) ->
    (new_state, extras, (rounds, n_labeled, accuracy, picked, active[,
    metrics]))``:
    ``state`` is the carry form of the pool state (:func:`~.state.as_carry`:
    key and round counter on the device), ``end_round`` a 0-d int32 tensor
    there, each y is stacked ``[chunk_size, ...]``, ``n_labeled`` is the
    pre-reveal count (what the evaluated forest was trained on), and
    ``extras`` is a :class:`~.pipeline.ChunkExtras` of two 0-d int32 tensors,
    the only values ``run_pipelined`` blocks on per chunk.

    Stopping stays exact, not quantized to chunks: each step computes
    ``active = (labeled < label_cap) & (round < end_round)`` on the device
    and an inactive step is a masked no-op (:func:`~.state.select_state`), so
    a chunk may overrun the stopping point and the final state still equals
    the per-round driver's bit for bit. Inactive steps still compute a
    (discarded) fit and score: wasted work bounded by one chunk's tail.

    With ``with_metrics`` a stacked :class:`~.telemetry.RoundMetrics` rides
    as a sixth y, computed in the graph like the rest (a few hundred bytes
    more in the touchdown copy, no extra sync).

    The body reads nothing back to the host and uploads nothing: that is
    what lets :class:`GraphedChunk` capture it into a CUDA graph. A Python
    callback cannot run inside a replayed graph, so ``stream_cb(round,
    n_labeled, accuracy, active)`` (the JAX package calls it from inside
    the scan) is called at the chunk's touchdown instead, once per round in
    round order: ``chunk_fn.stream(ys)`` on the host copies of the ys.

    ``scenario`` (an active :class:`~..config.ScenarioConfig`, or None) runs
    the scenario round (:func:`_round_core`) and, under ``drift``, measures
    the accuracy on ``drift_apply(test_x, carry.round)``, the JAX package's
    spelling; the chunk then takes a trailing ``costs`` argument (the
    per-point cost vector of a ``cost_budget`` scenario, else None; a
    constant of the graph). ``drift_direction`` is the mean-shift direction,
    drawn once before the chunk is built (its draw uploads the scenario key,
    which a graph capture cannot). A device mesh waits for its slice.
    """
    from distributed_active_learning_tpu_torch.runtime.pipeline import ChunkExtras

    round_fn = make_round_fn(strategy, window_size, with_metrics=with_metrics,
                             n_classes=n_classes, fused=fused_round, scenario=scenario)
    drift = scenario is not None and scenario.kind == "drift"

    def step(codes, carry: state_lib.PoolState, aux, fit_key, test_x, test_y, end_round,
             costs=None):
        n_labeled = state_lib.labeled_count(carry)
        active = (n_labeled < label_cap) & (carry.round < end_round)
        forest = fit_fn(codes, carry, prng.fold_in(fit_key, carry.round + 1))
        new_state, picked, _, *rm = round_fn(forest, carry, aux, costs)
        if drift:
            from distributed_active_learning_tpu_torch.scenarios.engine import drift_apply

            test_x = drift_apply(scenario, test_x, carry.round, direction=drift_direction)
        acc = _accuracy(forest, test_x, test_y)
        out = state_lib.select_state(active, new_state, carry)
        return out, (carry.round + 1, n_labeled, acc, picked.to(torch.int32), active, *rm)

    def chunk_fn(codes, state, aux, fit_key, test_x, test_y, end_round, costs=None):
        ys = []
        for _ in range(chunk_size):
            state, y = step(codes, state, aux, fit_key, test_x, test_y, end_round, costs)
            ys.append(y)
        cols = list(zip(*ys))
        ys = tuple(torch.stack(col) for col in cols[:5])
        if with_metrics:
            from distributed_active_learning_tpu_torch.runtime.telemetry import stack_metrics

            ys = ys + (stack_metrics(list(cols[5])),)
        extras = ChunkExtras(
            n_labeled_after=state_lib.labeled_count(state),
            n_active=ys[4].sum(dtype=torch.int32),
        )
        return state, extras, ys

    def stream(ys) -> None:
        if stream_cb is None:
            return
        for r, nl, acc, act in zip(*(y.tolist() for y in (ys[0], ys[1], ys[2], ys[4]))):
            stream_cb(r, nl, acc, act)

    chunk_fn.step = step
    chunk_fn.stream = stream
    return chunk_fn


def ckpt_snapshot(mask: torch.Tensor, key: torch.Tensor, rnd: torch.Tensor):
    """Fresh-buffer copies of the carry fields a checkpoint needs, queued on
    the current stream.

    A :class:`GraphedChunk` writes its new carry into the same static
    buffers at every replay, and with ``pipeline_depth > 1`` the driver
    dispatches chunk N + 1 before chunk N's touchdown runs, so a
    checkpointing touchdown cannot read the carry itself. This copy, made
    right after chunk N's dispatch and ordered by the stream before chunk
    N + 1's replay, holds chunk N's (mask, key, round) (the JAX package's
    ``ckpt_snapshot`` does the same against buffer donation)."""
    return mask.clone(), key.clone(), rnd.clone()


def _kernel_launch_counts() -> dict:
    """The wrappers' launch counters this module's paths can advance."""
    from distributed_active_learning_tpu_torch.ops import round_fused, threefry, trees_pallas

    return {(trees_pallas, "launches"): trees_pallas.launches,
            (round_fused, "launches"): round_fused.launches,
            (threefry, "launches"): threefry.launches}


# The carry of every chunk program: the fields of a PoolState (one
# experiment) or of a sweep's SweepState ([E] experiments, or a grid's [C]
# cells) that a round changes.
CARRY_FIELDS = ("labeled_mask", "key", "round")


def _copy_leaves(dst, src) -> None:
    """Copy every tensor of ``src`` into the matching tensor of ``dst`` (two
    trees of one structure: a tensor, or dicts, tuples and lists of them)."""
    pairs = []
    _map_leaves(lambda d: pairs.append(d), dst)
    srcs = []
    _map_leaves(lambda t: srcs.append(t), src)
    for d, t in zip(pairs, srcs, strict=True):
        d.copy_(t)


class GraphedChunk:
    """A chunk function as one CUDA graph: the counterpart of the jitted
    launch with a donated carry.

    ``chunk_fn(*args) -> (new_carry, extras, ys)`` takes its carry as
    ``args[carry_arg]`` (an object with ``replace`` and the
    ``carry_fields``, each a tensor or a tree of them: a
    :class:`~.state.PoolState` for one experiment, a
    ``runtime.sweep.SweepState`` for a sweep or grid, both with
    :data:`CARRY_FIELDS`; a ``runtime.neural_loop.NeuralCarry``, which also
    carries the network's TrainState), the per-call inputs
    at the positions ``input_args`` (tensors that may change from call to
    call: the single chunk's end round, a sweep's end rounds, a grid's end
    rounds, label caps and real widths), and its constants everywhere else.

    The first call runs one step of the body eagerly on a side stream
    (``chunk_fn.step``, same arguments: it builds and loads the kernels,
    sets up autograd's per-stream state and fills the
    per-device constant caches, none of which may happen while capturing),
    copies the carry and the inputs into static buffers and captures the
    whole chunk on them; that call and every later one replay the graph.
    The graph ends by writing the new carry back into the static buffers,
    so the returned carry aliases the one passed to the next call (pass it
    on; any other carry is copied in first). Each call copies its inputs
    into their buffers before the replay, so a resumed run never replays
    stale stop rounds. A constant tensor must be the very tensor of the
    capture (the graph reads it where it lay): another one raises. The ys
    and extras are static buffers too, overwritten by every replay: copy
    them out on the same stream before the next call
    (``pipeline.start_host_copy``).

    A capture that fails raises: nothing here falls back to the eager body.

    Counters. ``captures`` and ``replays`` count this object's graph
    captures and replays, ``capture_seconds`` the host time of the capture
    (warm-up step excluded) and ``pool_bytes`` the device memory its
    private pool reserved. The kernel wrappers count a launch where they
    launch, which during a capture records the launch into the graph instead
    of running it: the capture's counts are therefore taken back, kept as
    ``launches_per_replay``, and added to the wrappers' counters at every
    replay, which is where the kernels really run (K rounds' worth per
    replay).
    """

    def __init__(self, chunk_fn, carry_arg: int = 1, input_args=(6,), carry_fields=CARRY_FIELDS):
        self._fn = chunk_fn
        self._carry_arg = carry_arg
        self._input_args = tuple(input_args)
        self._carry_fields = tuple(carry_fields)
        self._graph = None
        self.captures = 0
        self.replays = 0
        self.pool_bytes = 0  # device memory the graph's private pool reserved
        self.capture_seconds = 0.0
        self.launches_per_replay: dict = {}

    def _consts(self, args) -> dict:
        skip = (self._carry_arg, *self._input_args)
        return {i: a.data_ptr() for i, a in enumerate(args) if torch.is_tensor(a) and i not in skip}

    def _capture(self, args):
        carry = args[self._carry_arg]
        dev = carry.labeled_mask.device
        # The warm-up runs on a side stream, PyTorch's recipe for a capture
        # (autograd sets up per-stream state at its first backward, which a
        # capture must not see created).
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._fn.step(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._carry = {f: _map_leaves(torch.clone, getattr(carry, f)) for f in self._carry_fields}
        self._inputs = {i: args[i].clone() for i in self._input_args}
        static_args = list(args)
        static_args[self._carry_arg] = carry.replace(**self._carry)
        for i, buf in self._inputs.items():
            static_args[i] = buf
        self._const_ptrs = self._consts(args)
        torch.cuda.synchronize(dev)
        before = _kernel_launch_counts()
        # Entering the capture empties the allocator's cache; do it first, so
        # that what is reserved afterwards is the graph's private pool.
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, extras, ys = self._fn(*static_args)
            for f, buf in self._carry.items():
                _copy_leaves(buf, getattr(out, f))
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        for (mod, name), n in before.items():
            self.launches_per_replay[(mod, name)] = getattr(mod, name) - n
            setattr(mod, name, n)
        self._graph, self._extras, self._ys = graph, extras, ys
        self._static = static_args[self._carry_arg]
        self.captures += 1

    def stats(self) -> dict:
        """Counts for a report: captures, replays, the capture's host
        seconds, the private pool's bytes, and the kernel launches one
        replay stands for."""
        return {
            "captures": self.captures,
            "replays": self.replays,
            "capture_seconds": self.capture_seconds,
            "pool_bytes": self.pool_bytes,
            "launches_per_replay": {f"{mod.__name__.rsplit('.', 1)[-1]}.{name}": n
                                    for (mod, name), n in self.launches_per_replay.items()},
        }

    def __call__(self, *args):
        if self._graph is None:
            self._capture(args)
        else:
            if self._consts(args) != self._const_ptrs:
                raise ValueError(
                    "a graphed chunk replays on the constant tensors of its capture; it was "
                    "called with others (build a new GraphedChunk for new pool arrays)")
            carry = args[self._carry_arg]
            if carry.labeled_mask.data_ptr() != self._carry["labeled_mask"].data_ptr():
                for f, buf in self._carry.items():
                    _copy_leaves(buf, getattr(carry, f))
        for i, buf in self._inputs.items():
            buf.copy_(args[i])
        self._graph.replay()
        self.replays += 1
        for (mod, name), n in self.launches_per_replay.items():
            setattr(mod, name, getattr(mod, name) + n)
        return self._static, self._extras, self._ys


def _run_chunked(cfg, state, codes, aux, device_fit, fit_key, test_x, test_y, strategy,
                 fit_budget, result, dbg, start_round, metrics=None, n_classes=2, ckpt=None,
                 scn=None, costs=None, drift_dir=None):
    """The chunked branch of :func:`run_experiment`: K rounds per launch
    through ``pipeline.run_pipelined``. ``ckpt`` is ``(fingerprint,
    kernel)`` when the run checkpoints; ``scn`` the active scenario (with its
    ``costs`` and drift direction), or None. Returns the final state."""
    from distributed_active_learning_tpu_torch.runtime import pipeline as pipeline_lib
    from distributed_active_learning_tpu_torch.runtime import telemetry

    dev = state.x.device
    n_pool = state.n_valid
    K, window = cfg.rounds_per_launch, cfg.strategy.window_size
    label_cap = n_pool if cfg.label_budget is None else min(cfg.label_budget, n_pool)
    depth = max(int(cfg.pipeline_depth or 1), 1)
    want_metrics = metrics is not None or cfg.collect_metrics
    stream_cb = None
    if metrics is not None and cfg.stream_round_events:
        def stream_cb(round_, n_labeled_cb, acc_cb, active_cb):
            if bool(active_cb):
                metrics.event("round_stream", round=int(round_), n_labeled=int(n_labeled_cb),
                              accuracy=float(acc_cb))
    body = make_chunk_fn(strategy, window, K, device_fit, label_cap, fused_round=cfg.fused_round,
                         with_metrics=want_metrics, n_classes=n_classes, stream_cb=stream_cb,
                         scenario=scn, drift_direction=drift_dir)
    chunk_fn = GraphedChunk(body) if dev.type == "cuda" else body
    # The chunk updates the carried mask in place; at round 0 aux.seed_mask
    # is that mask, so it gets its own copy once up front.
    if aux.seed_mask is not None:
        aux = dataclasses.replace(aux, seed_mask=aux.seed_mask.clone())
    launches = telemetry.LaunchTracker(metrics, "chunk_scan", fn=chunk_fn)
    end_round = (start_round + cfg.max_rounds if cfg.max_rounds is not None
                 else int(np.iinfo(np.int32).max))
    # One sync at loop entry; afterwards the loop blocks only on each
    # chunk's two stop scalars.
    n_known = int(state_lib.labeled_count(state))
    # An abstaining oracle reveals fewer than `window` labels a round, so
    # the label-cap lattice (window-sized steps) would overestimate progress
    # and veto chunks while the run still has work: lattice window 0 turns
    # that veto off, and the stop comes from the revealed count alone.
    abstaining = scn is not None and scn.kind == "noisy_oracle" and scn.abstain_prob > 0.0
    ctl = pipeline_lib.ChunkDriveControl(K, 0 if abstaining else window, label_cap,
                                         cfg.max_rounds, n_known, start_round)
    if ctl.already_done:
        return state
    # Projected upper bound on any ACTIVE fit's labeled rows over the whole
    # run, raised here instead of mid-round: a fit inside a chunk cannot
    # raise, and a silently truncated window would corrupt the curve.
    # Pre-reveal counts advance on the n_known + j * window lattice and an
    # active round needs its count < label_cap, so the largest reachable
    # active fit size is the last lattice point under the cap, further
    # capped by max_rounds.
    j_cap = -(-(label_cap - n_known) // window) - 1
    if cfg.max_rounds is not None:
        j_cap = min(cfg.max_rounds - 1, j_cap)
    projected = n_known + max(j_cap, 0) * window
    if projected > fit_budget:
        raise ValueError(
            f"up to {projected} labeled rows would exceed the device fit window "
            f"({fit_budget}); raise ForestConfig.fit_budget or lower "
            "label_budget/max_rounds"
        )

    carry = state_lib.as_carry(state)
    fit_key_dev = fit_key.to(dev)
    end_dev = torch.as_tensor(end_round, dtype=torch.int32).to(dev)
    # The graph rewrites its carry buffers at every replay, so a
    # checkpointing drive copies (mask, key, round) at each dispatch and the
    # touchdown writes the copy, never the carry (ckpt_snapshot).
    snapshots = pipeline_lib.CarrySnapshots(ckpt_snapshot)

    tail = (costs,) if scn is not None else ()

    def dispatch(st, idx):
        out = chunk_fn(codes, st, aux, fit_key_dev, test_x, test_y, end_dev, *tail)
        if ckpt is not None:
            new_state = out[0]
            snapshots.take(idx, new_state.labeled_mask, new_state.key, new_state.round)
        return out

    def touchdown(idx, _n_labeled_after, n_active, ys, _out_state, wall):
        # ys are this chunk's host copies. Runs overlapped with the next
        # chunk's execution when depth > 1.
        snap = snapshots.pop(idx)
        if n_active == 0:
            return  # a wholly inactive (speculative tail) chunk
        body.stream(ys)
        rounds_y, labeled_y, acc_y, _picked_y, active_y = ys[:5]
        active_np = active_y.numpy()
        rounds_np = rounds_y.numpy()[active_np]
        labeled_np = labeled_y.numpy()[active_np]
        acc_np = acc_y.numpy()[active_np]
        round_dicts = (telemetry.stacked_metrics_to_dicts(ys[5], active_np)
                       if want_metrics else None)
        result.extend_from_arrays(
            rounds_np, labeled_np, n_pool - labeled_np, acc_np, total_time=wall / n_active,
            metrics=round_dicts)
        ctl.note_round(int(rounds_np[-1]))
        if metrics is not None:
            # Bytes this touchdown copied to the host (shape times item
            # size: counting the transfer must not add one), then one round
            # event per active round.
            fetched = sum(y.numel() * y.element_size()
                          for y in (active_y, rounds_y, labeled_y, acc_y))
            if want_metrics:
                fetched += telemetry.metrics_nbytes(ys[5])
            metrics.counter("host_transfer_bytes", int(fetched))
            for i in range(len(rounds_np)):
                metrics.round(round=int(rounds_np[i]), n_labeled=int(labeled_np[i]),
                              accuracy=float(acc_np[i]),
                              **(round_dicts[i] if round_dicts else {}))
            mem = telemetry.device_memory_gauges()
            if mem:
                metrics.gauges(mem)
        if cfg.log_every and dbg.enabled:
            for r, nl, a in zip(rounds_np, labeled_np, acc_np):
                if int(r) % cfg.log_every == 0:
                    dbg.debug(f"Iteration {int(r)} -- labeled={int(nl)} accu={float(a) * 100:.2f}")
        if ckpt is not None and ctl.checkpoint_due(cfg.checkpoint_every):
            # Saved at the first touchdown after each checkpoint_every
            # multiple, from the dispatch-time snapshot.
            from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

            s_mask, s_key, s_rnd = snap
            ckpt_state = state.replace(labeled_mask=s_mask, key=s_key, round=int(s_rnd))
            ckpt_lib.save(cfg.checkpoint_dir, ckpt_state, result, fingerprint=ckpt[0],
                          kernel=ckpt[1])
            ctl.checkpoint_done()

    carry, stats = pipeline_lib.run_pipelined(
        carry,
        dispatch=dispatch,
        touchdown=touchdown,
        continue_after=ctl.continue_after,
        depth=depth,
        on_launch=launches.record,
        may_dispatch=ctl.may_dispatch,
        on_veto=lambda idx: launches.veto(idx, ctl.veto_reason(idx)),
    )
    result.pipeline_stats = stats
    if isinstance(chunk_fn, GraphedChunk):
        result.graph_stats = chunk_fn.stats()
    return carry


def _labeled_subset(state: state_lib.PoolState, host_x: np.ndarray, host_y: np.ndarray):
    """The labeled rows of the host-side pool arrays, for the host fit: only
    the mask crosses from the device."""
    mask = state.labeled_mask.cpu().numpy()[: state.n_valid]
    return host_x[mask], host_y[mask]


def make_host_fit(cfg: ExperimentConfig, host_x: np.ndarray, host_y: np.ndarray,
                  n_classes: int, device):
    """The host train phase ``fit(state, round_idx) -> forest``: scikit-learn
    on the labeled rows with ``random_state = cfg.seed + round_idx``, the
    packed forest in the configured kernel's form, placed on ``device``."""
    from distributed_active_learning_tpu_torch.models import forest as forest_lib

    forest_lib.require_sklearn()  # fail by name before the first round

    def fit(state, round_idx):
        lx, ly = _labeled_subset(state, host_x, host_y)
        packed = forest_lib.fit_forest_classifier(
            lx, ly, cfg.forest, seed=cfg.seed + round_idx, n_classes=n_classes)
        return forest_eval.for_kernel(packed, cfg.forest.kernel).to(device)

    return fit


def build_aux(cfg: ExperimentConfig, state: state_lib.PoolState) -> StrategyAux:
    """Strategy aux inputs: the LAL regressor that the ``lal`` strategy's
    options name (a :class:`~..ops.trees.PackedForest` on the pool's
    device, evaluated in the gather form as in the JAX package) and the
    seed mask."""
    lal_forest = None
    if cfg.strategy.name == "lal":
        from distributed_active_learning_tpu_torch.models.lal_training import (
            load_or_train_lal_regressor,
        )

        lal_forest = load_or_train_lal_regressor(dict(cfg.strategy.options), state.x.device)
    return StrategyAux(lal_forest=lal_forest, seed_mask=state.labeled_mask)


def run_experiment(
    cfg: ExperimentConfig,
    bundle: Optional[DataBundle] = None,
    debugger: Optional[Debugger] = None,
    metrics=None,
    device=None,
    devices=None,
) -> ExperimentResult:
    """Run a full AL experiment on ``device`` (default CUDA; raises without a
    card unless ``device="cpu"``); returns per-round records and the final
    labeled mask. A mesh config takes its devices from ``devices`` (passed to
    ``parallel.mesh.make_mesh``; a list may repeat a card), or by default the
    first ``data * model`` cards, or every shard on the CPU.

    ``metrics`` (a :class:`~.telemetry.MetricsWriter`, or None) turns on the
    JSONL event stream (one ``round`` event per round with its
    RoundMetrics, launch accounting, transfer counters, memory gauges) and
    implies ``cfg.collect_metrics``. With ``cfg.checkpoint_dir`` and
    ``cfg.checkpoint_every`` the run resumes from the newest checkpoint
    there and writes new ones (``runtime/checkpoint.py``)."""
    dev = resolve_device(device)
    _not_ported(cfg, metrics)
    _validate_quantize(cfg)
    if cfg.forest.fit not in ("host", "device"):
        raise ValueError(f"unknown ForestConfig.fit {cfg.forest.fit!r}; use 'host' or 'device'")
    dbg = debugger or Debugger(enabled=False)
    if bundle is None:
        bundle = get_dataset(cfg.data)
    want_metrics = metrics is not None or cfg.collect_metrics

    test_x = torch.as_tensor(np.asarray(bundle.test_x, dtype=np.float32)).to(dev)
    test_y = torch.as_tensor(np.asarray(bundle.test_y, dtype=np.int32)).to(dev)
    host_x = np.ascontiguousarray(bundle.train_x, dtype=np.float32)
    host_y = np.asarray(bundle.train_y, dtype=np.int32)
    n_classes = max(int(host_y.max()) + 1, 2) if host_y.size else 2

    state = state_lib.init_pool_state(host_x, host_y, prng.key(cfg.seed), dev)
    state = state_lib.set_start_state(state, cfg.n_start, n_classes=n_classes)
    strategy = get_strategy(cfg.strategy)
    # The scenario engine, as the JAX package wires it: validated up front;
    # the start state is drawn on the clean labels above (as the grid seeds
    # its cells) and the flips replace the oracle after it; the costs are a
    # per-point vector of the dataset; the drift moves the test batch a round.
    scn = cfg.scenario if cfg.scenario is not None and cfg.scenario.active else None
    costs = drift_dir = None
    if scn is not None:
        from distributed_active_learning_tpu_torch.scenarios import engine as scn_engine

        scn_engine.validate_scenario(scn, strategy=strategy, max_rounds=cfg.max_rounds)
        if cfg.forest.fit != "device":
            raise ValueError(
                f"scenario {scn.kind!r} runs inside the jitted round and "
                "needs the device fit; use --fit device"
            )
        if scn.kind == "noisy_oracle" and scn.flip_prob > 0.0:
            flips = scn_engine.flip_mask(scn, cfg.seed, state.n_pool, dev)
            state = state.replace(
                oracle_y=scn_engine.apply_flips(state.oracle_y, flips, n_classes))
        if scn.kind == "cost_budget":
            costs = scn_engine.make_costs(scn, state.n_pool, cfg.data.name, dev)
        if scn.kind == "drift" and scn.drift_kind == "mean_shift":
            drift_dir = scn_engine.drift_direction(scn, test_x.shape[-1], dev)
    if cfg.fused_round:
        reason = _fused_round_reason(cfg, want_metrics, n_classes)
        if reason is not None:
            raise ValueError(f"fused_round unavailable: {reason}")

    host_fit = None
    if cfg.forest.fit == "host":
        host_fit = make_host_fit(cfg, host_x, host_y, n_classes, dev)
        codes = edges = None
    else:
        from distributed_active_learning_tpu_torch.ops import trees_train

        binned = trees_train.make_bins(state.x, cfg.forest.max_bins, quantize=cfg.forest.quantize)
        codes, edges = binned.codes, binned.edges

    mesh = None
    if cfg.mesh.data * cfg.mesh.model > 1:
        # Pad the pool to the data axis, place its rows over data (codes
        # too) and the test set on every shard; each fit lands on the mesh's
        # first device and is sharded by trees.
        from distributed_active_learning_tpu_torch.ops.trees_pallas import attach_mesh
        from distributed_active_learning_tpu_torch.parallel import (
            make_mesh,
            make_sharded_round_fn,
            shard_forest,
            shard_pool_state,
            shard_rows,
        )

        if cfg.forest.n_trees % cfg.mesh.model:
            raise ValueError(
                f"n_trees={cfg.forest.n_trees} not divisible by mesh "
                f"model axis {cfg.mesh.model}"
            )
        mesh = make_mesh(data=cfg.mesh.data, model=cfg.mesh.model, devices=devices, device=dev)
        if mesh.first.type != dev.type:
            raise ValueError(f"mesh devices {mesh.devices} do not match device {dev}")
        state = state_lib.pad_for_sharding(state, cfg.mesh.data)
        state = shard_pool_state(state, mesh)
        codes = shard_rows(codes, mesh)  # zero codes for the padding rows
        edges = edges.to(mesh.first)
        test_x = shard_rows(test_x, mesh, replicate=True)
        test_y = test_y.to(mesh.first)
        round_fn = make_sharded_round_fn(
            strategy, cfg.strategy.window_size, mesh, fused=cfg.fused_round)

        def place_forest(f):
            return attach_mesh(shard_forest(f, mesh), mesh)
    else:
        round_fn = make_round_fn(strategy, cfg.strategy.window_size, with_metrics=want_metrics,
                                 n_classes=n_classes, fused=cfg.fused_round, scenario=scn)

        def place_forest(f):
            return f

    aux = build_aux(cfg, state)
    if metrics is not None:
        metrics.meta(
            config=dataclasses.asdict(cfg),
            backend=dev.type,
            n_devices=torch.cuda.device_count() if dev.type == "cuda" else 1,
            process_count=1,
        )
    result = ExperimentResult()
    start_round = state.round

    ckpt = None
    if cfg.checkpoint_dir and cfg.checkpoint_every:
        from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

        ckpt = (ckpt_lib.config_fingerprint(cfg), ckpt_lib.kernel_ident(cfg))
        restored = ckpt_lib.restore_latest(
            cfg.checkpoint_dir, state, result,
            fingerprint=ckpt_lib.accepted_fingerprints(cfg), kernel=ckpt[1],
        )
        if restored is not None:
            state, result = restored
            if mesh is not None:
                state = shard_pool_state(state, mesh)  # re-place the restored mask
            start_round = state.round
            dbg.debug(f"resumed at round {start_round}")

    # The fit window is sized after any restore, so it counts the labels the
    # resumed run already holds.
    if host_fit is None:
        fit_budget = _resolve_fit_budget(cfg, state.n_valid, int(state_lib.labeled_count(state)))
        device_fit = make_device_fit(cfg, edges, fit_budget, n_classes)
    fit_key = prng.key(cfg.seed + 0x5EED)
    sync_devs = {d for row in mesh.devices for d in row} if mesh else {dev}

    def sync():  # keep phase timings honest
        for d in sync_devs:
            synchronize(d)

    n_pool = state.n_valid
    round_idx = start_round
    if cfg.rounds_per_launch > 1 and host_fit is None and not dbg.phase_detail:
        state = _run_chunked(
            cfg, state, codes, aux, device_fit, fit_key, test_x, test_y, strategy,
            fit_budget, result, dbg, start_round, metrics=metrics, n_classes=n_classes,
            ckpt=ckpt, scn=scn, costs=costs, drift_dir=drift_dir)
        result.final_labeled_mask = state_lib.global_labeled_mask(state).clone()
        if cfg.results_path:
            result.save(cfg.results_path, fmt="reference")
        return result
    while True:
        n_labeled = int(state_lib.labeled_count(state))
        if n_labeled >= n_pool:
            break
        if cfg.label_budget is not None and n_labeled >= cfg.label_budget:
            break
        if cfg.max_rounds is not None and round_idx - start_round >= cfg.max_rounds:
            break
        round_idx += 1

        with dbg.phase("train"):
            if host_fit is not None:
                forest = place_forest(host_fit(state, round_idx))
            else:
                if n_labeled > fit_budget:
                    raise ValueError(
                        f"{n_labeled} labeled rows exceed the device fit "
                        f"window ({fit_budget}); raise ForestConfig.fit_budget"
                    )
                forest = place_forest(device_fit(codes, state, prng.fold_in(fit_key, round_idx)))
            sync()
        train_time = dbg.records[-1][1]

        with dbg.phase("round"):
            state, picked, _, *rm = round_fn(forest, state, aux, *(
                (costs,) if costs is not None else ()))
            sync()
        score_time = dbg.records[-1][1]
        with dbg.phase("eval"):
            eval_x = test_x
            if scn is not None and scn.kind == "drift":
                # round_idx - 1 is the chunk's pre-reveal carry.round for this
                # round: both drivers drift the same batch for a round.
                eval_x = scn_engine.drift_apply(scn, test_x, round_idx - 1, direction=drift_dir)
            acc = float(_accuracy(forest, eval_x, test_y))
        eval_time = dbg.records[-1][1]
        round_dict = None
        if want_metrics:
            from distributed_active_learning_tpu_torch.runtime import telemetry

            round_dict = telemetry.metrics_to_dict(rm[0])

        # The record pairs the accuracy with the labeled count the evaluated
        # forest was trained on (pre-reveal), the reference's print order.
        result.append(RoundRecord(
            round=round_idx,
            n_labeled=n_labeled,
            n_unlabeled=n_pool - n_labeled,
            accuracy=acc,
            train_time=train_time,
            score_time=score_time,
            eval_time=eval_time,
            total_time=train_time + score_time + eval_time,
            metrics=round_dict,
        ))
        if metrics is not None:
            metrics.round(round=round_idx, n_labeled=n_labeled, accuracy=acc,
                          train_time=train_time, score_time=score_time, eval_time=eval_time,
                          **(round_dict or {}))
        if cfg.log_every and round_idx % cfg.log_every == 0:
            dbg.debug(f"Iteration {round_idx} -- labeled={n_labeled} accu={acc * 100:.2f}")
        if ckpt is not None and round_idx % cfg.checkpoint_every == 0:
            from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

            ckpt_lib.save(cfg.checkpoint_dir, state, result, fingerprint=ckpt[0], kernel=ckpt[1])

    if metrics is not None:
        from distributed_active_learning_tpu_torch.runtime import telemetry

        mem = telemetry.device_memory_gauges()
        if mem:
            metrics.gauges(mem)
    result.final_labeled_mask = state_lib.global_labeled_mask(state)
    if cfg.results_path:
        result.save(cfg.results_path, fmt="reference")
    return result
