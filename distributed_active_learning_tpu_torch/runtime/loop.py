"""The AL driver loop (the port of ``runtime/loop.py``, per-round branch).

Each round: fit the forest on the labeled window on the device
(``ops/trees_train.py``), score the pool and take the masked top-k (or run
the round megakernel, ``fused_round``), reveal, and measure test accuracy.
The PRNG stream, the fit, the picks and the records equal the JAX package's
bit for bit on the same configuration (``tests/test_torch_loop.py``).

With ``ExperimentConfig.mesh`` of ``data x model > 1`` the pool's rows
shard over ``data`` and the trees over ``model`` (``parallel/``): the pool is
padded to the data axis, every fit is sharded by trees, and the round runs
per shard (:func:`~..parallel.kernels.make_sharded_round_fn`). The records
and the final mask equal the single-device run's.

Not ported yet, and refused with a ``NotImplementedError`` that names the
slice bringing them: the chunked driver (``rounds_per_launch > 1``), the
host (sklearn) fit, ``kernel="gemm"`` under a mesh, scenarios, checkpoints,
metrics writers, quantized storage, multiclass pools and the gather kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import ExperimentConfig
from distributed_active_learning_tpu_torch.data.datasets import DataBundle, get_dataset
from distributed_active_learning_tpu_torch.device import resolve_device, synchronize
from distributed_active_learning_tpu_torch.ops import forest_eval
from distributed_active_learning_tpu_torch.ops.topk import select_bottom_k, select_top_k
from distributed_active_learning_tpu_torch.parallel.mesh import Sharded, gather
from distributed_active_learning_tpu_torch.runtime import state as state_lib
from distributed_active_learning_tpu_torch.runtime.debugger import Debugger
from distributed_active_learning_tpu_torch.runtime.results import ExperimentResult, RoundRecord
from distributed_active_learning_tpu_torch.strategies import Strategy, StrategyAux, get_strategy


def _round_core(
    strategy: Strategy,
    window_size: int,
    forest: forest_eval.Forest,
    state: state_lib.PoolState,
    aux: StrategyAux,
    fused: bool = False,
):
    """One AL round: split the key, score + select (or the fused round),
    reveal. The key is split even when the round is fused, so the carried
    stream is the unfused round's."""
    keys = prng.split(state.key)
    key, k_score = keys[0], keys[1]
    state = state.replace(key=key)
    unlabeled = state.unlabeled_mask
    if fused:
        from distributed_active_learning_tpu_torch.ops import round_fused

        vals, picked = round_fused.fused_score_select(
            forest, state.x, unlabeled, strategy.name, window_size
        )
        scores = None
    else:
        scores = strategy.score(forest, state, k_score, aux)
        unlabeled = gather(unlabeled)  # a mesh's global select runs on its first device
        if strategy.higher_is_better:
            vals, picked = select_top_k(scores, unlabeled, window_size)
        else:
            vals, picked = select_bottom_k(scores, unlabeled, window_size)
    return state_lib.reveal(state, picked), picked, scores


def make_round_fn(strategy: Strategy, window_size: int, fused: bool = False):
    """The AL round ``round_fn(forest, state, aux) -> (new_state, picked,
    scores)``; ``fused`` routes score + select through the round megakernel
    (``scores`` is then None). RoundMetrics wait for the telemetry slice."""

    def round_fn(forest, state, aux):
        return _round_core(strategy, window_size, forest, state, aux, fused=fused)

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


def _not_ported(cfg: ExperimentConfig, metrics) -> None:
    """Refuse what this slice does not carry, naming the slice that will."""
    refusals = [
        (cfg.rounds_per_launch > 1,
         "rounds_per_launch > 1 (the chunked driver, make_chunk_fn and "
         "runtime/pipeline.py) comes with the chunked-driver slice"),
        (cfg.forest.fit == "host",
         "the host (sklearn) fit is not ported: the port does not depend on "
         "scikit-learn; use fit='device'"),
        (cfg.mesh.data * cfg.mesh.model > 1 and cfg.forest.kernel == "gemm",
         "kernel 'gemm' under a device mesh (GSPMD-partitioned plain XLA in "
         "the JAX package, no kernel) is not ported yet; use kernel 'pallas'"),
        (cfg.scenario is not None and cfg.scenario.active,
         "scenarios come with the scenario slice"),
        (bool(cfg.checkpoint_dir and cfg.checkpoint_every),
         "checkpoints come with the checkpoint slice"),
        (metrics is not None or cfg.collect_metrics,
         "metrics writers and RoundMetrics come with the telemetry slice"),
        (cfg.forest.quantize != "none",
         "quantized forest storage comes with the quantization slice"),
        (cfg.forest.kernel not in ("gemm", "pallas"),
         f"kernel {cfg.forest.kernel!r} (the gather form) comes with the "
         "gather-kernel slice; use 'gemm' or 'pallas'"),
        (cfg.forest.max_depth > forest_eval._GEMM_MAX_DEPTH,
         f"max_depth {cfg.forest.max_depth} needs the gather form, which "
         "comes with the gather-kernel slice"),
    ]
    for refused, why in refusals:
        if refused:
            raise NotImplementedError(why)


def _accuracy(forest, test_x, test_y: torch.Tensor) -> torch.Tensor:
    """Test accuracy on the device (``uncertainty_sampling.py:79-83``); on a
    mesh ``test_x`` is the test set placed on every shard."""
    from distributed_active_learning_tpu_torch.ops.xla_f32 import div_const

    pred = (forest_eval.proba(forest, test_x) > 0.5).to(torch.int32)
    return div_const((pred == test_y).to(torch.float32).sum(), test_y.shape[0])


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
    """Labeled-window gather + histogram fit + kernel-form conversion."""
    from distributed_active_learning_tpu_torch.ops import trees_train
    from distributed_active_learning_tpu_torch.ops.trees_pallas import PallasForest

    fc = cfg.forest

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
        gf = trees_train.heap_gemm_forest(f, th, v, fc.max_depth)
        return PallasForest(gf=gf) if fc.kernel == "pallas" else gf

    return fit_body


def make_device_fit(cfg: ExperimentConfig, edges: torch.Tensor, budget: int, n_classes: int = 2):
    """The device train phase ``fit(codes, state, key) -> forest``."""
    fit_body = _device_fit_core(cfg, budget, n_classes)

    def fit(codes, state, key):
        return fit_body(codes, edges, state, key)

    return fit


def build_aux(cfg: ExperimentConfig, state: state_lib.PoolState) -> StrategyAux:
    """Strategy aux inputs: the seed mask (the LAL regressor is not ported)."""
    return StrategyAux(seed_mask=state.labeled_mask)


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
    first ``data * model`` cards, or every shard on the CPU."""
    dev = resolve_device(device)
    _not_ported(cfg, metrics)
    if cfg.forest.fit != "device":
        raise ValueError(f"unknown ForestConfig.fit {cfg.forest.fit!r}; use 'host' or 'device'")
    dbg = debugger or Debugger(enabled=False)
    if bundle is None:
        bundle = get_dataset(cfg.data)

    test_x = torch.as_tensor(np.asarray(bundle.test_x, dtype=np.float32)).to(dev)
    test_y = torch.as_tensor(np.asarray(bundle.test_y, dtype=np.int32)).to(dev)
    host_x = np.ascontiguousarray(bundle.train_x, dtype=np.float32)
    host_y = np.asarray(bundle.train_y, dtype=np.int32)
    n_classes = max(int(host_y.max()) + 1, 2) if host_y.size else 2
    if n_classes > 2:
        raise NotImplementedError("multiclass pools come with the multiclass slice")

    state = state_lib.init_pool_state(host_x, host_y, prng.key(cfg.seed), dev)
    state = state_lib.set_start_state(state, cfg.n_start, n_classes=n_classes)
    strategy = get_strategy(cfg.strategy)
    if cfg.fused_round:
        reason = _fused_round_reason(cfg, False, n_classes)
        if reason is not None:
            raise ValueError(f"fused_round unavailable: {reason}")

    from distributed_active_learning_tpu_torch.ops import trees_train

    binned = trees_train.make_bins(state.x, cfg.forest.max_bins, quantize=cfg.forest.quantize)
    codes, edges = binned.codes, binned.edges
    fit_budget = _resolve_fit_budget(cfg, state.n_valid, int(state_lib.labeled_count(state)))

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
        round_fn = make_round_fn(strategy, cfg.strategy.window_size, fused=cfg.fused_round)

        def place_forest(f):
            return f

    aux = build_aux(cfg, state)
    result = ExperimentResult()
    device_fit = make_device_fit(cfg, edges, fit_budget, n_classes)
    fit_key = prng.key(cfg.seed + 0x5EED)
    sync_devs = {d for row in mesh.devices for d in row} if mesh else {dev}

    def sync():  # keep phase timings honest
        for d in sync_devs:
            synchronize(d)

    n_pool = state.n_valid
    round_idx = state.round
    start_round = round_idx
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
            if n_labeled > fit_budget:
                raise ValueError(
                    f"{n_labeled} labeled rows exceed the device fit "
                    f"window ({fit_budget}); raise ForestConfig.fit_budget"
                )
            forest = place_forest(device_fit(codes, state, prng.fold_in(fit_key, round_idx)))
            sync()
        train_time = dbg.records[-1][1]

        with dbg.phase("round"):
            state, picked, _ = round_fn(forest, state, aux)
            sync()
        score_time = dbg.records[-1][1]
        with dbg.phase("eval"):
            acc = float(_accuracy(forest, test_x, test_y))
        eval_time = dbg.records[-1][1]

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
        ))
        if cfg.log_every and round_idx % cfg.log_every == 0:
            dbg.debug(f"Iteration {round_idx} -- labeled={n_labeled} accu={acc * 100:.2f}")

    result.final_labeled_mask = state_lib.global_labeled_mask(state)
    if cfg.results_path:
        result.save(cfg.results_path, fmt="reference")
    return result
