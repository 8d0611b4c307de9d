"""Batched experiment sweeps and grids: one launch stream advances many AL
experiments (the port of ``runtime/sweep.py``).

The paper reports grids of runs (strategies x seeds x datasets) averaged
into learning curves, not single runs. :func:`run_sweep` runs E seeds of one
configuration and :func:`run_grid` the strategies x datasets x seeds grid,
each as ONE pipelined stream of chunk launches through
``runtime/pipeline.py``, as the JAX package does.

Design, and where it departs from the JAX package's:

- **One pool, E experiments.** The pool (features, labels, bin codes, test
  set, LAL regressor) is shared by the batch; only the per-experiment carry
  (labeled mask, key, round: :class:`SweepState`) has a leading ``[E]``
  axis. A grid stacks its datasets' pools ``[D, ...]`` and shares each one
  among that dataset's cells.
- **The chunk is the unit of batching.** JAX vmaps its chunk body over the
  experiments. Here each round step of a chunk runs, as one CUDA graph
  replayed K times a chunk on the card: the E device fits one after
  another (each the serial fit on its own key, so exact by construction),
  ONE stacked launch of the leaf kernel K1 over every experiment's forest
  on the pool and one on the test set (``forest_eval.evaluated_many``: the
  forests' heap operands concatenated along the tree axis, where JAX runs
  its Pallas kernel under ``vmap``), each experiment's score, select and reveal on its own rows of
  those leaves, and a masked no-op past each experiment's own stop. K1 runs
  twice a round step per dataset whatever E is. The round is always the
  unfused padded round (``runtime.loop.make_padded_round_fn``), as in JAX,
  whose padded round has no fused form: a ``fused_round`` config runs
  unfused here too.
- **Heterogeneous windows** select at the widest window and reveal each
  experiment's own first ``window`` picks (``state.reveal_masked``).
- **Unequal pool widths** in a grid pad every pool to one slab and mark the
  real rows with the scalar fill watermark ``PoolState.n_filled``; padding
  rows are labeled sentinels outside the fit window, the counts and the
  metrics, so each cell equals its unpadded serial run (except ``random``,
  whose uniform draw is shaped by the padded slab: such cells agree with
  the JAX package's ``run_grid``, not with the serial run).
- **One chunk body.** A sweep is the grid of one strategy and one dataset:
  both run :func:`make_grid_chunk_fn`'s body, the sweep over ``[1, ...]``
  views of its pool with its per-seed windows as the per-cell vector.
- **Stopping reduces to one scalar pair** per chunk (the negated largest
  remaining budget and the max active rounds), so ``ChunkDriveControl`` and
  ``run_pipelined`` drive the batch unchanged.

Per-seed (per-cell) records and final masks equal the serial
``run_experiment`` of the same configuration bit for bit, provided the fit
window is pinned (``ForestConfig.fit_budget``): the device fit's bootstrap
draw depends on the window's static size, and the batched window covers
the widest experiment.

- **Under a device mesh** (``cfg.mesh``) the batch axis stays outside the
  data-sharded pool, as in the JAX package: the pool's rows (features,
  labels, codes; each dataset's in a grid) are padded to the data axis and
  sharded over it, each experiment's mask is a row-sharded mask of its own
  (``[E]`` experiments by ``data`` shards), and each experiment's fitted
  forest is placed by trees inside the round step
  (``parallel.mesh.constrain_forest``). K1's stacked launch becomes one
  launch a (data, model) shard per dataset and input. Padding rows read
  labeled; equal widths keep the static real-row count
  (``static_n_valid``), unequal ones the per-shard fill watermark.

Fallbacks, as the JAX package's: a host fit runs the experiments as serial
``run_experiment`` calls (one after another, each on the requested device),
and so does a grid whose datasets disagree on feature width or class count.
Refused, with the JAX package's own ``ValueError`` s: a scenario run as a
seed sweep (it runs as a grid's scenario axis: :func:`run_grid` with
``scenarios=``, one scenario round a group inside the same graph), a
grid's scenario axis under a mesh, and ``stream_round_events``.

Checkpoints: one ``sweepstate_<round>.npz`` a sweep, one
``gridstate_<round>.npz`` a grid (``runtime/checkpoint.py``), the JAX
package's format, written from the dispatch-time snapshot of the carry.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import ExperimentConfig
from distributed_active_learning_tpu_torch.device import resolve_device
from distributed_active_learning_tpu_torch.ops import forest_eval
from distributed_active_learning_tpu_torch.parallel.mesh import (
    gather,
    global_put,
    shard_fill_watermark,
)
from distributed_active_learning_tpu_torch.runtime import obs
from distributed_active_learning_tpu_torch.runtime import state as state_lib
from distributed_active_learning_tpu_torch.runtime.results import ExperimentResult
from distributed_active_learning_tpu_torch.strategies import Strategy, StrategyAux, get_strategy


@dataclasses.dataclass(frozen=True)
class SweepState:
    """The per-experiment carry of E experiments (or a grid's C cells) over
    shared pools: the fields of :class:`~.state.PoolState` a round changes,
    with a leading axis."""

    labeled_mask: object        # [E, n] bool; on a mesh a tuple of E row-sharded masks
    key: torch.Tensor           # [E, 2] int64 key words
    round: torch.Tensor         # [E] int32

    def replace(self, **kw) -> "SweepState":
        return dataclasses.replace(self, **kw)

    @property
    def n_experiments(self) -> int:
        return len(self.labeled_mask)


def _global_masks(masks) -> torch.Tensor:
    """A carry's masks as one ``[E, n]`` tensor (joined from the shards on a
    mesh)."""
    if isinstance(masks, tuple):
        return torch.stack([gather(m) for m in masks])
    return masks


def _shard_masks(masks: torch.Tensor, mesh, n_rows: int) -> tuple:
    """``[E, n]`` masks padded with labeled rows to ``n_rows`` and placed on
    ``mesh``, one row-sharded mask an experiment."""
    masks = torch.nn.functional.pad(masks, (0, n_rows - masks.shape[1]), value=True)
    return tuple(global_put(m, mesh, "mask") for m in masks)


def _grid_counts(mask: torch.Tensor, n_valids_cell: torch.Tensor) -> torch.Tensor:
    """Per-cell real-row labeled counts of a ``[C, n]`` mask batch whose
    cells have their own real widths ``[C]`` (padding rows are labeled)."""
    valid = torch.arange(mask.shape[1], device=mask.device)[None, :] < n_valids_cell[:, None]
    return (mask & valid).sum(dim=1, dtype=torch.int32)


def _stack_ys(rows: list, with_metrics: bool) -> tuple:
    """Rows of ys stacked along a new leading axis, field by field: a round
    step's per-experiment ys ``[E, ...]``, then a chunk's steps ``[K, E,
    ...]``."""
    from distributed_active_learning_tpu_torch.runtime.telemetry import stack_metrics

    cols = list(zip(*rows))
    ys = tuple(torch.stack(col) for col in cols[:5])
    if with_metrics:
        ys = ys + (stack_metrics(list(cols[5])),)
    return ys


def _experiment_round(round_fn, forest, test_forest, state, aux, window, cap, end_round,
                      accuracy, costs=None):
    """One experiment's round on its evaluated forests: the padded round
    (with its cost vector under ``cost_budget``), the accuracy, and the
    masked no-op past its own stop; ``(out_state, ys)``."""
    n_labeled = state_lib.labeled_count(state)
    active = (n_labeled < cap) & (state.round < end_round)
    new_state, picked, _, *rm = round_fn(forest, state, aux, window, costs)
    acc = accuracy(test_forest)
    out = state_lib.select_state(active, new_state, state)
    return out, (state.round + 1, n_labeled, acc, picked.to(torch.int32), active, *rm)


def make_grid_chunk_fn(
    strategies: Sequence[Strategy],
    window_pad: int,
    chunk_size: int,
    fit_fn,
    *,
    n_datasets: int,
    n_seeds: int,
    use_fill: bool = False,
    use_test_fill: bool = False,
    with_metrics: bool = False,
    n_classes: int = 2,
    scenarios=None,
    drift_dirs=None,
    mesh=None,
    static_n_valid: int = -1,
):
    """``chunk_size`` rounds of the whole S x D x E grid as one launch; a
    sweep is the grid of one strategy and one dataset.

    Cells are laid out strategy-major (cell c = g*D*E + d*E + e), so each
    strategy group is a contiguous slice of the cell axis running its own
    round. ``strategies`` holds one strategy a group; ``fit_fn`` is
    ``runtime.loop._device_fit_core``'s ``fit(codes, edges, state, key)``.
    ``grid_chunk_fn(codes, x, oracle_y, grid, seed_masks, lal_forests,
    fit_keys, windows, test_x, test_y, end_rounds, label_caps, edges,
    n_valids, test_ns) -> (new_grid, extras, ys)``: the pool arrays stacked
    ``[D, ...]``, the carry and the per-cell vectors ``[C, ...]``,
    ``lal_forests`` one regressor (or None) a group, ``n_valids`` and
    ``test_ns`` ``[D]`` each dataset's real pool and test rows; every y is
    stacked ``[chunk_size, C, ...]``. ``use_fill`` gives each cell's state
    the fill watermark of its dataset (pools of unequal widths);
    ``use_test_fill`` masks the accuracy to the real test rows (test sets of
    unequal widths). ``extras.n_labeled_after`` is ``-max_c(label_cap_c -
    count_c)``, >= 0 exactly when every cell reached its own cap, so
    ``ChunkDriveControl`` drives the batch with ``label_cap = 0``;
    ``extras.n_active`` is the max active-round count.

    A round step fits every cell's forest one after another, walks each
    dataset's cells' forests in one stacked K1 launch on its pool and one on
    its test set (``forest_eval.evaluated_many``), then runs each cell's
    padded round and a masked no-op past its own stop. The body reads
    nothing back to the host, so :class:`~.loop.GraphedChunk` captures its
    round step (:func:`~.loop.chunk_of`, the carry at 3; ``input_args=(10,
    11, 13, 14)``).

    ``scenarios`` (one :class:`~..config.ScenarioConfig` a group, the JAX
    package's grid spelling) gives each group its own scenario round, and
    the chunk two more arguments: ``flip_masks [C, n]`` (each cell's oracle
    view, read by its fit and its round, is the dataset's labels with its
    flips applied) and ``costs_ds [D, n]`` (each dataset's cost vector, read
    by the knapsack of a ``cost_budget`` group). A ``drift`` group's cells
    measure their accuracy on their own drifted test set, at their own round
    (``drift_dirs``: the mean-shift direction of each group, or None), one K1
    launch a cell; every other cell's test set stays in its dataset's
    stacked launch. The scenario metrics are emitted by every group alike
    (one set of metric fields across the cells); ``run_grid`` keeps each
    cell's own.

    Under a ``mesh`` the pool arrays are tuples of ``D`` row-sharded arrays
    (the test sets too), the carry's mask a tuple of ``C`` row-sharded
    masks, each cell's forest is placed by trees on the mesh inside the step
    (``runtime.loop._mesh_placement``), and its state reads
    ``static_n_valid`` real rows (the data-axis pad of equal widths) or the
    per-shard fill watermark of its dataset (``use_fill``)."""
    from distributed_active_learning_tpu_torch.runtime.loop import (
        _accuracy,
        _accuracy_masked,
        _mesh_placement,
        chunk_of,
        make_padded_round_fn,
    )
    from distributed_active_learning_tpu_torch.runtime.pipeline import ChunkExtras

    G, D, E = len(strategies), n_datasets, n_seeds
    C = G * D * E
    scn_on = scenarios is not None
    if scn_on and len(scenarios) != G:
        raise ValueError(f"{len(scenarios)} scenarios for {G} strategy groups")
    scns = list(scenarios) if scn_on else [None] * G
    emit_rare = any(s is not None and s.kind == "rare_event" for s in scns)
    emit_cost = any(s is not None and s.kind == "cost_budget" for s in scns)
    round_fns = [make_padded_round_fn(s, window_pad, with_metrics=with_metrics,
                                      n_classes=n_classes, scenario=scns[g],
                                      emit_rare=emit_rare, emit_cost=emit_cost)
                 for g, s in enumerate(strategies)]
    drifts = [s is not None and s.kind == "drift" and s.drift_rate > 0.0 for s in scns]
    costed = [s is not None and s.kind == "cost_budget" for s in scns]
    drift_dirs = list(drift_dirs) if drift_dirs is not None else [None] * G
    cells_of = [[c for c in range(C) if (c // E) % D == d] for d in range(D)]
    place = _mesh_placement(mesh)

    def step(codes, x, oracle_y, grid: SweepState, seed_masks, lal_forests, fit_keys, windows,
             test_x, test_y, end_rounds, label_caps, edges, n_valids, test_ns, flip_masks=None,
             costs_ds=None):
        from distributed_active_learning_tpu_torch.scenarios import engine as scn_engine

        xs, oys, txs, tys = ([t[d] for d in range(D)] for t in (x, oracle_y, test_x, test_y))
        fills = [None] * D
        if use_fill:
            fills = [n_valids[d] if mesh is None else
                     shard_fill_watermark(n_valids[d], xs[d].shape[0], mesh.shape["data"])
                     for d in range(D)]
        states = []
        for c in range(C):
            d = (c // E) % D
            oy = oys[d] if not scn_on else scn_engine.apply_flips(oys[d], flip_masks[c],
                                                                  n_classes)
            states.append(state_lib.PoolState(
                x=xs[d], oracle_y=oy, labeled_mask=grid.labeled_mask[c], key=grid.key[c],
                round=grid.round[c], n_valid_static=static_n_valid, n_filled=fills[d]))
        forests = [place(fit_fn(codes[(c // E) % D], edges[(c // E) % D], st,
                                prng.fold_in(fit_keys[c], st.round + 1)))
                   for c, st in enumerate(states)]
        pool_forests, test_forests = [None] * C, list(forests)
        for d, cells in enumerate(cells_of):
            for c, pf in zip(cells, forest_eval.evaluated_many([forests[c] for c in cells], xs[d])):
                pool_forests[c] = pf
            # A drift cell's test set is its own (drifted at its round): it
            # is walked alone, inside its accuracy below.
            steady = [c for c in cells if not drifts[c // (D * E)]]
            for c, tf in zip(steady, forest_eval.evaluated_many([forests[c] for c in steady],
                                                                txs[d])):
                test_forests[c] = tf
        outs, per_cell = [], []
        for c, st in enumerate(states):
            g, d = c // (D * E), (c // E) % D

            def accuracy(f, d=d, g=g, rnd=st.round):
                tx = txs[d]
                if drifts[g]:
                    tx = scn_engine.drift_apply(scns[g], tx, rnd, direction=drift_dirs[g])
                if use_test_fill:
                    return _accuracy_masked(f, tx, tys[d], test_ns[d])
                return _accuracy(f, tx, tys[d])

            out, ys = _experiment_round(
                round_fns[g], pool_forests[c], test_forests[c], st,
                StrategyAux(lal_forest=lal_forests[g], seed_mask=seed_masks[c]), windows[c],
                label_caps[c], end_rounds[c], accuracy,
                costs=costs_ds[d] if costed[g] else None)
            outs.append(out)
            per_cell.append(ys)
        masks = [o.labeled_mask for o in outs]
        new = SweepState(labeled_mask=tuple(masks) if mesh is not None else torch.stack(masks),
                         key=torch.stack([o.key for o in outs]),
                         round=torch.stack([o.round for o in outs]))
        return new, _stack_ys(per_cell, with_metrics)

    def finish(steps, codes, x, oracle_y, grid, seed_masks, lal_forests, fit_keys, windows,
               test_x, test_y, end_rounds, label_caps, edges, n_valids, test_ns,
               flip_masks=None, costs_ds=None):
        ys = _stack_ys(steps, with_metrics)
        n_valids_cell = torch.repeat_interleave(n_valids, E).repeat(G)
        remaining = label_caps - _grid_counts(_global_masks(grid.labeled_mask), n_valids_cell)
        extras = ChunkExtras(
            n_labeled_after=-remaining.max(),
            n_active=ys[4].sum(dim=0, dtype=torch.int32).max(),
        )
        return extras, ys

    return chunk_of(step, finish, chunk_size, carry_arg=3)


def _resolve_sweep_fit_budget(cfg: ExperimentConfig, n_pool: int, n_labeled_max: int,
                              window_pad: int) -> int:
    """The fit window's static row capacity, covering the widest experiment
    of the batch (``runtime.loop._resolve_fit_budget``'s twin: every
    experiment's fit shares it)."""
    if cfg.forest.fit_budget is not None:
        return min(cfg.forest.fit_budget, n_pool)
    caps = [n_pool]
    if cfg.label_budget is not None:
        caps.append(cfg.label_budget + window_pad)
    if cfg.max_rounds is not None:
        caps.append(n_labeled_max + cfg.max_rounds * window_pad)
    return min(caps)


def _sweep_mesh(cfg: ExperimentConfig, dev, devices):
    """The device mesh of a batched run (``parallel.mesh.make_mesh`` on
    ``devices``, as ``run_experiment`` builds it), or None without one."""
    if cfg.mesh.data * cfg.mesh.model <= 1:
        return None
    from distributed_active_learning_tpu_torch.parallel.mesh import make_mesh

    if cfg.forest.n_trees % cfg.mesh.model:
        raise ValueError(f"n_trees={cfg.forest.n_trees} not divisible by mesh model axis "
                         f"{cfg.mesh.model}")
    mesh = make_mesh(data=cfg.mesh.data, model=cfg.mesh.model, devices=devices, device=dev)
    if mesh.first.type != dev.type:
        raise ValueError(f"mesh devices {mesh.devices} do not match device {dev}")
    return mesh


def _shard_pool_rows(a: torch.Tensor, mesh, n_rows: int, replicate: bool):
    """A pool array padded with zero rows to ``n_rows`` and sharded over the
    mesh's data axis (features and codes replicated over ``model``)."""
    return global_put(torch.nn.functional.pad(a, (0, 0) * (a.ndim - 1) + (0, n_rows - a.shape[0])),
                      mesh, "pool" if replicate else "mask")


def _sweep_result_path(path: str, seed: int) -> str:
    """Per-seed results file: ``curve.txt`` -> ``curve_s3.txt``."""
    stem, ext = os.path.splitext(path)
    return f"{stem}_s{seed}{ext}"


def _fit_guard(counts, caps, windows, max_rounds, fit_budget: int) -> None:
    """The whole run's fit-capacity guard, per experiment: the largest
    labeled count any active fit can reach (the serial chunked driver's
    lattice projection) must fit the window; a fit inside a graphed chunk
    cannot raise, and a truncated window would corrupt the curve."""
    worst = 0
    for c0, cap, w in zip(counts, caps, windows):
        j_cap = -(-(cap - c0) // w) - 1
        if max_rounds is not None:
            j_cap = min(max_rounds - 1, j_cap)
        worst = max(worst, c0 + max(j_cap, 0) * w)
    if worst > fit_budget:
        raise ValueError(
            f"up to {worst} labeled rows would exceed the device fit window ({fit_budget}); "
            "raise ForestConfig.fit_budget or lower label_budget/max_rounds")


def _refuse_stream_events(cfg: ExperimentConfig, kind: str) -> None:
    if cfg.stream_round_events:
        raise ValueError(
            f"stream_round_events is not supported by the batched {kind} chunk; per-round "
            "events still arrive at every touchdown via the MetricsWriter, or run the "
            f"{'seeds' if kind == 'sweep' else 'cells'} serially")


def _meta(metrics, cfg, dev, **extra) -> None:
    if metrics is not None:
        from distributed_active_learning_tpu_torch.parallel.multihost import run_meta

        metrics.meta(config=dataclasses.asdict(cfg), backend=dev.type,
                     n_devices=torch.cuda.device_count() if dev.type == "cuda" else 1,
                     **run_meta(), **extra)


def _append_rows(ys, results, n_pools, wall: float, want_metrics: bool, metrics, dbg,
                 log_every: int, tags, labels, kinds=None) -> int:
    """A batched touchdown's host bookkeeping: each row's (experiment's or
    cell's) active rounds appended to its result, with the launch's wall
    split over every active row-round; one ``round`` event a row-round
    (``tags[i]`` first); the log lines; the transfer counter and memory
    gauges. ``kinds`` (a scenario grid's cell scenarios) keeps each cell's
    own scenario metrics only: every group emits both, so that a ``none``
    cell's records carry a clean run's keys. Returns the last round appended
    (-1 for none)."""
    from distributed_active_learning_tpu_torch.runtime import telemetry

    rounds_y, labeled_y, acc_y, _picked_y, active_y = ys[:5]
    active = active_y.numpy()  # [K, rows]
    rounds_np, labeled_np, acc_np = rounds_y.numpy(), labeled_y.numpy(), acc_y.numpy()
    total_active = int(active.sum())
    md = telemetry.stacked_sweep_metrics_to_dicts(ys[5], active) if want_metrics else None
    if md is not None and kinds is not None:
        for i, kind in enumerate(kinds):
            for m in md[i]:
                if kind != "rare_event":
                    m.pop("rare_recall", None)
                if kind != "cost_budget":
                    m.pop("cost_spent", None)
    last = -1
    for i, res in enumerate(results):
        act = active[:, i]
        if not act.any():
            continue
        r_i, l_i, a_i = rounds_np[act, i], labeled_np[act, i], acc_np[act, i]
        res.extend_from_arrays(r_i, l_i, n_pools[i] - l_i, a_i, total_time=wall / total_active,
                               metrics=md[i] if md is not None else None)
        last = max(last, int(r_i[-1]))
        if metrics is not None:
            for j in range(len(r_i)):
                metrics.round(**tags[i], round=int(r_i[j]), n_labeled=int(l_i[j]),
                              accuracy=float(a_i[j]), **(md[i][j] if md is not None else {}))
        if log_every and dbg.enabled:
            for r, nl, a in zip(r_i, l_i, a_i):
                if int(r) % log_every == 0:
                    dbg.debug(f"[{labels[i]}] Iteration {int(r)} -- labeled={int(nl)} "
                              f"accu={float(a) * 100:.2f}")
    if metrics is not None:
        fetched = sum(y.numel() * y.element_size() for y in (active_y, rounds_y, labeled_y, acc_y))
        if want_metrics:
            fetched += telemetry.metrics_nbytes(ys[5])
        metrics.counter("host_transfer_bytes", int(fetched))
        mem = telemetry.device_memory_gauges()
        if mem:
            metrics.gauges(mem)
    return last


def run_sweep(
    cfg: ExperimentConfig,
    seeds: Sequence[int],
    windows: Optional[Sequence[int]] = None,
    bundle=None,
    debugger=None,
    metrics=None,
    device=None,
    devices=None,
) -> List[ExperimentResult]:
    """Run E = len(seeds) AL experiments over one shared pool as one batched
    launch stream on ``device`` (default CUDA; raises without a card unless
    ``device="cpu"``); returns one :class:`ExperimentResult` per seed, with
    its final labeled mask (and the stream's ``pipeline_stats`` and, on the
    card, ``graph_stats``).

    Each seed's records and final mask equal ``run_experiment`` of
    ``dataclasses.replace(cfg, seed=s)`` (with that experiment's
    ``window_size`` when ``windows`` vary) bit for bit, provided
    ``ForestConfig.fit_budget`` is pinned. ``windows`` (one per seed)
    selects the padded-window path; by default every experiment takes
    ``cfg.strategy.window_size``. K = ``cfg.rounds_per_launch`` rounds go in
    each launch (one CUDA graph a chunk on the card).

    A host fit falls back to E serial ``run_experiment`` calls, the JAX
    package's documented behaviour (each seed checkpoints into its own
    ``seed_<s>`` directory). ``fused_round`` is ignored: the padded round is
    unfused, as in the JAX package. Refused by name before any work: a
    device mesh, an active scenario (with a device fit: a scenario sweep is
    :func:`run_grid` with ``scenarios=``, the JAX package's ``ValueError``),
    and ``stream_round_events`` (with a device fit). With ``checkpoint_dir`` and ``checkpoint_every`` one
    ``sweepstate_<round>.npz`` covers every experiment, and a resumed sweep
    continues each experiment from its own round. Under ``cfg.mesh`` the
    pool is sharded over the mesh (``devices`` as ``run_experiment`` takes
    them) and each experiment equals its serial mesh run, which equals the
    single-device run."""
    from distributed_active_learning_tpu_torch.data.datasets import get_dataset
    from distributed_active_learning_tpu_torch.ops import trees_train
    from distributed_active_learning_tpu_torch.runtime import pipeline as pipeline_lib
    from distributed_active_learning_tpu_torch.runtime import telemetry
    from distributed_active_learning_tpu_torch.runtime.debugger import Debugger
    from distributed_active_learning_tpu_torch.runtime.loop import (
        GraphedChunk,
        _validate_quantize,
        build_aux,
        _device_fit_core,
        ckpt_snapshot,
        run_experiment,
    )

    dev = resolve_device(device)
    seeds = [int(s) for s in seeds]
    E = len(seeds)
    if E == 0:
        raise ValueError("run_sweep needs at least one seed")
    windows = ([int(cfg.strategy.window_size)] * E if windows is None
               else [int(w) for w in windows])
    if len(windows) != E:
        raise ValueError(f"{len(windows)} windows for {E} seeds")
    window_pad = max(windows)
    dbg = debugger or Debugger(enabled=False)
    _validate_quantize(cfg)

    if cfg.forest.fit != "device":
        out = []
        for s, w in zip(seeds, windows):
            scfg = dataclasses.replace(
                cfg, seed=s, strategy=dataclasses.replace(cfg.strategy, window_size=w),
                results_path=_sweep_result_path(cfg.results_path, s) if cfg.results_path else None,
                checkpoint_dir=(os.path.join(cfg.checkpoint_dir, f"seed_{s}")
                                if cfg.checkpoint_dir else None))
            out.append(run_experiment(scfg, bundle=bundle, debugger=debugger, metrics=metrics,
                                      device=dev, devices=devices))
        return out
    if cfg.scenario is not None and cfg.scenario.active:
        # Scenario runs sweep through the grid launcher (a seed sweep is its
        # one-strategy shape), as in the JAX package.
        raise ValueError(
            f"scenario {cfg.scenario.kind!r} is not wired into the batched "
            "seed sweep; run it as a grid axis (runtime.sweep.run_grid "
            "scenarios=..., or run.py --scenario with --sweep-seeds, which "
            "routes there)"
        )
    _refuse_stream_events(cfg, "sweep")

    if bundle is None:
        bundle = get_dataset(cfg.data)
    want_metrics = metrics is not None or cfg.collect_metrics
    test_x = torch.as_tensor(np.asarray(bundle.test_x, dtype=np.float32)).to(dev)
    test_y = torch.as_tensor(np.asarray(bundle.test_y, dtype=np.int32)).to(dev)
    host_x = np.ascontiguousarray(bundle.train_x, dtype=np.float32)
    host_y = np.asarray(bundle.train_y, dtype=np.int32)
    n_classes = max(int(host_y.max()) + 1, 2) if host_y.size else 2

    # Each seed's start state as run_experiment draws it, over ONE pool on
    # the device: E masks and keys, not E pools.
    base = state_lib.init_pool_state(host_x, host_y, prng.key(seeds[0]), dev)
    states = [state_lib.set_start_state(base.replace(key=prng.key(s)), cfg.n_start,
                                        n_classes=n_classes) for s in seeds]
    n_pool = base.n_valid
    masks0 = torch.stack([st.labeled_mask for st in states])
    # The strategies' seed masks are the start masks, taken before a restore
    # advances masks0 (as run_experiment builds aux from the start state).
    seed_masks = masks0.clone()
    keys0 = torch.stack([st.key for st in states]).to(dev)
    rounds0 = torch.zeros(E, dtype=torch.int32, device=dev)
    strategy = get_strategy(cfg.strategy)
    lal_forest = build_aux(cfg, states[0]).lal_forest
    del states
    _meta(metrics, cfg, dev, sweep_seeds=seeds, sweep_windows=windows)

    results = [ExperimentResult() for _ in range(E)]
    start_rounds = [0] * E
    ckpt_enabled = bool(cfg.checkpoint_dir and cfg.checkpoint_every)
    ckpt_fp = None
    if ckpt_enabled:
        from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

        ckpt_fp = ckpt_lib.sweep_fingerprint(cfg, seeds, windows)
        restored = ckpt_lib.restore_latest_sweep(cfg.checkpoint_dir, n_valid=n_pool,
                                                 n_experiments=E, fingerprint=ckpt_fp)
        if restored is not None:
            r_masks, r_keys, r_rounds, results = restored
            masks0 = torch.from_numpy(r_masks).to(dev)
            keys0 = torch.from_numpy(r_keys).to(dev)
            rounds0 = torch.from_numpy(r_rounds).to(dev)
            start_rounds = [int(r) for r in r_rounds]
            dbg.debug(f"resumed sweep at rounds {start_rounds}")

    binned = trees_train.make_bins(base.x, cfg.forest.max_bins, quantize=cfg.forest.quantize)
    counts0 = [int(c) for c in masks0.sum(dim=1).cpu()]
    fit_budget = _resolve_sweep_fit_budget(cfg, n_pool, max(counts0), window_pad)
    fit_keys = torch.stack([prng.key(s + 0x5EED) for s in seeds]).to(dev)
    windows_dev = torch.as_tensor(windows, dtype=torch.int32).to(dev)
    label_cap = n_pool if cfg.label_budget is None else min(cfg.label_budget, n_pool)
    end_rounds = torch.as_tensor(
        [sr + cfg.max_rounds if cfg.max_rounds is not None else int(np.iinfo(np.int32).max)
         for sr in start_rounds], dtype=torch.int32).to(dev)

    K = max(int(cfg.rounds_per_launch or 1), 1)
    depth = max(int(cfg.pipeline_depth or 1), 1)
    mesh = _sweep_mesh(cfg, dev, devices)
    # The sweep's chunk is the grid's of one strategy and one dataset: the
    # pool arrays as [1, ...] views (one-tuples of sharded arrays on a
    # mesh), the per-seed windows as the per-cell vector.
    shared = (binned.codes[None], base.x[None], base.oracle_y[None])
    test_x_d, edges_d = test_x[None], binned.edges[None]
    static_n_valid = -1
    if mesh is not None:
        n_rows = n_pool + (-n_pool) % cfg.mesh.data
        static_n_valid = n_pool if n_rows != n_pool else -1
        shared = tuple((_shard_pool_rows(a[0], mesh, n_rows, replicate=i != 2),)
                       for i, a in enumerate(shared))
        test_x_d = (global_put(test_x, mesh, "pool"),)
        masks0 = _shard_masks(masks0, mesh, n_rows)
        seed_masks = _shard_masks(seed_masks, mesh, n_rows)
    body = make_grid_chunk_fn([strategy], window_pad, K,
                              _device_fit_core(cfg, fit_budget, n_classes), n_datasets=1,
                              n_seeds=E, with_metrics=want_metrics, n_classes=n_classes,
                              mesh=mesh, static_n_valid=static_n_valid)
    chunk = (GraphedChunk(body, input_args=(10, 11, 13, 14))
             if dev.type == "cuda" else body)
    launches = telemetry.LaunchTracker(metrics, "sweep_chunk_scan", fn=chunk)
    # The stop/veto arithmetic over the batch-reduced scalars, shifted by the
    # cap as the grid's: the lattice of the MIN known count and the MIN
    # window can only under-veto, and the MAX active rounds a chunk count the
    # laggard, the one max_rounds bounds.
    ctl = pipeline_lib.ChunkDriveControl(K, min(windows), 0, cfg.max_rounds,
                                         min(counts0) - label_cap, max(start_rounds))
    if not ctl.already_done:
        _fit_guard(counts0, [label_cap] * E, windows, cfg.max_rounds, fit_budget)

    carry = SweepState(labeled_mask=masks0, key=keys0, round=rounds0)
    snapshots = pipeline_lib.CarrySnapshots(ckpt_snapshot)
    tail = (seed_masks, (lal_forest,), fit_keys, windows_dev, test_x_d, test_y[None],
            end_rounds, torch.full((E,), label_cap, dtype=torch.int32, device=dev),
            edges_d, torch.tensor([n_pool], dtype=torch.int32, device=dev),
            torch.tensor([test_y.shape[0]], dtype=torch.int32, device=dev))

    def dispatch(sw, idx):
        out = chunk(*shared, sw, *tail)
        if ckpt_enabled:
            snapshots.take(idx, out[0].labeled_mask, out[0].key, out[0].round)
        return out

    tags = [dict(exp=e, seed=s) for e, s in enumerate(seeds)]
    labels = [f"seed {s}" for s in seeds]

    def touchdown(idx, _n_labeled_after, n_active, ys, _out, wall):
        snap = snapshots.pop(idx)
        if n_active == 0:
            return
        last = _append_rows(ys, results, [n_pool] * E, wall, want_metrics, metrics, dbg,
                            cfg.log_every, tags, labels)
        ctl.note_round(max(ctl.round_idx, last))
        if ckpt_enabled and ctl.checkpoint_due(cfg.checkpoint_every):
            from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

            s_masks, s_keys, s_rounds = snap
            ckpt_lib.save_sweep(cfg.checkpoint_dir, s_masks, s_keys, s_rounds, results,
                                n_valid=n_pool, fingerprint=ckpt_fp)
            ctl.checkpoint_done()

    stats = None
    if not ctl.already_done:
        carry, stats = pipeline_lib.run_pipelined(
            carry, dispatch=dispatch, touchdown=touchdown, continue_after=ctl.continue_after,
            depth=depth, on_launch=launches.record, may_dispatch=ctl.may_dispatch,
            on_veto=lambda idx: launches.veto(idx, ctl.veto_reason(idx)))
    graph_stats = chunk.stats() if isinstance(chunk, GraphedChunk) else None
    final = _global_masks(carry.labeled_mask)
    for e, res in enumerate(results):
        res.final_labeled_mask = final[e, :n_pool].clone()
        res.pipeline_stats, res.graph_stats = stats, graph_stats
    if cfg.results_path:
        for s, res in zip(seeds, results):
            res.save(_sweep_result_path(cfg.results_path, s), fmt="reference")
    return results


# ---------------------------------------------------------------------------
# The grid: strategies x datasets x seeds as one launch stream
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GridCell:
    """One (strategy, dataset, seed[, scenario]) cell of a grid run."""

    strategy: str
    dataset: str
    seed: int
    window: int
    scenario: str = "none"
    result: ExperimentResult = dataclasses.field(default_factory=ExperimentResult)


@dataclasses.dataclass
class GridResult:
    """Every cell of one grid launch stream in cell order (strategy-major,
    then dataset, then seed), and its launch accounting:
    ``recompiles_after_warmup`` counts the chunk's CUDA graph captures after
    the first (the port's recompile; 0 without a graph, on the CPU).
    ``pipeline_stats`` and ``graph_stats`` are the stream's, as an
    ``ExperimentResult`` carries them."""

    cells: List[GridCell]
    launches: int = 0
    recompiles_after_warmup: int = 0
    serial_fallback: bool = False
    pipeline_stats: Optional[object] = None
    graph_stats: Optional[dict] = None

    def cell(self, strategy: str, dataset: str, seed: int,
             scenario: Optional[str] = None) -> GridCell:
        """The cell of (strategy, dataset, seed), of ``scenario`` when the
        grid has a scenario axis (else the first such cell)."""
        for c in self.cells:
            if (c.strategy, c.dataset, c.seed) == (strategy, dataset, int(seed)):
                if scenario is None or c.scenario == scenario:
                    return c
        raise KeyError(f"no grid cell ({strategy}, {dataset}, {seed}, {scenario})")

    def results_for(self, strategy: str, dataset: Optional[str] = None,
                    scenario: Optional[str] = None) -> List[ExperimentResult]:
        """One strategy's results in seed order (optionally of one dataset
        and one scenario): what ``results.strategy_curves`` stacks."""
        return [c.result for c in self.cells
                if c.strategy == strategy and (dataset is None or c.dataset == dataset)
                and (scenario is None or c.scenario == scenario)]


def _grid_result_path(path: str, strategy: str, dataset: str, seed: int,
                      with_dataset: bool, scenario: str = "none",
                      with_scenario: bool = False) -> str:
    """Per-cell results file: ``curve.txt`` -> ``curve_margin_s3.txt`` (with
    the dataset's name once the grid has a dataset axis, and the scenario's
    once it has a scenario axis)."""
    stem, ext = os.path.splitext(path)
    ds = f"_{dataset}" if with_dataset else ""
    sc = f"_{scenario}" if with_scenario else ""
    return f"{stem}_{strategy}{ds}{sc}_s{seed}{ext}"


def run_grid(
    cfg: ExperimentConfig,
    strategies: Sequence[str],
    seeds: Sequence[int],
    datasets: Optional[Sequence[str]] = None,
    windows: Optional[Sequence[int]] = None,
    scenarios=None,
    bundles=None,
    debugger=None,
    metrics=None,
    device=None,
    devices=None,
) -> GridResult:
    """Run the strategies x datasets x seeds grid as ONE pipelined launch
    stream on ``device`` (default CUDA; ``device="cpu"`` for the plain
    versions); returns a :class:`GridResult`, one ``ExperimentResult`` a
    cell (with its final labeled mask over its dataset's real rows).

    Each cell's records and final mask equal ``run_experiment`` of the cell
    (strategy, dataset and seed substituted into ``cfg``) bit for bit,
    provided ``ForestConfig.fit_budget`` is pinned and, for datasets of
    unequal pool widths, the strategy draws no per-row randomness
    (``random``'s uniform vector is shaped by the padded slab: such cells
    agree with the JAX package's ``run_grid``, not with the serial run).

    ``windows`` is one reveal width a STRATEGY (default
    ``cfg.strategy.window_size``); ``bundles`` maps dataset names to
    ``DataBundle`` s (else the registry loads them). A host fit, or datasets
    that disagree on feature width or class count, fall back to the serial
    S x D x E loop of ``run_experiment`` calls (``serial_fallback`` is then
    True), as in the JAX package. ``scenarios`` (kind names or
    :class:`~..config.ScenarioConfig` s; by default ``cfg.scenario`` when it
    is active) is the scenario axis, crossed with the strategies into
    scenario-major groups (cells in (scenario, strategy, dataset, seed)
    order, ``GridCell.scenario`` naming each); an axis of ``none`` only is
    the clean grid, and duplicate kinds are refused. Each cell equals its
    serial ``run_experiment`` under its scenario. Refused before any work,
    with the JAX package's ``ValueError`` s: a scenario axis with a host
    fit or under a mesh, and ``stream_round_events`` (with a device fit).
    Under ``cfg.mesh`` (``devices`` as ``run_experiment`` takes them) each
    cell equals its serial mesh run. The
    ops plane shows the gauges ``grid_cells``, ``grid_cells_frozen``,
    ``grid_eta_seconds`` (0 once the stream is over) and the counter
    ``grid_cell_rounds``. Checkpoints write one ``gridstate_<round>.npz``
    covering every cell."""
    from distributed_active_learning_tpu_torch.data.datasets import get_dataset
    from distributed_active_learning_tpu_torch.ops import trees_train
    from distributed_active_learning_tpu_torch.runtime import pipeline as pipeline_lib
    from distributed_active_learning_tpu_torch.runtime import telemetry
    from distributed_active_learning_tpu_torch.runtime.debugger import Debugger
    from distributed_active_learning_tpu_torch.runtime.loop import (
        GraphedChunk,
        _validate_quantize,
        _device_fit_core,
        ckpt_snapshot,
        run_experiment,
    )

    dev = resolve_device(device)
    strategies = [str(s) for s in strategies]
    seeds = [int(s) for s in seeds]
    datasets = [cfg.data.name] if datasets is None else [str(d) for d in datasets]
    S, E, D = len(strategies), len(seeds), len(datasets)
    if S == 0 or E == 0 or D == 0:
        raise ValueError("run_grid needs at least one strategy, seed, and dataset")
    windows = ([int(cfg.strategy.window_size)] * S if windows is None
               else [int(w) for w in windows])
    if len(windows) != S:
        raise ValueError(f"{len(windows)} windows for {S} strategies")
    window_pad = max(windows)
    dbg = debugger or Debugger(enabled=False)

    # The scenario axis, normalized as the JAX package's: None (the clean
    # grid, its program unchanged) or ScenarioConfigs crossed with the
    # strategies into scenario-major groups.
    from distributed_active_learning_tpu_torch.config import ScenarioConfig

    if scenarios is None and cfg.scenario is not None and cfg.scenario.active:
        scenarios = [cfg.scenario]
    scn_list = None
    if scenarios is not None:
        scn_list = [s if isinstance(s, ScenarioConfig) else ScenarioConfig(kind=str(s))
                    for s in scenarios]
        if not scn_list:
            raise ValueError("run_grid scenarios axis must not be empty")
        kinds = [s.kind for s in scn_list]
        if len(set(kinds)) != len(kinds):
            raise ValueError(f"duplicate scenario kinds in grid axis: {kinds}")
        if not any(s.active for s in scn_list):
            scn_list = None  # an all-none axis is the clean grid
    scenario_axis = scn_list is not None
    _validate_quantize(cfg)
    group_scns = None
    if scenario_axis:
        if cfg.forest.fit != "device":
            raise ValueError(
                "scenario grid axes run inside the jitted round and need "
                "the device fit; use --fit device"
            )
        if cfg.mesh.data * cfg.mesh.model > 1:
            raise ValueError(
                "scenario grid axes are single-device for now (the sharded "
                "scenario round rides the pod-sharding ROADMAP item)"
            )
        base_strategies, base_windows = list(strategies), list(windows)
        strategies = [st for _ in scn_list for st in base_strategies]
        windows = [w for _ in scn_list for w in base_windows]
        group_scns = [sc for sc in scn_list for _ in base_strategies]
        S = len(strategies)
    scn_by_kind = {sc.kind: sc for sc in scn_list} if scenario_axis else {}

    def cells_in_order():
        return [GridCell(strategy=s, dataset=d, seed=e, window=w,
                         scenario=group_scns[g].kind if scenario_axis else "none")
                for g, (s, w) in enumerate(zip(strategies, windows))
                for d in datasets for e in seeds]

    bundle_cache = {}

    def bundle_of(name):
        # Once a dataset: the serial fallback asks once a cell.
        if bundles is not None and name in bundles:
            return bundles[name]
        if name not in bundle_cache:
            bundle_cache[name] = get_dataset(dataclasses.replace(cfg.data, name=name))
        return bundle_cache[name]

    def serial_fallback(reason: str) -> GridResult:
        dbg.debug(f"grid launcher falling back to serial cells: {reason}")
        cells = cells_in_order()
        for c in cells:
            scn = scn_by_kind.get(c.scenario)
            sc_tag = f"_{scn.kind}" if scn is not None and scn.active else ""
            ccfg = dataclasses.replace(
                cfg, seed=c.seed, data=dataclasses.replace(cfg.data, name=c.dataset),
                strategy=dataclasses.replace(cfg.strategy, name=c.strategy, window_size=c.window),
                scenario=scn if scn is not None else ScenarioConfig(),
                results_path=(_grid_result_path(cfg.results_path, c.strategy, c.dataset, c.seed,
                                                 D > 1, c.scenario, scenario_axis)
                              if cfg.results_path else None),
                checkpoint_dir=(os.path.join(cfg.checkpoint_dir,
                                             f"{c.strategy}_{c.dataset}{sc_tag}_seed_{c.seed}")
                                if cfg.checkpoint_dir else None))
            c.result = run_experiment(ccfg, bundle=bundle_of(c.dataset), debugger=debugger,
                                      metrics=metrics, device=dev, devices=devices)
        return GridResult(cells=cells, serial_fallback=True)

    if cfg.forest.fit != "device":
        return serial_fallback("host fit")
    _refuse_stream_events(cfg, "grid")

    ds_bundles = [bundle_of(d) for d in datasets]
    if len({np.asarray(b.train_x).shape[-1] for b in ds_bundles}) > 1 or any(
            np.asarray(b.train_x).ndim != 2 for b in ds_bundles):
        return serial_fallback("datasets disagree on feature width")
    n_classes_per = [max(int(np.asarray(b.train_y).max()) + 1, 2)
                     if np.asarray(b.train_y).size else 2 for b in ds_bundles]
    if len(set(n_classes_per)) > 1:
        return serial_fallback("datasets disagree on class count")
    n_classes = n_classes_per[0]
    want_metrics = metrics is not None or cfg.collect_metrics

    # Every dataset padded to one slab width; equal widths keep the static
    # path (no watermark), unequal ones ride the fill watermark.
    n_valids_host = [int(np.asarray(b.train_y).shape[0]) for b in ds_bundles]
    n_store = max(n_valids_host)  # the checkpoint's mask width (no mesh pad)
    mesh = _sweep_mesh(cfg, dev, devices)
    n_slab = n_store + ((-n_store) % cfg.mesh.data if mesh is not None else 0)
    test_ns_host = [int(np.asarray(b.test_y).shape[0]) for b in ds_bundles]
    t_slab = max(test_ns_host)
    use_fill = len(set(n_valids_host)) > 1
    use_test_fill = len(set(test_ns_host)) > 1
    # Equal widths padded to the data axis keep the static real-row count.
    static_n_valid = n_valids_host[0] if not use_fill and n_slab != n_store else -1

    xs, oys, codes_l, edges_l, txs, tys, starts = [], [], [], [], [], [], []
    for b, n_d, t_d in zip(ds_bundles, n_valids_host, test_ns_host):
        host_x = np.ascontiguousarray(b.train_x, dtype=np.float32)
        host_y = np.asarray(b.train_y, dtype=np.int32)
        # run_experiment's start draw per (dataset, seed), on the unpadded
        # pool; the masks are padded below with labeled sentinel rows.
        base = state_lib.init_pool_state(host_x, host_y, prng.key(seeds[0]), dev)
        starts.append([state_lib.set_start_state(base.replace(key=prng.key(s)), cfg.n_start,
                                                 n_classes=n_classes) for s in seeds])
        binned = trees_train.make_bins(base.x, cfg.forest.max_bins, quantize=cfg.forest.quantize)
        pad = n_slab - n_d
        xs.append(torch.nn.functional.pad(base.x, (0, 0, 0, pad)))
        oys.append(torch.nn.functional.pad(base.oracle_y, (0, pad)))
        codes_l.append(torch.nn.functional.pad(binned.codes, (0, 0, 0, pad)))
        edges_l.append(binned.edges)
        txs.append(torch.nn.functional.pad(
            torch.as_tensor(np.asarray(b.test_x, dtype=np.float32)).to(dev), (0, 0, 0, t_slab - t_d)))
        tys.append(torch.nn.functional.pad(
            torch.as_tensor(np.asarray(b.test_y, dtype=np.int32)).to(dev), (0, t_slab - t_d)))
    if mesh is None:
        x, oracle_y, codes = torch.stack(xs), torch.stack(oys), torch.stack(codes_l)
        test_x = torch.stack(txs)
    else:  # each dataset's pool sharded over the mesh (already padded to n_slab)
        x = tuple(global_put(a, mesh, "pool") for a in xs)
        oracle_y = tuple(global_put(a, mesh, "mask") for a in oys)
        codes = tuple(global_put(a, mesh, "pool") for a in codes_l)
        test_x = tuple(global_put(a, mesh, "pool") for a in txs)
    edges, test_y = torch.stack(edges_l), torch.stack(tys)
    del xs, oys, codes_l, edges_l, txs, tys
    n_valids = torch.as_tensor(n_valids_host, dtype=torch.int32).to(dev)
    test_ns = torch.as_tensor(test_ns_host, dtype=torch.int32).to(dev)

    # Per-cell vectors in cell order (strategy-major, then dataset, seed).
    C = S * D * E
    order = [(g, d, e) for g in range(S) for d in range(D) for e in range(E)]
    masks0 = torch.stack([torch.nn.functional.pad(starts[d][e].labeled_mask,
                                                  (0, n_slab - n_valids_host[d]), value=True)
                          for _g, d, e in order])
    seed_masks = masks0.clone()
    keys0 = torch.stack([starts[d][e].key for _g, d, e in order]).to(dev)
    del starts
    rounds0 = torch.zeros(C, dtype=torch.int32, device=dev)
    fit_keys = torch.stack([prng.key(seeds[e] + 0x5EED) for _g, _d, e in order]).to(dev)
    windows_by_cell = [windows[g] for g, _d, _e in order]
    windows_cell = torch.as_tensor(windows_by_cell, dtype=torch.int32).to(dev)
    caps_host = [n_valids_host[d] if cfg.label_budget is None
                 else min(cfg.label_budget, n_valids_host[d]) for _g, d, _e in order]
    label_caps = torch.as_tensor(caps_host, dtype=torch.int32).to(dev)
    nv_cell_host = [n_valids_host[d] for _g, d, _e in order]

    strat_objs, lal_forests = [], []
    for s, w in zip(strategies, windows):
        scfg = dataclasses.replace(cfg.strategy, name=s, window_size=w)
        strat_objs.append(get_strategy(scfg))
        if s == "lal":  # one regressor a group
            from distributed_active_learning_tpu_torch.models.lal_training import (
                load_or_train_lal_regressor,
            )

            lal_forests.append(load_or_train_lal_regressor(dict(scfg.options), dev))
        else:
            lal_forests.append(None)
    lal_forests = tuple(lal_forests)

    # The scenario inputs: a flip mask a cell, a cost vector a dataset (each
    # padded to the slab) and the mean-shift direction of each drift group.
    scn_tail, drift_dirs = (), None
    if scenario_axis:
        from distributed_active_learning_tpu_torch.scenarios import engine as scn_engine

        for sc, so in zip(group_scns, strat_objs):
            scn_engine.validate_scenario(sc, strategy=so, max_rounds=cfg.max_rounds)
        flip_masks = torch.stack([
            torch.nn.functional.pad(
                scn_engine.flip_mask(group_scns[g], seeds[e], n_valids_host[d], dev),
                (0, n_slab - n_valids_host[d]))
            for g, d, e in order])
        cost_scn = next((sc for sc in scn_list if sc.kind == "cost_budget"), None)
        costs_ds = torch.stack([
            torch.nn.functional.pad(
                scn_engine.make_costs(cost_scn, n_valids_host[d], name, dev)
                if cost_scn is not None else torch.ones(n_valids_host[d], device=dev),
                (0, n_slab - n_valids_host[d]), value=1.0)
            for d, name in enumerate(datasets)])
        scn_tail = (flip_masks, costs_ds)
        drift_dirs = [scn_engine.drift_direction(sc, x.shape[-1], dev)
                      if sc.kind == "drift" and sc.drift_kind == "mean_shift" else None
                      for sc in group_scns]
    _meta(metrics, cfg, dev, grid_strategies=strategies, grid_seeds=seeds,
          grid_datasets=datasets, grid_windows=windows,
          grid_scenarios=[sc.kind for sc in group_scns] if scenario_axis else None)

    cells = cells_in_order()
    start_rounds = [0] * C
    ckpt_enabled = bool(cfg.checkpoint_dir and cfg.checkpoint_every)
    ckpt_fp = None
    if ckpt_enabled:
        from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

        ckpt_fp = ckpt_lib.grid_fingerprint(
            cfg, strategies, seeds, datasets, windows,
            scenarios=[sc.kind for sc in scn_list] if scenario_axis else None)
        restored = ckpt_lib.restore_latest_grid(cfg.checkpoint_dir, n_store=n_store, n_cells=C,
                                                fingerprint=ckpt_fp)
        if restored is not None:
            r_masks, r_keys, r_rounds, r_results = restored
            masks0 = torch.nn.functional.pad(torch.from_numpy(r_masks).to(dev),
                                             (0, n_slab - n_store), value=True)
            keys0 = torch.from_numpy(r_keys).to(dev)
            rounds0 = torch.from_numpy(r_rounds).to(dev)
            start_rounds = [int(r) for r in r_rounds]
            for c, res in zip(cells, r_results):
                c.result = res
            dbg.debug(f"resumed grid at rounds {start_rounds}")

    counts0 = [int(c) for c in _grid_counts(
        masks0, torch.as_tensor(nv_cell_host, dtype=torch.int32).to(dev)).cpu()]
    fit_budget = _resolve_sweep_fit_budget(cfg, n_store, max(counts0), window_pad)
    end_rounds = torch.as_tensor(
        [sr + cfg.max_rounds if cfg.max_rounds is not None else int(np.iinfo(np.int32).max)
         for sr in start_rounds], dtype=torch.int32).to(dev)

    K = max(int(cfg.rounds_per_launch or 1), 1)
    depth = max(int(cfg.pipeline_depth or 1), 1)
    body = make_grid_chunk_fn(strat_objs, window_pad, K,
                              _device_fit_core(cfg, fit_budget, n_classes), n_datasets=D,
                              n_seeds=E, use_fill=use_fill, use_test_fill=use_test_fill,
                              with_metrics=want_metrics, n_classes=n_classes,
                              scenarios=group_scns, drift_dirs=drift_dirs, mesh=mesh,
                              static_n_valid=static_n_valid)
    chunk = (GraphedChunk(body, input_args=(10, 11, 13, 14))
             if dev.type == "cuda" else body)
    launches = telemetry.LaunchTracker(metrics, "grid_chunk_scan", fn=chunk)
    # label_cap = 0 and n_known = -max remaining: "every cell reached its
    # cap" is ChunkDriveControl's >= test; the min-window lattice
    # under-estimates every cell's progress, so its vetoes stay safe. An
    # abstaining group reveals less than a window a round, the other way:
    # its grids run with the lattice off (window 0).
    rem0 = max(cap - c0 for cap, c0 in zip(caps_host, counts0))
    abstaining = scenario_axis and any(
        sc.kind == "noisy_oracle" and sc.abstain_prob > 0.0 for sc in group_scns)
    ctl = pipeline_lib.ChunkDriveControl(K, 0 if abstaining else min(windows), 0,
                                         cfg.max_rounds, -rem0, max(start_rounds))
    if not ctl.already_done:
        _fit_guard(counts0, caps_host, windows_by_cell, cfg.max_rounds, fit_budget)

    if mesh is not None:
        masks0 = _shard_masks(masks0, mesh, n_slab)
        seed_masks = _shard_masks(seed_masks, mesh, n_slab)
    carry = SweepState(labeled_mask=masks0, key=keys0, round=rounds0)
    snapshots = pipeline_lib.CarrySnapshots(ckpt_snapshot)

    # Grid progress on the ops plane, from each cell's records: the labeled
    # count of its last round this run (else its count at the start) and
    # its rounds (those of a resumed run included, as the JAX package counts).
    obs.gauge("grid_cells", "cells in the running grid launch").set(C)
    n_records0 = [len(c.result.records) for c in cells]

    def obs_grid_progress(total_active: int) -> None:
        frozen = rem_rounds = 0
        for c in range(C):
            w = windows_by_cell[c]
            recs = cells[c].result.records
            new = len(recs) - n_records0[c]
            rem_budget = caps_host[c] - (recs[-1].n_labeled if new else counts0[c])
            r = -(-rem_budget // w) if (w > 0 and rem_budget > 0) else 0
            if cfg.max_rounds is not None:
                r = min(r, max(cfg.max_rounds - (start_rounds[c] + new), 0))
            if r <= 0:
                frozen += 1
            rem_rounds = max(rem_rounds, r)
        obs.counter("grid_cell_rounds", "active cell-rounds completed across the grid").inc(
            total_active)
        obs.gauge("grid_cells_frozen", "cells stopped while the grid stream runs on").set(frozen)
        steady = launches.steady_seconds_mean()
        if steady is not None:
            obs.gauge("grid_eta_seconds",
                      "estimated wall seconds until the slowest cell finishes").set(
                round(-(-rem_rounds // K) * steady, 3))
        obs.heartbeat("grid_touchdown")

    def dispatch(gs, idx):
        out = chunk(codes, x, oracle_y, gs, seed_masks, lal_forests, fit_keys, windows_cell,
                    test_x, test_y, end_rounds, label_caps, edges, n_valids, test_ns, *scn_tail)
        if ckpt_enabled:
            snapshots.take(idx, out[0].labeled_mask, out[0].key, out[0].round)
        return out

    results = [c.result for c in cells]
    tags = [dict(exp=c, strategy=cell.strategy, dataset=cell.dataset, seed=cell.seed,
                 **({"scenario": cell.scenario} if scenario_axis else {}))
            for c, cell in enumerate(cells)]
    labels = [f"{cell.strategy}/{cell.dataset}/seed {cell.seed}" for cell in cells]

    def touchdown(idx, _n_labeled_after, n_active, ys, _out, wall):
        snap = snapshots.pop(idx)
        if n_active == 0:
            return
        last = _append_rows(ys, results, nv_cell_host, wall, want_metrics, metrics, dbg,
                            cfg.log_every, tags, labels,
                            kinds=[cell.scenario for cell in cells] if scenario_axis else None)
        ctl.note_round(max(ctl.round_idx, last))
        obs_grid_progress(int(ys[4].sum()))
        if ckpt_enabled and ctl.checkpoint_due(cfg.checkpoint_every):
            from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

            s_masks, s_keys, s_rounds = snap
            ckpt_lib.save_grid(cfg.checkpoint_dir, s_masks, s_keys, s_rounds,
                               [c.result for c in cells], n_store=n_store, fingerprint=ckpt_fp)
            ctl.checkpoint_done()

    stats = None
    if not ctl.already_done:
        carry, stats = pipeline_lib.run_pipelined(
            carry, dispatch=dispatch, touchdown=touchdown, continue_after=ctl.continue_after,
            depth=depth, on_launch=launches.record, may_dispatch=ctl.may_dispatch,
            on_veto=lambda idx: launches.veto(idx, ctl.veto_reason(idx)))
    # The stream is over: a later scrape reads no remaining wall.
    obs.gauge("grid_eta_seconds", "estimated wall seconds until the slowest cell finishes").set(0.0)
    final = _global_masks(carry.labeled_mask)
    for c, cell in enumerate(cells):
        cell.result.final_labeled_mask = final[c, :nv_cell_host[c]].clone()
    if cfg.results_path:
        for cell in cells:
            cell.result.save(_grid_result_path(cfg.results_path, cell.strategy, cell.dataset,
                                               cell.seed, D > 1, cell.scenario, scenario_axis),
                             fmt="reference")
    captures = getattr(chunk, "captures", 0)
    return GridResult(
        cells=cells,
        launches=launches.calls,
        recompiles_after_warmup=max(captures - 1, 0),
        pipeline_stats=stats,
        graph_stats=chunk.stats() if isinstance(chunk, GraphedChunk) else None,
    )
