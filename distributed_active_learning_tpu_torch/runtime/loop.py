"""The AL driver loop (the port of ``runtime/loop.py``): the per-round branch
and the chunked branch.

Each round: fit the forest on the labeled window on the device
(``ops/trees_train.py``) or on the host with scikit-learn
(``models/forest.py``, then ``forest_eval.for_kernel`` and placement on the
device), score the pool and take the masked top-k (or run the round
megakernel, ``fused_round``), reveal, and measure test accuracy. A device
fit gives the path-matrix form (``kernel`` "gemm" or "pallas", depth <= 10)
or the gather form (``kernel="gather"``, or any depth > 10).
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

Not ported yet, and refused with a ``NotImplementedError`` that names the
slice bringing them: under a mesh the chunked driver, ``kernel`` "gemm" and
"gather", depths past 10, the host fit and the density strategy; scenarios,
checkpoints, metrics writers, quantized storage and multiclass pools.
"""

from __future__ import annotations

import dataclasses
import gc
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


# Where what a mesh does not carry yet is queued.
_MESH_SLICE = "the mesh-and-pod slice (ROADMAP queue 1, \"Mesh and pod\")"


def _not_ported(cfg: ExperimentConfig, metrics) -> None:
    """Refuse what this slice does not carry, naming the slice that will."""
    mesh = cfg.mesh.data * cfg.mesh.model > 1
    refusals = [
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
        (cfg.scenario is not None and cfg.scenario.active,
         "scenarios come with the scenario slice"),
        (bool(cfg.checkpoint_dir and cfg.checkpoint_every),
         "checkpoints come with the checkpoint slice"),
        (metrics is not None or cfg.collect_metrics,
         "metrics writers and RoundMetrics come with the telemetry slice"),
        (cfg.forest.quantize != "none",
         "quantized forest storage comes with the quantization slice"),
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
    """Labeled-window gather + histogram fit + kernel-form conversion: the
    path-matrix form for kernels "gemm" and "pallas" up to depth 10, the
    gather form otherwise."""
    from distributed_active_learning_tpu_torch.ops import trees_train
    from distributed_active_learning_tpu_torch.ops.trees_pallas import PallasForest

    fc = cfg.forest
    to_gemm = fc.kernel in ("gemm", "pallas") and fc.max_depth <= forest_eval._GEMM_MAX_DEPTH

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
        return PallasForest(gf=gf) if fc.kernel == "pallas" else gf

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
):
    """``chunk_size`` AL rounds as one launch, on a single device.

    ``chunk_fn(codes, state, aux, fit_key, test_x, test_y, end_round) ->
    (new_state, extras, (rounds, n_labeled, accuracy, picked, active))``:
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

    The body reads nothing back to the host and uploads nothing: that is
    what lets :class:`GraphedChunk` capture it into a CUDA graph. Metrics,
    scenarios, the in-chunk stream callback and a device mesh wait for their
    slices.
    """
    from distributed_active_learning_tpu_torch.runtime.pipeline import ChunkExtras

    round_fn = make_round_fn(strategy, window_size, fused=fused_round)

    def step(codes, carry: state_lib.PoolState, aux, fit_key, test_x, test_y, end_round):
        n_labeled = state_lib.labeled_count(carry)
        active = (n_labeled < label_cap) & (carry.round < end_round)
        forest = fit_fn(codes, carry, prng.fold_in(fit_key, carry.round + 1))
        new_state, picked, _ = round_fn(forest, carry, aux)
        acc = _accuracy(forest, test_x, test_y)
        out = state_lib.select_state(active, new_state, carry)
        return out, (carry.round + 1, n_labeled, acc, picked.to(torch.int32), active)

    def chunk_fn(codes, state, aux, fit_key, test_x, test_y, end_round):
        ys = []
        for _ in range(chunk_size):
            state, y = step(codes, state, aux, fit_key, test_x, test_y, end_round)
            ys.append(y)
        ys = tuple(torch.stack(col) for col in zip(*ys))
        extras = ChunkExtras(
            n_labeled_after=state_lib.labeled_count(state),
            n_active=ys[4].sum(dtype=torch.int32),
        )
        return state, extras, ys

    chunk_fn.step = step
    return chunk_fn


def _kernel_launch_counts() -> dict:
    """The wrappers' launch counters this module's paths can advance."""
    from distributed_active_learning_tpu_torch.ops import round_fused, trees_pallas

    return {(trees_pallas, "launches"): trees_pallas.launches,
            (round_fused, "launches"): round_fused.launches}


class GraphedChunk:
    """A chunk function as one CUDA graph: the counterpart of the jitted
    launch with a donated carry.

    The first call runs one step of the body eagerly (it builds and loads
    the kernels and fills the per-device constant caches, none of which may
    happen while capturing), copies the carry into static buffers and
    captures the whole chunk on them; that call and every later one replay
    the graph. The graph ends by writing the new carry back into the static
    buffers, so the returned state aliases the one passed to the next call
    (pass it on; any other state is copied in first). The ys and extras are
    static buffers too, overwritten by every replay: copy them out on the
    same stream before the next call (``pipeline.start_host_copy``).

    A capture that fails raises: nothing here falls back to the eager body.

    Counters. ``captures`` and ``replays`` count this object's graph
    captures and replays. The kernel wrappers count a launch where they
    launch, which during a capture records the launch into the graph instead
    of running it: the capture's counts are therefore taken back, kept as
    ``launches_per_replay``, and added to the wrappers' counters at every
    replay, which is where the kernels really run (K rounds' worth per
    replay).
    """

    def __init__(self, chunk_fn):
        self._fn = chunk_fn
        self._graph = None
        self.captures = 0
        self.replays = 0
        self.pool_bytes = 0  # device memory the graph's private pool reserved
        self.launches_per_replay: dict = {}

    def _capture(self, codes, state, aux, fit_key, test_x, test_y, end_round):
        dev = state.x.device
        self._fn.step(codes, state, aux, fit_key, test_x, test_y, end_round)  # warm-up
        self._mask = state.labeled_mask.clone()
        self._key = state.key.clone()
        self._round = state.round.clone()
        self._end = end_round.clone()
        static = state.replace(labeled_mask=self._mask, key=self._key, round=self._round)
        torch.cuda.synchronize(dev)
        before = _kernel_launch_counts()
        # Entering the capture empties the allocator's cache; do it first, so
        # that what is reserved afterwards is the graph's private pool.
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, extras, ys = self._fn(codes, static, aux, fit_key, test_x, test_y, self._end)
            self._mask.copy_(out.labeled_mask)
            self._key.copy_(out.key)
            self._round.copy_(out.round)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        for (mod, name), n in before.items():
            self.launches_per_replay[(mod, name)] = getattr(mod, name) - n
            setattr(mod, name, n)
        self._graph, self._static, self._extras, self._ys = graph, static, extras, ys
        self.captures += 1

    def stats(self) -> dict:
        """Counts for a report: captures, replays, the private pool's bytes,
        and the kernel launches one replay stands for."""
        return {
            "captures": self.captures,
            "replays": self.replays,
            "pool_bytes": self.pool_bytes,
            "launches_per_replay": {f"{mod.__name__.rsplit('.', 1)[-1]}.{name}": n
                                    for (mod, name), n in self.launches_per_replay.items()},
        }

    def __call__(self, codes, state, aux, fit_key, test_x, test_y, end_round):
        if self._graph is None:
            self._capture(codes, state, aux, fit_key, test_x, test_y, end_round)
        elif state.labeled_mask.data_ptr() != self._mask.data_ptr():
            self._mask.copy_(state.labeled_mask)
            self._key.copy_(state.key)
            self._round.copy_(state.round)
        self._end.copy_(end_round)
        self._graph.replay()
        self.replays += 1
        for (mod, name), n in self.launches_per_replay.items():
            setattr(mod, name, getattr(mod, name) + n)
        return self._static, self._extras, self._ys


def _run_chunked(cfg, state, codes, aux, device_fit, fit_key, test_x, test_y, strategy,
                 fit_budget, result, dbg, start_round):
    """The chunked branch of :func:`run_experiment`: K rounds per launch
    through ``pipeline.run_pipelined``. Returns the final state."""
    from distributed_active_learning_tpu_torch.runtime import pipeline as pipeline_lib

    dev = state.x.device
    n_pool = state.n_valid
    K, window = cfg.rounds_per_launch, cfg.strategy.window_size
    label_cap = n_pool if cfg.label_budget is None else min(cfg.label_budget, n_pool)
    depth = max(int(cfg.pipeline_depth or 1), 1)
    chunk_fn = make_chunk_fn(strategy, window, K, device_fit, label_cap,
                             fused_round=cfg.fused_round)
    if dev.type == "cuda":
        chunk_fn = GraphedChunk(chunk_fn)
    # The chunk updates the carried mask in place; at round 0 aux.seed_mask
    # is that mask, so it gets its own copy once up front.
    if aux.seed_mask is not None:
        aux = dataclasses.replace(aux, seed_mask=aux.seed_mask.clone())
    end_round = (start_round + cfg.max_rounds if cfg.max_rounds is not None
                 else int(np.iinfo(np.int32).max))
    # One sync at loop entry; afterwards the loop blocks only on each
    # chunk's two stop scalars.
    n_known = int(state_lib.labeled_count(state))
    ctl = pipeline_lib.ChunkDriveControl(K, window, label_cap, cfg.max_rounds, n_known, start_round)
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

    def dispatch(st, _idx):
        return chunk_fn(codes, st, aux, fit_key_dev, test_x, test_y, end_dev)

    def touchdown(_idx, _n_labeled_after, n_active, ys, _out_state, wall):
        # ys are this chunk's host copies. Runs overlapped with the next
        # chunk's execution when depth > 1.
        if n_active == 0:
            return  # a wholly inactive (speculative tail) chunk
        rounds_y, labeled_y, acc_y, _picked_y, active_y = ys
        active_np = active_y.numpy()
        rounds_np = rounds_y.numpy()[active_np]
        labeled_np = labeled_y.numpy()[active_np]
        acc_np = acc_y.numpy()[active_np]
        result.extend_from_arrays(
            rounds_np, labeled_np, n_pool - labeled_np, acc_np, total_time=wall / n_active)
        if cfg.log_every and dbg.enabled:
            for r, nl, a in zip(rounds_np, labeled_np, acc_np):
                if int(r) % cfg.log_every == 0:
                    dbg.debug(f"Iteration {int(r)} -- labeled={int(nl)} accu={float(a) * 100:.2f}")

    carry, stats = pipeline_lib.run_pipelined(
        carry,
        dispatch=dispatch,
        touchdown=touchdown,
        continue_after=ctl.continue_after,
        depth=depth,
        may_dispatch=ctl.may_dispatch,
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
    if cfg.forest.fit not in ("host", "device"):
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

    host_fit = None
    if cfg.forest.fit == "host":
        host_fit = make_host_fit(cfg, host_x, host_y, n_classes, dev)
        codes = edges = None
    else:
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
    if host_fit is None:
        device_fit = make_device_fit(cfg, edges, fit_budget, n_classes)
    fit_key = prng.key(cfg.seed + 0x5EED)
    sync_devs = {d for row in mesh.devices for d in row} if mesh else {dev}

    def sync():  # keep phase timings honest
        for d in sync_devs:
            synchronize(d)

    n_pool = state.n_valid
    round_idx = state.round
    start_round = round_idx
    if cfg.rounds_per_launch > 1 and host_fit is None:
        state = _run_chunked(
            cfg, state, codes, aux, device_fit, fit_key, test_x, test_y, strategy,
            fit_budget, result, dbg, start_round)
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
