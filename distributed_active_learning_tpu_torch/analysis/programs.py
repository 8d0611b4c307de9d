"""The programs the port's drivers launch, built at their configured shapes
for the pre-flight (``analysis/memory.py``) and the cost model
(``analysis/roofline.py``).

A :class:`ProgramSpec` builds one program on a device: on the meta device
for pricing (its inputs empty tensors of the configured shapes, so nothing
is allocated or launched), or on the card or the CPU with inputs drawn from
a seed, to measure the same program (``chip_smoke.py`` phase 4t holds the
priced footprint against the measured one). The kinds, each the unit the
drivers launch:

- ``fit``, ``round``, ``eval``: the per-round driver's three phases
  (``runtime/loop.py``: the device fit, the round's score + select +
  reveal, the test accuracy);
- ``chunk``: one round step of the chunked driver (``make_chunk_fn``'s
  ``step``: the unit a CUDA graph captures and replays K times a launch);
  a scenario run's is its scenario round (the knapsack, the abstaining or
  flipped oracle, the drifted test set), and a mesh run's lies on the
  configured ``(data, model)`` mesh;
- ``sweep`` and ``grid``: one round step of the batched chunk
  (``runtime/sweep.py`` ``make_grid_chunk_fn``): E seeds of one strategy,
  or the run's exact strategy x dataset x seed (x scenario) cells;
- ``neural_chunk`` and ``neural_sweep``: one round step of the neural
  chunk, and of the neural seed sweep's E lanes
  (``runtime/neural_loop.py``);
- ``serve_score`` and ``serve_chunk``: the service's score endpoint over a
  query block and the round step of a capacity's re-fit chunk
  (``serving/``).

:func:`specs_for_run` gives the programs a run launches at its data's
shapes (the JAX package's ``specs_for_experiment``: the grid of the run's
exact cells, the sweep, the scenario round, the mesh at its configured
shape, LAL with its regressor; :func:`specs_for_experiment` one
experiment's); :func:`build_registry` the port's default set, at the widths
``chip_smoke.py`` drives. Each built :class:`ProgramUnit` also carries what
the program auditor (``analysis/auditor.py``) holds it to: where its carry
is, whether it returns RoundMetrics, its forest storage and its pool rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from distributed_active_learning_tpu_torch.config import (
    ExperimentConfig,
    ForestConfig,
    ServeConfig,
    StrategyConfig,
)

KINDS = ("fit", "round", "eval", "chunk", "sweep", "grid", "neural_chunk", "neural_sweep",
         "serve_score", "serve_chunk")
#: The kinds whose drivers capture the program as a CUDA graph on the card.
GRAPHED_KINDS = frozenset(("chunk", "sweep", "grid", "neural_chunk", "neural_sweep",
                           "serve_chunk"))


@dataclasses.dataclass(frozen=True)
class ProgramUnit:
    """A built program: ``fn(*args)`` is one launch of it. For the
    auditor: ``carry_arg`` is the argument holding the carry that output 0
    returns (None: no carry), ``with_metrics`` whether it returns
    RoundMetrics, ``quantize`` its forest storage, ``pool_rows`` its pool's
    rows."""

    fn: Callable
    args: tuple
    carry_arg: Optional[int] = None
    with_metrics: bool = False
    quantize: Optional[str] = None
    pool_rows: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """A named program and how to build it on a device (``"meta"`` by
    default)."""

    name: str
    kind: str
    make: Callable[[torch.device], ProgramUnit]
    #: Whether the driver captures it, where its kind does not say (a mesh
    #: over processes runs its chunk eagerly).
    graph: Optional[bool] = None

    def build(self, device="meta") -> ProgramUnit:
        return self.make(torch.device(device))

    @property
    def graphed(self) -> bool:
        """Whether the driver runs this program as a CUDA graph, whose
        private pool stays reserved beside the resident inputs."""
        return self.kind in GRAPHED_KINDS if self.graph is None else self.graph


@dataclasses.dataclass(frozen=True)
class ForestShapes:
    """The data shapes a forest experiment runs at."""

    pool_rows: int
    features: int
    test_rows: int
    n_classes: int = 2


@dataclasses.dataclass(frozen=True)
class NeuralShapes:
    """A neural experiment: its network (``"cnn"``, ``"mlp"`` or
    ``"transformer"``), input shape, pool and test rows, classes and the
    loop's knobs (``runtime/neural_loop.py``)."""

    model: str
    input_shape: tuple
    pool_rows: int
    test_rows: int
    n_classes: int
    strategy: str = "deep.entropy"
    window: int = 100
    train_steps: int = 200
    mc_samples: int = 8
    rounds_per_launch: int = 2
    vocab_size: int = 4096
    hidden: tuple = (128, 64)
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 256


def _draw(shape, dtype, device: torch.device, gen: np.random.Generator, high: int = 2):
    """An input tensor: empty on the meta device, else drawn from ``gen``."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if dtype.is_floating_point:
        return torch.from_numpy(gen.normal(size=shape).astype(np.float32)).to(device)
    if dtype == torch.bool:
        return torch.from_numpy(gen.random(size=shape) < 0.5).to(device)
    return torch.from_numpy(gen.integers(0, high, size=shape)).to(dtype).to(device)


def _key(device: torch.device, seed: int) -> torch.Tensor:
    from distributed_active_learning_tpu_torch import prng

    return prng.key(seed, device if device.type != "meta" else "cpu").to(device)


def _start_mask(n: int, n_start: int, device: torch.device, gen) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(n, dtype=torch.bool, device=device)
    mask = np.zeros(n, dtype=bool)
    mask[gen.permutation(n)[:n_start]] = True
    return torch.from_numpy(mask).to(device)


def lal_regressor(options, device: torch.device):
    """The LAL regressor a run's strategy ``options`` name, at its shapes:
    the forest file's (``lal_model_path``, read on the host) where there is
    one, else ``lal_trees`` (200) trees of ``lal_depth`` (10) levels, each
    of ``2^(depth + 1) - 1`` nodes (the most a fit of that depth packs
    into). On the meta device only the shapes; elsewhere (a measurement of
    the same program) the file's forest, or a random one of those shapes
    (``models.forest.synthetic_forest``). Never fits one."""
    import os

    from distributed_active_learning_tpu_torch.models import forest_io
    from distributed_active_learning_tpu_torch.models.forest import synthetic_forest
    from distributed_active_learning_tpu_torch.ops.trees import PackedForest

    path = options.get("lal_model_path")
    if path and os.path.exists(path):
        forest, _ = forest_io.load_forest(path, "cpu")
    else:
        trees, depth = int(options.get("lal_trees", 200)), int(options.get("lal_depth", 10))
        if device.type != "meta":
            return synthetic_forest(np.random.default_rng(0), trees, depth, 5).to(device)
        nodes = (trees, 2 ** (depth + 1) - 1)
        forest = PackedForest(
            **{f: torch.empty(nodes, dtype=dt, device="meta") for f, dt in (
                ("feature", torch.int32), ("threshold", torch.float32), ("left", torch.int32),
                ("right", torch.int32), ("value", torch.float32))}, max_depth=depth)
    if device.type == "meta":
        return dataclasses.replace(forest, **{
            f: torch.empty_like(getattr(forest, f), device=device)
            for f in ("feature", "threshold", "left", "right", "value")})
    return forest.to(device)


def _mesh_on(cfg: ExperimentConfig, device: torch.device):
    """The run's ``(data, model)`` mesh with every cell on ``device`` (a
    priced program charges every shard to the one device; over processes
    the rank's own cells), or None without a mesh."""
    data, model = cfg.mesh.data, cfg.mesh.model
    if data * model <= 1:
        return None
    from distributed_active_learning_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(data, model, devices=[device] * (data * model))


@dataclasses.dataclass
class _ForestParts:
    """The inputs of a forest program on a device, placed as the driver
    places them."""

    state: object
    codes: object
    fit: Callable
    strategy: object
    aux: object
    test_x: object
    test_y: torch.Tensor
    fit_key: torch.Tensor
    scenario: object = None
    costs: Optional[torch.Tensor] = None
    drift_dir: Optional[torch.Tensor] = None
    mesh: object = None


def _forest_parts(cfg: ExperimentConfig, shapes: ForestShapes, device: torch.device,
                  seed: int = 0, n_filled: bool = False) -> _ForestParts:
    """The inputs of a forest round on ``device``, the fit window sized as
    the driver sizes it (``loop._resolve_fit_budget``), the scenario's
    inputs (its costs and drift direction) and, under a mesh, the pool, the
    codes and the test set placed on it as ``loop.run_experiment`` places
    them."""
    from distributed_active_learning_tpu_torch.ops import trees_train
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.runtime import state as state_lib
    from distributed_active_learning_tpu_torch.strategies import StrategyAux, get_strategy

    gen = np.random.default_rng(seed)
    n, d = shapes.pool_rows, shapes.features
    x = _draw((n, d), torch.float32, device, gen)
    y = _draw((n,), torch.int32, device, gen, high=shapes.n_classes)
    n_start = min(cfg.n_start, n)
    state = state_lib.PoolState(
        x=x, oracle_y=y, labeled_mask=_start_mask(n, n_start, device, gen),
        key=_key(device, seed), round=torch.zeros((), dtype=torch.int32).to(device),
        n_filled=(torch.full((), n, dtype=torch.int32).to(device) if n_filled else None))
    binned = trees_train.make_bins(x, cfg.forest.max_bins, quantize=cfg.forest.quantize)
    budget = loop._resolve_fit_budget(cfg, n, n_start)
    fit = loop.make_device_fit(cfg, binned.edges, budget, shapes.n_classes)
    test_x = _draw((shapes.test_rows, d), torch.float32, device, gen)
    test_y = _draw((shapes.test_rows,), torch.int32, device, gen, high=shapes.n_classes)
    parts = _ForestParts(state=state, codes=binned.codes, fit=fit,
                         strategy=get_strategy(cfg.strategy), aux=None, test_x=test_x,
                         test_y=test_y, fit_key=_key(device, seed + 1))
    scn = cfg.scenario if cfg.scenario is not None and cfg.scenario.active else None
    if scn is not None:
        parts.scenario = scn
        if scn.kind == "cost_budget":
            parts.costs = 1.0 + _draw((n,), torch.float32, device, gen).abs()
        if scn.kind == "drift" and scn.drift_kind == "mean_shift":
            parts.drift_dir = _draw((d,), torch.float32, device, gen)
    mesh = parts.mesh = _mesh_on(cfg, device)
    if mesh is not None:
        from distributed_active_learning_tpu_torch.parallel.mesh import (
            global_put,
            shard_pool_state,
        )

        state = shard_pool_state(state_lib.pad_for_sharding(state, cfg.mesh.data), mesh)
        parts.state = state
        parts.codes = global_put(parts.codes, mesh, "mask")
        parts.test_x = global_put(test_x, mesh, "pool")
        if parts.costs is not None:
            parts.costs = global_put(parts.costs, mesh, "replicated")
    lal = (lal_regressor(dict(cfg.strategy.options), device) if cfg.strategy.name == "lal"
           else None)
    parts.aux = StrategyAux(lal_forest=lal, seed_mask=loop._map_leaves(torch.clone,
                                                                       parts.state.labeled_mask))
    return parts


def forest_program(kind: str, cfg: ExperimentConfig, shapes: ForestShapes,
                   with_metrics: bool = False, seed: int = 0) -> Callable:
    """The builder of one forest program (``fit``, ``round``, ``eval`` or
    ``chunk``) of ``cfg`` at ``shapes``: its scenario's round under an
    active ``cfg.scenario``, and on its mesh under ``cfg.mesh``."""
    from distributed_active_learning_tpu_torch.runtime import loop

    audit = dict(quantize=None if cfg.forest.quantize == "none" else cfg.forest.quantize,
                 pool_rows=shapes.pool_rows)

    def make(device: torch.device) -> ProgramUnit:
        p = _forest_parts(cfg, shapes, device, seed)
        window = cfg.strategy.window_size
        tail = (p.costs,) if p.scenario is not None else ()
        if kind == "chunk":
            chunk = loop.make_chunk_fn(p.strategy, window, cfg.rounds_per_launch, p.fit,
                                       label_cap=shapes.pool_rows, fused_round=cfg.fused_round,
                                       with_metrics=with_metrics, n_classes=shapes.n_classes,
                                       scenario=p.scenario, drift_direction=p.drift_dir,
                                       mesh=p.mesh)
            end = torch.full((), np.iinfo(np.int32).max, dtype=torch.int32).to(device)
            return ProgramUnit(chunk.step, (p.codes, p.state, p.aux, p.fit_key, p.test_x,
                                            p.test_y, end, *tail), carry_arg=1,
                               with_metrics=with_metrics, **audit)
        if kind == "fit":
            return ProgramUnit(p.fit, (p.codes, p.state, p.fit_key), **audit)
        forest = loop._mesh_placement(p.mesh)(p.fit(p.codes, p.state, p.fit_key))
        if kind == "round":
            if p.mesh is not None:
                from distributed_active_learning_tpu_torch.parallel.kernels import (
                    make_sharded_round_fn,
                )

                round_fn = make_sharded_round_fn(
                    p.strategy, window, p.mesh, with_metrics=with_metrics,
                    n_classes=shapes.n_classes, fused=cfg.fused_round, scenario=p.scenario)
            else:
                round_fn = loop.make_round_fn(p.strategy, window, with_metrics=with_metrics,
                                              n_classes=shapes.n_classes, fused=cfg.fused_round,
                                              scenario=p.scenario)
            tail = (p.costs,) if p.costs is not None else ()
            return ProgramUnit(round_fn, (forest, p.state, p.aux, *tail), carry_arg=1,
                               with_metrics=with_metrics, **audit)
        if kind == "eval":
            if p.scenario is not None and p.scenario.kind == "drift":
                from distributed_active_learning_tpu_torch.scenarios.engine import drift_apply

                def drifted_accuracy(f, tx, ty, rnd, scn=p.scenario, direction=p.drift_dir):
                    return loop._accuracy(f, drift_apply(scn, tx, rnd, direction=direction), ty)

                return ProgramUnit(drifted_accuracy, (forest, p.test_x, p.test_y, 0), **audit)
            return ProgramUnit(loop._accuracy, (forest, p.test_x, p.test_y), **audit)
        raise ValueError(f"unknown forest program kind {kind!r}")

    return make


def grid_program(cfg: ExperimentConfig, datasets: Sequence[ForestShapes],
                 strategies: Sequence[str], n_seeds: int, scenarios=None,
                 with_metrics: bool = False, seed: int = 0) -> Callable:
    """The builder of one round step of the batched chunk that
    ``runtime.sweep.run_grid`` launches for ``strategies`` x ``datasets``
    (each dataset's shapes) x ``n_seeds`` seeds, crossed with the active
    ``scenarios`` into scenario-major groups (``run_sweep``'s is the grid of
    one strategy and one dataset): every cell's carry, the pools stacked
    (or each placed on ``cfg.mesh``), one regressor a LAL group, the
    scenario inputs, the fit window the run sizes."""
    from distributed_active_learning_tpu_torch.ops import trees_train
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.runtime import sweep as sweep_lib
    from distributed_active_learning_tpu_torch.strategies import get_strategy

    scns = [sc for sc in (scenarios or ()) if sc.active] or None
    names = [st for _ in (scns or [None]) for st in strategies]
    group_scns = [sc for sc in scns for _ in strategies] if scns else None
    D, E, G = len(datasets), int(n_seeds), len(names)
    C = G * D * E
    n_classes = max(s.n_classes for s in datasets)
    window = cfg.strategy.window_size

    def make(device: torch.device) -> ProgramUnit:
        gen = np.random.default_rng(seed)
        mesh = _mesh_on(cfg, device)
        n_valids = [s.pool_rows for s in datasets]
        n_store = max(n_valids)
        n_slab = n_store + ((-n_store) % cfg.mesh.data if mesh is not None else 0)
        test_ns = [s.test_rows for s in datasets]
        t_slab = max(test_ns)
        use_fill, use_test_fill = len(set(n_valids)) > 1, len(set(test_ns)) > 1
        static_n_valid = n_valids[0] if not use_fill and n_slab != n_store else -1
        d = datasets[0].features
        xs, oys, codes, edges, txs, tys = [], [], [], [], [], []
        for s in datasets:
            x = _draw((s.pool_rows, d), torch.float32, device, gen)
            binned = trees_train.make_bins(x, cfg.forest.max_bins, quantize=cfg.forest.quantize)
            pad = n_slab - s.pool_rows
            xs.append(torch.nn.functional.pad(x, (0, 0, 0, pad)))
            oys.append(_draw((n_slab,), torch.int32, device, gen, high=n_classes))
            codes.append(torch.nn.functional.pad(binned.codes, (0, 0, 0, pad)))
            edges.append(binned.edges)
            txs.append(_draw((t_slab, d), torch.float32, device, gen))
            tys.append(_draw((t_slab,), torch.int32, device, gen, high=n_classes))
        masks = torch.stack([_start_mask(n_slab, cfg.n_start, device, gen) for _ in range(C)])
        seed_masks = masks.clone()
        if mesh is None:
            x, oracle_y, codes, test_x = (torch.stack(t) for t in (xs, oys, codes, txs))
        else:
            from distributed_active_learning_tpu_torch.parallel.mesh import global_put

            x = tuple(global_put(a, mesh, "pool") for a in xs)
            oracle_y = tuple(global_put(a, mesh, "mask") for a in oys)
            codes = tuple(global_put(a, mesh, "pool") for a in codes)
            test_x = tuple(global_put(a, mesh, "pool") for a in txs)
            masks = sweep_lib._shard_masks(masks, mesh, n_slab)
            seed_masks = sweep_lib._shard_masks(seed_masks, mesh, n_slab)

        def cells(dtype, fill):
            return torch.full((C,), fill, dtype=dtype).to(device)

        keys = torch.stack([_key(device, seed + 2 + c) for c in range(C)])
        carry = sweep_lib.SweepState(labeled_mask=masks, key=keys,
                                     round=cells(torch.int32, 0))
        objs = [get_strategy(dataclasses.replace(cfg.strategy, name=nm)) for nm in names]
        lal = tuple(lal_regressor(dict(cfg.strategy.options), device) if nm == "lal" else None
                    for nm in names)
        budget = sweep_lib._resolve_sweep_fit_budget(cfg, n_store, cfg.n_start, window)
        scn_tail, drift_dirs = (), None
        if group_scns is not None:
            scn_tail = (torch.stack([_draw((n_slab,), torch.bool, device, gen)
                                     for _ in range(C)]),
                        1.0 + torch.stack([_draw((n_slab,), torch.float32, device, gen).abs()
                                           for _ in range(D)]))
            drift_dirs = [_draw((d,), torch.float32, device, gen)
                          if sc.kind == "drift" and sc.drift_kind == "mean_shift" else None
                          for sc in group_scns]
        body = sweep_lib.make_grid_chunk_fn(
            objs, window, max(cfg.rounds_per_launch, 1),
            loop._device_fit_core(cfg, budget, n_classes), n_datasets=D, n_seeds=E,
            use_fill=use_fill, use_test_fill=use_test_fill, with_metrics=with_metrics,
            n_classes=n_classes, scenarios=group_scns, drift_dirs=drift_dirs, mesh=mesh,
            static_n_valid=static_n_valid)
        args = (codes, x, oracle_y, carry, seed_masks, lal,
                torch.stack([_key(device, seed + 2 + C + c) for c in range(C)]),
                cells(torch.int32, window), test_x, torch.stack(tys),
                cells(torch.int32, np.iinfo(np.int32).max),
                torch.tensor([n_valids[(c // E) % D] for c in range(C)],
                             dtype=torch.int32).to(device),
                torch.stack(edges), torch.tensor(n_valids, dtype=torch.int32).to(device),
                torch.tensor(test_ns, dtype=torch.int32).to(device), *scn_tail)
        return ProgramUnit(body.step, args, carry_arg=3, with_metrics=with_metrics,
                           quantize=None if cfg.forest.quantize == "none" else cfg.forest.quantize,
                           pool_rows=n_store)

    return make


def neural_chunk_program(shapes: NeuralShapes, seed: int = 0, lanes: int = 0) -> Callable:
    """The builder of one round step of the neural chunk at ``shapes``;
    with ``lanes`` E > 0, of the neural seed sweep's chunk
    (``neural_loop.make_neural_sweep_chunk_fn``: E carries and E
    networks, the lanes one after another)."""
    from distributed_active_learning_tpu_torch.models.neural import MLP, NeuralLearner, SmallCNN
    from distributed_active_learning_tpu_torch.runtime import neural_loop

    def make(device: torch.device) -> ProgramUnit:
        gen = np.random.default_rng(seed)
        if shapes.model == "cnn":
            module = SmallCNN(n_classes=shapes.n_classes)
        elif shapes.model == "transformer":
            from distributed_active_learning_tpu_torch.models.transformer import (
                TransformerClassifier,
            )

            module = TransformerClassifier(vocab_size=shapes.vocab_size,
                                           max_len=shapes.input_shape[0],
                                           n_classes=shapes.n_classes, d_model=shapes.d_model,
                                           n_layers=shapes.n_layers, n_heads=shapes.n_heads,
                                           d_ff=shapes.d_ff)
        else:
            module = MLP(n_classes=shapes.n_classes, hidden=shapes.hidden)
        learner = NeuralLearner(module, shapes.input_shape, train_steps=shapes.train_steps,
                                mc_samples=shapes.mc_samples, device=device)
        n = shapes.pool_rows
        tokens = shapes.model == "transformer"
        dtype = torch.int32 if tokens else torch.float32
        pool_x = _draw((n, *shapes.input_shape), dtype, device, gen, high=shapes.vocab_size)
        test_x = _draw((shapes.test_rows, *shapes.input_shape), dtype, device, gen,
                       high=shapes.vocab_size)
        oracle_y = _draw((n,), torch.int32, device, gen, high=shapes.n_classes)
        test_y = _draw((shapes.test_rows,), torch.int32, device, gen, high=shapes.n_classes)
        strategy = neural_loop._normalize_deep_name(shapes.strategy)
        end = torch.full((), np.iinfo(np.int32).max, dtype=torch.int32).to(device)
        if lanes:
            nets = tuple(learner.init(_key(device, seed + e)) for e in range(lanes))
            carry = neural_loop.NeuralCarry(
                labeled_mask=torch.stack([_start_mask(n, shapes.window, device, gen)
                                          for _ in range(lanes)]),
                key=torch.stack([_key(device, seed + lanes + e) for e in range(lanes)]),
                round=torch.zeros(lanes, dtype=torch.int32).to(device), net=nets)
            body = neural_loop.make_neural_sweep_chunk_fn(
                learner, strategy, shapes.window, shapes.rounds_per_launch, label_cap=n,
                n_experiments=lanes, n_classes=shapes.n_classes)
            return ProgramUnit(body.step, (pool_x, carry, oracle_y, nets, test_x, test_y,
                                           end.expand(lanes).clone()), carry_arg=1, pool_rows=n)
        init_net = learner.init(_key(device, seed))
        carry = neural_loop.NeuralCarry(
            labeled_mask=_start_mask(n, shapes.window, device, gen), key=_key(device, seed + 1),
            round=torch.zeros((), dtype=torch.int32).to(device), net=init_net)
        body = neural_loop.make_neural_chunk_fn(
            learner, strategy, shapes.window, shapes.rounds_per_launch, label_cap=n,
            n_classes=shapes.n_classes)
        return ProgramUnit(body.step, (pool_x, carry, oracle_y, init_net, test_x, test_y, end),
                           carry_arg=1, pool_rows=n)

    return make


def serve_program(kind: str, cfg: ExperimentConfig, serve: ServeConfig, capacity: int,
                  features: int, test_rows: int, seed: int = 0) -> Callable:
    """The builder of the service's ``serve_score`` (the score endpoint over
    ``serve.score_width`` queries) or ``serve_chunk`` (one round step of the
    re-fit chunk at ``capacity`` rows, RoundMetrics on, the watermark
    riding) program."""
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.serving import slab as slab_lib

    budget = (min(cfg.forest.fit_budget, capacity) if cfg.forest.fit_budget is not None
              else serve.slab_rows)
    cfg = dataclasses.replace(cfg, forest=dataclasses.replace(cfg.forest, fit_budget=budget))
    shapes = ForestShapes(capacity, features, test_rows)

    def make(device: torch.device) -> ProgramUnit:
        p = _forest_parts(cfg, shapes, device, seed, n_filled=True)
        if kind == "serve_score":
            forest = p.fit(p.codes, p.state, p.fit_key)
            queries = _draw((serve.score_width, features), torch.float32, device,
                            np.random.default_rng(seed + 2))
            return ProgramUnit(slab_lib.score_body, (forest, queries), pool_rows=capacity)
        chunk = loop.make_chunk_fn(p.strategy, cfg.strategy.window_size, serve.refit_rounds,
                                   p.fit, label_cap=capacity, with_metrics=True)
        end = torch.full((), np.iinfo(np.int32).max, dtype=torch.int32).to(device)
        return ProgramUnit(chunk.step, (p.codes, p.state, p.aux, p.fit_key, p.test_x, p.test_y,
                                        end), carry_arg=1, with_metrics=True, pool_rows=capacity)

    return make


def _placement(cfg: ExperimentConfig) -> str:
    """A spec name's placement suffix: the mesh and, over processes, the
    rank whose cells are priced."""
    if cfg.mesh.data * cfg.mesh.model <= 1:
        return ""
    from distributed_active_learning_tpu_torch.parallel import multihost

    tag = f"/mesh{cfg.mesh.data}x{cfg.mesh.model}"
    if multihost.process_count() > 1:
        tag += f"/rank{multihost.process_index()}of{multihost.process_count()}"
    return tag


def _graph(cfg: ExperimentConfig) -> Optional[bool]:
    """A mesh over processes runs its chunk eagerly (no graph pool)."""
    from distributed_active_learning_tpu_torch.parallel import multihost

    return False if cfg.mesh.data * cfg.mesh.model > 1 and multihost.launched() else None


def specs_for_experiment(cfg: ExperimentConfig, shapes: ForestShapes,
                         with_metrics: bool = False,
                         kinds: Optional[Sequence[str]] = None) -> List[ProgramSpec]:
    """The forest programs ``cfg``'s driver launches at ``shapes``: the
    chunk's round step when it runs K rounds a launch, else the per-round
    driver's fit, round and eval (``kinds`` overrides); under an active
    scenario its scenario round, under a mesh on the configured ``(data,
    model)`` mesh (this rank's cells over processes), for LAL with the
    regressor its options name. The name says which."""
    if kinds is None:
        kinds = ("chunk",) if cfg.rounds_per_launch > 1 else ("fit", "round", "eval")
    tag = f"{cfg.strategy.name}{'-fused' if cfg.fused_round else ''}"
    if cfg.scenario is not None and cfg.scenario.active:
        tag += f"/{cfg.scenario.kind}"
    tag += _placement(cfg)
    return [ProgramSpec(f"{kind}/{tag}", kind, forest_program(kind, cfg, shapes, with_metrics),
                        graph=_graph(cfg) if kind == "chunk" else None) for kind in kinds]


def specs_for_run(cfg: ExperimentConfig, datasets: Sequence[ForestShapes], *,
                  strategies: Optional[Sequence[str]] = None, n_seeds: int = 1,
                  scenarios=None, grid: bool = False,
                  with_metrics: bool = False) -> List[ProgramSpec]:
    """The programs a forest run of the CLI launches (``run.py``'s
    dispatch), at its datasets' shapes: the grid chunk of its exact cells
    (``grid``: ``strategies`` x ``datasets`` x ``n_seeds``, crossed with
    ``scenarios`` or the config's active scenario), the batched seed sweep
    (``n_seeds`` > 1), else :func:`specs_for_experiment`. A host fit runs a
    sweep or grid as serial experiments, and so do datasets of unequal
    feature widths or class counts (``run_grid``'s fallback): each is
    priced as the one experiment it launches at a time."""
    strategies = list(strategies or [cfg.strategy.name])
    serial = cfg.forest.fit != "device" or len({(s.features, s.n_classes)
                                                 for s in datasets}) > 1
    if serial or not (grid or n_seeds > 1):
        widest = max(datasets, key=lambda s: s.pool_rows)
        return [spec for name in strategies for spec in specs_for_experiment(
            dataclasses.replace(cfg, strategy=dataclasses.replace(cfg.strategy, name=name)),
            widest, with_metrics)]
    if not grid:
        return [ProgramSpec(f"sweep/{cfg.strategy.name}/seeds{n_seeds}{_placement(cfg)}",
                            "sweep", grid_program(cfg, datasets[:1], strategies, n_seeds,
                                                  with_metrics=with_metrics),
                            graph=_graph(cfg))]
    if scenarios is None and cfg.scenario is not None and cfg.scenario.active:
        scenarios = [cfg.scenario]
    scn_tag = "/" + "+".join(sc.kind for sc in scenarios) if scenarios else ""
    name = (f"grid/{'+'.join(strategies)}/{len(datasets)}x{n_seeds}{scn_tag}"
            f"{_placement(cfg)}")
    return [ProgramSpec(name, "grid", grid_program(cfg, datasets, strategies, n_seeds,
                                                   scenarios=scenarios,
                                                   with_metrics=with_metrics),
                        graph=_graph(cfg))]


#: The default widths: ``chip_smoke.py``'s headline round (the JAX bench's
#: accelerator sizes), its CNN chunk (phase 4n) and its serving legs (phase
#: 4o: the cold start, and the headline pool as a slab).
BENCH_SHAPES = ForestShapes(284_807, 30, 85_443)
BENCH_CONFIG = ExperimentConfig(
    forest=ForestConfig(n_trees=100, max_depth=8, max_bins=32, kernel="pallas", fit="device"),
    strategy=StrategyConfig(name="uncertainty", window_size=100),
    n_start=5_000, max_rounds=6, rounds_per_launch=4, fused_round=True)
CNN_SHAPES = NeuralShapes("cnn", (32, 32, 3), 50_000, 10_000, 10)
SERVE_CONFIG = ServeConfig(slab_rows=1024, score_width=64, refit_rounds=4)


def serve_config(depth: int) -> ExperimentConfig:
    """The service's forest (phase 4o: 100 trees, K1, uncertainty, window
    20) at ``depth``."""
    return ExperimentConfig(
        forest=ForestConfig(n_trees=100, max_depth=depth, kernel="pallas", fit="device"),
        strategy=StrategyConfig(name="uncertainty", window_size=20))


def build_registry(kinds: Optional[Sequence[str]] = None) -> List[ProgramSpec]:
    """The port's default program set (``--list``): the headline round's
    per-round phases and its chunk, fused and unfused; the CNN's neural
    chunk; the service's endpoint and re-fit chunk at the cold start's
    8,192-row capacity (depth 4) and at the headline pool's 291,840-row
    slab (depth 8). ``kinds`` filters."""
    unfused = dataclasses.replace(BENCH_CONFIG, fused_round=False)
    specs = (specs_for_experiment(BENCH_CONFIG, BENCH_SHAPES, kinds=("fit", "round", "eval",
                                                                      "chunk"))
             + specs_for_experiment(unfused, BENCH_SHAPES, kinds=("round", "chunk")))
    specs.append(ProgramSpec("neural_chunk/deep.entropy/cnn", "neural_chunk",
                             neural_chunk_program(CNN_SHAPES)))
    for capacity, depth, test_rows in ((8_192, 4, 2_048), (291_840, 8, 85_443)):
        cfg = serve_config(depth)
        for kind in ("serve_score", "serve_chunk"):
            specs.append(ProgramSpec(f"{kind}/{capacity}", kind,
                                     serve_program(kind, cfg, SERVE_CONFIG, capacity, 30,
                                                   test_rows)))
    if kinds is not None:
        specs = [s for s in specs if s.kind in kinds]
    return specs
