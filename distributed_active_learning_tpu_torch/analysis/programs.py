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
- ``neural_chunk``: one round step of the neural chunk
  (``runtime/neural_loop.py``);
- ``serve_score`` and ``serve_chunk``: the service's score endpoint over a
  query block and the round step of a capacity's re-fit chunk
  (``serving/``).

:func:`specs_for_experiment` gives the programs an ``ExperimentConfig``
launches at its data's shapes (the JAX package's configured-scale
repricing); :func:`build_registry` the port's default set, at the widths
``chip_smoke.py`` drives. Costs and memory only: the port has no traced
program for the JAX package's jaxpr rules.
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

KINDS = ("fit", "round", "eval", "chunk", "neural_chunk", "serve_score", "serve_chunk")
#: The kinds whose drivers capture the program as a CUDA graph on the card.
GRAPHED_KINDS = frozenset(("chunk", "neural_chunk", "serve_chunk"))


@dataclasses.dataclass(frozen=True)
class ProgramUnit:
    """A built program: ``fn(*args)`` is one launch of it."""

    fn: Callable
    args: tuple


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """A named program and how to build it on a device (``"meta"`` by
    default)."""

    name: str
    kind: str
    make: Callable[[torch.device], ProgramUnit]

    def build(self, device="meta") -> ProgramUnit:
        return self.make(torch.device(device))

    @property
    def graphed(self) -> bool:
        """Whether the driver runs this program as a CUDA graph, whose
        private pool stays reserved beside the resident inputs."""
        return self.kind in GRAPHED_KINDS


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


def _forest_parts(cfg: ExperimentConfig, shapes: ForestShapes, device: torch.device,
                  with_metrics: bool, seed: int = 0, n_filled: bool = False):
    """The inputs of a forest round on ``device``: ``(state, binned, fit,
    strategy, aux, test_x, test_y)``, the fit window sized as the driver
    sizes it (``loop._resolve_fit_budget``)."""
    from distributed_active_learning_tpu_torch.ops import trees_train
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.runtime import state as state_lib
    from distributed_active_learning_tpu_torch.strategies import StrategyAux, get_strategy

    if cfg.strategy.name == "lal":
        raise ValueError("a LAL program's regressor comes from its file (the strategy's "
                         "options); it is not priced from shapes")
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
    aux = StrategyAux(seed_mask=state.labeled_mask.clone())
    test_x = _draw((shapes.test_rows, d), torch.float32, device, gen)
    test_y = _draw((shapes.test_rows,), torch.int32, device, gen, high=shapes.n_classes)
    return state, binned, fit, get_strategy(cfg.strategy), aux, test_x, test_y


def forest_program(kind: str, cfg: ExperimentConfig, shapes: ForestShapes,
                   with_metrics: bool = False, seed: int = 0) -> Callable:
    """The builder of one forest program (``fit``, ``round``, ``eval`` or
    ``chunk``) of ``cfg`` at ``shapes``."""
    from distributed_active_learning_tpu_torch.runtime import loop

    def make(device: torch.device) -> ProgramUnit:
        state, binned, fit, strategy, aux, test_x, test_y = _forest_parts(
            cfg, shapes, device, with_metrics, seed)
        window = cfg.strategy.window_size
        if kind == "chunk":
            chunk = loop.make_chunk_fn(strategy, window, cfg.rounds_per_launch, fit,
                                       label_cap=shapes.pool_rows, fused_round=cfg.fused_round,
                                       with_metrics=with_metrics, n_classes=shapes.n_classes)
            end = torch.full((), np.iinfo(np.int32).max, dtype=torch.int32).to(device)
            return ProgramUnit(chunk.step, (binned.codes, state, aux, _key(device, seed + 1),
                                            test_x, test_y, end))
        if kind == "fit":
            return ProgramUnit(fit, (binned.codes, state, _key(device, seed + 1)))
        forest = fit(binned.codes, state, _key(device, seed + 1))
        if kind == "round":
            round_fn = loop.make_round_fn(strategy, window, with_metrics=with_metrics,
                                          n_classes=shapes.n_classes, fused=cfg.fused_round)
            return ProgramUnit(round_fn, (forest, state, aux))
        if kind == "eval":
            return ProgramUnit(loop._accuracy, (forest, test_x, test_y))
        raise ValueError(f"unknown forest program kind {kind!r}")

    return make


def neural_chunk_program(shapes: NeuralShapes, seed: int = 0) -> Callable:
    """The builder of one round step of the neural chunk at ``shapes``."""
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
        init_net = learner.init(_key(device, seed))
        carry = neural_loop.NeuralCarry(
            labeled_mask=_start_mask(n, shapes.window, device, gen), key=_key(device, seed + 1),
            round=torch.zeros((), dtype=torch.int32).to(device), net=init_net)
        body = neural_loop.make_neural_chunk_fn(
            learner, neural_loop._normalize_deep_name(shapes.strategy), shapes.window,
            shapes.rounds_per_launch, label_cap=n, n_classes=shapes.n_classes)
        end = torch.full((), np.iinfo(np.int32).max, dtype=torch.int32).to(device)
        return ProgramUnit(body.step, (pool_x, carry, oracle_y, init_net, test_x, test_y, end))

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
        state, binned, fit, strategy, aux, test_x, test_y = _forest_parts(
            cfg, shapes, device, True, seed, n_filled=True)
        if kind == "serve_score":
            forest = fit(binned.codes, state, _key(device, seed + 1))
            queries = _draw((serve.score_width, features), torch.float32, device,
                            np.random.default_rng(seed + 2))
            return ProgramUnit(slab_lib.score_body, (forest, queries))
        chunk = loop.make_chunk_fn(strategy, cfg.strategy.window_size, serve.refit_rounds, fit,
                                   label_cap=capacity, with_metrics=True)
        end = torch.full((), np.iinfo(np.int32).max, dtype=torch.int32).to(device)
        return ProgramUnit(chunk.step, (binned.codes, state, aux, _key(device, seed + 1),
                                        test_x, test_y, end))

    return make


def specs_for_experiment(cfg: ExperimentConfig, shapes: ForestShapes,
                         with_metrics: bool = False,
                         kinds: Optional[Sequence[str]] = None) -> List[ProgramSpec]:
    """The forest programs ``cfg``'s driver launches at ``shapes``: the
    chunk's round step when it runs K rounds a launch, else the per-round
    driver's fit, round and eval (``kinds`` overrides)."""
    if kinds is None:
        kinds = ("chunk",) if cfg.rounds_per_launch > 1 else ("fit", "round", "eval")
    tag = f"{cfg.strategy.name}{'-fused' if cfg.fused_round else ''}"
    return [ProgramSpec(f"{kind}/{tag}", kind,
                        forest_program(kind, cfg, shapes, with_metrics)) for kind in kinds]


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
