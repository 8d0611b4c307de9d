"""Deep-AL experiment driver (the port of ``runtime/neural_loop.py``): a
neural learner and MC acquisition over the pool.

Per round: (re)train the network on the masked labeled subset on the device
(``models/neural.py``), draw MC-dropout predictive samples over the pool,
score with a deep acquisition function (``strategies/deep.py``), select the
window, reveal, and measure test accuracy. The RNG protocol is the JAX
package's: the pool state's key is ``key(seed)``, the loop key ``key(seed +
1)``, the network's init key ``key(seed + 2)``; each round splits ``key,
k_fit, k_mc, k_rand`` from the loop key, and ``retrain_from_scratch``
restarts every round from the init weights. The picks and records equal the
JAX package's on the same configuration, the accuracy to its float sum
(``tests/test_torch_neural.py``).

Three drivers share one round body (:func:`_make_neural_round_core`):

- the per-round loop of :func:`run_neural_experiment` (phases ``train``,
  ``acquire``, ``eval``), taken when ``rounds_per_launch`` is 1 or the
  debugger asks for ``phase_detail``;
- the chunk (:func:`make_neural_chunk_fn`): K rounds per launch, each a
  masked no-op past the label cap or the round quota, driven by
  ``runtime/pipeline.py``; on CUDA one CUDA graph of a round, replayed K
  times a chunk (``runtime/loop.py::GraphedChunk``), holding the training
  steps, the adam updates, the MC passes and the greedy selects; on the
  CPU the same body eagerly. ``stream_round_events`` fire as each round
  finishes, in round order (``loop.RoundStream``, the forest chunk's);
- the seed sweep (:func:`run_neural_sweep`): E seeds over one shared pool
  as one launch stream, the lanes one after another inside each round
  step of the chunk's graph, so a lane is its serial run by construction.

On CUDA the drivers switch cuDNN to deterministic algorithms
(``device.deterministic_cuda``): the chunked == per-round and sweep ==
serial gates compare bits.

Under ``MeshConfig(data=D)`` the pool rows shard over a data mesh
(:func:`_place_on_mesh`, the JAX package's): the pool is padded to a
multiple of D (padding rows labeled, so never selectable, and outside every
real-row count through ``n_valid``), its mask, labels and images split into
D row blocks, and the network, the test arrays and the loop key stay on the
mesh's first device. The learner runs each shard's rows on the shard's
device (``models/neural.py``), the scores, masks and selects are global on
the first device, and each shard reveals its own block. The picks and
records are the single-device run's. The chunk on one card (a mesh of one
card repeated) is still ONE CUDA graph of a round; a mesh over distinct
cards runs its chunks eagerly (``graph_stats["mode"] == "eager"``). A seed
sweep under a mesh runs its seeds serially, as in JAX; a model axis is
refused with the JAX package's message.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import MeshConfig
from distributed_active_learning_tpu_torch.device import deterministic_cuda
from distributed_active_learning_tpu_torch.models.neural import (
    NeuralLearner,
    TrainState,
    select_train_state,
)
from distributed_active_learning_tpu_torch.ops import threefry
from distributed_active_learning_tpu_torch.ops.topk import select_top_k
from distributed_active_learning_tpu_torch.parallel.mesh import gather
from distributed_active_learning_tpu_torch.runtime import state as state_lib
from distributed_active_learning_tpu_torch.runtime.debugger import Debugger
from distributed_active_learning_tpu_torch.runtime.results import ExperimentResult, RoundRecord
from distributed_active_learning_tpu_torch.strategies import deep

# score_fn: probs_samples [S, n, C] -> scores [n] (higher = more informative)
_SCORES: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "entropy": deep.predictive_entropy,
    "bald": deep.bald_score,
    "mean_std": deep.mean_std_score,
    "variation_ratio": deep.variation_ratio,
    "margin": deep.margin_score,
}


def _deep_names():
    return set(_SCORES) | {"batchbald", "random", "coreset", "badge", "density"}


def available_deep_strategies():
    """Namespaced names (``"deep.bald"``, ...)."""
    return sorted("deep." + n for n in _deep_names())


def _normalize_deep_name(name: str) -> str:
    return name[len("deep."):] if name.startswith("deep.") else name


def is_deep_strategy(name: str) -> bool:
    """True if ``name`` (bare or ``deep.``-prefixed) names a deep strategy."""
    return _normalize_deep_name(name) in _deep_names()


@dataclasses.dataclass(frozen=True)
class NeuralExperimentConfig:
    """The JAX package's fields and defaults (the fingerprint reads them)."""

    strategy: str = "bald"
    window_size: int = 10
    n_start: int = 20
    max_rounds: Optional[int] = 10
    label_budget: Optional[int] = None
    seed: int = 0
    retrain_from_scratch: bool = True
    batchbald_max_configs: int = 4096
    batchbald_candidate_pool: int = 512
    batchbald_mc_samples: int = 256
    beta: float = 1.0
    coreset_space: str = "input"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    rounds_per_launch: int = 1
    pipeline_depth: int = 2
    stream_round_events: bool = False
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def neural_fingerprint(cfg: NeuralExperimentConfig, learner: NeuralLearner,
                       data_ident: Optional[dict] = None) -> str:
    """Identity hash for neural checkpoints: strategy, seeding, training
    protocol, architecture (the module's flax repr) and dataset; equal to the
    JAX package's for the same experiment."""
    from distributed_active_learning_tpu_torch.runtime.checkpoint import fingerprint_from_ident

    ident = {
        "strategy": _normalize_deep_name(cfg.strategy),
        "window_size": cfg.window_size,
        "n_start": cfg.n_start,
        "seed": cfg.seed,
        "retrain_from_scratch": cfg.retrain_from_scratch,
        "batchbald": (cfg.batchbald_max_configs, cfg.batchbald_candidate_pool,
                      cfg.batchbald_mc_samples),
        "beta": cfg.beta,
        "coreset_space": cfg.coreset_space,
        "module": repr(learner.module),
        "input_shape": learner.input_shape,
        "train": (learner.train_steps, learner.batch_size, learner.mc_samples,
                  learner.learning_rate),
        "data": data_ident or {},
    }
    return fingerprint_from_ident(ident)


def _refuse_mesh(mesh: MeshConfig) -> None:
    if mesh.model > 1:
        raise ValueError(
            "the neural path shards pool rows only (--mesh-data); model "
            f"parallelism of the network (mesh model={mesh.model}) is out of scope")


def _sharded(mesh: MeshConfig) -> bool:
    return mesh.data * mesh.model > 1


def _place_on_mesh(cfg: MeshConfig, state: state_lib.PoolState, pool_x: torch.Tensor, devices,
                   device):
    """Data-parallel placement (the JAX package's ``_place_on_mesh``): pad
    the pool to a multiple of the data axis (``state.pad_for_sharding``:
    padding rows labeled, zero images), shard the state's rows and the
    images over ``data`` (``parallel.mesh.shard_pool_state``,
    ``shard_rows``). The network, the test arrays and the loop key stay on
    the mesh's first device, which must be the learner's. Over processes
    (``parallel.multihost``) each rank keeps its own rows
    (``parallel.mesh.global_put``), its first device is the rank's card, and
    the network, the test arrays and the key are replicated on every rank.
    Returns ``(mesh, state, pool_x)``."""
    from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib

    _refuse_mesh(cfg)
    mesh = mesh_lib.make_mesh(data=cfg.data, model=1, devices=devices, device=device)
    if mesh.first != mesh_lib._indexed(torch.device(device)):
        raise ValueError(f"mesh devices {mesh.devices} do not start on the learner's "
                         f"device {device}")
    state = state_lib.pad_for_sharding(state, cfg.data)
    state = mesh_lib.shard_pool_state(state, mesh)
    pad = state.n_pool - pool_x.shape[0]
    if pad:
        pool_x = torch.cat([pool_x, pool_x.new_zeros((pad, *pool_x.shape[1:]))])
    return mesh, state, mesh_lib.global_put(pool_x, mesh, "pool")


def _global_view(st: state_lib.PoolState):
    """``(labeled mask, labels, fit mask)`` as global tensors on the first
    device (joined from the shards on a mesh): the fit mask is the labeled
    real rows (padding rows are labeled and excluded, the JAX package's
    guard)."""
    mask, y = gather(st.labeled_mask), gather(st.oracle_y)
    fit_mask = mask
    if st.n_valid != st.n_pool:
        fit_mask = mask & (torch.arange(st.n_pool, device=mask.device) < st.n_valid)
    return mask, y, fit_mask


_BATCHBALD_DEFAULTS = (4096, 512, 256)


class _RoundParts:
    """The three phases of a neural round over one pool (the per-round
    driver times them apart; the chunk runs them back to back)."""

    def __init__(self, learner: NeuralLearner, strat: str, window_size: int, beta: float,
                 with_metrics: bool, n_classes: int, coreset_space: str = "input",
                 batchbald_params=_BATCHBALD_DEFAULTS):
        if coreset_space not in ("input", "embedding"):
            raise ValueError(f"unknown coreset_space {coreset_space!r}; use 'input' or 'embedding'")
        self.learner, self.strat, self.window = learner, strat, window_size
        self.beta, self.with_metrics, self.n_classes = beta, with_metrics, n_classes
        self.coreset_space, self.batchbald_params = coreset_space, batchbald_params

    def train(self, st: state_lib.PoolState, net_in: TrainState, pool_x, k_fit) -> TrainState:
        _, y, fit_mask = _global_view(st)
        return self.learner.fit_on_mask(net_in, pool_x, y, fit_mask, k_fit)

    def acquire(self, st: state_lib.PoolState, net: TrainState, pool_x, k_mc, k_rand):
        """``(picked, picked_vals, scores, probs)``: the window, its values,
        the per-point score vector (a proxy for the greedy selects, as in
        JAX) and the MC samples (None where the strategy and the metrics do
        not need them)."""
        learner, strat, window = self.learner, self.strat, self.window
        # Padding rows read as labeled: never selectable, never centers.
        mask, _, centers = _global_view(st)
        unlabeled = ~mask
        probs = None
        if strat not in ("random", "coreset", "badge") or self.with_metrics:
            probs = learner.predict_proba_samples(net, pool_x, k_mc)
        picked = vals = None
        if strat == "random":
            scores = threefry.uniform(k_rand.to(unlabeled.device), (st.n_pool,))
        elif strat == "density":
            from distributed_active_learning_tpu_torch.ops.similarity import similarity_mass

            ent = deep.predictive_entropy(probs)
            emb = learner.embed(net, pool_x)
            mass = torch.clamp_min(similarity_mass(emb, unlabeled), 0.0)
            scores = ent * torch.pow(mass, self.beta)
        elif strat == "coreset":
            space = (learner.embed(net, pool_x) if self.coreset_space == "embedding"
                     else gather(pool_x))
            picked, vals = deep.coreset_select(space, centers, window, selectable_mask=unlabeled)
            scores = deep.coreset_min_dists(space, centers)
        elif strat == "badge":
            mean_probs = learner.predict_proba(net, pool_x)
            emb = learner.embed(net, pool_x)
            picked = deep.badge_select(mean_probs, emb, unlabeled, window, k_rand)
            scores = deep.badge_embedding_norms(mean_probs, emb)[2]
            vals = scores[picked]
        elif strat == "batchbald":
            max_configs, candidate_pool, mc_samples = self.batchbald_params
            picked, vals = deep.batchbald_select(probs, unlabeled, window, max_configs,
                                                 candidate_pool, mc_samples, key=k_rand)
            scores = deep.bald_score(probs)
        else:
            scores = _SCORES[strat](probs)
        if picked is None:
            vals, picked = select_top_k(scores, unlabeled, window)
        return picked, vals, scores, probs

    def metrics(self, st, picked, vals, scores, probs):
        from distributed_active_learning_tpu_torch.runtime import telemetry

        mask, y, _ = _global_view(st)
        st = st.replace(labeled_mask=mask, oracle_y=y)
        return telemetry.selection_metrics(
            st, picked, vals, scores, higher_is_better=True, n_classes=self.n_classes,
            pool_entropy=deep.predictive_entropy(probs))


def _make_neural_round_core(learner, strat, window_size, beta, with_metrics, n_classes,
                            coreset_space="input", batchbald_params=_BATCHBALD_DEFAULTS):
    """``round_core(st, net_in, pool_x, test_x, test_y, k_fit, k_mc, k_rand)
    -> (net, new_st, acc, picked, metrics-or-None)``: the fit, the MC score,
    the select, the reveal and the accuracy of one round, shared by the
    chunk and the sweep lanes."""
    parts = _RoundParts(learner, strat, window_size, beta, with_metrics, n_classes,
                        coreset_space, batchbald_params)

    def round_core(st, net_in, pool_x, test_x, test_y, k_fit, k_mc, k_rand):
        net = parts.train(st, net_in, pool_x, k_fit)
        picked, vals, scores, probs = parts.acquire(st, net, pool_x, k_mc, k_rand)
        new_st = state_lib.reveal(st, picked)
        acc = learner.accuracy_tensor(net, test_x, test_y)
        rm = parts.metrics(st, picked, vals, scores, probs) if with_metrics else None
        return net, new_st, acc, picked, rm

    return round_core


@dataclasses.dataclass(frozen=True)
class NeuralCarry:
    """The chunk's carry: the labeled mask, the loop key and the round
    counter (on the device) and the network's TrainState. A sweep's carry
    stacks masks ``[E, n]``, keys ``[E, 2]`` and rounds ``[E]`` and holds a
    tuple of E TrainStates."""

    labeled_mask: torch.Tensor
    key: torch.Tensor
    round: torch.Tensor
    net: object

    def replace(self, **kw) -> "NeuralCarry":
        return dataclasses.replace(self, **kw)


NEURAL_CARRY_FIELDS = ("labeled_mask", "key", "round", "net")


def _lane_state(pool_x, oracle_y, mask, key, rnd, n_valid: int = -1) -> state_lib.PoolState:
    """A lane's state: ``[n, 0]`` features on the first device (the network
    reads ``pool_x``), the loop key in the pool key's place (the round reads
    neither) and the real row count of a padded pool."""
    return state_lib.PoolState(
        x=torch.zeros((pool_x.shape[0], 0), dtype=torch.float32, device=pool_x.device),
        oracle_y=oracle_y, labeled_mask=mask, key=key, round=rnd, n_valid_static=n_valid)


def _lane_step(round_core, retrain_from_scratch: bool, label_cap: int, pool_x, oracle_y,
               mask, key, rnd, net_c, init_net, test_x, test_y, end_round, n_valid: int = -1):
    """One round of one experiment as a masked no-op past its stop:
    returns ``(mask, key, round, net)`` and the ys (:func:`_lane_state`; on
    a mesh the mask and labels are row-sharded)."""
    st = _lane_state(pool_x, oracle_y, mask, key, rnd, n_valid)
    n_labeled = state_lib.labeled_count(st)
    active = (n_labeled < label_cap) & (rnd < end_round)
    ks = prng.split(key, 4)
    net_in = init_net if retrain_from_scratch else net_c
    net, new_st, acc, picked, rm = round_core(st, net_in, pool_x, test_x, test_y,
                                              ks[1], ks[2], ks[3])
    out = (state_lib.select_state(active, new_st, st).labeled_mask,
           torch.where(active, ks[0], key),
           torch.where(active, rnd + 1, rnd), select_train_state(active, net, net_c))
    ys = (rnd + 1, n_labeled, acc, picked.to(torch.int32), active)
    return out, (ys + (rm,) if rm is not None else ys)


def _stack_ys(rows, with_metrics: bool):
    cols = list(zip(*rows))
    ys = tuple(torch.stack(c) for c in cols[:5])
    if with_metrics:
        from distributed_active_learning_tpu_torch.runtime.telemetry import stack_metrics

        ys = ys + (stack_metrics(list(cols[5])),)
    return ys


def make_neural_chunk_fn(learner: NeuralLearner, strat: str, window_size: int, chunk_size: int,
                         label_cap: int, retrain_from_scratch: bool = True, beta: float = 1.0,
                         with_metrics: bool = False, n_classes: int = 2,
                         coreset_space: str = "input", batchbald_params=_BATCHBALD_DEFAULTS,
                         stream_cb=None, n_valid: int = -1):
    """``chunk_size`` neural rounds as one launch.

    ``chunk_fn(pool_x, carry, oracle_y, init_net, test_x, test_y, end_round)
    -> (carry, ChunkExtras, (rounds, n_labeled, accuracy, picked, active[,
    metrics]))`` with :class:`NeuralCarry` ``carry`` and each y stacked
    ``[chunk_size, ...]``. Every round splits its four keys from the carried
    loop key, as the per-round driver does, so the two drivers agree bit for
    bit; an inactive round keeps the carry exactly. The body reads nothing
    back to the host, so :class:`~.loop.GraphedChunk` captures its round
    step (:func:`~.loop.chunk_of`). ``stream_cb(round, n_labeled, accuracy,
    active)`` is called as each round finishes, through
    ``chunk_fn.stream`` (a :class:`~.loop.RoundStream`; None without it),
    as in the forest chunk. On a mesh the carry's mask and ``oracle_y`` are
    row-sharded (``pool_x`` too) and ``n_valid`` is the padded pool's real
    row count."""
    from distributed_active_learning_tpu_torch.runtime.loop import chunk_of
    from distributed_active_learning_tpu_torch.runtime.pipeline import ChunkExtras

    round_core = _make_neural_round_core(learner, strat, window_size, beta, with_metrics,
                                         n_classes, coreset_space, batchbald_params)

    def one(pool_x, carry, oracle_y, init_net, test_x, test_y, end_round):
        (mask, key, rnd, net), ys = _lane_step(
            round_core, retrain_from_scratch, label_cap, pool_x, oracle_y,
            carry.labeled_mask, carry.key, carry.round, carry.net, init_net, test_x, test_y,
            end_round, n_valid)
        return carry.replace(labeled_mask=mask, key=key, round=rnd, net=net), ys

    def finish(rows, pool_x, carry, oracle_y, *_):
        ys = _stack_ys(rows, with_metrics)
        st = _lane_state(pool_x, oracle_y, carry.labeled_mask, carry.key, carry.round, n_valid)
        extras = ChunkExtras(n_labeled_after=state_lib.labeled_count(st),
                             n_active=ys[4].sum(dtype=torch.int32))
        return extras, ys

    return chunk_of(one, finish, chunk_size, stream_cb=stream_cb)


def make_neural_sweep_chunk_fn(learner: NeuralLearner, strat: str, window_size: int,
                               chunk_size: int, label_cap: int, n_experiments: int,
                               retrain_from_scratch: bool = True, beta: float = 1.0,
                               with_metrics: bool = False, n_classes: int = 2,
                               coreset_space: str = "input",
                               batchbald_params=_BATCHBALD_DEFAULTS):
    """The seed-sweep chunk: ``chunk_fn(pool_x, carry, oracle_y, init_nets,
    test_x, test_y, end_rounds)`` with a stacked :class:`NeuralCarry` (masks
    ``[E, n]``, keys ``[E, 2]``, rounds ``[E]``, a tuple of E TrainStates),
    each y stacked ``[chunk_size, E, ...]``. Each round step runs the E lanes
    one after another through the serial round body, so every lane equals
    its serial run by construction. ``extras`` reduce over the batch: the
    fewest labels of any lane, the most active rounds of any lane."""
    from distributed_active_learning_tpu_torch.runtime.loop import chunk_of
    from distributed_active_learning_tpu_torch.runtime.pipeline import ChunkExtras

    round_core = _make_neural_round_core(learner, strat, window_size, beta, with_metrics,
                                         n_classes, coreset_space, batchbald_params)
    E = n_experiments

    def one(pool_x, carry, oracle_y, init_nets, test_x, test_y, end_rounds):
        outs, rows = [], []
        for e in range(E):
            out, ys = _lane_step(round_core, retrain_from_scratch, label_cap, pool_x, oracle_y,
                                 carry.labeled_mask[e], carry.key[e], carry.round[e],
                                 carry.net[e], init_nets[e], test_x, test_y, end_rounds[e])
            outs.append(out)
            rows.append(ys)
        masks, keys, rnds, nets = zip(*outs)
        new = carry.replace(labeled_mask=torch.stack(masks), key=torch.stack(keys),
                            round=torch.stack(rnds), net=tuple(nets))
        return new, _stack_ys(rows, with_metrics)

    def finish(rows, pool_x, carry, *_):
        ys = _stack_ys(rows, with_metrics)
        extras = ChunkExtras(
            n_labeled_after=carry.labeled_mask.sum(1, dtype=torch.int32).min(),
            n_active=ys[4].sum(0, dtype=torch.int32).max())
        return extras, ys

    return chunk_of(one, finish, chunk_size)


def _setup(cfg: NeuralExperimentConfig, learner: NeuralLearner, train_x, train_y, test_x,
           test_y):
    """Device tensors and the shared constants of a run."""
    dev = learner.device
    if dev.type == "cuda":
        deterministic_cuda()
    x = torch.as_tensor(np.asarray(train_x)).to(dev)
    y = torch.as_tensor(np.asarray(train_y, dtype=np.int32)).to(dev)
    tx = torch.as_tensor(np.asarray(test_x)).to(dev)
    ty = torch.as_tensor(np.asarray(test_y, dtype=np.int32)).to(dev)
    n_classes = int(np.asarray(train_y).max()) + 1
    return dev, x, y, tx, ty, n_classes


def _start_state(seed: int, y_np, n: int, n_start: int, n_classes: int, dev):
    """The JAX driver's start state: an all-unlabeled pool of ``[n, 0]``
    features (the network reads the pool itself), seeded from
    ``key(seed)``."""
    st = state_lib.init_pool_state(np.zeros((n, 0), np.float32), y_np, prng.key(seed), dev)
    return state_lib.set_start_state(st, n_start, n_classes=max(n_classes, 2))


def _batchbald_params(cfg):
    return (cfg.batchbald_max_configs, cfg.batchbald_candidate_pool, cfg.batchbald_mc_samples)


def _resolve_strategy(cfg) -> str:
    strat = _normalize_deep_name(cfg.strategy)
    if strat not in _deep_names():
        raise KeyError(
            f"unknown deep strategy {cfg.strategy!r}; available: {available_deep_strategies()}")
    return strat


def run_neural_experiment(cfg: NeuralExperimentConfig, learner: NeuralLearner, train_x, train_y,
                          test_x, test_y, debugger: Optional[Debugger] = None,
                          data_ident: Optional[dict] = None, metrics=None,
                          devices=None) -> ExperimentResult:
    """Run one deep-AL experiment on the learner's device; returns the
    per-round records and the final labeled mask (over the real rows).
    ``metrics`` (a ``telemetry.MetricsWriter``) gets one ``round`` event a
    round (with the chunk's RoundMetrics when chunked) and memory gauges;
    with ``checkpoint_dir`` and ``checkpoint_every`` the run resumes from
    the newest ``alstate_<round>.npz`` (either package's, written sharded or
    not) and writes one every ``checkpoint_every`` rounds (chunk boundaries
    when chunked). ``cfg.mesh`` with ``data > 1`` shards the pool over a
    data mesh of ``devices`` (``parallel.mesh.make_mesh``'s list, starting
    with the learner's device; without it the first cards on CUDA, the CPU
    repeated on the CPU)."""
    dbg = debugger or Debugger(enabled=False)
    strat = _resolve_strategy(cfg)
    _refuse_mesh(cfg.mesh)
    dev, pool_x, oracle_y, test_x, test_y, n_classes = _setup(cfg, learner, train_x, train_y,
                                                              test_x, test_y)
    n = pool_x.shape[0]
    state = _start_state(cfg.seed, np.asarray(train_y, dtype=np.int32), n, cfg.n_start,
                         n_classes, dev)
    key = prng.key(cfg.seed + 1, dev)
    net_state = learner.init(prng.key(cfg.seed + 2))
    init_net_state = net_state

    result = ExperimentResult()
    start_round = 0
    ckpt_fp = None
    if cfg.checkpoint_dir and cfg.checkpoint_every:
        from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

        ckpt_fp = neural_fingerprint(cfg, learner, data_ident)
        restored = ckpt_lib.restore_latest_neural(cfg.checkpoint_dir, state, result, net_state,
                                                  fingerprint=ckpt_fp)
        if restored is not None:
            state, result, net_state, key = restored
            key = key.to(dev)
            start_round = int(state.round)
            dbg.debug(f"resumed at round {start_round}")
    if _sharded(cfg.mesh):
        # Placed after a resume: the checkpoint's mask is over the real rows.
        _, state, pool_x = _place_on_mesh(cfg.mesh, state, pool_x, devices, dev)

    if metrics is not None:
        from distributed_active_learning_tpu_torch.parallel.multihost import run_meta

        metrics.meta(config=dataclasses.asdict(cfg), loop="neural", backend=dev.type,
                     n_devices=cfg.mesh.data if _sharded(cfg.mesh) else 1, **run_meta())
    n_pool = state.n_valid  # real rows; mesh padding is never selectable
    use_chunked = cfg.rounds_per_launch > 1 and not dbg.phase_detail
    if use_chunked:
        state = _run_neural_chunked(cfg, learner, strat, state, key, net_state, init_net_state,
                                    pool_x, test_x, test_y, n_classes, result, start_round,
                                    metrics, ckpt_fp)
    else:
        state = _run_neural_rounds(cfg, learner, strat, state, key, net_state, init_net_state,
                                   pool_x, test_x, test_y, n_classes, result, start_round, dbg,
                                   metrics, ckpt_fp, n_pool)
    result.final_labeled_mask = state_lib.global_labeled_mask(state)
    if metrics is not None:
        from distributed_active_learning_tpu_torch.runtime import telemetry

        mem = telemetry.device_memory_gauges()
        if mem:
            metrics.gauges(mem)
    return result


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # audit: ok[DAL101] (phase timing)


def _run_neural_rounds(cfg, learner, strat, state, key, net_state, init_net_state, pool_x,
                       test_x, test_y, n_classes, result, start_round, dbg, metrics, ckpt_fp,
                       n_pool):
    """The per-round driver: one round per host step, each phase timed
    with the device synchronized inside it."""
    dev = pool_x.device
    parts = _RoundParts(learner, strat, cfg.window_size, cfg.beta, False, max(n_classes, 2),
                        cfg.coreset_space, _batchbald_params(cfg))
    round_idx = start_round
    while True:
        n_labeled = int(state_lib.labeled_count(state))
        if n_labeled >= n_pool:
            break
        if cfg.label_budget is not None and n_labeled >= cfg.label_budget:
            break
        if cfg.max_rounds is not None and round_idx - start_round >= cfg.max_rounds:
            break
        round_idx += 1
        ks = prng.split(key, 4)
        key, k_fit, k_mc, k_rand = ks[0], ks[1], ks[2], ks[3]
        with dbg.phase("train"):
            if cfg.retrain_from_scratch:
                net_state = init_net_state
            net_state = parts.train(state, net_state, pool_x, k_fit)
            _sync(dev)
        train_time = dbg.records[-1][1]
        with dbg.phase("acquire"):
            if strat == "batchbald" and n_pool - n_labeled > cfg.batchbald_candidate_pool:
                dbg.debug(
                    "batchbald: candidate pool truncated to top "
                    f"{cfg.batchbald_candidate_pool} of {n_pool - n_labeled} unlabeled points "
                    "(marginal-BALD ranking); raise --candidate-pool to widen")
            picked = parts.acquire(state, net_state, pool_x, k_mc, k_rand)[0]
            state = state_lib.reveal(state, picked)
            _sync(dev)
        score_time = dbg.records[-1][1]
        with dbg.phase("eval"):
            acc = learner.accuracy(net_state, test_x, test_y)
        eval_time = dbg.records[-1][1]
        result.append(RoundRecord(
            round=round_idx, n_labeled=n_labeled, n_unlabeled=n_pool - n_labeled, accuracy=acc,
            train_time=train_time, score_time=score_time, eval_time=eval_time,
            total_time=train_time + score_time + eval_time))
        if metrics is not None:
            metrics.round(round=round_idx, n_labeled=n_labeled, accuracy=acc,
                          train_time=train_time, score_time=score_time, eval_time=eval_time)
        if ckpt_fp is not None and round_idx % cfg.checkpoint_every == 0:
            from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

            ckpt_lib.save_neural(cfg.checkpoint_dir, state, result, net_state, key,
                                 fingerprint=ckpt_fp)
    return state


def _snapshot(carry: NeuralCarry):
    """Fresh copies of the carry a checkpoint writes, queued on the chunk's
    stream right after its dispatch (the graph rewrites its carry buffers at
    the next replay; ``loop.ckpt_snapshot`` for the forest, which also joins
    a row-sharded mask)."""
    from distributed_active_learning_tpu_torch.models.neural import clone_state
    from distributed_active_learning_tpu_torch.runtime.loop import ckpt_snapshot

    return (*ckpt_snapshot(carry.labeled_mask, carry.key, carry.round), clone_state(carry.net))


def _graphed(body, dev, n_inputs_arg: int = 6):
    """``body`` as a GraphedChunk on CUDA (its carry at argument 1, the end
    round(s) at argument 6), the body itself on the CPU."""
    if dev.type != "cuda":
        return body
    from distributed_active_learning_tpu_torch.runtime.loop import GraphedChunk

    return GraphedChunk(body, input_args=(n_inputs_arg,),
                        carry_fields=NEURAL_CARRY_FIELDS)


def _run_neural_chunked(cfg, learner, strat, state, key, net_state, init_net_state, pool_x,
                        test_x, test_y, n_classes, result, start_round, metrics, ckpt_fp):
    """The chunked driver: K rounds a launch through ``run_pipelined``."""
    from distributed_active_learning_tpu_torch.runtime import pipeline as pipeline_lib
    from distributed_active_learning_tpu_torch.runtime import telemetry
    from distributed_active_learning_tpu_torch.runtime.loop import round_stream_cb
    from distributed_active_learning_tpu_torch.runtime.pipeline import _map_leaves

    dev = pool_x.device
    n_pool = state.n_valid
    K, window = cfg.rounds_per_launch, cfg.window_size
    label_cap = n_pool if cfg.label_budget is None else min(cfg.label_budget, n_pool)
    want_metrics = metrics is not None
    stream_cb = (round_stream_cb(metrics) if metrics is not None and cfg.stream_round_events
                 else None)
    body = make_neural_chunk_fn(learner, strat, window, K, label_cap,
                                retrain_from_scratch=cfg.retrain_from_scratch, beta=cfg.beta,
                                with_metrics=want_metrics, n_classes=max(n_classes, 2),
                                coreset_space=cfg.coreset_space,
                                batchbald_params=_batchbald_params(cfg), stream_cb=stream_cb,
                                n_valid=state.n_valid_static)
    chunk_fn = _graphed(body, dev)
    launches = telemetry.LaunchTracker(metrics, "neural_chunk_scan", fn=chunk_fn)
    end_round = (start_round + cfg.max_rounds if cfg.max_rounds is not None
                 else int(np.iinfo(np.int32).max))
    end_dev = torch.as_tensor(end_round, dtype=torch.int32).to(dev)
    ctl = pipeline_lib.ChunkDriveControl(K, window, label_cap, cfg.max_rounds,
                                         int(state_lib.labeled_count(state)), start_round)
    if ctl.already_done:
        return state
    carry = NeuralCarry(labeled_mask=_map_leaves(torch.clone, state.labeled_mask),
                        key=key.to(dev),
                        round=torch.as_tensor(int(state.round), dtype=torch.int32).to(dev),
                        net=net_state)
    snapshots = pipeline_lib.CarrySnapshots(_snapshot)

    def dispatch(c, idx):
        out = chunk_fn(pool_x, c, state.oracle_y, init_net_state, test_x, test_y, end_dev)
        if ckpt_fp is not None:
            snapshots.take(idx, out[0])
        return out

    def touchdown(idx, _n_after, n_active, ys, _out, wall):
        snap = snapshots.pop(idx)
        if body.stream is not None:
            body.stream.wait_chunk()  # this chunk's round_stream events are written
        if n_active == 0:
            return
        rounds_y, labeled_y, acc_y, _picked_y, active_y = ys[:5]
        active_np = active_y.numpy()
        rounds_np = rounds_y.numpy()[active_np]
        labeled_np = labeled_y.numpy()[active_np]
        acc_np = acc_y.numpy()[active_np]
        round_dicts = (telemetry.stacked_metrics_to_dicts(ys[5], active_np)
                       if want_metrics else None)
        result.extend_from_arrays(rounds_np, labeled_np, n_pool - labeled_np, acc_np,
                                  total_time=wall / n_active, metrics=round_dicts)
        ctl.note_round(int(rounds_np[-1]))
        if metrics is not None:
            for i in range(len(rounds_np)):
                metrics.round(round=int(rounds_np[i]), n_labeled=int(labeled_np[i]),
                              accuracy=float(acc_np[i]),
                              **(round_dicts[i] if round_dicts else {}))
        if ckpt_fp is not None and ctl.checkpoint_due(cfg.checkpoint_every):
            from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib

            mask, key_s, rnd, net_s = snap
            ckpt_lib.save_neural(cfg.checkpoint_dir,
                                 state.replace(labeled_mask=mask, round=int(rnd)), result, net_s,
                                 key_s, fingerprint=ckpt_fp)
            ctl.checkpoint_done()

    try:
        carry, stats = pipeline_lib.run_pipelined(
            carry, dispatch=dispatch, touchdown=touchdown, continue_after=ctl.continue_after,
            depth=max(int(cfg.pipeline_depth or 1), 1), on_launch=launches.record,
            may_dispatch=ctl.may_dispatch,
            on_veto=lambda idx: launches.veto(idx, ctl.veto_reason(idx)))
    finally:
        if body.stream is not None:
            body.stream.close()
    result.pipeline_stats = stats
    if chunk_fn is not body:
        result.graph_stats = chunk_fn.stats()
    return state.replace(labeled_mask=_map_leaves(torch.clone, carry.labeled_mask),
                         round=int(carry.round))


def run_neural_sweep(cfg: NeuralExperimentConfig, learner: NeuralLearner, train_x, train_y,
                     test_x, test_y, seeds, debugger: Optional[Debugger] = None,
                     data_ident: Optional[dict] = None, metrics=None,
                     devices=None) -> List[ExperimentResult]:
    """E = len(seeds) deep-AL experiments over one shared pool as one launch
    stream; one :class:`ExperimentResult` per seed, each equal to the serial
    :func:`run_neural_experiment` with ``seed=s``. Per-phase debugging and a
    device mesh (``devices`` as there) run the seeds serially, as in JAX;
    checkpointing is refused, as in JAX."""
    dbg = debugger or Debugger(enabled=False)
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("run_neural_sweep needs at least one seed")
    strat = _resolve_strategy(cfg)
    if cfg.checkpoint_dir and cfg.checkpoint_every:
        raise ValueError(
            "checkpointing is not supported by the batched neural sweep; "
            "run the seeds serially or drop --checkpoint-dir")
    _refuse_mesh(cfg.mesh)
    if dbg.phase_detail or _sharded(cfg.mesh):
        return [run_neural_experiment(dataclasses.replace(cfg, seed=s), learner, train_x,
                                      train_y, test_x, test_y, debugger=debugger,
                                      data_ident=data_ident, metrics=metrics, devices=devices)
                for s in seeds]
    from distributed_active_learning_tpu_torch.runtime import pipeline as pipeline_lib
    from distributed_active_learning_tpu_torch.runtime import telemetry

    dev, pool_x, oracle_y, test_x, test_y, n_classes = _setup(cfg, learner, train_x, train_y,
                                                              test_x, test_y)
    n = pool_x.shape[0]
    y_np = np.asarray(train_y, dtype=np.int32)
    states = [_start_state(s, y_np, n, cfg.n_start, n_classes, dev) for s in seeds]
    E = len(seeds)
    K = max(int(cfg.rounds_per_launch or 1), 1)
    window = cfg.window_size
    label_cap = n if cfg.label_budget is None else min(cfg.label_budget, n)
    init_nets = tuple(learner.init(prng.key(s + 2)) for s in seeds)
    if metrics is not None:
        from distributed_active_learning_tpu_torch.parallel.multihost import run_meta

        metrics.meta(config=dataclasses.asdict(cfg), loop="neural_sweep", backend=dev.type,
                     n_devices=1, **run_meta(), sweep_seeds=seeds)
    want_metrics = metrics is not None
    body = make_neural_sweep_chunk_fn(learner, strat, window, K, label_cap, E,
                                      retrain_from_scratch=cfg.retrain_from_scratch,
                                      beta=cfg.beta, with_metrics=want_metrics,
                                      n_classes=max(n_classes, 2),
                                      coreset_space=cfg.coreset_space,
                                      batchbald_params=_batchbald_params(cfg))
    chunk_fn = _graphed(body, dev)
    launches = telemetry.LaunchTracker(metrics, "neural_sweep_chunk_scan", fn=chunk_fn)
    end_round = cfg.max_rounds if cfg.max_rounds is not None else int(np.iinfo(np.int32).max)
    end_rounds = torch.full((E,), end_round, dtype=torch.int32, device=dev)
    masks0 = torch.stack([st.labeled_mask for st in states])
    counts0 = [int(c) for c in masks0.sum(1).tolist()]
    carry = NeuralCarry(labeled_mask=masks0,
                        key=torch.stack([prng.key(s + 1, dev) for s in seeds]),
                        round=torch.zeros((E,), dtype=torch.int32, device=dev),
                        net=init_nets)
    ctl = pipeline_lib.ChunkDriveControl(K, window, label_cap, cfg.max_rounds, min(counts0), 0)
    results = [ExperimentResult() for _ in seeds]

    def dispatch(c, _idx):
        return chunk_fn(pool_x, c, oracle_y, init_nets, test_x, test_y, end_rounds)

    def touchdown(_idx, _n_after, n_active, ys, _out, wall):
        if n_active == 0:
            return
        rounds_y, labeled_y, acc_y, _picked_y, active_y = ys[:5]
        active_np = active_y.numpy()
        total_active = int(active_np.sum())
        md = (telemetry.stacked_sweep_metrics_to_dicts(ys[5], active_np)
              if want_metrics else None)
        last_round = ctl.round_idx
        for e in range(E):
            act = active_np[:, e]
            if not act.any():
                continue
            r_e = rounds_y.numpy()[act, e]
            l_e = labeled_y.numpy()[act, e]
            a_e = acc_y.numpy()[act, e]
            results[e].extend_from_arrays(r_e, l_e, n - l_e, a_e, total_time=wall / total_active,
                                          metrics=md[e] if md is not None else None)
            last_round = max(last_round, int(r_e[-1]))
            if metrics is not None:
                for i in range(len(r_e)):
                    metrics.round(exp=e, seed=seeds[e], round=int(r_e[i]),
                                  n_labeled=int(l_e[i]), accuracy=float(a_e[i]),
                                  **(md[e][i] if md is not None else {}))
        ctl.note_round(last_round)

    if not ctl.already_done:
        carry, stats = pipeline_lib.run_pipelined(
            carry, dispatch=dispatch, touchdown=touchdown, continue_after=ctl.continue_after,
            depth=max(int(cfg.pipeline_depth or 1), 1), on_launch=launches.record,
            may_dispatch=ctl.may_dispatch,
            on_veto=lambda idx: launches.veto(idx, ctl.veto_reason(idx)))
        for r in results:
            r.pipeline_stats = stats
    graph_stats = None if chunk_fn is body else chunk_fn.stats()
    for e, r in enumerate(results):
        r.final_labeled_mask = carry.labeled_mask[e].clone()
        r.graph_stats = graph_stats
    if metrics is not None:
        mem = telemetry.device_memory_gauges()
        if mem:
            metrics.gauges(mem)
    return results
