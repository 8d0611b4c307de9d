"""Scenario-engine primitives (the port of ``scenarios/engine.py``): the
deterministic transforms every driver shares.

Scenario randomness is keyed apart from the experiment: flip masks, cost
vectors and the drift direction derive from ``ScenarioConfig.seed`` salted
with :data:`_SALT` (plus the cell's experiment seed or dataset name where a
cell varies), never from ``PoolState.key``, so a ``none`` cell's stream is
the clean one. The draws are the port's threefry (``prng``), bit for bit the
JAX package's, on whatever device the caller names: the serial setup, the
grid's setup and the card draw the same flips and costs. Every helper is the
identity (all-False masks, unit costs, untransformed arrays) for an inactive
scenario.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import ScenarioConfig

SCENARIO_KINDS = ("none", "noisy_oracle", "cost_budget", "rare_event", "drift")

#: Domain separator for scenario keys, so a scenario seed equal to an
#: experiment seed still draws an unrelated stream.
_SALT = 0x5CE7A410

#: Relative tolerance of a mean-shift direction wider than 3 features
#: against the JAX package's (see :func:`drift_direction`).
DRIFT_DIRECTION_RTOL = 1e-6


def scenario_from_name(name: str, base: Optional[ScenarioConfig] = None) -> ScenarioConfig:
    """A :class:`ScenarioConfig` of kind ``name`` carrying ``base``'s knobs
    (the CLI's ``--scenarios a,b,c`` axis shares one knob set)."""
    if name not in SCENARIO_KINDS:
        raise ValueError(f"unknown scenario {name!r}; one of {SCENARIO_KINDS}")
    return dataclasses.replace(base if base is not None else ScenarioConfig(), kind=name)


def validate_scenario(scn: ScenarioConfig, *, strategy=None, max_rounds=None) -> None:
    """Refuse an unservable scenario at run start, with the JAX package's
    messages. ``strategy`` gates the knapsack's score direction;
    ``max_rounds`` is the only stop an abstaining oracle has."""
    if scn.kind not in SCENARIO_KINDS:
        raise ValueError(f"unknown scenario kind {scn.kind!r}; one of {SCENARIO_KINDS}")
    if not scn.active:
        return
    if scn.kind == "noisy_oracle":
        if not (0.0 <= scn.flip_prob <= 1.0 and 0.0 <= scn.abstain_prob <= 1.0):
            raise ValueError(
                f"noisy_oracle needs flip_prob/abstain_prob in [0, 1], got "
                f"{scn.flip_prob}/{scn.abstain_prob}"
            )
        if scn.flip_prob == 0.0 and scn.abstain_prob == 0.0:
            raise ValueError(
                "noisy_oracle with flip_prob=0 and abstain_prob=0 is the "
                "clean oracle; use scenario 'none' or set a probability"
            )
        if scn.abstain_prob > 0.0 and max_rounds is None:
            raise ValueError(
                "an abstaining oracle may never reach the label budget "
                "(abstained picks re-enter the pool), so the run needs "
                "max_rounds as its stop; set --rounds"
            )
    elif scn.kind == "cost_budget":
        if scn.cost_budget <= 0.0:
            raise ValueError("cost_budget scenario needs cost_budget > 0")
        if scn.cost_spread < 0.0:
            raise ValueError(f"cost_spread must be >= 0, got {scn.cost_spread}")
        if strategy is not None and not strategy.higher_is_better:
            raise ValueError(
                f"knapsack selection ranks by score-per-cost and assumes "
                f"nonnegative higher-is-better scores; strategy "
                f"{strategy.name!r} selects ascending — use an "
                "entropy/density-family strategy for cost_budget"
            )
    elif scn.kind == "rare_event":
        if scn.rare_class < 0:
            raise ValueError(f"rare_class must be >= 0, got {scn.rare_class}")
    elif scn.kind == "drift":
        if scn.drift_rate <= 0.0:
            raise ValueError("drift scenario needs drift_rate > 0")
        if scn.drift_kind not in ("mean_shift", "rotation"):
            raise ValueError(
                f"unknown drift_kind {scn.drift_kind!r}; "
                "'mean_shift' or 'rotation'"
            )


def _base_key(scn: ScenarioConfig) -> prng.Key:
    return prng.key((scn.seed ^ _SALT) & 0xFFFFFFFF)


def dataset_fold(name: str) -> int:
    """Stable per-dataset fold constant (crc32 of the name), so the serial
    driver and the grid derive identical per-dataset draws."""
    return zlib.crc32(str(name).encode()) & 0x7FFFFFFF


def flip_mask(scn: ScenarioConfig, cell_seed: int, n: int, device=None) -> torch.Tensor:
    """The per-experiment label-flip mask ``[n] bool``, drawn once per
    (scenario seed, experiment seed): a flipped point stays flipped for the
    whole experiment. All False when the scenario has no flips."""
    if scn.kind != "noisy_oracle" or scn.flip_prob <= 0.0:
        return torch.zeros(n, dtype=torch.bool, device=device)
    k = prng.fold_in(_base_key(scn), int(cell_seed))
    return prng.uniform(k, (n,), device) < scn.flip_prob


def flip_mask_block(scn: ScenarioConfig, cell_seed: int, n_pool: int, shard_index: int,
                    rows: int, device=None) -> torch.Tensor:
    """Shard ``shard_index``'s ``[rows]`` block of :func:`flip_mask` (rows
    ``[shard_index * rows, (shard_index + 1) * rows)``): the draw is keyed by
    global row, so each shard draws the whole ``[n_pool]`` vector and keeps
    its rows, and the blocks join to :func:`flip_mask` at any shard count."""
    start = int(shard_index) * rows
    return flip_mask(scn, cell_seed, n_pool, device)[start:start + rows]


def abstain_draw(scn: ScenarioConfig, abstain_key: prng.Key, shape) -> torch.Tensor:
    """The noisy oracle's keep-draw for a pick window: True where the oracle
    answers (probability ``1 - abstain_prob``); all True otherwise."""
    if scn.kind != "noisy_oracle" or scn.abstain_prob <= 0.0:
        return torch.ones(shape, dtype=torch.bool, device=abstain_key.device)
    return prng.uniform(abstain_key, shape) >= scn.abstain_prob


def apply_flips(oracle_y: torch.Tensor, flips: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Oracle labels with the flip mask applied: 0 <-> 1 for a binary pool,
    the next class (``(y + 1) % C``) for a multiclass one."""
    if n_classes <= 2:
        return torch.where(flips, 1 - oracle_y, oracle_y)
    return torch.where(flips, (oracle_y + 1) % n_classes, oracle_y)


def make_costs(scn: ScenarioConfig, n: int, dataset_name: str = "", device=None) -> torch.Tensor:
    """The per-point labeling costs ``[n] float32`` in ``[1, 1 +
    cost_spread]``, keyed by (scenario seed, dataset name): every seed of one
    dataset prices its points alike. Unit costs for other scenarios. The JAX
    package draws them eagerly, outside any compiled round, so ``1 + spread
    * u`` rounds the product and the sum apart, as here."""
    if scn.kind != "cost_budget":
        return torch.ones(n, dtype=torch.float32, device=device)
    k = prng.fold_in(_base_key(scn), dataset_fold(dataset_name))
    return 1.0 + prng.uniform(k, (n,), device) * float(scn.cost_spread)


def drift_direction(scn: ScenarioConfig, d: int, device=None) -> torch.Tensor:
    """The mean-shift drift's unit direction ``[d]``: a standard normal draw
    from the scenario key over its norm (floored at 1e-6). The squared norm
    is summed in ascending order with fused multiply-adds, XLA's spelling
    of a short fused reduce: the JAX package's bits at d <= 3 (held in
    ``tests/test_torch_prng.py``); longer rows XLA may vectorize, so wider
    directions agree with JAX's only to ``DRIFT_DIRECTION_RTOL``. The card
    computes the CPU's bits (elementwise operations only)."""
    from distributed_active_learning_tpu_torch.ops.xla_f32 import fma_f32

    u = prng.normal(_base_key(scn), (d,), device)
    acc = torch.zeros((), dtype=torch.float32, device=u.device)
    for i in range(d):
        acc = fma_f32(u[i], u[i], acc)
    return u / torch.clamp_min(torch.sqrt(acc.double()).float(), 1e-6)


def drift_apply(scn: ScenarioConfig, x: torch.Tensor, round_, direction=None) -> torch.Tensor:
    """The round-``round_`` drifted view of an evaluation batch
    (``data.synthetic.drift_transform``): ``mean_shift`` moves along the
    scenario's unit direction by ``drift_rate`` a round, ``rotation`` turns
    the first two coordinates by ``drift_rate`` radians a round. ``round_``
    is an int or a 0-d int tensor on ``x``'s device (a chunk's round
    counter: nothing crosses to the host). ``direction`` may be passed in
    precomputed (:func:`drift_direction`), as the chunks do. Identity for
    other scenarios."""
    if scn.kind != "drift" or scn.drift_rate <= 0.0:
        return x
    from distributed_active_learning_tpu_torch.data.synthetic import drift_transform

    if scn.drift_kind == "mean_shift" and direction is None:
        direction = drift_direction(scn, x.shape[-1], x.device)
    return drift_transform(x, round_, kind=scn.drift_kind, rate=scn.drift_rate,
                           direction=direction)


def rare_recall(labeled_mask: torch.Tensor, oracle_y: torch.Tensor, valid_mask: torch.Tensor,
                rare_class: int) -> torch.Tensor:
    """Recall-at-budget: the fraction of the pool's ``rare_class`` points
    labeled so far (0 for an empty class)."""
    rare = (oracle_y == rare_class) & valid_mask
    total = rare.sum(dtype=torch.int32)
    found = (rare & labeled_mask).sum(dtype=torch.int32)
    return found.to(torch.float32) / torch.clamp_min(total, 1).to(torch.float32)
