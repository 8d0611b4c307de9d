"""Strategy protocol: a pure scoring function plus selection direction (the
port of ``strategies/base.py``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from distributed_active_learning_tpu_torch.config import StrategyConfig


@dataclasses.dataclass(frozen=True)
class StrategyAux:
    """Optional per-round auxiliary inputs: the LAL regressor
    (``lal_forest``, a forest the ``lal`` strategy evaluates over its
    features) and ``seed_mask``, the initially labeled mask."""

    lal_forest: Optional[object] = None
    seed_mask: Optional[torch.Tensor] = None


# (forest, state, key, aux) -> scores [n_pool]
ScoreFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Strategy:
    """A named scoring rule; ``higher_is_better`` picks top-k vs bottom-k."""

    name: str
    score: ScoreFn
    higher_is_better: bool = True


_REGISTRY: Dict[str, Callable[[StrategyConfig], Strategy]] = {}


def register_strategy(name: str):
    def deco(builder: Callable[[StrategyConfig], Strategy]):
        _REGISTRY[name] = builder
        return builder
    return deco


def available_strategies():
    return sorted(_REGISTRY)


def get_strategy(cfg: StrategyConfig) -> Strategy:
    if cfg.name not in _REGISTRY:
        raise KeyError(f"unknown strategy {cfg.name!r}; available: {available_strategies()}")
    return _REGISTRY[cfg.name](cfg)
