"""Core strategies over binary forests (the port of ``strategies/core.py``):
random, uncertainty, soft_uncertainty, entropy, full_entropy, margin.
``density`` waits for ``ops/similarity.py``; the multiclass branches wait for
the multiclass slice."""

from __future__ import annotations

import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import StrategyConfig
from distributed_active_learning_tpu_torch.ops import forest_eval, scoring
from distributed_active_learning_tpu_torch.ops.xla_f32 import row_sum
from distributed_active_learning_tpu_torch.strategies.base import Strategy, register_strategy


def _vote_fraction(forest, state) -> scoring.VoteFraction:
    """Positive-vote fraction per pool point (votes / T, f32), kept as its
    operands so the scores write out XLA's contraction."""
    votes = forest_eval.votes(forest, state.x)
    return scoring.VoteFraction(votes.to(torch.float32), forest.n_trees)


@register_strategy("random")
def _random(cfg: StrategyConfig) -> Strategy:
    """Uniform-random priorities + top-k: the control baseline."""

    def score(forest, state, key, aux):
        del forest, aux
        return prng.uniform(key, (state.n_pool,), state.x.device)

    return Strategy(name="random", score=score, higher_is_better=True)


@register_strategy("uncertainty")
def _uncertainty(cfg: StrategyConfig) -> Strategy:
    """Least-confidence: distance of the vote fraction from 0.5, ascending."""

    def score(forest, state, key, aux):
        del key, aux
        return scoring.uncertainty_score(_vote_fraction(forest, state))

    return Strategy(name="uncertainty", score=score, higher_is_better=False)


@register_strategy("soft_uncertainty")
def _soft_uncertainty(cfg: StrategyConfig) -> Strategy:
    """Least-confidence over the mean leaf probability, ascending. The mean
    is kept as its operands (the tree sum and T), because XLA contracts
    ``1 - sum * (1/T)`` into one FMA as it does for the vote fraction."""

    def score(forest, state, key, aux):
        del key, aux
        total = row_sum(forest_eval.leaves(forest, state.x))
        return scoring.uncertainty_score(scoring.VoteFraction(total, forest.n_trees))

    return Strategy(name="soft_uncertainty", score=score, higher_is_better=False)


@register_strategy("entropy")
def _entropy(cfg: StrategyConfig) -> Strategy:
    """The reference's one-sided entropy ``-(1-p) log2(1-p)``, descending."""

    def score(forest, state, key, aux):
        del key, aux
        return scoring.positive_entropy(_vote_fraction(forest, state))

    return Strategy(name="entropy", score=score, higher_is_better=True)


@register_strategy("full_entropy")
def _full_entropy(cfg: StrategyConfig) -> Strategy:
    """Binary entropy in bits, descending."""

    def score(forest, state, key, aux):
        del key, aux
        return scoring.full_entropy(_vote_fraction(forest, state))

    return Strategy(name="full_entropy", score=score, higher_is_better=True)


@register_strategy("margin")
def _margin(cfg: StrategyConfig) -> Strategy:
    """Binary top-2 margin ``|2p - 1|``, ascending."""

    def score(forest, state, key, aux):
        del key, aux
        return scoring.margin_score(_vote_fraction(forest, state))

    return Strategy(name="margin", score=score, higher_is_better=False)
