"""Core strategies (the port of ``strategies/core.py``): random, uncertainty,
soft_uncertainty, entropy, full_entropy, margin and density. Over a binary
forest they score the vote fraction (or the mean leaf value); over a
multiclass :class:`~..ops.trees_multi.MultiForest` the class probabilities:
uncertainty, soft_uncertainty and margin take the top-2 margin, entropy and
full_entropy the full entropy, density its entropy term likewise."""

from __future__ import annotations

import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import StrategyConfig
from distributed_active_learning_tpu_torch.ops import forest_eval, scoring, similarity, trees_multi
from distributed_active_learning_tpu_torch.ops.xla_f32 import row_sum
from distributed_active_learning_tpu_torch.parallel.kernels import sharded_similarity_mass
from distributed_active_learning_tpu_torch.parallel.mesh import Sharded, mesh_of
from distributed_active_learning_tpu_torch.strategies.base import Strategy, register_strategy


def _multi_margin(forest, state) -> torch.Tensor:
    return trees_multi.margin_score_multi(trees_multi.proba_multi(forest, state.x))


def _multi_entropy(forest, state) -> torch.Tensor:
    return trees_multi.entropy_multi(trees_multi.proba_multi(forest, state.x))


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
        if trees_multi.is_multi(forest):  # least confident: the smallest top-2 margin
            return _multi_margin(forest, state)
        return scoring.uncertainty_score(_vote_fraction(forest, state))

    return Strategy(name="uncertainty", score=score, higher_is_better=False)


@register_strategy("soft_uncertainty")
def _soft_uncertainty(cfg: StrategyConfig) -> Strategy:
    """Least-confidence over the mean leaf probability, ascending. The mean
    is kept as its operands (the tree sum and T), because XLA contracts
    ``1 - sum * (1/T)`` into one FMA as it does for the vote fraction."""

    def score(forest, state, key, aux):
        del key, aux
        if trees_multi.is_multi(forest):
            return _multi_margin(forest, state)
        total = row_sum(forest_eval.leaves(forest, state.x))
        return scoring.uncertainty_score(scoring.VoteFraction(total, forest.n_trees))

    return Strategy(name="soft_uncertainty", score=score, higher_is_better=False)


@register_strategy("entropy")
def _entropy(cfg: StrategyConfig) -> Strategy:
    """The reference's one-sided entropy ``-(1-p) log2(1-p)``, descending."""

    def score(forest, state, key, aux):
        del key, aux
        if trees_multi.is_multi(forest):
            return _multi_entropy(forest, state)
        return scoring.positive_entropy(_vote_fraction(forest, state))

    return Strategy(name="entropy", score=score, higher_is_better=True)


@register_strategy("full_entropy")
def _full_entropy(cfg: StrategyConfig) -> Strategy:
    """Binary entropy in bits, descending."""

    def score(forest, state, key, aux):
        del key, aux
        if trees_multi.is_multi(forest):
            return _multi_entropy(forest, state)
        return scoring.full_entropy(_vote_fraction(forest, state))

    return Strategy(name="full_entropy", score=score, higher_is_better=True)


@register_strategy("margin")
def _margin(cfg: StrategyConfig) -> Strategy:
    """Binary top-2 margin ``|2p - 1|``, ascending."""

    def score(forest, state, key, aux):
        del key, aux
        if trees_multi.is_multi(forest):
            return _multi_margin(forest, state)
        return scoring.margin_score(_vote_fraction(forest, state))

    return Strategy(name="margin", score=score, higher_is_better=False)


@register_strategy("density")
def _density(cfg: StrategyConfig) -> Strategy:
    """Information density: the one-sided entropy times the similarity mass
    to the power ``beta``, descending (``density_weighting.py:148-168``).
    The mass counts the current unlabeled rows; ``options={"mass_over":
    "non_seed"}`` (with ``aux.seed_mask``) counts every row but the initial
    seeds, as the reference does. On a mesh the mass is
    ``parallel.kernels.sharded_similarity_mass``."""
    mass_over = dict(cfg.options).get("mass_over", "unlabeled")
    beta = cfg.beta

    def score(forest, state, key, aux):
        del key
        if trees_multi.is_multi(forest):
            ent = _multi_entropy(forest, state)
        else:
            ent = scoring.positive_entropy(_vote_fraction(forest, state))
        if mass_over == "non_seed" and aux.seed_mask is not None:
            count_mask = ~aux.seed_mask
        else:
            count_mask = ~state.labeled_mask
        if isinstance(state.x, Sharded):  # a mesh: one [d] vector crosses the data axis
            raw = sharded_similarity_mass(mesh_of(state.x))(state.x, count_mask)
        else:
            raw = similarity.similarity_mass(state.x, count_mask)
        # The mass can dip below 0 for adversarial rows; clamp so the power
        # is defined.
        mass = torch.clamp_min(raw, 0.0)
        return ent * torch.pow(mass, beta)

    return Strategy(name="density", score=score, higher_is_better=True)
