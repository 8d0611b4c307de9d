"""Acquisition scoring primitives (pure functions over probabilities/votes),
the port of ``ops/scoring.py``; the formulas are written in the same order of
operations, with XLA's CPU contractions written out (:mod:`.xla_f32`).

A hard-vote score takes a :class:`VoteFraction`: XLA turns ``votes / T`` into
``votes * f32(1/T)`` and contracts that product into the subtraction after it
(``1 - p`` becomes ``fma(-votes, 1/T, 1)``; ``2p - 1`` becomes ``fma(votes,
2/T, -1)``), so the score needs both operands, not the rounded fraction. A
plain tensor (the soft mean-leaf probability) is scored op by op.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from distributed_active_learning_tpu_torch.ops.xla_f32 import div_const, fma_f32, log2_f32, recip_f32


@dataclasses.dataclass(frozen=True)
class VoteFraction:
    """``votes / n_trees`` kept as its operands (``votes`` float32: hard vote
    counts, or the sum of the trees' leaf values for the soft mean)."""

    votes: torch.Tensor
    n_trees: int

    @property
    def value(self) -> torch.Tensor:
        return div_const(self.votes, self.n_trees)

    def one_minus(self) -> torch.Tensor:
        return fma_f32(-self.votes, recip_f32(self.n_trees), 1.0)

    def twice_minus_one(self) -> torch.Tensor:
        return fma_f32(self.votes, 2.0 * recip_f32(self.n_trees), -1.0)


Prob = Union[torch.Tensor, VoteFraction]


def _one_minus(p: Prob) -> torch.Tensor:
    return p.one_minus() if isinstance(p, VoteFraction) else 1.0 - p


def _value(p: Prob) -> torch.Tensor:
    return p.value if isinstance(p, VoteFraction) else p


def uncertainty_score(p_pos: Prob) -> torch.Tensor:
    """Least-confidence distance from the decision boundary,
    ``abs(0.5 - (1 - p))`` (``uncertainty_sampling.py:98,106``). Lower = more
    uncertain."""
    return torch.abs(0.5 - _one_minus(p_pos))


def positive_entropy(p_pos: Prob, eps: float = 1e-12) -> torch.Tensor:
    """The reference's one-sided entropy ``-(1-p) * log2(1-p)``
    (``density_weighting.py:148``)."""
    q = torch.clamp(_one_minus(p_pos), eps, 1.0)
    return -q * log2_f32(q)


def full_entropy(p_pos: Prob, eps: float = 1e-6) -> torch.Tensor:
    """Binary entropy in bits; ``eps`` stays float32-representable so a
    unanimous forest gives 0, not nan. The sum of the two products is one
    FMA on XLA's CPU."""
    p = torch.clamp(_value(p_pos), eps, 1.0 - eps)
    return -fma_f32(p, log2_f32(p), (1.0 - p) * log2_f32(1.0 - p))


def margin_score(p_pos: Prob) -> torch.Tensor:
    """Binary top-2 margin ``|2p - 1|``. Lower = more uncertain."""
    if isinstance(p_pos, VoteFraction):
        return torch.abs(p_pos.twice_minus_one())
    return torch.abs(2.0 * p_pos - 1.0)


def vote_sd(votes: torch.Tensor, n_trees: int) -> torch.Tensor:
    """Standard deviation of per-tree Bernoulli votes, ``sqrt(p (1 - p))``
    with ``p = votes * f32(1/T)`` (LAL feature f_2). ``p`` is read twice, so
    XLA does not contract ``1 - p`` into an FMA here (it does where the
    product has one use, :meth:`VoteFraction.one_minus`)."""
    p = div_const(votes, n_trees)
    return torch.sqrt(p * (1.0 - p))
