"""Acquisition scoring primitives (pure functions over probabilities/votes),
the port of ``ops/scoring.py``; the formulas are written in the same order of
operations."""

from __future__ import annotations

import numpy as np
import torch


def div_const(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as the JAX package computes it: XLA
    rewrites a division by a constant into a multiplication by the constant's
    float32 reciprocal, which differs from a true division in the last place
    when ``1/c`` is inexact (e.g. ``c = 13``). Written out here so vote
    fractions, tree means and accuracies match bit for bit."""
    return x * float(np.float32(1.0) / np.float32(c))


def uncertainty_score(p_pos: torch.Tensor) -> torch.Tensor:
    """Least-confidence distance from the decision boundary,
    ``abs(0.5 - (1 - p))`` (``uncertainty_sampling.py:98,106``). Lower = more
    uncertain."""
    return torch.abs(0.5 - (1.0 - p_pos))


def positive_entropy(p_pos: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The reference's one-sided entropy ``-(1-p) * log2(1-p)``
    (``density_weighting.py:148``)."""
    q = torch.clamp(1.0 - p_pos, eps, 1.0)
    return -q * torch.log2(q)


def full_entropy(p_pos: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Binary entropy in bits; ``eps`` stays float32-representable so a
    unanimous forest gives 0, not nan."""
    p = torch.clamp(p_pos, eps, 1.0 - eps)
    return -(p * torch.log2(p) + (1.0 - p) * torch.log2(1.0 - p))


def margin_score(p_pos: torch.Tensor) -> torch.Tensor:
    """Binary top-2 margin ``|2p - 1|``. Lower = more uncertain."""
    return torch.abs(2.0 * p_pos - 1.0)


def vote_sd(votes: torch.Tensor, n_trees: int) -> torch.Tensor:
    """Standard deviation of per-tree Bernoulli votes (LAL feature f_2)."""
    p = votes / n_trees
    return torch.sqrt(p * (1.0 - p))
