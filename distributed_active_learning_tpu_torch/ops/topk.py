"""Masked top-k / bottom-k selection over the unlabeled pool (the port of
``ops/topk.py``).

``lax.top_k`` breaks value ties by the lowest index; ``torch.topk`` promises
no order among ties. Every selection here is a stable descending sort, which
keeps index order among equal values, followed by the first ``k``.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = float("-inf")
POS_INF = float("inf")


def stable_top_k(values: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the ``k`` largest values, equal
    values in ascending index order. ``torch.topk`` promises no order among
    ties; a stable descending sort does (hard-vote scores take only T+1
    values, so ties are everywhere)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_top_k(
    scores: torch.Tensor, unlabeled_mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values [k], indices [k])`` of the k highest-scoring unlabeled
    points; if fewer than k are unlabeled the tail points at -inf entries."""
    masked = torch.where(unlabeled_mask, scores, torch.full_like(scores, NEG_INF))
    return stable_top_k(masked, k)


def select_bottom_k(
    scores: torch.Tensor, unlabeled_mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k lowest-scoring unlabeled points, as the JAX code spells it: top-k
    of the negated masked scores, values negated back."""
    masked = torch.where(unlabeled_mask, scores, torch.full_like(scores, POS_INF))
    vals, idx = stable_top_k(-masked, k)
    return -vals, idx


def merge_tile_topk(
    tile_vals: torch.Tensor, tile_idx: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-tile descending candidate lists into the global top-k.

    Exact as in the JAX package: every global winner is among its own tile's
    best, tiles arrive in ascending base-index order and each tile's ties in
    ascending index order, so a stable sort of the flattened candidates
    orders ties exactly as a stable sort of the full vector would.
    """
    flat_vals = tile_vals.reshape(-1)
    flat_idx = tile_idx.reshape(-1)
    vals, pos = stable_top_k(flat_vals, k)
    return vals, flat_idx[pos]


def knapsack_top_k(scores: torch.Tensor, costs: torch.Tensor, unlabeled_mask: torch.Tensor,
                   k: int, budget: float):
    """Greedy budget-constrained selection (the cost_budget scenario's):
    ``k`` steps, each taking the highest ``scores / costs`` among the
    unlabeled points still affordable under the remaining budget and paying
    its cost. Once nothing affordable remains a step emits a sentinel
    (``keep`` False, value ``NEG_INF``, index redirected onto the first
    pick). Ties go to the lowest index (``torch.argmax`` returns the first
    maximum on every device). Plain PyTorch, as the JAX package's is plain
    XLA (a ``lax.scan`` of argmax steps): every step stays on the device, so
    a graphed chunk runs it without a host sync.

    Returns ``(vals [k], idx [k], keep [k] bool, spent)``, ``spent`` a 0-d
    float32 tensor, ``budget`` minus what remains."""
    dev = scores.device
    ratio = scores / costs
    rows = torch.arange(scores.shape[0], device=dev)
    avail = unlabeled_mask
    budget_t = torch.full((), budget, dtype=torch.float32, device=dev)
    remaining = budget_t
    neg = torch.full((), NEG_INF, dtype=scores.dtype, device=dev)
    vals, idx, keep = [], [], []
    for _ in range(k):
        cand = avail & (costs <= remaining)
        i = torch.argmax(torch.where(cand, ratio, neg)).view(1)
        ok = cand.index_select(0, i)[0]  # False iff nothing was affordable
        avail = avail & ~((rows == i) & ok)
        remaining = remaining - torch.where(ok, costs.index_select(0, i)[0], 0.0)
        vals.append(torch.where(ok, scores.index_select(0, i)[0], neg))
        idx.append(i[0])
        keep.append(ok)
    vals, idx, keep = torch.stack(vals), torch.stack(idx), torch.stack(keep)
    return vals, torch.where(keep, idx, idx[0]), keep, budget_t - remaining
