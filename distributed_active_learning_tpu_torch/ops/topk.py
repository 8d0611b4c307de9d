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
