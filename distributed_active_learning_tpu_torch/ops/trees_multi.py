"""Multiclass forests: one value plane per class over one tree structure
(the port of ``ops/trees_multi.py``).

A C-class forest is C scalar-valued forests that share their trees, one
plane per class, so every kernel form (gather, gemm, K1) evaluates it plane
by plane unchanged: ``P(y = c | x)`` is the mean leaf value of plane ``c``.
Scoring evaluates the structure C times (K1 launches once a plane).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from distributed_active_learning_tpu_torch.ops import forest_eval
from distributed_active_learning_tpu_torch.ops.xla_f32 import fma_f32, log2_f32


@dataclasses.dataclass(frozen=True)
class MultiForest:
    """A C-class forest: one scalar-value plane (any kernel form) per class,
    every plane the same fitted trees with its own leaf payload."""

    planes: Tuple[object, ...]

    @property
    def n_classes(self) -> int:
        return len(self.planes)

    @property
    def n_trees(self) -> int:
        return self.planes[0].n_trees

    def to(self, device) -> "MultiForest":
        return MultiForest(planes=tuple(p.to(device) for p in self.planes))


def is_multi(forest) -> bool:
    return isinstance(forest, MultiForest)


def proba_multi(mf: MultiForest, x: torch.Tensor) -> torch.Tensor:
    """Class probabilities ``[n, C]``: each plane's mean leaf value."""
    return torch.stack([forest_eval.value(p, x) for p in mf.planes], dim=-1)


def predict_class(mf: MultiForest, x: torch.Tensor) -> torch.Tensor:
    """The most probable class per row ``[n]`` int32 (the first on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(proba_multi(mf, x), dim=-1).to(torch.int32)


def margin_score_multi(probs: torch.Tensor) -> torch.Tensor:
    """Top-2 margin per row ``[n]`` (ascending = least confident first)."""
    top2 = torch.topk(probs, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def entropy_multi(probs: torch.Tensor) -> torch.Tensor:
    """Predictive entropy per row ``[n]`` in bits,
    ``-sum_c p_c log2(p_c + 1e-12)``, as XLA's CPU code computes it: its
    ``log2`` (:func:`~.xla_f32.log2_f32`), and the C terms added from 0 in
    class order with each multiply contracted into its add (one FMA a
    class; bit-equal to the jitted JAX expression at C = 3 to 32)."""
    logs = log2_f32(probs + 1e-12)
    acc = torch.zeros_like(probs[..., 0])
    for c in range(probs.shape[-1]):
        acc = fma_f32(probs[..., c], logs[..., c], acc)
    return -acc
