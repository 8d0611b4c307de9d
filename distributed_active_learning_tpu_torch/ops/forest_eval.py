"""Kernel-agnostic forest evaluation (the port of ``ops/forest_eval.py``).

The forest's wrapper type selects the implementation, so the kernel choice
is a config knob (``ForestConfig.kernel``), not a code path:
:class:`~.trees_gemm.GemmForest` takes the plain path-matrix form,
:class:`~.trees_pallas.PallasForest` the hand-written leaf kernel, and
:class:`~.trees_pallas.ShardedPallasForest` that kernel once per shard of a
device mesh. The gather form (``PackedForest``) is not ported yet.
"""

from __future__ import annotations

from typing import Union

import torch

from distributed_active_learning_tpu_torch.ops import trees_gemm, trees_pallas

Forest = Union[trees_gemm.GemmForest, trees_pallas.PallasForest, trees_pallas.ShardedPallasForest]

# Deepest forest converted to path-matrix form (the JAX package's limit).
_GEMM_MAX_DEPTH = 10


def _kind(forest) -> str:
    if isinstance(forest, (trees_pallas.PallasForest, trees_pallas.ShardedPallasForest)):
        return "pallas"
    if isinstance(forest, trees_gemm.GemmForest):
        return "gemm"
    raise TypeError(
        f"unsupported forest {type(forest).__name__}: the port evaluates "
        "GemmForest, PallasForest and ShardedPallasForest (the gather form is "
        "not ported yet)"
    )


def leaves(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Per-tree leaf values ``[n, T]``."""
    if _kind(forest) == "pallas":
        return trees_pallas.predict_leaves(forest, x)
    return trees_gemm.predict_leaves_gemm(forest, x)


def proba(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """P(class 1) per point ``[n]``: the mean of per-tree leaf values."""
    if _kind(forest) == "pallas":
        return trees_pallas.predict_proba(forest, x)
    return trees_gemm.predict_proba_gemm(forest, x)


def votes(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Hard positive-vote count per point ``[n]`` int32."""
    if _kind(forest) == "pallas":
        return trees_pallas.predict_votes(forest, x)
    return trees_gemm.predict_votes_gemm(forest, x)


def value(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Regression prediction per point ``[n]`` (mean of leaf values)."""
    return proba(forest, x)
