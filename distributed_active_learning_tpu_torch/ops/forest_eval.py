"""Kernel-agnostic forest evaluation (the port of ``ops/forest_eval.py``).

The forest's wrapper type selects the implementation, so the kernel choice
is a config knob (``ForestConfig.kernel``), not a code path:
:class:`~.trees.PackedForest` takes the gather traversal,
:class:`~.trees_gemm.GemmForest` the plain path-matrix form,
:class:`~.trees_pallas.PallasForest` the hand-written leaf kernel, and
:class:`~.trees_pallas.ShardedPallasForest` that kernel once per shard of a
device mesh. :func:`for_kernel` turns a packed forest (a host fit's, a
forest file's) into the form a kernel names.
"""

from __future__ import annotations

from typing import Union

import torch

from distributed_active_learning_tpu_torch.ops import trees, trees_gemm, trees_pallas

Forest = Union[
    trees.PackedForest,
    trees_gemm.GemmForest,
    trees_pallas.PallasForest,
    trees_pallas.ShardedPallasForest,
]

# Deepest forest converted to path-matrix form (the JAX package's limit):
# the path tensor is O(T 4^depth), so deeper forests keep the gather form.
_GEMM_MAX_DEPTH = 10


def _kind(forest) -> str:
    if isinstance(forest, (trees_pallas.PallasForest, trees_pallas.ShardedPallasForest)):
        return "pallas"
    if isinstance(forest, trees_gemm.GemmForest):
        return "gemm"
    if isinstance(forest, trees.PackedForest):
        return "gather"
    raise TypeError(
        f"unsupported forest {type(forest).__name__}: the port evaluates PackedForest, "
        "GemmForest, PallasForest and ShardedPallasForest"
    )


def leaves(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Per-tree leaf values ``[n, T]``."""
    kind = _kind(forest)
    if kind == "pallas":
        return trees_pallas.predict_leaves(forest, x)
    if kind == "gemm":
        return trees_gemm.predict_leaves_gemm(forest, x)
    return trees.predict_leaves(forest, x)


def proba(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """P(class 1) per point ``[n]``: the mean of per-tree leaf values."""
    kind = _kind(forest)
    if kind == "pallas":
        return trees_pallas.predict_proba(forest, x)
    if kind == "gemm":
        return trees_gemm.predict_proba_gemm(forest, x)
    return trees.predict_proba(forest, x)


def votes(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Hard positive-vote count per point ``[n]`` int32."""
    kind = _kind(forest)
    if kind == "pallas":
        return trees_pallas.predict_votes(forest, x)
    if kind == "gemm":
        return trees_gemm.predict_votes_gemm(forest, x)
    return trees.predict_votes(forest, x)


def value(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Regression prediction per point ``[n]`` (mean of leaf values)."""
    if _kind(forest) == "gather":
        return trees.predict_value(forest, x)
    return proba(forest, x)


def for_kernel(forest: trees.PackedForest, kernel: str) -> Forest:
    """A packed forest in the form ``kernel`` names, on its device.

    ``"gemm"`` builds the path-matrix form with depth-derived budgets
    (``2^D - 1`` internal slots, ``2^D`` leaves), so every refit has the same
    shapes; ``"pallas"`` wraps that form for the leaf kernel together with
    the trees packed as complete heaps of depth D, the form the kernel
    walks (:func:`~.trees_pallas.heap_from_packed`; only where the kernel
    takes the depth, D <= 8: deeper forests take the gemm form there, as in
    the JAX package). Past depth 10 both keep the gather form, which
    ``"gather"`` always keeps.
    """
    if kernel == "gather":
        return forest
    if kernel not in ("gemm", "pallas"):
        raise ValueError(f"unknown forest kernel {kernel!r}; use 'gemm', 'pallas', or 'gather'")
    d = forest.max_depth
    if d > _GEMM_MAX_DEPTH:
        return forest
    gf = trees_gemm.gemm_forest_from_packed(forest, n_internal=2**d - 1, n_leaves=2**d)
    if kernel == "gemm":
        return gf
    fits_kernel = (2**d - 1) <= trees_pallas._MAX_I_PAD
    return trees_pallas.PallasForest(
        gf=gf, prepacked=trees_pallas.heap_from_packed(forest) if fits_kernel else None)
