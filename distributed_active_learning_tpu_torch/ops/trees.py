"""The gather form of a forest (the port of ``ops/trees.py``; plain XLA
there, so plain PyTorch here on every device).

A :class:`PackedForest` holds one tensor per node field, shaped ``[T, N]``:
what the host (sklearn) fit packs (``models/forest.py``), what forest files
store (``models/forest_io.py``), and what device fits emit where the
path-matrix form does not serve (``kernel="gather"``, depth > 10). Traversal
is ``max_depth`` steps of gathers over ``[n, T]`` node ids; a leaf is a
fixed point, so trees shallower than ``max_depth`` stop early by standing
still. Features compare in float32 against float32 thresholds (a NaN goes
right), unlike the leaf kernels, which round the feature to bf16 first.
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_active_learning_tpu_torch.ops.trees_gemm import tree_mean

# Feature id marking a leaf node.
LEAF = -1


@dataclasses.dataclass(frozen=True)
class PackedForest:
    """A forest as dense node arrays. ``feature[t, i] == LEAF`` marks a leaf;
    an internal node sends ``x`` left iff ``x[feature] <= threshold``.
    ``value`` is the node's payload (P(class 1), or the regression value) at
    every node. Padding slots are self-looping leaves (``left == right ==
    i``)."""

    feature: torch.Tensor    # [T, N] int32, LEAF for leaves
    threshold: torch.Tensor  # [T, N] float32
    left: torch.Tensor       # [T, N] int32 (or int64)
    right: torch.Tensor      # [T, N] int32 (or int64)
    value: torch.Tensor      # [T, N] float32
    max_depth: int = 32

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.feature.shape[1]

    def to(self, device) -> "PackedForest":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device)
            for f in ("feature", "threshold", "left", "right", "value")})


def predict_leaves(forest: PackedForest, x: torch.Tensor) -> torch.Tensor:
    """Per-tree leaf values ``[n, T]``: ``max_depth`` gather steps from the
    roots (the JAX package's ``_traverse_one``, over every row at once)."""
    n, T = x.shape[0], forest.n_trees
    tree = torch.arange(T, device=x.device)[None, :]
    feature = forest.feature.long()
    nodes = torch.zeros(n, T, dtype=torch.long, device=x.device)
    for _ in range(forest.max_depth):
        feat = feature[tree, nodes]
        go_left = torch.gather(x, 1, feat.clamp_min(0)) <= forest.threshold[tree, nodes]
        nxt = torch.where(go_left, forest.left[tree, nodes], forest.right[tree, nodes]).long()
        nodes = torch.where(feat == LEAF, nodes, nxt)
    return forest.value[tree, nodes]


def predict_proba(forest: PackedForest, x: torch.Tensor) -> torch.Tensor:
    """P(class 1) per row ``[n]``: the tree mean in XLA's summation order."""
    return tree_mean(predict_leaves(forest, x))


def predict_votes(forest: PackedForest, x: torch.Tensor) -> torch.Tensor:
    """Positive-vote count per row ``[n]`` int32: each tree votes its
    majority class."""
    return (predict_leaves(forest, x) > 0.5).sum(dim=1, dtype=torch.int32)


def predict_value(forest: PackedForest, x: torch.Tensor) -> torch.Tensor:
    """Regression prediction per row ``[n]``: the mean of per-tree values."""
    return tree_mean(predict_leaves(forest, x))


def pad_forest(forest: PackedForest, n_nodes: int) -> PackedForest:
    """Every tree's node arrays padded to ``n_nodes`` with self-looping
    leaves."""
    T, N = forest.feature.shape
    if N > n_nodes:
        raise ValueError(f"forest has {N} nodes; budget {n_nodes} too small")
    if N == n_nodes:
        return forest
    pad = n_nodes - N
    idx = torch.arange(N, n_nodes, dtype=forest.left.dtype, device=forest.left.device)

    def fill(t, v):
        return torch.nn.functional.pad(t, (0, pad), value=v)

    return PackedForest(
        feature=fill(forest.feature, LEAF),
        threshold=fill(forest.threshold, 0.0),
        left=torch.cat([forest.left, idx.expand(T, pad)], dim=1),
        right=torch.cat([forest.right, idx.expand(T, pad)], dim=1),
        value=fill(forest.value, 0.0),
        max_depth=forest.max_depth,
    )
