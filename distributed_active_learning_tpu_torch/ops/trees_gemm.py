"""Path-matrix forest evaluation in plain PyTorch (the port of
``ops/trees_gemm.py``; plain XLA there, so plain PyTorch here).

``feat_vals = x[:, feat_ids]`` -> ``c = feat_vals <= thresholds`` ->
``s = c . path`` (ancestor-agreement counts) -> ``hit = (s == target)`` ->
``pred = hit . value``. Counts are small integers, exact in float32; the leaf
contraction has one hit per (row, tree), so it is exact too. Rows are
chunked so the ``[chunk, T, I]`` intermediates stay bounded.

A quantized forest (``ops/trees_train.quantize_forest``) keeps its storage
dtypes here and is widened at the point of use: bf16 thresholds before the
compare (exact: they are bf16-snapped bin edges), bf16 or int8 leaf values
inside the leaf contraction (``models.forest.dequantize_leaf_values``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Target of a padded leaf slot: no ancestor count reaches it, so it never hits.
_PAD_TARGET = 1.0e6


@dataclasses.dataclass(frozen=True)
class GemmForest:
    """Forest in path-matrix form: T trees, I internal-node slots, L leaves."""

    feat_ids: torch.Tensor    # [T, I] int32 (0 for padded slots)
    thresholds: torch.Tensor  # [T, I] float32 (bfloat16 when quantized)
    path: torch.Tensor        # [T, I, L] float32 in {-1, 0, +1}
    target: torch.Tensor      # [T, L] float32 — required S value (left-ancestor count)
    value: torch.Tensor       # [T, L] leaf payload (P(class 1)): float32, bfloat16 or int8

    @property
    def n_trees(self) -> int:
        return self.feat_ids.shape[0]

    def to(self, device) -> "GemmForest":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)})


def gemm_forest_from_packed(packed, n_internal: int | None = None,
                            n_leaves: int | None = None) -> GemmForest:
    """The path-matrix form of a :class:`~.trees.PackedForest`, built on the
    host with numpy (the JAX package's function, the same arrays bit for
    bit): each tree's reachable nodes in depth-first order (right subtree
    first), internal nodes in the order they are met, leaves likewise.
    ``n_internal``/``n_leaves`` pad the I/L axes to fixed sizes (default:
    the forest's largest tree); padded leaves carry an unreachable target.
    The result lies on the packed forest's device."""
    from distributed_active_learning_tpu_torch.ops.trees import LEAF

    feature, threshold, left, right, value = (
        getattr(packed, f).cpu().numpy() for f in ("feature", "threshold", "left", "right", "value"))
    T = feature.shape[0]
    per_tree = []
    max_I = max_L = 1
    for t in range(T):
        internal, leaves = [], []
        stack = [(0, [])]  # (node, [(internal index, went left), ...])
        while stack:
            node, path_list = stack.pop()
            if feature[t, node] == LEAF:
                leaves.append((node, path_list))
            else:
                i = len(internal)
                internal.append(node)
                stack.append((int(left[t, node]), path_list + [(i, True)]))
                stack.append((int(right[t, node]), path_list + [(i, False)]))
        per_tree.append((internal, leaves))
        max_I = max(max_I, len(internal))
        max_L = max(max_L, len(leaves))
    if n_internal is not None:
        if max_I > n_internal:
            raise ValueError(f"forest has {max_I} internal nodes > budget {n_internal}")
        max_I = n_internal
    if n_leaves is not None:
        if max_L > n_leaves:
            raise ValueError(f"forest has {max_L} leaves > budget {n_leaves}")
        max_L = n_leaves

    feat_ids = np.zeros((T, max_I), dtype=np.int32)
    thresholds = np.full((T, max_I), -np.inf, dtype=np.float32)
    path = np.zeros((T, max_I, max_L), dtype=np.float32)
    target = np.full((T, max_L), _PAD_TARGET, dtype=np.float32)
    leaf_value = np.zeros((T, max_L), dtype=np.float32)
    for t, (internal, leaves) in enumerate(per_tree):
        for i, node in enumerate(internal):
            feat_ids[t, i] = feature[t, node]
            thresholds[t, i] = threshold[t, node]
        for leaf, (node, path_list) in enumerate(leaves):
            leaf_value[t, leaf] = value[t, node]
            for i, went_left in path_list:
                path[t, i, leaf] = 1.0 if went_left else -1.0
            target[t, leaf] = float(sum(went_left for _, went_left in path_list))

    dev = packed.feature.device
    return GemmForest(*(torch.from_numpy(a).to(dev)
                        for a in (feat_ids, thresholds, path, target, leaf_value)))


def _predict_chunk(gf: GemmForest, x: torch.Tensor) -> torch.Tensor:
    """Leaf values for one pool chunk: ``[chunk, d] -> [chunk, T]``."""
    from distributed_active_learning_tpu_torch.models.forest import dequantize_leaf_values

    T, I = gf.feat_ids.shape
    feat_vals = x.index_select(1, gf.feat_ids.reshape(-1))  # [chunk, T*I]
    c = (feat_vals <= gf.thresholds.reshape(-1).to(torch.float32)).to(torch.float32)
    c = c.reshape(-1, T, I)
    s = torch.einsum("nti,til->ntl", c, gf.path)
    hit = (s == gf.target[None]).to(torch.float32)
    return torch.einsum("ntl,tl->nt", hit, dequantize_leaf_values(gf.value))


def _auto_chunk(gf: GemmForest) -> int:
    """Row chunk bounding the ``[chunk, T, L]`` intermediates near 512M
    elements, a power of two no larger than 8192 (as the JAX package)."""
    T, L = gf.value.shape
    budget = max(512 * 1024 * 1024 // (T * L), 256)
    return min(1 << (budget.bit_length() - 1), 8192)


def predict_leaves_gemm(gf: GemmForest, x: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    """Per-tree leaf values ``[n, T]``, chunked over rows."""
    if chunk is None:
        chunk = _auto_chunk(gf)
    if x.shape[0] <= chunk:
        return _predict_chunk(gf, x)
    return torch.cat([_predict_chunk(gf, xb) for xb in torch.split(x, chunk)])


def tree_mean(leaves: torch.Tensor) -> torch.Tensor:
    """Mean over the tree axis of ``[n, T]`` leaves: the trees summed in the
    order XLA's CPU reduce adds them (``xla_f32.row_sum``: one fixed order,
    so CPU and CUDA give the same bits, and they are the JAX package's),
    divided by T in the JAX package's reciprocal form."""
    from distributed_active_learning_tpu_torch.ops.xla_f32 import div_const, row_sum

    return div_const(row_sum(leaves), leaves.shape[1])


def predict_proba_gemm(gf: GemmForest, x: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    return tree_mean(predict_leaves_gemm(gf, x, chunk))


def predict_votes_gemm(gf: GemmForest, x: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    return (predict_leaves_gemm(gf, x, chunk) > 0.5).sum(dim=1, dtype=torch.int32)
