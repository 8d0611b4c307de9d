"""The host fit (the port of ``models/forest.py``): scikit-learn fits a
random forest on the labeled rows, and its trees are packed into a
:class:`~..ops.trees.PackedForest` with numpy, the same arrays as the JAX
package's bit for bit. ``ops.forest_eval.for_kernel`` then turns it into the
form the configured kernel evaluates.

scikit-learn is imported only inside these functions, so the rest of the
port runs without it; where it is missing they raise an ``ImportError`` that
names it (a forest fitted elsewhere reaches such a machine as a forest file,
``models/forest_io.py``). A fit of more than two classes packs one value
plane per class over the one fitted structure (a
:class:`~..ops.trees_multi.MultiForest`).

It also holds the storage formats of quantized forests
(:func:`quantize_leaf_values`, :func:`dequantize_leaf_values`): leaf
probabilities stored as bf16 or on a fixed int8 grid, widened back to f32
where a kernel reads them, never between the fit and the store.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from distributed_active_learning_tpu_torch.config import ForestConfig
from distributed_active_learning_tpu_torch.ops.trees import LEAF, PackedForest, predict_proba

#: Fixed int8 scale of class-probability leaves: ``q = round(p * 127)`` maps
#: [0, 1] onto [0, 127], a worst-case error of 1/254. Only classifier leaves
#: quantize to int8; a regressor's payload (the LAL regressor) is unbounded
#: and stays f32.
INT8_LEAF_SCALE = 127.0

VALID_QUANTIZE_MODES = ("none", "bf16", "int8")

# The int8 rescale, f32(1/127): a multiply by the f32 reciprocal, the JAX
# package's spelling (a division by 127 differs in the last bit).
_INT8_STEP = float(np.float32(1.0 / INT8_LEAF_SCALE))


def require_sklearn():
    """``sklearn.ensemble``, or an ImportError that names scikit-learn."""
    try:
        from sklearn import ensemble
    except ImportError as e:
        raise ImportError(
            "the host fit (ForestConfig.fit='host') needs scikit-learn, which is not "
            "installed here; fit with fit='device', or fit on a machine that has "
            "scikit-learn and bring the forest as a file (models.forest_io.save_forest / "
            "load_forest)"
        ) from e
    return ensemble


def quantize_leaf_values(value: torch.Tensor, mode: str) -> torch.Tensor:
    """Leaf probabilities in their storage format: ``"bf16"`` a cast
    (round to nearest even), ``"int8"`` ``round(v * 127)`` (half to even,
    as ``jnp.round``), ``"none"`` unchanged. Elementwise, so the device fit
    quantizes inside its own pass (and inside a captured chunk)."""
    if mode == "none":
        return value
    if mode == "bf16":
        return value.to(torch.bfloat16)
    if mode == "int8":
        return torch.round(value * INT8_LEAF_SCALE).to(torch.int8)
    raise ValueError(f"unknown quantize mode {mode!r}; one of {VALID_QUANTIZE_MODES}")


def dequantize_leaf_values(value: torch.Tensor) -> torch.Tensor:
    """f32 leaf probabilities from their storage dtype, at the point of use:
    int8 times f32(1/127), bf16 widened (exact), f32 as it is."""
    if value.dtype == torch.int8:
        return value.to(torch.float32) * _INT8_STEP
    if value.dtype == torch.bfloat16:
        return value.to(torch.float32)
    return value


def pack_sklearn_forest(model, node_budget: Optional[int] = None,
                        max_depth: Optional[int] = None,
                        class_plane: Optional[int] = None) -> PackedForest:
    """A fitted scikit-learn forest as dense node tensors (on the CPU).

    A classifier's ``value`` is P(class 1) at each node (class 1's share of
    the node's class weights; a single-class fit holds that class at every
    node), or with ``class_plane`` P(that class) (0 where the fit never saw
    it); a regressor's is the node mean. Trees are padded with self-looping
    leaves to the largest node count, or to ``node_budget``. The traversal
    depth is ``max(max_depth, 1)`` when given (the config's bound, so shapes
    do not move from fit to fit), else the deepest fitted tree's.
    """
    is_classifier = isinstance(model, require_sklearn().RandomForestClassifier)
    estimators = model.estimators_
    n_nodes = max(e.tree_.node_count for e in estimators)
    if node_budget is not None:
        if n_nodes > node_budget:
            raise ValueError(f"fitted trees need {n_nodes} nodes > budget {node_budget}")
        n_nodes = node_budget
    if max_depth is not None:
        depth = max(max_depth, 1)
    else:
        depth = max(int(e.tree_.max_depth) for e in estimators)

    T = len(estimators)
    feature = np.full((T, n_nodes), LEAF, dtype=np.int32)
    threshold = np.zeros((T, n_nodes), dtype=np.float32)
    left = np.tile(np.arange(n_nodes, dtype=np.int32), (T, 1))
    right = left.copy()
    value = np.zeros((T, n_nodes), dtype=np.float32)
    for t, est in enumerate(estimators):
        tr = est.tree_
        m = tr.node_count
        # scikit-learn marks a leaf with children_left == -1; an internal
        # node sends x left iff x[feature] <= threshold, as the traversal.
        leaf_mask = tr.children_left < 0
        feature[t, :m] = np.where(leaf_mask, LEAF, tr.feature)
        threshold[t, :m] = np.where(leaf_mask, 0.0, tr.threshold).astype(np.float32)
        left[t, :m] = np.where(leaf_mask, np.arange(m), tr.children_left)
        right[t, :m] = np.where(leaf_mask, np.arange(m), tr.children_right)
        if is_classifier:
            counts = tr.value[:, 0, :]  # [m, n_classes]
            totals = counts.sum(axis=1)
            if class_plane is not None:
                value[t, :m] = _class_share(model, counts, class_plane)
            elif counts.shape[1] == 1:  # single-class fit (a small labeled set)
                value[t, :m] = float(model.classes_[0])
            else:
                pos_col = int(np.flatnonzero(model.classes_ == 1)[0]) if 1 in model.classes_ else 1
                value[t, :m] = counts[:, pos_col] / np.maximum(totals, 1e-9)
        else:
            value[t, :m] = tr.value[:, 0, 0].astype(np.float32)

    return PackedForest(
        feature=torch.from_numpy(feature),
        threshold=torch.from_numpy(threshold),
        left=torch.from_numpy(left),
        right=torch.from_numpy(right),
        value=torch.from_numpy(value),
        max_depth=depth,
    )


def _class_share(model, counts: np.ndarray, c: int) -> np.ndarray:
    """Class ``c``'s share of each node's class weights, 0 where the fit
    never saw ``c``."""
    cols = np.flatnonzero(model.classes_ == c)
    if not len(cols):
        return np.zeros(counts.shape[0], dtype=np.float32)
    return counts[:, int(cols[0])] / np.maximum(counts.sum(axis=1), 1e-9)


def fit_forest_classifier(x: np.ndarray, y: np.ndarray, cfg: ForestConfig,
                          seed: Optional[int] = None,
                          n_classes: Optional[int] = None):
    """Fit a random-forest classifier on the labeled rows and pack it
    (``RandomForest.trainClassifier(numTrees, maxDepth, 'gini')`` in the
    reference): ``cfg.n_trees`` trees of depth at most ``cfg.max_depth``,
    ``random_state`` = ``seed`` (default ``cfg.seed``). With more than two
    classes (``n_classes``, or inferred from ``y``) the result is a
    :class:`~..ops.trees_multi.MultiForest`: the structure packed once, one
    value plane per class."""
    y = np.asarray(y)
    if n_classes is None:
        n_classes = int(y.max()) + 1 if y.size else 2
    model = require_sklearn().RandomForestClassifier(
        n_estimators=cfg.n_trees,
        max_depth=cfg.max_depth,
        criterion=cfg.criterion,
        random_state=cfg.seed if seed is None else seed,
        n_jobs=-1,
    )
    model.fit(np.asarray(x), y)
    if n_classes <= 2:
        return pack_sklearn_forest(model, node_budget=cfg.resolved_node_budget,
                                   max_depth=cfg.max_depth)
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest

    base = pack_sklearn_forest(model, node_budget=cfg.resolved_node_budget,
                               max_depth=cfg.max_depth, class_plane=0)

    def plane(c: int) -> torch.Tensor:
        value = np.zeros(tuple(base.value.shape), dtype=np.float32)
        for t, est in enumerate(model.estimators_):
            value[t, :est.tree_.node_count] = _class_share(model, est.tree_.value[:, 0, :], c)
        return torch.from_numpy(value)

    return MultiForest(planes=(base, *(dataclasses.replace(base, value=plane(c))
                                       for c in range(1, n_classes))))


def fit_forest_regressor(x: np.ndarray, y: np.ndarray, cfg: ForestConfig,
                         seed: Optional[int] = None) -> PackedForest:
    """Fit a random-forest regressor and pack it (the LAL regressor's form)."""
    model = require_sklearn().RandomForestRegressor(
        n_estimators=cfg.n_trees,
        max_depth=cfg.max_depth,
        random_state=cfg.seed if seed is None else seed,
        n_jobs=-1,
    )
    model.fit(np.asarray(x), np.asarray(y))
    return pack_sklearn_forest(model, node_budget=cfg.resolved_node_budget,
                               max_depth=cfg.max_depth)


def forest_accuracy(forest: PackedForest, x, y) -> float:
    """Test-set accuracy of a packed forest (P(class 1) > 0.5 against
    ``y``), evaluated on the forest's device."""
    xt = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(forest.feature.device)
    pred = (predict_proba(forest, xt) > 0.5).cpu().numpy()
    return float(np.mean(pred.astype(np.int32) == np.asarray(y)))


def synthetic_forest(rng: np.random.Generator, n_trees: int, max_depth: int, n_features: int,
                     leaf_prob: float = 0.25, single_leaf_every: int = 0) -> PackedForest:
    """A random forest in the shapes a scikit-learn fit packs into, made
    without scikit-learn (for checks where it is missing): each tree's nodes
    numbered depth-first with the left subtree first, leaves at every depth
    from 1 to ``max_depth`` (a node above the last level stops with
    probability ``leaf_prob``), every ``single_leaf_every``-th tree a single
    leaf (a single-class fit), node values in [0, 1] with pure 0s and 1s,
    padded to ``2^(max_depth + 1) - 1`` nodes with self-looping leaves."""
    n_nodes = 2 ** (max_depth + 1) - 1
    feature = np.full((n_trees, n_nodes), LEAF, dtype=np.int32)
    threshold = np.zeros((n_trees, n_nodes), dtype=np.float32)
    left = np.tile(np.arange(n_nodes, dtype=np.int32), (n_trees, 1))
    right = left.copy()
    value = np.zeros((n_trees, n_nodes), dtype=np.float32)
    for t in range(n_trees):
        single = single_leaf_every > 0 and t % single_leaf_every == 0
        count = 0

        def grow(depth: int) -> int:
            nonlocal count
            node, count = count, count + 1
            u = rng.random()
            value[t, node] = 0.0 if u < 0.3 else 1.0 if u > 0.7 or single else rng.random()
            if single or depth == max_depth or (depth > 0 and rng.random() < leaf_prob):
                return node
            feature[t, node] = rng.integers(n_features)
            threshold[t, node] = rng.normal()
            left[t, node] = grow(depth + 1)
            right[t, node] = grow(depth + 1)
            return node

        grow(0)
    return PackedForest(*(torch.from_numpy(a) for a in (feature, threshold, left, right, value)),
                        max_depth=max_depth)
