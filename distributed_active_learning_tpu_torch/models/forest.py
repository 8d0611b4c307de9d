"""The host fit (the port of ``models/forest.py``): scikit-learn fits a
random forest on the labeled rows, and its trees are packed into a
:class:`~..ops.trees.PackedForest` with numpy, the same arrays as the JAX
package's bit for bit. ``ops.forest_eval.for_kernel`` then turns it into the
form the configured kernel evaluates.

scikit-learn is imported only inside these functions, so the rest of the
port runs without it; where it is missing they raise an ``ImportError`` that
names it (a forest fitted elsewhere reaches such a machine as a forest file,
``models/forest_io.py``). Binary forests only: multiclass packing waits for
the multiclass slice, quantized leaves for the quantization slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributed_active_learning_tpu_torch.config import ForestConfig
from distributed_active_learning_tpu_torch.ops.trees import LEAF, PackedForest, predict_proba


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


def _refuse_multiclass(n_classes: int) -> None:
    if n_classes > 2:
        raise NotImplementedError(
            f"a {n_classes}-class host fit needs multiclass packing, which comes with the "
            "multiclass slice (MultiForest)"
        )


def pack_sklearn_forest(model, node_budget: Optional[int] = None,
                        max_depth: Optional[int] = None) -> PackedForest:
    """A fitted scikit-learn forest as dense node tensors (on the CPU).

    A classifier's ``value`` is P(class 1) at each node (class 1's share of
    the node's class weights; a single-class fit holds that class at every
    node); a regressor's is the node mean. Trees are padded with self-looping
    leaves to the largest node count, or to ``node_budget``. The traversal
    depth is ``max(max_depth, 1)`` when given (the config's bound, so shapes
    do not move from fit to fit), else the deepest fitted tree's.
    """
    is_classifier = isinstance(model, require_sklearn().RandomForestClassifier)
    if is_classifier:
        _refuse_multiclass(len(model.classes_))
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
            if counts.shape[1] == 1:  # single-class fit (a small labeled set)
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


def fit_forest_classifier(x: np.ndarray, y: np.ndarray, cfg: ForestConfig,
                          seed: Optional[int] = None,
                          n_classes: Optional[int] = None) -> PackedForest:
    """Fit a random-forest classifier on the labeled rows and pack it
    (``RandomForest.trainClassifier(numTrees, maxDepth, 'gini')`` in the
    reference): ``cfg.n_trees`` trees of depth at most ``cfg.max_depth``,
    ``random_state`` = ``seed`` (default ``cfg.seed``)."""
    y = np.asarray(y)
    if n_classes is None:
        n_classes = int(y.max()) + 1 if y.size else 2
    _refuse_multiclass(n_classes)
    model = require_sklearn().RandomForestClassifier(
        n_estimators=cfg.n_trees,
        max_depth=cfg.max_depth,
        criterion=cfg.criterion,
        random_state=cfg.seed if seed is None else seed,
        n_jobs=-1,
    )
    model.fit(np.asarray(x), y)
    return pack_sklearn_forest(model, node_budget=cfg.resolved_node_budget,
                               max_depth=cfg.max_depth)


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
