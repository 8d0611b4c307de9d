"""Kernel-agnostic forest evaluation (the port of ``ops/forest_eval.py``).

The forest's wrapper type selects the implementation, so the kernel choice
is a config knob (``ForestConfig.kernel``), not a code path:
:class:`~.trees.PackedForest` takes the gather traversal,
:class:`~.trees_gemm.GemmForest` the plain path-matrix form,
:class:`~.trees_pallas.PallasForest` the hand-written leaf kernel, and
:class:`~.trees_pallas.ShardedPallasForest` that kernel once per shard of a
device mesh (and a ``parallel.mesh.ShardedForest`` the gemm or gather form
per shard). :func:`for_kernel` turns a packed forest (a host fit's, a
forest file's) into the form a kernel names. A multiclass
:class:`~.trees_multi.MultiForest` is evaluated plane by plane by
``ops/trees_multi.py``; the entry points here take one plane.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from distributed_active_learning_tpu_torch.ops import trees, trees_gemm, trees_pallas
from distributed_active_learning_tpu_torch.parallel.mesh import ShardedForest

Forest = Union[
    trees.PackedForest,
    trees_gemm.GemmForest,
    trees_pallas.PallasForest,
    ShardedForest,
]

# Deepest forest converted to path-matrix form (the JAX package's limit):
# the path tensor is O(T 4^depth), so deeper forests keep the gather form.
_GEMM_MAX_DEPTH = 10


@dataclasses.dataclass(frozen=True)
class EvaluatedForest:
    """A forest together with its per-tree leaf values on one input ``x``.

    :func:`leaves`, :func:`votes` and :func:`proba` of the wrapper on that
    same tensor ``x`` reduce the stored leaves instead of evaluating the
    forest again. Any other input, or any other entry point, raises: a
    wrapper that evaluated again would cost the launch it exists to save,
    and nothing but a launch count would show it. Every
    single-device form defines its votes as ``(leaves > 0.5)`` summed and its
    probability as :func:`~.trees_gemm.tree_mean` of the leaves, so the
    reductions are bit-identical to a fresh evaluation. A round with metrics
    evaluates the pool once this way and both its score and its pool entropy
    read it (:func:`evaluated`).
    """

    forest: object
    x: torch.Tensor
    leaf_values: torch.Tensor

    @property
    def n_trees(self) -> int:
        return self.forest.n_trees


def evaluated(forest: Forest, x: torch.Tensor) -> EvaluatedForest:
    """``forest`` with its leaf values on ``x`` computed once (a
    :class:`~.trees_multi.MultiForest` plane by plane, one evaluation a
    plane); a forest already evaluated on this very ``x`` is returned as it
    is. A mesh's sharded forest keeps the leaves joined on the mesh's first
    device (one evaluation a shard)."""
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest

    if isinstance(forest, MultiForest):
        return MultiForest(planes=tuple(evaluated(p, x) for p in forest.planes))
    if isinstance(forest, EvaluatedForest) and forest.x is x:
        return forest
    return EvaluatedForest(forest, x, leaves(forest, x))


def evaluated_many(forests, x: torch.Tensor) -> list:
    """:func:`evaluated` of each forest over one shared ``x`` (a batched
    round's E fits over its pool, or over its test set).

    :class:`~.trees_pallas.PallasForest` s that share their shape are
    walked together: their heap operands are concatenated along the tree
    axis and K1 runs ONE launch over the stacked forest
    (:func:`~.trees_pallas.predict_leaves_many`; its plain version on the
    CPU), where the JAX package runs its Pallas kernel under ``vmap`` over
    the experiments. Each :class:`EvaluatedForest` holds its own trees'
    rows of that launch, bit for bit what its own launch gives. Forests that
    differ in depth, node count, leaf pitch or payload are refused by name.
    :class:`~.trees_multi.MultiForest` s are stacked plane by plane (one
    launch a plane). On a mesh, :class:`~.trees_pallas.ShardedPallasForest`
    s of one mesh are stacked shard by shard: one launch a (data, model)
    shard over its row block of ``x`` (a row-sharded array), each forest's
    leaves then joined as :func:`~..parallel.kernels.sharded_leaves` joins
    them. The gemm and gather forms (and forests past K1's tile limits) are
    evaluated one by one: no kernel exists there, in the JAX package
    either."""
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest

    forests = list(forests)
    if not forests:
        return []
    if all(isinstance(f, MultiForest) for f in forests):
        n_planes = {f.n_classes for f in forests}
        if len(n_planes) != 1:
            raise ValueError(f"multiclass forests of one batch disagree on the class count: "
                             f"{sorted(n_planes)}")
        planes = [evaluated_many([f.planes[c] for f in forests], x)
                  for c in range(forests[0].n_classes)]
        return [MultiForest(planes=tuple(p[e] for p in planes)) for e in range(len(forests))]
    if all(type(f) is trees_pallas.ShardedPallasForest for f in forests) and len(
            {id(f.mesh) for f in forests}) == 1:
        return _evaluated_many_sharded(forests, x)
    n, d = x.shape
    if all(type(f) is trees_pallas.PallasForest for f in forests) and all(
            trees_pallas.tile_dims(f.gf, n, d) is not None for f in forests):
        return [EvaluatedForest(f, x, lv)
                for f, lv in zip(forests, trees_pallas.predict_leaves_many(forests, x))]
    return [evaluated(f, x) for f in forests]


def _evaluated_many_sharded(forests, x) -> list:
    """:func:`evaluated_many` of sharded pallas forests of one mesh: one
    stacked K1 launch a (data, model) shard (shards past the tile limits
    are evaluated one by one)."""
    from distributed_active_learning_tpu_torch.parallel import kernels as par_kernels
    from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib

    mesh = forests[0].mesh
    xs = mesh_lib.shard_rows(x, mesh, replicate=True)
    grids = [[[None] * len(row) for row in forests[0].shards] for _ in forests]
    for i, (s, row) in enumerate(zip(xs.local_ids, forests[0].shards)):
        for m in range(len(row)):
            xb = xs.block(s, m)
            local = [f.shards[i][m] for f in forests]
            if all(trees_pallas.tile_dims(f.gf, *xb.shape) is not None for f in local):
                leaves_sm = trees_pallas.predict_leaves_many(local, xb)
            else:
                leaves_sm = [leaves(f, xb) for f in local]
            for e, lv in enumerate(leaves_sm):
                grids[e][i][m] = lv
    return [EvaluatedForest(f, x, par_kernels.join_leaf_grid(g, mesh, xs.n_rows))
            for f, g in zip(forests, grids)]


def _cached_leaves(forest, x):
    """The stored leaves when ``forest`` is an :class:`EvaluatedForest` of
    this very ``x``, else ``(None, forest)``."""
    if not isinstance(forest, EvaluatedForest):
        return None, forest
    if x is not forest.x:
        raise ValueError(
            "an EvaluatedForest holds the leaf values of one input tensor and was given "
            "another: pass the very tensor it was evaluated on, or the wrapped forest")
    return forest.leaf_values, forest.forest


def _kind(forest) -> str:
    if isinstance(forest, ShardedForest):
        return "sharded"
    if isinstance(forest, trees_pallas.PallasForest):
        return "pallas"
    if isinstance(forest, trees_gemm.GemmForest):
        return "gemm"
    if isinstance(forest, trees.PackedForest):
        return "gather"
    if isinstance(forest, EvaluatedForest):
        raise TypeError("an EvaluatedForest serves leaves, votes and proba of its own input only")
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest

    if isinstance(forest, MultiForest):
        raise TypeError(
            f"a {forest.n_classes}-class MultiForest is evaluated plane by plane: use "
            "ops.trees_multi (proba_multi, predict_class), or one of its planes")
    raise TypeError(
        f"unsupported forest {type(forest).__name__}: the port evaluates PackedForest, "
        "GemmForest, PallasForest and their sharded forms"
    )


def leaves(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Per-tree leaf values ``[n, T]``."""
    cached, forest = _cached_leaves(forest, x)
    if cached is not None:
        return cached
    kind = _kind(forest)
    if kind == "sharded":
        from distributed_active_learning_tpu_torch.parallel.kernels import sharded_leaves

        return sharded_leaves(forest, x)
    if kind == "pallas":
        return trees_pallas.predict_leaves(forest, x)
    if kind == "gemm":
        return trees_gemm.predict_leaves_gemm(forest, x)
    return trees.predict_leaves(forest, x)


def proba(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """P(class 1) per point ``[n]``: the mean of per-tree leaf values."""
    cached, forest = _cached_leaves(forest, x)
    if cached is not None:
        return trees_gemm.tree_mean(cached)
    kind = _kind(forest)
    if kind == "sharded":
        return trees_gemm.tree_mean(leaves(forest, x))
    if kind == "pallas":
        return trees_pallas.predict_proba(forest, x)
    if kind == "gemm":
        return trees_gemm.predict_proba_gemm(forest, x)
    return trees.predict_proba(forest, x)


def votes(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Hard positive-vote count per point ``[n]`` int32."""
    cached, forest = _cached_leaves(forest, x)
    if cached is not None:
        return (cached > 0.5).sum(dim=1, dtype=torch.int32)
    kind = _kind(forest)
    if kind == "sharded":
        from distributed_active_learning_tpu_torch.parallel.kernels import sharded_votes

        return sharded_votes(forest.mesh)(forest, x)
    if kind == "pallas":
        return trees_pallas.predict_votes(forest, x)
    if kind == "gemm":
        return trees_gemm.predict_votes_gemm(forest, x)
    return trees.predict_votes(forest, x)


def value(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Regression prediction per point ``[n]`` (mean of leaf values)."""
    if isinstance(forest, EvaluatedForest):
        return proba(forest, x)
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
    ``"gather"`` always keeps. A :class:`~.trees_multi.MultiForest` is
    converted plane by plane.
    """
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest

    if isinstance(forest, MultiForest):
        return MultiForest(planes=tuple(for_kernel(p, kernel) for p in forest.planes))
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
