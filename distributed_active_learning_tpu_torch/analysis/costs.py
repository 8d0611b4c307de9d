"""The work each kernel of the port declares: operations and bytes, from the
shapes its wrapper is given.

Bytes count each input byte read once and each output byte written once,
whatever the kernel reads again (the rule of PERF.md's bound column).
Operations are the least work of the function: for the tree walks one
compare a level of a row's root-to-leaf path in each tree (and one vote
add a tree for K2 and K3); for K7 the threefry hash's integer operations a
draw. Each function returns ``(flops, bytes)``; the wrappers hand it to
``kernels.kernel_work`` where they launch, and a counting mode adds it in
place of whatever computes the kernel's function (``analysis.roofline``).

The forests are in the walking kernels' heap form
(``ops.trees_pallas.HeapOperands``): 8-byte node words, ``max(2^depth, 2)``
a tree, and ``2^depth`` leaf values a tree in the storage dtype, padded to
whole 16-byte pieces.
"""

from __future__ import annotations

from typing import Sequence, Tuple

Cost = Tuple[float, float]

#: Integer operations of one threefry-2x32 uniform draw (K7), and of one
#: Gumbel-max candidate of a categorical draw (the uniform, its log-log and
#: the running max).
THREEFRY_OPS_UNIFORM = 123
THREEFRY_OPS_GUMBEL = THREEFRY_OPS_UNIFORM + 60

_ROUND_TILE_ROWS = 128  # ops.round_fused.TILE_ROWS: K2 writes k candidates a tile


def heap_bytes(n_trees: int, depth: int, val_itemsize: int = 4) -> int:
    """Bytes of a heap forest: the node words and the padded leaf payload."""
    leaves = 1 << depth
    per16 = 16 // val_itemsize
    padded = -(-leaves // per16) * per16
    return n_trees * (8 * max(leaves, 2) + padded * val_itemsize)


def forest_leaves(n: int, d: int, n_trees: int, depth: int, val_itemsize: int = 4) -> Cost:
    """K1 (``csrc/forest_leaves.cu``): ``[n, d]`` f32 rows through a heap
    forest to ``[T, n]`` f32 leaf values."""
    nbytes = 4 * n * d + heap_bytes(n_trees, depth, val_itemsize) + 4 * n_trees * n
    return float(n * n_trees * depth), float(nbytes)


def round_megakernel(n: int, d: int, n_trees: int, depth: int, k: int,
                     val_itemsize: int = 4) -> Cost:
    """K2 (``csrc/round_megakernel.cu``): votes, the score table and the
    mask to each 128-row tile's top-k candidates (f32 value, int32 index)."""
    tiles = -(-n // _ROUND_TILE_ROWS)
    nbytes = (4 * n * d + heap_bytes(n_trees, depth, val_itemsize) + n + 4 * (n_trees + 1)
              + tiles * min(k, _ROUND_TILE_ROWS) * 8)
    return float(n * n_trees * (depth + 1)), float(nbytes)


def fused_votes(n: int, d: int, n_trees: int, depth: int, val_itemsize: int = 4) -> Cost:
    """K3 (``csrc/fused_votes.cu``): ``[n]`` int32 hard votes."""
    nbytes = 4 * n * d + heap_bytes(n_trees, depth, val_itemsize) + 4 * n
    return float(n * n_trees * (depth + 1)), float(nbytes)


def ring_step(window_rows: Sequence[int]) -> Cost:
    """K4 (``csrc/ring_hop.cu``): each ``k``-row window (f32 values, int32
    indices) read once and written once into its receiving buffers."""
    return 0.0, float(sum(2 * 8 * k for k in window_rows))


def forest_leaves_variant(xt_bytes: int, n: int, n_trees: int, depth: int) -> Cost:
    """K5 and K6 (``csrc/forest_leaves_transposed.cu``,
    ``csrc/forest_leaves_segmented.cu``): the feature-major bf16 pool
    ``x^T`` (``xt_bytes``), the forest once in its f32 heap form, ``[T, n]``
    f32 leaf values."""
    nbytes = xt_bytes + heap_bytes(n_trees, depth) + 4 * n_trees * n
    return float(n * n_trees * depth), float(nbytes)


def threefry_uniform(numel: int) -> Cost:
    """K7's uniform: one key (16 bytes) to ``numel`` f32 draws."""
    return float(THREEFRY_OPS_UNIFORM * numel), float(16 + 4 * numel)


def threefry_categorical(rows: int, n: int, per_row_logits: bool) -> Cost:
    """K7's Gumbel-max categorical: ``rows`` draws over ``n`` f32 logits
    (shared, or one row of logits a draw) to ``[rows]`` int32."""
    logits = n * (rows if per_row_logits else 1)
    return float(THREEFRY_OPS_GUMBEL * rows * n), float(16 + 4 * logits + 4 * rows)
