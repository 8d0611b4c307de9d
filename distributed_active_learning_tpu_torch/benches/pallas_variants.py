"""Kernel-variant sweep of the leaf evaluation (the port of the repo's
``benches/pallas_variants.py``): K1's function in two more operand layouts,
each a hand-written CUDA kernel, timed side by side on one forest and pool.

- :func:`predict_leaves_transposed` (``csrc/forest_leaves_transposed.cu``,
  replacing the Pallas ``_kernel_transposed``): the pool streamed
  feature-major (``x^T [d_pad, n_pad]`` bf16), tree-major ``[T, n]`` output,
  a grid of ``bn``-row by ``bt``-tree tiles in either order (``tree_outer``),
  the leaf payload exact f32 (``leaf_f32``) or the sum of its two bf16 planes
  ``hi + lo``, and the ablation stages (``ablate``).
- :func:`predict_leaves_segmented` (``csrc/forest_leaves_segmented.cu``,
  replacing the Pallas ``_kernel_segmented``): node slot ``f * S + r`` holds
  the ``r``-th node of a tree that splits on feature ``f``, so the compare
  reads feature ``slot // S`` and no feature-id array exists; ``hi + lo``
  payload; at most 32 features.

Both kernels walk each tree from the root (``csrc/heap_tiles.cuh``, as K1
does), so on the card they take forests of complete heap trees, the form
every device fit grows, and refuse any other forest with ``ValueError``
before a launch. Beside each kernel stand its plain PyTorch version
(``*_plain``, the path-matrix function, for any forest): what a CPU tensor
gets, and the kernel's oracle on the card; and a mirror of the kernel's own
arithmetic on its packed operands (``walk_*_plain``). A CUDA tensor
launches the kernel or raises.

The JAX script also takes flags that only choose the matrix unit's operand
type or how its products are batched (``int8``, ``batched``, ``blockdiag``,
``leaf_vpu``, ``fv_bf16``, ``main_bf16``, ``relu_hit``, ``bigsel``). They all
compute the same function; a kernel that walks the trees has no such
product, so the port does not take them and its :data:`VARIANTS` keeps one
name per distinct ``(bn, bt, tree_outer, payload, ablate)``.

The forest comes from the port's device fit (``fit_forest_device`` +
``heap_gemm_forest`` on ``--train-rows`` labeled rows): the JAX script fits
with scikit-learn on the host, which the machine with the card does not
have.

Run: ``python -m distributed_active_learning_tpu_torch.benches.pallas_variants
[--pool N] [--variants v0,v1,...] [--device cpu]``. Times are medians of
CUDA-event timings, one measurement per variant per pass (round-robin), so
a drift of the card's clocks over the run falls on every variant alike. A
transposed variant's time includes its on-device packing (the ``x^T``
relayout), as the JAX script's jitted call does; the segmented packing is a
host loop over the forest and is cached, as there.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from distributed_active_learning_tpu_torch import kernels
from distributed_active_learning_tpu_torch.analysis import costs
from distributed_active_learning_tpu_torch.ops import trees_pallas
from distributed_active_learning_tpu_torch.ops.trees_gemm import GemmForest

# Launches of csrc/forest_leaves_transposed.cu and csrc/forest_leaves_segmented.cu,
# counted where each kernel is launched.
transposed_launches = 0
segmented_launches = 0

_BN = 512
_BT = 16
ABLATE = ("full", "sel", "cmp", "main", "eq")
_TGT_PAD = 1.0e6  # a count no leaf reaches: padded trees and leaves never hit
_SEG_FEATURES = 32


def _pad_to(a: torch.Tensor, axis: int, multiple: int, value=0) -> torch.Tensor:
    """Pad ``axis`` of ``a`` up to a multiple of ``multiple`` with ``value``."""
    pad = -a.shape[axis] % multiple
    if pad == 0:
        return a
    widths = [0, 0] * a.ndim
    widths[2 * (a.ndim - 1 - axis) + 1] = pad
    return torch.nn.functional.pad(a, widths, value=value)


def _hi_lo(val: torch.Tensor):
    """f32 leaf values as two bf16 planes: ``val == hi + lo`` to about
    ``2^-17`` relative."""
    hi = val.to(torch.bfloat16)
    lo = (val - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _check_tile(bn: int) -> None:
    """The kernels stage rows 16 bytes at a time: ``bn`` is a multiple of 8."""
    if bn <= 0 or bn % 8:
        raise ValueError(f"the row tile bn must be a positive multiple of 8, got {bn}")


# ---------------------------------------------------------------- transposed
@dataclasses.dataclass(frozen=True)
class TransposedOperands:
    """The transposed kernel's operands (trees padded to ``bt``, rows to
    ``bn``, features to 32): the pool feature-major, the forest as K1's heap
    words, the leaf payload."""

    xT: torch.Tensor      # [d_pad, n_pad] bf16
    nodes: torch.Tensor   # [t_pad, N] int64 heap words (trees_pallas.HeapOperands)
    val_hi: torch.Tensor  # [t_pad, L] f32 (leaf_f32) or bf16
    val_lo: torch.Tensor  # [t_pad, L] bf16 (zeros with leaf_f32)
    n: int
    n_trees: int
    depth: int
    leaf_f32: bool


def _refuse_quantized(gf: GemmForest) -> None:
    """The variants take f32 storage only, as in the JAX package (its
    variant kernels have no quantized payload)."""
    if gf.value.dtype != torch.float32 or gf.thresholds.dtype != torch.float32:
        raise ValueError(
            f"the leaf-eval variants (K5, K6) take f32 forests, not {gf.value.dtype} leaves and "
            f"{gf.thresholds.dtype} thresholds; quantized forests run through K1, K2 and K3")


def _prep_transposed(gf: GemmForest, x: torch.Tensor, bn: int, bt: int,
                     leaf_f32: bool = False) -> TransposedOperands:
    """Device-side packing of the transposed variants: one relayout of the
    pool per call, the forest in K1's heap form padded to the tree tile;
    ``ValueError`` when the forest is not made of complete heap trees."""
    _refuse_quantized(gf)
    heap = trees_pallas.heap_operands(gf)
    xT = _pad_to(_pad_to(x.to(torch.bfloat16), 1, 32), 0, bn).T.contiguous()
    val = _pad_to(gf.value.to(torch.float32), 0, bt)
    if leaf_f32:
        val_hi, val_lo = val.contiguous(), torch.zeros_like(val, dtype=torch.bfloat16)
    else:
        val_hi, val_lo = (t.contiguous() for t in _hi_lo(val))
    return TransposedOperands(
        xT=xT, nodes=_pad_to(heap.nodes, 0, bt).contiguous(), val_hi=val_hi, val_lo=val_lo,
        n=x.shape[0], n_trees=gf.n_trees, depth=heap.depth, leaf_f32=leaf_f32,
    )


def _launch_transposed(p: TransposedOperands, bn: int, bt: int, tree_outer: bool = False,
                       ablate: str = "full") -> torch.Tensor:
    """Launch csrc/forest_leaves_transposed.cu: ``[T, n]`` f32."""
    global transposed_launches
    _check_tile(bn)
    dev = p.xT.device
    tensors = (p.nodes, p.val_hi, p.val_lo)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"every operand must lie on one CUDA device, got {dev}")
    if p.xT.shape[1] % bn or p.nodes.shape[0] % bt:
        raise ValueError("operands were packed for another (bn, bt)")
    out = torch.empty(p.n_trees, p.n, dtype=torch.float32, device=dev)
    lib = kernels.load("forest_leaves_transposed")
    val = p.val_hi.data_ptr() if p.leaf_f32 else None
    hi = None if p.leaf_f32 else p.val_hi.data_ptr()
    with torch.cuda.device(dev):
        err = lib.forest_leaves_transposed(
            p.xT.data_ptr(), p.n, p.xT.shape[1], p.xT.shape[0],
            p.nodes.data_ptr(), val, hi, p.val_lo.data_ptr(),
            p.n_trees, p.depth, p.nodes.shape[1], bn, bt, int(tree_outer),
            int(p.leaf_f32), ABLATE.index(ablate),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check("forest_leaves_transposed", err)
    transposed_launches += 1
    return out


def _walk_payload(ops: trees_pallas.HeapOperands, x: torch.Tensor, hi: torch.Tensor,
                  lo: torch.Tensor) -> torch.Tensor:
    """``[n, T]``: ``hi + lo`` in f32 at the leaf each row reaches in each
    tree of ``ops`` (``trees_pallas.walk_leaf_ids``)."""
    tree = torch.arange(ops.n_trees, device=x.device)
    hi, lo = hi.to(torch.float32), lo.to(torch.float32)
    return torch.cat([hi[tree, leaf] + lo[tree, leaf]
                      for leaf in trees_pallas.walk_leaf_ids(ops, x)])


def walk_transposed_plain(p: TransposedOperands, ablate: str = "full") -> torch.Tensor:
    """The transposed kernel's own arithmetic in plain PyTorch, ``[n, T]``,
    from its packed operands: the heap walk and the payload word (the exact
    f32 value with ``leaf_f32``, else ``hi + lo``), or an ablation stage:
    the root's bf16 feature (``sel``) or compare (``cmp``), the true
    compares on the left spine 0, 1, 3, 7, ... (``main``), whether all of
    them are true (``eq``)."""
    T = p.n_trees
    ops = trees_pallas.HeapOperands(nodes=p.nodes[:T], val=p.val_hi[:T], depth=p.depth)
    x = p.xT[:, : p.n].T
    if ablate == "full" and p.leaf_f32:
        return trees_pallas.walk_leaves_plain(ops, x)
    if ablate == "full":
        return _walk_payload(ops, x, p.val_hi[:T], p.val_lo[:T])
    spine = [(1 << k) - 1 for k in range(p.depth)]
    xv = x.to(torch.float32)[:, ops.feat.long()[:, spine]]  # [n, T, depth]
    c = xv <= ops.thr[:, spine]
    if ablate == "sel":
        return xv[:, :, 0]
    if ablate == "cmp":
        return c[:, :, 0].to(torch.float32)
    count = c.sum(-1).to(torch.float32)
    return count if ablate == "main" else (count == p.depth).to(torch.float32)


def predict_leaves_transposed_plain(gf: GemmForest, x: torch.Tensor, leaf_f32: bool = False,
                                    ablate: str = "full") -> torch.Tensor:
    """The plain PyTorch version of the transposed kernel, ``[n, T]``: bf16
    features compared in f32, dense ancestor counts, hit, and the payload as
    ``hit . hi + hit . lo`` (or the exact f32 value with ``leaf_f32``). An
    ablation stage gives row 0 of its intermediate per tree: the feature of
    node slot 0 (``sel``), its compare (``cmp``), leaf 0's ancestor count
    (``main``) or leaf 0's hit (``eq``). The tiling (``bn``, ``bt``,
    ``tree_outer``) does not enter the function."""
    T, I = gf.feat_ids.shape
    feat = gf.feat_ids.reshape(-1).long()
    thr = gf.thresholds.reshape(-1).to(torch.float32)
    if leaf_f32:
        hi, lo = gf.value.to(torch.float32), torch.zeros_like(gf.value)
    else:
        hi, lo = (t.to(torch.float32) for t in _hi_lo(gf.value.to(torch.float32)))
    out = []
    for xb in torch.split(x, trees_pallas._auto_chunk(gf)):
        fv = xb.to(torch.bfloat16).to(torch.float32)[:, feat]
        if ablate == "sel":
            out.append(fv.reshape(-1, T, I)[:, :, 0])
            continue
        c = (fv <= thr).to(torch.float32).reshape(-1, T, I)
        if ablate == "cmp":
            out.append(c[:, :, 0])
            continue
        s = torch.einsum("nti,til->ntl", c, gf.path)
        if ablate == "main":
            out.append(s[:, :, 0])
            continue
        hit = (s == gf.target[None]).to(torch.float32)
        if ablate == "eq":
            out.append(hit[:, :, 0])
            continue
        out.append(torch.einsum("ntl,tl->nt", hit, hi) + torch.einsum("ntl,tl->nt", hit, lo))
    return torch.cat(out)


def predict_leaves_transposed(gf: GemmForest, x: torch.Tensor, bn: int = _BN, bt: int = _BT,
                              tree_outer: bool = False, leaf_f32: bool = False,
                              ablate: str = "full") -> torch.Tensor:
    """Per-tree leaf values ``[n, T]`` through the transposed layout: the
    CUDA kernel for a CUDA tensor (a forest of complete heap trees, else
    ``ValueError``), its plain version for a CPU tensor."""
    if ablate not in ABLATE:
        raise ValueError(f"ablate must be one of {ABLATE}, got {ablate!r}")
    if trees_pallas.tile_dims(gf, *x.shape) is None:
        raise ValueError("the forest exceeds the kernels' tile limits (depth > 8 or d > 512)")
    with kernels.kernel_work("forest_leaves_transposed", lambda: _variant_cost(gf, x, bn)):
        if x.device.type == "cuda":
            p = _prep_transposed(gf, x, bn, bt, leaf_f32)
            return _launch_transposed(p, bn, bt, tree_outer, ablate).T
        if x.device.type == "cpu":
            return predict_leaves_transposed_plain(gf, x, leaf_f32, ablate)
    raise ValueError(f"unsupported device {x.device}")


def _variant_cost(gf: GemmForest, x: torch.Tensor, bn: int) -> costs.Cost:
    """K5's and K6's declared work: the feature-major bf16 pool as they
    read it (features padded to 32, rows to ``bn``), the forest's heap form,
    ``[T, n]`` f32 leaves."""
    n = x.shape[0]
    xt_bytes = 2 * (-(-x.shape[1] // 32) * 32) * (-(-n // bn) * bn)
    return costs.forest_leaves_variant(xt_bytes, n, gf.n_trees,
                                       gf.value.shape[1].bit_length() - 1)


# ------------------------------------------------------------ segmented
@dataclasses.dataclass(frozen=True)
class SegmentedOperands:
    """The segmented kernel's operands: node (t, feature f, rank r) at slot
    ``f * S + r``; only nodes with a threshold above -inf have a slot."""

    xT: torch.Tensor      # [32, n_pad] bf16
    thr: torch.Tensor     # [t_pad, 32 S] f32, -inf in empty slots
    slot: torch.Tensor    # [t_pad, I] int32: node i's slot, -1 where it has none
    path: torch.Tensor    # [t_pad, L, 32 S] int8 in {-1, 0, +1} (the plain version's)
    tgt: torch.Tensor     # [t_pad, L] f32 (the plain version's)
    val_hi: torch.Tensor  # [t_pad, L] bf16
    val_lo: torch.Tensor  # [t_pad, L] bf16
    n: int
    n_trees: int
    S: int
    depth: int
    not_a_heap: str       # why the kernel refuses the forest; "" for a heap forest


def _prep_segmented(gf: GemmForest, x: torch.Tensor, bn: int, bt: int) -> SegmentedOperands:
    """Feature-segmented slot layout, packed on the host (a Python loop over
    every node of the forest): ``S`` is the most nodes of one tree that share
    a feature, rounded up to 4. The kernel reads the slot of each heap node
    (``slot``); the plain version reads the slots' path matrix."""
    _refuse_quantized(gf)
    n, d = x.shape
    T, I = gf.feat_ids.shape
    L = gf.value.shape[1]
    if d > _SEG_FEATURES:
        raise ValueError(f"the segmented layout takes at most {_SEG_FEATURES} features, got {d}")
    try:
        trees_pallas.heap_depth(gf)
        not_a_heap = ""
    except ValueError as e:
        not_a_heap = str(e)
    feat = gf.feat_ids.cpu().numpy()
    thr_in = gf.thresholds.cpu().numpy()
    path_in = gf.path.cpu().numpy()
    S = 1
    per_tree = []
    for t in range(T):
        ranks: Dict[int, int] = {}
        slots = []
        for i in np.where(thr_in[t] > -np.inf)[0]:
            f = int(feat[t, i])
            r = ranks.get(f, 0)
            ranks[f] = r + 1
            slots.append((i, f, r))
        per_tree.append(slots)
        if ranks:
            S = max(S, max(ranks.values()))
    S = -(-S // 4) * 4
    i_seg = _SEG_FEATURES * S
    t_pad = -(-T // bt) * bt
    thr = np.full((t_pad, i_seg), -np.inf, dtype=np.float32)
    path = np.zeros((t_pad, L, i_seg), dtype=np.int8)
    slot = np.full((t_pad, I), -1, dtype=np.int32)
    for t, slots in enumerate(per_tree):
        for i, f, r in slots:
            k = f * S + r
            thr[t, k] = thr_in[t, i]
            path[t, :, k] = path_in[t, i, :].astype(np.int8)
            slot[t, i] = k
    dev = x.device
    val = _pad_to(gf.value.to(torch.float32), 0, bt)
    hi, lo = _hi_lo(val)
    return SegmentedOperands(
        xT=_pad_to(_pad_to(x.to(torch.bfloat16), 1, _SEG_FEATURES), 0, bn).T.contiguous(),
        thr=torch.from_numpy(thr).to(dev),
        slot=torch.from_numpy(slot).to(dev),
        path=torch.from_numpy(path).to(dev),
        tgt=_pad_to(gf.target.to(torch.float32), 0, bt, value=_TGT_PAD).contiguous(),
        val_hi=hi.contiguous(), val_lo=lo.contiguous(), n=n, n_trees=T, S=S,
        depth=L.bit_length() - 1, not_a_heap=not_a_heap,
    )


def _launch_segmented(p: SegmentedOperands, bn: int, bt: int) -> torch.Tensor:
    """Launch csrc/forest_leaves_segmented.cu: ``[T, n]`` f32."""
    global segmented_launches
    if p.not_a_heap:
        raise ValueError(p.not_a_heap)
    _check_tile(bn)
    dev = p.xT.device
    tensors = (p.thr, p.slot, p.val_hi, p.val_lo)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"every operand must lie on one CUDA device, got {dev}")
    if p.xT.shape[1] % bn or p.thr.shape[0] % bt:
        raise ValueError("operands were packed for another (bn, bt)")
    out = torch.empty(p.n_trees, p.n, dtype=torch.float32, device=dev)
    lib = kernels.load("forest_leaves_segmented")
    with torch.cuda.device(dev):
        err = lib.forest_leaves_segmented(
            p.xT.data_ptr(), p.n, p.xT.shape[1], p.slot.data_ptr(), p.thr.data_ptr(),
            p.val_hi.data_ptr(), p.val_lo.data_ptr(), p.n_trees, p.depth, p.S, bn, bt,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check("forest_leaves_segmented", err)
    segmented_launches += 1
    return out


def _segmented_plain(p: SegmentedOperands, chunk: int = 2048) -> torch.Tensor:
    """The plain PyTorch version on the packed operands, ``[n, T]``: every
    feature row repeated S times against the slot thresholds, the dense
    int8 path product, hit, ``hit . hi + hit . lo``."""
    T = p.n_trees
    thr = p.thr[:T]
    path = p.path[:T].to(torch.float32)
    tgt = p.tgt[:T]
    hi, lo = p.val_hi[:T].to(torch.float32), p.val_lo[:T].to(torch.float32)
    out = []
    for xb in torch.split(p.xT[:, : p.n].T, chunk):
        xr = xb.to(torch.float32).repeat_interleave(p.S, dim=1)       # [c, 32 S]
        c = (xr[:, None, :] <= thr[None]).to(torch.float32)           # [c, T, 32 S]
        s = torch.einsum("nti,tli->ntl", c, path)
        hit = (s == tgt[None]).to(torch.float32)
        out.append(torch.einsum("ntl,tl->nt", hit, hi) + torch.einsum("ntl,tl->nt", hit, lo))
    return torch.cat(out)


def walk_segmented_plain(p: SegmentedOperands) -> torch.Tensor:
    """The segmented kernel's own arithmetic in plain PyTorch, ``[n, T]``,
    from its packed operands (a heap forest): node ``i``'s word is
    ``(slot // S, thr[slot])``, or a NaN threshold (every row goes right)
    where the node has no slot; then the heap walk and ``hi + lo``."""
    T = p.n_trees
    slot = p.slot[:T].long()
    has = slot >= 0
    feat = torch.where(has, slot // p.S, 0)
    thr = torch.where(has, p.thr[:T].gather(1, slot.clamp(min=0)), float("nan"))
    ops = trees_pallas.pack_heap(feat, thr, p.val_hi[:T], p.depth)
    return _walk_payload(ops, p.xT[:, : p.n].T, p.val_hi[:T], p.val_lo[:T])


def predict_leaves_segmented_plain(gf: GemmForest, x: torch.Tensor, bn: int = 2048,
                                   bt: int = 8) -> torch.Tensor:
    """The plain PyTorch version of the segmented kernel, ``[n, T]``."""
    return _segmented_plain(_segmented_operands(gf, x, bn, bt))


# Cache of the host-side packing (seconds of Python per forest), keyed on
# the forest and the pool by identity; each entry keeps both alive, so an
# id is never reused while cached. The sweep's timed calls therefore leave
# the segmented packing out, where the transposed variants include theirs.
_SEG_CACHE: dict = {}


def _segmented_operands(gf: GemmForest, x: torch.Tensor, bn: int, bt: int) -> SegmentedOperands:
    key = (id(gf), id(x), bn, bt)
    if key not in _SEG_CACHE:
        _SEG_CACHE[key] = (gf, x, _prep_segmented(gf, x, bn, bt))
    return _SEG_CACHE[key][2]


def predict_leaves_segmented(gf: GemmForest, x: torch.Tensor, bn: int = 2048,
                             bt: int = 8) -> torch.Tensor:
    """Per-tree leaf values ``[n, T]`` through the segmented layout: the CUDA
    kernel for a CUDA tensor (a forest of complete heap trees, else
    ``ValueError``), its plain version for a CPU tensor."""
    with kernels.kernel_work("forest_leaves_segmented", lambda: _variant_cost(gf, x, bn)):
        p = _segmented_operands(gf, x, bn, bt)
        if x.device.type == "cuda":
            return _launch_segmented(p, bn, bt).T
        if x.device.type == "cpu":
            return _segmented_plain(p)
    raise ValueError(f"unsupported device {x.device}")


# One name per distinct function and tiling, under the JAX script's names.
# Its other names choose only an operand type or a batching of the matrix
# unit's products and collapse onto these: v2, v3, v4 = v1; v6 = v5; v11, w7,
# w10 = v8; w1, w2, w3 = v9; w6 = v7; w9 = v10; w14 = w12.
VARIANTS: Dict[str, Callable] = {
    "v0": lambda gf, x: trees_pallas.predict_leaves_pallas(gf, x),
    "v1": lambda gf, x: predict_leaves_transposed(gf, x),
    "v5": lambda gf, x: predict_leaves_transposed(gf, x, bn=2048),
    "v7": lambda gf, x: predict_leaves_transposed(gf, x, bn=1024, bt=8),
    "v8": lambda gf, x: predict_leaves_transposed(gf, x, bn=2048, bt=8),
    "v9": lambda gf, x: predict_leaves_transposed(gf, x, bn=4096, bt=8),
    "v10": lambda gf, x: predict_leaves_transposed(gf, x, bn=1024, bt=16),
    "a_sel": lambda gf, x: predict_leaves_transposed(gf, x, bn=4096, bt=8, ablate="sel"),
    "a_cmp": lambda gf, x: predict_leaves_transposed(gf, x, bn=4096, bt=8, ablate="cmp"),
    "a_main": lambda gf, x: predict_leaves_transposed(gf, x, bn=4096, bt=8, ablate="main"),
    "a_eq": lambda gf, x: predict_leaves_transposed(gf, x, bn=4096, bt=8, ablate="eq"),
    "w4": lambda gf, x: predict_leaves_transposed(gf, x, bn=8192, bt=8),
    "w5": lambda gf, x: predict_leaves_transposed(gf, x, bn=4096, bt=16),
    "w8": lambda gf, x: predict_leaves_transposed(gf, x, bn=2048, bt=4),
    "w12": lambda gf, x: predict_leaves_transposed(gf, x, bn=2048, bt=8, tree_outer=True),
    "w13": lambda gf, x: predict_leaves_transposed(gf, x, bn=4096, bt=8, tree_outer=True),
    "r1": lambda gf, x: predict_leaves_segmented(gf, x, bn=2048, bt=8),
    "r2": lambda gf, x: predict_leaves_segmented(gf, x, bn=4096, bt=8),
    "r3": lambda gf, x: predict_leaves_segmented(gf, x, bn=1024, bt=8),
    "wf": lambda gf, x: predict_leaves_transposed(gf, x, bn=2048, bt=8, leaf_f32=True),
}
DEFAULT_VARIANTS = "v0,v1,v8,r1,wf"


def fit_bench_forest(train_rows: int, features: int, trees: int, depth: int, device,
                     seed: int = 0, bins: int = 32) -> GemmForest:
    """The sweep's forest: a device fit on ``train_rows`` normal draws
    labeled ``x0 + 0.3 x1 > 0`` (the JAX script's training set)."""
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.ops import trees_train

    rng = np.random.default_rng(seed + 1)
    tx = rng.normal(size=(train_rows, features)).astype(np.float32)
    ty = (tx[:, 0] + 0.3 * tx[:, 1] > 0).astype(np.int32)
    x = torch.from_numpy(tx).to(device)
    binned = trees_train.make_bins(x, bins)
    f, th, v = trees_train.fit_forest_device(
        binned.codes, torch.from_numpy(ty).to(device), torch.ones(train_rows, device=device),
        binned.edges, prng.key(seed), n_trees=trees, max_depth=depth, n_bins=bins)
    return trees_train.heap_gemm_forest(f, th, v, depth)


def time_call(fn: Callable[[], object], device: torch.device) -> float:
    """Seconds of one call: CUDA events around it on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def run_sweep(gf: GemmForest, x: torch.Tensor, names: List[str], iters: int = 10) -> List[dict]:
    """Time the named variants round-robin; one dict per variant with its
    median seconds, scores per second and vote agreement with the first
    variant. A variant that fails raises: nothing is skipped."""
    dev = x.device
    ref: Optional[torch.Tensor] = None
    agree, times = {}, {n: [] for n in names}
    for name in names:
        out = VARIANTS[name](gf, x)  # builds, packs and warms
        if ref is None:
            ref = out
        agree[name] = float(((out > 0.5) == (ref > 0.5)).float().mean())
    for _ in range(iters):
        for name in names:
            times[name].append(time_call(lambda: VARIANTS[name](gf, x), dev))
    rows = []
    for name in names:
        sec = statistics.median(times[name])
        rows.append({"variant": name, "seconds": sec, "scores_per_second": x.shape[0] / sec,
                     "vote_agree": agree[name]})
    return rows


def main(argv=None) -> List[dict]:
    from distributed_active_learning_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description="leaf-eval kernel variants, timed side by side")
    ap.add_argument("--pool", type=int, default=284_807)
    ap.add_argument("--features", type=int, default=30)
    ap.add_argument("--trees", type=int, default=100)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--train-rows", type=int, default=5000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.normal(size=(args.pool, args.features)).astype(np.float32)).to(dev)
    gf = fit_bench_forest(args.train_rows, args.features, args.trees, args.depth, dev, args.seed)
    rows = run_sweep(gf, x, args.variants.split(","), args.iters)
    for r in rows:
        print(f"{r['variant']}: {r['seconds'] * 1e3:8.3f} ms  "
              f"{r['scores_per_second'] / 1e6:7.3f}M scores/s  vote_agree={r['vote_agree']:.6f}")
    return rows


if __name__ == "__main__":
    main()
