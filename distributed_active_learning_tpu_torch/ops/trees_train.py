"""On-device random-forest training: histogram splits, level-wise (the port
of ``ops/trees_train.py``; plain XLA there, plain PyTorch here).

Every tree is grown complete to ``max_depth`` in heap layout (node ``v``'s
children at ``2v+1``/``2v+2``), so shapes never depend on the data, and the
path-matrix form of the forest is a constant per depth
(:func:`heap_gemm_forest`). Per level, every (tree, node, class, feature,
bin) histogram is one scatter-add of the bootstrap weights; the bin prefix
sums give the left counts of every split candidate; a weighted Gini gain over
a random ``ceil(sqrt(d))`` feature subset picks each node's split (first
index on ties, as ``jnp.argmax``); rows route by a direct gather of their
code at the chosen feature.

Bit-identity with the JAX package rests on three things: the random draws
come from :mod:`..prng` with the same keys; every count is an integer well
inside float32's exact range (so any summation order gives the same bits);
and the floating-point steps after the counts (Gini gains, leaf
probabilities) are the same operations in the same order. The JAX package
evaluates its tree chunks one after another under ``lax.map``; here all
chunks run as one batch, each with its own key, which draws the same bits.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.ops.trees_gemm import GemmForest
from distributed_active_learning_tpu_torch.ops.xla_f32 import fma_f32


@dataclasses.dataclass(frozen=True)
class BinnedPool:
    """Per-feature quantile binning: ``codes <= b  <=>  x <= edges[:, b]``."""

    edges: torch.Tensor  # [d, n_bins - 1] float32
    codes: torch.Tensor  # [n, d] int32


def _quantile_linear(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(x, qs, axis=0)`` with method "linear", written out
    (``torch.quantile`` interpolates with ``lerp``, which rounds differently):
    sort, ``q * (n - 1)``, floor and ceil, then the blend
    ``low * w_low + high * w_high``, which XLA contracts into one FMA."""
    n = x.shape[0]
    s, _ = torch.sort(x, dim=0)
    q = qs * float(n - 1)
    low = torch.floor(q)
    high = torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w
    low_i = torch.clamp(low, 0, n - 1).long()
    high_i = torch.clamp(high, 0, n - 1).long()
    low_v = s[low_i]    # [Q, d]
    high_v = s[high_i]
    return fma_f32(low_v, low_w[:, None].expand_as(low_v), high_v * high_w[:, None])


def make_bins(x: torch.Tensor, n_bins: int = 32, quantize: str = "none") -> BinnedPool:
    """Quantile-bin the pool once per experiment (interior quantiles of a
    float32 ``linspace``).

    ``quantize != "none"`` snaps the edges onto the bf16 grid (round to
    nearest even, as XLA) before the codes are computed: a fitted threshold
    is always a bin edge, so bf16 threshold storage is then lossless and the
    quantized forest's decision paths are those of the f32 forest."""
    x = x.to(torch.float32)
    qs = torch.linspace(0.0, 1.0, n_bins + 1, dtype=torch.float32, device=x.device)[1:-1]
    edges = _quantile_linear(x, qs).T.contiguous()  # [d, n_bins-1]
    if quantize != "none":
        edges = edges.to(torch.bfloat16).to(torch.float32)
    return BinnedPool(edges=edges, codes=code_features(x, edges))


def code_features(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``code = #{edges < x}`` per feature (searchsorted-left), so that
    ``code <= b <=> x <= edges[b]``."""
    codes = torch.searchsorted(edges, x.T.contiguous(), side="left")  # [d, n]
    return codes.T.to(torch.int32).contiguous()


# Poisson(1) CDF, truncated where it saturates f32 (P[w > 12] ~ 1e-13).
_POISSON1_CDF = np.cumsum(
    [np.exp(-1.0) / math.factorial(k) for k in range(13)]
).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _poisson1_cdf(device: torch.device) -> torch.Tensor:
    """The CDF table on ``device``, uploaded once (not per fit: an upload
    from pageable memory cannot be captured into a CUDA graph)."""
    return torch.as_tensor(_POISSON1_CDF, device=device)


def poisson1(key: prng.Key, shape, device=None) -> torch.Tensor:
    """Poisson(1) draws by inverse CDF on one uniform per element (batched
    keys ``[*B, 2]`` give ``[*B, *shape]``)."""
    u = prng.uniform(key, shape, device)
    cdf = _poisson1_cdf(u.device)
    return torch.searchsorted(cdf, u, right=True).to(torch.int32)


def _gini_gain(left: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """Weighted Gini impurity decrease of every split candidate.

    ``left [..., C, S]``: class counts routed left; ``parent [..., C]``: the
    node's class counts. Returns ``[..., S]`` gains scaled by the parent
    weight (same operations, same order as the JAX package).
    """
    right = parent[..., :, None] - left
    wl = left.sum(dim=-2)
    wr = right.sum(dim=-2)
    w = parent.sum(dim=-1)[..., None]

    def _purity(counts, weight):
        return (counts * counts).sum(dim=-2) / torch.clamp_min(weight, 1e-9)

    child = _purity(left, wl) + _purity(right, wr)
    parent_purity = (parent * parent).sum(dim=-1)[..., None] / torch.clamp_min(w, 1e-9)
    return child - parent_purity


def fit_forest_device(
    codes: torch.Tensor,     # [m, d] int — binned rows (the fit window)
    y: torch.Tensor,         # [m] int in [0, n_classes)
    weights: torch.Tensor,   # [m] float32 — 0 for invalid/unlabeled rows
    edges: torch.Tensor,     # [d, n_bins - 1] float32
    key: prng.Key,
    n_trees: int,
    max_depth: int,
    n_bins: int = 32,
    tree_chunk: int = 16,
    n_classes: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train ``n_trees`` complete depth-``max_depth`` trees.

    Returns heap-layout ``(feature [T, I] int32, threshold [T, I] f32,
    value [T, 2^(D+1)-1, C] f32)`` with ``I = 2^D - 1`` internal nodes first.
    """
    m, d = codes.shape
    D, C, B = max_depth, n_classes, n_bins
    dev = codes.device
    if n_bins > 256:
        raise ValueError(f"fit_forest_device supports n_bins <= 256, got {n_bins}")
    n_feat_sub = max(int(np.ceil(np.sqrt(d))), 1)

    n_chunks = -(-n_trees // tree_chunk)
    Tc = tree_chunk
    Tt = n_chunks * Tc
    chunk_keys = prng.split(key, n_chunks)        # [nc, 2]
    sub = prng.split(chunk_keys, 2)               # [nc, 2, 2]
    k_boot, k_feat = sub[:, 0], sub[:, 1]

    # Poisson(1) bootstrap weights, zeroed outside the labeled window; bf16
    # in the JAX package (small integers, exact), reproduced by rounding.
    w_bf = weights.to(torch.bfloat16).to(torch.float32)
    w = poisson1(k_boot, (Tc, m), dev).to(torch.float32).reshape(Tt, m)
    w = (w * w_bf[None, :]).to(torch.bfloat16).to(torch.float32)

    root = torch.zeros(Tt, C, device=dev).index_add_(1, y, w)  # exact integer sums
    values = [root[:, None, :]]                                  # [Tt, 1, C]

    node = torch.zeros(Tt, m, dtype=torch.long, device=dev)     # level-local node
    tree_ids = torch.arange(Tt, device=dev)[:, None]
    feat_bins = (torch.arange(d, device=dev) * B)[None, :] + codes  # [m, d]
    row_ids = torch.arange(m, device=dev)
    n_splits = d * (B - 1)
    feat_out, thr_out = [], []
    for level in range(D):
        J = 1 << level
        # All (tree, node, class, feature, bin) histograms of the level as
        # one scatter-add of the bootstrap weights (integer sums: exact in
        # float32 in any order, so atomics give deterministic bits).
        base = ((tree_ids * J + node) * C + y[None, :]) * (d * B)      # [Tt, m]
        flat = (base[:, :, None] + feat_bins[None]).reshape(-1)
        hist = torch.zeros(Tt * J * C * d * B, device=dev)
        hist.index_add_(0, flat, w[:, :, None].expand(Tt, m, d).reshape(-1))
        hist = hist.reshape(Tt, J, C, d, B)

        parent = values[level]                                         # [Tt, J, C]
        left = torch.cumsum(hist, dim=-1)[..., : B - 1]                # [Tt, J, C, d, B-1]
        gain = _gini_gain(left.reshape(Tt, J, C, n_splits), parent)
        gain = gain.reshape(Tt, J, d, B - 1)
        # Mask features outside each node's random subset of ceil(sqrt(d)).
        k_lvl = prng.fold_in(k_feat, level)
        scores = prng.uniform(k_lvl, (Tc, J, d), dev).reshape(Tt, J, d)
        kth = torch.topk(scores, n_feat_sub, dim=-1).values[..., -1]
        fmask = scores >= kth[..., None]
        gain = torch.where(fmask[..., None], gain, torch.full_like(gain, -math.inf))

        best = torch.argmax(gain.reshape(Tt, J, n_splits), dim=2)      # first max
        bf = best // (B - 1)
        bb = best % (B - 1)
        feat_out.append(bf)
        thr_out.append(edges[bf, bb])

        left_best = torch.gather(
            left.reshape(Tt, J, C, n_splits), 3, best[:, :, None, None].expand(Tt, J, C, 1)
        )[..., 0]
        right_best = parent - left_best
        values.append(torch.stack([left_best, right_best], dim=2).reshape(Tt, 2 * J, C))

        # Route rows: left iff code[row, feature(node)] <= bin(node).
        f_row = torch.gather(bf, 1, node)
        b_row = torch.gather(bb, 1, node)
        code_at = codes[row_ids[None, :], f_row]
        node = 2 * node + (code_at > b_row)

    feature = torch.cat(feat_out, dim=1).to(torch.int32)
    threshold = torch.cat(thr_out, dim=1)
    vals = []
    root_v = values[0] / torch.clamp_min(values[0].sum(-1, keepdim=True), 1e-9)
    vals.append(root_v)
    for level in range(1, D + 1):
        cnt = values[level]
        tot = cnt.sum(-1, keepdim=True)
        v = cnt / torch.clamp_min(tot, 1e-9)
        prev = vals[level - 1]  # each parent twice, as repeat(2, axis=1), with no host sync
        parent_v = prev[:, :, None, :].expand(-1, -1, 2, -1).reshape(prev.shape[0], -1, C)
        vals.append(torch.where(tot > 0, v, parent_v))
    value = torch.cat(vals, dim=1)
    return feature[:n_trees], threshold[:n_trees], value[:n_trees]


@functools.lru_cache(maxsize=None)
def _heap_path_target(depth: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static path matrix ``[I, L]`` (+1/-1/0) and targets ``[L]`` (each
    leaf's left-ancestor count) of the complete depth-``depth`` heap tree."""
    I = (1 << depth) - 1
    L = 1 << depth
    path = np.zeros((I, L), dtype=np.float32)
    target = np.zeros((L,), dtype=np.float32)
    for leaf in range(L):
        node = I + leaf
        while node > 0:
            parent = (node - 1) // 2
            went_left = node == 2 * parent + 1
            path[parent, leaf] = 1.0 if went_left else -1.0
            target[leaf] += float(went_left)
            node = parent
    return path, target


# heap_path_target's constants, one pair per (depth, device).
_heap_constants: dict = {}


def heap_path_target(depth: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_heap_path_target` on ``device``, uploaded once per (depth,
    device) and shared by every forest fitted there."""
    key = (depth, torch.device(device))
    if key not in _heap_constants:
        path_np, target_np = _heap_path_target(depth)
        _heap_constants[key] = (torch.as_tensor(path_np, device=key[1]),
                                torch.as_tensor(target_np, device=key[1]))
    return _heap_constants[key]


def heap_constant(t: torch.Tensor):
    """``(depth, 0)`` when ``t`` is :func:`heap_path_target`'s path matrix
    of its device broadcast over trees, ``(depth, 1)`` for its targets,
    else ``None``: a test of storage that reads no value from the device."""
    if t.ndim < 2 or t.stride(0) != 0:
        return None
    L = t.shape[-1]
    depth = L.bit_length() - 1
    consts = _heap_constants.get((depth, t.device))
    if L != 1 << depth or consts is None:
        return None
    for which, c in enumerate(consts):
        if (t.shape[1:] == c.shape and t.stride()[1:] == c.stride()
                and t.data_ptr() == c.data_ptr()):
            return depth, which
    return None


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``; a broadcast heap constant (:func:`heap_constant`)
    is expanded from ``device``'s own copy, where a copy would make it a
    full tensor that only a check by value could recognize again."""
    hit = heap_constant(t)
    if hit is None:
        return t.to(device)
    depth, which = hit
    return heap_path_target(depth, device)[which].expand(t.shape)


def _scalar_value_planes(value: torch.Tensor):
    """``(C, value)``: a fit's value tensor as scalar planes. Rank 2 is the
    P(class 1) plane already and ``[T, nodes, 2]`` gives its class-1 plane
    (``C`` None); ``[T, nodes, C]`` with C > 2 keeps every plane, one a class
    of a :class:`~.trees_multi.MultiForest`."""
    if value.ndim == 2:
        return None, value
    C = value.shape[-1]
    if C == 2:
        return None, value[..., 1]
    return C, value


def heap_gemm_forest(
    feature: torch.Tensor, threshold: torch.Tensor, value: torch.Tensor, max_depth: int
):
    """Path-matrix form of a device-fit (complete heap) forest: slicing plus
    a constant per depth. A multiclass value tensor gives a
    :class:`~.trees_multi.MultiForest` of one such form a class."""
    C, value = _scalar_value_planes(value)
    if C is not None:
        from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest

        return MultiForest(planes=tuple(
            heap_gemm_forest(feature, threshold, value[..., c], max_depth) for c in range(C)))
    T, I = feature.shape
    L = I + 1
    path, target = heap_path_target(max_depth, feature.device)
    return GemmForest(
        feat_ids=feature,
        thresholds=threshold,
        path=path.expand(T, I, L),
        target=target.expand(T, L),
        value=value[:, I:].to(torch.float32),
    )


def heap_packed_forest(
    feature: torch.Tensor, threshold: torch.Tensor, value: torch.Tensor, max_depth: int
):
    """The gather form (:class:`~.trees.PackedForest`) of a device-fit heap
    forest: ``2I + 1`` nodes, node ``v``'s children at ``2v + 1`` and
    ``2v + 2``, the ``I + 1`` leaves self-looping; ``left``/``right`` are one
    row broadcast over the trees. A multiclass value tensor gives a
    :class:`~.trees_multi.MultiForest` of one such form a class."""
    from distributed_active_learning_tpu_torch.ops.trees import LEAF, PackedForest

    C, value = _scalar_value_planes(value)
    if C is not None:
        from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest

        return MultiForest(planes=tuple(
            heap_packed_forest(feature, threshold, value[..., c], max_depth) for c in range(C)))
    T, I = feature.shape
    n_nodes = 2 * I + 1  # 2^(D+1) - 1
    node = torch.arange(n_nodes, dtype=torch.int32, device=feature.device)
    internal = node < I
    return PackedForest(
        feature=torch.cat([feature, feature.new_full((T, n_nodes - I), LEAF)], dim=1),
        threshold=torch.cat([threshold, threshold.new_zeros((T, n_nodes - I))], dim=1),
        left=torch.where(internal, 2 * node + 1, node).expand(T, n_nodes),
        right=torch.where(internal, 2 * node + 2, node).expand(T, n_nodes),
        value=value.to(torch.float32),
        max_depth=max_depth,
    )


def quantize_forest(forest, mode: str):
    """The forest with quantized storage: ``"bf16"`` stores thresholds and
    leaf values in bfloat16, ``"int8"`` thresholds in bfloat16 and leaf
    probabilities on the fixed int8 grid (``models.forest.INT8_LEAF_SCALE``).
    The evaluation forms widen them where they read them (``trees_gemm``,
    and the kernels K1, K2 and K3 in their own bodies). Elementwise casts,
    so the device fit quantizes inside its own pass.

    Only the path-matrix forms quantize (:class:`GemmForest`, and its pallas
    and multiclass wrappers); bf16 thresholds are lossless only when they are
    bf16-snapped bin edges (``make_bins(quantize=...)``)."""
    from distributed_active_learning_tpu_torch.models.forest import (
        VALID_QUANTIZE_MODES,
        quantize_leaf_values,
    )
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest
    from distributed_active_learning_tpu_torch.ops.trees_pallas import PallasForest

    if mode not in VALID_QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {mode!r}; one of {VALID_QUANTIZE_MODES}")
    if mode == "none":
        return forest
    if isinstance(forest, MultiForest):
        return MultiForest(planes=tuple(quantize_forest(p, mode) for p in forest.planes))
    if isinstance(forest, PallasForest):
        return PallasForest(gf=quantize_forest(forest.gf, mode))
    if not isinstance(forest, GemmForest):
        raise ValueError(
            "quantized storage applies to the path-matrix (gemm/pallas) "
            f"forms only, got {type(forest).__name__}; use kernel='gemm' or "
            "'pallas' with a depth within the path-matrix budget"
        )
    return dataclasses.replace(
        forest,
        thresholds=forest.thresholds.to(torch.bfloat16),
        value=quantize_leaf_values(forest.value, mode),
    )


def gather_fit_window(
    codes: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, budget: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the labeled rows, in index order, into a fixed ``budget``-row
    window (cumsum + scatter, no sort); unfilled slots read row 0 at
    weight 0."""
    n = codes.shape[0]
    dev = codes.device
    pos = torch.cumsum(mask, dim=0, dtype=torch.int32) - 1
    n_labeled = pos[-1] + 1
    slot = torch.where(mask & (pos < budget), pos, torch.full_like(pos, budget))
    idx = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, slot, torch.arange(n, device=dev))
    idx = idx[:budget]
    sel = torch.arange(budget, device=dev) < n_labeled
    return codes[idx], y[idx], sel.to(torch.float32)


def gather_fit_window_sharded(codes, y, masks, budget: int):
    """:func:`gather_fit_window` over a row-sharded pool: ``codes`` and
    ``y`` are ``Sharded``, ``masks`` each data shard's rows that enter the
    fit (labeled and real) on its device, for the shards held here. Each
    shard places its rows at their global window slots (a cumulative count
    offset by the earlier shards' counts, added in shard order) and the
    blocks are joined on the mesh's first device; slots no row fills read
    global row 0 at weight 0. The window equals the single-device window bit
    for bit, and nothing is read back to the host, so a CUDA graph can
    capture it.

    Over processes (``codes.spans_processes``) each rank fills the slots
    of the rows it owns (``codes.spread``: a row held by several ranks,
    whose cells cross or share it, enters from its owner alone, so every row
    enters the window once), its offset starting at the earlier rows'
    counts (one all-gather of the per-row counts, each from its owner); the
    ranks' windows are all-gathered and overlaid in rank order on rank 0's,
    whose unfilled slots read global row 0: every rank gets the same window,
    in global index order, so every rank fits the same forest. COLLECTIVE."""
    dev = codes.device
    c = codes.block(codes.first)[:1].to(dev).expand(budget, -1)
    yy = y.block(y.first)[:1].to(dev).expand(budget)
    offset = torch.zeros((), dtype=torch.int64, device=dev)
    counts = [m.sum(dtype=torch.int64).to(dev) for m in masks]
    rows = codes.local_ids
    spans = codes.spans_processes
    if spans:
        from distributed_active_learning_tpu_torch.parallel.collectives import owner_gather

        sp = codes.spread
        every = torch.stack(owner_gather(counts, sp))
        rows = sp.owned(sp.rank)
        offset = every[:rows.start].sum()
        hit_any = torch.zeros(budget, dtype=torch.bool, device=dev)
    for s in rows:
        m, cnt = masks[s - codes.first], counts[s - codes.first]
        cb, yb = codes.block(s), y.block(s)
        pos = torch.cumsum(m, dim=0, dtype=torch.int32) - 1 + offset.to(m.device)
        slot = torch.where(m & (pos < budget), pos, torch.full_like(pos, budget))
        idx = torch.full((budget + 1,), -1, dtype=torch.int64, device=m.device)
        idx.scatter_(0, slot, torch.arange(m.shape[0], device=m.device))
        idx = idx[:budget]
        hit = (idx >= 0).to(dev)
        safe = torch.clamp_min(idx, 0)
        c = torch.where(hit[:, None], cb[safe].to(dev), c)
        yy = torch.where(hit, yb[safe].to(dev), yy)
        offset = offset + cnt
        if spans:
            hit_any = hit_any | hit
    if spans:
        from distributed_active_learning_tpu_torch.parallel.multihost import all_gather

        offset = every.sum()
        parts = zip(all_gather(c.contiguous()), all_gather(yy.contiguous()),
                    all_gather(hit_any))
        c, yy, _ = next(parts)
        for cr, yr, hr in parts:
            c = torch.where(hr[:, None], cr, c)
            yy = torch.where(hr, yr, yy)
    sel = torch.arange(budget, device=dev) < offset
    return c, yy, sel.to(torch.float32)
