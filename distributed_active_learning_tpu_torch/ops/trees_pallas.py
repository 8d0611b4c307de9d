"""Per-tree leaf values through the hand-written Hopper kernel
(``csrc/forest_leaves.cu``): the port of ``ops/trees_pallas.py``, whose
Pallas ``_kernel`` it replaces. ``ForestConfig.kernel="pallas"`` keeps its
name and selects this module.

The kernel walks each tree from the root (``csrc/heap_walk.cuh``), so it
takes complete heap trees, the form every device fit grows: the forest's
heap form (:class:`HeapOperands`) is built once per forest and shared with
the vote kernels K2 and K3 (``ops/round_fused.py``), which walk the same
trees, and a path matrix of another shape is refused on the card. On a heap
tree the walk is the path-matrix function exactly. The path-matrix operands
(:class:`KernelOperands`) stay for the layout variant K5, which counts
ancestors (``benches/pallas_variants.py``).

Numerics are those of the TPU kernel: each node slot's feature is rounded to
bf16 and compared in f32 against its f32 threshold. A vote can differ from
the exact f32 compare of ``ops/trees_gemm.py`` only where a feature lies
within bf16 rounding of a threshold; each form is held against its own
reference.

Routes, each with its own counter:

- a CUDA tensor within the kernel's tile limits launches the kernel
  (``launches``), or raises (a forest that is not a heap raises
  ``ValueError``);
- a CPU tensor takes the plain PyTorch version of the same function
  (:func:`predict_leaves_plain`, the bf16-compare dense-count form);
- a forest past the limits (depth > 8, or more than 512 features) takes the
  exact gemm form (``gemm_route_calls``), the same boundary as the JAX
  package's. That route compares in f32, so it is a named branch, not a
  silent fallback: no configuration of the main path (depth 8, d = 30)
  reaches it.

On a device mesh a :class:`ShardedPallasForest` launches the kernel once per
(data, model) shard, each on its own device (:func:`_predict_leaves_sharded`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from distributed_active_learning_tpu_torch import kernels
from distributed_active_learning_tpu_torch.ops.trees_gemm import (
    GemmForest,
    _auto_chunk,
    predict_leaves_gemm,
    tree_mean,
)
from distributed_active_learning_tpu_torch.ops.trees_train import heap_constant, heap_path_target

# Launches of csrc/forest_leaves.cu, counted where the kernel is launched.
launches = 0
# Calls routed to the gemm form because the forest exceeds the tile limits.
gemm_route_calls = 0


@dataclasses.dataclass(frozen=True)
class PallasForest:
    """Marker wrapper selecting the hand-written leaf kernels: the same
    path-matrix data as :class:`GemmForest`; the wrapper type is what
    ``ops.forest_eval`` dispatches on. The kernels' heap form (K1, K2 and
    K3 walk it) is built at their first launch and kept, so the round's
    launches (score or megakernel, then test accuracy) pack and check the
    forest once."""

    gf: GemmForest

    @property
    def n_trees(self) -> int:
        return self.gf.n_trees

    @functools.cached_property
    def heap(self) -> "HeapOperands":
        return heap_operands(self.gf)


@dataclasses.dataclass(frozen=True)
class ShardedPallasForest:
    """Mesh-aware twin of :class:`PallasForest`: ``shards[s][m]`` is model
    shard ``m``'s trees on ``mesh.devices[s][m]`` (``parallel.mesh.
    shard_forest``), and evaluation launches the kernel per shard on the
    shard's row block, as the JAX package's ``shard_map`` does."""

    shards: tuple
    mesh: object

    @property
    def n_trees(self) -> int:
        return sum(f.n_trees for f in self.shards[0])


def attach_mesh(forest, mesh):
    """Wrap pallas forests for per-shard evaluation on ``mesh``: a
    ``[data][model]`` grid from ``parallel.mesh.shard_forest``, a global
    :class:`PallasForest` (sharded here), or a :class:`ShardedPallasForest`
    (re-wrapped); other forests pass through untouched."""
    from distributed_active_learning_tpu_torch.parallel.mesh import shard_forest

    if isinstance(forest, ShardedPallasForest):
        return ShardedPallasForest(shards=forest.shards, mesh=mesh)
    if isinstance(forest, PallasForest):
        forest = shard_forest(forest, mesh)
    if isinstance(forest, tuple) and isinstance(forest[0][0], PallasForest):
        return ShardedPallasForest(shards=forest, mesh=mesh)
    return forest


# The JAX package's tile limits, kept so both packages route the same
# forests to the gemm form.
_BT = 8
_MAX_I_PAD = 256
_MAX_D_PAD = 512


def tile_dims(gf: GemmForest, n: int, d: int):
    """The JAX kernel's padded tile dimensions ``(i_pad, l_pad, d_pad, bn)``,
    or ``None`` past its tiling budget (depth > 8 or d_pad > 512), where
    evaluation takes the gemm form."""
    T, I = gf.feat_ids.shape
    L = gf.value.shape[1]
    i_pad = max(-(-I // 128) * 128, 128)
    l_pad = max(-(-L // 128) * 128, 128)
    d_pad = max(-(-d // 128) * 128, 128)
    if i_pad > _MAX_I_PAD or d_pad > _MAX_D_PAD:
        return None
    bn = 2048 if n >= 1536 else 512
    return i_pad, l_pad, d_pad, bn


@dataclasses.dataclass(frozen=True)
class KernelOperands:
    """The forest in the path-matrix layout of csrc/forest_eval.cuh (K5)."""

    feat: torch.Tensor   # [T, i_pad] int32, padded slots select feature 0...
    thr: torch.Tensor    # [T, i_pad] f32, ...and compare False (-inf)
    plus: torch.Tensor   # [T, L, i_pad // 32] int32 bits of path == +1
    minus: torch.Tensor  # [T, L, i_pad // 32] int32 bits of path == -1
    tgt: torch.Tensor    # [T, L] f32
    val: torch.Tensor    # [T, L] f32

    @property
    def i_pad(self) -> int:
        return self.feat.shape[1]

    @property
    def n_leaves(self) -> int:
        return self.tgt.shape[1]

    @property
    def tensors(self):
        return (self.feat, self.thr, self.plus, self.minus, self.tgt, self.val)


def _bits(cols: torch.Tensor) -> torch.Tensor:
    """``[..., L, i_pad]`` booleans -> ``[..., L, i_pad // 32]`` int32 words
    (bit b of word w is node slot 32 w + b)."""
    *lead, L, i_pad = cols.shape
    shifts = torch.arange(32, device=cols.device, dtype=torch.int64)
    words = (cols.reshape(*lead, L, i_pad // 32, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _path_masks(src: torch.Tensor, i_pad: int):
    """Plus and minus bit masks ``[T', L, i_pad // 32]`` of path matrices
    ``[T', I, L]``; raises unless every entry is -1, 0 or +1 (the masks are
    exact only then; the check reads one boolean back from the device)."""
    if not bool(((src == 1) | (src == 0) | (src == -1)).all()):
        raise ValueError("path matrix entries must be -1, 0 or +1")
    cols = torch.nn.functional.pad(src.transpose(1, 2), (0, i_pad - src.shape[1]))
    return _bits(cols == 1).contiguous(), _bits(cols == -1).contiguous()


# Masks of broadcast (heap) path matrices, keyed by the matrix's storage: a
# device-fit forest's path is one constant per (depth, device), so it is
# checked and packed once, not once per fit (the check syncs with the
# device). Each entry holds its matrix, so a key is never reused.
_shared_masks: dict = {}


def forest_operands(gf: GemmForest) -> KernelOperands:
    """Pad and pack a path-matrix forest for K5: node slots padded
    to a multiple of 32, each leaf column of the path matrix as a plus and a
    minus bit mask. A device-fit forest's path is one constant broadcast
    over trees: checked and packed at its first use and kept."""
    T, I = gf.feat_ids.shape
    i_pad = -(-I // 32) * 32
    path = gf.path
    if path.stride(0) == 0:  # heap forests: one matrix, broadcast
        key = (path.data_ptr(), tuple(path.shape[1:]), path.device)
        if key not in _shared_masks:
            _shared_masks[key] = (path, *_path_masks(path[:1], i_pad))
        _, plus, minus = _shared_masks[key]
        plus, minus = plus.expand(T, -1, -1), minus.expand(T, -1, -1)
    else:
        plus, minus = _path_masks(path, i_pad)
    pad = (0, i_pad - I)
    return KernelOperands(
        feat=torch.nn.functional.pad(gf.feat_ids.to(torch.int32), pad).contiguous(),
        thr=torch.nn.functional.pad(gf.thresholds.to(torch.float32), pad, value=float("-inf")).contiguous(),
        plus=plus.contiguous(),
        minus=minus.contiguous(),
        tgt=gf.target.to(torch.float32).contiguous(),
        val=gf.value.to(torch.float32).contiguous(),
    )


@dataclasses.dataclass(frozen=True)
class HeapOperands:
    """A complete heap forest in the walking kernels' layout (K1, K2 and K3;
    csrc/heap_walk.cuh): node
    ``v`` of tree ``t`` is the 8-byte word ``nodes[t, v] = (feature id,
    threshold bits)``, children at ``2v + 1`` and ``2v + 2``; leaf ``l``'s
    value is ``val[t, l]``. Feature ids fit 16 bits (``d <= 512``) and are
    kept in the word's 32-bit half. The trailing slots (node ``2^depth - 1``
    at every depth, leaves padded to a multiple of 4) keep each tree's
    arrays whole 16-byte pieces for the kernel's asynchronous copies and are
    never read."""

    nodes: torch.Tensor  # [T, N] int64 words: N = max(2^depth, 2)
    val: torch.Tensor    # [T, Lp] f32: Lp = 2^depth rounded up to 4
    depth: int

    @property
    def n_trees(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_internal(self) -> int:
        return (1 << self.depth) - 1

    @property
    def feat(self) -> torch.Tensor:
        """``[T, I]`` int32 feature ids."""
        return self.nodes.view(torch.int32)[:, 0:2 * self.n_internal:2]

    @property
    def thr(self) -> torch.Tensor:
        """``[T, I]`` f32 thresholds."""
        return self.nodes.view(torch.int32)[:, 1:2 * self.n_internal:2].view(torch.float32)

    @property
    def tensors(self):
        return (self.nodes, self.val)


def _not_a_heap(why: str) -> ValueError:
    return ValueError(
        f"The forest kernels on the card (K1, K2, K3) walk complete heap trees, and this "
        f"forest is not one ({why}). "
        "The device fit grows heap trees; forests of another shape come from the host fit, "
        "which is not ported yet: the host-fit slice packs its trees into heaps for the walk."
    )


def heap_operands(gf: GemmForest) -> HeapOperands:
    """The heap form of a path-matrix forest, or ``ValueError`` when the
    forest is not made of complete heap trees. A device-fit forest's path
    and targets are broadcasts of ``heap_path_target``'s constant, which is
    recognized from storage alone (no host sync: the test runs inside a
    captured chunk); any other path matrix is compared with that constant
    by value, which reads one boolean back from the device."""
    T, I = gf.feat_ids.shape
    L = gf.value.shape[1]
    depth = L.bit_length() - 1
    if L != 1 << depth or I != L - 1:
        raise _not_a_heap(f"{I} nodes and {L} leaves a tree")
    if tuple(gf.path.shape) != (T, I, L) or tuple(gf.target.shape) != (T, L):
        raise _not_a_heap(f"path {tuple(gf.path.shape)}, targets {tuple(gf.target.shape)}")
    if heap_constant(gf.path) != (depth, 0) or heap_constant(gf.target) != (depth, 1):
        path, target = heap_path_target(depth, gf.path.device)
        if not (torch.equal(gf.path, path.expand_as(gf.path))
                and torch.equal(gf.target, target.expand_as(gf.target))):
            raise _not_a_heap("its path matrix is not the heap constant of its depth")
    N = max(L, 2)
    words = torch.zeros(T, N, 2, dtype=torch.int32, device=gf.feat_ids.device)
    words[:, :I, 0] = gf.feat_ids.to(torch.int32)
    words[:, :I, 1] = gf.thresholds.to(torch.float32).view(torch.int32)
    Lp = -(-L // 4) * 4
    return HeapOperands(
        nodes=words.view(torch.int64).reshape(T, N),
        val=torch.nn.functional.pad(gf.value.to(torch.float32), (0, Lp - L)).contiguous(),
        depth=depth,
    )


def walk_leaf_ids(ops: HeapOperands, x: torch.Tensor, thr=None):
    """The walk of csrc/heap_walk.cuh in plain PyTorch, over row chunks:
    yields ``[rows, T]`` int64 leaf indices, reached by ``depth`` rounds of
    gathers from the heap operands, features rounded to bf16 and compared
    ``<=`` in f32 (a NaN goes right) with the ``[T, I]`` thresholds ``thr``
    (the operands' own by default)."""
    T = ops.n_trees
    feat, thr = ops.feat.long(), (ops.thr if thr is None else thr)
    tree = torch.arange(T, device=x.device)
    for xb in torch.split(x, 1 << 14):
        xf = xb.to(torch.bfloat16).to(torch.float32)
        v = torch.zeros(xb.shape[0], T, dtype=torch.int64, device=x.device)
        for _ in range(ops.depth):
            xv = torch.gather(xf, 1, feat[tree, v])
            v = 2 * v + 1 + (~(xv <= thr[tree, v])).long()
        yield v - ops.n_internal


def walk_leaves_plain(ops: HeapOperands, x: torch.Tensor) -> torch.Tensor:
    """K1's arithmetic in plain PyTorch: ``[n, T]`` leaf values at the
    leaves :func:`walk_leaf_ids` reaches."""
    tree = torch.arange(ops.n_trees, device=x.device)
    return torch.cat([ops.val[tree, leaf] for leaf in walk_leaf_ids(ops, x)])


def predict_leaves_plain(gf: GemmForest, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``[n, T]`` leaf values from
    bf16-rounded features compared in f32, dense ancestor counts
    ``c . path`` (small integers, exact in f32), ``hit = (count ==
    target)``, ``hit . value`` — chunked over rows like the gemm form."""
    T, I = gf.feat_ids.shape
    feat = gf.feat_ids.reshape(-1).long()
    thr = gf.thresholds.reshape(-1).to(torch.float32)
    out = []
    for xb in torch.split(x, _auto_chunk(gf)):
        fv = xb.to(torch.bfloat16).to(torch.float32)[:, feat]
        c = (fv <= thr).to(torch.float32).reshape(-1, T, I)
        s = torch.einsum("nti,til->ntl", c, gf.path)
        hit = (s == gf.target[None]).to(torch.float32)
        out.append(torch.einsum("ntl,tl->nt", hit, gf.value))
    return torch.cat(out)


def _check_x(x: torch.Tensor, ops, *others: torch.Tensor) -> torch.Tensor:
    """Refuse what the kernels do not take: x must be ``[n, d]`` float32 and
    every operand must lie on x's device (a pointer to another device's
    memory would fault inside the kernel)."""
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"x must be a [n, d] float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] > _MAX_D_PAD:
        raise ValueError(f"the kernels take at most {_MAX_D_PAD} features, got {x.shape[1]}")
    if any(t.device != x.device for t in (*ops.tensors, *others)):
        raise ValueError(f"forest operands must lie on {x.device} with x")
    return x.contiguous()


def _launch_leaves(ops: HeapOperands, x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/forest_leaves.cu: ``[T, n]`` f32 leaf values."""
    global launches
    x = _check_x(x, ops)
    n, d = x.shape
    out = torch.empty(ops.n_trees, n, dtype=torch.float32, device=x.device)
    lib = kernels.load("forest_leaves")
    with torch.cuda.device(x.device):
        err = lib.forest_leaves(
            x.data_ptr(), n, d, ops.nodes.data_ptr(), ops.val.data_ptr(), ops.n_trees, ops.depth,
            ops.nodes.shape[1], ops.val.shape[1], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check("forest_leaves", err)
    launches += 1
    return out


def leaves_launch_config(ops: HeapOperands, n: int, d: int, device) -> dict:
    """The configuration csrc/forest_leaves.cu launches with for ``n`` rows
    of ``d`` features on ``device``: rows a tile (threads a block), trees a
    chunk, shared memory bytes a block, and the persistent grid."""
    import ctypes

    got = (ctypes.c_int * 4)()
    lib = kernels.load("forest_leaves")
    with torch.cuda.device(device):
        err = lib.forest_leaves_config(n, d, ops.n_trees, ops.depth, ops.nodes.shape[1],
                                       ops.val.shape[1], got)
    kernels.check("forest_leaves_config", err)
    return dict(zip(("rows", "trees_per_chunk", "smem_bytes", "grid"), list(got)))


def _unwrap(f) -> GemmForest:
    return f.gf if isinstance(f, PallasForest) else f


def heap_operands_of(f) -> HeapOperands:
    """The heap operands of a forest: kept on a :class:`PallasForest`,
    packed anew for a bare :class:`GemmForest`."""
    return f.heap if isinstance(f, PallasForest) else heap_operands(f)


def predict_leaves_pallas(f, x: torch.Tensor) -> torch.Tensor:
    """Per-tree leaf values ``[n, T]`` of a :class:`GemmForest` or
    :class:`PallasForest`: the CUDA kernel for a CUDA tensor, its plain
    version for a CPU tensor, the gemm form past the tile limits."""
    global gemm_route_calls
    gf = _unwrap(f)
    n, d = x.shape
    if tile_dims(gf, n, d) is None:
        gemm_route_calls += 1
        return predict_leaves_gemm(gf, x)
    if x.device.type == "cuda":
        return _launch_leaves(heap_operands_of(f), x).T
    if x.device.type == "cpu":
        return predict_leaves_plain(gf, x)
    raise ValueError(f"unsupported device {x.device}")


def _predict_leaves_sharded(f: ShardedPallasForest, x) -> torch.Tensor:
    """``[n, T]`` leaves on the mesh's first device, one kernel launch per
    (data, model) shard. Each row block's model shards are joined in tree
    order before the blocks are joined in row order, so a reduction over
    trees afterwards (``proba``) adds in the single-device order and gives
    its bits. ``x`` is a row-sharded pool or a plain tensor (the test set),
    padded to the data axis here and cut back."""
    from distributed_active_learning_tpu_torch.parallel.kernels import per_shard

    grid, n = per_shard(f, x, predict_leaves_pallas)
    first = f.mesh.first
    rows = [torch.cat([leaves.to(row[0].device) for leaves in row], dim=1) for row in grid]
    return torch.cat([r.to(first) for r in rows])[:n]


def predict_leaves(f, x: torch.Tensor) -> torch.Tensor:
    if isinstance(f, ShardedPallasForest):
        return _predict_leaves_sharded(f, x)
    return predict_leaves_pallas(f, x)


def predict_proba(f, x: torch.Tensor) -> torch.Tensor:
    return tree_mean(predict_leaves(f, x))


def predict_votes(f, x: torch.Tensor) -> torch.Tensor:
    if isinstance(f, ShardedPallasForest):
        from distributed_active_learning_tpu_torch.parallel.kernels import sharded_votes

        return sharded_votes(f.mesh)(f, x)
    return (predict_leaves(f, x) > 0.5).sum(dim=1, dtype=torch.int32)
