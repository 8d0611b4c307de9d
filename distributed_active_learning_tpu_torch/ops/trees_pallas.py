"""Per-tree leaf values through the hand-written Hopper kernel
(``csrc/forest_leaves.cu``): the port of ``ops/trees_pallas.py``, whose
Pallas ``_kernel`` it replaces. ``ForestConfig.kernel="pallas"`` keeps its
name and selects this module.

The kernel walks each tree from the root (``csrc/heap_walk.cuh``), so it
takes complete heap trees, the form every device fit grows: the forest's
heap form (:class:`HeapOperands`) is built once per forest and shared with
the vote kernels K2 and K3 (``ops/round_fused.py``), which walk the same
trees, and a path matrix of another shape is refused on the card. A host
fit's trees are packed into complete heaps of the forest's depth from their
gather form (:func:`heap_from_packed`, called by
``forest_eval.for_kernel``) and kept on the :class:`PallasForest`. On a heap
tree the walk is the path-matrix function exactly. The layout variants K5
and K6 (``benches/pallas_variants.py``) walk the same heap words.

Numerics are those of the TPU kernel: each node slot's feature is rounded to
bf16 and compared in f32 against its f32 threshold. A vote can differ from
the exact f32 compare of ``ops/trees_gemm.py`` only where a feature lies
within bf16 rounding of a threshold; each form is held against its own
reference.

Quantized storage (``ops/trees_train.quantize_forest``): bf16 thresholds are
widened into the f32 half of the node words (exact), and the leaf payload
keeps its storage dtype (f32, bf16 or int8) in :class:`HeapOperands`. The
kernels read the narrow payload and widen it in registers, as the TPU
kernel's ``_leaf_rows`` dequantizes in its body
(``models.forest.dequantize_leaf_values``: int8 times f32(1/127), bf16
widened).

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
(data, model) shard, each on its own device (``parallel.kernels``).
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

from distributed_active_learning_tpu_torch import kernels
from distributed_active_learning_tpu_torch.analysis import costs
from distributed_active_learning_tpu_torch.models.forest import dequantize_leaf_values
from distributed_active_learning_tpu_torch.ops.trees_gemm import (
    GemmForest,
    _auto_chunk,
    predict_leaves_gemm,
    tree_mean,
)
from distributed_active_learning_tpu_torch.ops.trees_train import heap_constant, heap_path_target
from distributed_active_learning_tpu_torch.parallel.mesh import ShardedForest

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
    # The heap form when it was built elsewhere: a host-fit forest's trees
    # are packed into heaps from their gather form (heap_from_packed), which
    # its path matrix (depth-first, not heap order) cannot give back.
    prepacked: "HeapOperands | None" = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def n_trees(self) -> int:
        return self.gf.n_trees

    @functools.cached_property
    def heap(self) -> "HeapOperands":
        return self.prepacked if self.prepacked is not None else heap_operands(self.gf)

    def to(self, device) -> "PallasForest":
        heap = self.prepacked
        if heap is not None:
            heap = dataclasses.replace(heap, nodes=heap.nodes.to(device), val=heap.val.to(device))
        return PallasForest(gf=self.gf.to(device), prepacked=heap)


#: The payload code each kernel entry point takes for a leaf dtype
#: (csrc/leaf_payload.cuh): a dtype not listed raises before any launch.
PAYLOAD_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@dataclasses.dataclass(frozen=True)
class ShardedPallasForest(ShardedForest):
    """Mesh-aware twin of :class:`PallasForest`: ``shards[s][m]`` is model
    shard ``m``'s trees on ``mesh.devices[s][m]`` (``parallel.mesh.
    shard_forest``), and evaluation launches the kernel per shard on the
    shard's row block, as the JAX package's ``shard_map`` does; the fused
    round runs K3 per shard on it."""


def attach_mesh(forest, mesh):
    """Wrap a forest for per-shard evaluation on ``mesh``: a ``[data][model]``
    grid from ``parallel.mesh.shard_forest`` or a global forest (sharded
    here) becomes a :class:`ShardedPallasForest` for the leaf kernel's form
    and a ``parallel.mesh.ShardedForest`` for the gemm and gather forms; a
    sharded forest is re-wrapped on ``mesh``, and a multiclass
    :class:`~.trees_multi.MultiForest` is wrapped plane by plane."""
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest
    from distributed_active_learning_tpu_torch.parallel.mesh import shard_forest

    if isinstance(forest, MultiForest):
        return MultiForest(planes=tuple(attach_mesh(p, mesh) for p in forest.planes))
    if isinstance(forest, ShardedForest):
        return type(forest)(shards=forest.shards, mesh=mesh)
    if not isinstance(forest, tuple):
        forest = shard_forest(forest, mesh)
    cls = ShardedPallasForest if isinstance(forest[0][0], PallasForest) else ShardedForest
    return cls(shards=forest, mesh=mesh)


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
class HeapOperands:
    """A complete heap forest in the walking kernels' layout (K1, K2, K3, K5
    and K6; csrc/heap_walk.cuh): node
    ``v`` of tree ``t`` is the 8-byte word ``nodes[t, v] = (feature id,
    f32 threshold bits)``, children at ``2v + 1`` and ``2v + 2``; leaf
    ``l``'s value is ``val[t, l]``, in the forest's storage dtype (f32, bf16
    or int8). Feature ids fit 16 bits (``d <= 512``) and are kept in the
    word's 32-bit half. The trailing slots (node ``2^depth - 1`` at every
    depth; leaves padded to 16 bytes a tree: a multiple of 4 f32, 8 bf16 or
    16 int8 values) keep each tree's arrays whole 16-byte pieces for the
    kernels' asynchronous copies and are never read."""

    nodes: torch.Tensor  # [T, N] int64 words: N = max(2^depth, 2)
    val: torch.Tensor    # [T, Lp] payload: Lp = 2^depth rounded up to 16 bytes
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

    @property
    def payload(self) -> int:
        """The kernels' code of the leaf dtype (:data:`PAYLOAD_CODES`)."""
        if self.val.dtype not in PAYLOAD_CODES:
            raise ValueError(f"the forest kernels take f32, bf16 or int8 leaf values, "
                             f"not {self.val.dtype}")
        return PAYLOAD_CODES[self.val.dtype]

    def values(self) -> torch.Tensor:
        """``[T, Lp]`` f32 leaf values, widened from the storage dtype as the
        kernels widen them."""
        return dequantize_leaf_values(self.val)


def _not_a_heap(why: str) -> ValueError:
    return ValueError(
        "The forest kernels on the card (K1, K2, K3, K5, K6) walk complete heap trees, and "
        f"this forest is not one ({why}). "
        "The device fit grows heap trees; a host fit's trees reach the kernels packed into "
        "heaps from their gather form: forest_eval.for_kernel(packed, 'pallas')."
    )


def heap_depth(gf: GemmForest) -> int:
    """The depth of a forest of complete heap trees, or ``ValueError`` when
    the forest is not one. A device-fit forest's path and targets are
    broadcasts of ``heap_path_target``'s constant, which is recognized from
    storage alone (no host sync: the test runs inside a captured chunk); any
    other path matrix is compared with that constant by value, which reads
    one boolean back from the device."""
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
    return depth


def pack_heap(feat: torch.Tensor, thr: torch.Tensor, value: torch.Tensor,
              depth: int) -> HeapOperands:
    """Heap words of ``[T, 2^depth - 1]`` feature ids and thresholds (f32,
    or bf16 widened into the word's f32 half) in heap order, with
    ``[T, 2^depth]`` leaf values kept in their dtype (f32, bf16 or int8),
    each tree's padded to whole 16-byte pieces."""
    T, I = feat.shape
    L = 1 << depth
    N = max(L, 2)
    words = torch.zeros(T, N, 2, dtype=torch.int32, device=feat.device)
    words[:, :I, 0] = feat.to(torch.int32)
    words[:, :I, 1] = thr.to(torch.float32).view(torch.int32)
    if value.dtype not in PAYLOAD_CODES:
        value = value.to(torch.float32)
    per16 = 16 // value.element_size()
    Lp = -(-L // per16) * per16
    return HeapOperands(
        nodes=words.view(torch.int64).reshape(T, N),
        val=torch.nn.functional.pad(value, (0, Lp - L)).contiguous(),
        depth=depth,
    )


def heap_from_packed(packed) -> HeapOperands:
    """The heap form of a :class:`~.trees.PackedForest` whose trees are no
    deeper than its ``max_depth`` D (a host fit's): every tree becomes a
    complete heap of depth D. A leaf met above the last level stands for all
    the heap slots below it: those internal slots get feature 0 and the
    leaf's own threshold, and every heap leaf under it gets its value, so
    the walk reaches that value whatever their compares give. Built level
    by level with numpy on the host, then placed on the forest's device."""
    from distributed_active_learning_tpu_torch.ops.trees import LEAF

    feature, threshold, left, right, value = (
        getattr(packed, f).cpu().numpy() for f in ("feature", "threshold", "left", "right", "value"))
    depth = max(packed.max_depth, 1)
    tree = np.arange(feature.shape[0])[:, None]
    node = np.zeros((feature.shape[0], 1), dtype=np.int64)  # packed node of each heap slot
    feats, thrs = [], []
    for _ in range(depth):
        feat = feature[tree, node]
        leaf = feat == LEAF
        feats.append(np.where(leaf, 0, feat))
        thrs.append(threshold[tree, node])
        children = (np.where(leaf, node, left[tree, node]), np.where(leaf, node, right[tree, node]))
        node = np.stack(children, axis=2).reshape(feature.shape[0], -1)
    if (feature[tree, node] != LEAF).any():
        raise ValueError(f"a tree of this forest is deeper than its max_depth {packed.max_depth}")
    dev = packed.feature.device
    return pack_heap(torch.from_numpy(np.concatenate(feats, axis=1).astype(np.int32)).to(dev),
                     torch.from_numpy(np.concatenate(thrs, axis=1).astype(np.float32)).to(dev),
                     torch.from_numpy(value[tree, node].astype(np.float32)).to(dev), depth)


def heap_operands(gf: GemmForest) -> HeapOperands:
    """The heap form of a path-matrix forest, or ``ValueError`` when the
    forest is not made of complete heap trees (:func:`heap_depth`)."""
    return pack_heap(gf.feat_ids, gf.thresholds, gf.value, heap_depth(gf))


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
    val = ops.values()
    return torch.cat([val[tree, leaf] for leaf in walk_leaf_ids(ops, x)])


def predict_leaves_plain(gf: GemmForest, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``[n, T]`` leaf values from
    bf16-rounded features compared in f32, dense ancestor counts
    ``c . path`` (small integers, exact in f32), ``hit = (count ==
    target)``, ``hit . value`` (the value widened from its storage dtype) —
    chunked over rows like the gemm form."""
    T, I = gf.feat_ids.shape
    feat = gf.feat_ids.reshape(-1).long()
    thr = gf.thresholds.reshape(-1).to(torch.float32)
    out = []
    for xb in torch.split(x, _auto_chunk(gf)):
        fv = xb.to(torch.bfloat16).to(torch.float32)[:, feat]
        c = (fv <= thr).to(torch.float32).reshape(-1, T, I)
        s = torch.einsum("nti,til->ntl", c, gf.path)
        hit = (s == gf.target[None]).to(torch.float32)
        out.append(torch.einsum("ntl,tl->nt", hit, dequantize_leaf_values(gf.value)))
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
    x = _check_x(x, ops)
    n, d = x.shape
    out = torch.empty(ops.n_trees, n, dtype=torch.float32, device=x.device)
    lib = kernels.load("forest_leaves")
    with torch.cuda.device(x.device):
        err = lib.forest_leaves(
            x.data_ptr(), n, d, ops.nodes.data_ptr(), ops.val.data_ptr(), ops.payload,
            ops.n_trees, ops.depth, ops.nodes.shape[1], ops.val.shape[1], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check("forest_leaves", err)
    kernels.count_launch(sys.modules[__name__])
    return out


def leaves_launch_config(ops: HeapOperands, n: int, d: int, device) -> dict:
    """The configuration csrc/forest_leaves.cu launches with for ``n`` rows
    of ``d`` features on ``device`` (at the forest's payload dtype): rows a
    tile (threads a block), trees a chunk, shared memory bytes a block, and
    the persistent grid."""
    import ctypes

    got = (ctypes.c_int * 4)()
    lib = kernels.load("forest_leaves")
    with torch.cuda.device(device):
        err = lib.forest_leaves_config(n, d, ops.payload, ops.n_trees, ops.depth,
                                       ops.nodes.shape[1], ops.val.shape[1], got)
    kernels.check("forest_leaves_config", err)
    return dict(zip(("rows", "trees_per_chunk", "smem_bytes", "grid"), list(got)))


def _unwrap(f) -> GemmForest:
    return f.gf if isinstance(f, PallasForest) else f


def heap_operands_of(f) -> HeapOperands:
    """The heap operands of a forest: kept on a :class:`PallasForest`,
    packed anew for a bare :class:`GemmForest`."""
    return f.heap if isinstance(f, PallasForest) else heap_operands(f)


def heap_shape(f):
    """``(trees, depth, leaf payload bytes)`` of a forest's heap form, from
    shapes alone: a host fit's packed heaps where it has them, else the
    path-matrix forest's (the kernels' declared work, ``analysis.costs``)."""
    heap = f.prepacked if isinstance(f, PallasForest) else None
    if heap is not None:
        return heap.n_trees, heap.depth, heap.val.element_size()
    gf = _unwrap(f)
    item = gf.value.element_size() if gf.value.dtype in PAYLOAD_CODES else 4
    return gf.n_trees, gf.value.shape[1].bit_length() - 1, item


def launch_shape(f, n: int, d: int) -> dict:
    """The shape a walking kernel (K1, K2, K3) launches at over ``n`` rows
    of ``d`` features: the shared-memory pre-flight's input
    (``analysis.memory.smem_for_launch``)."""
    trees, depth, item = heap_shape(f)
    return {"n": n, "d": d, "n_trees": trees, "depth": depth, "item": item}


def leaves_cost(f, n: int, d: int) -> costs.Cost:
    """K1's declared work over ``n`` rows of ``d`` features."""
    return costs.forest_leaves(n, d, *heap_shape(f))


def _meta_leaves(f, x: torch.Tensor) -> torch.Tensor:
    """K1's output on the meta device (a priced program's stand-in): the
    heap form built as on the card, ``[T, n]`` f32 seen as ``[n, T]``."""
    heap_operands_of(f)
    return torch.empty(_unwrap(f).n_trees, x.shape[0], dtype=torch.float32, device=x.device).T


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
    with kernels.kernel_work("forest_leaves", lambda: leaves_cost(f, n, d),
                             lambda: launch_shape(f, n, d)):
        if x.device.type == "cuda":
            return _launch_leaves(heap_operands_of(f), x).T
        if x.device.type == "cpu":
            return predict_leaves_plain(gf, x)
        if x.device.type == "meta":
            return _meta_leaves(f, x)
    raise ValueError(f"unsupported device {x.device}")


def stack_heaps(heaps) -> HeapOperands:
    """Heap forests of one shape as one forest, their trees concatenated in
    order: the walk of tree ``t`` reads only tree ``t``'s words, so the
    stacked forest's leaves are each forest's own, rows ``[a, a + T)`` for
    the forest whose trees start at ``a``. Forests that differ in depth,
    node count ``N``, leaf pitch ``Lp``, payload or device are refused,
    naming the difference."""
    first = heaps[0]
    for h in heaps[1:]:
        for what, a, b in (("depth", first.depth, h.depth),
                           ("node count N", first.nodes.shape[1], h.nodes.shape[1]),
                           ("leaf pitch Lp", first.val.shape[1], h.val.shape[1]),
                           ("payload", first.val.dtype, h.val.dtype),
                           ("device", first.nodes.device, h.nodes.device)):
            if a != b:
                raise ValueError(f"forests of one stacked K1 launch must share their {what}: "
                                 f"{a} != {b}")
    if len(heaps) == 1:
        return first
    return HeapOperands(nodes=torch.cat([h.nodes for h in heaps]),
                        val=torch.cat([h.val for h in heaps]), depth=first.depth)


def predict_leaves_many(forests, x: torch.Tensor):
    """Per-tree leaf values ``[n, T]`` of each :class:`PallasForest` (or
    :class:`GemmForest` of heap trees) over one ``x``, from ONE walk of all
    their trees stacked (:func:`stack_heaps`): one kernel launch for a CUDA
    tensor, the walk's plain version (:func:`walk_leaves_plain`) for a CPU
    tensor. Each result equals :func:`predict_leaves_pallas` of its forest
    bit for bit (on the card a slice of the launch's ``[sum T, n]`` output,
    laid out as one forest's launch; on the CPU a contiguous ``[n, T]``, as
    the plain version's). Forests past the kernel's tile limits are not
    taken (``ValueError``): evaluate them one by one."""
    n, d = x.shape
    if any(tile_dims(_unwrap(f), n, d) is None for f in forests):
        raise ValueError("a forest past the leaf kernel's tile limits takes the gemm form; "
                         "evaluate such forests one by one")

    def cost():
        # One launch: x read once, every forest's heap and leaves.
        work = [leaves_cost(f, n, d) for f in forests]
        return sum(w[0] for w in work), sum(w[1] for w in work) - 4 * n * d * (len(work) - 1)

    with kernels.kernel_work("forest_leaves", cost):
        heaps = [heap_operands_of(f) for f in forests]
        sizes = [h.n_trees for h in heaps]
        ops = stack_heaps(heaps)
        if x.device.type == "cuda":
            return [v.T for v in torch.split(_launch_leaves(ops, x), sizes)]
        if x.device.type == "cpu":
            return [v.contiguous() for v in torch.split(walk_leaves_plain(ops, x), sizes, dim=1)]
        if x.device.type == "meta":
            out = torch.empty(ops.n_trees, n, dtype=torch.float32, device=x.device)
            return [v.T for v in torch.split(out, sizes)]
    raise ValueError(f"unsupported device {x.device}")


def predict_leaves(f, x: torch.Tensor) -> torch.Tensor:
    return predict_leaves_pallas(f, x)


def predict_proba(f, x: torch.Tensor) -> torch.Tensor:
    return tree_mean(predict_leaves(f, x))


def predict_votes(f, x: torch.Tensor) -> torch.Tensor:
    return (predict_leaves(f, x) > 0.5).sum(dim=1, dtype=torch.int32)
