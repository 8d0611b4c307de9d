"""The memory pre-flight: a program's peak device footprint priced before
its launch, at its configured shapes, and the kernels' shared memory a
block priced against the card, with findings that refuse what cannot fit.

- **Peak bytes** (:func:`program_memory`): the program runs once on the meta
  device (its inputs built there at the configured shapes, so a 284,807-row
  pool allocates nothing) under a dispatch mode that tracks live bytes by
  storage: each storage an operation creates is allocated (rounded up to the
  CUDA caching allocator's 512-byte blocks) and freed when its last tensor
  dies (a weakref finalizer); a storage first seen as an input is resident.
  The port's kernel wrappers return meta outputs of their declared shapes
  there (``kernels.kernel_work``). What a kernel allocates inside an
  operation is invisible to the dispatch, so each operation is charged, for
  its length, its library scratch (:func:`library_scratch`: a sort's radix
  buffers, a scan's, cuDNN's convolution workspace, asked of the card's
  cuDNN where there is a card, and the temporaries the card's allocator
  trace showed: a casting reduction's input copy, ``index_add_``'s source
  copy, ``index``'s contiguous broadcast indices). A request past 1 MiB may
  get a cached block up to 1 MiB bigger, all of it counted as allocated, so
  each such live block carries that slack. The result splits the peak into
  its resident inputs, the transient bytes (scratch given apart) and the
  slack, and also models the caching allocator's segments (2 MiB for blocks
  up to 1 MiB, 20 MiB up to 10 MiB, larger ones rounded to 2 MiB, best fit
  with splitting) for the same allocations: the bytes a CUDA graph's private
  pool reserves when it captures the program (``pool_bytes``, with
  :data:`POOL_HEADROOM`). ``chip_smoke.py`` phase 4t holds both against the
  card's ``max_memory_allocated`` and captured pools. A program that its
  driver captures as a CUDA graph (a chunk, the neural chunk, a serving
  capacity's re-fit chunk) holds its resident inputs and its graph's private
  pool at once, which can exceed its eager peak: the gate takes the larger
  of the two.

- **Shared memory** (:func:`smem_for_launch`): Python mirrors of the C
  configuration of K1 (``forest_leaves_config``, ``csrc/forest_leaves.cu``),
  K2 and K3 (``round_megakernel_config``, ``fused_votes_config``,
  ``csrc/heap_votes.cuh``) price each launch of a program a block against
  the card's opt-in maximum, so the CPU can gate a launch configuration
  before the card sees it.

- **Budgets**: the HBM capacity (on the card ``torch.cuda.mem_get_info``'s
  total, else ``analysis/roofline.py``'s table) and the shared memory a
  block; a JSON table overrides them (``--budget-table``, or the
  ``DAL_MEMORY_BUDGET`` variable): ``{"hbm_bytes": N, "smem_bytes": N,
  "source": "..."}``.

Rules: ``hbm-over-budget`` (error; names the overage and the parts of the
peak), ``smem-over-budget`` (error; names the kernel and its bytes a block)
and ``memory-plan-unavailable`` (warn: a program that could not be priced
is unpriced, never clean). ``run.py --audit`` refuses the launch on an
error, ``bench --audit`` carries the ``memory`` section, ``python -m
distributed_active_learning_tpu_torch.analysis --memory`` gates.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from distributed_active_learning_tpu_torch.analysis import roofline
from distributed_active_learning_tpu_torch.analysis.report import Finding

MEMORY_RULES: Dict[str, Tuple[str, str]] = {
    "hbm-over-budget": (
        "error",
        "a program's peak device footprint (resident inputs + transient tensors + "
        "library scratch at the peak; for a program run as a CUDA graph, at least "
        "its resident inputs + the graph's private pool) exceeds the device budget: "
        "the launch would run out of memory",
    ),
    "smem-over-budget": (
        "error",
        "a kernel's launch configuration needs more shared memory a block than the "
        "card offers: the kernel would fail to launch",
    ),
    "memory-plan-unavailable": (
        "warn",
        "a program could not be priced (its footprint is unpriced, not under budget)",
    ),
}


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """What one device may spend: HBM bytes and shared memory a block.
    ``None`` disables that axis (an unknown card: footprints still report)."""

    hbm_bytes: Optional[float]
    smem_bytes: Optional[float]
    source: str

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def device_budget(kind: Optional[str] = None) -> MemoryBudget:
    """This card's budget (``torch.cuda.mem_get_info``'s total HBM), or the
    named device kind's from the capacity tables (``"cpu"``: the stand-in)."""
    if kind is None and torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
        hbm = float(torch.cuda.mem_get_info(0)[1])
    else:
        hbm, kind = roofline.hbm_capacity(kind)
    smem, _ = roofline.smem_capacity(kind)
    return MemoryBudget(hbm_bytes=hbm, smem_bytes=smem, source=kind)


def load_budget_table(path: str) -> MemoryBudget:
    """A JSON budget table ``{"hbm_bytes": N, "smem_bytes": N}`` (a key
    absent or null disables that axis; ``"source"`` labels findings, the
    path by default). The JAX package's ``vmem_bytes`` is refused by name:
    the card has no VMEM."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: budget table must be a JSON object")
    if "vmem_bytes" in doc:
        raise ValueError(
            f"{path}: vmem_bytes is the TPU's per-core VMEM; the card's budget is shared "
            "memory a block: use smem_bytes")
    unknown = set(doc) - {"hbm_bytes", "smem_bytes", "source"}
    if unknown:
        raise ValueError(
            f"{path}: unknown budget keys {sorted(unknown)}; the table "
            "format is {\"hbm_bytes\": N, \"smem_bytes\": N}"
        )

    def _num(key):
        v = doc.get(key)
        if v is None:
            return None
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
            raise ValueError(f"{path}: {key} must be a positive number, got {v!r}")
        return float(v)

    return MemoryBudget(hbm_bytes=_num("hbm_bytes"), smem_bytes=_num("smem_bytes"),
                        source=str(doc.get("source", path)))


def budget_from_env_or(path: Optional[str] = None) -> MemoryBudget:
    """``path``'s table, else ``DAL_MEMORY_BUDGET``'s (the JAX package's
    variable), else :func:`device_budget`."""
    import os

    path = path or os.environ.get("DAL_MEMORY_BUDGET")
    return load_budget_table(path) if path else device_budget()


# ---------------------------------------------------------------------------
# the CUDA caching allocator, modelled
# ---------------------------------------------------------------------------

_BLOCK = 512              # kMinBlockSize: every allocation rounds up to it
_SMALL = 1 << 20          # kSmallSize: blocks up to it come from 2 MiB segments
_SMALL_SEGMENT = 2 << 20  # kSmallBuffer
_LARGE_SEGMENT = 20 << 20  # kLargeBuffer: blocks up to 10 MiB
_MIN_LARGE_ALLOC = 10 << 20
_ROUND_LARGE = 2 << 20


#: Headroom on a modelled graph pool. Replaying the card's own allocation
#: trace of a capture through :class:`PoolModel` gives the captured pool to
#: within 4 MiB (``benches/alloc_trace.py``: the forest chunk 1,116 MiB
#: against 1,120 captured, the CNN chunk 2,448 against 2,446-2,448, a
#: serving capacity's re-fit 1,290 against 1,290; NVIDIA H100 80GB HBM3,
#: PyTorch 2.11): best fit breaks ties by address there and by creation
#: order here. The same program's capture moved by one 2 MiB segment
#: between runs (2,446 and 2,448 MiB). Four times the larger gap.
POOL_HEADROOM = 16 << 20


def block_bytes(nbytes: int) -> int:
    """The caching allocator's block for an allocation of ``nbytes``."""
    return 0 if nbytes <= 0 else -(-nbytes // _BLOCK) * _BLOCK


class PoolModel:
    """A private pool of the caching allocator: segments, best-fit blocks,
    splitting and merging as in ``CUDACachingAllocator``. ``reserved`` is
    what a graph's pool holds after a capture that made these calls."""

    def __init__(self):
        self.reserved = 0
        self._free = {True: [], False: []}  # small?: sorted (size, seg, offset)
        self._blocks = {}  # handle -> (small, seg, offset, size)
        self._segments = {}  # seg -> {offset: (size, free)}
        self._next = 0

    def alloc(self, nbytes: int) -> Optional[int]:
        size = block_bytes(nbytes)
        if size == 0:
            return None
        small = size <= _SMALL
        free = self._free[small]
        i = bisect.bisect_left(free, (size, -1, -1))
        if i < len(free):
            bsize, seg, off = free.pop(i)
        else:
            seg_size = (_SMALL_SEGMENT if small else _LARGE_SEGMENT if size < _MIN_LARGE_ALLOC
                        else -(-size // _ROUND_LARGE) * _ROUND_LARGE)
            seg, off, bsize = self._next, 0, seg_size
            self._next += 1
            self._segments[seg] = {0: [seg_size, True]}
            self.reserved += seg_size
        rest = bsize - size
        if rest >= _BLOCK if small else rest > _SMALL:
            self._segments[seg][off] = [size, False]
            self._segments[seg][off + size] = [rest, True]
            bisect.insort(free, (rest, seg, off + size))
        else:
            self._segments[seg][off] = [bsize, False]
        handle = self._next
        self._next += 1
        self._blocks[handle] = (small, seg, off)
        return handle

    def free(self, handle: Optional[int]) -> None:
        if handle is None:
            return
        small, seg, off = self._blocks.pop(handle)
        blocks = self._segments[seg]
        size = blocks[off][0]
        free = self._free[small]
        # Merge with the free neighbours in the segment.
        nxt = off + size
        if nxt in blocks and blocks[nxt][1]:
            free.remove((blocks[nxt][0], seg, nxt))
            size += blocks.pop(nxt)[0]
        prev = next((o for o, (s, f) in blocks.items() if o + s == off and f), None)
        if prev is not None:
            free.remove((blocks[prev][0], seg, prev))
            size += blocks[prev][0]
            del blocks[off]
            off = prev
        blocks[off] = [size, True]
        bisect.insort(free, (size, seg, off))


# ---------------------------------------------------------------------------
# library scratch
# ---------------------------------------------------------------------------

_SORTS = frozenset(("sort", "argsort", "msort", "topk", "kthvalue", "median", "mode",
                    "unique", "_unique", "_unique2", "unique_consecutive", "unique_dim"))
_SCANS = frozenset(("cumsum", "cumprod", "logcumsumexp", "cummax", "cummin"))


#: Reductions that cast their whole input to the result's dtype first when
#: the two differ (PyTorch's ``make_reduction_from_out_ty``; on the card a
#: half or bfloat16 input summed into float32 is read as it is).
_CASTING_REDUCTIONS = frozenset(("sum", "nansum", "prod", "mean"))
_CONVS = frozenset(("convolution", "_convolution", "convolution_overrideable",
                    "convolution_backward"))


_CUDNN_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_workspaces: Dict[tuple, int] = {}


def _conv_layout(x: torch.Tensor, w: torch.Tensor) -> torch.memory_format:
    """The layout PyTorch hands cuDNN (``cudnn_conv_suggest_memory_format``):
    channels-last when the input or the weight is channels-last."""
    def last(t):
        return (t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)
                and not t.is_contiguous())

    return torch.channels_last if last(x) or last(w) else torch.contiguous_format


def cudnn_workspace(kind: int, x_shape, w_shape, y_shape, stride, padding, dilation,
                    dtype: torch.dtype, layout: torch.memory_format) -> int:
    """The workspace bytes cuDNN's heuristics give the convolution PyTorch
    runs on the card for these shapes (``kind`` 0 forward, 1 backward data,
    2 backward filter): the first configuration PyTorch would accept, under
    the flags of the port's runs there (deterministic, no TF32;
    ``csrc/cudnn_workspace.cu``; no kernel launches). Cached by its
    arguments; a failed query raises."""
    import ctypes

    from distributed_active_learning_tpu_torch import kernels

    # The source asks under the flags of the port's runs on the card:
    # ``device.resolve_device`` turns TF32 off for every run there, and the
    # neural drivers make cuDNN deterministic (``device.deterministic_cuda``);
    # the engine PyTorch picks, and its workspace, follow them.
    dev = torch.cuda.current_device()
    key = (kind, tuple(x_shape), tuple(w_shape), tuple(y_shape), tuple(stride), tuple(padding),
           tuple(dilation), dtype, layout, dev)
    if key in _workspaces:
        return _workspaces[key]
    if dtype not in _CUDNN_DTYPES:
        raise ValueError(f"no cuDNN workspace query for {dtype}")
    spatial = len(x_shape) - 2

    def arr(vals):
        return (ctypes.c_longlong * len(vals))(*[int(v) for v in vals])

    def strides(shape):
        fmt = layout if len(shape) == 4 else torch.contiguous_format
        return torch.empty(tuple(shape), device="meta", memory_format=fmt).stride()

    ws, count = ctypes.c_longlong(0), ctypes.c_int(0)
    err = kernels.load("cudnn_workspace").cudnn_conv_workspace(
        kind, dev, spatial, arr(x_shape), arr(strides(x_shape)), arr(w_shape),
        arr(strides(w_shape)), arr(y_shape), arr(strides(y_shape)), arr(stride), arr(padding),
        arr(dilation), _CUDNN_DTYPES[dtype], ctypes.byref(ws), ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuDNN's workspace query failed for the convolution {key[:7]} "
                           f"(status {err}, {count.value} configurations)")
    _workspaces[key] = int(ws.value)
    return _workspaces[key]


def conv_scratch(name: str, args, out) -> int:
    """A convolution's cuDNN workspace. On a machine with a card: cuDNN's own
    answer for its shapes (:func:`cudnn_workspace`; a backward's the larger
    of its data and filter passes, run one after the other). Without one
    (the meta device on a host, the CPU): bounded by twice the bytes of the
    convolution's tensors (the largest seen on the H100 was 1.19 times
    them: SmallCNN's first layer over a 4,096-row chunk, 705 MB)."""
    ins = [a for a in args if isinstance(a, torch.Tensor)]
    outs = list(roofline._tensors(out))
    bound = 2 * sum(t.numel() * t.element_size() for t in ins + outs if t.dim() == 4)
    if not torch.cuda.is_available():
        return bound
    if name == "convolution_backward":
        dy, x, w = args[0], args[1], args[2]
        stride, padding, dilation, transposed, mask = args[4], args[5], args[6], args[7], args[10]
        runs = [(1, mask[0]), (2, mask[1])]
    else:
        x, w = args[0], args[1]
        dy = outs[0] if outs else None
        stride, padding, dilation, transposed = args[3], args[4], args[5], args[6]
        runs = [(0, True)]
    if transposed or x.dim() != 4 or dy is None:
        return bound
    layout = _conv_layout(x, w)
    return max([cudnn_workspace(kind, x.shape, w.shape, dy.shape, stride, padding, dilation,
                                x.dtype, layout) for kind, want in runs if want] or [0])


def _index_copies(indices) -> int:
    """``index`` on the card with two or more index tensors whose strides
    differ once broadcast (a ``[1, m]`` row index beside a ``[T, m]`` one)
    makes each that is not contiguous at the broadcast shape contiguous
    (``AdvancedIndex``): those copies' bytes."""
    idx = [t for t in indices if isinstance(t, torch.Tensor)]
    if len(idx) < 2:
        return 0
    shape = tuple(torch.broadcast_shapes(*(t.shape for t in idx)))
    return sum(math.prod(shape) * t.element_size() for t in idx
               if tuple(t.shape) != shape or not t.is_contiguous())


#: Operations whose library scratch is allocated before their outputs.
_SCRATCH_FIRST = {"index": True}


def library_scratch(func, args, out) -> int:
    """Bytes a library kernel allocates inside one operation on the card,
    beyond its outputs, which the dispatch does not see: a sort's radix
    double buffers of keys and int64 indices (and the cub temporary beside
    them), a scan's temporary, a convolution's cuDNN workspace
    (:func:`conv_scratch`), an accumulating ``index_put_``'s sorted indices,
    and what the H100's allocator trace of the forest chunk, the CNN chunk
    and a serving capacity's re-fit showed besides (PyTorch 2.11): a
    reduction into another dtype than its input's casts the input first (a
    boolean ``[n, T]`` summed as int32: its int32 copy), ``index_add_``
    copies its source, and ``index`` makes broadcast index tensors
    contiguous (:func:`_index_copies`). No other operation of those
    programs allocated beside its outputs."""
    name = func.overloadpacket.__name__
    ins = [a for a in args if isinstance(a, torch.Tensor)]
    if not ins:
        return 0
    x = ins[0]
    outs = list(roofline._tensors(out))
    if name in _CASTING_REDUCTIONS and outs and outs[0].dtype != x.dtype:
        return x.numel() * outs[0].element_size()
    if name == "index" and len(args) > 1:
        return _index_copies(args[1])
    if name in ("index_add", "index_add_") and len(args) > 3:
        return args[3].numel() * args[3].element_size()
    if name in _SORTS:
        return 2 * (x.numel() * (x.element_size() + 8)) + _SMALL
    if name in _SCANS:
        return x.numel() * x.element_size()
    if name in _CONVS:
        return conv_scratch(name, args, out)
    if name in ("index_put_", "_index_put_impl_") and len(args) > 3 and args[3]:
        idx = sum(t.numel() for t in roofline._tensors(args[1]))
        return 4 * idx * 8 + _SMALL  # accumulate sorts its indices
    return 0


# ---------------------------------------------------------------------------
# the live-bytes tracker
# ---------------------------------------------------------------------------


def _make_tracker(device_type: str):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Tracker(TorchDispatchMode):
        """Live bytes by storage of the tensors on ``device_type``."""

        def __init__(self):
            super().__init__()
            self.resident = {}  # storage key -> bytes (first seen as an input)
            self.live = {}  # storage key -> [bytes, tensor refs, pool handle]
            self.seen = {}  # id -> weakref of the tensors already noted as outputs
            self.transient = 0
            self.large_live = 0  # live blocks past the small pool's 1 MiB
            self.peak_transient = 0
            self.peak_scratch = 0
            self.peak_slack = 0
            self.pool = PoolModel()

        def _key(self, t):
            return t.untyped_storage()._cdata

        def _release(self, key):
            entry = self.live.get(key)
            if entry is None:
                return
            entry[1] -= 1
            if entry[1] == 0:
                del self.live[key]
                self.transient -= entry[0]
                self.large_live -= entry[0] > _SMALL
                self.pool.free(entry[2])

        def _noted(self, t):
            ref = self.seen.get(id(t))
            return ref is not None and ref() is t

        def _note_input(self, t):
            if t.device.type != device_type or self._noted(t):
                return
            key = self._key(t)
            if key not in self.live and key not in self.resident:
                self.resident[key] = block_bytes(t.untyped_storage().nbytes())

        def _note_output(self, t):
            if t.device.type != device_type or self._noted(t):
                return
            self.seen[id(t)] = weakref.ref(t)
            key = self._key(t)
            if key in self.resident:
                return
            entry = self.live.get(key)
            if entry is None:
                size = block_bytes(t.untyped_storage().nbytes())
                entry = self.live[key] = [size, 0, self.pool.alloc(size)]
                self.transient += size
                self.large_live += size > _SMALL
            entry[1] += 1
            weakref.finalize(t, self._release, key)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            for t in roofline._tensors((args, kwargs)):
                self._note_input(t)
            out = roofline.meta_layout(func, args, func(*args, **kwargs))
            scratch = block_bytes(library_scratch(func, args, out))
            # ``index`` makes its indices contiguous before it allocates its
            # output (the card's allocator trace of LAL's regressor walk):
            # the copies' block comes first in the pool, the others' after.
            first = self.pool.alloc(scratch) if _SCRATCH_FIRST.get(
                func.overloadpacket.__name__) else None
            for t in roofline._tensors(out):
                self._note_output(t)
            self._peak(scratch)
            if first is not None:
                self.pool.free(first)
            elif scratch:
                self.pool.free(self.pool.alloc(scratch))
            return out

        def _peak(self, scratch):
            # The allocator hands a request past 1 MiB a cached block up to
            # 1 MiB bigger (it splits only a larger remainder), and counts
            # the whole block as allocated: each such live block may carry
            # that much slack.
            slack = (self.large_live + (scratch > _SMALL)) * _SMALL
            if self.transient + scratch + slack > self.peak_transient + self.peak_slack:
                self.peak_transient = self.transient + scratch
                self.peak_scratch = scratch
                self.peak_slack = slack

    return Tracker()


def tensor_leaves(tree):
    """The tensors of an argument tree: tensors, tuples, lists, dicts and
    dataclasses (a pool state, a strategy's aux inputs, a forest)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from tensor_leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from tensor_leaves(t)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensor_leaves(getattr(tree, f.name))


def program_memory(fn, *args) -> Dict[str, Any]:
    """The footprint of one call of ``fn(*args)`` on the meta device:
    ``{argument_bytes, temp_bytes, scratch_bytes, slack_bytes,
    output_bytes, peak_hbm_bytes, pool_bytes}`` — the resident inputs, the
    transient tensors at the peak (library scratch included, and also given
    apart), the allocator's block slack there (up to 1 MiB a live block
    past 1 MiB), what is still live when ``fn`` returns, the peak (inputs +
    transient + slack: what ``torch.cuda.max_memory_allocated`` can reach)
    and the caching allocator's segments for the program's own allocations
    (a graph capture's private pool), plus :data:`POOL_HEADROOM`. Raises
    what ``fn`` raises."""
    tracker = _make_tracker("meta")
    for t in tensor_leaves(args):
        tracker._note_input(t)
    with tracker:
        result = fn(*args)
    resident = float(sum(tracker.resident.values()))
    out = {
        "argument_bytes": resident,
        "temp_bytes": float(tracker.peak_transient),
        "scratch_bytes": float(tracker.peak_scratch),
        "slack_bytes": float(tracker.peak_slack),
        "output_bytes": float(tracker.transient),
        "peak_hbm_bytes": resident + tracker.peak_transient + tracker.peak_slack,
        "pool_bytes": float(tracker.pool.reserved + POOL_HEADROOM),
    }
    del result
    return out


# ---------------------------------------------------------------------------
# shared memory: the kernels' launch configurations, mirrored
# ---------------------------------------------------------------------------

_MAX_DEPTH = 8  # csrc/heap_walk.cuh


def _align16(b: int) -> int:
    return (b + 15) & ~15


def forest_leaves_config(n: int, d: int, item: int, T: int, depth: int, N: int,
                         Lp: int) -> Optional[dict]:
    """K1's ``configure`` (``csrc/forest_leaves.cu``): rows a tile, trees a
    chunk, shared memory bytes a block; None where the C refuses the
    shape."""
    if (n <= 0 or d <= 0 or d > 1024 or T <= 0 or depth < 0 or depth > _MAX_DEPTH
            or N < (1 << depth) or N % 2 or Lp < (1 << depth) or (Lp * item) % 16):
        return None
    rows = (64 * 1024 // (2 * d)) // 32 * 32  # X_TILE_BYTES
    rows = max(32, min(rows, 256))  # MAX_THREADS
    tree_bytes = N * 8 + Lp * item
    ct = max(1, min(24 * 1024 // tree_bytes, T))  # STAGE_BYTES
    if ct >= 4:  # TREE_ILP
        ct -= ct % 4
    return {"rows": rows, "trees_per_chunk": ct,
            "smem_bytes": _align16(rows * d * 2) + 2 * ct * tree_bytes}


def heap_votes_config(n: int, d: int, item: int, T: int, depth: int, N: int, Lp: int,
                      scratch: int, optin: int) -> Optional[dict]:
    """K2's and K3's ``configure`` (``csrc/heap_votes.cuh``) for a card
    whose blocks may opt in to ``optin`` bytes: mode, groups of 128 threads,
    trees a chunk, shared memory bytes a block; None where the C refuses
    (``scratch`` is the epilogue's: K2 1,024 bytes, K3 0)."""
    if (n <= 0 or d <= 0 or d > 1024 or T <= 0 or depth < 0 or depth > _MAX_DEPTH
            or N < (1 << depth) or N < 2 or N % 2 or Lp < (1 << depth) or (Lp * item) % 16):
        return None
    tile, ilp, max_groups = 128, 4, 8
    votes = _align16(d * tile * 2)
    forest = votes + _align16(tile * 4) + _align16(scratch)
    words = ((1 << depth) + 31) // 32
    resident_bytes = forest + _align16(T * N * 4) + _align16(T * words * 4)
    if resident_bytes <= optin:
        mode, ct, smem = "resident", T, resident_bytes
    else:
        if forest >= optin:
            return {"mode": "streamed", "groups": 0, "trees_per_chunk": 0, "smem_bytes": forest,
                    "refused": True}
        tree_bytes = N * 8 + Lp * item
        ct = (optin - forest) // (2 * tree_bytes)
        if ct < 1:
            return None
        ct = min(ct, T)
        if ct >= ilp * max_groups:
            ct -= ct % (ilp * max_groups)
        mode, smem = "streamed", forest + 2 * ct * tree_bytes
    batches = (ct + ilp - 1) // ilp
    return {"mode": mode, "groups": min(batches, max_groups), "trees_per_chunk": ct,
            "smem_bytes": smem}


#: The epilogue scratch of each vote kernel (``SCRATCH_BYTES``).
VOTE_SCRATCH = {"round_megakernel": 2 * 128 * 4, "fused_votes": 0}


def smem_for_launch(kernel: str, n: int, d: int, n_trees: int, depth: int, item: int,
                    optin: float) -> Optional[dict]:
    """The configuration ``kernel`` ("forest_leaves", "round_megakernel" or
    "fused_votes") launches with for this shape on a card of ``optin``
    bytes a block; the heap form's ``N`` and ``Lp`` follow from the depth
    and payload as ``ops.trees_pallas.pack_heap`` lays them out."""
    L = 1 << depth
    N = max(L, 2)
    per16 = 16 // item
    Lp = -(-L // per16) * per16
    if kernel == "forest_leaves":
        return forest_leaves_config(n, d, item, n_trees, depth, N, Lp)
    return heap_votes_config(n, d, item, n_trees, depth, N, Lp, VOTE_SCRATCH[kernel],
                             int(optin))


# ---------------------------------------------------------------------------
# the planner: per-spec table + findings
# ---------------------------------------------------------------------------


def _mib(b: float) -> str:
    return f"{b / (1 << 20):.2f} MiB"


def _finding(rule: str, program: str, message: str, location: str = "<memory>") -> Finding:
    severity, _ = MEMORY_RULES[rule]
    return Finding(rule=rule, severity=severity, program=program, location=location,
                   message=message)


def _launches(fn, args) -> List[dict]:
    """The shapes of the K1, K2 and K3 launches one call of ``fn`` makes
    (recorded from the kernels' declared work on the meta device)."""
    from distributed_active_learning_tpu_torch import kernels

    tally = kernels.WorkTally()
    with kernels.work_tally(tally):
        fn(*args)
    return [dict(s) for s in tally.launches]


def memory_table(specs: Sequence, budget: MemoryBudget
                 ) -> Tuple[Dict[str, Dict[str, Any]], List[Finding]]:
    """Price every program spec against ``budget`` (the one call of every
    gate: ``run.py --audit``, ``bench --audit``, ``--memory``): ``(table,
    findings)``, one entry a spec (its footprint, its kernels' shared memory, the
    ``*_over_budget_bytes`` where a budget fires) and the findings. A build
    or run that fails is a warn finding and an unpriced entry: the table
    never drops a program."""
    table: Dict[str, Dict[str, Any]] = {}
    findings: List[Finding] = []
    for spec in specs:
        try:
            unit = spec.build()
            entry: Dict[str, Any] = program_memory(unit.fn, *unit.args)
            unit = spec.build()
            launches = _launches(unit.fn, unit.args)
        except Exception as e:  # noqa: BLE001 — unpriced != over budget
            table[spec.name] = {"error": f"{type(e).__name__}: {e}"}
            findings.append(_finding("memory-plan-unavailable", spec.name,
                                     f"{type(e).__name__}: {e}"))
            continue
        peak = gated = entry["peak_hbm_bytes"]
        parts = (f"eager peak {_mib(peak)}: resident inputs {_mib(entry['argument_bytes'])}, "
                 f"transient {_mib(entry['temp_bytes'] - entry['scratch_bytes'])}, library "
                 f"scratch {_mib(entry['scratch_bytes'])}, allocator slack "
                 f"{_mib(entry['slack_bytes'])}")
        if spec.graphed:
            graph = entry["graph_hbm_bytes"] = entry["argument_bytes"] + entry["pool_bytes"]
            parts += (f"; as a CUDA graph {_mib(graph)}: resident inputs "
                      f"{_mib(entry['argument_bytes'])} + captured pool {_mib(entry['pool_bytes'])}")
            gated = max(peak, graph)
        if budget.hbm_bytes is not None and gated > budget.hbm_bytes:
            over = gated - budget.hbm_bytes
            entry["hbm_over_budget_bytes"] = over
            what = "the graph's footprint" if gated > peak else "peak HBM"
            findings.append(_finding(
                "hbm-over-budget", spec.name,
                f"{what} {_mib(gated)} exceeds the {budget.source} budget "
                f"{_mib(budget.hbm_bytes)} by {_mib(over)} ({parts})",
            ))
        smem = {}
        for launch in launches:
            cfg = smem_for_launch(optin=budget.smem_bytes or roofline.SMEM_BYTES_PER_BLOCK["cpu"],
                                  **launch)
            key = launch["kernel"]
            if cfg is None:
                continue
            if key not in smem or cfg["smem_bytes"] > smem[key]["smem_bytes"]:
                smem[key] = cfg
        if smem:
            entry["smem"] = smem
        for kernel, cfg in smem.items():
            if budget.smem_bytes is not None and cfg["smem_bytes"] > budget.smem_bytes:
                over = cfg["smem_bytes"] - budget.smem_bytes
                entry["smem_over_budget_bytes"] = max(entry.get("smem_over_budget_bytes", 0),
                                                      over)
                findings.append(_finding(
                    "smem-over-budget", spec.name,
                    f"{kernel} needs {cfg['smem_bytes']:,} bytes of shared memory a block, "
                    f"{over:,.0f} over the {budget.source} budget {budget.smem_bytes:,.0f}",
                    location=kernel))
        table[spec.name] = entry
    return table, findings


def render_memory_table(table: Dict[str, Dict[str, Any]], budget: MemoryBudget) -> str:
    """Human table: one row per program, sorted by name, the budgets in the
    header."""
    header = ("program", "peak_hbm", "inputs", "transient", "pool", "graph", "smem", "verdict")
    rows = []
    for name in sorted(table):
        e = table[name]
        if "error" in e:
            rows.append((name, "(error)", e["error"][:36], "", "", "", "", "unpriced"))
            continue
        verdict = []
        if "hbm_over_budget_bytes" in e:
            verdict.append(f"HBM over by {_mib(e['hbm_over_budget_bytes'])}")
        if "smem_over_budget_bytes" in e:
            verdict.append(f"smem over by {e['smem_over_budget_bytes']:,.0f} B")
        smem = max((c["smem_bytes"] for c in e.get("smem", {}).values()), default=None)
        rows.append((name, _mib(e["peak_hbm_bytes"]), _mib(e["argument_bytes"]),
                     _mib(e["temp_bytes"]), _mib(e["pool_bytes"]),
                     _mib(e["graph_hbm_bytes"]) if "graph_hbm_bytes" in e else "-",
                     f"{smem:,}" if smem is not None else "-", "; ".join(verdict) or "ok"))
    widths = [max(len(header[i]), *(len(str(r[i])) for r in rows)) if rows else len(header[i])
              for i in range(len(header))]

    def _row(cols):
        return "  ".join(str(c).ljust(w) for c, w in zip(cols, widths))

    head = (f"budget [{budget.source}]: hbm="
            + (_mib(budget.hbm_bytes) if budget.hbm_bytes else "unlimited")
            + ", smem a block="
            + (f"{budget.smem_bytes:,.0f} B" if budget.smem_bytes else "unlimited"))
    return "\n".join([head, _row(header), _row(["-" * w for w in widths])]
                     + [_row(r) for r in rows])


def memory_section(table: Dict[str, Dict[str, Any]], findings: Sequence[Finding],
                   budget: MemoryBudget) -> dict:
    """The JSON-ready ``memory`` section the surfaces share (``--memory
    --json``, ``bench --audit``), with the JAX package's keys."""
    priced = [e for e in table.values() if "error" not in e]
    peaks = [e["peak_hbm_bytes"] for e in priced]
    counts = {"error": 0, "warn": 0, "info": 0}
    for f in findings:
        counts[f.severity] += 1
    return {
        "budget": budget.asdict(),
        "programs_priced": len(priced),
        "programs_skipped": 0,
        "programs_unpriced": len(table) - len(priced),
        "max_peak_hbm_bytes": max(peaks) if peaks else None,
        "counts": counts,
        "findings": [f.asdict() for f in findings],
        "programs": table,
    }
