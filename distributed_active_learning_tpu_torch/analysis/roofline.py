"""Per-program cost accounting and roofline attribution on the card.

Two halves, as in the JAX package's ``analysis/roofline.py``:

- **Cost** (:func:`program_cost`): the program runs once under a
  ``TorchDispatchMode`` that counts every aten operation it makes. Bytes:
  each operation's tensor inputs read once (a broadcast or strided input
  counts the storage it spans, a gather the rows it fetches, a scatter the
  rows it writes) and its outputs written once; views, allocations without
  a fill and host reads move nothing. A CUDA graph replays the same kernels
  unfused, so this is what the program moves. FLOPs: ``torch.utils.
  flop_counter``'s rules for products and convolutions, plus one an output
  element for each elementwise operation. The port's own kernels (K1-K7)
  count their declared work (``analysis/costs.py``, through
  ``kernels.kernel_work``) and nothing of what computes them inside their
  wrappers: on the card the CUDA kernel, on the CPU the plain version, on
  the meta device a stand-in. So a program has one cost whichever of those
  implements its kernels, and a later redesign of a kernel leaves it as it
  is. The count runs the program once, so it runs outside every timed
  region; on the meta device it allocates nothing and launches nothing.

- **Attribution** (:func:`attribute`): the cost joined with measured
  seconds and the card's peaks into achieved FLOP/s and bytes/s, the share
  of each peak and the bound verdict, with the JAX package's keys and
  arithmetic.

Peak tables are keyed by the name ``torch.cuda.get_device_name`` prints,
matched by prefix. ``mfu`` divides by the bf16 dense table
(:data:`PEAK_BF16_FLOPS`, the JAX package's convention); ``mfu_f32``, which
the port's callers add beside it, by the float32 table
(:data:`PEAK_F32_FLOPS`, the rate of PERF.md's kernel bounds);
``bandwidth_util`` by :data:`PEAK_HBM_BYTES_PER_SEC`. A card off the tables
(and the CPU) gets ``indeterminate:no-peak-table``.

Consumers: ``run.py --roofline`` (a ``roofline`` JSONL event after a
chunked run), ``bench --mode round`` (the ``roofline`` section) and
``python -m distributed_active_learning_tpu_torch.analysis --costs``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

_GiB = float(1 << 30)

# NVIDIA's H100 SXM data sheet (dense rates, at the 700 W power limit).
_H100 = "NVIDIA H100 80GB HBM3"

#: bf16 dense tensor-core peak FLOP/s.
PEAK_BF16_FLOPS = {_H100: 989e12}

#: float32 peak FLOP/s outside the tensor cores: the rate of the tree walks'
#: compares, which PERF.md's kernel bounds use.
PEAK_F32_FLOPS = {_H100: 67e12}

#: HBM bandwidth, bytes/s.
PEAK_HBM_BYTES_PER_SEC = {_H100: 3.35e12}

#: HBM capacity in bytes. The "cpu" entry is the JAX package's stand-in: host
#: memory is not the scarce resource there, so the budget is a generous
#: fixed slab that only a runaway program (or a deliberately tiny table) can
#: exceed. On the card the memory pre-flight takes ``torch.cuda.
#: mem_get_info``'s total instead (``analysis.memory.device_budget``).
HBM_BYTES_PER_DEVICE = {_H100: 80e9, "cpu": 4 * _GiB}

#: Shared memory a block may opt in to (sm_90's maximum, 227 KiB): the
#: budget of the kernels' tiles (``analysis.memory``), in place of the JAX
#: package's per-core VMEM. The "cpu" entry keeps the card's, so the CPU
#: can gate a launch configuration before the card sees it.
SMEM_BYTES_PER_BLOCK = {_H100: 232_448, "cpu": 232_448}


def _lookup(table: Dict[str, float], kind: str) -> Optional[float]:
    for name, peak in table.items():
        if kind.startswith(name):
            return peak
    return None


def device_kind() -> str:
    """The first card's name, ``"cpu"`` without one."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def peak_flops(kind: Optional[str] = None) -> Tuple[Optional[float], str]:
    """(bf16 peak FLOP/s, device kind); None off the table (the CPU)."""
    kind = device_kind() if kind is None else kind
    return _lookup(PEAK_BF16_FLOPS, kind), kind


def peak_flops_f32(kind: Optional[str] = None) -> Tuple[Optional[float], str]:
    """(float32 peak FLOP/s, device kind), None off the table."""
    kind = device_kind() if kind is None else kind
    return _lookup(PEAK_F32_FLOPS, kind), kind


def peak_bandwidth(kind: Optional[str] = None) -> Tuple[Optional[float], str]:
    """(HBM peak bytes/s, device kind), None off the table."""
    kind = device_kind() if kind is None else kind
    return _lookup(PEAK_HBM_BYTES_PER_SEC, kind), kind


def _capacity(table, kind):
    cap = _lookup(table, kind)
    if cap is None and kind.lower().startswith("cpu"):
        cap = table["cpu"]
    return cap


def hbm_capacity(kind: Optional[str] = None) -> Tuple[Optional[float], str]:
    """(HBM capacity bytes, device kind) from the table; None for an
    unknown card (the planner then reports footprints without gating)."""
    kind = device_kind() if kind is None else kind
    return _capacity(HBM_BYTES_PER_DEVICE, kind), kind


def smem_capacity(kind: Optional[str] = None) -> Tuple[Optional[float], str]:
    """(shared memory a block, device kind), keyed like :func:`hbm_capacity`."""
    kind = device_kind() if kind is None else kind
    return _capacity(SMEM_BYTES_PER_BLOCK, kind), kind


# ---------------------------------------------------------------------------
# cost: one run under a counting dispatch mode
# ---------------------------------------------------------------------------

# Operations that move no data: allocations without a fill, host reads,
# bookkeeping.
_FREE = frozenset((
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "_local_scalar_dense", "detach", "alias", "lift_fresh", "resize_", "set_",
    "record_stream", "_has_compatible_shallow_copy_type", "is_same_size", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "_unsafe_view", "_reshape_alias",
))
# In-place operations that write ``self`` without reading it.
_WRITE_ONLY = frozenset(("copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
                         "bernoulli_", "exponential_"))
# Reads of selected rows: the source counts the elements fetched, not its size.
_GATHERS = frozenset(("index", "index_select", "gather", "take", "embedding",
                      "take_along_dim"))
# In-place writes of selected rows: the destination counts the rows written.
_SCATTERS = frozenset(("index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
                       "scatter_reduce_", "index_add_", "index_copy_", "index_fill_",
                       "masked_scatter_", "index_reduce_"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def span_bytes(t: torch.Tensor) -> int:
    """Bytes a read of ``t`` touches: its elements, or the storage its
    strides span where that is less (a broadcast)."""
    if t.numel() == 0:
        return 0
    extent = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()) if s > 1)
    return min(t.numel(), extent) * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


_CONVOLUTIONS = frozenset(("convolution", "_convolution", "convolution_overrideable"))


def meta_layout(func, args, out):
    """``out`` with the layout the card (and the CPU) give: a convolution of
    a channels-last input comes out channels-last there, where the meta
    kernel returns it contiguous (a later reshape would copy on the meta
    device only). Other outputs pass through."""
    if (func.overloadpacket.__name__ in _CONVOLUTIONS and isinstance(out, torch.Tensor)
            and out.device.type == "meta" and out.dim() == 4
            and args[0].is_contiguous(memory_format=torch.channels_last)
            and not out.is_contiguous(memory_format=torch.channels_last)):
        return out.contiguous(memory_format=torch.channels_last)
    return out


def op_cost(func, args, kwargs, out) -> Tuple[float, float]:
    """``(flops, bytes)`` of one aten operation by the rules above."""
    from torch.utils.flop_counter import flop_registry

    name = func.overloadpacket.__name__
    if name in _FREE or _is_view(func):
        return 0.0, 0.0
    outs = list(_tensors(out))
    flops = 0.0
    formula = flop_registry.get(func.overloadpacket)
    if formula is not None:
        flops = float(formula(*args, **kwargs, out_val=out))
    elif torch.Tag.pointwise in func.tags and outs:
        flops = float(outs[0].numel())
    ins = list(_tensors(args)) + list(_tensors(kwargs))
    written = [t for t in _tensors(kwargs.get("out"))] if "out" in kwargs else []
    if name in _GATHERS:
        fetched = sum(_nbytes(t) for t in outs)
        idx = sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
        return flops, float(idx + 2 * fetched)
    if name in _SCATTERS:
        self_ = ins[0]
        others = [t for t in ins[1:] if t is not self_]
        if name == "index_fill_":
            index = others[0]
            dim = args[1] % max(self_.dim(), 1)
            row = self_.numel() // max(self_.shape[dim], 1) if self_.dim() else 1
            return flops, float(_nbytes(index) + index.numel() * row * self_.element_size())
        src = max((_nbytes(t) for t in others), default=0)
        return flops, float(sum(_nbytes(t) for t in others) + src)
    reads, seen = 0, set()
    skip = {id(t) for t in written}
    if name in _WRITE_ONLY and ins:
        skip.add(id(ins[0]))
    for t in ins:
        if id(t) in seen or id(t) in skip:
            continue
        seen.add(id(t))
        reads += span_bytes(t)
    writes = sum(_nbytes(t) for t in (written or outs))
    return flops, float(reads + writes)


def _call(func, args, kwargs):
    return func(*args, **kwargs)


def cost_mode(tally, on_op=None, run=_call):
    """The counting dispatch mode over this thread's kernel ``tally``: the
    one walk of a program's operations that the cost, and the program
    auditor's trace (``analysis/auditor.py``), read. ``run(func, args,
    kwargs)`` computes each operation (the auditor's stands in for the
    meta device's refusals); ``on_op(func, args, kwargs, out, cost)`` sees
    each one after it ran, ``cost`` its ``(flops, bytes)``, None inside a
    kernel's wrapper (not the program's)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CostMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = meta_layout(func, args, run(func, args, kwargs))
            cost = None
            if tally.inside == 0:
                cost = op_cost(func, args, kwargs, out)
                self.flops += cost[0]
                self.bytes += cost[1]
                self.ops += 1
            if on_op is not None:
                on_op(func, args, kwargs, out, cost)
            return out

    return CostMode()


def program_cost(fn, *args) -> Dict[str, Any]:
    """The cost of one call of ``fn(*args)``: ``{flops, bytes_accessed,
    flops_per_byte, kernels, ops}``, ``kernels`` being each kernel's
    declared ``{calls, flops, bytes}`` (included in the totals) and ``ops``
    the aten operations counted outside them. Runs ``fn`` once (outside
    timed regions); raises what ``fn`` raises. Count a warm call: a device's
    constants (uploaded once and cached) are counted at its first call
    only."""
    from distributed_active_learning_tpu_torch import kernels

    tally = kernels.WorkTally()
    mode = cost_mode(tally)
    with kernels.work_tally(tally), mode:
        fn(*args)
    flops = mode.flops + sum(k["flops"] for k in tally.kernels.values())
    nbytes = mode.bytes + sum(k["bytes"] for k in tally.kernels.values())
    return {
        "flops": flops,
        "bytes_accessed": nbytes,
        "flops_per_byte": round(flops / nbytes, 4) if flops and nbytes else None,
        "kernels": tally.kernels,
        "ops": mode.ops,
    }


def cost_table(specs) -> Dict[str, Dict[str, Any]]:
    """Price every program spec (``analysis/programs.py``): ``{name:
    {flops, bytes_accessed, flops_per_byte, peak_hbm_bytes}}``, the peak
    from the memory pre-flight of the same build. A spec whose build or run
    fails gets ``{"error": ...}``: the table never drops a program."""
    from distributed_active_learning_tpu_torch.analysis import memory as memory_lib

    table: Dict[str, Dict[str, Any]] = {}
    for spec in specs:
        try:
            unit = spec.build()
            cost = program_cost(unit.fn, *unit.args)
            cost.pop("kernels")
            cost.pop("ops")
            unit = spec.build()
            cost["peak_hbm_bytes"] = memory_lib.program_memory(unit.fn, *unit.args)[
                "peak_hbm_bytes"]
            table[spec.name] = cost
        except Exception as e:  # noqa: BLE001 — per-program, keep pricing
            table[spec.name] = {"error": f"{type(e).__name__}: {e}"}
    return table


# ---------------------------------------------------------------------------
# attribution: join the cost with measured seconds
# ---------------------------------------------------------------------------


def roofline_verdict(
    mfu: Optional[float],
    bw_util: Optional[float],
    flops_per_byte: Optional[float],
    machine_balance: Optional[float],
) -> str:
    """Name the binding resource: the higher measured share when both
    exist, else the static comparison of arithmetic intensity with the
    machine balance (marked ``(static)``), ``indeterminate:no-peak-table``
    when the cost is known but the card has no peak table."""
    if mfu is not None and bw_util is not None:
        return "compute-bound" if mfu >= bw_util else "bandwidth-bound"
    if flops_per_byte is not None and machine_balance is not None:
        side = "compute" if flops_per_byte >= machine_balance else "bandwidth"
        return f"{side}-bound(static)"
    if flops_per_byte is not None:
        return "indeterminate:no-peak-table"
    return "indeterminate"


def attribute(
    cost: Dict[str, Optional[float]],
    seconds: Optional[float],
    *,
    peak_flops_per_sec: Optional[float] = None,
    peak_bytes_per_sec: Optional[float] = None,
    n_devices: int = 1,
) -> Dict[str, Any]:
    """Join one program's cost with its measured seconds. ``peak_*``
    default to this card's tables (bf16 and HBM), times ``n_devices`` for
    mesh programs. Returns the JAX package's flat dict: ``flops``,
    ``bytes_accessed``, ``flops_per_byte``, ``seconds``,
    ``achieved_gflops_per_sec``, ``achieved_gbytes_per_sec``, ``mfu``,
    ``bandwidth_util`` and ``bound``."""
    if peak_flops_per_sec is None:
        peak_flops_per_sec, _ = peak_flops()
    if peak_bytes_per_sec is None:
        peak_bytes_per_sec, _ = peak_bandwidth()
    if peak_flops_per_sec is not None:
        peak_flops_per_sec *= max(n_devices, 1)
    if peak_bytes_per_sec is not None:
        peak_bytes_per_sec *= max(n_devices, 1)
    flops, nbytes = cost.get("flops"), cost.get("bytes_accessed")
    achieved_f = flops / seconds if flops and seconds else None
    achieved_b = nbytes / seconds if nbytes and seconds else None
    mfu = (
        achieved_f / peak_flops_per_sec
        if achieved_f is not None and peak_flops_per_sec
        else None
    )
    bw_util = (
        achieved_b / peak_bytes_per_sec
        if achieved_b is not None and peak_bytes_per_sec
        else None
    )
    balance = (
        peak_flops_per_sec / peak_bytes_per_sec
        if peak_flops_per_sec and peak_bytes_per_sec
        else None
    )
    return {
        "flops": flops,
        "bytes_accessed": nbytes,
        "flops_per_byte": cost.get("flops_per_byte"),
        "seconds": round(seconds, 6) if seconds is not None else None,
        "achieved_gflops_per_sec": (
            round(achieved_f / 1e9, 3) if achieved_f is not None else None
        ),
        "achieved_gbytes_per_sec": (
            round(achieved_b / 1e9, 3) if achieved_b is not None else None
        ),
        "mfu": round(mfu, 5) if mfu is not None else None,
        "bandwidth_util": round(bw_util, 5) if bw_util is not None else None,
        "bound": roofline_verdict(
            mfu, bw_util, cost.get("flops_per_byte"), balance
        ),
    }


def attribute_card(cost: Dict[str, Any], seconds: Optional[float],
                   n_devices: int = 1) -> Dict[str, Any]:
    """:func:`attribute` on this card's tables, with what the port's
    callers add beside the JAX keys: ``mfu_f32`` (the share of the float32
    table), ``peak_tables`` (which table each share divides by) and, where
    the cost has them, the kernels' declared rows."""
    out = attribute(cost, seconds, n_devices=n_devices)
    kind = device_kind()
    f32, _ = peak_flops_f32(kind)
    flops = cost.get("flops")
    out["mfu_f32"] = (round(flops / seconds / (f32 * max(n_devices, 1)), 5)
                      if flops and seconds and f32 else None)
    out["peak_tables"] = {
        "mfu": "PEAK_BF16_FLOPS" if peak_flops(kind)[0] else None,
        "mfu_f32": "PEAK_F32_FLOPS" if f32 else None,
        "bandwidth_util": "PEAK_HBM_BYTES_PER_SEC" if peak_bandwidth(kind)[0] else None,
        "device_kind": kind,
    }
    if cost.get("kernels"):
        out["kernels"] = cost["kernels"]
    return out


def shares(attr: Dict[str, Any]):
    """The shares of the peaks in an attribution (for the "no share above
    1.0" gates): ``{name: value}`` of those present."""
    return {k: attr[k] for k in ("mfu", "mfu_f32", "bandwidth_util")
            if isinstance(attr.get(k), (int, float))}


def render_cost_table(table: Dict[str, Dict[str, Any]]) -> str:
    """Human table for ``--costs``: one row per program, sorted by name."""
    header = ("program", "flops", "bytes", "flops/byte", "peak_hbm")
    rows = []
    for name in sorted(table):
        entry = table[name]
        if "error" in entry:
            rows.append((name, "(error)", entry["error"][:40], "", ""))
            continue

        def _fmt(v):
            return f"{v:,.0f}" if isinstance(v, (int, float)) else "?"

        peak = entry.get("peak_hbm_bytes")
        rows.append((
            name,
            _fmt(entry.get("flops")),
            _fmt(entry.get("bytes_accessed")),
            str(entry.get("flops_per_byte") or "?"),
            f"{peak / (1 << 20):.2f} MiB" if isinstance(peak, (int, float)) else "?",
        ))
    widths = [
        max(len(header[i]), *(len(r[i]) for r in rows)) if rows else len(header[i])
        for i in range(len(header))
    ]

    def _row(cols):
        return "  ".join(str(c).ljust(w) for c, w in zip(cols, widths))

    return "\n".join(
        [_row(header), _row(["-" * w for w in widths])] + [_row(r) for r in rows]
    )
