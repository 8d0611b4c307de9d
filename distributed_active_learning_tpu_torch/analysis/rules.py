"""Invariant rules of the program auditor, over the port's program trace.

Each rule reads ONE traced program (an :class:`~analysis.auditor.
TracedUnit`: its aten operations, its kernel launches, its collectives, its
carry and outputs) and yields :class:`~analysis.report.Finding` records.
The ids and severities are the JAX package's (``analysis/rules.py``);
``python -m distributed_active_learning_tpu_torch.analysis --rules`` prints
the table. Two of the twelve have no exact counterpart in PyTorch and are
not live here; their rows say what holds the invariant in the port
instead (:attr:`Rule.held_by`):

- ``weak-type-output``: PyTorch has no weak types. A Python scalar takes
  part in type promotion by category only, and an output's dtype is fixed
  by its operation; an output whose dtype changes between launches shows
  as ``carry-aval-drift`` on the carry.
- ``donation-not-aliased``: a CUDA graph has static buffers, not donation.
  ``runtime.loop.GraphedChunk`` writes each step's new carry back into the
  buffers it captured, and the carry it returns aliases the one the next
  call takes; any other carry is copied in first.

``f64-aval`` differs too. PyTorch's index dtype is int64: sort, top-k,
argmax and arange return it, and what is computed from such indices alone
stays an index. So int64 is allowed only there: a cast into int64 from a
narrower dtype (``.long()``, ``.to(torch.int64)``, a ``copy_`` into an
int64 tensor) is refused anywhere in the program but ``ops/prng.py``, whose
threefry words live in int64 as PyTorch has no uint32 arithmetic; no carry
leaf but the PRNG key (a ``key`` field) is int64, and an output is int64
only if it is the key or an index. f64 and c128 are refused anywhere but in
``ops/xla_f32.py``, the exact arithmetic that reproduces XLA's float32
rounding (an FMA, a root) through float64 and rounds back at once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from distributed_active_learning_tpu_torch.analysis.report import Finding

#: Operations that read a device tensor back to the host: ``.item()``,
#: ``float()``, ``int()``, ``bool()``, ``.tolist()`` all come down to it.
HOST_SYNC_OPS = frozenset({"_local_scalar_dense"})

#: Operations whose output shape depends on the data: the host waits for
#: the count before it can allocate the output.
DATA_DEPENDENT_OPS = frozenset({"nonzero", "masked_select", "unique", "_unique", "_unique2",
                                "unique_dim", "unique_consecutive", "_unique_consecutive"})

#: The one module whose float64 is sanctioned: exact float32 arithmetic
#: (XLA's single-rounded FMA, a correctly rounded root) through float64,
#: rounded back to float32 before it returns.
EXACT_F64_MODULE = "distributed_active_learning_tpu_torch/ops/xla_f32.py"

#: The one module whose casts into int64 are sanctioned: threefry's uint32
#: words held in int64 (PyTorch has no uint32 arithmetic).
PRNG_MODULE = "distributed_active_learning_tpu_torch/prng.py"

#: Operations whose int64 output is an index whatever their inputs; those
#: of :data:`VALUES_AND_INDICES` return ``(values, indices)``, and only the
#: indices are.
INDEX_OPS = frozenset({"argsort", "argmax", "argmin", "searchsorted", "bucketize", "nonzero",
                       "arange", "randperm"})
VALUES_AND_INDICES = frozenset({"sort", "topk", "max", "min", "kthvalue", "mode", "median",
                                "cummax", "cummin"})

_COPY_OPS = frozenset({"_to_copy", "copy_", "copy", "_copy_from", "_copy_from_and_resize"})
_64BIT_FLOAT = frozenset({"float64", "complex128"})
_NARROW = {"int8": "int8", "bf16": "bfloat16"}

#: The collectives of ``kernels.collective_work`` that move a whole
#: operand to every shard (``all_gather``, ``all_to_all``), which the
#: sanctioned reductions and ring hops (``psum``, ``ppermute``) do not.
GATHER_KINDS = frozenset({"gather", "exchange"})

#: Derived collective budget: this many times the largest input.
COLLECTIVE_BUDGET_FACTOR = 16


def op_info(name: str, args, kwargs, ins, outs) -> Tuple[Tuple[str, object], ...]:
    """What a rule needs of an operation beyond its tensors' dtypes and
    shapes: a copy's source and destination devices, whether an index is a
    boolean mask, whether a repeat's output length depends on the data."""
    info = []
    if name in _COPY_OPS and ins:
        src = ins[-1] if name in ("copy_", "copy", "_copy_from") else ins[0]
        dst = (outs[0].device if outs else ins[0].device)
        if name == "_to_copy" and kwargs.get("device") is not None:
            import torch

            dst = torch.device(kwargs["device"])
        info += [("src", str(src.device)), ("dst", str(dst))]
    if name in ("index", "index_put_", "_index_put_impl_", "index_put") and len(args) > 1:
        if any(getattr(i, "dtype", None) is not None and str(i.dtype) in ("torch.bool",
                                                                           "torch.uint8")
               for i in (args[1] or ())):
            info.append(("bool_index", True))
    if name == "repeat_interleave" and len(args) > 1 and hasattr(args[1], "dtype") and (
            kwargs.get("output_size") is None):
        info.append(("data_dependent", True))
    return tuple(info)


def _device_type(dev: str) -> str:
    return dev.split(":")[0]


def is_host_sync(op: str, ins, info: dict) -> bool:
    """Whether an operation on a device (not the CPU) reads back to the
    host or makes a shape from the data."""
    if not ins or ins[0][2] == "cpu":
        return False
    return (op in HOST_SYNC_OPS or op in DATA_DEPENDENT_OPS or info.get("bool_index", False)
            or info.get("data_dependent", False))


def is_transfer(info: dict) -> bool:
    """Whether a copy goes to the host from a device, or between cards."""
    src, dst = info.get("src"), info.get("dst")
    if src is None or src == dst:
        return False
    if _device_type(dst) == "cpu":
        return _device_type(src) != "cpu"
    return _device_type(src) == "cuda" and _device_type(dst) == "cuda"


def is_int64_cast(op: str, ins, outs) -> bool:
    """Whether an operation casts a narrower tensor into int64 (``.long()``,
    ``.to(torch.int64)``, a ``copy_`` into an int64 tensor)."""
    if op not in _COPY_OPS or not ins or not outs or outs[0][0] != "int64":
        return False
    src = ins[-1] if op in ("copy_", "copy", "_copy_from") else ins[0]
    return src[0] != "int64"


def notable(op: str, ins, outs, info: dict) -> bool:
    """Whether the trace should say where an operation was called (only
    the operations a rule can name: a location costs a stack walk);
    ``ins`` and ``outs`` are ``(dtype, shape, device type)``."""
    return (is_host_sync(op, ins, info) or is_transfer(info) or is_int64_cast(op, ins, outs)
            or any(d in _64BIT_FLOAT for d, _, _ in outs)
            or (any(d in _NARROW.values() for d, _, _ in ins)
                and any(d == "float32" for d, _, _ in outs)))


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rule:
    """A rule: ``check(traced) -> findings``, or None where the port holds
    the invariant another way (``held_by`` says how)."""

    id: str
    severity: str
    description: str
    check: Optional[Callable]
    held_by: Optional[str] = None


RULES: Dict[str, Rule] = {}


def register_rule(rule_id: str, severity: str, description: str):
    def deco(fn):
        RULES[rule_id] = Rule(id=rule_id, severity=severity, description=description, check=fn)
        return fn

    return deco


def held_rule(rule_id: str, severity: str, description: str, held_by: str) -> None:
    """A rule of the JAX package that is not a live check in the port."""
    RULES[rule_id] = Rule(id=rule_id, severity=severity, description=description, check=None,
                          held_by=held_by)


def _finding(rule_id: str, unit, location: str, message: str) -> Finding:
    rule = RULES[rule_id]
    return Finding(rule=rule_id, severity=rule.severity, program=unit.name,
                   location=location, message=message)


def _aval(desc) -> str:
    dtype, shape, dev = desc
    return f"{dtype}{list(shape)}@{dev}"


def _program_ops(unit):
    """The program's own operations (not those of a kernel's body)."""
    return (s for s in unit.ops if s.kernel is None)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


@register_rule(
    "host-callback-in-fast-path",
    "error",
    "no host sync inside a program (a tensor read back to the host: "
    "aten._local_scalar_dense from .item()/float()/int()/bool(), or a "
    "data-dependent shape: nonzero, masked_select, unique, a boolean-mask "
    "index): a CUDA graph capture raises on one, and a step run eagerly "
    "waits on the device every round (the port streams a round after each "
    "replay, never inside a program)",
)
def _rule_host_callback(unit) -> Iterator[Finding]:
    for site in _program_ops(unit):
        if is_host_sync(site.op, site.ins, dict(site.info)):
            what = ("reads a device tensor back to the host" if site.op in HOST_SYNC_OPS
                    else "makes a shape from the data, which the host must wait for")
            yield _finding("host-callback-in-fast-path", unit, site.where,
                           f"aten.{site.op} on {_aval(site.ins[0])} {what} inside the "
                           "program: every round waits on the device, and a CUDA graph "
                           "capture raises")


@register_rule(
    "device-transfer-in-fast-path",
    "error",
    "no copy to the host, or between cards, inside a program outside the "
    "mesh's collectives (parallel/collectives.py, the ring hop): each forces "
    "a transfer (and a wait) per launch",
)
def _rule_device_transfer(unit) -> Iterator[Finding]:
    for site in _program_ops(unit):
        info = dict(site.info)
        if not site.collective and is_transfer(info):
            yield _finding("device-transfer-in-fast-path", unit, site.where,
                           f"aten.{site.op} copies {_aval(site.ins[0])} from {info['src']} to "
                           f"{info['dst']} inside the program, outside the collectives: a "
                           "transfer per launch")


@register_rule(
    "f64-aval",
    "error",
    "no float64/complex128 tensor anywhere in the program (outside "
    "ops/xla_f32.py's exact float32 arithmetic, which rounds back at once); "
    "int64 only as an index (the output of sort, top-k, argmax, arange, ..., "
    "and what is computed from indices alone): no cast into int64 outside "
    "ops/prng.py's threefry words, no int64 carry leaf but the PRNG key, no "
    "int64 output but the key and indices. A 64-bit leak doubles the "
    "bandwidth of the whole chain downstream",
)
def _rule_f64(unit) -> Iterator[Finding]:
    seen = set()

    def once(where, dtype):
        key = (where, dtype)
        if key in seen:
            return False
        seen.add(key)
        return True

    def is_key(path):
        return path.endswith(".key")

    for path, t, _ in unit.in_leaves:
        dtype = str(t.dtype).replace("torch.", "")
        if dtype in _64BIT_FLOAT and once(path, dtype):
            yield _finding("f64-aval", unit, path,
                           f"64-bit input {dtype}{list(t.shape)} in the program")
    for site in _program_ops(unit):
        if not site.location.startswith(EXACT_F64_MODULE):
            for dtype, shape, dev in site.outs:
                if dtype in _64BIT_FLOAT and once(site.where, dtype):
                    yield _finding("f64-aval", unit, site.where,
                                   f"aten.{site.op} makes a 64-bit {dtype}{list(shape)} tensor "
                                   "in the program")
        cast = is_int64_cast(site.op, site.ins, site.outs)
        if cast and not site.location.startswith(PRNG_MODULE) and once(site.where, "int64"):
            src = site.ins[0 if site.op == "_to_copy" else -1]
            yield _finding("f64-aval", unit, site.where,
                           f"aten.{site.op} casts {_aval(src)} into int64 in the program: a "
                           "64-bit tensor where its values need no more than their own width")
    for path, t in unit.carry_out or ():
        dtype = str(t.dtype).replace("torch.", "")
        if (dtype in _64BIT_FLOAT or (dtype == "int64" and not is_key(path))) and once(path,
                                                                                      dtype):
            yield _finding("f64-aval", unit, path,
                           f"64-bit {dtype}{list(t.shape)} in the program's carry: a 64-bit "
                           "buffer every launch")
    for path, t, _ in unit.out_leaves:
        dtype = str(t.dtype).replace("torch.", "")
        wide = dtype in _64BIT_FLOAT or (dtype == "int64" and not is_key(path)
                                         and not unit.is_index(t))
        if wide and once(path, dtype):
            what = ", not an index" if dtype == "int64" else ""
            yield _finding("f64-aval", unit, path,
                           f"64-bit {dtype}{list(t.shape)} in the program's outputs{what}: a "
                           "64-bit buffer every launch")


held_rule(
    "weak-type-output",
    "error",
    "program outputs must not be weakly typed: a weak output rebound as the "
    "next launch's input has a different aval and retriggers compilation",
    "not a live check: PyTorch has no weak types (a Python scalar promotes by "
    "category only and every output has one fixed dtype); an output whose dtype "
    "changes between launches is carry-aval-drift on the carry",
)


@register_rule(
    "carry-aval-drift",
    "error",
    "the carried state's output tensors must equal its input tensors exactly "
    "(count, shape, dtype, device), or the next launch recaptures its graph (a "
    "graph's carry buffers are the captured ones)",
)
def _rule_carry_drift(unit) -> Iterator[Finding]:
    if unit.carry_in is None or unit.carry_out is None:
        return
    ins, outs = unit.carry_in, unit.carry_out
    if len(ins) != len(outs):
        yield _finding("carry-aval-drift", unit, "<carry>",
                       f"carry leaf count changed across the launch: {len(ins)} in, "
                       f"{len(outs)} out")
        return
    for (p_in, a), (_, b) in zip(ins, outs):
        was, now = ((str(t.dtype).replace("torch.", ""), tuple(t.shape), str(t.device))
                    for t in (a, b))
        if was != now:
            yield _finding("carry-aval-drift", unit, p_in,
                           f"carry tensor drifts across the launch: {_aval(was)} in vs "
                           f"{_aval(now)} out: the next launch recaptures")


held_rule(
    "donation-not-aliased",
    "error",
    "a program built with donate_argnums must actually alias its donated "
    "buffers to outputs",
    "not a live check: a CUDA graph has static buffers, not donation; "
    "runtime.loop.GraphedChunk writes each step's new carry back into the carry "
    "buffers it captured and returns them as the carry the next call takes (any "
    "other carry is copied in first)",
)


@register_rule(
    "collective-in-shard-map",
    "error",
    "no gather or all-to-all collective (collectives.owner_gather, "
    "gather_fills, exchange_blocks) in a mesh program; the sums in shard "
    "order and the ring hops are the sanctioned collectives. A program that "
    "declares pool_rows narrows the lint to pool-sized operands or results: "
    "the rebalance epoch's window-sized exchange is sanctioned there, priced "
    "by the bytes budget instead",
)
def _rule_collective_gathers(unit) -> Iterator[Finding]:
    for c in unit.collectives:
        if c["kind"] not in GATHER_KINDS:
            continue
        if unit.pool_rows and not _pool_sized_collective(c, unit):
            continue
        yield _finding("collective-in-shard-map", unit, f"{c['location']}: {c['name']}",
                       f"{c['name']} ({c['kind']}) of {c['operands']} a shard rematerializes "
                       "the sharded axis on every shard")


def _has_pool_dim(shape, pool_rows: int) -> bool:
    return any(isinstance(s, int) and s >= pool_rows for s in shape)


def _pool_rows_dim(shape, unit) -> bool:
    """Whether a dim is the sharded pool's row count: ``pool_rows``, or
    that padded to a multiple of the data shards (a test set of another
    row count is not the pool)."""
    lo = unit.pool_rows
    return any(isinstance(s, int) and lo <= s < lo + max(unit.data_shards, 1) for s in shape)


def _pool_sized_collective(c, unit) -> bool:
    """A collective whose one-shard operand, or gathered result, has the
    pool's rows."""
    for _, shape in c["operands"]:
        if _pool_rows_dim(shape, unit):
            return True
        if c["kind"] == "gather" and shape and _pool_rows_dim((shape[0] * c["shards"],), unit):
            return True
    return False


def collective_traffic(unit) -> List[Tuple[dict, float]]:
    """Every collective of the launch with the bytes one shard's operands
    move (what crosses each link)."""
    return [(c, c["shard_bytes"]) for c in unit.collectives]


@register_rule(
    "replicated-pool-operand",
    "error",
    "a pool-sized operand of a program whose pool is row-sharded must not "
    "enter it replicated (a plain tensor, not parallel.mesh.Sharded): every "
    "device then holds, and streams, the whole pool, which is the footprint "
    "sharding exists to remove",
)
def _rule_replicated_pool(unit) -> Iterator[Finding]:
    if not unit.pool_rows or not unit.sharded:
        return
    for path, t, shards in unit.in_leaves:
        if shards == 0 and _pool_rows_dim(tuple(t.shape), unit):
            yield _finding("replicated-pool-operand", unit, path,
                           f"pool-sized operand {str(t.dtype).replace('torch.', '')}"
                           f"{list(t.shape)} enters the mesh program replicated: every "
                           "shard materializes the whole pool")


@register_rule(
    "pool-scale-collective",
    "error",
    "no collective of a row-sharded program may move a pool-sized operand "
    "(one shard's operand carrying a pool-scale dim means the sharding failed "
    "to divide the pool before the collective ran)",
)
def _rule_pool_scale_collective(unit) -> Iterator[Finding]:
    if not unit.pool_rows or not unit.sharded:
        return
    for c in unit.collectives:
        if any(_pool_rows_dim(shape, unit) for _, shape in c["operands"]):
            yield _finding("pool-scale-collective", unit, f"{c['location']}: {c['name']}",
                           f"{c['name']} moves a pool-scale operand {c['operands']} across "
                           "the mesh: traffic a shard proportional to the whole pool")


@register_rule(
    "collective-bytes-over-budget",
    "error",
    "a program's collective traffic (one shard's operand bytes, summed over "
    "every collective and ring hop of the launch) must stay under 16x its "
    "largest input",
)
def _rule_collective_bytes(unit) -> Iterator[Finding]:
    traffic = collective_traffic(unit)
    if not traffic:
        return
    total = sum(b for _, b in traffic)
    largest = max((t.numel() * t.element_size() * max(shards, 1)
                   for _, t, shards in unit.in_leaves), default=0)
    if not largest:
        return
    budget = COLLECTIVE_BUDGET_FACTOR * largest
    if total <= budget:
        return
    worst, worst_bytes = max(traffic, key=lambda t: t[1])
    sites = len({c["location"] for c, _ in traffic})
    yield _finding("collective-bytes-over-budget", unit,
                   f"{worst['location']}: {worst['name']}",
                   f"collective traffic {total:,.0f} B a launch exceeds the budget "
                   f"{budget:,.0f} B ({len(traffic)} collective call(s) at {sites} site(s); "
                   f"worst: {worst['name']} at {worst_bytes:,.0f} B)")


@register_rule(
    "metrics-missing",
    "error",
    "a program built with with_metrics=True must return RoundMetrics in its "
    "outputs (fused runs otherwise lose per-round observability silently)",
)
def _rule_metrics(unit) -> Iterator[Finding]:
    if unit.with_metrics and "RoundMetrics" not in unit.out_types:
        yield _finding("metrics-missing", unit, "<outputs>",
                       "with_metrics=True but no RoundMetrics in the outputs")


@register_rule(
    "quantized-leaf-upcast",
    "error",
    "a program built with quantized forest storage (ForestConfig.quantize) "
    "must keep the narrow payload live: an int8 or bf16 tensor present (an "
    "input, an operation's result or a kernel's payload), and (int8) no "
    "int8 tensor widened to a pool-sized float32 tensor outside K1-K3, whose "
    "kernels read the narrow payload themselves",
)
def _rule_quantized_upcast(unit) -> Iterator[Finding]:
    mode = unit.quantize
    if mode not in _NARROW:
        return
    narrow = _NARROW[mode]
    item = 1 if mode == "int8" else 2
    present = (any(str(t.dtype).replace("torch.", "") == narrow for _, t, _ in unit.in_leaves)
               or any(d == narrow for s in unit.ops for d, _, _ in s.outs)
               or any(launch.get("item") == item for launch in unit.launches))
    if not present:
        yield _finding("quantized-leaf-upcast", unit, "<trace>",
                       f"quantize={mode!r} declared but no {narrow} tensor exists anywhere in "
                       "the program: the storage was never narrowed")
        return
    if mode != "int8" or not unit.pool_rows:
        # bf16 has no sharper signature (as in the JAX package): bf16 is
        # legitimate all over a program (the fit's bootstrap weights round
        # through it), so its presence is the checkable invariant.
        return
    for site in _program_ops(unit):
        if any(d == narrow for d, _, _ in site.ins) and any(
                d == "float32" and _has_pool_dim(s, unit.pool_rows) for d, s, _ in site.outs):
            yield _finding("quantized-leaf-upcast", unit, site.where,
                           f"aten.{site.op} widens {narrow} to a pool-sized float32 "
                           f"{[list(s) for d, s, _ in site.outs]} outside K1-K3: the "
                           "bandwidth the narrow payload saves is spent")


def default_rules() -> List[Rule]:
    return list(RULES.values())


def rule_table() -> Iterator[Tuple[str, str, str]]:
    """``(id, severity, description)`` of every rule; a held rule's
    description says what holds its invariant in the port."""
    for rule in RULES.values():
        desc = (rule.description if rule.check is not None
                else f"{rule.description} [in the port: {rule.held_by}]")
        yield rule.id, rule.severity, desc
