"""The program auditor: trace the port's programs, apply the rules.

A :class:`TracedUnit` is one launch of a program (a ``ProgramSpec`` of
``analysis/programs.py``, or any :class:`AuditUnit`) run under the cost
model's dispatch mode (``analysis.roofline.cost_mode``, the walk the
roofline counts with), on the meta device by default: its inputs are empty
tensors of the configured shapes, so nothing is allocated or launched and a
284,807-row pool traces in seconds. On the card the same trace runs the
program for real (``chip_smoke.py`` phase 4t). The trace records:

- each aten operation (:class:`OpSite`): its name, the dtype, shape and
  device of its tensor inputs and outputs, the kernel wrapper it runs in
  (its operations are the kernel's, not the program's), whether it runs in
  a collective, and where the port called it;
- each kernel wrapper's launch, under the name and declared work of
  ``analysis/costs.py`` (``kernels.WorkTally``, as the roofline counts it);
- each call into ``parallel/collectives.py`` and each ring hop, with one
  shard's operands and bytes (``kernels.collective_work``);
- the carry's tensors in and out, and the outputs.

On the meta device an operation that needs the data (a host read, a copy
to the host, a data-dependent shape) cannot run: the trace records it and
stands in a value of the right type (a zero, an empty meta tensor), so the
rules name it instead of the trace failing. The trace is the port's
jaxpr: the rules (``analysis/rules.py``) read it and yield
:class:`~analysis.report.Finding` records; :func:`run_audit` gives the
JAX package's ``Report``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from distributed_active_learning_tpu_torch.analysis import rules as rules_lib
from distributed_active_learning_tpu_torch.analysis.report import Finding, Report


@dataclasses.dataclass
class AuditUnit:
    """One auditable program: ``fn(*args)`` is one launch of it, plus the
    invariants it was built to keep.

    ``carry_in_argnums``/``carry_out_index`` name the launch-to-launch
    carry (the chunk steps take it at argument 1, a sweep's at 3, and
    return it at output 0); ``None`` disables the carry rule. ``quantize``:
    the forest storage (``"bf16"``/``"int8"``) the program was built with.
    ``pool_rows``: the pool's rows; the sharding rules, which apply when an
    argument is row-sharded over more than one data shard, read a dim of
    that many rows (padded to the shards) as the pool."""

    name: str
    fn: Any
    args: Tuple[Any, ...]
    with_metrics: bool = False
    carry_in_argnums: Optional[Tuple[int, ...]] = None
    carry_out_index: Optional[int] = None
    quantize: Optional[str] = None
    pool_rows: Optional[int] = None

    @classmethod
    def of(cls, name: str, unit) -> "AuditUnit":
        """The audit unit of a built ``programs.ProgramUnit``."""
        carry = unit.carry_arg
        return cls(name=name, fn=unit.fn, args=unit.args, with_metrics=unit.with_metrics,
                   carry_in_argnums=None if carry is None else (carry,),
                   carry_out_index=None if carry is None else 0, quantize=unit.quantize,
                   pool_rows=unit.pool_rows)


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One aten operation of a trace: ``ins`` and ``outs`` are ``(dtype,
    shape, device type)`` of its tensors; ``kernel`` the kernel wrapper it
    ran inside (None: the program's own); ``collective`` whether it ran in
    a collective; ``location`` where the port called it (``file:line
    (function)``)."""

    op: str
    ins: Tuple[Tuple[str, tuple, str], ...]
    outs: Tuple[Tuple[str, tuple, str], ...]
    kernel: Optional[str]
    collective: bool
    location: str
    info: Tuple[Tuple[str, Any], ...] = ()

    @property
    def where(self) -> str:
        return f"{self.location}: aten.{self.op}"

    def get(self, key: str, default=None):
        return dict(self.info).get(key, default)


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _desc(t) -> Tuple[str, tuple, str]:
    return (_dtype(t), tuple(t.shape), t.device.type)


def leaves(tree, path: str = ""):
    """``(path, tensor, shards)`` of every tensor of an argument tree
    (tensors, tuples, lists, dicts, dataclasses); ``shards`` is the number
    of data shards of a row-sharded array's block (``parallel.mesh.
    Sharded``), 0 for a plain tensor."""
    from distributed_active_learning_tpu_torch.parallel.mesh import Sharded

    if isinstance(tree, torch.Tensor):
        yield path, tree, 0
    elif isinstance(tree, Sharded):
        shards = tree.n_shards or len(tree.blocks)
        for i, reps in enumerate(tree.blocks):
            for j, b in enumerate(reps):
                yield f"{path}.blocks[{i}][{j}]", b, shards
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None)
        for i, t in enumerate(tree):
            yield from leaves(t, f"{path}.{names[i]}" if names else f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k, t in tree.items():
            yield from leaves(t, f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name), f"{path}.{f.name}")


def _type_names(tree, out=None) -> set:
    """The class names of every node of an output tree."""
    out = set() if out is None else out
    out.add(type(tree).__name__)
    if isinstance(tree, (list, tuple)):
        for t in tree:
            _type_names(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _type_names(t, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _type_names(getattr(tree, f.name), out)
    return out


#: Where an operation's call is not: torch, the standard library and this
#: package's ``analysis/`` (the trace itself).
_NOT_THE_CALLER = (os.path.dirname(os.path.abspath(torch.__file__)),
                   os.path.dirname(os.path.abspath(__file__)),
                   os.path.dirname(os.path.abspath(os.__file__)))


def _stand_in(func, args, kwargs):
    """Run one operation; on the meta device, stand in for those that need
    the data (the rules name them): a host read gives a zero of its type, a
    copy off the meta device an empty meta tensor, a data-dependent shape
    an empty one."""
    name = func.overloadpacket.__name__
    src = next((a for a in args if isinstance(a, torch.Tensor)), None)
    if src is None or src.device.type != "meta":
        return func(*args, **kwargs)
    if name == "_local_scalar_dense":
        return (False if src.dtype == torch.bool else 0.0 if src.dtype.is_floating_point
                else 0)
    if name == "_to_copy" and kwargs.get("device") is not None and torch.device(
            kwargs["device"]).type != "meta":
        return torch.empty(src.shape, dtype=kwargs.get("dtype") or src.dtype, device="meta")
    if name == "copy_" and args[0].device.type != "meta":
        return args[0]
    if name == "nonzero":
        return torch.empty((0, src.dim()), dtype=torch.int64, device="meta")
    if name == "masked_select":
        return torch.empty((0,), dtype=src.dtype, device="meta")
    if name == "index" and any(i is not None and i.dtype == torch.bool for i in args[1]):
        idx = [i for i in args[1] if i is not None]
        if len(idx) == 1 and len(args[1]) == 1:
            return torch.empty((0, *src.shape[idx[0].dim():]), dtype=src.dtype, device="meta")
    return func(*args, **kwargs)


class TracedUnit:
    """An :class:`AuditUnit` run once under the trace: what the rules read
    (``ops``, ``kernels``, ``launches``, ``collectives``, ``in_leaves``,
    ``out_leaves``, the carry's leaves in and out, ``out_types``)."""

    def __init__(self, unit: AuditUnit):
        from distributed_active_learning_tpu_torch import kernels
        from distributed_active_learning_tpu_torch.analysis import roofline

        self.name = unit.name
        self.with_metrics = unit.with_metrics
        self.quantize = unit.quantize
        self.pool_rows = unit.pool_rows
        self.ops: List[OpSite] = []
        self._indices = WeakIdKeyDictionary()
        self.in_leaves = list(leaves(unit.args, "args"))
        carry_in = []
        for i in unit.carry_in_argnums or ():
            carry_in.extend((p, t) for p, t, _ in leaves(unit.args[i], f"args[{i}]"))
        tally = kernels.WorkTally(record=True)

        def on_op(func, args, kwargs, out, cost):
            ins = list(roofline._tensors((args, kwargs)))
            outs = list(roofline._tensors(out))
            name = func.overloadpacket.__name__
            kernel = tally.log[-1]["kernel"] if tally.inside and tally.log else None
            info = rules_lib.op_info(name, args, kwargs, ins, outs)
            ins_d, outs_d = tuple(map(_desc, ins)), tuple(map(_desc, outs))
            notable = kernel is None and rules_lib.notable(name, ins_d, outs_d, dict(info))
            self.ops.append(OpSite(
                op=name, ins=ins_d, outs=outs_d, kernel=kernel,
                collective=tally.in_collective > 0,
                location=kernels.caller(_NOT_THE_CALLER) if notable else "", info=info))
            self._mark_indices(name, ins, outs, rules_lib.is_int64_cast(name, ins_d, outs_d))

        mode = roofline.cost_mode(tally, on_op=on_op, run=_stand_in)
        with kernels.work_tally(tally), mode:
            self.out = unit.fn(*unit.args)
        self.kernels = tally.kernels
        self.launches = tally.log
        self.collectives = tally.collectives
        self.out_leaves = list(leaves(self.out, "out"))
        self.carry_in = carry_in if unit.carry_in_argnums is not None else None
        self.carry_out = None
        if unit.carry_out_index is not None:
            self.carry_out = [(p, t) for p, t, _ in leaves(self.out[unit.carry_out_index],
                                                           f"out[{unit.carry_out_index}]")]
        self.out_types = _type_names(self.out)

    def _mark_indices(self, name, ins, outs, cast: bool) -> None:
        """Mark the int64 outputs that are indices: an index operation's,
        and those of an operation (not a cast) whose int64 inputs are all
        indices."""
        longs = [t for t in outs if t.dtype == torch.int64]
        if not longs or cast:
            return
        if name in rules_lib.VALUES_AND_INDICES:
            longs = longs[-1:] if outs[-1].dtype == torch.int64 else []
        elif name not in rules_lib.INDEX_OPS:
            inputs = [t for t in ins if t.dtype == torch.int64]
            if not inputs or not all(t in self._indices for t in inputs):
                return
        for t in longs:
            self._indices[t] = True

    def is_index(self, t: torch.Tensor) -> bool:
        """Whether an int64 tensor of the trace is an index (see
        ``rules.f64-aval``)."""
        return t in self._indices

    @property
    def launch_counts(self) -> dict:
        """Kernel launches of the trace by kernel name."""
        return {k: v["calls"] for k, v in self.kernels.items()}

    @property
    def data_shards(self) -> int:
        """The data shards of the program's row-sharded arguments (0 for
        none)."""
        return max((shards for _, _, shards in self.in_leaves), default=0)

    @property
    def sharded(self) -> bool:
        """Whether an argument is row-sharded over more than one data
        shard (a mesh program whose pool is divided)."""
        return self.data_shards > 1


#: Each kernel wrapper's launch counter (``kernels.count_launch``'s module
#: and name) and the kernel it counts, by its declared name.
LAUNCH_COUNTERS = {
    ("trees_pallas", "launches"): "forest_leaves",
    ("round_fused", "launches"): "round_megakernel",
    ("round_fused", "votes_launches"): "fused_votes",
    ("ring_topk", "launches"): "ring_hop",
    ("threefry", "launches"): "threefry",
}


def kernel_launches(tally: dict) -> dict:
    """A capture's launch tally ``{(module, counter): n}``
    (``kernels.capture_tally``, ``GraphedChunk.launches_per_replay``) by
    kernel name, as a trace's :attr:`TracedUnit.launch_counts` reads."""
    out: dict = {}
    for (mod, counter), n in tally.items():
        if n:
            name = LAUNCH_COUNTERS[(mod.__name__.rsplit(".", 1)[-1], counter)]
            out[name] = out.get(name, 0) + n
    return out


def audit_unit(unit: AuditUnit, rules: Optional[Sequence[rules_lib.Rule]] = None,
               stats: Optional[dict] = None) -> List[Finding]:
    """Trace one program and run every live rule over it. A program that
    fails to trace is itself an error finding (``trace-failure``).
    ``stats`` (a dict) receives the accounting the rules compute on the way:
    the collective traffic of the launch (``collective_bytes``,
    ``collective_sites``) and the kernel launches by name."""
    try:
        traced = TracedUnit(unit)
    except Exception as e:  # noqa: BLE001 - converted into a finding
        return [Finding(rule="trace-failure", severity="error", program=unit.name,
                        location="<trace>", message=f"{type(e).__name__}: {e}")]
    findings: List[Finding] = []
    for rule in rules or rules_lib.default_rules():
        if rule.check is not None:
            findings.extend(rule.check(traced))
    if stats is not None:
        traffic = rules_lib.collective_traffic(traced)
        stats["collective_bytes"] = float(sum(b for _, b in traffic))
        stats["collective_sites"] = len({c["location"] for c, _ in traffic})
        stats["launches"] = traced.launch_counts
    return findings


def run_audit(specs, rules: Optional[Sequence[rules_lib.Rule]] = None,
              device="meta") -> Report:
    """Audit a list of ``analysis.programs.ProgramSpec``, each built on
    ``device`` (the meta device by default): the aggregate
    :class:`~analysis.report.Report`, with each program's collective
    traffic and kernel launches in ``stats``. A spec whose build fails is
    an error finding (``build-failure``)."""
    report = Report()
    for spec in specs:
        report.programs.append(spec.name)
        try:
            unit = AuditUnit.of(spec.name, spec.build(device))
        except Exception as e:  # noqa: BLE001 - a broken build is a finding
            report.findings.append(Finding(rule="build-failure", severity="error",
                                           program=spec.name, location="<build>",
                                           message=f"{type(e).__name__}: {e}"))
            continue
        stats: dict = {}
        report.extend(audit_unit(unit, rules=rules, stats=stats))
        report.stats[spec.name] = stats
    return report
