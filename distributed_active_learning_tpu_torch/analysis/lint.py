"""Recompile-hazard lint: an AST pass over the port's driver code, the JAX
package's ``analysis/lint.py`` with its rule ids, severities and waivers.

The program auditor (``analysis/auditor.py``) sees what a program ran as;
this pass catches hazards in the Python around it that one run may never
show: host round-trips inside a captured body, and silent recaptures.
The port's "traced program" is a round step that ``runtime.loop.
GraphedChunk`` captures as a CUDA graph, and the service's score endpoint
(``serving/slab.py``). The lint recognises exactly those bodies: a def
whose name is the step handed to ``chunk_of(step, finish, ...)`` (what
``GraphedChunk`` graphs), or the body handed to ``capture_thread_local(
graph, body)`` (a def by name, or a lambda and the defs it calls by name),
with every def nested inside them.

- ``DAL101 synchronize-in-library``: ``torch.cuda.synchronize()``,
  ``Event.synchronize()`` or ``Stream.synchronize()`` in library code
  stalls the host until the device drains. Honest phase timing in the
  drivers carries an inline waiver.
- ``DAL102 host-cast-in-captured-body``: ``float()``/``int()``/``bool()``
  or ``.item()`` on a value inside a captured body reads a tensor back to
  the host: a CUDA graph capture raises on it, and where the step runs
  eagerly (a mesh over cards or processes) every round waits on the device.
- ``DAL103 mutable-closure-in-captured-body``: a captured body closing over
  an enclosing-scope name that is rebound (re-assigned, augmented, a loop
  variable): the graph keeps the tensor it captured, as jit bakes the
  value, and the later rebinding silently does not apply.
- ``DAL104 dict-ordered-static-arg``: ``tuple(d.items())``/``list(d.items())``
  hash by insertion order; two equal configs built in different orders
  then miss a graph cache and recapture. Use ``sorted(d.items())``.

The DAL2xx series is the host-concurrency lint, scoped to the threaded
surfaces (``serving/`` and ``runtime/``: the frontend's dispatcher, the
tenant manager, the precompile worker, telemetry, the round streamer):

- ``DAL201 guarded-attr-mutated-outside-lock``: a class that guards an
  attribute with ``with self._lock:`` somewhere must guard every mutation
  of it. ``__init__`` is exempt (construction is single-threaded).
- ``DAL202 dispatch-under-lock``: a ``torch.*`` call, a ``synchronize()``
  or a kernel's build or launch (``kernels.build_all``, ``kernels.load``)
  inside a ``with self._lock:`` block keeps every other thread out for the
  dispatch's (or the build's) duration.
- ``DAL203 non-atomic-install``: a membership test (``k in self.d`` /
  ``self.d.get(k)``) and a subscript store (``self.d[k] = v``) on the same
  guarded dict in one function but not in one ``with self._lock:`` block:
  two threads both miss, both build, and one install overwrites the other.
- ``DAL204 thread-without-discipline``: ``threading.Thread(...)`` in a
  module with neither a ``.join(...)`` on a thread nor an
  ``atexit.register`` hook.

Waivers: append ``# audit: ok`` (any rule) or ``# audit: ok[DAL101]`` (one
rule) to the offending line; any line of a multi-line call works. For
DAL103 (whose finding anchors to the captured def itself) put the waiver
on the ``def`` line or a decorator line: waivers inside the body are
ignored, so one comment cannot blanket a whole function.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from distributed_active_learning_tpu_torch.analysis.report import Finding

LINT_RULES: Dict[str, Tuple[str, str]] = {
    "DAL101": ("warn", "synchronize() in library code stalls the host on the device"),
    "DAL102": ("error", "float()/int()/bool()/.item() on a tensor inside a body captured "
                        "as a CUDA graph"),
    "DAL103": ("warn", "a captured body closes over a mutated enclosing name"),
    "DAL104": ("warn", "tuple(dict.items()) hashes by insertion order"),
    # host-concurrency series (serving/ + runtime/: the threaded surfaces)
    "DAL201": ("error", "lock-guarded attribute mutated outside its lock"),
    "DAL202": ("warn", "torch dispatch or kernel launch while holding a shared lock"),
    "DAL203": ("error", "non-atomic check-then-install on a guarded dict"),
    "DAL204": ("warn", "threading.Thread without join/atexit discipline"),
}

#: Relative-path prefixes the DAL2xx concurrency rules apply to: the
#: threaded surfaces. The DAL1xx hazards run on every target.
CONCURRENCY_SCOPES = ("serving/", "runtime/")

#: Lock-ish types whose self-attribute instances define a guard.
_LOCK_TYPES = ("Lock", "RLock", "Condition")

#: The capture entry points and the position (and keyword) of the body
#: each takes: ``chunk_of(step, finish, ...)`` (``GraphedChunk`` graphs the
#: step) and ``capture_thread_local(graph, body)``.
_CAPTURE_CALLS = {"chunk_of": (0, "step"), "capture_thread_local": (1, "body")}

_WAIVER_RE = re.compile(r"#\s*audit:\s*ok(?:\[(?P<rules>[A-Z0-9,\s]+)\])?")

_FN = (ast.FunctionDef, ast.AsyncFunctionDef)


def _waivers(source: str) -> Dict[int, Optional[Set[str]]]:
    """Line number -> waived rule ids (None = all rules waived)."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _WAIVER_RE.search(line)
        if m:
            rules = m.group("rules")
            out[i] = (None if rules is None
                      else {r.strip() for r in rules.split(",") if r.strip()})
    return out


def _dotted(expr: ast.expr) -> str:
    if isinstance(expr, ast.Attribute):
        return f"{_dotted(expr.value)}.{expr.attr}"
    if isinstance(expr, ast.Name):
        return expr.id
    return ""


def _scope_defs(scope: ast.AST) -> Set[str]:
    """The names of the defs a scope makes itself (through its control
    flow, not inside nested defs, lambdas or classes)."""
    out: Set[str] = set()

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FN):
                out.add(child.name)
            elif not isinstance(child, (ast.Lambda, ast.ClassDef)):
                walk(child)

    walk(scope)
    return out


def _captured_bodies(tree: ast.Module) -> Tuple[Set[Tuple[int, str]], Set[int]]:
    """``(defs, lambdas)``: the ``(id(scope), name)`` of each def handed to
    a capture entry point, resolved from the call's scope outward to the
    scope that defines it, and the ids of the lambdas handed to one."""
    defs: Set[Tuple[int, str]] = set()
    lambdas: Set[int] = set()

    def resolve(chain, name):
        for scope in reversed(chain):
            if name in _scope_defs(scope):
                defs.add((id(scope), name))
                return

    def walk(node, chain):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Call):
                entry = _CAPTURE_CALLS.get(_dotted(child.func).split(".")[-1])
                if entry is not None:
                    pos, kw = entry
                    body = child.args[pos] if len(child.args) > pos else next(
                        (k.value for k in child.keywords if k.arg == kw), None)
                    if isinstance(body, ast.Name):
                        resolve(chain, body.id)
                    elif isinstance(body, ast.Lambda):
                        lambdas.add(id(body))
                        for n in ast.walk(body.body):
                            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
                                resolve(chain, n.func.id)
            walk(child, chain + [child] if isinstance(child, _FN) else chain)

    walk(tree, [tree])
    return defs, lambdas


def _bound_names(fn: ast.AST) -> Set[str]:
    """Names bound in ONE function's own scope (params + assignments +
    imports + nested def/class names), not descending into nested scopes."""
    bound: Set[str] = set()
    if isinstance(fn, _FN):
        a = fn.args
        for arg in (list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
                    + ([a.vararg] if a.vararg else []) + ([a.kwarg] if a.kwarg else [])):
            bound.add(arg.arg)

    def walk(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (*_FN, ast.ClassDef)):
                bound.add(child.name)
                continue  # nested scope: its bindings are its own
            if isinstance(child, ast.Lambda):
                continue
            if isinstance(child, ast.Name) and isinstance(child.ctx, (ast.Store, ast.Del)):
                bound.add(child.id)
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                for alias in child.names:
                    bound.add((alias.asname or alias.name).split(".")[0])
            walk(child)

    walk(fn)
    return bound


def _rebound_names(fn: ast.AST) -> Set[str]:
    """Names bound more than once (or augmented / loop-bound) in one
    function's own scope: the mutation half of DAL103."""
    counts: Dict[str, int] = {}

    def bump(name: str, n: int = 1):
        counts[name] = counts.get(name, 0) + n

    def walk(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (*_FN, ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(child, ast.AugAssign) and isinstance(child.target, ast.Name):
                bump(child.target.id, 2)  # augmenting is inherently a rebind
            elif isinstance(child, (ast.For, ast.AsyncFor)):
                for t in ast.walk(child.target):
                    if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store):
                        bump(t.id, 2)  # loop vars rebind per iteration
            elif isinstance(child, ast.Name) and isinstance(child.ctx, ast.Store):
                bump(child.id)
            walk(child)

    walk(fn)
    return {name for name, n in counts.items() if n > 1}


def _loaded_names(fn: ast.AST) -> Set[str]:
    """Names loaded anywhere inside a function, nested scopes included."""
    return {node.id for node in ast.walk(fn)
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)}


class _Linter(ast.NodeVisitor):
    def __init__(self, relpath: str, source: str, tree: ast.Module):
        self.relpath = relpath
        self.waivers = _waivers(source)
        self.findings: List[Finding] = []
        self._scopes: List[ast.AST] = [tree]  # the module, then enclosing defs
        self._captured_defs, self._captured_lambdas = _captured_bodies(tree)
        self._capture_depth = 0  # inside a captured body?

    def _waived(self, rule: str, lines) -> bool:
        for line in lines:
            if line in self.waivers:
                waived = self.waivers[line]
                if waived is None or rule in waived:
                    return True
        return False

    def _emit(self, rule: str, node: ast.AST, message: str):
        line = getattr(node, "lineno", 0)
        # A waiver anywhere on the node's own lines counts (a multi-line
        # call's lands on its closing line); a def (DAL103) only on its
        # header, the decorators and the `def` line.
        if isinstance(node, _FN):
            lines = [d.lineno for d in node.decorator_list] + [node.lineno]
        else:
            lines = range(line, getattr(node, "end_lineno", line) + 1)
        if self._waived(rule, lines):
            return
        severity, _ = LINT_RULES[rule]
        self.findings.append(Finding(rule=rule, severity=severity, program=self.relpath,
                                     location=f"{self.relpath}:{line}", message=message))

    # -- function scopes ----------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._visit_fn(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
        self._visit_fn(node)

    def _visit_fn(self, node):
        captured = (id(self._scopes[-1]), node.name) in self._captured_defs
        if captured:
            self._check_mutable_closure(node)
        self._scopes.append(node)
        self._capture_depth += int(captured)
        self.generic_visit(node)
        self._capture_depth -= int(captured)
        self._scopes.pop()

    def visit_Lambda(self, node: ast.Lambda):
        captured = id(node) in self._captured_lambdas
        self._capture_depth += int(captured)
        self.generic_visit(node)
        self._capture_depth -= int(captured)

    def _check_mutable_closure(self, fn: ast.AST):
        """DAL103: free names of a captured def that some enclosing
        function scope both binds and rebinds."""
        free = _loaded_names(fn) - _bound_names(fn)
        for enclosing in reversed(self._scopes[1:]):
            bound = _bound_names(enclosing)
            rebound = _rebound_names(enclosing)
            for name in sorted(free & bound & rebound):
                self._emit(
                    "DAL103", fn,
                    f"captured `{fn.name}` closes over `{name}`, which is rebound in the "
                    "enclosing scope: the CUDA graph keeps the tensor live at its capture "
                    "and the later rebinding silently does not apply")
            free -= bound  # resolved at this level; stop attributing upward

    # -- calls --------------------------------------------------------------

    def visit_Call(self, node: ast.Call):
        fn = node.func
        # DAL101: torch.cuda.synchronize(), event.synchronize(), stream.synchronize()
        if isinstance(fn, ast.Attribute) and fn.attr == "synchronize":
            self._emit(
                "DAL101", node,
                f"{_dotted(fn) or 'synchronize'}() in library code stalls the host until "
                "the device drains; time at the driver boundary or waive with "
                "`# audit: ok[DAL101]` where the sync is the point")
        # DAL102: float()/int()/bool()/.item() inside a captured body
        if self._capture_depth > 0:
            cast = (fn.id if isinstance(fn, ast.Name) and fn.id in ("float", "int", "bool")
                    and node.args else
                    ".item" if isinstance(fn, ast.Attribute) and fn.attr == "item"
                    and not node.args else None)
            if cast is not None:
                self._emit(
                    "DAL102", node,
                    f"{cast}() inside a body captured as a CUDA graph reads a tensor back "
                    "to the host: the capture raises, and where the step runs eagerly "
                    "every round waits on the device")
        # DAL104: tuple(d.items()) / list(d.items())
        if (isinstance(fn, ast.Name) and fn.id in ("tuple", "list") and len(node.args) == 1
                and isinstance(node.args[0], ast.Call)
                and isinstance(node.args[0].func, ast.Attribute)
                and node.args[0].func.attr == "items"):
            self._emit(
                "DAL104", node,
                f"{fn.id}(...items()) preserves dict insertion order; as a cache key two "
                "equal configs can hash differently and recapture; use sorted(...items())")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# DAL2xx: host-concurrency lint (class-scope analysis)
# ---------------------------------------------------------------------------


def _self_attr(expr: ast.expr) -> Optional[str]:
    """``self.X`` -> ``"X"``; anything else -> None."""
    if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        return expr.attr
    return None


def _lock_attrs_of(cls: ast.ClassDef) -> Set[str]:
    """Attribute names the class binds to threading.Lock/RLock/Condition."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        if _dotted(node.value.func).split(".")[-1] not in _LOCK_TYPES:
            continue
        for target in node.targets:
            attr = _self_attr(target)
            if attr is not None:
                out.add(attr)
    return out


def _with_lock_attr(node: ast.With, lock_attrs: Set[str]) -> Optional[str]:
    """The lock attr a ``with self._lock:`` statement holds, or None."""
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr in lock_attrs:
            return attr
    return None


@dataclasses.dataclass
class _AttrEvent:
    """One touch of ``self.<attr>`` inside a method: ``mutate``
    (assignment/augassign/del of the attr or one of its subscripts),
    ``test`` (membership test / ``.get()``) or ``store`` (subscript store),
    and which with-lock block (by id) enclosed it."""

    kind: str
    attr: str
    node: ast.AST
    lock_block: Optional[int]


def _method_events(fn: ast.AST, lock_attrs: Set[str]) -> List[_AttrEvent]:
    events: List[_AttrEvent] = []

    def walk(node: ast.AST, lock_block: Optional[int]):
        for child in ast.iter_child_nodes(node):
            inner = lock_block
            if isinstance(child, ast.With) and _with_lock_attr(child, lock_attrs):
                inner = id(child)
            if isinstance(child, _FN):
                continue  # nested defs run later, on their own thread terms
            if isinstance(child, (ast.Assign, ast.AugAssign)):
                targets = child.targets if isinstance(child, ast.Assign) else [child.target]
                flat = []  # `self.a, self.b = ...` mutates both
                for t in targets:
                    flat.extend(t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t])
                for t in flat:
                    attr = _self_attr(t)
                    if attr is not None:
                        events.append(_AttrEvent("mutate", attr, child, inner))
                    elif isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value)
                        if attr is not None:
                            events.append(_AttrEvent("mutate", attr, child, inner))
                            events.append(_AttrEvent("store", attr, child, inner))
            if isinstance(child, ast.Delete):
                for t in child.targets:
                    attr = _self_attr(t) or (_self_attr(t.value)
                                             if isinstance(t, ast.Subscript) else None)
                    if attr is not None:
                        events.append(_AttrEvent("mutate", attr, child, inner))
            if isinstance(child, ast.Compare) and any(
                    isinstance(op, (ast.In, ast.NotIn)) for op in child.ops):
                for comp in child.comparators:
                    attr = _self_attr(comp)
                    if attr is not None:
                        events.append(_AttrEvent("test", attr, child, inner))
            if (isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute)
                    and child.func.attr == "get"):
                attr = _self_attr(child.func.value)
                if attr is not None:
                    events.append(_AttrEvent("test", attr, child, inner))
            walk(child, inner)

    walk(fn, None)
    return events


def _is_dispatch(call: ast.Call) -> bool:
    """DAL202's dispatches: a ``torch.*`` call, a ``synchronize()``, and a
    kernel's build or launch (``kernels.build_all``, ``kernels.load``, whose
    library a launch is called on)."""
    name = _dotted(call.func)
    return (name.split(".")[0] == "torch" or name in ("kernels.load", "kernels.build_all")
            or isinstance(call.func, ast.Attribute) and call.func.attr == "synchronize")


def _lint_concurrency(linter: _Linter, tree: ast.Module) -> None:
    """The DAL2xx pass: module-level thread discipline + per-class lock
    discipline. Runs only on files under :data:`CONCURRENCY_SCOPES`."""
    # DAL204: a `.join` counts only when its receiver is plausibly a thread
    # (the name a threading.Thread(...) was assigned to, or a thread- or
    # worker-named variable), else any `"\n".join(lines)` would silence it.
    thread_names: Set[str] = set()
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
                and _dotted(n.value.func) in ("threading.Thread", "Thread")):
            continue
        for target in n.targets:
            if isinstance(target, ast.Name):
                thread_names.add(target.id)
            attr = _self_attr(target)
            if attr is not None:
                thread_names.add(attr)

    def _joins_a_thread(call: ast.Call) -> bool:
        if not (isinstance(call.func, ast.Attribute) and call.func.attr == "join"):
            return False
        recv = call.func.value
        name = (recv.id if isinstance(recv, ast.Name)
                else recv.attr if isinstance(recv, ast.Attribute) else "")
        return name in thread_names or bool(re.search(r"thread|worker", name, re.IGNORECASE))

    has_join = any(isinstance(n, ast.Call) and _joins_a_thread(n) for n in ast.walk(tree))
    has_atexit = any(
        isinstance(n, ast.Call) and _dotted(n.func) == "atexit.register"
        for n in ast.walk(tree)
    ) or any(
        isinstance(n, _FN) and any(_dotted(d) == "atexit.register" for d in n.decorator_list)
        for n in ast.walk(tree)
    )
    if not (has_join or has_atexit):
        for n in ast.walk(tree):
            if isinstance(n, ast.Call) and _dotted(n.func) in ("threading.Thread", "Thread"):
                linter._emit(
                    "DAL204", n,
                    "threading.Thread started in a module with no .join() and no "
                    "atexit.register hook: a worker aborted mid-launch at interpreter "
                    "teardown kills the process")

    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        lock_attrs = _lock_attrs_of(cls)
        if not lock_attrs:
            continue
        methods = [m for m in cls.body if isinstance(m, _FN)]
        per_method = {m.name: _method_events(m, lock_attrs) for m in methods}
        # attrs the class treats as lock-guarded: mutated under a with-lock
        # anywhere in the class (lexically: a helper that only runs with the
        # lock already held carries a waiver saying so at the mutation)
        guarded = {ev.attr for events in per_method.values() for ev in events
                   if ev.kind == "mutate" and ev.lock_block is not None} - lock_attrs
        for method in methods:
            events = per_method[method.name]
            if method.name != "__init__":
                for ev in events:
                    if ev.kind == "mutate" and ev.attr in guarded and ev.lock_block is None:
                        linter._emit(
                            "DAL201", ev.node,
                            f"`self.{ev.attr}` is mutated under `with self.<lock>:` "
                            f"elsewhere in {cls.name} but mutated here without it: one "
                            "unguarded writer corrupts the shared state")
            # DAL203: test + store on one guarded dict, not in ONE block
            for attr in {ev.attr for ev in events if ev.kind == "store"} & guarded:
                tests = [ev for ev in events if ev.kind == "test" and ev.attr == attr]
                stores = [ev for ev in events if ev.kind == "store" and ev.attr == attr]
                for store in stores:
                    split = [t for t in tests
                             if t.lock_block is None or store.lock_block is None
                             or t.lock_block != store.lock_block]
                    if tests and len(split) == len(tests):
                        linter._emit(
                            "DAL203", store.node,
                            f"`self.{attr}[...] = ...` and its membership test sit in "
                            "different lock scopes: two threads can both miss and one "
                            "install silently overwrites the other; test and store "
                            "inside ONE `with self.<lock>:` block")

        # DAL202: a dispatch inside any with-lock block. Nested def/lambda
        # bodies are skipped: a callback merely defined under the lock runs
        # later, after release.
        def _calls_skipping_nested_defs(node: ast.AST):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (*_FN, ast.Lambda)):
                    continue
                if isinstance(child, ast.Call):
                    yield child
                yield from _calls_skipping_nested_defs(child)

        for method in methods:
            for node in ast.walk(method):
                if not (isinstance(node, ast.With) and _with_lock_attr(node, lock_attrs)):
                    continue
                for call in _calls_skipping_nested_defs(node):
                    if _is_dispatch(call):
                        linter._emit(
                            "DAL202", call,
                            f"`{_dotted(call.func)}` runs while "
                            f"holding a {cls.name} lock: every other thread stalls behind "
                            "the device dispatch")


def lint_file(path: str, relpath: Optional[str] = None) -> List[Finding]:
    rel = relpath or os.path.basename(path)
    with open(path) as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="lint-parse-failure", severity="error", program=rel,
                        location=f"{rel}:{e.lineno or 0}", message=str(e))]
    linter = _Linter(rel, source, tree)
    linter.visit(tree)
    # The concurrency scope reads the relpath prefix or the file's own
    # parent directory (a serving/ file linted under a bare basename still
    # gets the DAL2xx pass); only the immediate parent counts.
    rel_scoped = rel.replace(os.sep, "/").startswith(CONCURRENCY_SCOPES)
    parent = os.path.basename(os.path.dirname(os.path.abspath(path)))
    path_scoped = any(parent == s.rstrip("/") for s in CONCURRENCY_SCOPES)
    if rel_scoped or path_scoped:
        _lint_concurrency(linter, tree)
    return linter.findings


def default_lint_targets(root: Optional[str] = None) -> List[str]:
    """The port's driver surfaces (``runtime/``, ``strategies/``) and its
    threaded serving layer (``serving/``)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    targets = []
    for sub in ("runtime", "serving", "strategies"):
        d = os.path.join(root, sub)
        targets.extend(os.path.join(d, fn) for fn in sorted(os.listdir(d))
                       if fn.endswith(".py"))
    return targets


def lint_paths(paths: Sequence[str], root: Optional[str] = None) -> List[Finding]:
    if root is None and paths:
        root = os.path.commonpath([os.path.dirname(os.path.abspath(p)) for p in paths])
    findings: List[Finding] = []
    for p in paths:
        rel = os.path.relpath(p, root) if root else os.path.basename(p)
        findings.extend(lint_file(p, rel))
    return findings


def iter_rule_table() -> Iterator[Tuple[str, str, str]]:
    for rule_id, (severity, desc) in LINT_RULES.items():
        yield rule_id, severity, desc
