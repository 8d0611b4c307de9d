"""The plain PyTorch versions of the two layout-variant kernels (K5
transposed, K6 segmented) against the JAX package's Pallas kernels in
interpret mode, on one seeded numpy forest and pool per width (13 complete
trees of depth 4; 700 rows; 5 and 30 features): bit-equal, tolerance 0 (the
``hi + lo`` payload is an exact f32 sum of a one-hot product). The flags of
the JAX kernel that only choose an operand type (``int8``) must give the same
bits as the port's one function; ``leaf_f32`` must equal K1's leaves.

The CUDA kernels walk each heap tree from the root; their arithmetic in
plain PyTorch (``walk_transposed_plain``, ``walk_segmented_plain``) must
equal the plain versions bit for bit on the same forests and rows, and on
rows of NaN, +-inf and -inf at nodes whose threshold is -inf or NaN: K6
gives such nodes no slot, so every row goes right there, where K5 sends a
-inf feature left at a -inf threshold.

Also the pre-flight's pieces that need no program run (``analysis/``):
each kernel's declared work reproduces PERF.md section 6's bound column at
its shapes, and a program's count on the CPU is the declared work of the
kernels it calls, whatever computes them (K1, K2, K3, K4, K5, K6 and K7
through their wrappers here, which run the plain versions); ``attribute``
and ``roofline_verdict`` over a grid of costs, seconds, device counts and
explicit peaks equal the JAX package's dicts; findings and reports render
the JAX package's JSON and table; budget tables round-trip and refuse as
the JAX package's do (``vmem_bytes`` by name); ``device_budget("cpu")`` and
``memory_section``'s keys are the JAX package's; the shared-memory mirrors
give the C configuration the card returned (PERF.md)."""

import collections
import dataclasses
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_active_learning_tpu.ops.trees_gemm import GemmForest as JGemmForest
from distributed_active_learning_tpu_torch import interop
from distributed_active_learning_tpu_torch.benches import pallas_variants as t_var
from distributed_active_learning_tpu_torch.ops import trees_pallas as t_pallas
from distributed_active_learning_tpu_torch.ops.trees_train import _heap_path_target
from tests.torch_threads import capped_torch_threads  # noqa: F401  (autouse)


def _jax_script():
    path = os.path.join(os.path.dirname(__file__), "..", "benches", "pallas_variants.py")
    spec = importlib.util.spec_from_file_location("jax_pallas_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _forest(rng, n_trees, depth, d):
    I = (1 << depth) - 1
    path, target = _heap_path_target(depth)
    arrays = dict(
        feat_ids=rng.integers(0, d, size=(n_trees, I)).astype(np.int32),
        thresholds=rng.normal(size=(n_trees, I)).astype(np.float32),
        path=np.broadcast_to(path, (n_trees,) + path.shape).copy(),
        target=np.broadcast_to(target, (n_trees,) + target.shape).copy(),
        value=rng.random((n_trees, I + 1)).astype(np.float32),
    )
    jgf = JGemmForest(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jgf, interop.gemm_forest_from_numpy(**arrays, device="cpu")


def _same_bits(got: torch.Tensor, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    bad = np.flatnonzero(got.numpy().view(np.int32) != want.view(np.int32))
    assert bad.size == 0, (what, bad[:5])


def test_k5_k6_plain_match_pallas_interpret(tmp_path):
    j_var = _jax_script()
    rng = np.random.default_rng(5)
    for d in (5, 30):
        jgf, tgf = _forest(rng, 13, 4, d)
        x = rng.normal(size=(700, d)).astype(np.float32)
        # Some features exactly on a threshold's bf16 rounding, so the compare
        # runs on its boundary.
        feat0, thr0 = np.asarray(jgf.feat_ids)[0], np.asarray(jgf.thresholds)[0]
        for r in range(60):
            x[r, feat0[r % 15]] = thr0[r % 15]
        jx, tx = jnp.asarray(x), torch.from_numpy(x)

        flag_sets = [
            dict(),
            dict(int8=True),
            dict(leaf_f32=True),
            dict(tree_outer=True, bn=256, bt=4),
        ] + [dict(int8=True, ablate=a) for a in ("sel", "cmp", "main", "eq")]
        for flags in flag_sets:
            want = j_var.predict_leaves_transposed(jgf, jx, interpret=True, **flags)
            mine = {k: v for k, v in flags.items() if k != "int8"}
            got = t_var.predict_leaves_transposed(tgf, tx, **mine)
            _same_bits(got, want, (d, flags))
        # leaf_f32 is K1's function; the hi + lo payload is not (it differs
        # from the f32 leaf by the bf16 split's remainder).
        k1 = t_pallas.predict_leaves_plain(tgf, tx)
        assert torch.equal(t_var.predict_leaves_transposed(tgf, tx, leaf_f32=True), k1)
        hl = t_var.predict_leaves_transposed(tgf, tx)
        assert not torch.equal(hl, k1) and float((hl - k1).abs().max()) < 1e-5

        want = j_var.predict_leaves_segmented(jgf, jx, bn=256, bt=8, interpret=True)
        got = t_var.predict_leaves_segmented(tgf, tx, bn=256, bt=8)
        _same_bits(got, want, (d, "segmented"))
        assert torch.equal(got, hl)
        # The packing itself: slot f * S + r, S rounded up to 4.
        p = t_var._prep_segmented(tgf, tx, 256, 8)
        jp = j_var._prep_segmented(jgf, jx, 256, 8)
        assert p.S == jp["dims"][6] and p.S % 4 == 0
        np.testing.assert_array_equal(p.thr.numpy(), np.asarray(jp["thr"]))
        np.testing.assert_array_equal(p.path.numpy(), np.asarray(jp["path"])[:, :16])

        # The kernels' walks, on these rows and on a forest with -inf and NaN
        # thresholds against rows of NaN, +-inf and -inf at those nodes.
        thr_odd = np.asarray(jgf.thresholds).copy()
        thr_odd[:, 1::5], thr_odd[:, 3::7] = -np.inf, np.nan
        tgf_odd = dataclasses.replace(tgf, thresholds=torch.from_numpy(thr_odd))
        x_odd = x.copy()
        x_odd[:3] = np.array([np.nan, np.inf, -np.inf], dtype=np.float32)[:, None]
        for r in range(3, 200):
            x_odd[r, feat0[1 + 5 * (r % 3)]] = -np.inf
        for g, xx in ((tgf, tx), (tgf_odd, torch.from_numpy(x_odd))):
            for leaf_f32 in (False, True):
                p5 = t_var._prep_transposed(g, xx, 256, 4, leaf_f32)
                _same_bits(t_var.walk_transposed_plain(p5),
                           t_var.predict_leaves_transposed_plain(g, xx, leaf_f32).numpy(),
                           (d, "walk", leaf_f32))
            p5 = t_var._prep_transposed(g, xx, 256, 4)
            for a in t_var.ABLATE[1:]:
                _same_bits(t_var.walk_transposed_plain(p5, a),
                           t_var.predict_leaves_transposed_plain(g, xx, ablate=a).numpy(),
                           (d, "walk", a))
            p6 = t_var._prep_segmented(g, xx, 256, 8)
            seg = t_var._segmented_plain(p6)
            _same_bits(t_var.walk_segmented_plain(p6), seg.numpy(), (d, "walk segmented"))
        assert (p6.slot[:13, 1::5] == -1).all() and (p6.slot[:13, 3::7] == -1).all()
        assert not torch.equal(seg, t_var.predict_leaves_transposed_plain(g, xx))
    _preflight_matches_jax(tgf, tx)
    _lint_matches_jax(tmp_path)
    _program_rules_match_jax()


def _preflight_matches_jax(tgf, tx):
    import json

    from distributed_active_learning_tpu.analysis import memory as j_mem
    from distributed_active_learning_tpu.analysis import report as j_report
    from distributed_active_learning_tpu.analysis import roofline as j_roof
    from distributed_active_learning_tpu_torch import kernels, prng
    from distributed_active_learning_tpu_torch.analysis import costs, memory, report, roofline
    from distributed_active_learning_tpu_torch.ops import ring_topk, round_fused, threefry

    # PERF.md section 6's bound column (ms), from the declared work alone.
    def bound_ms(cost):
        flops, nbytes = cost
        return 1e3 * max(nbytes / 3.35e12, flops / 67e12)

    xt_pool = 2 * 32 * (-(-284_807 // 2048) * 2048)
    section6 = (
        (costs.forest_leaves(284_807, 30, 100, 8), 0.0443),
        (costs.forest_leaves(85_443, 30, 100, 8), 0.0134),
        (costs.forest_leaves(71_202, 30, 50, 8), 0.0068),
        (costs.round_megakernel(284_807, 30, 100, 8, 100), 0.0109),
        (costs.fused_votes(71_202, 30, 50, 8), 0.0027),
        (costs.forest_leaves_variant(xt_pool, 284_807, 100, 8), 0.0396),
        (costs.threefry_categorical(64, 50_000, False), 0.0087),
        (costs.threefry_uniform(4096 * 16 * 16 * 32), 0.0616),
    )
    for cost, want in section6:
        assert round(bound_ms(cost), 4) == want, (cost, want)
    assert f"{bound_ms(costs.ring_step([100])):.1e}" == "4.8e-07"  # a hop
    assert costs._ROUND_TILE_ROWS == round_fused.TILE_ROWS

    # On the CPU each wrapper counts its declaration and none of the plain
    # version's operations: the program's count is the kernel's work.
    n, d = tx.shape
    pf = t_pallas.PallasForest(gf=tgf)
    key = prng.key(3)
    windows = [(torch.zeros(100), torch.zeros(100, dtype=torch.int32)) for _ in range(2)]
    dst = [(torch.empty(100), torch.empty(100, dtype=torch.int32)) for _ in range(2)]
    sel, logits = torch.ones(n, dtype=torch.bool), torch.zeros(6, 50)
    calls = (
        (lambda: t_pallas.predict_leaves(pf, tx), "forest_leaves",
         costs.forest_leaves(n, d, 13, 4)),
        (lambda: round_fused._megakernel(pf, tx, sel, "uncertainty", 10), "round_megakernel",
         costs.round_megakernel(n, d, 13, 4, 10)),
        (lambda: round_fused.fused_votes(pf, tx), "fused_votes", costs.fused_votes(n, d, 13, 4)),
        (lambda: ring_topk.ring_step(windows, dst), "ring_hop", costs.ring_step([100, 100])),
        (lambda: t_var.predict_leaves_transposed(tgf, tx, bn=256, bt=4),
         "forest_leaves_transposed", costs.forest_leaves_variant(2 * 32 * 768, n, 13, 4)),
        (lambda: t_var.predict_leaves_segmented(tgf, tx, bn=256, bt=8),
         "forest_leaves_segmented", costs.forest_leaves_variant(2 * 32 * 768, n, 13, 4)),
        (lambda: threefry.uniform(key, (40, 7)), "threefry", costs.threefry_uniform(280)),
        (lambda: threefry.categorical(key, logits, 6), "threefry",
         costs.threefry_categorical(6, 50, True)),
    )
    for fn, name, (flops, nbytes) in calls:
        c = roofline.program_cost(fn)
        assert c["kernels"] == {name: {"calls": 1, "flops": flops, "bytes": nbytes}}, name
        if name != "round_megakernel":  # K2's caller also builds the score table
            assert (c["flops"], c["bytes_accessed"]) == (flops, nbytes), (name, c)
    tally = kernels.WorkTally()
    with kernels.work_tally(tally):
        t_pallas.predict_leaves(pf, tx)
    assert tally.launches == [{"kernel": "forest_leaves", "n": n, "d": d, "n_trees": 13,
                               "depth": 4, "item": 4}]

    # Attribution: the JAX package's dicts on a grid of inputs.
    for flops, nbytes in ((0.0, 0.0), (1e9, 2e10), (5e12, 1e9), (None, 4e8)):
        cost = {"flops": flops, "bytes_accessed": nbytes,
                "flops_per_byte": round(flops / nbytes, 4) if flops and nbytes else None}
        for seconds in (None, 0.0, 1e-4, 0.0235, 3.0):
            for n_dev in (1, 8):
                for peaks in ({}, dict(peak_flops_per_sec=989e12, peak_bytes_per_sec=3.35e12),
                              dict(peak_flops_per_sec=67e12, peak_bytes_per_sec=None)):
                    assert roofline.attribute(cost, seconds, n_devices=n_dev, **peaks) == \
                        j_roof.attribute(cost, seconds, n_devices=n_dev, **peaks)
    for args in ((0.2, 0.3, 1.0, 2.0), (None, None, 0.07, 295.0), (None, None, 400.0, 295.0),
                 (None, None, 0.1, None), (None, None, None, None), (0.5, 0.5, None, None)):
        assert roofline.roofline_verdict(*args) == j_roof.roofline_verdict(*args)
    cpu = roofline.attribute_card({"flops": 1e6, "bytes_accessed": 1e7, "flops_per_byte": 0.1},
                                  1e-3)
    assert cpu["bound"] == "indeterminate:no-peak-table" and cpu["mfu_f32"] is None
    assert roofline.peak_flops("NVIDIA H100 80GB HBM3")[0] == 989e12
    assert roofline.peak_flops_f32("NVIDIA H100 80GB HBM3")[0] == 67e12
    assert roofline.peak_bandwidth("NVIDIA H100 80GB HBM3 (rev 2)")[0] == 3.35e12

    # Findings and reports: the JAX package's JSON and table.
    rows = [("hbm-over-budget", "error", "chunk/uncertainty", "<memory>", "over by 3.00 MiB"),
            ("memory-plan-unavailable", "warn", "neural_chunk/x", "<memory>", "ValueError: x"),
            ("smem-over-budget", "error", "round/u", "forest_leaves", "needs 300,000 bytes")]
    jr = j_report.Report(findings=[j_report.Finding(*r) for r in rows], programs=["a", "b"],
                         skipped={"c": "why"}, stats={"a": {"x": 1}})
    tr = report.Report(findings=[report.Finding(*r) for r in rows], programs=["a", "b"],
                       skipped={"c": "why"}, stats={"a": {"x": 1}})
    assert tr.to_json() == jr.to_json() and tr.render_table() == jr.render_table()
    assert tr.gate("warn") and not report.Report().gate() and str(tr.findings[0]) == \
        str(jr.findings[0])
    assert report.SEVERITIES == j_report.SEVERITIES

    # Budget tables: round trip and validation, as the JAX package's.
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "b.json")
        for doc in ({"hbm_bytes": 1048576, "source": "t"}, {"hbm_bytes": 5e9},
                    {"hbm_bytes": None}):
            with open(path, "w") as f:
                json.dump(doc, f)
            mine, theirs = memory.load_budget_table(path), j_mem.load_budget_table(path)
            assert (mine.hbm_bytes, mine.source) == (theirs.hbm_bytes, theirs.source)
        with open(path, "w") as f:
            json.dump({"hbm_bytes": 1024, "smem_bytes": 4096, "source": "s"}, f)
        assert memory.load_budget_table(path) == memory.MemoryBudget(1024.0, 4096.0, "s")
        for doc, why in (([1], "JSON object"), ({"hbm_bytes": -1}, "positive"),
                         ({"hbm_bytes": True}, "positive"), ({"hbm": 1}, "unknown budget keys"),
                         ({"vmem_bytes": 1}, "smem_bytes")):
            with open(path, "w") as f:
                json.dump(doc, f)
            with pytest.raises(ValueError, match=why):
                memory.load_budget_table(path)
    assert memory.device_budget("cpu").hbm_bytes == j_mem.device_budget("cpu").hbm_bytes
    assert memory.device_budget("cpu").smem_bytes == 232_448
    j_budget, t_budget = j_mem.MemoryBudget(1.0, 2.0, "x"), memory.MemoryBudget(1.0, 2.0, "x")
    j_find = [j_report.Finding(*rows[0])]
    t_find = [report.Finding(*rows[0])]
    table = {"p": {"peak_hbm_bytes": 10.0}, "q": {"error": "E"}}
    assert memory.memory_section(table, t_find, t_budget).keys() == \
        j_mem.memory_section(table, j_find, j_budget).keys()

    # The shared-memory mirrors: the C configuration the H100 returned
    # (opt-in 232,448 bytes a block).
    optin = 232_448
    for kernel, shape, want in (
            ("forest_leaves", (284_807, 30, 100, 8, 4), (256, 8, 64_512)),
            ("forest_leaves", (64, 30, 100, 4, 4), (256, 100, 53_760)),
            ("forest_leaves", (284_807, 30, 100, 8, 1), (256, 8, 52_224)),
            ("round_megakernel", (284_807, 30, 100, 8, 4), ("resident", 8, 100, 114_816)),
            ("fused_votes", (71_202, 30, 50, 8, 4), ("resident", 8, 50, 60_992)),
            ("round_megakernel", (284_807, 30, 256, 8, 4), ("streamed", 8, 32, 205_824)),
            ("fused_votes", (284_807, 30, 256, 8, 2), ("streamed", 8, 32, 172_032)),
            ("round_megakernel", (64, 30, 100, 4, 4), ("resident", 8, 100, 16_016))):
        cfg = memory.smem_for_launch(kernel, *shape, optin)
        got = ((cfg["rows"], cfg["trees_per_chunk"], cfg["smem_bytes"])
               if kernel == "forest_leaves" else
               (cfg["mode"], cfg["groups"], cfg["trees_per_chunk"], cfg["smem_bytes"]))
        assert got == want, (kernel, shape, got)


# ---------------------------------------------------------------------------
# The program auditor and the recompile-hazard lint (analysis/auditor.py,
# rules.py, lint.py) against the JAX package's.
# ---------------------------------------------------------------------------

_CAPTURE = "from distributed_active_learning_tpu_torch.runtime.loop import chunk_of\n"

#: The JAX package's DAL1xx snippets (its tests/test_analysis.py) beside the
#: port's spelling of the same hazard: a sync, a host cast in the traced
#: (captured) body, a closure over a rebound name, an insertion-ordered key.
#: Each pair gives the same (rule, line, severity), waivers included.
_DAL1_PAIRS = (
    ("def f(x):\n    y = g(x)\n    y.block_until_ready()\n    return y\n",
     "def f(x):\n    y = g(x)\n    torch.cuda.synchronize()\n    return y\n"),
    ("def f(x):\n    y = g(x)\n    y.block_until_ready()  # audit: ok[DAL101]\n    return y\n",
     "def f(x):\n    y = g(x)\n    event.synchronize()  # audit: ok[DAL101]\n    return y\n"),
    ("import jax\ndef f(tree):\n    jax.block_until_ready(\n        tree,\n"
     "    )  # audit: ok[DAL101]\n",
     "import torch\ndef f(dev):\n    torch.cuda.synchronize(\n        dev,\n"
     "    )  # audit: ok[DAL101]\n"),
    ("import jax\n@jax.jit\ndef f(x):\n    return float(x) * 2\n",
     _CAPTURE + "def make():\n    def step(x):\n        return float(x) * 2\n"
     "    return chunk_of(step, None, 1)\n"),
    ("def f(x):\n    return float(x) * 2\n", "def f(x):\n    return float(x) * 2\n"),
    ("import jax\n@jax.jit\ndef f(x):\n    def body(c, _):\n        return c + int(x), None\n"
     "    return jax.lax.scan(body, x, None, length=3)\n",
     _CAPTURE + "def make(x):\n    def step(c):\n        def body(c):\n"
     "            return c + int(x), None\n        return body(c)\n"
     "    return chunk_of(step, None, 1)\n"),
    ("import jax\ndef make(n):\n    scale = 1.0\n    scale = scale * n\n    @jax.jit\n"
     "    def f(x):\n        return x * scale\n    return f\n",
     _CAPTURE + "def make(n):\n    scale = 1.0\n    scale = scale * n\n\n"
     "    def step(x):\n        return x * scale, None\n    return chunk_of(step, None, 1)\n"),
    ("import jax\ndef make(n):\n    scale = 1.0\n    scale = scale * n\n    @jax.jit\n"
     "    def f(x):  # audit: ok[DAL103]\n        return x * scale\n    return f\n",
     _CAPTURE + "def make(n):\n    scale = 1.0\n    scale = scale * n\n\n"
     "    def step(x):  # audit: ok[DAL103]\n        return x * scale, None\n"
     "    return chunk_of(step, None, 1)\n"),
    ("import jax\ndef make(n):\n    scale = 1.0\n    scale = scale * n\n    @jax.jit\n"
     "    def f(x):\n        return x * scale  # audit: ok[DAL103]\n    return f\n",
     _CAPTURE + "def make(n):\n    scale = 1.0\n    scale = scale * n\n\n"
     "    def step(x):\n        return x * scale, None  # audit: ok[DAL103]\n"
     "    return chunk_of(step, None, 1)\n"),
    ("import jax\ndef make(scale):\n    @jax.jit\n    def f(x):\n        return x * scale\n"
     "    return f\n",
     _CAPTURE + "def make(scale):\n    def step(x):\n        return x * scale, None\n"
     "    return chunk_of(step, None, 1)\n"),
    ("def key_for(options):\n    return tuple(options.items())\n",) * 2,
    ("def key_for(options):\n    return tuple(sorted(options.items()))\n",) * 2,
)


def _torch_spelling(src: str) -> str:
    """A DAL2xx source with its device dispatch spelled in torch, line for
    line (the port's DAL202 names ``torch.*``, the JAX package's
    ``jax.*``/``jnp.*``)."""
    return (src.replace("import jax.numpy as jnp", "import torch")
            .replace("import jax\n", "import torch\n").replace("jnp.sum(", "torch.sum(")
            .replace("jax.device_put(", "torch.as_tensor("))


def _lint_rows(lint_mod, path, src, rel):
    path.write_text(src)
    return [(f.rule, int(f.location.rsplit(":", 1)[1]), f.severity)
            for f in lint_mod.lint_file(str(path), rel)]


def _lint_matches_jax(tmp_path):
    from distributed_active_learning_tpu.analysis import lint as j_lint
    from distributed_active_learning_tpu_torch.analysis import lint as t_lint
    from tests.test_analysis import _CONCURRENCY_FIXTURE as conc

    assert {k: v[0] for k, v in t_lint.LINT_RULES.items()} == {
        k: v[0] for k, v in j_lint.LINT_RULES.items()}
    assert t_lint.CONCURRENCY_SCOPES == j_lint.CONCURRENCY_SCOPES
    f = tmp_path / "fixture_mod.py"
    fired = set()
    for j_src, t_src in _DAL1_PAIRS:
        want = _lint_rows(j_lint, f, j_src, "fixture_mod.py")
        assert _lint_rows(t_lint, f, t_src, "fixture_mod.py") == want, (t_src, want)
        fired.update(r for r, _, _ in want)
    assert fired == {"DAL101", "DAL102", "DAL103", "DAL104"}
    # The service's capture hands a lambda to capture_thread_local: a read
    # back inside it is a host cast in the captured body.
    lam = ("import torch\nclass S:\n    def capture(self, g):\n"
           "        return capture_thread_local(g, lambda: self._q.sum().item())\n")
    assert _lint_rows(t_lint, f, lam, "fixture_mod.py") == [("DAL102", 4, "error")]

    # DAL2xx: the JAX package's concurrency sources, scoped by relpath.
    sources = [
        conc,
        conc.replace("    def racy_bump(self):\n        self.count += 1",
                     "    def racy_bump(self):\n        self.count += 1  # audit: ok[DAL201]"),
        ("import threading\nclass M:\n    def __init__(self):\n"
         "        self._lock = threading.Lock()\n    def locked(self):\n"
         "        with self._lock:\n            self.a = 1\n    def racy(self, f):\n"
         "        self.a, self.b = f, False\n"),
        ("import threading\nimport jax\nclass M:\n    def __init__(self):\n"
         "        self._lock = threading.Lock()\n        self.x = 0\n    def touch(self):\n"
         "        with self._lock:\n            self.x = 1\n    def deferred(self, x):\n"
         "        with self._lock:\n            def cb():\n"
         "                return jax.device_put(x)\n            self._cb = cb\n"),
        conc.replace("return jnp.sum(x)", "return jnp.sum(x)  # audit: ok[DAL202]"),
        conc.replace("            self._programs[key] = value\n\n    def atomic",
                     "            self._programs[key] = value  # audit: ok[DAL203]\n"
                     "\n    def atomic"),
        conc + "\n    def stop(self):\n        self._thread.join()\n",
        conc.replace("t = threading.Thread(target=self.racy_bump, daemon=True)",
                     "t = threading.Thread(  # audit: ok[DAL204]\n"
                     "            target=self.racy_bump, daemon=True)"),
        conc + "\ndef render(lines):\n    return '\\n'.join(lines)\n",
        conc.replace("        t.start()", "        t.start()\n        t.join()"),
    ]
    fired = set()
    for src in sources:
        for rel in ("serving/fixture.py", "runtime/m.py", "strategies/m.py"):
            want = _lint_rows(j_lint, f, src, rel)
            assert _lint_rows(t_lint, f, _torch_spelling(src), rel) == want, (rel, src, want)
            fired.update(r for r, _, _ in want)
    assert fired >= {"DAL201", "DAL202", "DAL203", "DAL204"}
    # The port's own dispatches under a lock: a kernel's build or launch.
    launch = ("import threading\nclass M:\n    def __init__(self):\n"
              "        self._lock = threading.Lock()\n    def go(self, x):\n"
              "        with self._lock:\n            kernels.build_all()\n"
              "            kernels.load('ring_hop').ring_step(x)\n")
    assert _lint_rows(t_lint, f, launch, "runtime/m.py") == [("DAL202", 7, "warn"),
                                                           ("DAL202", 8, "warn")]
    d = tmp_path / "serving"
    d.mkdir()
    p = d / "mod.py"
    for lint_mod, src in ((j_lint, conc), (t_lint, _torch_spelling(conc))):
        p.write_text(src)
        assert any(x.rule.startswith("DAL2") for x in lint_mod.lint_file(str(p)))
        assert any(x.rule.startswith("DAL2") for x in lint_mod.lint_paths([str(p)]))
    targets = t_lint.default_lint_targets()
    for sub in ("runtime", "serving", "strategies"):
        assert any(f"distributed_active_learning_tpu_torch/{sub}/" in t for t in targets)
    # The port's own surfaces: every finding fixed or waived with a reason.
    assert t_lint.lint_paths(targets) == []


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _program_rules_match_jax():
    """Each planted defect of the JAX package's tests/test_analysis.py
    fires the same rule id and severity on the port's trace; the programs
    of the registry audit clean."""
    import json

    from distributed_active_learning_tpu.analysis import rules as j_rules
    from distributed_active_learning_tpu_torch import config as t_config
    from distributed_active_learning_tpu_torch.analysis import programs
    from distributed_active_learning_tpu_torch.analysis import rules as t_rules
    from distributed_active_learning_tpu_torch.analysis.auditor import (
        AuditUnit,
        OpSite,
        audit_unit,
        run_audit,
    )
    from distributed_active_learning_tpu_torch.ops import ring_topk, xla_f32
    from distributed_active_learning_tpu_torch.parallel import collectives
    from distributed_active_learning_tpu_torch.parallel.mesh import Sharded, Spread

    assert {r.id: r.severity for r in t_rules.default_rules()} == {
        r.id: r.severity for r in j_rules.default_rules()}
    held = {r.id for r in t_rules.default_rules() if r.check is None}
    assert held == {"weak-type-output", "donation-not-aliased"}
    assert all(t_rules.RULES[r].held_by for r in held)

    def fired(findings):
        return {f.rule: f.severity for f in findings}

    def unit(name, fn, *args, **kw):
        return AuditUnit(name=f"fixture/{name}", fn=fn, args=args, **kw)

    def spy(x):
        x[0].item()
        return x * 2

    assert fired(audit_unit(unit("callback", spy, _meta(4)))) == {
        "host-callback-in-fast-path": "error"}
    # The real chunk step, reading its round back each round (a stream
    # done inside the body: the port streams after each replay instead).
    cfg = t_config.ExperimentConfig(
        forest=t_config.ForestConfig(n_trees=8, max_depth=4, kernel="pallas", fit="device"),
        strategy=t_config.StrategyConfig(name="uncertainty", window_size=15), n_start=10,
        rounds_per_launch=2)
    shapes = programs.ForestShapes(300, 2, 100)
    built = programs.specs_for_experiment(cfg, shapes, with_metrics=True)[0].build()

    def streaming(*args):
        out = built.fn(*args)
        out[1][0].item()
        return out

    chunk = AuditUnit.of("fixture/streaming-chunk", dataclasses.replace(built, fn=streaming))
    assert chunk.with_metrics and chunk.carry_in_argnums == (1,)
    assert fired(audit_unit(chunk)) == {"host-callback-in-fast-path": "error"}
    assert fired(audit_unit(unit("device-put", lambda x: x.cpu() + 1, _meta(4)))) == {
        "device-transfer-in-fast-path": "error"}

    # A copy between cards (the meta device has one, so its op is written
    # out): refused outside the collectives, sanctioned inside them.
    class Between:
        name = "fixture/between-cards"

        def __init__(self, collective):
            self.ops = [OpSite("_to_copy", (("float32", (64,), "cuda"),),
                               (("float32", (64,), "cuda"),), None, collective,
                               "runtime/loop.py:1 (step)", (("src", "cuda:0"), ("dst", "cuda:1")))]

    check = t_rules.RULES["device-transfer-in-fast-path"].check
    assert [(f.rule, f.severity) for f in check(Between(False))] == [
        ("device-transfer-in-fast-path", "error")]
    assert not list(check(Between(True)))
    assert fired(audit_unit(unit("f64", lambda x: x.double() * 2.0, _meta(4)))) == {
        "f64-aval": "error"}
    assert not audit_unit(unit("exact-f64", lambda x: xla_f32.fma_f32(x, x, x), _meta(4)))
    # int64: a pool-sized mask cast with .long(), an int64 carry leaf other
    # than the key and an int64 output that is no index are refused; the
    # key in the carry, an index and arithmetic on indices are not.
    got = audit_unit(unit("mask-long", lambda m: torch.cumsum(m.long(), 0), _meta(
        64, dtype=torch.bool), pool_rows=64))
    assert fired(got) == {"f64-aval": "error"} and "casts bool[64]" in got[0].message
    wide = audit_unit(unit("int64-carry", lambda c, x: ((c[0] + 1, c[1]), x), (
        _meta(3, dtype=torch.int64), _meta(2, dtype=torch.int64)), _meta(4),
        carry_in_argnums=(0,), carry_out_index=0))
    assert fired(wide) == {"f64-aval": "error"} and [f.location for f in wide] == [
        "out[0][0]", "out[0][1]"]
    Carry = collections.namedtuple("Carry", "key mask")
    assert not audit_unit(unit("key-carry", lambda c, x: (Carry(c.key + 1, c.mask), torch.sort(
        x).indices[:2] + 1), Carry(_meta(2, dtype=torch.int64), _meta(4, dtype=torch.bool)),
        _meta(4), carry_in_argnums=(0,), carry_out_index=0))
    assert fired(audit_unit(unit("int64-out", lambda x: torch.zeros(4, dtype=torch.int64,
                                                                    device=x.device) + 1,
                                 _meta(4)))) == {"f64-aval": "error"}
    assert fired(audit_unit(unit("carry-drift", lambda s, x: (s.float() + x, x),
                                 _meta(4, dtype=torch.int32), _meta(4),
                                 carry_in_argnums=(0,), carry_out_index=0))) == {
        "carry-aval-drift": "error"}
    assert fired(audit_unit(unit("no-metrics", lambda x: (x * 2, x.sum()), _meta(4),
                                 with_metrics=True))) == {"metrics-missing": "error"}

    def broken(x):
        raise RuntimeError("a bug in the program")

    got = audit_unit(unit("broken", broken, _meta(4)))
    assert [(f.rule, f.severity) for f in got] == [("trace-failure", "error")]
    assert fired(audit_unit(unit("quantize-dropped", lambda x: x * 2.0, _meta(8),
                                 quantize="int8"))) == {"quantized-leaf-upcast": "error"}

    # The sharding rules, on a pool of 64 rows over 4 data shards.
    def pool(rows=64, shards=4):
        return Sharded(blocks=tuple((_meta(rows // shards),) for _ in range(shards)),
                       n_rows=rows)

    def blocks(x):
        return [b[0] for b in x.blocks]

    def all_gather(x):
        return torch.cat(collectives.owner_gather(blocks(x), Spread(1, 4, 1, 0)))

    assert fired(audit_unit(unit("all-gather", all_gather, pool(8)))) == {
        "collective-in-shard-map": "error"}
    assert not audit_unit(unit("psum", lambda x: collectives.vector_accumulate(blocks(x)),
                               pool(8)))

    def replicated(x, w):
        return collectives.vector_accumulate([b * w[:1] for b in blocks(x)]).sum()

    assert fired(audit_unit(unit("replicated-pool", replicated, pool(), _meta(64),
                                 pool_rows=64))) == {"replicated-pool-operand": "error"}
    assert not audit_unit(unit("sharded-pool", lambda x, w: collectives.vector_accumulate(
        [b * c for b, c in zip(blocks(x), blocks(w))]).sum(), pool(), pool(), pool_rows=64))
    assert not audit_unit(unit("no-threshold", replicated, pool(), _meta(64)))

    def pool_gather(x):
        full = all_gather(x)
        return collectives.vector_accumulate([full, full])[:2]

    assert fired(audit_unit(unit("pool-gather", pool_gather, pool(), pool_rows=64))) == {
        "pool-scale-collective": "error", "collective-in-shard-map": "error"}
    assert not audit_unit(unit("shard-psum", lambda x: collectives.vector_accumulate(
        blocks(x)), pool(), pool_rows=64))

    # The byte budget is 16x the largest input: the 64-row float32 pool,
    # 256 B, gives 4,096 B a launch.
    def summed(x, calls=10):
        c = torch.zeros((), device="meta")
        for _ in range(calls):
            c = c + collectives.vector_accumulate(blocks(x)).sum()
        return c

    stats = {}
    assert not audit_unit(unit("coll-bytes", summed, pool()), stats=stats)
    assert stats["collective_bytes"] == 640.0 and stats["collective_sites"] == 1
    over = audit_unit(unit("coll-over", lambda x: summed(x, 100), pool()))
    assert fired(over) == {"collective-bytes-over-budget": "error"}
    assert "6,400 B" in over[0].message and "4,096 B" in over[0].message
    assert "100 collective call(s)" in over[0].message

    def ring(x, rounds=12):  # whole 16-row blocks round the ring, not k-row windows
        wins = [(b, _meta(16, dtype=torch.int32)) for b in blocks(x)]
        return sum(ring_topk.ring_topk(wins, 16)[0][0].sum() for _ in range(rounds))

    stats = {}
    got = audit_unit(unit("pool-ring", ring, pool(), pool_rows=64), stats=stats)
    assert stats["collective_bytes"] == 12 * 3 * 16 * 8
    assert fired(got) == {"collective-bytes-over-budget": "error"}

    def all_to_all(x, epochs=17):  # every shard's whole block to every shard, every epoch
        return [collectives.exchange_blocks([b[None].expand(4, 16).contiguous()
                                             for b in blocks(x)]) for _ in range(epochs)]

    stats = {}
    got = audit_unit(unit("pool-all-to-all", all_to_all, pool(), pool_rows=64), stats=stats)
    assert stats["collective_bytes"] == 17 * 256.0
    assert fired(got) == {"collective-bytes-over-budget": "error"}

    # Clean: the registry (chip_smoke.py's widths, on the meta device), a
    # mesh chunk with its traffic in the report, a neural sweep's lanes.
    specs = programs.build_registry()
    report = run_audit(specs)
    assert report.programs == [s.name for s in specs] and len(specs) == 11
    assert report.findings == [], [str(f) for f in report.findings]
    assert report.stats["chunk/uncertainty-fused"]["launches"] == {
        "forest_leaves": 1, "round_megakernel": 1}
    mesh_cfg = dataclasses.replace(cfg, fused_round=True, mesh=t_config.MeshConfig(4, 2))
    report = run_audit(programs.specs_for_experiment(mesh_cfg, programs.ForestShapes(600, 5,
                                                                                     200)))
    assert report.findings == [], [str(f) for f in report.findings]
    stats = report.stats["chunk/uncertainty-fused/mesh4x2"]
    assert stats["collective_bytes"] > 0 and stats["launches"] == {
        "fused_votes": 8, "ring_hop": 3, "forest_leaves": 8}
    assert json.loads(report.to_json())["program_stats"]["chunk/uncertainty-fused/mesh4x2"]
    lanes = programs.ProgramSpec("neural_sweep/deep.entropy/lanes2", "neural_sweep",
                                 programs.neural_chunk_program(programs.NeuralShapes(
                                     "mlp", (2,), 200, 100, 2, train_steps=3, mc_samples=2,
                                     window=5, hidden=(16,)), lanes=2))
    assert run_audit([lanes]).findings == []
