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


def test_k5_k6_plain_match_pallas_interpret():
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
