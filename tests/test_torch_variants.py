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
-inf feature left at a -inf threshold."""

import dataclasses
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
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
    return jgf, interop.gemm_forest_from_numpy(**arrays)


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
