"""The plain PyTorch versions of the two layout-variant kernels (K5
transposed, K6 segmented) against the JAX package's Pallas kernels in
interpret mode, on one seeded numpy forest and pool per width (13 complete
trees of depth 4; 700 rows; 5 and 30 features): bit-equal, tolerance 0 (the
``hi + lo`` payload is an exact f32 sum of a one-hot product). The flags of
the JAX kernel that only choose an operand type (``int8``) must give the same
bits as the port's one function; ``leaf_f32`` must equal K1's leaves."""

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
