"""The mesh's kernels of the port against the JAX package's, on the CPU
(the helpers are ``tests/test_torch_mesh.py``'s; the port's 4 x 2 mesh on
``cpu``, the JAX package's on 4 x 2 forced host devices):

- K3's plain version equals JAX's ``fused_votes_pallas`` in interpret mode,
  and the sharded vote count (per-shard K3, one sum over ``model``) equals
  JAX's ``_sharded_fused_votes``;
- the ring merge over duplicate-heavy scores, with ``k`` past a shard's rows,
  equals JAX's ring and the global stable top-k, on every shard;
- ``fused_score_select`` on a sharded forest equals JAX's, values and picks.

A file of its own, so that ``pytest -n --dist loadfile`` runs it beside the
mesh's loop parity instead of after it.
"""

import jax.numpy as jnp
import numpy as np
import torch

from distributed_active_learning_tpu.ops import round_fused as j_fused
from distributed_active_learning_tpu.ops import trees_pallas as j_pallas
from distributed_active_learning_tpu_torch.ops import ring_topk as t_ring
from distributed_active_learning_tpu_torch.ops import round_fused as t_fused
from distributed_active_learning_tpu_torch.ops import trees_pallas as t_pallas
from distributed_active_learning_tpu_torch.ops.topk import NEG_INF
from tests.test_torch_mesh import (
    _duplicate_heavy,
    _forest,
    _jax_ring,
    _meshes,
    _port_ring,
    _sharded_pair,
)
from tests.torch_threads import capped_torch_threads  # noqa: F401  (autouse)


def test_mesh_kernels_match_jax(devices):
    j_mesh, t_m = _meshes(4, 2)

    # K3's plain version at 13 trees (not a multiple of the TPU kernel's
    # 8-tree block), 1,700 rows (past its 1,536-row tile switch).
    gf13, tf13, rng = _forest(13, 4, seed=13)
    x = rng.normal(size=(1700, 5)).astype(np.float32)
    want = np.asarray(j_fused.fused_votes_pallas(gf13, jnp.asarray(x), interpret=True))
    got = t_fused.fused_votes(t_pallas.PallasForest(gf=tf13), torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    # Past the tile limits (depth 9) both packages take the exact gemm form.
    gf9, tf9, rng9 = _forest(3, 9, seed=9)
    x9 = rng9.normal(size=(257, 5)).astype(np.float32)
    before = t_fused.votes_gemm_route_calls
    got9 = t_fused.fused_votes(t_pallas.PallasForest(gf=tf9), torch.from_numpy(x9))
    assert t_fused.votes_gemm_route_calls == before + 1
    np.testing.assert_array_equal(
        np.asarray(j_fused.fused_votes_pallas(gf9, jnp.asarray(x9), interpret=True)),
        got9.numpy())

    # The sharded vote count and the sharded fused selection, 1,702 rows
    # (padded to 1,704: 426 a shard). At 16 trees (8 per model shard, exact
    # 1/T) the port equals JAX's mesh selection. At 14 trees (inexact 1/T)
    # JAX's mesh round divides by T where its single-device round multiplies
    # by f32(1/T) and contracts (ROADMAP queue 3); the port keeps the
    # single-device spelling on every path and equals JAX's single-device
    # selection.
    for n_trees in (16, 14):
        gf, tf, rng = _forest(n_trees, 4, seed=n_trees)
        x = rng.normal(size=(1702, 5)).astype(np.float32)
        sel = rng.random(1702) < 0.8
        j_sh, t_sh = _sharded_pair(gf, tf, j_mesh, t_m)
        np.testing.assert_array_equal(
            np.asarray(j_fused._sharded_fused_votes(j_sh, jnp.asarray(x))),
            t_fused._sharded_fused_votes(t_sh, torch.from_numpy(x)).numpy())
        j_ref = j_sh if n_trees == 16 else j_pallas.PallasForest(gf=gf)
        for name in ("uncertainty", "margin"):
            for k in (10, 600):  # 600 > the 426 rows of a shard: padded windows
                vj, ij = j_fused.fused_score_select(
                    j_ref, jnp.asarray(x), jnp.asarray(sel), name, k)
                vt, it = t_fused.fused_score_select(
                    t_sh, torch.from_numpy(x), torch.from_numpy(sel), name, k)
                np.testing.assert_array_equal(np.asarray(ij), it.numpy())
                np.testing.assert_array_equal(
                    np.asarray(vj).view(np.int32), vt.numpy().view(np.int32))

    # The ring merge: duplicate-heavy scores, k past a shard's 16 rows.
    rng = np.random.default_rng(7)
    scores = _duplicate_heavy(rng, 64)
    mask = rng.integers(0, 2, size=64).astype(bool)
    host = np.where(mask, scores, NEG_INF)
    order = np.lexsort((np.arange(64), -host))  # (value desc, index asc)
    for k in (5, 24):
        j_v, j_i = _jax_ring(j_mesh, jnp.asarray(scores), jnp.asarray(mask), k)
        merged = _port_ring(scores, mask, k, 4)
        want_i = np.concatenate([order, np.full(max(k - 64, 0), t_ring.IDX_SENTINEL)])[:k]
        for s, (v, i) in enumerate(merged):  # every shard converges
            np.testing.assert_array_equal(i.numpy(), j_i[s])
            np.testing.assert_array_equal(v.numpy(), j_v[s])
            np.testing.assert_array_equal(i.numpy(), want_i)
            np.testing.assert_array_equal(v.numpy(), host[order][:k])
