"""Score parity with the JAX package's CPU code, exhaustively.

A hard-vote score takes T + 1 values, so the check covers every vote count of
every forest size from 1 to 256 trees: the port's score table (the one K2 and
the mesh round read, and the unfused strategies' spelling) equals, bit for
bit, JAX's jitted ``round_fused._score_from_votes`` and its strategies' path
(``votes / T`` then the scoring function) for every fused strategy. The
votes reach the jitted function as an argument, so XLA compiles the
arithmetic instead of folding it as constants. Also: the round megakernel's
plain version at 13 trees (an inexact 1/T) picks what JAX's megakernel picks
in interpret mode. And the tree mean and the soft uncertainty score equal
the jitted ``jnp.mean`` expressions at 100 trees and four more tree counts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from distributed_active_learning_tpu.ops import round_fused as j_fused
from distributed_active_learning_tpu.ops import scoring as j_scoring
from distributed_active_learning_tpu.ops import trees_pallas as j_pallas
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu_torch import interop
from distributed_active_learning_tpu_torch.ops import round_fused as t_fused
from distributed_active_learning_tpu_torch.ops import scoring as t_scoring
from distributed_active_learning_tpu_torch.ops import trees_gemm as t_gemm
from distributed_active_learning_tpu_torch.ops.xla_f32 import row_sum
from distributed_active_learning_tpu_torch.ops import trees_pallas as t_pallas

_MAX_T = 256
_STRATEGY_FN = {
    "uncertainty": (j_scoring.uncertainty_score, False),
    "margin": (j_scoring.margin_score, False),
    "entropy": (j_scoring.positive_entropy, True),
    "full_entropy": (j_scoring.full_entropy, True),
}


def _jax_tables(strategy):
    """Every table for T = 1..256 from one jitted program: the fused
    spelling and the strategies' (int votes / T), each directed."""
    fn, higher = _STRATEGY_FN[strategy]

    def tables(v_all):
        fused, unfused, base = [], [], 0
        for T in range(1, _MAX_T + 1):
            v = v_all[base:base + T + 1]
            base += T + 1
            fused.append(j_fused._score_from_votes(v.astype(jnp.float32), T, strategy)[0])
            s = fn(v / T)
            unfused.append(s if higher else -s)
        return jnp.concatenate(fused), jnp.concatenate(unfused)

    v_all = np.concatenate([np.arange(T + 1, dtype=np.int32) for T in range(1, _MAX_T + 1)])
    return [np.asarray(a) for a in jax.jit(tables)(v_all)]


def _forest(n_trees, depth, seed, n_fit=400, d=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_fit, d)).astype(np.float32)
    y = (x[:, 0] + 0.3 * x[:, 1] + 0.5 * rng.normal(size=n_fit) > 0).astype(np.int32)
    b = j_train.make_bins(jnp.asarray(x), 32)
    mask = jnp.asarray(rng.random(n_fit) < 0.4)
    c, yy, w = j_train.gather_fit_window(b.codes, jnp.asarray(y), mask, n_fit)
    f, th, v = j_train.fit_forest_device(
        c, yy, w, b.edges, jax.random.key(seed), n_trees=n_trees, max_depth=depth)
    gf = j_train.heap_gemm_forest(f, th, v, depth)
    arrays = [np.array(a) for a in (gf.feat_ids, gf.thresholds, gf.path, gf.target, gf.value)]
    return gf, interop.gemm_forest_from_numpy(*arrays), rng


def test_score_tables_match_jax():
    for strategy in _STRATEGY_FN:
        j_fused_t, j_unfused_t = _jax_tables(strategy)
        np.testing.assert_array_equal(j_fused_t.view(np.int32), j_unfused_t.view(np.int32))
        got = torch.cat([t_fused.score_table(T, strategy, "cpu") for T in range(1, _MAX_T + 1)])
        bad = np.flatnonzero(got.numpy().view(np.int32) != j_fused_t.view(np.int32))
        assert bad.size == 0, (strategy, bad[:10])

    # The tree mean and the soft score at 100 trees (XLA adds more than 32
    # terms in windows of 32, not in ascending order) and on both sides of
    # the window: bit-equal to the jitted JAX expressions.
    j_mean = jax.jit(lambda a: jnp.mean(a, axis=1))
    j_soft = jax.jit(lambda a: j_scoring.uncertainty_score(jnp.mean(a, axis=1)))
    rng = np.random.default_rng(100)
    for T in (13, 32, 33, 100, 200):
        lv = rng.random((4000, T)).astype(np.float32)
        tl = torch.from_numpy(lv)
        np.testing.assert_array_equal(
            t_gemm.tree_mean(tl).numpy().view(np.int32), np.asarray(j_mean(lv)).view(np.int32))
        soft = t_scoring.uncertainty_score(t_scoring.VoteFraction(row_sum(tl), T))
        np.testing.assert_array_equal(
            soft.numpy().view(np.int32), np.asarray(j_soft(lv)).view(np.int32))

    # The megakernel's plain version at 13 trees: picks and values equal the
    # JAX megakernel's in interpret mode.
    gf, tf, rng = _forest(13, 4, seed=13)
    x = rng.normal(size=(1700, 5)).astype(np.float32)
    sel = rng.random(1700) < 0.8
    for k in (10, 100):
        vj, ij = j_fused.fused_score_select(
            j_pallas.PallasForest(gf=gf), jnp.asarray(x), jnp.asarray(sel), "uncertainty", k)
        vt, it = t_fused.fused_score_select(
            t_pallas.PallasForest(gf=tf), torch.from_numpy(x), torch.from_numpy(sel),
            "uncertainty", k)
        np.testing.assert_array_equal(np.asarray(ij), it.numpy())
        np.testing.assert_array_equal(np.asarray(vj).view(np.int32), vt.numpy().view(np.int32))
