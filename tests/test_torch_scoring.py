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
The density strategy's similarity mass, the cosine matrix and its blocked
reduction agree with the JAX package's to ``similarity.MASS_RTOL`` of the
largest magnitude (float sums in another order); the normalized rows
(``l2_normalize``) are the jitted JAX function's bit for bit at d = 2, 17,
30 and at 5,000 x 30; the mass sharded over 8 data shards
(``parallel.kernels.sharded_similarity_mass``) agrees with JAX's sharded
mass and the port's own to ``MASS_RTOL``, and ``collectives.masked_mean``
over them equals JAX's. A sweep (JAX's
``tests/test_sweep.py`` mesh configuration) and a grid (``tests/test_grid.py``'s)
under the 4 x 2 mesh give each experiment and cell the JAX single-device
serial run's records and the port's final masks; every forest form, fit
and strategy under the mesh (250 rows padded to 252, JAX's
``tests/test_parallel.py`` configuration: the gemm form, the gather form
and depth 12, the host fit with gemm and pallas, density and LAL), per
round and chunked, gives the JAX single-device run's records and the
port's single-device final mask. The multiclass scores
(``trees_multi``: class probabilities, top-2 margin, entropy in XLA's
spelling) at C = 3, 4, 10 and 32, the LAL features, and a LAL regressor
fitted from the committed fixture (its values in the gather form and through
K1's plain version) are bit-equal to the jitted JAX expressions. The
scenario engine's round pieces (the greedy knapsack, label flips, rare
recall, the abstaining reveal) equal the JAX package's, and its validation
refuses with the same messages; and the scenario grid (every family x
entropy and density x 2 seeds in one stream) against the JAX package's
``run_grid``, its serial cells, its fingerprint and its checkpoints.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from distributed_active_learning_tpu.ops import round_fused as j_fused
from distributed_active_learning_tpu.ops import scoring as j_scoring
from distributed_active_learning_tpu.ops import similarity as j_sim
from distributed_active_learning_tpu.ops import trees_pallas as j_pallas
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu.ops import forest_eval as j_eval
from distributed_active_learning_tpu.ops import trees_multi as j_multi
from distributed_active_learning_tpu.models import lal_training as j_lal
from distributed_active_learning_tpu.runtime import state as j_state
from distributed_active_learning_tpu.strategies import lal as j_lal_strategy
from distributed_active_learning_tpu_torch import interop
from distributed_active_learning_tpu_torch.ops import round_fused as t_fused
from distributed_active_learning_tpu_torch.ops import scoring as t_scoring
from distributed_active_learning_tpu_torch.ops import similarity as t_sim
from distributed_active_learning_tpu_torch.ops import trees_gemm as t_gemm
from distributed_active_learning_tpu_torch.ops.xla_f32 import row_sum
from distributed_active_learning_tpu_torch.ops import trees_pallas as t_pallas
from distributed_active_learning_tpu_torch.ops import forest_eval as t_eval
from distributed_active_learning_tpu_torch.ops import trees_multi as t_multi
from distributed_active_learning_tpu_torch.models import lal_training as t_lal
from distributed_active_learning_tpu_torch.strategies import lal as t_lal_strategy
from tests.torch_threads import capped_torch_threads  # noqa: F401  (autouse)

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
    return gf, interop.gemm_forest_from_numpy(*arrays, device="cpu"), rng


def test_score_tables_match_jax(tmp_path):
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

    # The density strategy's similarity mass, the cosine matrix and its
    # blocked reduction: float sums in another order than XLA's, held to
    # MASS_RTOL of the largest magnitude (a zero row takes the eps path).
    rtol = t_sim.MASS_RTOL
    for n, d in ((3000, 7), (20000, 30)):
        xs = rng.normal(size=(n, d)).astype(np.float32)
        xs[7] = 0.0
        m = rng.random(n) < 0.6
        want = np.asarray(jax.jit(j_sim.similarity_mass)(jnp.asarray(xs), jnp.asarray(m)))
        got = t_sim.similarity_mass(torch.from_numpy(xs), torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())
    # The normalized rows bit for bit (the squares summed in XLA's order),
    # then the sharded mass over 8 data shards.
    j_norm = jax.jit(j_sim.l2_normalize)
    for n, d in ((300, 2), (96, 17), (1000, 30), (5000, 30)):
        xn = rng.normal(size=(n, d)).astype(np.float32)
        np.testing.assert_array_equal(
            t_sim.l2_normalize(torch.from_numpy(xn)).numpy().view(np.int32),
            np.asarray(j_norm(jnp.asarray(xn))).view(np.int32))
    from distributed_active_learning_tpu.parallel import kernels as j_par
    from distributed_active_learning_tpu.parallel import make_mesh as j_make_mesh
    from distributed_active_learning_tpu_torch.parallel import kernels as t_par
    from distributed_active_learning_tpu_torch.parallel import mesh as t_mesh

    xs8, m8 = xs[:4000], m[:4000]
    want = np.asarray(jax.jit(j_par.sharded_similarity_mass(j_make_mesh(data=8, model=1)))(
        jnp.asarray(xs8), jnp.asarray(m8)))
    t_m = t_mesh.make_mesh(8, 1, device="cpu")
    got = t_par.sharded_similarity_mass(t_m)(
        t_mesh.shard_rows(torch.from_numpy(xs8), t_m, replicate=True), torch.from_numpy(m8))
    single = t_sim.similarity_mass(torch.from_numpy(xs8), torch.from_numpy(m8))
    for other in (want, single.numpy()):
        np.testing.assert_allclose(got.numpy(), other, rtol=0, atol=rtol * np.abs(want).max())
    # masked_mean over the 8 shards: JAX's under shard_map, bit for bit.
    from jax.sharding import PartitionSpec as P

    from distributed_active_learning_tpu.parallel import collectives as j_coll
    from distributed_active_learning_tpu.utils.compat import shard_map
    from distributed_active_learning_tpu_torch.parallel import collectives as t_coll

    vals = rng.random(4000).astype(np.float32)
    want = shard_map(lambda v, mk: j_coll.masked_mean(v, mk, "data"),
                     mesh=j_make_mesh(data=8, model=1), in_specs=(P("data"), P("data")),
                     out_specs=P())(jnp.asarray(vals), jnp.asarray(m8))
    got = t_coll.masked_mean(torch.from_numpy(vals).chunk(8), torch.from_numpy(m8).chunk(8))
    assert np.float32(want).view(np.int32) == got.numpy().view(np.int32)
    _mesh_sweep_and_grid_match_jax()
    _forms_under_the_mesh_match_jax()

    xs = xs[:700]
    want = np.asarray(j_sim.pairwise_cosine(jnp.asarray(xs)))
    np.testing.assert_allclose(t_sim.pairwise_cosine(torch.from_numpy(xs)).numpy(), want,
                               rtol=0, atol=rtol)
    row_max = np.asarray(j_sim.blocked_pairwise_cosine_reduce(
        jnp.asarray(xs), lambda s_: jnp.max(s_, axis=1), block=256))
    got = t_sim.blocked_pairwise_cosine_reduce(
        torch.from_numpy(xs), lambda s_: s_.max(dim=1).values, block=256).numpy()
    np.testing.assert_allclose(got, row_max, rtol=0, atol=rtol)

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

    _multiclass_and_lal_match_jax()
    _scenario_ops_match_jax()
    _scenario_grid_matches_jax(tmp_path)


def _forms_under_the_mesh_match_jax():
    """Every forest form, fit and strategy on the 4 x 2 mesh, per round and
    chunked where the fit is the device's, against the JAX single-device
    run of the same configuration (records) and the port's (final mask)."""
    import dataclasses

    from distributed_active_learning_tpu import config as j_config
    from distributed_active_learning_tpu.runtime import loop as j_loop
    from distributed_active_learning_tpu_torch import config as t_config
    from distributed_active_learning_tpu_torch.runtime import loop as t_loop

    lal = {"lal_data_path": "tests/fixtures/lal_simulatedunbalanced_big.txt", "lal_trees": 12,
           "lal_depth": 6}
    cases = [dict(kernel="gemm", fit="host"), dict(kernel="pallas", fit="host"),
             dict(kernel="gemm"), dict(kernel="gather"), dict(kernel="pallas", depth=12),
             dict(strategy="density"), dict(strategy="lal")]
    for case in cases:
        strategy = case.get("strategy", "uncertainty")
        j = j_config.ExperimentConfig(
            data=j_config.DataConfig(name="checkerboard2x2", n_samples=250, seed=2),
            forest=j_config.ForestConfig(n_trees=8, max_depth=case.get("depth", 4),
                                         kernel=case.get("kernel", "pallas"),
                                         fit=case.get("fit", "device")),
            strategy=j_config.StrategyConfig(name=strategy, window_size=10,
                                             options=lal if strategy == "lal" else {}),
            n_start=10, max_rounds=3, seed=7)
        want = [(r.round, r.n_labeled, r.accuracy) for r in j_loop.run_experiment(j).records]
        t = t_config.from_dict(dataclasses.asdict(j))
        single = t_loop.run_experiment(t, device="cpu")
        for k in ((1, 4) if case.get("fit", "device") == "device" else (1,)):
            got = t_loop.run_experiment(dataclasses.replace(
                t, mesh=t_config.MeshConfig(4, 2), rounds_per_launch=k), device="cpu")
            assert [(r.round, r.n_labeled, r.accuracy) for r in got.records] == want, (case, k)
            assert torch.equal(got.final_labeled_mask, single.final_labeled_mask), (case, k)


def _mesh_sweep_and_grid_match_jax():
    """A sweep and a grid under the 4 x 2 mesh against the JAX single-device
    serial runs (the JAX package pins its mesh sweep and grid to them), at
    JAX's own tests' configurations; and with the leaf kernel, on a pool
    padded to the data axis (250 rows to 252), against the port's serial
    mesh runs."""
    import dataclasses

    from distributed_active_learning_tpu import config as jc
    from distributed_active_learning_tpu.runtime import loop as j_loop
    from distributed_active_learning_tpu_torch import config as tc
    from distributed_active_learning_tpu_torch.runtime import loop as t_loop
    from distributed_active_learning_tpu_torch.runtime import sweep as t_sweep

    def rec(res):
        return [(r.round, r.n_labeled, r.accuracy) for r in res.records]

    sw = jc.ExperimentConfig(
        data=jc.DataConfig(name="checkerboard2x2", n_samples=200, seed=2),
        forest=jc.ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="gemm",
                               fit_budget=256),
        strategy=jc.StrategyConfig(name="uncertainty", window_size=10),
        n_start=10, max_rounds=3, seed=0, rounds_per_launch=3)
    gr = jc.ExperimentConfig(
        data=jc.DataConfig(name="checkerboard2x2", n_samples=160, seed=2),
        forest=jc.ForestConfig(n_trees=8, max_depth=3, fit="device", kernel="gemm",
                               fit_budget=160),
        strategy=jc.StrategyConfig(name="uncertainty", window_size=10),
        n_start=10, max_rounds=2, seed=0, rounds_per_launch=2, log_every=0)
    mesh = tc.MeshConfig(data=4, model=2)
    t_sw = dataclasses.replace(tc.from_dict(dataclasses.asdict(sw)), mesh=mesh)
    for s, res in zip((5, 6), t_sweep.run_sweep(t_sw, [5, 6], device="cpu")):
        j1 = dataclasses.replace(sw, seed=s, rounds_per_launch=1)
        assert rec(res) == rec(j_loop.run_experiment(j1)), s
        t1 = tc.from_dict(dataclasses.asdict(j1))
        assert torch.equal(res.final_labeled_mask,
                           t_loop.run_experiment(t1, device="cpu").final_labeled_mask)
    t_gr = dataclasses.replace(tc.from_dict(dataclasses.asdict(gr)), mesh=mesh)
    grid = t_sweep.run_grid(t_gr, ["uncertainty", "entropy"], [5], device="cpu")
    for cell in grid.cells:
        j1 = dataclasses.replace(gr, seed=cell.seed, rounds_per_launch=1, strategy=dataclasses.replace(
            gr.strategy, name=cell.strategy, window_size=cell.window))
        assert rec(cell.result) == rec(j_loop.run_experiment(j1)), cell.strategy
    # The leaf kernel on a padded pool, with metrics: each experiment and
    # cell equals its serial run on the mesh (records, metrics, final mask).
    pal = dataclasses.replace(
        t_gr, data=dataclasses.replace(t_gr.data, n_samples=250), collect_metrics=True,
        forest=dataclasses.replace(t_gr.forest, kernel="pallas"))
    for strategies, seeds in ((["uncertainty"], [5, 6]), (["uncertainty", "margin"], [5])):
        runs = (t_sweep.run_sweep(pal, seeds, device="cpu") if len(strategies) == 1 else
                [c.result for c in t_sweep.run_grid(pal, strategies, seeds, device="cpu").cells])
        cells = [(st, sd) for st in strategies for sd in seeds]
        for (st, sd), res in zip(cells, runs):
            serial = t_loop.run_experiment(dataclasses.replace(
                pal, seed=sd, rounds_per_launch=1,
                strategy=dataclasses.replace(pal.strategy, name=st)), device="cpu")
            assert [(r.round, r.n_labeled, r.accuracy, r.metrics) for r in res.records] == [
                (r.round, r.n_labeled, r.accuracy, r.metrics) for r in serial.records], (st, sd)
            assert torch.equal(res.final_labeled_mask, serial.final_labeled_mask)


def _scenario_ops_match_jax():
    """The scenario engine's round pieces against the JAX package's: the
    greedy knapsack (the host-reference and tie cases of
    ``tests/test_scenarios.py`` and random pools with value ties and an
    unaffordable tail: picks, values, keep, spent), the label flips (2 and 4
    classes), rare recall, the abstaining reveal and the scenario
    validation's refusals, message for message."""
    import dataclasses
    import functools

    import pytest

    from distributed_active_learning_tpu import config as j_config
    from distributed_active_learning_tpu.ops import topk as j_topk
    from distributed_active_learning_tpu.scenarios import engine as j_scn
    from distributed_active_learning_tpu.strategies import get_strategy as j_strategy
    from distributed_active_learning_tpu_torch import config as t_config
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.ops import topk as t_topk
    from distributed_active_learning_tpu_torch.runtime import state as t_state
    from distributed_active_learning_tpu_torch.scenarios import engine as t_scn
    from distributed_active_learning_tpu_torch.strategies import get_strategy as t_strategy

    rng = np.random.default_rng(7)
    cases = [(rng.uniform(0.0, 1.0, 64).astype(np.float32),
              rng.uniform(1.0, 5.0, 64).astype(np.float32), rng.uniform(size=64) < 0.7,
              10, 12.0) for _ in range(5)]
    cases.append((np.ones(8, np.float32), np.ones(8, np.float32), np.ones(8, bool), 4, 3.0))
    for _ in range(6):  # value ties, costs of three sizes, budgets that run out early
        n = int(rng.integers(2, 60))
        cases.append((rng.choice([0.0, 0.25, 0.5, 1.0], n).astype(np.float32),
                      rng.choice([1.0, 2.0, 3.0], n).astype(np.float32), rng.random(n) < 0.7,
                      int(rng.integers(1, 12)), float(rng.choice([2.5, 6.0, 100.0]))))
    for scores, costs, mask, k, budget in cases:
        want = jax.jit(functools.partial(j_topk.knapsack_top_k, k=k, budget=budget))(
            jnp.asarray(scores), jnp.asarray(costs), jnp.asarray(mask))
        got = t_topk.knapsack_top_k(torch.from_numpy(scores), torch.from_numpy(costs),
                                    torch.from_numpy(mask), k, budget)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    y = rng.integers(0, 4, 500).astype(np.int32)
    flips = rng.random(500) < 0.3
    for c in (2, 4):
        yc = y % c
        np.testing.assert_array_equal(
            t_scn.apply_flips(torch.from_numpy(yc), torch.from_numpy(flips), c).numpy(),
            np.asarray(j_scn.apply_flips(jnp.asarray(yc), jnp.asarray(flips), c)))
    labeled, valid = rng.random(500) < 0.4, rng.random(500) < 0.9
    for rare in (1, 3, 7):  # 7: an empty class reports 0
        np.testing.assert_array_equal(
            t_scn.rare_recall(torch.from_numpy(labeled), torch.from_numpy(y),
                              torch.from_numpy(valid), rare).numpy(),
            np.asarray(j_scn.rare_recall(jnp.asarray(labeled), jnp.asarray(y),
                                         jnp.asarray(valid), rare)))

    x = rng.normal(size=(40, 2)).astype(np.float32)
    picked = rng.permutation(40)[:12].astype(np.int32)
    keep = rng.random(12) < 0.8
    for seed in (0, 1, 5):
        js = j_state.init_pool_state(x, y[:40] % 2, jax.random.key(seed))
        ts = t_state.init_pool_state(x, y[:40] % 2, prng.key(seed), "cpu")
        want = j_state.reveal_masked(js, jnp.asarray(picked), jnp.asarray(keep),
                                     abstain_key=jax.random.key(seed + 9), abstain_prob=0.4)
        got = t_state.reveal_masked(ts, torch.from_numpy(picked), torch.from_numpy(keep),
                                    abstain_key=prng.key(seed + 9), abstain_prob=0.4)
        np.testing.assert_array_equal(got.labeled_mask.numpy(), np.asarray(want.labeled_mask))
        assert got.round == int(want.round)

    refused = [
        dict(kind="bogus"),
        dict(kind="noisy_oracle", flip_prob=1.5),
        dict(kind="noisy_oracle"),
        dict(kind="noisy_oracle", abstain_prob=0.2),
        dict(kind="cost_budget"),
        dict(kind="cost_budget", cost_budget=3.0, cost_spread=-1.0),
        dict(kind="cost_budget", cost_budget=3.0, strategy="uncertainty"),
        dict(kind="rare_event", rare_class=-1),
        dict(kind="drift"),
        dict(kind="drift", drift_rate=0.1, drift_kind="spin"),
    ]
    for case in refused:
        case = dict(case)
        name = case.pop("strategy", "entropy")
        jc = j_config.ScenarioConfig(**case)
        tc = t_config.ScenarioConfig(**dataclasses.asdict(jc))
        with pytest.raises(ValueError) as want_err:
            j_scn.validate_scenario(jc, strategy=j_strategy(j_config.StrategyConfig(name=name)))
        with pytest.raises(ValueError) as got_err:
            t_scn.validate_scenario(tc, strategy=t_strategy(t_config.StrategyConfig(name=name)))
        assert str(got_err.value) == str(want_err.value), case
    t_scn.validate_scenario(t_config.ScenarioConfig(kind="noisy_oracle", abstain_prob=0.2),
                            max_rounds=3)
    assert t_scn.scenario_from_name("drift", t_config.ScenarioConfig(drift_rate=0.2)).kind == "drift"
    with pytest.raises(ValueError, match="unknown scenario"):
        t_scn.scenario_from_name("bogus")


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


def _multiclass_and_lal_match_jax():
    """The multiclass scores from C probability planes (leaf-like values,
    pure 0s and 1s among them, and their tree means), then the LAL features
    of a pool and a regressor fitted from the fixture (read by the native
    loader in both packages): bit-equal to jitted JAX; and the regressor's
    training rows synthesized by ``generate_lal_dataset`` (2 experiments of
    2 candidates, pool 40, 2 trees of depth 3) bit-equal to the JAX
    package's vmapped generator."""
    rng = np.random.default_rng(7)
    j_scores = jax.jit(lambda p: (j_multi.margin_score_multi(p), j_multi.entropy_multi(p)))
    for C in (3, 4, 10, 32):
        raw = rng.random((3000, C)).astype(np.float32)
        raw[:500] = raw[:500] > 0.7
        raw[500:1000] = np.round(raw[500:1000] * 8) / 8
        probs = (raw / np.maximum(raw.sum(1, keepdims=True), 1e-9)).astype(np.float32)
        probs[1000:1010] = 0.0
        tp = torch.from_numpy(probs)
        jm, je = j_scores(jnp.asarray(probs))
        np.testing.assert_array_equal(_bits(jm), _bits(t_multi.margin_score_multi(tp)), C)
        np.testing.assert_array_equal(_bits(je), _bits(t_multi.entropy_multi(tp)), C)
    # proba_multi and predict_class over the planes of fitted forests.
    planes = [_forest(13, 4, seed=60 + c) for c in range(3)]
    jmf = j_multi.MultiForest(planes=tuple(p[0] for p in planes))
    tmf = t_multi.MultiForest(planes=tuple(p[1] for p in planes))
    x = rng.normal(size=(700, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(jax.jit(j_multi.proba_multi)(jmf, jnp.asarray(x))),
        _bits(t_multi.proba_multi(tmf, torch.from_numpy(x))))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(j_multi.predict_class)(jmf, jnp.asarray(x))),
        t_multi.predict_class(tmf, torch.from_numpy(x)).numpy())

    # The LAL features of a 700-row pool under a 13-tree base forest, with
    # 137 rows labeled.
    gf, tf, _ = planes[0]
    y = (x[:, 0] > 0).astype(np.int32)
    mask = np.zeros(700, dtype=bool)
    mask[rng.choice(700, 137, replace=False)] = True
    js = j_state.init_pool_state(x, y, jax.random.key(0)).replace(labeled_mask=jnp.asarray(mask))
    ts = interop.pool_state_from_numpy(x, y, mask, np.zeros(2, np.uint32), device="cpu")
    jf = jax.jit(j_lal_strategy.lal_features)(gf, js)
    tfeat = t_lal_strategy.lal_features(tf, ts)
    np.testing.assert_array_equal(_bits(jf), _bits(tfeat))
    # The regressor, fitted from the fixture by both packages (scikit-learn),
    # scored over those features in the gather form, and through K1's plain
    # version (the heap packing of its trees) against JAX's Pallas kernel.
    fixture = "tests/fixtures/lal_simulatedunbalanced_big.txt"
    from distributed_active_learning_tpu.data import formats as j_formats
    from distributed_active_learning_tpu_torch.data import formats as t_formats

    raw = t_formats._text_to_matrix(fixture, None)
    np.testing.assert_array_equal(_bits(j_formats._text_to_matrix(fixture, None)), _bits(raw))
    jreg = j_lal.train_lal_regressor(raw[:, :-1], raw[:, -1], n_trees=9, max_depth=7)
    treg = t_lal.train_lal_regressor(raw[:, :-1], raw[:, -1], n_trees=9, max_depth=7)
    for field in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(np.asarray(getattr(jreg, field)),
                                      getattr(treg, field).numpy())
    np.testing.assert_array_equal(_bits(j_eval.value(jreg, jf)), _bits(t_eval.value(treg, tfeat)))
    jk = j_eval.for_kernel(jreg, "pallas")
    tk = t_eval.for_kernel(treg, "pallas")
    np.testing.assert_array_equal(
        _bits(j_pallas.predict_leaves_pallas(jk.gf, jf, interpret=True)),
        _bits(t_pallas.predict_leaves_pallas(tk, tfeat)))
    np.testing.assert_array_equal(_bits(j_eval.value(jk, jf)), _bits(t_eval.value(tk, tfeat)))
    for seed in (0, 1):
        small = dict(seed=seed, n_experiments=2, candidates_per_experiment=2, pool_size=40,
                     n_trees=2, max_depth=3)
        jfe, jta = j_lal.generate_lal_dataset(**small)
        tfe, tta = t_lal.generate_lal_dataset(**small, device="cpu")
        assert tfe.shape == (4, 5)
        np.testing.assert_array_equal(_bits(jfe), _bits(tfe))
        np.testing.assert_array_equal(_bits(jta), _bits(tta))


def _scenario_grid_matches_jax(tmp_path):
    """The scenario grid: the JAX package's scenario families (its
    ``tests/test_scenarios.py`` SCENARIOS and configuration) x entropy and
    density x seeds 0 and 1, 20 cells in one stream, metrics on. Each cell
    equals its serial ``run_experiment`` in the port (records, every metric,
    final mask). Against the JAX package's ``run_grid``: the entropy cells
    bit-equal (records; metrics but pool_entropy, which is held to
    ``POOL_ENTROPY_RTOL``), the density cells in their first round and their
    metric keys (a density pick can differ from JAX's at a tie at score 0,
    where the similarity mass clamps to 0 in one package and not in the other:
    ROADMAP queue 3; the mass agrees only to ``MASS_RTOL``). The scenario
    grid's fingerprint is JAX's, and its ``gridstate_`` files resume across
    both packages to the uninterrupted records."""
    import dataclasses
    import os

    import torch

    from distributed_active_learning_tpu import config as j_config
    from distributed_active_learning_tpu.runtime import checkpoint as j_ckpt
    from distributed_active_learning_tpu.runtime import sweep as j_sweep
    from distributed_active_learning_tpu_torch import config as t_config
    from distributed_active_learning_tpu_torch.runtime import checkpoint as t_ckpt
    from distributed_active_learning_tpu_torch.runtime import loop as t_loop
    from distributed_active_learning_tpu_torch.runtime import sweep as t_sweep
    from distributed_active_learning_tpu_torch.runtime.telemetry import POOL_ENTROPY_RTOL

    kinds = [dict(), dict(kind="noisy_oracle", flip_prob=0.2, abstain_prob=0.3),
             dict(kind="rare_event", rare_class=1), dict(kind="drift", drift_rate=0.3),
             dict(kind="cost_budget", cost_budget=6.0)]
    j_axis = [j_config.ScenarioConfig(**kw) for kw in kinds]
    t_axis = [t_config.ScenarioConfig(**kw) for kw in kinds]
    jcfg = j_config.ExperimentConfig(
        data=j_config.DataConfig(name="checkerboard2x2", n_samples=96, seed=2),
        forest=j_config.ForestConfig(n_trees=4, max_depth=3, fit="device", fit_budget=96),
        strategy=j_config.StrategyConfig(name="entropy", window_size=8), n_start=8,
        max_rounds=3, rounds_per_launch=2, log_every=0, collect_metrics=True)
    tcfg = t_config.from_dict(dataclasses.asdict(jcfg))
    axes = (["entropy", "density"], [0, 1])
    want = j_sweep.run_grid(jcfg, *axes, scenarios=j_axis)
    got = t_sweep.run_grid(tcfg, *axes, scenarios=t_axis, device="cpu")
    assert not got.serial_fallback and len(got.cells) == 20
    rounds = lambda res: [(r.round, r.n_labeled, r.accuracy) for r in res.records]
    for tc, jc in zip(got.cells, want.cells, strict=True):
        assert (tc.strategy, tc.seed, tc.scenario) == (jc.strategy, jc.seed, jc.scenario)
        scn = t_axis[[kw.get("kind", "none") for kw in kinds].index(tc.scenario)]
        serial = t_loop.run_experiment(dataclasses.replace(
            tcfg, seed=tc.seed, rounds_per_launch=1, scenario=scn,
            strategy=dataclasses.replace(tcfg.strategy, name=tc.strategy)), device="cpu")
        assert rounds(tc.result) == rounds(serial), (tc.strategy, tc.scenario, tc.seed)
        assert [r.metrics for r in tc.result.records] == [r.metrics for r in serial.records]
        assert torch.equal(tc.result.final_labeled_mask, serial.final_labeled_mask)
        assert [list(r.metrics) for r in tc.result.records] == [
            list(r.metrics) for r in jc.result.records]
        n = None if tc.strategy == "entropy" else 1
        assert rounds(tc.result)[:n] == rounds(jc.result)[:n], (tc.strategy, tc.scenario)
        if tc.strategy == "entropy":
            for a, b in zip(tc.result.records, jc.result.records):
                for field, v in b.metrics.items():
                    if field == "pool_entropy":
                        assert abs(a.metrics[field] - v) <= POOL_ENTROPY_RTOL * abs(v)
                    else:
                        assert a.metrics[field] == v, (tc.scenario, a.round, field)
    assert got.cell("entropy", "checkerboard2x2", 1, scenario="drift").scenario == "drift"
    assert len(got.results_for("density", scenario="cost_budget")) == 2
    names = [kw.get("kind", "none") for kw in kinds]
    fp_args = (["entropy"] * 5, [0, 1], ["checkerboard2x2"], [8] * 5)
    assert t_ckpt.grid_fingerprint(tcfg, *fp_args, scenarios=names) == j_ckpt.grid_fingerprint(
        jcfg, *fp_args, scenarios=names)
    assert t_ckpt.grid_fingerprint(tcfg, *fp_args) != t_ckpt.grid_fingerprint(
        tcfg, *fp_args, scenarios=names)

    # gridstate_ files across the packages: a noisy oracle and a cost budget
    # x entropy x 2 seeds, 3 rounds; each package's round-2 file resumed by
    # the other to the uninterrupted records.
    j_small, t_small = j_axis[1::3], t_axis[1::3]
    ck = lambda name, r: dict(checkpoint_dir=str(tmp_path / name), checkpoint_every=1,
                              max_rounds=r)
    j_full = j_sweep.run_grid(dataclasses.replace(jcfg, **ck("s_j", 3)), ["entropy"], [0, 1],
                              scenarios=j_small)
    t_full = t_sweep.run_grid(dataclasses.replace(tcfg, **ck("s_t", 3)), ["entropy"], [0, 1],
                              scenarios=t_small, device="cpu")
    assert [rounds(c.result) for c in t_full.cells] == [rounds(c.result) for c in j_full.cells]
    for name in ("s_j", "s_t"):
        os.remove(tmp_path / name / "gridstate_3.npz")
    resumed_t = t_sweep.run_grid(dataclasses.replace(tcfg, **ck("s_j", 1)), ["entropy"], [0, 1],
                                 scenarios=t_small, device="cpu")
    resumed_j = j_sweep.run_grid(dataclasses.replace(jcfg, **ck("s_t", 1)), ["entropy"], [0, 1],
                                 scenarios=j_small)
    for a, b, c in zip(resumed_t.cells, resumed_j.cells, t_full.cells, strict=True):
        assert rounds(a.result) == rounds(b.result) == rounds(c.result), c.scenario
        assert torch.equal(a.result.final_labeled_mask, c.result.final_labeled_mask)
