"""The port's streaming service (``distributed_active_learning_tpu_torch/
serving/``) against the JAX package's, on the CPU, with the same inputs.

- ``ALService``: the JAX serving test's small service (re-fit touchdown at
  the first poll on both sides, ``refit_poll_events=1``, so both packages
  see the same resident forest at every query) through one 14-query stream
  that crosses a slab growth: every query's scores, the refit reasons, fill,
  labeled count, capacity, growths, final mask, key and records are
  bit-equal, RoundMetrics within ``telemetry.POOL_ENTROPY_RTOL``, for
  ``kernel="gemm"`` and ``kernel="pallas"`` (JAX's Pallas kernel on the CPU,
  K1's plain version in the port). A serve checkpoint written by either
  package resumes in the other with bit-equal scores; a host fit, an
  oversized arrival and another service's checkpoint are refused.
- ``TenantManager`` and ``ServiceFrontend``: three tenants, grouped scores
  equal to JAX's and to the single endpoint's, the tenant-axis batched
  re-fit's masks and keys equal to JAX's and to independent services', a
  warmup growth without a precompiled set counted at the first query after
  warmup in both packages, a growth that swaps in a precompiled program set
  with no capture on the request path, the frontend's admission refusal and the cross-wired
  tenant checkpoint refusal.
- The fleet (``serving/fleet.py``): ``HashRing`` placement and walk order
  equal to JAX's for 64 keys over 1-5 nodes; ``_spec_data`` bit-equal; the
  port's ``RouterServer`` against the JAX fleet test's stub workers (a
  healthy echo worker and a sick one) gives JAX's statuses, bodies (the
  binary body byte for byte), ``summary()`` and aggregated ``/metrics``
  text; and a spawned 2-worker ``Fleet(device="cpu")`` of 4 small specs
  scores bit-equal to JAX's ``TenantManager`` built as the JAX worker
  builds it, every worker's ``recompiles_after_warmup`` 0.
- Under the 4 x 2 mesh: the noisy oracle (JAX's ``tests/test_pod_pool.py``
  configuration), per round and chunked, gives the JAX single-device run's
  records (JAX pins its mesh run to it), its flips landing before the pool
  is placed and each shard revealing its own block; ``flip_mask_block``
  equals JAX's and joins to ``flip_mask`` at any shard count; a checkpoint
  written by a chunked run on a 3-shard mesh resumes on one device as the
  JAX package's per-round mesh run does (JAX's
  ``test_checkpoint_mesh_switch_resumes``); the per-shard ``[S]`` fill
  watermark equals JAX's and its masks and count equal the scalar's, and
  ``save_serve`` writes the scalar's file from it and refuses one with gaps
  with JAX's message.
- The pod (``serving/slab.py``'s pod half, ``ops/ring_topk.remap_indices``)
  on a (4, 1) mesh against JAX's, bit for bit: placement and refusals, the
  rebalance plan, ingest, an epoch and its index map, growth, the
  hysteresis, and the fused select over the ingest-built pool (K3 and K4's
  plain versions here).
"""

import dataclasses
import json
import os
import shutil
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from distributed_active_learning_tpu import config as j_config
from distributed_active_learning_tpu.runtime import checkpoint as j_ckpt
from distributed_active_learning_tpu.serving import drift as j_drift
from distributed_active_learning_tpu.serving import fleet as j_fleet
from distributed_active_learning_tpu.serving.service import ALService as JALService
from distributed_active_learning_tpu.serving.tenants import TenantManager as JTenantManager
from distributed_active_learning_tpu_torch import config as t_config
from distributed_active_learning_tpu.runtime.results import ExperimentResult as JResult
from distributed_active_learning_tpu_torch.runtime import checkpoint as t_ckpt
from distributed_active_learning_tpu_torch.runtime.results import ExperimentResult as TResult
from distributed_active_learning_tpu_torch.runtime import telemetry as t_telemetry
from distributed_active_learning_tpu_torch.serving import drift as t_drift
from distributed_active_learning_tpu_torch.serving import fleet as t_fleet
from distributed_active_learning_tpu_torch.serving import slab as t_slab
from distributed_active_learning_tpu_torch.serving.frontend import AdmissionError, ServiceFrontend
from distributed_active_learning_tpu_torch.serving.service import ALService as TALService
from distributed_active_learning_tpu_torch.serving.tenants import TenantManager as TTenantManager
from tests.torch_threads import capped_torch_threads  # noqa: F401  (autouse)


def _points(n, d=4, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) + shift
    y = (x[:, 0] + 0.3 * x[:, 1] > shift).astype(np.int32)
    return x, y


def _cfgs(pkg, kernel="gemm", seed=0, strategy="uncertainty", **serve_kw):
    """The JAX serving test's ``_service_cfg`` in ``pkg``'s config classes,
    with the touchdown at the first poll."""
    cfg = pkg.ExperimentConfig(
        forest=pkg.ForestConfig(n_trees=6, max_depth=3, max_bins=8, fit="device", fit_budget=64,
                                kernel=kernel),
        strategy=pkg.StrategyConfig(name=strategy, window_size=4),
        n_start=6, log_every=0, seed=seed)
    serve = pkg.ServeConfig(**{**dict(
        slab_rows=64, ingest_block=16, score_width=16, refit_rounds=2, drift_entropy_shift=0.2,
        drift_min_fresh=8, max_staleness=5, refit_poll_events=1), **serve_kw})
    return cfg, serve


def _drive(svc, tx):
    """The JAX serving test's stream: 14 queries, a 16-row block of the
    shifted stream every third, across the 64-row slab boundaries."""
    rng = np.random.default_rng(2)
    sx, sy = _points(128, seed=3, shift=2.0)
    pos, scores = 0, []
    for i in range(14):
        if i % 3 == 0 and pos < sx.shape[0]:
            svc.submit(sx[pos: pos + 16], sy[pos: pos + 16])
            pos += 16
        scores.append(svc.score(tx[rng.integers(0, 32, size=8)]))
    svc.flush()
    return scores


def _records(result):
    return [(r.round, r.n_labeled, r.n_unlabeled, np.float32(r.accuracy)) for r in result.records]


def _assert_metrics_close(a, b):
    for ra, rb in zip(a.records, b.records, strict=True):
        assert ra.metrics.keys() == rb.metrics.keys()
        for k in ra.metrics:
            np.testing.assert_allclose(ra.metrics[k], rb.metrics[k],
                                       rtol=t_telemetry.POOL_ENTROPY_RTOL, err_msg=k)


def _pod_parity():
    """The pod half of the slab pool against the JAX package's on a (4, 1)
    mesh of host devices, at ``tests/test_pod_pool.py``'s sizes (4
    features, 8 bins, 64-row slab, 32 start rows). Everything is compared
    bit for bit: the placement and its two refusals, ``rebalance_plan`` on
    seeded fill vectors, every leaf after interleaved routed ingest, one
    epoch and one growth, the epoch's ``moved_src``/``moved_dst`` and
    ``remap_indices`` over them, ``RebalanceHysteresis``'s decisions and
    counters, and the fused select over the ingest-built pool (values and
    indices; the port's shards on the CPU take K3's and K4's plain
    versions)."""
    import jax.numpy as jnp

    from distributed_active_learning_tpu.ops import ring_topk as j_ring
    from distributed_active_learning_tpu.ops import round_fused as j_rf
    from distributed_active_learning_tpu.ops import trees_train as j_tt
    from distributed_active_learning_tpu.ops.trees_pallas import ShardedPallasForest as JSPF
    from distributed_active_learning_tpu.parallel import make_mesh as j_make_mesh
    from distributed_active_learning_tpu.serving import slab as j_slab
    from distributed_active_learning_tpu_torch import interop, serving as t_serving
    from distributed_active_learning_tpu_torch.ops import ring_topk as t_ring
    from distributed_active_learning_tpu_torch.ops import round_fused as t_rf
    from distributed_active_learning_tpu_torch.ops.trees_pallas import attach_mesh
    from distributed_active_learning_tpu_torch.parallel import make_mesh as t_make_mesh
    from distributed_active_learning_tpu_torch.parallel import gather as t_gather

    rng = np.random.default_rng(11)
    x0 = rng.normal(size=(32, 4)).astype(np.float32)
    y0 = (x0[:, 0] > 0).astype(np.int32)
    mask0 = np.zeros(32, bool)
    mask0[rng.permutation(32)[:12]] = True
    xa = rng.normal(size=(40, 4)).astype(np.float32)
    ya = (xa[:, 0] > 0).astype(np.int32)
    j_edges = j_tt.make_bins(jnp.asarray(x0), 8).edges
    t_edges = torch.as_tensor(np.array(j_edges))
    jmesh = j_make_mesh(data=4, model=1, devices=jax.devices()[:4])
    tmesh = t_make_mesh(4, 1, device="cpu")

    def start(pkg_slab, edges, to):
        return pkg_slab.init_slab_pool(to(x0), to(y0), to(mask0), edges, 64)

    jp = j_slab.shard_slab_pool(start(j_slab, j_edges, jnp.asarray), jmesh)
    tp = t_slab.shard_slab_pool(start(t_slab, t_edges, torch.as_tensor), tmesh)

    def leaves_equal(j, t, what):
        for f in ("x", "oracle_y", "labeled_mask", "codes", "n_filled"):
            np.testing.assert_array_equal(np.asarray(jax.device_get(getattr(j, f))),
                                          t_gather(getattr(t, f)).numpy(), err_msg=f"{what} {f}")
        assert j.capacity == t.capacity

    leaves_equal(jp, tp, "placed")
    odd = t_slab.init_slab_pool(np.zeros((66, 4), np.float32), np.zeros(66, np.int32),
                                np.zeros(66, bool), t_edges, 66)
    with pytest.raises(ValueError, match="not divisible"):
        t_slab.shard_slab_pool(odd, tmesh)
    with pytest.raises(ValueError, match="does not match the data axis"):
        t_slab.shard_slab_pool(start(t_slab, t_edges, torch.as_tensor).replace(
            n_filled=torch.zeros(3, dtype=torch.int32)), tmesh)
    for _ in range(6):
        fills = rng.integers(0, 40, size=int(rng.integers(1, 9)))
        for block in (1, 4, 16):
            np.testing.assert_array_equal(np.asarray(j_slab.rebalance_plan(jnp.asarray(fills), block)),
                                          t_slab.rebalance_plan(torch.as_tensor(fills), block).numpy())
        assert t_slab.route_to_shard(fills) == j_slab.route_to_shard(fills)
        for ratio in (1.5, 2.0):
            assert t_slab.rebalance_trigger(fills, ratio) == j_slab.rebalance_trigger(fills, ratio)

    # Interleaved routed ingest (a partial block too), one epoch, one growth
    # and two more appends, leaf by leaf after each step.
    j_ing, t_ing = j_slab.make_sharded_ingest_fn(jmesh), t_slab.make_sharded_ingest_fn(tmesh)
    blocks = [(xa[0:8], ya[0:8], 8), (xa[8:16], ya[8:16], 8),
              (np.concatenate([xa[16:21], np.zeros((3, 4), np.float32)]),
               np.concatenate([ya[16:21], np.zeros(3, np.int32)]), 5)]

    def ingest(jp, tp, blocks):
        for bx, by, count in blocks:
            shard = t_slab.route_to_shard(tp.n_filled)
            assert shard == j_slab.route_to_shard(np.asarray(jax.device_get(jp.n_filled)))
            jp, jg = j_ing(jp, j_edges, jnp.asarray(bx), jnp.asarray(by), count, shard)
            tp, tg = t_ing(tp, t_edges, torch.as_tensor(bx), torch.as_tensor(by), count, shard)
            assert int(jg) == int(tg)
        return jp, tp

    jp, tp = ingest(jp, tp, blocks)
    leaves_equal(jp, tp, "ingest")
    np.testing.assert_array_equal(tp.n_filled.numpy(), [16, 16, 13, 8])
    j_reb, t_reb = j_slab.make_rebalance_fn(jmesh, 8), t_slab.make_rebalance_fn(tmesh, 8)
    jp, jsrc, jdst = j_reb(jp)
    tp, tsrc, tdst = t_reb(tp)
    leaves_equal(jp, tp, "epoch")
    np.testing.assert_array_equal(np.asarray(jsrc), tsrc.numpy())
    np.testing.assert_array_equal(np.asarray(jdst), tdst.numpy())
    assert (tsrc >= 0).sum() > 0
    idx = np.concatenate([np.asarray(jdst).reshape(-1)[:3], [0, 5, 63]]).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(j_ring.remap_indices(jnp.asarray(idx), jsrc, jdst)),
                                  t_ring.remap_indices(torch.as_tensor(idx), tsrc, tdst).numpy())

    # The fused select over the ingest-built pool: a forest fitted on the
    # contents, K3 per shard and the ring merge, against JAX's.
    x, y, m = (np.asarray(jax.device_get(getattr(jp, f))) for f in ("x", "oracle_y", "labeled_mask"))
    fills = np.asarray(jax.device_get(jp.n_filled))
    valid = np.concatenate([np.arange(16) < f for f in fills])
    sel = valid & ~m
    binned = j_tt.make_bins(jnp.asarray(x), 8)
    c, yy, w = j_tt.gather_fit_window(binned.codes, jnp.asarray(y), jnp.asarray(m & valid), 128)
    f, th, v = j_tt.fit_forest_device(c, yy, w, binned.edges, jax.random.key(0), n_trees=8,
                                      max_depth=3, n_bins=8)
    jgf = j_tt.heap_gemm_forest(f, th, v, 3)
    tforest = attach_mesh(interop.gemm_forest_from_numpy(
        jgf.feat_ids, jgf.thresholds, jgf.path, jgf.target, jgf.value, pallas=True,
        device="cpu"), tmesh)
    for name in ("uncertainty",):
        jv, ji = j_rf.fused_score_select(JSPF(gf=jgf, mesh=jmesh), jp.x, jnp.asarray(sel), name, 7)
        tv, ti = t_rf.fused_score_select(tforest, tp.x, torch.as_tensor(sel), name, 7)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy(), err_msg=name)

    jg, tg = j_slab.grow_sharded_slab(jp, jmesh), t_slab.grow_sharded_slab(tp, tmesh)
    leaves_equal(jg, tg, "grown")
    assert tg.capacity == tp.capacity + 4 * 64
    j_ing2, t_ing = j_slab.make_sharded_ingest_fn(jmesh), t_slab.make_sharded_ingest_fn(tmesh)
    j_ing = j_ing2
    jg, tg = ingest(jg, tg, [(xa[21:29], ya[21:29], 8), (xa[29:37], ya[29:37], 8)])
    leaves_equal(jg, tg, "grown ingest")
    # Epochs until the plan is empty; then an epoch is a no-op: no map
    # entries, nothing moved.
    bal = t_slab.make_rebalance_fn(tmesh, 8)
    for _ in range(8):
        if not t_slab.rebalance_plan(tg.n_filled, 8).any():
            break
        tg, _, _ = bal(tg)
    before = [t_gather(getattr(tg, f)).clone() for f in ("x", "labeled_mask", "n_filled")]
    tg, s2, d2 = bal(tg)
    assert (s2 < 0).all() and (d2 < 0).all()
    for a, f in zip(before, ("x", "labeled_mask", "n_filled")):
        assert torch.equal(a, t_gather(getattr(tg, f))), f

    # The hysteresis over one fill sequence: every decision and counter.
    seq = [[8, 8, 8, 8], [17, 10, 10, 10], [17, 8, 8, 8], [17, 8, 8, 8], [16, 9, 9, 9],
           [12, 10, 10, 10],
           [30, 8, 8, 8], [30, 8, 8, 8], [30, 8, 8, 8], [30, 8, 8, 8], [30, 8, 8, 8],
           [14, 8, 8, 8], [0, 0, 0, 0], [9, 0, 4, 4], [5, 5, 5, 5]]
    jh, th = j_slab.RebalanceHysteresis(), t_serving.RebalanceHysteresis()
    for fl in seq:
        assert jh.update(fl) == th.update(torch.as_tensor(fl)), fl
        assert jh.active == th.active
    assert (jh.fired, jh.suppressed_interval, jh.suppressed_band) == \
        (th.fired, th.suppressed_interval, th.suppressed_band)
    assert th.fired >= 2 and th.suppressed_interval >= 1 and th.suppressed_band >= 1
    with pytest.raises(ValueError, match="band would invert"):
        t_serving.RebalanceHysteresis(enter_ratio=1.5, exit_ratio=2.0)


def test_service_matches_jax(tmp_path):
    x0, y0 = _points(48, seed=0)
    tx, ty = _points(32, seed=1)
    for kernel in ("gemm", "pallas"):
        jcfg, jserve = _cfgs(j_config, kernel)
        tcfg, tserve = _cfgs(t_config, kernel)
        jdir, tdir = str(tmp_path / f"j_{kernel}"), str(tmp_path / f"t_{kernel}")
        js = JALService(jcfg, jserve, x0, y0, tx, ty, checkpoint_dir=jdir)
        ts = TALService(tcfg, tserve, x0, y0, tx, ty, checkpoint_dir=tdir, device="cpu")
        j_scores, t_scores = _drive(js, tx), _drive(ts, tx)
        for a, b in zip(j_scores, t_scores, strict=True):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), kernel)
        js_sum, ts_sum = js.summary(), ts.summary()
        assert js_sum == ts_sum, kernel  # the key set and every count
        assert ts_sum["slab_growths"] >= 1 and ts_sum["refits"] >= 1
        assert ts_sum["recompiles_after_warmup"] == 0
        np.testing.assert_array_equal(np.asarray(js._slab.labeled_mask),
                                      ts._slab.labeled_mask.numpy())
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(js._tenant._key)),
                                      ts._tenant._key.numpy().astype(np.uint32))
        assert _records(js.result) == _records(ts.result)
        _assert_metrics_close(js.result, ts.result)

        # Checkpoints across the packages, both ways: a JAX-written file
        # resumes in the port and a port-written one in JAX, scoring alike.
        js.save_checkpoint()
        ts.save_checkpoint()
        q = _points(16, seed=77)[0]
        for src, ref in ((jdir, js), (tdir, ts)):
            dst = str(tmp_path / f"x_{kernel}_{os.path.basename(src)}")
            shutil.copytree(src, dst)
            if src == jdir:
                other = TALService(tcfg, tserve, x0, y0, tx, ty, checkpoint_dir=dst, device="cpu")
            else:
                other = JALService(jcfg, jserve, x0, y0, tx, ty, checkpoint_dir=dst)
            assert (other._fill, other._labeled) == (ref._fill, ref._labeled)
            np.testing.assert_array_equal(np.asarray(other.score(q)), np.asarray(ref.score(q)))
        ts.manager.close()

    # The refusals: a host fit, an arrival wider than the ingest block, and
    # a checkpoint of another service.
    with pytest.raises(ValueError, match="fit='device'"):
        TALService(dataclasses.replace(tcfg, forest=dataclasses.replace(tcfg.forest, fit="host")),
                   tserve, x0, y0, tx, ty, device="cpu")
    with pytest.raises(ValueError, match="exceeds ingest block"):
        t_slab.pad_block(*_points(17), 16)
    other_cfg = dataclasses.replace(tcfg, strategy=dataclasses.replace(tcfg.strategy,
                                                                       window_size=5))
    with pytest.raises(ValueError, match="refusing to resume a different service"):
        TALService(other_cfg, tserve, x0, y0, tx, ty, checkpoint_dir=tdir, device="cpu")

    # The slab writes arrivals in place: a chunk graph captured on its
    # tensors reads them at the next replay.
    ts = TALService(tcfg, dataclasses.replace(tserve, max_staleness=0), x0, y0, tx, ty,
                    device="cpu")
    slab = ts._slab
    ptrs = [t.data_ptr() for t in (slab.x, slab.codes, slab.oracle_y, slab.n_filled)]
    ts.submit(*_points(16, seed=9))
    assert [t.data_ptr() for t in (ts._slab.x, ts._slab.codes, ts._slab.oracle_y,
                                   ts._slab.n_filled)] == ptrs
    assert int(ts._slab.n_filled) == 64 and ts._fill == 64
    ts.manager.close()

    # The drift monitor is the JAX package's (pure Python, copied).
    for mon in (j_drift.DriftMonitor(entropy_shift=0.2, min_fresh=10, max_staleness=3, ema=0.5),
                t_drift.DriftMonitor(entropy_shift=0.2, min_fresh=10, max_staleness=3, ema=0.5)):
        mon.observe_chunk([{"pool_entropy": 1.0, "score_margin": 0.5}])
        seen = []
        for ent, fresh in ((2.0, 0), (2.0, 10), (1.1, 0), (1.0, 5), (1.0, 5)):
            mon.observe_serve(ent)
            mon.observe_ingest(fresh)
            seen.append(mon.should_refit())
        mon.observe_chunk([{"pool_entropy": 1.0, "score_margin": 0.05}])
        mon.observe_ingest(10)
        seen.append(mon.should_refit())
        if isinstance(mon, j_drift.DriftMonitor):
            want = seen
    assert seen == want and "entropy_shift" in seen and "margin_shift" in seen
    _mesh_scenario_resume_and_watermark_match_jax(tmp_path)
    _pod_parity()


def _mesh_scenario_resume_and_watermark_match_jax(tmp_path):
    import jax.numpy as jnp

    from distributed_active_learning_tpu.parallel import make_mesh as j_make_mesh
    from distributed_active_learning_tpu.parallel import mesh as j_mesh
    from distributed_active_learning_tpu.runtime import loop as j_loop
    from distributed_active_learning_tpu.runtime import state as j_state
    from distributed_active_learning_tpu.scenarios import engine as j_engine
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.parallel import mesh as t_mesh
    from distributed_active_learning_tpu_torch.runtime import loop as t_loop
    from distributed_active_learning_tpu_torch.runtime import state as t_state
    from distributed_active_learning_tpu_torch.scenarios import engine as t_engine

    def rec(res):
        return [(r.round, r.n_labeled, r.accuracy) for r in res.records]

    # The noisy oracle on the mesh, per round and chunked.
    j = j_config.ExperimentConfig(
        data=j_config.DataConfig(name="checkerboard2x2", n_samples=250, seed=2),
        forest=j_config.ForestConfig(n_trees=8, max_depth=4, fit="device"),
        strategy=j_config.StrategyConfig(name="uncertainty", window_size=10),
        scenario=j_config.ScenarioConfig(kind="noisy_oracle", flip_prob=0.2, abstain_prob=0.3),
        n_start=10, max_rounds=3, seed=7)
    want = rec(j_loop.run_experiment(j))
    t = t_config.from_dict(dataclasses.asdict(j))
    single = t_loop.run_experiment(t, device="cpu")
    for k in (1, 4):
        got = t_loop.run_experiment(dataclasses.replace(
            t, mesh=t_config.MeshConfig(4, 2), rounds_per_launch=k), device="cpu")
        assert rec(got) == want, k
        assert torch.equal(got.final_labeled_mask, single.final_labeled_mask)
    full = t_engine.flip_mask(t.scenario, 7, 252)
    for shards in (1, 3, 4, 7):
        rows = 252 // shards
        blocks = [t_engine.flip_mask_block(t.scenario, 7, 252, s, rows) for s in range(shards)]
        assert torch.equal(torch.cat(blocks), full[:rows * shards])
        np.testing.assert_array_equal(blocks[-1].numpy(), np.asarray(j_engine.flip_mask_block(
            j.scenario, 7, 252, jnp.asarray(shards - 1), rows)))

    # A chunked run on a 3-shard mesh (1,000 rows padded to 1,002)
    # checkpoints; one device resumes it, as after the JAX package's mesh run.
    def ckpt_cfg(pkg, **kw):
        return pkg.ExperimentConfig(
            data=pkg.DataConfig(name="checkerboard2x2", seed=3),
            forest=pkg.ForestConfig(n_trees=10, max_depth=4),
            strategy=pkg.StrategyConfig(name="uncertainty", window_size=20),
            n_start=10, seed=0, checkpoint_every=1, **kw)

    resumed = []
    for pkg, run, k in ((j_config, j_loop.run_experiment, 1),
                        (t_config, lambda c: t_loop.run_experiment(c, device="cpu"), 2)):
        ck = str(tmp_path / f"mesh_ckpt_{pkg.__name__.split('.')[0]}")
        run(ckpt_cfg(pkg, max_rounds=2, checkpoint_dir=ck, mesh=pkg.MeshConfig(data=3),
                     rounds_per_launch=k))
        resumed.append(run(ckpt_cfg(pkg, max_rounds=1, checkpoint_dir=ck)))
    assert resumed[1].records[-1].round == 3  # continued across the mesh switch
    assert rec(resumed[1]) == rec(resumed[0])

    # The per-shard fill watermark.
    x = np.random.default_rng(5).normal(size=(256, 3)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    jm = j_make_mesh(data=4, model=2)
    js = j_mesh.shard_pool_state(j_state.set_start_state(
        j_state.init_pool_state(x, y, jax.random.key(6)), 8).replace(
        n_filled=jnp.asarray(37, jnp.int32)), jm)
    scalar = t_state.set_start_state(t_state.init_pool_state(x, y, prng.key(6), "cpu"), 8)
    scalar = scalar.replace(n_filled=torch.tensor(37, dtype=torch.int32))
    sh = t_mesh.shard_pool_state(scalar, t_mesh.make_mesh(4, 2, device="cpu"))
    np.testing.assert_array_equal(sh.n_filled.numpy(), np.asarray(js.n_filled))
    assert torch.equal(sh.fill_mask, scalar.fill_mask)
    assert int(t_state.filled_count(sh)) == 37 == int(j_state.filled_count(js))
    assert int(t_state.labeled_count(sh)) == int(t_state.labeled_count(scalar))
    forest = torch.arange(4, dtype=torch.float32)
    files = [t_ckpt.save_serve(str(tmp_path / f"serve_{i}"), st, forest, TResult())
             for i, st in enumerate((scalar, sh))]
    a, b = np.load(files[0]), np.load(files[1])
    assert a.files == b.files and all(np.array_equal(a[f], b[f]) for f in a.files)
    gaps = sh.replace(n_filled=torch.tensor([64, 0, 64, 0], dtype=torch.int32))
    with pytest.raises(ValueError) as t_err:
        t_ckpt.save_serve(str(tmp_path / "serve_gaps"), gaps, forest, TResult())
    with pytest.raises(ValueError) as j_err:
        j_ckpt.save_serve(str(tmp_path / "serve_gaps_j"), js.replace(
            n_filled=jnp.asarray([64, 0, 64, 0], jnp.int32)), jnp.arange(4.0), JResult())
    assert str(t_err.value) == str(j_err.value)


T = 3


def _tenant_cfgs(pkg, i):
    return _cfgs(pkg, seed=i, max_staleness=0, drift_entropy_shift=99.0, refit_poll_events=1,
                 slo_latency_ms=60_000.0, slo_target=0.9)


def _tenant_data(i):
    x0, y0 = _points(40, seed=10 + i, shift=0.3 * i)
    tx, ty = _points(24, seed=50 + i, shift=0.3 * i)
    return x0, y0, tx, ty


def test_tenants_and_frontend_match_jax(tmp_path):
    jmgr = JTenantManager()
    tmgr = TTenantManager(checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    svcs = []
    for i in range(T):
        jcfg, jserve = _tenant_cfgs(j_config, i)
        tcfg, tserve = _tenant_cfgs(t_config, i)
        # the JAX manager's ahead-of-time compiles change no result; off, to
        # keep the test short
        jmgr.add_tenant(f"t{i}", jcfg, dataclasses.replace(jserve, precompile_ahead=False),
                        *_tenant_data(i))
        tmgr.add_tenant(f"t{i}", tcfg, tserve, *_tenant_data(i))
        svcs.append(TALService(tcfg, tserve, *_tenant_data(i), device="cpu"))
    try:
        # grouped scores == JAX's == the single endpoint's
        q1 = {f"t{i}": _points(10, seed=90 + i)[0] for i in range(T)}
        j_b, t_b = jmgr.score_many(q1), tmgr.score_many(q1)
        for i, tid in enumerate(q1):
            np.testing.assert_array_equal(np.asarray(j_b[tid]), t_b[tid])
            np.testing.assert_array_equal(t_b[tid], svcs[i].score(q1[tid]))
        assert tmgr.batched_score_launches >= 1 and tmgr.score_fallback_reasons == {}
        assert tmgr.score_groups() == [["t0", "t1", "t2"]]

        # one tenant-axis batched re-fit == JAX's == three independent ones
        for i in range(T):
            sx, sy = _points(16, seed=70 + i, shift=0.3 * i)
            jmgr.submit(f"t{i}", sx, sy)
            tmgr.submit(f"t{i}", sx, sy)
            svcs[i].submit(sx, sy)
        assert jmgr.refit_now("test") == tmgr.refit_now("test") == T
        assert tmgr.batched_refit_launches == 1
        for s in svcs:
            assert s.refit_now("test")
        for m in (jmgr, tmgr, *svcs):
            m.flush()
        for i in range(T):
            jt, tt, st = jmgr.tenant(f"t{i}"), tmgr.tenant(f"t{i}"), svcs[i]._tenant
            mask = tt._slab.labeled_mask.numpy()
            np.testing.assert_array_equal(np.asarray(jt._slab.labeled_mask), mask)
            np.testing.assert_array_equal(st._slab.labeled_mask.numpy(), mask)
            key = tt._key.numpy().astype(np.uint32)
            np.testing.assert_array_equal(np.asarray(jax.random.key_data(jt._key)), key)
            np.testing.assert_array_equal(st._key.numpy().astype(np.uint32), key)
            assert jt._labeled == tt._labeled == st._labeled > 6
            assert _records(jt.result) == _records(tt.result) == _records(st.result)
        q2 = {f"t{i}": _points(8, seed=120 + i)[0] for i in range(T)}
        j_b, t_b = jmgr.score_many(q2), tmgr.score_many(q2)
        for i, tid in enumerate(q2):
            np.testing.assert_array_equal(np.asarray(j_b[tid]), t_b[tid])
            np.testing.assert_array_equal(t_b[tid], svcs[i].score(q2[tid]))

        # a growth inside warmup that finds no precompiled set leaves its
        # cause pending: the first query after mark_warmup_complete counts
        # it, in both packages
        pmgr = TTenantManager(device="cpu")
        try:
            tcfg, tserve = _tenant_cfgs(t_config, 0)
            pmgr.add_tenant("t0", tcfg, dataclasses.replace(tserve, precompile_ahead=False),
                            *_tenant_data(0))
            gx, gy = _points(32, seed=300)
            for m in (jmgr, pmgr):
                m.submit("t0", gx, gy)
                m.flush()
                assert m.tenant("t0").stats.slab_growths == 1
                assert m.tenant("t0").stats.growths_precompiled == 0
                m.mark_warmup_complete()
                assert m.post_warmup_growth_compile_events() == 0
                m.score_many({"t0": _points(4, seed=301)[0]})
                m.score_many({"t0": _points(4, seed=302)[0]})
            assert jmgr.post_warmup_growth_compile_events() == 1
            assert pmgr.post_warmup_growth_compile_events() == 1
            assert (jmgr.tenant("t0").cause_counts["slab_growth_compile"]
                    == pmgr.tenant("t0").cause_counts["slab_growth_compile"] == 1)
        finally:
            pmgr.close()

        # growth swaps in the precompiled set: no capture or build on the
        # request path after warmup
        assert tmgr.wait_precompiles(timeout=120)
        tmgr.mark_warmup_complete()
        t0 = tmgr.tenant("t0")
        tmgr.submit("t0", *_points(64, seed=200))
        tmgr.score_many({"t0": _points(6, seed=201)[0]})
        assert t0.stats.slab_growths >= 1
        assert t0.stats.growths_precompiled == t0.stats.slab_growths
        assert "slab_growth_compile" not in t0.cause_counts
        assert tmgr.post_warmup_growth_compile_events() == 0
        assert tmgr.recompiles_after_warmup() == 0
        assert tmgr.request_path_builds_after_warmup == 0
        assert tmgr.precompiles >= 1 and tmgr.precompile_errors == 0
        assert all(p.precompiled for c, p in t0._programs.items() if c > 64)
        assert all(n <= 2 for tid, n in tmgr.live_graphs().items() if tid != "_batched")
        s = tmgr.summary()
        assert s["slo"]["total"] == s["queries"] and s["slo"]["compliance"] == 1.0

        # the frontend: a held ingest (re-fit in flight) and a flood past the
        # admission cap
        tt = tmgr.tenant("t1")
        tt._poll_refit, tt._inflight = (lambda force=False: None), object()
        fe = ServiceFrontend(tmgr, max_pending=2).start()
        try:
            bx, by = _points(4, seed=400)
            held = [fe.submit_ingest("t1", bx, by) for _ in range(2)]
            with pytest.raises(AdmissionError, match="backpressure"):
                fe.submit_ingest("t1", bx, by)
            assert fe.rejected == {"t1": 1} and not any(f.done() for f in held)
            out = fe.score("t0", _points(5, seed=401)[0], timeout=60)
            assert out.shape == (5,) and np.isfinite(out).all()
        finally:
            del tt._poll_refit
            tt._inflight = None
            fe.stop(drain=True)
        assert all(f.result(timeout=60)["points"] == 4 for f in held)

        # the tenant axis of the checkpoint: a renamed file is refused
        paths = tmgr.save_checkpoints()
        step = os.path.basename(paths["t0"]).rsplit("_", 1)[1]
        cross = tmp_path / "cross"
        cross.mkdir()
        shutil.copy(paths["t0"], cross / f"servestate_t9_{step}")
        for ckpt in (t_ckpt, j_ckpt):
            with pytest.raises(ValueError, match="cross-wire"):
                ckpt.restore_latest_serve(str(cross), None, tenant="t9")
    finally:
        jmgr.close()
        tmgr.close()
        for s in svcs:
            s.manager.close()
    _fleet_matches_jax()


# The JAX fleet test's stub workers (tests/test_fleet.py): an echo /score
# endpoint and an ops plane whose /healthz verdict is fixed.
def _stub_server(handler_cls):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, int(httpd.server_address[1])


def _stub_worker(healthy: bool):
    class _Score(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *_a):
            pass

        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            ctype = self.headers.get("Content-Type", "application/json")
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    class _Ops(BaseHTTPRequestHandler):
        def log_message(self, *_a):
            pass

        def do_GET(self):  # noqa: N802
            code = 200 if healthy else 503
            body = json.dumps({"ok": healthy}).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    s1, score_port = _stub_server(_Score)
    s2, ops_port = _stub_server(_Ops)
    return (s1, s2), {"host": "127.0.0.1", "score_port": score_port, "ops_port": ops_port}


def _router_exchange(router_cls, workers):
    """The same requests through one router: each answer's status and
    body, the summary and the aggregated /metrics text."""
    router = router_cls(workers, port=0, health_ttl=0.05).start()
    base = f"http://127.0.0.1:{router.port}"
    blob = b"\x02\x00\x00\x00\x03\x00\x00\x00" + np.arange(6, dtype=np.float32).tobytes()
    reqs = [(f"/score?tenant=u{i}", blob, "application/octet-stream") for i in range(8)]
    reqs += [("/score", json.dumps({"tenant": f"u{i}", "queries": [[1.0, 2.0]]}).encode(),
              "application/json") for i in range(8)]
    reqs += [("/score", b"not json", "application/json"), ("/nope", b"", "application/json")]
    answers = []
    try:
        for path, body, ctype in reqs:
            req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    answers.append((r.status, r.read()))
            except urllib.error.HTTPError as e:
                answers.append((e.code, e.read()))
        gets = {}
        for route in ("healthz", "workers", "summary", "metrics"):
            with urllib.request.urlopen(f"{base}/{route}", timeout=10) as r:
                gets[route] = (r.status, r.read())
        return answers, router.summary(), gets, [router.route(f"u{i}") for i in range(8)]
    finally:
        router.stop()


def _fleet_matches_jax():
    keys = [f"tenant-{i}" for i in range(64)]
    for n in range(1, 6):
        nodes = [f"w{i}" for i in range(n)]
        j_ring, t_ring = j_fleet.HashRing(nodes), t_fleet.HashRing(nodes)
        assert [t_ring.nodes_for(k) for k in keys] == [j_ring.nodes_for(k) for k in keys]
        assert [t_ring.lookup(k) for k in keys] == [j_ring.lookup(k) for k in keys]
    spec = t_fleet.TenantSpec("u0", features=5, pool_rows=700, shift=0.4, seed=3)
    for a, b in zip(t_fleet._spec_data(spec), j_fleet._spec_data(j_fleet.TenantSpec(
            **dataclasses.asdict(spec))), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    # The router against stub workers, both packages' RouterServer.
    (a1, a2), ep_ok = _stub_worker(healthy=True)
    (b1, b2), ep_sick = _stub_worker(healthy=False)
    workers = {"wok": ep_ok, "wsick": ep_sick}
    try:
        t_out = _router_exchange(t_fleet.RouterServer, workers)
        j_out = _router_exchange(j_fleet.RouterServer, workers)
    finally:
        for srv in (a1, a2, b1, b2):
            srv.shutdown()
            srv.server_close()
    assert t_out == j_out
    answers, summary, gets = t_out[:3]
    assert [a[0] for a in answers] == [200] * 16 + [400, 404]
    assert all(body == answers[0][1] for _, body in answers[:8])  # the binary body, relayed
    assert summary["routed"] == {"wok": 16} and summary["unroutable"] == 0
    assert summary["rerouted"] > 0 and gets["healthz"][0] == 200

    # A spawned 2-worker fleet on the CPU == JAX's managers, built as the
    # JAX worker builds them.
    specs = [t_fleet.TenantSpec(f"u{i}", features=4, pool_rows=64, shift=0.3 * i, seed=20 + i,
                                n_trees=6, max_depth=3, slab_rows=64, score_width=16,
                                ingest_block=16) for i in range(4)]
    fleet = t_fleet.Fleet(specs, n_workers=2, device="cpu").start()
    jmgrs = []
    try:
        got, want = {}, {}
        for wid in fleet.worker_ids:
            jmgr = JTenantManager()
            jmgrs.append(jmgr)
            for i, spec in enumerate(fleet.specs_for(wid)):
                tcfg, tserve = t_fleet.spec_configs(spec, i)
                jcfg = j_config.ExperimentConfig(
                    forest=j_config.ForestConfig(n_trees=spec.n_trees, max_depth=spec.max_depth,
                                                 kernel=spec.kernel, fit="device",
                                                 fit_budget=spec.slab_rows),
                    strategy=j_config.StrategyConfig(name="uncertainty", window_size=16),
                    n_start=max(spec.pool_rows // 8, 4), log_every=0, seed=spec.seed + i)
                jserve = j_config.ServeConfig(**dataclasses.asdict(tserve))
                assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
                jmgr.add_tenant(spec.tenant_id, jcfg, jserve, *j_fleet._spec_data(
                    j_fleet.TenantSpec(**dataclasses.asdict(spec))))
            for spec in fleet.specs_for(wid):
                q = _points(21, seed=600 + int(spec.tenant_id[1:]), shift=spec.shift)[0]
                got[spec.tenant_id] = fleet.score(spec.tenant_id, q)
                want[spec.tenant_id] = np.asarray(jmgr.score_many({spec.tenant_id: q})
                                                  [spec.tenant_id])
    finally:
        final = fleet.stop()
        for jmgr in jmgrs:
            jmgr.close()
    assert sorted(got) == [s.tenant_id for s in specs]
    for tid in got:
        np.testing.assert_array_equal(got[tid], want[tid], err_msg=tid)
    assert sorted(final["workers"]) == ["w0", "w1"]
    for wid, f in final["workers"].items():
        assert f["recompiles_after_warmup"] == 0 and f["device"] == "cpu", f
        assert f["tenants"] == [s.tenant_id for s in fleet.specs_for(wid)]
    assert final["router"]["unroutable"] == 0 and final["router"]["rerouted"] == 0
