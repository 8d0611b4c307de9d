"""The port's single-process device mesh against the JAX package's mesh.

On the CPU every shard of the port's 4 x 2 mesh lies on ``cpu``; the JAX
package's mesh is 4 x 2 forced host devices (tests/conftest.py). Inputs are
numpy arrays made from a seed and handed to both packages.

- the mesh's kernels (K3, the sharded votes and selection, the ring merge)
  in ``tests/test_torch_mesh_kernels.py``, with this file's helpers;
- ``run_experiment`` on a 4 x 2 mesh (250 rows padded to 252), fused and
  unfused, equals the JAX single-device run exactly (records, final mask)
  and the port's single-device run, with a fit that is bit-identical to the
  single-device fit; so do int8 and bf16 storage on the fused mesh (K3 on
  the narrow payloads) and a 4-class pool on the unfused mesh (K1 per shard
  and plane), whose records also equal the JAX package's 4 x 2 mesh run;
- the chunk under the 4 x 2 mesh (``rounds_per_launch=4``, JAX's
  ``tests/test_chunked_driver.py`` configuration): unfused, its records and
  final mask equal the JAX single-device run's (JAX pins its mesh chunk to
  it); fused, they equal the JAX package's own 4 x 2 mesh chunk (whose
  mesh round divides ``votes / T``; at 8 trees both spellings agree);
- RoundMetrics under the mesh (JAX's ``tests/test_telemetry.py``
  configuration), per round and chunked, equal the JAX single-device
  run's, ``pool_entropy`` to ``telemetry.POOL_ENTROPY_RTOL``;
- the mesh over processes (``parallel/multihost.py``): JAX's four forest
  cases of ``tests/test_multihost_2proc.py`` (2 processes with the device
  fit, 2 with the host fit, 4 with the device fit, 2 with the device fit
  and ``kernel="pallas"``) run on 2 or 4 port processes over gloo
  (:func:`spawn_ranks`; this file's ``__main__`` is the rank): every rank's
  records and final mask equal JAX's single-process run, every rank fits
  the same forest bytes, rank 0 alone writes the 3 checkpoints, whose
  payload equals JAX's single-process checkpoints, another rank's ``save``
  returns None, ``gauges(allgather=True)`` carries every rank's value, the
  run's metadata names the gloo backend, every collective over processes
  equals the one-process collective over every shard (each row once where a
  row spans 2 ranks, and where the ranks' cells cross a row partway, their
  row groups overlapping), and a mesh whose ranks' cells cross a row
  partway places each rank's cells row-major; a 2-seed chunked sweep on the
  2-process mesh equals the single-process sweep;
- the model axis across processes, in the same jobs: ``MeshConfig(1, 2)``
  and ``(3, 2)`` (cells crossing a row) on the 2 ranks of the leaf kernel's
  case, ``(2, 2)``, ``(1, 4)`` and ``(3, 4)`` (no rank holding a whole row)
  on the 4 ranks, each fused (kernel "pallas", K3's plain version) and
  unfused: every rank's records and final mask, and rank 0's checkpoints,
  equal JAX's single-process run of the same configuration;
- the pod over 2 processes (``pod_sequence``: ``_pod_parity``'s sizes on a
  (4, 1) mesh, 2 rows a rank): every leaf after each step, the fills, each
  epoch's index maps and the fused select's picks equal JAX's pod on a
  (4, 1) host mesh.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from distributed_active_learning_tpu import config as j_config
from distributed_active_learning_tpu.data import get_dataset as j_get_dataset
from distributed_active_learning_tpu.data.datasets import DataBundle as JBundle
from distributed_active_learning_tpu.ops import ring_topk as j_ring
from distributed_active_learning_tpu.ops import round_fused as j_fused
from distributed_active_learning_tpu.ops import trees_pallas as j_pallas
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu.parallel import make_mesh as j_make_mesh
from distributed_active_learning_tpu.parallel import shard_forest as j_shard_forest
from distributed_active_learning_tpu.runtime import loop as j_loop
from distributed_active_learning_tpu.runtime import state as j_state
from distributed_active_learning_tpu.strategies import get_strategy as j_strategy
from distributed_active_learning_tpu.utils.compat import shard_map
from distributed_active_learning_tpu_torch import config as t_config
from distributed_active_learning_tpu_torch import interop, prng
from distributed_active_learning_tpu_torch.data import get_dataset as t_get_dataset
from distributed_active_learning_tpu_torch.ops import ring_topk as t_ring
from distributed_active_learning_tpu_torch.ops import round_fused as t_fused
from distributed_active_learning_tpu_torch.ops import trees_pallas as t_pallas
from distributed_active_learning_tpu_torch.ops import trees_train as t_train
from distributed_active_learning_tpu_torch.ops.topk import NEG_INF
from distributed_active_learning_tpu_torch.parallel import mesh as t_mesh
from distributed_active_learning_tpu_torch.runtime import loop as t_loop
from distributed_active_learning_tpu_torch.runtime import state as t_state
from tests.torch_threads import capped_torch_threads  # noqa: F401  (autouse)


def _forest(n_trees, depth, seed, n_fit=400, d=5):
    """A JAX device-fit forest (heap layout) and the port's copy of it."""
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


def _meshes(data, model):
    j_mesh = j_make_mesh(data=data, model=model)
    return j_mesh, t_mesh.make_mesh(data, model, device="cpu")


def _sharded_pair(gf, tf, j_mesh, t_m):
    j_sh = j_pallas.ShardedPallasForest(gf=j_shard_forest(gf, j_mesh), mesh=j_mesh)
    t_sh = t_pallas.attach_mesh(t_mesh.shard_forest(t_pallas.PallasForest(gf=tf), t_m), t_m)
    return j_sh, t_sh


def _duplicate_heavy(rng, n):
    levels = np.array([-1.5, 0.0, 0.25, 0.25, 3.0], np.float32)
    return levels[rng.integers(0, len(levels), size=n)]


def _jax_ring(j_mesh, scores, sel, k):
    """JAX's window pipeline under shard_map: every shard's merged window."""
    S = j_mesh.shape["data"]
    n_local = scores.shape[0] // S

    def body(s_blk, m_blk):
        kk = min(k, n_local)
        work = jnp.where(m_blk, s_blk, NEG_INF)
        loc_v, loc_i = lax.top_k(work, kk)
        glob_i = (lax.axis_index("data") * n_local + loc_i).astype(jnp.int32)
        win_v, win_i = j_ring.pad_window(loc_v, glob_i, k)
        acc_v, acc_i = j_ring.ring_topk(win_v, win_i, k, "data", mesh_axis_names=j_mesh.axis_names)
        return acc_v[None], acc_i[None]

    out = shard_map(body, mesh=j_mesh, in_specs=(P("data"), P("data")),
                    out_specs=(P("data"), P("data")), check_vma=False)(scores, sel)
    return [np.asarray(a).reshape(S, k) for a in out]


def _port_ring(scores, sel, k, n_shards):
    n_local = scores.shape[0] // n_shards
    windows = []
    for s in range(n_shards):
        blk = slice(s * n_local, (s + 1) * n_local)
        work = torch.where(torch.from_numpy(sel[blk]), torch.from_numpy(scores[blk]), NEG_INF)
        v, i = torch.sort(work, descending=True, stable=True)
        kk = min(k, n_local)
        windows.append(t_ring.pad_window(v[:kk], (i[:kk] + s * n_local).to(torch.int32), k))
    return t_ring.ring_topk(windows, k)


def _cfgs(mesh, fused, strategy="uncertainty", window=10, quantize="none"):
    j = j_config.ExperimentConfig(
        data=j_config.DataConfig(name="checkerboard2x2", n_samples=250, seed=2),
        forest=j_config.ForestConfig(n_trees=8, max_depth=4, kernel="pallas", fit="device",
                                     quantize=quantize),
        strategy=j_config.StrategyConfig(name=strategy, window_size=window),
        mesh=j_config.MeshConfig(*mesh),
        n_start=10, max_rounds=3, seed=7, fused_round=fused,
    )
    return j, t_config.from_dict(dataclasses.asdict(j))


def _jax_final_mask(cfg):
    """The JAX package's single-device loop, driven round by round, for its
    final labeled mask (``run_experiment`` returns records only)."""
    b = j_get_dataset(cfg.data)
    st = j_state.set_start_state(
        j_state.init_pool_state(b.train_x, b.train_y, jax.random.key(cfg.seed)), cfg.n_start)
    binned = j_train.make_bins(jnp.asarray(b.train_x), cfg.forest.max_bins)
    window = cfg.strategy.window_size
    fit = j_loop.make_device_fit(cfg, binned.edges, cfg.n_start + cfg.max_rounds * window)
    round_fn = j_loop.make_round_fn(j_strategy(cfg.strategy), window, fused=cfg.fused_round)
    aux = j_loop.build_aux(cfg, st)
    fit_key = jax.random.key(cfg.seed + 0x5EED)
    for r in range(1, cfg.max_rounds + 1):
        forest = fit(binned.codes, st, jax.random.fold_in(fit_key, r))
        st, _, _ = round_fn(forest, st, aux)
    return np.asarray(st.labeled_mask)


def _records(res):
    return [(r.round, r.n_labeled, r.n_unlabeled, r.accuracy) for r in res.records]


def _fit_matches_single_device(tcfg, mesh_shape):
    """One fit on the padded, sharded start state against the same fit on
    the single-device state: window and forest arrays bit-identical."""
    b = t_get_dataset(tcfg.data)
    st = t_state.set_start_state(
        t_state.init_pool_state(b.train_x, b.train_y, prng.key(tcfg.seed), "cpu"), tcfg.n_start)
    binned = t_train.make_bins(st.x, 32)
    m = t_mesh.make_mesh(*mesh_shape, device="cpu")
    sh = t_mesh.shard_pool_state(t_state.pad_for_sharding(st, mesh_shape[0]), m)
    codes = t_mesh.shard_rows(binned.codes, m)
    for budget in (40, 8):  # a window past the labeled rows, and one they overflow
        single = t_train.gather_fit_window(binned.codes, st.oracle_y, st.labeled_mask, budget)
        masks = [sh.labeled_mask.block(s) & v for s, v in enumerate(t_state.valid_blocks(sh))]
        sharded = t_train.gather_fit_window_sharded(codes, sh.oracle_y, masks, budget)
        for a, c in zip(single, sharded):
            assert a.dtype == c.dtype and torch.equal(a, c)
    budget = 40
    fit = t_loop.make_device_fit(tcfg, binned.edges, budget)
    key = prng.fold_in(prng.key(1), 1)
    f1 = fit(binned.codes, st, key).gf
    f2 = fit(codes, sh, key).gf
    for field in ("feat_ids", "thresholds", "path", "target", "value"):
        assert torch.equal(getattr(f1, field), getattr(f2, field)), field


def _check_mesh_run(fused, strategy="uncertainty", mesh=(4, 2), window=10):
    jcfg, tcfg = _cfgs((1, 1), fused, strategy, window)
    want = j_loop.run_experiment(jcfg)
    single = t_loop.run_experiment(tcfg, device="cpu")
    _, tmesh_cfg = _cfgs(mesh, fused, strategy, window)
    for k in (1, 4):  # per round, and the chunk under the mesh
        got = t_loop.run_experiment(dataclasses.replace(tmesh_cfg, rounds_per_launch=k),
                                    device="cpu")
        assert _records(got) == _records(want) == _records(single), k
        assert got.final_labeled_mask.shape == (250,)
        assert torch.equal(got.final_labeled_mask, single.final_labeled_mask)
    np.testing.assert_array_equal(got.final_labeled_mask.numpy(), _jax_final_mask(jcfg))


def test_mesh_run_experiment_matches_jax(devices, tmp_path):
    for fused in (False, True):
        _check_mesh_run(fused)
    # Quantized storage on the fused mesh; a 4-class pool on the unfused one
    # (the fused round refuses multiclass pools, as in the JAX package).
    from distributed_active_learning_tpu_torch.data.datasets import DataBundle as TBundle

    rng = np.random.default_rng(5)
    x = rng.normal(size=(378, 4)).astype(np.float32)
    s = x[:, 0] + 0.3 * x[:, 1]
    y = np.digitize(s, np.quantile(s, [0.25, 0.5, 0.75])).astype(np.int32)
    four = (x[:250], y[:250], x[250:], y[250:])
    for fused, quantize, bundle in ((True, "int8", None), (True, "bf16", None),
                                    (False, "none", four)):
        jb, tb = (JBundle(*bundle), TBundle(*bundle)) if bundle else (None, None)
        jcfg, tcfg = _cfgs((1, 1), fused, quantize=quantize)
        want = j_loop.run_experiment(jcfg, bundle=jb)
        single = t_loop.run_experiment(tcfg, bundle=tb, device="cpu")
        jm_cfg, tm_cfg = _cfgs((4, 2), fused, quantize=quantize)
        got = t_loop.run_experiment(tm_cfg, bundle=tb, device="cpu")
        assert _records(got) == _records(want) == _records(single), (quantize, bundle is None)
        assert torch.equal(got.final_labeled_mask, single.final_labeled_mask)
        if bundle is not None:
            assert _records(j_loop.run_experiment(jm_cfg, bundle=jb)) == _records(got)
    _fit_matches_single_device(_cfgs((4, 2), False)[1], (4, 2))
    # `random` draws over the padded pool, as the JAX mesh run does: in
    # partitionable threefry element i's bits depend on i alone.
    key = prng.key(3)
    assert torch.equal(prng.uniform(key, (252,))[:250], prng.uniform(key, (250,)))
    _mesh_chunk_and_metrics_match_jax()
    _multi_process_runs_match_jax(tmp_path)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The four forest cases of JAX's tests/test_multihost_2proc.py.
_MP_CASES = ((2, "device", "gather"), (2, "host", "gather"), (4, "device", "gather"),
             (2, "device", "pallas"))
#: The meshes whose model axis (or one data row) spans the ranks, run by
#: the case's job fused (kernel "pallas") and unfused (the case's kernel);
#: in (3, 2) over 2 and (3, 4) over 4 the ranks' cells cross a row partway.
_MP_MODEL_AXIS = {(2, "device", "pallas"): ((1, 2), (3, 2)),
                  (4, "device", "gather"): ((2, 2), (1, 4), (3, 4))}
#: Each rank's rows and its columns in each, of make_mesh(3 * n // 2, 2)
#: over n ranks (3 cells a rank: a whole row and half of the next, or the
#: other half and a whole row).
_CROSSING = {2: [[[0, [0, 1]], [1, [0]]], [[1, [1]], [2, [0, 1]]]],
             4: [[[0, [0, 1]], [1, [0]]], [[1, [1]], [2, [0, 1]]],
                 [[3, [0, 1]], [4, [0]]], [[4, [1]], [5, [0, 1]]]]}


def spawn_ranks(n, argv, rdv_dir):
    """Start ``argv`` (a Python command line) as ``n`` ranks of one gloo job
    on the CPU, under the JAX package's env trio with a ``file://``
    rendezvous in ``rdv_dir`` (no port to race for under ``pytest -n``),
    each rank's output in ``rdv_dir/rank<r>.log``. Returns the running
    processes; :func:`wait_ranks` collects them."""
    procs = []
    for r in range(n):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   JAX_COORDINATOR_ADDRESS=f"file://{rdv_dir}/rendezvous",
                   JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(r),
                   PYTHONPATH=os.pathsep.join([_REPO, os.environ.get("PYTHONPATH", "")]))
        env.pop("XLA_FLAGS", None)
        with open(os.path.join(rdv_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, *argv], env=env, cwd=_REPO,
                                          stdout=log, stderr=subprocess.STDOUT))
        procs[-1].log = os.path.join(rdv_dir, f"rank{r}.log")
    return procs


def wait_ranks(procs, timeout=240):
    """Every rank's ``(returncode, output)``. A rank that fails stops the
    others (they would wait in a collective), as does ``timeout`` seconds
    (a missed collective), which fails the test."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
                p.wait()
            if not failed:
                pytest.fail(f"a rank of {len(procs)} hung past {timeout}s (a missed collective?)")
            break
        time.sleep(0.05)
    outs = []
    for p in procs:
        with open(p.log) as f:
            outs.append((p.returncode, f.read()))
    return outs


def rank_results(outs, tag):
    """Each rank's JSON result line ``<tag> <rank> {...}``, in rank order."""
    got = []
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
        line = next(ln for ln in out.splitlines() if ln.startswith(f"{tag} {r} "))
        got.append(json.loads(line.split(" ", 2)[2]))
    return got


def _ckpt_payload(path):
    """A checkpoint's fields, its records without their wall times."""
    z = np.load(path)
    out = {k: z[k] for k in z.files if k != "records_json"}
    recs = json.loads(bytes(z["records_json"]).decode())
    out["records"] = [{k: v for k, v in r.items() if not k.endswith("_time")} for r in recs]
    return out


def _multi_process_runs_match_jax(tmp_path):
    """JAX's four forest cases on N port processes against JAX's
    single-process runs (module docstring)."""
    from tests.multihost_expcfg import experiment_cfg

    running = {}
    for case in _MP_CASES:
        n, fit, kernel = case
        d = tmp_path / f"mp_{n}_{fit}_{kernel}"
        d.mkdir()
        running[case] = spawn_ranks(n, [__file__, "forest", str(d), fit, kernel], d)
    wants = {}
    # Meanwhile, JAX's references: each (fit, kernel) per round, and the
    # fused round of the leaf kernel.
    for fit, kernel, fused in {(f, k, False) for _, f, k in _MP_CASES} | {("device", "pallas",
                                                                          True)}:
        ck = tmp_path / f"jax_{fit}_{kernel}_{fused}"
        res = j_loop.run_experiment(dataclasses.replace(
            experiment_cfg(mesh_data=1, fit=fit, kernel=kernel, checkpoint_dir=str(ck),
                           checkpoint_every=1), fused_round=fused))
        wants[fit, kernel, fused] = (res, ck)
    jax_pod = json.loads(json.dumps(pod_sequence("jax")))
    for case, procs in running.items():
        n, fit, kernel = case
        got = rank_results(wait_ranks(procs), "RANK_OK")
        want, jck = wants[fit, kernel, False]
        jfiles = sorted(os.listdir(jck))
        final = np.flatnonzero(np.load(jck / jfiles[-1])["labeled_mask"]).tolist()
        for r, g in enumerate(got):
            assert g["accs"] == [x.accuracy for x in want.records], (case, r)
            assert g["labeled"] == [x.n_labeled for x in want.records], (case, r)
            assert g["mask"] == final, (case, r)
            assert (g["probe"] is not None) == (r == 0), (case, r, g["probe"])
            assert g["crossing"] == _CROSSING[n][r], (case, r, g["crossing"])
            assert all(g["collectives"].values()), (case, r, g["collectives"])
            assert g["fits"] == got[0]["fits"], (case, r)  # the same forest bytes on every rank
            if "pod" in g:
                assert g["pod"] == jax_pod, (case, r)
        assert (len(got[0]["fits"]) == 3) == (fit == "device"), case
        assert ("pod" in got[0]) == (case == (2, "device", "pallas")), case
        model_axis = [f"{d}x{m}_{f}" for d, m in _MP_MODEL_AXIS.get(case, ())
                      for f in ("unfused", "fused")]
        assert sorted(got[0]["model_axis"]) == sorted(model_axis), case
        for name in model_axis:
            fused = name.endswith("_fused")
            want_m, jck_m = wants[fit, "pallas" if fused else kernel, fused]
            jfiles_m = sorted(os.listdir(jck_m))
            final_m = np.flatnonzero(np.load(jck_m / jfiles_m[-1])["labeled_mask"]).tolist()
            for r, g in enumerate(got):
                m = g["model_axis"][name]
                assert m["accs"] == [x.accuracy for x in want_m.records], (case, name, r)
                assert m["labeled"] == [x.n_labeled for x in want_m.records], (case, name, r)
                assert m["mask"] == final_m, (case, name, r)
            ck_dir = tmp_path / f"mp_{n}_{fit}_{kernel}" / name
            assert sorted(f for f in os.listdir(ck_dir) if f.endswith(".npz")) == jfiles_m, \
                (case, name)
            for f in jfiles_m:
                a, b = _ckpt_payload(ck_dir / f), _ckpt_payload(jck_m / f)
                assert a.keys() == b.keys(), (case, name, f)
                for k in a:
                    assert (np.array_equal(a[k], b[k]) if k != "records" else a[k] == b[k]), \
                        (case, name, f, k)
        if "sweep" in got[0]:  # == the single-process sweep, lane by lane
            from distributed_active_learning_tpu_torch.runtime import sweep as t_sweep

            single = t_config.from_dict(dataclasses.asdict(experiment_cfg(mesh_data=1)))
            lanes = t_sweep.run_sweep(_sweep_cfg(single), [0, 1], device="cpu")
            assert all(g["sweep"] == [[list(x) for x in _records(r)] for r in lanes] for g in got)
        d = tmp_path / f"mp_{n}_{fit}_{kernel}"
        files = sorted(f for f in os.listdir(d / "ckpt") if f.endswith(".npz"))
        assert files == jfiles == ["alstate_1.npz", "alstate_2.npz", "alstate_3.npz"], case
        for f in files:
            a, b = _ckpt_payload(d / "ckpt" / f), _ckpt_payload(jck / f)
            assert a.keys() == b.keys(), (case, f)
            for k in a:
                assert np.array_equal(a[k], b[k]) if k != "records" else a[k] == b[k], (case, f, k)
        events = [json.loads(ln) for ln in open(d / "metrics.jsonl")]
        gauge = next(e for e in events if e["kind"] == "gauge" and "per_host" in e)
        assert gauge["per_host"] == [10.0 * r + 7 for r in range(n)], gauge
        assert gauge["value"] == sum(gauge["per_host"]) and gauge["rank"] == 0
        meta = next(e for e in events if e["kind"] == "meta")
        assert (meta["process_count"], meta["process_group_backend"]) == (n, "gloo"), meta


def _sweep_cfg(cfg):
    return dataclasses.replace(cfg, checkpoint_dir=None, checkpoint_every=0, rounds_per_launch=2)


def neural_case():
    """JAX's 2-process neural case (``tests/multihost_expcfg.
    neural_experiment``): its MLP BALD run's pool, test set, learner
    arguments and config fields, for both packages."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(128, 4)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32)
    tx = rng.normal(size=(64, 4)).astype(np.float32)
    ty = (tx[:, 0] + 0.5 * tx[:, 1] > 0).astype(np.int32)
    learner = dict(input_shape=(4,), train_steps=20, mc_samples=3)
    cfg = dict(strategy="bald", window_size=8, n_start=10, max_rounds=2, seed=3)
    return (x, y, tx, ty), learner, cfg


def _collectives_match_one_process(rank, n):
    """Each collective over processes (this rank passing its one shard's
    input) against one process holding every shard's: bit for bit."""
    from distributed_active_learning_tpu_torch.parallel import collectives as c
    from distributed_active_learning_tpu_torch.parallel import multihost
    from distributed_active_learning_tpu_torch.parallel.mesh import Spread

    rng = np.random.default_rng(3)
    vecs = [torch.from_numpy(rng.normal(size=7).astype(np.float32)) for _ in range(n)]
    masks = [torch.from_numpy(rng.random(7) < 0.5) for _ in range(n)]
    fills = [torch.tensor(5 * s + 1, dtype=torch.int32) for s in range(n)]
    blocks = [torch.from_numpy(rng.integers(0, 99, size=(n, 3)).astype(np.int32))
              for _ in range(n)]
    mine = slice(rank, rank + 1)
    row = slice(rank // 2, rank // 2 + 1)  # rows of 2 ranks: each row counted once
    whole, pairs = Spread(n, n, 1, rank), Spread(n, 2, 2, rank)
    # Cells that cross a row partway: (3, 2) over 2 ranks, (3, 4) over 4,
    # whose row groups overlap (a rank holds two rows, owners own unequal
    # counts, a rank may own none).
    cross = Spread(n, 3, 2 if n == 2 else 4, rank)
    multihost.make_groups(g for g in dict.fromkeys(pairs.row_groups + cross.row_groups)
                          if len(g) > 1)
    row_vecs = [torch.from_numpy(rng.normal(size=7).astype(np.float32)) for _ in range(3)]
    row_masks = [torch.from_numpy(rng.random(5) < 0.5) for _ in range(3)]
    cells = [[torch.from_numpy(rng.integers(0, 9, size=5).astype(np.int32))
              for _ in range(cross.model)] for _ in range(3)]
    held = list(cross.rows)
    over_rows = {} if n != 4 else {
        "vector_accumulate_rows": torch.equal(c.vector_accumulate(vecs[row], pairs),
                                              c.vector_accumulate(vecs[:2])),
        "gather_fills_rows": torch.equal(c.gather_fills(fills[row], pairs),
                                         c.gather_fills(fills[:2])),
        "row_accumulate": torch.equal(c.row_accumulate(vecs[mine], pairs, rank // 2),
                                      c.vector_accumulate(vecs[rank - rank % 2:][:2])),
    }
    crossing = {
        "vector_accumulate_cross": torch.equal(
            c.vector_accumulate([row_vecs[s] for s in held], cross),
            c.vector_accumulate(row_vecs)),
        "global_count_cross": torch.equal(c.global_count([row_masks[s] for s in held], cross),
                                          c.global_count(row_masks)),
        "row_accumulate_cross": all(torch.equal(
            c.row_accumulate([cells[s][m] for m in cross.cols_of(rank, s)], cross, s),
            c.vector_accumulate(cells[s])) for s in held),
        "owner_gather_cross": all(torch.equal(a, b) for a, b in zip(
            c.owner_gather([row_vecs[s] for s in held], cross), row_vecs, strict=True)),
    }
    return {**over_rows, **crossing,
        "vector_accumulate": torch.equal(c.vector_accumulate(vecs[mine], whole),
                                         c.vector_accumulate(vecs)),
        "global_count": torch.equal(c.global_count(masks[mine], whole),
                                    c.global_count(masks)),
        "gather_fills": torch.equal(c.gather_fills(fills[mine], whole),
                                    c.gather_fills(fills)),
        "exchange_blocks": torch.equal(c.exchange_blocks(blocks[mine], whole)[0],
                                       c.exchange_blocks(blocks)[rank]),
        "masked_mean": torch.equal(c.masked_mean(vecs[mine], masks[mine], whole),
                                   c.masked_mean(vecs, masks)),
    }


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pod_sequence(side: str):
    """The pod of ``tests/test_torch_serving.py::_pod_parity`` (its sizes
    and draws) on a (4, 1) mesh, driven by the JAX package in this process
    (``side="jax"``, the forced host devices) or by the port in a rank of a
    2-process job (``side="torch"``: 2 rows a rank): placement, three routed
    ingests, an epoch, the fused select over the ingest-built pool (a forest
    fitted on its contents by the package's own device fit), a growth, two
    appends and epochs until the plan is empty. Returns every leaf's digest
    after each step, the fills, every epoch's index maps and the picks."""
    if side == "jax":
        import jax.numpy as jnp

        from distributed_active_learning_tpu.ops.trees_pallas import PallasForest, ShardedPallasForest
        from distributed_active_learning_tpu.serving import slab

        mesh = j_make_mesh(data=4, model=1, devices=jax.devices()[:4])
        to, host, train, key = jnp.asarray, lambda a: np.asarray(jax.device_get(a)), j_train, \
            jax.random.key(0)

        def sharded(gf):
            return ShardedPallasForest(gf=gf, mesh=mesh)
    else:
        from distributed_active_learning_tpu_torch.parallel import gather as t_gather
        from distributed_active_learning_tpu_torch.serving import slab

        mesh = t_mesh.make_mesh(4, 1, device="cpu")
        to, host, train, key = torch.as_tensor, lambda a: t_gather(a).numpy(), t_train, prng.key(0)

        def sharded(gf):
            return t_pallas.attach_mesh(t_pallas.PallasForest(gf=gf), mesh)
    rng = np.random.default_rng(11)
    x0 = rng.normal(size=(32, 4)).astype(np.float32)
    y0 = (x0[:, 0] > 0).astype(np.int32)
    mask0 = np.zeros(32, bool)
    mask0[rng.permutation(32)[:12]] = True
    xa = rng.normal(size=(40, 4)).astype(np.float32)
    ya = (xa[:, 0] > 0).astype(np.int32)
    edges = train.make_bins(to(x0), 8).edges
    pool = slab.shard_slab_pool(slab.init_slab_pool(to(x0), to(y0), to(mask0), edges, 64), mesh)
    out = {"leaves": [], "fills": [], "maps": []}

    def note(pool):
        out["leaves"].append([_digest(host(getattr(pool, f))) for f in
                              ("x", "oracle_y", "labeled_mask", "codes", "n_filled")])
        out["fills"].append(host(pool.n_filled).tolist())

    def ingest(pool, blocks):
        fn = slab.make_sharded_ingest_fn(mesh)
        for bx, by, count in blocks:
            shard = slab.route_to_shard(host(pool.n_filled))
            pool, _ = fn(pool, edges, to(bx), to(by), count, shard)
            note(pool)
        return pool

    def epoch(pool):
        pool, src, dst = slab.make_rebalance_fn(mesh, 8)(pool)
        out["maps"].append([host(src).tolist(), host(dst).tolist()])
        note(pool)
        return pool

    note(pool)
    pool = ingest(pool, [(xa[0:8], ya[0:8], 8), (xa[8:16], ya[8:16], 8),
                         (np.concatenate([xa[16:21], np.zeros((3, 4), np.float32)]),
                          np.concatenate([ya[16:21], np.zeros(3, np.int32)]), 5)])
    pool = epoch(pool)
    x, y, m = (host(getattr(pool, f)) for f in ("x", "oracle_y", "labeled_mask"))
    valid = np.concatenate([np.arange(16) < f for f in host(pool.n_filled)])
    binned = train.make_bins(to(x), 8)
    c, yy, w = train.gather_fit_window(binned.codes, to(y), to(m & valid), 128)
    f, th, v = train.fit_forest_device(c, yy, w, binned.edges, key, n_trees=8, max_depth=3,
                                       n_bins=8)
    forest = sharded(train.heap_gemm_forest(f, th, v, 3))
    fused = j_fused if side == "jax" else t_fused
    vals, picks = fused.fused_score_select(forest, pool.x, to(valid & ~m), "uncertainty", 7)
    out["select"] = [host(vals).view(np.int32).tolist(), host(picks).tolist()]
    pool = slab.grow_sharded_slab(pool, mesh)
    note(pool)
    pool = ingest(pool, [(xa[21:29], ya[21:29], 8), (xa[29:37], ya[29:37], 8)])
    for _ in range(8):
        if not host(slab.rebalance_plan(pool.n_filled, 8)).any():
            break
        pool = epoch(pool)
    return out


def _rank_main(mode, out_dir, *rest):
    """One rank of a spawned job (:func:`spawn_ranks`): joins the gloo group
    through the env trio and prints ``RANK_OK <rank> {json}``."""
    from tests.multihost_expcfg import experiment_cfg

    from distributed_active_learning_tpu_torch.parallel import multihost
    from distributed_active_learning_tpu_torch.runtime import checkpoint as t_ckpt
    from distributed_active_learning_tpu_torch.runtime.results import ExperimentResult
    from distributed_active_learning_tpu_torch.runtime.telemetry import MetricsWriter

    assert multihost.maybe_initialize()
    rank, n = multihost.process_index(), multihost.process_count()
    assert multihost.is_primary() == (rank == 0)
    out = {}
    if mode == "forest":
        fit, kernel = rest
        fits = []
        fit_device = t_train.fit_forest_device

        def recorded(*a, **k):  # every fit's forest bytes, to compare across ranks
            arrays = fit_device(*a, **k)
            fits.append(hashlib.sha256(b"".join(
                t.contiguous().numpy().tobytes() for t in arrays)).hexdigest())
            return arrays

        t_train.fit_forest_device = recorded
        cfg = t_config.from_dict(dataclasses.asdict(experiment_cfg(
            mesh_data=n, checkpoint_dir=os.path.join(out_dir, "ckpt"), checkpoint_every=1,
            fit=fit, kernel=kernel)))
        res = t_loop.run_experiment(cfg, device="cpu")
        t_train.fit_forest_device = fit_device
        if (n, fit, kernel) == (2, "device", "gather"):  # a seed sweep on the mesh, chunked
            from distributed_active_learning_tpu_torch.runtime import sweep as t_sweep

            lanes = t_sweep.run_sweep(_sweep_cfg(cfg), [0, 1], device="cpu")
            out["sweep"] = [_records(r) for r in lanes]
        out.update(accs=[r.accuracy for r in res.records],
                   labeled=[r.n_labeled for r in res.records],
                   mask=torch.nonzero(res.final_labeled_mask).flatten().tolist(), fits=fits)
        # The primary-only gate outside the loop, as JAX's worker probes it.
        st = t_state.init_pool_state(np.zeros((8, 2), np.float32), np.zeros(8, np.int32),
                                     prng.key(0), "cpu")
        out["probe"] = t_ckpt.save(os.path.join(out_dir, "probe"), st, ExperimentResult())
        writer = MetricsWriter(os.path.join(out_dir, "metrics.jsonl"))
        t_loop.run_experiment(dataclasses.replace(cfg, checkpoint_dir=None, checkpoint_every=0,
                                                  max_rounds=1), metrics=writer, device="cpu")
        writer.gauges({"probe_gauge": 10.0 * rank + 7}, allgather=True)
        writer.close()
        # The model axis across processes: a row over 2 ranks, or 1 of 4.
        out["model_axis"] = {}
        for data, model in _MP_MODEL_AXIS.get((n, fit, kernel), ()):
            for fused in (False, True):
                name = f"{data}x{model}_{'fused' if fused else 'unfused'}"
                res = t_loop.run_experiment(dataclasses.replace(
                    cfg, mesh=t_config.MeshConfig(data, model), fused_round=fused,
                    forest=dataclasses.replace(cfg.forest, kernel="pallas" if fused else kernel),
                    checkpoint_dir=os.path.join(out_dir, name)), device="cpu")
                out["model_axis"][name] = dict(
                    accs=[r.accuracy for r in res.records],
                    labeled=[r.n_labeled for r in res.records],
                    mask=torch.nonzero(res.final_labeled_mask).flatten().tolist())
        if (n, fit, kernel) == (2, "device", "pallas"):
            out["pod"] = pod_sequence("torch")
        # Cells that cross a row boundary partway: 3 (or 6) rows of 2.
        crossing = t_mesh.make_mesh(3 * n // 2, 2, device="cpu")
        out["crossing"] = [[s, [c0 + j for j in range(len(row))]] for s, c0, row in zip(
            crossing.spread.rows, crossing.col_offsets, crossing.devices)]
        out["collectives"] = _collectives_match_one_process(rank, n)
    elif mode == "neural":
        from distributed_active_learning_tpu_torch.models.neural import MLP, NeuralLearner
        from distributed_active_learning_tpu_torch.runtime import neural_loop as t_nloop

        data, lkw, ckw = neural_case()
        learner = NeuralLearner(MLP(n_classes=2, hidden=(16,)), device="cpu", **lkw)
        res = t_nloop.run_neural_experiment(
            t_nloop.NeuralExperimentConfig(mesh=t_config.MeshConfig(data=n),
                                           checkpoint_dir=os.path.join(out_dir, "ckpt"),
                                           checkpoint_every=1, **ckw), learner, *data)
        out.update(accs=[r.accuracy for r in res.records],
                   labeled=[r.n_labeled for r in res.records],
                   mask=torch.nonzero(res.final_labeled_mask).flatten().tolist())
    print(f"RANK_OK {rank} {json.dumps(out)}", flush=True)


def _metric_dicts(res):
    return [r.metrics for r in res.records]


def _metrics_equal(got, want):
    from distributed_active_learning_tpu_torch.runtime.telemetry import POOL_ENTROPY_RTOL

    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "pool_entropy":
                assert abs(g[k] - w[k]) <= POOL_ENTROPY_RTOL * abs(w[k]), (k, g[k], w[k])
            else:
                assert g[k] == w[k], (k, g[k], w[k])


def _mesh_chunk_and_metrics_match_jax():
    """The chunk and RoundMetrics under the 4 x 2 mesh against the JAX
    package's runs of its own tests' configurations."""
    def cfgs(mesh, k, fused=False, rounds=5, metrics=False):
        j = j_config.ExperimentConfig(
            data=j_config.DataConfig(name="checkerboard2x2", n_samples=250, seed=2),
            forest=j_config.ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
            strategy=j_config.StrategyConfig(name="uncertainty", window_size=10),
            mesh=j_config.MeshConfig(*mesh), n_start=10, max_rounds=rounds, seed=7,
            rounds_per_launch=k, fused_round=fused, collect_metrics=metrics)
        return j, t_config.from_dict(dataclasses.asdict(j))

    for fused in (False, True):
        j1, _ = cfgs((1, 1), 1, fused)
        jm, tm = cfgs((4, 2), 4, fused)
        want = j_loop.run_experiment(jm if fused else j1)
        got = t_loop.run_experiment(tm, device="cpu")
        assert _records(got) == _records(want), fused
        assert got.pipeline_stats is not None  # the chunked driver ran
        np.testing.assert_array_equal(got.final_labeled_mask.numpy(), _jax_final_mask(j1))
    j1, _ = cfgs((1, 1), 1, rounds=4, metrics=True)
    want = j_loop.run_experiment(j1)
    for k in (1, 4):
        _, tm = cfgs((4, 2), k, rounds=4, metrics=True)
        got = t_loop.run_experiment(tm, device="cpu")
        assert _records(got) == _records(want), k
        _metrics_equal(_metric_dicts(got), _metric_dicts(want))


@pytest.mark.slow
@pytest.mark.parametrize("strategy", ["random", "soft_uncertainty", "entropy", "full_entropy",
                                      "margin"])
@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (4, 2)])
def test_mesh_run_matrix_matches_jax(devices, strategy, mesh):
    fused_options = (False, True) if strategy in t_fused.FUSED_STRATEGIES else (False,)
    for fused in fused_options:
        _check_mesh_run(fused, strategy, mesh)


@pytest.mark.slow
def test_mesh_window_past_shard_rows_matches_jax(devices):
    # 8 shards of 32 rows (250 padded to 256) and a 40-row window: every
    # shard's window is padded with sentinels before the ring merge.
    for fused in (False, True):
        _check_mesh_run(fused, mesh=(8, 1), window=40)


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
