"""Parity of the port's neural path with the JAX package's (``models/neural.py``,
``models/transformer.py``, ``strategies/deep.py``, ``runtime/neural_loop.py``,
the neural checkpoint and the CLI's ``--neural``).

Inputs are made from seeds with numpy and fed to both packages. What is held
bit for bit: the initial parameters (flax's keys and initializers), the
dropout masks, the training batch indices, every deep-strategy pick, and a
run's labeled counts, masks and keys. What is held to a stated tolerance:
forward passes (``FORWARD_RTOL``, float sums in another order), trained
parameters (``NEURAL_TRAIN_RTOL``) and accuracies (``ACC_ATOL``). Within the
port the per-round driver, the chunked driver and a seed sweep's lanes are
held bit for bit. Ring attention and the encoder running it are held to JAX's
``ring_attention`` on 8 host devices (``RING_ATOL``) and to full attention
(``RING_VS_FULL_ATOL``); the loop under ``MeshConfig(data=8)`` to JAX's same
run, as above (``_mesh_loop_matches_jax``).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from distributed_active_learning_tpu import run as j_run
from distributed_active_learning_tpu.models import neural as j_neural
from distributed_active_learning_tpu.models import transformer as j_transformer
from distributed_active_learning_tpu.runtime import neural_loop as j_loop
from distributed_active_learning_tpu.runtime import telemetry as j_telemetry
from distributed_active_learning_tpu.strategies import deep as j_deep
from distributed_active_learning_tpu_torch import interop, prng
from distributed_active_learning_tpu_torch import run as t_run
from distributed_active_learning_tpu_torch.config import MeshConfig
from distributed_active_learning_tpu_torch.models import neural as t_neural
from distributed_active_learning_tpu_torch.models import transformer as t_transformer
from distributed_active_learning_tpu_torch.ops import threefry
from distributed_active_learning_tpu_torch.runtime import neural_loop as t_loop
from distributed_active_learning_tpu_torch.runtime import telemetry as t_telemetry
from distributed_active_learning_tpu_torch.strategies import deep as t_deep
from tests.torch_threads import capped_torch_threads  # noqa: F401  (autouse)

# Forward passes: the same weights and masks, float sums in another order.
FORWARD_RTOL = 1e-5
# Test accuracy is a mean of 0/1 hits: equal hit counts give equal values up
# to the division's last bit.
ACC_ATOL = 1e-6
# Deep scores on the same probabilities: XLA's sums over classes are not in
# index order (and may be vectorized), so scores differ in their last bits;
# the picks are compared exactly.
SCORE_ATOL = 1e-6

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _models():
    return [
        ("mlp", j_neural.MLP(hidden=(16,)), t_neural.MLP(hidden=(16,)), (4,)),
        ("cnn", j_neural.SmallCNN(n_classes=2, dropout_rate=0.1),
         t_neural.SmallCNN(n_classes=2, dropout_rate=0.1), (8, 8, 3)),
        ("transformer",
         j_transformer.TransformerClassifier(vocab_size=64, max_len=8, d_model=16, n_heads=2,
                                             n_layers=1, d_ff=32),
         t_transformer.TransformerClassifier(vocab_size=64, max_len=8, d_model=16, n_heads=2,
                                             n_layers=1, d_ff=32), (8,)),
    ]


def _inputs(kind, shape, n, rs):
    if kind == "transformer":
        return rs.randint(0, 64, size=(n, *shape)).astype(np.int32), rs.randint(0, 4, n)
    return rs.randn(n, *shape).astype(np.float32), rs.randint(0, 2, n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-30)))


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params).items()}


def test_neural_modules_match_jax():
    rs = np.random.RandomState(0)
    for kind, jm, tm, shape in _models():
        assert repr(tm) == repr(jm), kind  # the fingerprint hashes it
        jl = j_neural.NeuralLearner(jm, shape, train_steps=5, batch_size=8, mc_samples=3,
                                    predict_chunk=7)
        tl = t_neural.NeuralLearner(tm, shape, train_steps=5, batch_size=8, mc_samples=3,
                                    predict_chunk=7, device="cpu")
        js, ts = jl.init(jax.random.key(5)), tl.init(prng.key(5))
        # Init bit for bit, and the carry-across function both ways.
        carried = interop.neural_params_from_numpy(jax.device_get(js.params), tm, device="cpu")
        assert set(carried) == set(ts.params) == set(tm.param_names()), kind
        for name, v in carried.items():
            assert torch.equal(v, ts.params[name]), (kind, name)
        back = _flat(interop.neural_params_to_numpy(ts.params, tm))
        flat_j = _flat(js.params)
        assert back.keys() == flat_j.keys()
        for k, v in flat_j.items():
            np.testing.assert_array_equal(back[k], v)

        # Dropout masks: flax's bernoulli at each Dropout's own path.
        keys = t_neural.batched_dropout_keys(prng.key(9)[None], tm.dropout_paths())
        rng = t_neural.DropoutRng({p: k[0] for p, k in keys.items()})
        for path in tm.dropout_paths():
            j_key = jax.random.fold_in(jax.random.key(9),
                                       jnp.uint32(t_neural.path_hash(path + (1,))))
            keep = 1.0 - tm.dropout_rate
            jmask = jax.random.bernoulli(j_key, keep, (6, 5))
            np.testing.assert_array_equal(np.asarray(jmask), rng.mask(path, (6, 5), keep).numpy())

        # Forward passes, with pools longer than the predict chunk.
        x, y = _inputs(kind, shape, 30, rs)
        xj, xt = jnp.asarray(x), torch.as_tensor(x)
        assert _rel(jl.predict_proba(js, xj), tl.predict_proba(ts, xt)) < FORWARD_RTOL
        np.testing.assert_allclose(np.asarray(jl.embed(js, xj)), tl.embed(ts, xt).numpy(),
                                   rtol=FORWARD_RTOL, atol=FORWARD_RTOL)
        sj = jl.predict_proba_samples(js, xj, jax.random.key(9))
        st = tl.predict_proba_samples(ts, xt, prng.key(9))
        assert _rel(sj, st) < FORWARD_RTOL, kind

        # Five adam steps: the batch indices bit for bit, the parameters to
        # NEURAL_TRAIN_RTOL of each leaf's scale.
        mask = rs.rand(30) < 0.4
        logits = jnp.where(jnp.asarray(mask), 0.0, -jnp.inf)
        k_idx, _ = tl.step_keys(prng.key(11))
        for t, k in enumerate(jax.random.split(jax.random.key(11), 5)):
            ji = jax.random.categorical(jax.random.split(k)[0], jnp.broadcast_to(logits, (8, 30)))
            ti = threefry.categorical(k_idx[t], torch.tensor(np.asarray(logits)), 8)
            np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
        js2 = jl.fit_on_mask(js, xj, jnp.asarray(y, jnp.int32), jnp.asarray(mask),
                             jax.random.key(11))
        ts2 = tl.fit_on_mask(ts, xt, torch.as_tensor(y, dtype=torch.int32),
                             torch.as_tensor(mask), prng.key(11))
        assert int(ts2.step) == int(js2.step) == 5 and int(ts2.opt_state.count) == 5
        for name, v in interop.neural_params_from_numpy(jax.device_get(js2.params), tm,
                                                         device="cpu").items():
            scale = float(v.abs().max()) or 1.0
            err = float((v - ts2.params[name]).abs().max()) / scale
            assert err < t_neural.NEURAL_TRAIN_RTOL, (kind, name, err)
        assert _rel(jl.predict_proba(js2, xj), tl.predict_proba(ts2, xt)) < t_neural.NEURAL_TRAIN_RTOL

    _ring_attention_matches_jax(rs)

    long_ids = torch.zeros((2, 9), dtype=torch.int32)
    tm = _models()[2][2]
    with pytest.raises(ValueError, match="exceeds max_len=8"):
        t_neural.NeuralLearner(tm, (9,), device="cpu").predict_proba(
            t_neural.NeuralLearner(tm, (8,), device="cpu").init(prng.key(0)), long_ids)
    # A learner built without a device runs on the card; with no card it
    # raises, naming device="cpu".
    if torch.cuda.is_available():
        assert t_neural.NeuralLearner(tm, (8,)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_neural.NeuralLearner(tm, (8,))
    # So do the converters that carry the JAX package's arrays across.
    state_of = lambda: interop.pool_state_from_numpy(  # noqa: E731
        np.zeros((2, 1)), np.zeros(2), np.zeros(2, bool), np.zeros(2, np.uint32))
    forest_of = lambda: interop.gemm_forest_from_numpy(  # noqa: E731
        np.zeros((1, 1)), np.zeros((1, 1)), np.zeros((1, 1, 2)), np.zeros((1, 2)),
        np.zeros((1, 2)))
    if torch.cuda.is_available():
        assert state_of().x.device.type == forest_of().path.device.type == "cuda"
        with pytest.raises(ValueError, match="are not those of"):
            interop.neural_params_from_numpy({}, tm)
    else:
        for convert in (state_of, forest_of, lambda: interop.neural_params_from_numpy({}, tm)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                convert()

    # Every deep function on the same probabilities and embeddings.
    S, n, C = 4, 120, 3
    lg = rs.randn(S, n, C).astype(np.float32) * 2
    p = np.exp(lg) / np.exp(lg).sum(-1, keepdims=True)
    p = p.astype(np.float32)
    unl = rs.rand(n) < 0.8
    emb = rs.randn(n, 6).astype(np.float32)
    P, U, E = torch.as_tensor(p), torch.as_tensor(unl), torch.as_tensor(emb)
    for name in ("predictive_entropy", "expected_conditional_entropy", "bald_score",
                 "mean_std_score", "variation_ratio", "margin_score"):
        np.testing.assert_allclose(np.asarray(jax.jit(getattr(j_deep, name))(jnp.asarray(p))),
                                   getattr(t_deep, name)(P).numpy(), rtol=0, atol=SCORE_ATOL)
    for max_configs in (4096, 20):  # exact joint throughout; the MC switch after two picks
        jp, jv = j_deep.batchbald_select(jnp.asarray(p), jnp.asarray(unl), 10, max_configs, 50,
                                         16, key=jax.random.key(3))
        tp, tv = t_deep.batchbald_select(P, U, 10, max_configs, 50, 16, key=prng.key(3))
        assert np.asarray(jp).tolist() == tp.tolist(), max_configs
        np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=0, atol=1e-5)
    jp, jd = j_deep.coreset_select(jnp.asarray(emb), jnp.asarray(~unl), 7, 16)
    tp, td = t_deep.coreset_select(E, ~U, 7, 16)
    assert np.asarray(jp).tolist() == tp.tolist()
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(j_deep.coreset_min_dists(jnp.asarray(emb),
                                                                   jnp.asarray(~unl), 16)),
                               t_deep.coreset_min_dists(E, ~U, 16).numpy(), rtol=1e-5,
                               atol=1e-5)  # a center's own distance is a rounding residue
    pm = p.mean(0)
    jp = j_deep.badge_select(jnp.asarray(pm), jnp.asarray(emb), jnp.asarray(unl), 9,
                             jax.random.key(4))
    tp = t_deep.badge_select(torch.as_tensor(pm), E, U, 9, prng.key(4))
    assert np.asarray(jp).tolist() == tp.tolist()


# Ring attention against the JAX package's on 8 host devices: the same
# online-softmax arithmetic in the same order, float sums in another order.
RING_ATOL = 1e-5
# Ring attention (and the encoder running it) against full attention: the
# JAX test's own bound (tests/test_ring_attention.py).
RING_VS_FULL_ATOL = 2e-4
# The learner's passes over a row-sharded pool against one device's: JAX's
# own bound (tests/test_neural_runtime.py).
SHARDED_PREDICT_ATOL = 1e-6


def _ring_attention_matches_jax(rs):
    import functools

    from jax.sharding import Mesh

    from distributed_active_learning_tpu.ops import ring_attention as j_ra
    from distributed_active_learning_tpu_torch.ops import ring_attention as t_ra
    from distributed_active_learning_tpu_torch.parallel import make_mesh, shard_rows

    jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8), ("sp",))
    tmesh = make_mesh(8, 1, device="cpu")
    q, k, v = (rs.randn(2, 32, 4, 8).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    for causal in (False, True):
        want = np.asarray(j_ra.ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              jmesh, causal=causal))
        got = t_ra.ring_attention(tq, tk, tv, tmesh, causal=causal).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=RING_ATOL, err_msg=str(causal))
        np.testing.assert_allclose(got, t_ra.full_attention(tq, tk, tv, causal=causal).numpy(),
                                   rtol=0, atol=RING_VS_FULL_ATOL)
    with pytest.raises(ValueError, match="not divisible"):
        t_ra.ring_attention(tq[:, :30], tk[:, :30], tv[:, :30], tmesh)
    # The encoder with the same parameters over the ring: JAX's logits (its
    # ring encoder) and the port's full-attention logits.
    kw = dict(vocab_size=64, max_len=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
              n_classes=4)
    jm = j_transformer.TransformerClassifier(
        **kw, attention_fn=functools.partial(j_ra.ring_attention, mesh=jmesh))
    tm_full = t_transformer.TransformerClassifier(**kw)
    tm_ring = t_transformer.TransformerClassifier(
        **kw, attention_fn=functools.partial(t_ra.ring_attention, mesh=tmesh))
    ids = rs.randint(0, 64, size=(2, 32)).astype(np.int32)
    params = jm.init({"params": jax.random.key(4)}, jnp.asarray(ids))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
    tp = interop.neural_params_from_numpy(jax.device_get(params), tm_full, device="cpu")
    ctx = t_neural._Ctx(None, 2)
    got = tm_ring.apply(tp, torch.as_tensor(ids), ctx).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RING_VS_FULL_ATOL)
    np.testing.assert_allclose(got, tm_full.apply(tp, torch.as_tensor(ids), ctx).detach().numpy(),
                               rtol=0, atol=RING_VS_FULL_ATOL)
    # The learner on a row-sharded pool: each shard's rows, its MC masks at
    # their global rows (chunks crossing the shard boundaries), equal to the
    # single-device pass to JAX's bound for the same check
    # (test_sharded_mc_predict_matches_single_device: the products batch
    # other row counts, so their sums may round apart).
    tl = t_neural.NeuralLearner(tm_full, (32,), mc_samples=3, predict_chunk=5, device="cpu")
    net = tl.init(prng.key(3))
    pool = torch.as_tensor(rs.randint(0, 64, size=(36, 32)).astype(np.int32))
    sharded = shard_rows(pool, make_mesh(4, 1, device="cpu"), replicate=True)
    for fn in (lambda p: tl.predict_proba_samples(net, p, prng.key(4)),
               lambda p: tl.embed(net, p)):
        np.testing.assert_allclose(fn(sharded).numpy(), fn(pool).numpy(), rtol=0,
                                   atol=SHARDED_PREDICT_ATOL)


def _pool():
    rs = np.random.RandomState(0)
    x = rs.randn(200, 4).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32)
    tx = rs.randn(60, 4).astype(np.float32)
    ty = (tx[:, 0] + 0.5 * tx[:, 1] > 0).astype(np.int32)
    return x, y, tx, ty


def _records(result):
    return [(r.round, r.n_labeled, r.n_unlabeled, r.accuracy) for r in result.records]


def _close_records(rj, rt):
    assert [(r.round, r.n_labeled) for r in rj.records] == \
        [(r.round, r.n_labeled) for r in rt.records]
    for a, b in zip(rj.records, rt.records):
        assert abs(a.accuracy - b.accuracy) <= ACC_ATOL


def _multi_process_loop_matches_jax(tmp_path):
    """JAX's 2-process neural case (MLP BALD, tests/test_multihost_2proc.py)
    on 2 port processes over gloo against JAX's single-process run: every
    rank's picks and final mask bit-equal, accuracy to ACC_ATOL; rank 0
    alone writes the 2 checkpoints, their masks and keys bit-equal to JAX's,
    the network to NEURAL_TRAIN_RTOL."""
    from tests.test_torch_mesh import neural_case, rank_results, spawn_ranks, wait_ranks

    d = tmp_path / "mp_neural"
    d.mkdir()
    procs = spawn_ranks(2, [os.path.join(_REPO, "tests", "test_torch_mesh.py"), "neural", str(d)],
                        d)
    data, lkw, ckw = neural_case()
    jd = str(tmp_path / "mp_neural_jax")
    jl = j_neural.NeuralLearner(j_neural.MLP(n_classes=2, hidden=(16,)), lkw["input_shape"],
                                train_steps=lkw["train_steps"], mc_samples=lkw["mc_samples"])
    rj = j_loop.run_neural_experiment(
        j_loop.NeuralExperimentConfig(checkpoint_dir=jd, checkpoint_every=1, **ckw), jl, *data)
    got = rank_results(wait_ranks(procs), "RANK_OK")
    files = sorted(os.listdir(d / "ckpt"))
    assert files == sorted(os.listdir(jd)) == ["alstate_1.npz", "alstate_2.npz"]
    final = np.flatnonzero(np.load(os.path.join(jd, files[-1]))["labeled_mask"]).tolist()
    for r, g in enumerate(got):
        assert g["labeled"] == [x.n_labeled for x in rj.records] and g["mask"] == final, r
        assert all(abs(a - x.accuracy) <= ACC_ATOL for a, x in zip(g["accs"], rj.records)), r
    for f in files:
        with np.load(d / "ckpt" / f) as zt, np.load(os.path.join(jd, f)) as zj:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                if k.startswith("net_"):
                    np.testing.assert_allclose(zt[k], zj[k], rtol=t_neural.NEURAL_TRAIN_RTOL,
                                               atol=1e-6, err_msg=f"{f} {k}")
                elif k != "records_json":
                    np.testing.assert_array_equal(zt[k], zj[k], err_msg=f"{f} {k}")


def _mesh_loop_matches_jax(tmp_path, jl, tl, base):
    """The neural loop under ``MeshConfig(data=8)`` against the JAX
    package's same run on 8 host devices: records (accuracy to ACC_ATOL),
    and the last checkpoint's mask and keys bit for bit, its network to
    NEURAL_TRAIN_RTOL. A 200-row pool (no padding; the mesh run equals the
    single-device run) and a 250-row one (padded to 256: the padding rows
    are never picked, never centers of coreset, and outside every count);
    chunked at K = 2 equal to per round; a checkpoint written on the mesh
    over the padded pool resumes on one device, and the reverse, as in
    JAX."""
    from distributed_active_learning_tpu.config import MeshConfig as JMeshConfig

    rs = np.random.RandomState(1)
    for strat, n in (("entropy", 200), ("coreset", 250), ("badge", 250)):
        if n == 200:
            x, y, tx, ty = _pool()
        else:
            x = rs.randn(n, 4).astype(np.float32)
            y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32)
            tx, ty = _pool()[2:]
        kw = dict(base, strategy=strat)
        dj, dt = str(tmp_path / f"mesh_j_{strat}"), str(tmp_path / f"mesh_t_{strat}")
        rj = j_loop.run_neural_experiment(j_loop.NeuralExperimentConfig(
            mesh=JMeshConfig(data=8), checkpoint_dir=dj, checkpoint_every=1, **kw),
            jl, x, y, tx, ty)
        rt = t_loop.run_neural_experiment(t_loop.NeuralExperimentConfig(
            mesh=MeshConfig(data=8), checkpoint_dir=dt, checkpoint_every=1, **kw),
            tl, x, y, tx, ty)
        _close_records(rj, rt)
        assert [r.n_unlabeled for r in rt.records] == [n - r.n_labeled for r in rt.records]
        with np.load(os.path.join(dj, "alstate_3.npz")) as zj, \
                np.load(os.path.join(dt, "alstate_3.npz")) as zt:
            for k in ("labeled_mask", "key", "loop_key", "round", "net_step"):
                np.testing.assert_array_equal(zj[k], zt[k], err_msg=f"mesh {strat} {k}")
            for k in zj.files:
                if k.startswith("net_"):
                    np.testing.assert_allclose(zt[k], zj[k], rtol=t_neural.NEURAL_TRAIN_RTOL,
                                               atol=1e-6, err_msg=f"mesh {strat} {k}")
            assert torch.equal(rt.final_labeled_mask, torch.as_tensor(zj["labeled_mask"]))
        rc = t_loop.run_neural_experiment(t_loop.NeuralExperimentConfig(
            mesh=MeshConfig(data=8), rounds_per_launch=2, **kw), tl, x, y, tx, ty)
        assert _records(rc) == _records(rt), strat
        assert torch.equal(rc.final_labeled_mask, rt.final_labeled_mask)
        if n == 200:
            single = t_loop.run_neural_experiment(t_loop.NeuralExperimentConfig(**kw), tl, x, y,
                                                  tx, ty)
            assert _records(single) == _records(rt)
            assert torch.equal(single.final_labeled_mask, rt.final_labeled_mask)
    # Resume across placements on the padded pool (bald): written on the
    # mesh, resumed on one device, and the reverse; JAX's resumed records.
    kw = dict(base, strategy="bald", checkpoint_every=1)
    for first, second in ((8, 1), (1, 8)):
        out = []
        for loop, mesh_cls, learner, tag in ((j_loop, JMeshConfig, jl, "j"),
                                              (t_loop, MeshConfig, tl, "t")):
            d = str(tmp_path / f"place_{first}_{second}_{tag}")
            for data, rounds in ((first, 2), (second, 2)):
                res = loop.run_neural_experiment(loop.NeuralExperimentConfig(
                    mesh=mesh_cls(data=data), checkpoint_dir=d, max_rounds=rounds,
                    **{k: v for k, v in kw.items() if k != "max_rounds"}), learner, x, y, tx, ty)
            out.append(res)
        _close_records(out[0], out[1])
        assert [r.round for r in out[1].records] == [1, 2, 3, 4]
        assert [r.n_labeled for r in out[1].records] == [10, 15, 20, 25]


def test_neural_loop_matches_jax(tmp_path):
    x, y, tx, ty = _pool()
    jl = j_neural.NeuralLearner(j_neural.MLP(hidden=(16,)), (4,), train_steps=10, mc_samples=2)
    tl = t_neural.NeuralLearner(t_neural.MLP(hidden=(16,)), (4,), train_steps=10, mc_samples=2,
                                device="cpu")
    base = dict(window_size=5, n_start=10, max_rounds=3, seed=1, batchbald_max_configs=8)
    assert (t_loop.neural_fingerprint(t_loop.NeuralExperimentConfig(**base), tl)
            == j_loop.neural_fingerprint(j_loop.NeuralExperimentConfig(**base), jl))
    assert t_loop.available_deep_strategies() == j_loop.available_deep_strategies()
    for strat in ("entropy", "bald", "batchbald", "coreset", "badge", "density", "random"):
        kw = dict(base, strategy=strat)
        dj, dt = str(tmp_path / f"j_{strat}"), str(tmp_path / f"t_{strat}")
        # JAX's run and the port's per-round run, both checkpointing every
        # round: the records and the final files (mask, keys) equal.
        rj = j_loop.run_neural_experiment(
            j_loop.NeuralExperimentConfig(checkpoint_dir=dj, checkpoint_every=1, **kw),
            jl, x, y, tx, ty)
        rt = t_loop.run_neural_experiment(
            t_loop.NeuralExperimentConfig(checkpoint_dir=dt, checkpoint_every=1, **kw),
            tl, x, y, tx, ty)
        _close_records(rj, rt)
        with np.load(os.path.join(dj, "alstate_3.npz")) as zj, \
                np.load(os.path.join(dt, "alstate_3.npz")) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in ("labeled_mask", "key", "loop_key", "round", "net_step",
                      "config_fingerprint"):
                np.testing.assert_array_equal(zj[k], zt[k], err_msg=f"{strat} {k}")
            for k in zj.files:
                if k.startswith("net_"):
                    np.testing.assert_allclose(zt[k], zj[k], rtol=t_neural.NEURAL_TRAIN_RTOL,
                                               atol=1e-6, err_msg=f"{strat} {k}")
        assert torch.equal(rt.final_labeled_mask,
                           torch.as_tensor(np.load(os.path.join(dj, "alstate_3.npz"))
                                           ["labeled_mask"]))

        # Within the port: chunked at K = 2 and a 2-seed sweep, bit for bit.
        cfg = t_loop.NeuralExperimentConfig(rounds_per_launch=2, **kw)
        rc = t_loop.run_neural_experiment(cfg, tl, x, y, tx, ty)
        assert _records(rc) == _records(rt), strat
        assert torch.equal(rc.final_labeled_mask, rt.final_labeled_mask)
        sweep = t_loop.run_neural_sweep(cfg, tl, x, y, tx, ty, seeds=[1, 2])
        r2 = t_loop.run_neural_experiment(t_loop.NeuralExperimentConfig(**dict(kw, seed=2)),
                                          tl, x, y, tx, ty)
        for lane, serial in zip(sweep, (rt, r2)):
            assert _records(lane) == _records(serial), strat
            assert torch.equal(lane.final_labeled_mask, serial.final_labeled_mask)

    # Checkpoints across packages: stopped at round 2 by one, resumed to
    # round 3 by the other, equal to the uninterrupted run (bald: MC
    # samples, random picks from k_rand).
    kw = dict(base, strategy="bald", checkpoint_every=1)
    full = t_loop.run_neural_experiment(t_loop.NeuralExperimentConfig(**kw), tl, x, y, tx, ty)
    for writer, reader in (("jax", "port"), ("port", "jax"), ("port", "port")):
        d = str(tmp_path / f"resume_{writer}_{reader}")
        first = dict(kw, checkpoint_dir=d, max_rounds=2)
        if writer == "jax":
            j_loop.run_neural_experiment(j_loop.NeuralExperimentConfig(**first), jl, x, y, tx, ty)
        else:
            t_loop.run_neural_experiment(
                t_loop.NeuralExperimentConfig(rounds_per_launch=2, **first), tl, x, y, tx, ty)
        second = dict(kw, checkpoint_dir=d, max_rounds=1)
        if reader == "jax":
            res = j_loop.run_neural_experiment(j_loop.NeuralExperimentConfig(**second), jl, x, y,
                                               tx, ty)
            _close_records(res, full)
        else:
            res = t_loop.run_neural_experiment(t_loop.NeuralExperimentConfig(**second), tl, x, y,
                                               tx, ty)
            _close_records(res, full)
            assert torch.equal(res.final_labeled_mask, full.final_labeled_mask)

    # A chunked run with a metrics writer: one round event a round with the
    # RoundMetrics computed inside the chunk, the pool entropy from the MC
    # samples; round_stream events as each round finishes, each chunk's
    # before its touchdown's round events, in the sequence of JAX's chunked
    # run (its accuracy to ACC_ATOL).
    m, jm = str(tmp_path / "m.jsonl"), str(tmp_path / "jm.jsonl")
    streamed = dict(base, strategy="entropy", rounds_per_launch=2, stream_round_events=True)
    with t_telemetry.MetricsWriter(m) as w:
        rm = t_loop.run_neural_experiment(t_loop.NeuralExperimentConfig(**streamed), tl, x, y,
                                          tx, ty, metrics=w)
    jw = j_telemetry.MetricsWriter(jm)
    j_loop.run_neural_experiment(j_loop.NeuralExperimentConfig(**streamed), jl, x, y, tx, ty,
                                 metrics=jw)
    jw.close()
    assert _records(rm) == _records(t_loop.run_neural_experiment(
        t_loop.NeuralExperimentConfig(**dict(base, strategy="entropy")), tl, x, y, tx, ty))
    assert all(r.metrics is not None and r.metrics["pool_entropy"] > 0 for r in rm.records)
    with open(m) as f:
        events = [json.loads(line) for line in f]
    with open(jm) as f:
        j_stream = [e for e in map(json.loads, f) if e["kind"] == "round_stream"]
    kinds = [e["kind"] for e in events]
    assert kinds.count("round") == 3 and kinds.count("round_stream") == 3
    t_stream = [e for e in events if e["kind"] == "round_stream"]
    assert [(e["round"], e["n_labeled"]) for e in t_stream] == \
        [(e["round"], e["n_labeled"]) for e in j_stream] == \
        [(r.round, r.n_labeled) for r in rm.records]
    assert all(abs(a["accuracy"] - b["accuracy"]) <= ACC_ATOL for a, b in zip(t_stream, j_stream))
    assert [e["accuracy"] for e in t_stream] == [r.accuracy for r in rm.records]
    # chunks {1, 2} and {3}: a chunk's events come before its first record
    at = {(e["kind"], e["round"]): i for i, e in enumerate(events) if "round" in e}
    assert at[("round_stream", 2)] < at[("round", 1)] and at[("round_stream", 3)] < at[("round", 3)]

    # A model axis is refused with JAX's message; a data axis runs
    # (_mesh_loop_matches_jax).
    with pytest.raises(ValueError, match="model parallelism of the network"):
        t_loop.run_neural_experiment(t_loop.NeuralExperimentConfig(mesh=MeshConfig(1, 2)), tl,
                                     x, y, tx, ty)
    _mesh_loop_matches_jax(tmp_path, jl, tl, base)
    _multi_process_loop_matches_jax(tmp_path)

    # The CLI: the JAX package's run.py log for the same flags; without a
    # card and without --device cpu it raises.
    flags = ["--neural", "--dataset", "checkerboard2x2", "--n-samples", "200", "--strategy",
             "deep.entropy", "--model", "mlp", "--hidden", "16", "--train-steps", "10",
             "--mc-samples", "2", "--window", "5", "--rounds", "3", "--seed", "1", "--quiet"]
    outs = []
    for main, extra in ((j_run.main, []), (t_run.main, ["--device", "cpu"]),
                        (t_run.main, ["--device", "cpu", "--rounds-per-launch", "2"]),
                        (j_run.main, ["--mesh-data", "8"]),
                        (t_run.main, ["--device", "cpu", "--mesh-data", "8"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(flags + extra) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == outs[2] and outs[0].count("Iteration") == 3
    assert outs[3] == outs[4] == outs[0]  # 200 rows over 8 shards: no padding
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_run.main(flags)

    # The port's neural path imports without JAX, flax or optax.
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'distributed_active_learning_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import distributed_active_learning_tpu_torch.runtime.neural_loop\n"
            "import distributed_active_learning_tpu_torch.models.transformer\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
