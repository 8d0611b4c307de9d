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
held bit for bit.
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
                                    predict_chunk=7)
        js, ts = jl.init(jax.random.key(5)), tl.init(prng.key(5))
        # Init bit for bit, and the carry-across function both ways.
        carried = interop.neural_params_from_numpy(jax.device_get(js.params), tm)
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
        for name, v in interop.neural_params_from_numpy(jax.device_get(js2.params), tm).items():
            scale = float(v.abs().max()) or 1.0
            err = float((v - ts2.params[name]).abs().max()) / scale
            assert err < t_neural.NEURAL_TRAIN_RTOL, (kind, name, err)
        assert _rel(jl.predict_proba(js2, xj), tl.predict_proba(ts2, xt)) < t_neural.NEURAL_TRAIN_RTOL

    long_ids = torch.zeros((2, 9), dtype=torch.int32)
    tm = _models()[2][2]
    with pytest.raises(ValueError, match="exceeds max_len=8"):
        t_neural.NeuralLearner(tm, (9,)).predict_proba(
            t_neural.NeuralLearner(tm, (8,)).init(prng.key(0)), long_ids)

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


def test_neural_loop_matches_jax(tmp_path):
    x, y, tx, ty = _pool()
    jl = j_neural.NeuralLearner(j_neural.MLP(hidden=(16,)), (4,), train_steps=10, mc_samples=2)
    tl = t_neural.NeuralLearner(t_neural.MLP(hidden=(16,)), (4,), train_steps=10, mc_samples=2)
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
    # samples; stream events at the touchdown.
    m = str(tmp_path / "m.jsonl")
    with t_telemetry.MetricsWriter(m) as w:
        rm = t_loop.run_neural_experiment(
            t_loop.NeuralExperimentConfig(rounds_per_launch=2, stream_round_events=True,
                                          **dict(base, strategy="entropy")), tl, x, y, tx, ty,
            metrics=w)
    assert _records(rm) == _records(t_loop.run_neural_experiment(
        t_loop.NeuralExperimentConfig(**dict(base, strategy="entropy")), tl, x, y, tx, ty))
    assert all(r.metrics is not None and r.metrics["pool_entropy"] > 0 for r in rm.records)
    with open(m) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds.count("round") == 3 and kinds.count("round_stream") == 3

    # Refusals: a model axis with JAX's message, a data axis by name.
    with pytest.raises(ValueError, match="model parallelism of the network"):
        t_loop.run_neural_experiment(t_loop.NeuralExperimentConfig(mesh=MeshConfig(1, 2)), tl,
                                     x, y, tx, ty)
    with pytest.raises(NotImplementedError, match="item 8"):
        t_loop.run_neural_experiment(t_loop.NeuralExperimentConfig(mesh=MeshConfig(2, 1)), tl,
                                     x, y, tx, ty)

    # The CLI: the JAX package's run.py log for the same flags; without a
    # card and without --device cpu it raises.
    flags = ["--neural", "--dataset", "checkerboard2x2", "--n-samples", "200", "--strategy",
             "deep.entropy", "--model", "mlp", "--hidden", "16", "--train-steps", "10",
             "--mc-samples", "2", "--window", "5", "--rounds", "3", "--seed", "1", "--quiet"]
    outs = []
    for main, extra in ((j_run.main, []), (t_run.main, ["--device", "cpu"]),
                        (t_run.main, ["--device", "cpu", "--rounds-per-launch", "2"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(flags + extra) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == outs[2] and outs[0].count("Iteration") == 3
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
