"""The port's threefry (distributed_active_learning_tpu_torch/prng.py) against
jax.random in partitionable mode: split, fold_in, raw bits, uniform, normal
and randint must be bit-identical, since every pick, bootstrap weight and
scenario draw of the AL loop derives from them. Also XLA's float32 erf_inv
(``ops.xla_f32.erfinv_f32``, which ``normal`` reads) against the jitted
``jax.scipy.special.erfinv`` on a grid with 0, the smallest normals and
subnormals and +-(1 - ulp), and the scenario engine's draws (flip masks,
costs, the abstain draw, the dataset fold, the mean-shift direction and
``drift_apply`` of both kinds at rounds 0-5, the drifting stream) against the
JAX package's. The drift is held to the jitted JAX drift (the spelling of
the JAX package's chunked round and grid) bit for bit; the mean-shift
direction of a 30-feature set to ``DRIFT_DIRECTION_RTOL``; the rotation to
``DRIFT_ROTATION_ATOL`` of the JAX package's eager drift (its per-round
driver's), which rounds each product where the jitted drift fuses one. The
data layer's draws and arithmetic too: ``uniform`` on a range (a fused
multiply-add), ``gumbel`` and ``categorical``, JAX's float32 ``ndtri``
(``ops.xla_f32.ndtri_f32``, not correctly rounded) on a grid, and the 2 x 2
products and Cholesky factors of ``make_gaussian_unbalanced``
(``small_matmul_f32``, ``cholesky_f32``), bit for bit; a 3 x 3 factor to
``CHOLESKY_RTOL``. The LAL row generator's file CLI (``python -m
...models.lal_training``) writes the JAX package's file for the same flags,
as the LAL data test holds the rows (bit for bit)."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import distributed_active_learning_tpu  # noqa: F401  (pins partitionable threefry)
from distributed_active_learning_tpu.config import ScenarioConfig as JScn
from distributed_active_learning_tpu.data import synthetic as j_synth
from distributed_active_learning_tpu.scenarios import engine as j_scn
from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import ScenarioConfig as TScn
from distributed_active_learning_tpu_torch.data import synthetic as t_synth
from distributed_active_learning_tpu_torch.ops import xla_f32
from distributed_active_learning_tpu_torch.ops.xla_f32 import erfinv_f32
from distributed_active_learning_tpu_torch.scenarios import engine as t_scn
from tests.torch_threads import capped_torch_threads  # noqa: F401  (autouse)

# The rotation drift against the JAX package's eager drift: a fused and an
# unfused product differ by at most one rounding of |x| ~ 4.
DRIFT_ROTATION_ATOL = 1e-6


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _scenario_draws_match_jax():
    """The scenario engine's draws and drifts, both packages."""
    rng = np.random.default_rng(0)
    unit = jax.jit(lambda u: u / jnp.maximum(jnp.linalg.norm(u), 1e-6))
    for seed in (0, 3, 0x5CE7A410):
        noisy = dict(kind="noisy_oracle", flip_prob=0.2, abstain_prob=0.3, seed=seed)
        for n in (1, 96, 4099):
            np.testing.assert_array_equal(
                np.asarray(j_scn.flip_mask(JScn(**noisy), 5, n)),
                t_scn.flip_mask(TScn(**noisy), 5, n).numpy())
            for spread in (4.0, 3.3):
                cost = dict(kind="cost_budget", cost_budget=6.0, cost_spread=spread, seed=seed)
                np.testing.assert_array_equal(
                    _bits(j_scn.make_costs(JScn(**cost), n, "checkerboard2x2")),
                    _bits(t_scn.make_costs(TScn(**cost), n, "checkerboard2x2").numpy()))
        np.testing.assert_array_equal(
            np.asarray(j_scn.abstain_draw(JScn(**noisy), jax.random.key(seed), (8,))),
            t_scn.abstain_draw(TScn(**noisy), prng.key(seed), (8,)).numpy())
        assert j_scn.dataset_fold(f"ds{seed}") == t_scn.dataset_fold(f"ds{seed}")
        for d in (2, 30):
            x = rng.normal(size=(500, d)).astype(np.float32)
            for kind in ("mean_shift", "rotation"):
                kw = dict(kind="drift", drift_rate=0.3, drift_kind=kind, seed=seed)
                js, ts = JScn(**kw), TScn(**kw)
                jitted = jax.jit(lambda xx, rr, js=js: j_scn.drift_apply(js, xx, rr))
                for r in range(6):
                    jit = np.asarray(jitted(jnp.asarray(x), jnp.int32(r)))
                    got = t_scn.drift_apply(ts, torch.from_numpy(x),
                                            torch.tensor(r, dtype=torch.int32)).numpy()
                    if kind == "mean_shift" and d > 3:
                        # The direction's squared norm: XLA may vectorize a
                        # 30-term reduce (drift_direction).
                        np.testing.assert_allclose(got, jit, rtol=0, atol=(
                            t_scn.DRIFT_DIRECTION_RTOL * 0.3 * r + 1e-6))
                        continue
                    np.testing.assert_array_equal(_bits(got), _bits(jit), (d, kind, r))
                    eager = np.asarray(j_scn.drift_apply(js, jnp.asarray(x), r))
                    if kind == "rotation":
                        np.testing.assert_allclose(got, eager, rtol=0, atol=DRIFT_ROTATION_ATOL)
                    else:
                        np.testing.assert_array_equal(_bits(got), _bits(eager))
            u = jax.random.normal(j_scn._base_key(JScn(kind="drift", seed=seed)), (d,))
            want = np.asarray(unit(u))
            got = t_scn.drift_direction(TScn(kind="drift", seed=seed), d).numpy()
            if d <= 3:
                np.testing.assert_array_equal(_bits(got), _bits(want))
            else:
                np.testing.assert_allclose(got, want, rtol=t_scn.DRIFT_DIRECTION_RTOL, atol=0)
    for kind in ("mean_shift", "rotation"):
        for (jx, jy), (tx, ty) in zip(
                j_synth.make_drifting_stream(jax.random.key(4), 4, 50, d=4, kind=kind,
                                             warm_blocks=1),
                t_synth.make_drifting_stream(prng.key(4), 4, 50, d=4, kind=kind, warm_blocks=1)):
            np.testing.assert_array_equal(_bits(jx), _bits(tx.numpy()))
            np.testing.assert_array_equal(np.asarray(jy), ty.numpy())


def test_prng_bits_split_fold_in_uniform_match_jax(tmp_path):
    for seed in (0, 1, 7, 0x5EED + 3, 2**31 + 5):
        kj, kt = jax.random.key(seed), prng.key(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(kj)).astype(np.int64), kt.numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jax.random.split(kj, 5))), prng.split(kt, 5).numpy())
        for data in (0, 1, 17, 2**32 - 1):
            np.testing.assert_array_equal(
                np.asarray(jax.random.key_data(jax.random.fold_in(kj, data))),
                prng.fold_in(kt, data).numpy())
        for shape in ((1,), (5,), (3, 7), (16, 4, 3), (1001,)):
            np.testing.assert_array_equal(
                np.asarray(jax.random.bits(kj, shape)).astype(np.int64),
                prng.random_bits(kt, shape).numpy())
            uj = np.asarray(jax.random.uniform(kj, shape))
            ut = prng.uniform(kt, shape).numpy()
            np.testing.assert_array_equal(uj.view(np.int32), ut.view(np.int32))
    # A batch of keys draws what each key draws alone (the fit's chunk batch).
    keys_j = jax.random.split(jax.random.key(3), 4)
    batched = prng.uniform(prng.split(prng.key(3), 4), (2, 3)).numpy()
    for i, k in enumerate(keys_j):
        np.testing.assert_array_equal(np.asarray(jax.random.uniform(k, (2, 3))), batched[i])
    assert prng.uniform(prng.key(0), (4,)).dtype == torch.float32

    # normal and randint, the scenario salt's key included.
    for seed in (0, 7, 0x5CE7A410, 2**31 + 5):
        kj, kt = jax.random.key(seed), prng.key(seed)
        for shape in ((1,), (30,), (100_000,)):
            np.testing.assert_array_equal(_bits(jax.random.normal(kj, shape)),
                                          _bits(prng.normal(kt, shape).numpy()))
            for lo, hi in ((0, 2), (-5, 1000), (3, 3)):
                got = prng.randint(kt, shape, lo, hi)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(np.asarray(jax.random.randint(kj, shape, lo, hi)),
                                              got.numpy())

    # XLA's erf_inv: a dense grid, the tails and the edges.
    f32 = np.float32
    tiny, one_minus = np.finfo(f32).tiny, np.nextafter(f32(1), f32(0))
    grid = np.concatenate([
        np.linspace(-1, 1, 200_001, dtype=f32),
        1 - np.geomspace(1e-7, 1e-2, 20_000).astype(f32),
        np.array([0, -0.0, tiny, -tiny, tiny / 4, -tiny / 4, 1e-45, one_minus, -one_minus,
                  1, -1], f32),
    ]).astype(f32)
    grid = np.concatenate([grid, -grid])
    want = np.asarray(jax.jit(jax.scipy.special.erfinv)(grid))
    np.testing.assert_array_equal(_bits(erfinv_f32(torch.from_numpy(grid)).numpy()), _bits(want))

    _scenario_draws_match_jax()
    _data_draws_match_jax()
    _lal_cli_matches_jax(tmp_path)


def _lal_cli_matches_jax(tmp_path):
    import contextlib
    import io

    from distributed_active_learning_tpu.models import lal_training as j_lal
    from distributed_active_learning_tpu_torch.models import lal_training as t_lal

    flags = ["--experiments", "2", "--candidates", "4", "--pool-size", "40", "--seed", "1"]
    outs = {}
    for name, main, extra in (("jax", j_lal._main, []), ("port", t_lal._main,
                                                          ["--device", "cpu"])):
        outs[name] = tmp_path / f"lal_{name}.txt"
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            assert main(flags + ["--out", str(outs[name])] + extra) == 0
        assert printed.getvalue() == f"8 rows -> {outs[name]}\n"
    assert outs["port"].read_text() == outs["jax"].read_text()


def _data_draws_match_jax():
    for seed in (0, 7, 2**31 + 5):
        kj, kt = jax.random.key(seed), prng.key(seed)
        for lo, hi in ((0.1, 0.9), (-1.0, 1.0), (-0.3, 2.7), (1e-3, 5.0)):
            np.testing.assert_array_equal(
                _bits(jax.random.uniform(kj, (5000,), minval=lo, maxval=hi)),
                _bits(prng.uniform(kt, (5000,), minval=lo, maxval=hi).numpy()))
        np.testing.assert_array_equal(_bits(jax.random.gumbel(kj, (3000, 7))),
                                      _bits(prng.gumbel(kt, (3000, 7)).numpy()))
        for imbalance in (0.3, 0.35):
            logp = jnp.arange(10) * jnp.log1p(-imbalance)
            got = prng.categorical(kt, torch.tensor(np.asarray(logp)), (4000,))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(
                np.asarray(jax.random.categorical(kj, logp, shape=(4000,))), got.numpy())
    # JAX's ndtri: the quantile the striatum pool's threshold reads, a dense
    # grid, both tails and the edges.
    rng = np.random.default_rng(0)
    grid = np.concatenate([
        np.float32([0.75, 0.25, 0.5, 0, 1, 1e-10, 1 - 1e-7]),
        np.linspace(0, 1, 20_001, dtype=np.float32),
        np.exp(-rng.uniform(0, 80, 20_000)).astype(np.float32),
        (1 - np.exp(-rng.uniform(0, 16, 20_000))).astype(np.float32)])
    np.testing.assert_array_equal(
        _bits(jax.scipy.special.ndtri(jnp.asarray(grid))),
        _bits(xla_f32.ndtri_f32(torch.from_numpy(grid)).numpy()))
    assert xla_f32.ndtri_f32(torch.tensor([0.75])).numpy().view(np.int32)[0] == \
        np.float32(0.6744898).view(np.int32)
    # The 2 x 2 covariance, its Cholesky factor and the sample product, as
    # the JAX package's eager code computes them.
    a = rng.uniform(-1, 1, size=(3000, 2, 2)).astype(np.float32)
    z = rng.normal(size=(3000, 64, 2)).astype(np.float32)
    cov_j = np.asarray(jnp.asarray(a) @ jnp.swapaxes(jnp.asarray(a), -1, -2) +
                       0.1 * jnp.eye(2))
    at = torch.from_numpy(a)
    cov_t = xla_f32.small_matmul_f32(at, at.transpose(-1, -2)) + torch.eye(2) * np.float32(0.1)
    np.testing.assert_array_equal(_bits(cov_j), _bits(cov_t.numpy()))
    chol_j = np.asarray(jax.vmap(jnp.linalg.cholesky)(jnp.asarray(cov_j)))
    chol_t = xla_f32.cholesky_f32(cov_t)
    np.testing.assert_array_equal(_bits(chol_j), _bits(chol_t.numpy()))
    np.testing.assert_array_equal(
        _bits(jnp.asarray(z) @ jnp.swapaxes(jnp.asarray(chol_j), -1, -2)),
        _bits(xla_f32.small_matmul_f32(torch.from_numpy(z), chol_t.transpose(-1, -2)).numpy()))
    b = rng.uniform(-1, 1, size=(3, 3)).astype(np.float32)
    spd = b @ b.T + np.float32(0.1) * np.eye(3, dtype=np.float32)
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(spd)))
    got = xla_f32.cholesky_f32(torch.from_numpy(spd)).numpy()
    assert np.abs(got - want).max() <= xla_f32.CHOLESKY_RTOL * np.abs(want).max()
