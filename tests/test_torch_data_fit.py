"""Data, pool state and the device fit of the port against the JAX package:
every dataset registry entry's bundle (the generated pools at small sizes,
the committed fixtures for the ``*_file`` checkerboards, files this test
writes for striatum, credit_card_fraud, cifar10 and agnews), the file
parsers (native route against the JAX package's native loader, the numpy
route against JAX's numpy route, the files both refuse, a failed build
raising), bin edges and codes (also snapped to bf16 for quantized storage),
start masks, fitted forests and their gather form (depth 4 and 11), a
3-class fit's planes (a MultiForest) and quantized storage are
bit-identical on the same inputs (CPU, plain PyTorch). The CLI on a file
(``--dataset credit_card_fraud --data-path``) prints the JAX CLI's log line
for line, and ``--plot`` and the five ``plot_*`` functions render PNGs (each
raising an ImportError naming matplotlib without it)."""

import contextlib
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from distributed_active_learning_tpu.config import DataConfig as JDataConfig
from distributed_active_learning_tpu.data import get_dataset as j_get_dataset
from distributed_active_learning_tpu.ops import forest_eval as j_eval
from distributed_active_learning_tpu.ops import trees as j_trees
from distributed_active_learning_tpu.ops import trees_multi as j_multi
from distributed_active_learning_tpu.ops import trees_train as j_train
from distributed_active_learning_tpu.runtime import state as j_state
from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import DataConfig as TDataConfig
from distributed_active_learning_tpu_torch.data import get_dataset as t_get_dataset
from distributed_active_learning_tpu_torch.ops import forest_eval as t_eval
from distributed_active_learning_tpu_torch.ops import trees as t_trees
from distributed_active_learning_tpu_torch.ops import trees_multi as t_multi
from distributed_active_learning_tpu_torch.ops import trees_train as t_train
from distributed_active_learning_tpu_torch.runtime import state as t_state
from tests.torch_threads import capped_torch_threads  # noqa: F401  (autouse)


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if b.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 against torch's bits
        b = b.view(np.int16)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_checkerboard2x2_bundle_bit_identical(tmp_path):
    for kw in ({}, {"n_samples": 300, "seed": 1}):
        a = j_get_dataset(JDataConfig(name="checkerboard2x2", **kw))
        b = t_get_dataset(TDataConfig(name="checkerboard2x2", **kw))
        for field in ("train_x", "train_y", "test_x", "test_y"):
            _bits_equal(getattr(a, field), getattr(b, field))
    _registry_matches_jax(tmp_path)
    _loader_matches_jax(tmp_path)
    _cli_on_a_file_and_plots(tmp_path)
    _start_masks_match_jax()


def _start_masks_match_jax():
    """The start state's labeled mask and carried key, at two seeds."""
    b = t_get_dataset(TDataConfig(name="checkerboard2x2", n_samples=300, seed=1))
    for seed, n_start in ((0, 10), (3, 57)):
        sj = j_state.set_start_state(
            j_state.init_pool_state(b.train_x, b.train_y, jax.random.key(seed)), n_start)
        st = t_state.set_start_state(
            t_state.init_pool_state(b.train_x, b.train_y, prng.key(seed), "cpu"), n_start)
        np.testing.assert_array_equal(np.asarray(sj.labeled_mask), st.labeled_mask.numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(sj.key)).astype(np.int64), st.key.numpy())
        assert int(st.labeled_mask.sum()) == n_start


def _write_rows(path, rows):
    with open(path, "w") as f:
        f.write("".join(" ".join(repr(float(v)) for v in r) + "\n" for r in rows))


def _registry_matches_jax(tmp_path):
    """All 14 registry names, each entry's bundle bit-equal to the JAX
    package's for the same DataConfig (striatum_like's labels included: its
    scores, which never enter the bundle, are held to
    ``STRIATUM_SCORE_ATOL``)."""
    import pickle

    from distributed_active_learning_tpu.data import available_datasets as j_available
    from distributed_active_learning_tpu_torch.data import available_datasets as t_available
    from distributed_active_learning_tpu_torch.data import formats as t_formats
    from distributed_active_learning_tpu_torch.data import synthetic as t_synth

    assert t_available() == j_available() and len(t_available()) == 14
    rng = np.random.default_rng(0)
    st = np.column_stack([rng.normal(size=(60, 5)), rng.choice([-1, 1], 60)])
    _write_rows(tmp_path / "striatum_train_mini.txt", st)
    _write_rows(tmp_path / "striatum_test_mini.txt", st[:40] * 1.5)
    t_formats.write_credit_card_csv(str(tmp_path / "cc.csv"), n_rows=300, n_fraud=30, seed=2)
    for fn in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(tmp_path / fn, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (20, 3072), dtype=np.uint8),
                         b"labels": [int(v) for v in rng.integers(0, 10, 20)]}, f)
    for fn in ("train.csv", "test.csv"):
        (tmp_path / fn).write_text("".join(
            f'"{rng.integers(1, 5)}","Title {i} stocks","Words about it\'s news, {i}"\n'
            for i in range(30)))
    fixtures = "tests/fixtures/reference_data"
    cases = [dict(name=n, n_samples=ns, seed=s) for n, ns, s in (
        ("checkerboard4x4", None, 0), ("rotated_checkerboard2x2", 250, 2), ("blobs4", 300, 3),
        ("xor", 200, 1), ("striatum_like", 400, 3), ("gaussian_unbalanced", 200, 5),
        ("cifar10", 100, 1), ("agnews", 120, 2))]
    cases += [dict(name=f"{b}_file", path=fixtures)
              for b in ("checkerboard2x2", "checkerboard4x4", "rotated_checkerboard2x2")]
    cases += [dict(name="striatum", path=str(tmp_path)),
              dict(name="credit_card_fraud", path=str(tmp_path / "cc.csv"), seed=4),
              dict(name="credit_card_fraud", path=str(tmp_path / "cc.csv"), seed=4, n_samples=100),
              dict(name="cifar10", path=str(tmp_path)), dict(name="agnews", path=str(tmp_path))]
    for kw in cases:
        a, b = j_get_dataset(JDataConfig(**kw)), t_get_dataset(TDataConfig(**kw))
        for field in ("train_x", "train_y", "test_x", "test_y"):
            _bits_equal(np.asarray(getattr(a, field)), getattr(b, field))
        assert (a.name, a.vocab_size, a.n_features) == (b.name, b.vocab_size, b.n_features), kw
    # striatum_like: the hyperplane's threshold is JAX's bits, the scores
    # within the named tolerance of XLA's product.
    x = t_get_dataset(TDataConfig(name="striatum_like", n_samples=400, seed=3,
                                  standardize=False)).train_x
    w, t = t_synth.striatum_boundary()
    want = np.asarray(jnp.asarray(x) @ jnp.asarray(w.numpy()))
    got = t_synth.striatum_scores(torch.from_numpy(x), w).numpy()
    assert np.abs(got - want).max() <= t_synth.STRIATUM_SCORE_ATOL
    from jax.scipy.stats import norm

    w_j = 0.5 ** jnp.arange(50, dtype=jnp.float32) * jnp.where(jnp.arange(50) % 3 == 1, -1.0, 1.0)
    assert np.float32(t) == np.asarray(jnp.linalg.norm(w_j) * norm.ppf(0.75))


def _loader_matches_jax(tmp_path):
    """The port's native parse equals the JAX package's native loader (a
    second build of ``cpp/loader.cpp`` with its Makefile's flags, bound by
    JAX's ``_native``), its numpy route equals JAX's numpy route; a
    double-rounding token pins which route gives which bits; the files the
    built parser declines take the numpy route in both packages and are
    accepted or refused alike; a failed build raises."""
    import subprocess

    from distributed_active_learning_tpu.data import _native as j_native
    from distributed_active_learning_tpu.data import formats as j_formats
    from distributed_active_learning_tpu_torch.data import _native as t_native
    from distributed_active_learning_tpu_torch.data import formats as t_formats

    lib = tmp_path / "libdal_loader_jax.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared",
                    "cpp/loader.cpp", "-o", str(lib)], check=True)
    rng = np.random.default_rng(1)
    token = "1.00000005960464477539062500000001"  # strtof: 0x3F800001, via a double 0x3F800000
    mat = tmp_path / "mat.txt"
    _write_rows(mat, rng.normal(size=(50, 4)))
    with open(mat, "a") as f:
        f.write(f"{token} 2.5 -1 0.1\n")
    cc = tmp_path / "cc.csv"
    t_formats.write_credit_card_csv(str(cc), n_rows=200, n_fraud=10, seed=5)
    with open(cc, "a") as f:
        f.write(f"7,{token}," + ",".join(["0.5"] * 27) + ',1.25,"1"\n')
    trip = tmp_path / "trip.txt"
    t_formats.write_triplet_text(str(trip), rng.normal(size=(5, 3)).astype(np.float32))
    bad = {"ragged.txt": "1 2 3\n4 5\n", "hex.txt": "1.0 0x1A 2.0\n3.0 4.0 5.0\n",
           "empty.csv": "a,b,c\n1,,2\n3,4,5\n", "trailing.csv": "a,b\n1,2,\n",
           "commas.csv": "a,b,c\n,,\n1,2,3\n", "hex.csv": "a,b\n1.0,0x1A\n",
           "special.txt": "inf nan\n-inf 1.0\n"}
    for name, text in bad.items():
        (tmp_path / name).write_text(text)

    def parse_all(fm, **kw):
        out = {"mat": fm._text_to_matrix(str(mat), None, **kw),
               "labeled": fm.load_labeled_text(str(mat), **kw),
               "cc": fm.load_credit_card_csv(str(cc), **kw),
               "trip": fm.load_triplet_text(str(trip), **kw),
               "space": fm._text_to_matrix(str(mat), " ", **kw)}
        for name in bad:
            load = fm.load_credit_card_csv if name.endswith(".csv") else (
                lambda p, **k: fm._text_to_matrix(p, None, **k))
            try:
                out[name] = load(str(tmp_path / name), **kw)
            except ValueError as e:
                out[name] = type(e)
        return out

    def same(a, b):
        if isinstance(a, tuple):
            for x, y in zip(a, b, strict=True):
                same(x, y)
        elif isinstance(a, type):
            assert a is b
        else:
            _bits_equal(a, b)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DAL_TPU_LOADER_LIB", str(lib))
        mp.setattr(j_native, "_LIB", None)
        mp.setattr(j_native, "_LIB_TRIED", False)
        j_nat = {k: v for k, v in parse_all(j_formats).items()}
        assert j_native._LIB is not None  # JAX's native route ran
        mp.setattr(j_native, "_LIB_TRIED", True)
        mp.setattr(j_native, "_LIB", None)
        j_np = parse_all(j_formats)
    t_nat, t_np = parse_all(t_formats), parse_all(t_formats, native=False)
    for key in j_nat:
        same(j_nat[key], t_nat[key])
        same(j_np[key], t_np[key])
    # The double-rounding token: one ulp apart, native above.
    assert t_nat["mat"][-1, 0].view(np.uint32) == 0x3F800001
    assert t_np["mat"][-1, 0].view(np.uint32) == 0x3F800000
    assert t_nat["cc"][0][-1, 1].view(np.uint32) == 0x3F800001
    assert t_np["cc"][0][-1, 1].view(np.uint32) == 0x3F800000
    for name in ("ragged.txt", "hex.txt", "empty.csv", "trailing.csv", "commas.csv", "hex.csv"):
        assert t_native.parse(str(tmp_path / name), name.endswith(".csv")) is None, name
        assert t_nat[name] is ValueError, name
    assert np.isnan(t_nat["special.txt"][0, 1]) and t_nat["special.txt"][1, 0] == -np.inf
    # A loader that cannot be built raises with the compiler's output; no
    # parse falls back to numpy for want of the library.
    broken = tmp_path / "loader.cpp"
    broken.write_text("this is not C++\n")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_native, "SOURCE", broken)
        mp.setattr(t_native, "_lib", None)
        with pytest.raises(RuntimeError, match="building the native loader .* failed"):
            t_formats.load_credit_card_csv(str(cc))


def test_make_bins_edges_and_codes_bit_identical():
    for n, d in [(300, 2), (1000, 5)]:
        x = np.random.default_rng(n + d).normal(size=(n, d)).astype(np.float32)
        for quantize in ("none", "int8"):  # int8 storage snaps the edges onto bf16
            bj = j_train.make_bins(jnp.asarray(x), 32, quantize=quantize)
            bt = t_train.make_bins(torch.from_numpy(x), 32, quantize=quantize)
            _bits_equal(bj.edges, bt.edges.numpy())
            _bits_equal(bj.codes, bt.codes.numpy())
        snapped = bt.edges.to(torch.bfloat16).to(torch.float32)
        assert torch.equal(snapped, bt.edges)


def _bf16_bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_fit_forest_device_bit_identical():
    """Both forest sizes (20 is not a multiple of tree_chunk=16) through
    :func:`_check_fit_forest_device`."""
    for n_trees in (10, 20):
        _check_fit_forest_device(n_trees)


def _check_fit_forest_device(n_trees):
    """The fit's heap arrays, then the fit's gather form
    (``heap_packed_forest``) and its leaves, proba, votes and value on rows
    with NaN and infinities, and ``pad_forest``. The 20-tree case fits deep
    (depth 11, past the path-matrix form's limit of 10), where the loop
    evaluates the gather form."""
    depth = 11 if n_trees == 20 else 4
    rng = np.random.default_rng(n_trees)
    x = rng.normal(size=(400, 6)).astype(np.float32)
    y = (x[:, 0] + 0.3 * x[:, 1] > 0).astype(np.int32)
    mask = rng.random(400) < 0.5
    bj = j_train.make_bins(jnp.asarray(x), 32)
    bt = t_train.make_bins(torch.from_numpy(x), 32)
    cj, yj, wj = j_train.gather_fit_window(bj.codes, jnp.asarray(y), jnp.asarray(mask), 300)
    ct, yt, wt = t_train.gather_fit_window(
        bt.codes, torch.from_numpy(y), torch.from_numpy(mask), 300)
    _bits_equal(cj, ct.numpy())
    _bits_equal(wj, wt.numpy())
    fj = j_train.fit_forest_device(
        cj, yj, wj, bj.edges, jax.random.key(5), n_trees=n_trees, max_depth=depth)
    ft = t_train.fit_forest_device(
        ct, yt, wt, bt.edges, prng.key(5), n_trees=n_trees, max_depth=depth)
    for a, b in zip(fj, ft):  # (feature, threshold, value)
        _bits_equal(a, b.numpy())

    pj = j_train.heap_packed_forest(*fj, depth)
    pt = t_train.heap_packed_forest(*ft, depth)
    xe = rng.normal(size=(500, 6)).astype(np.float32)
    xe[:3] = np.array([np.nan, np.inf, -np.inf], dtype=np.float32)[:, None]
    xe[3:300:3, rng.integers(6)] = np.nan
    xe[4:300:3, rng.integers(6)] = np.inf
    xe[5:300:3, rng.integers(6)] = -np.inf
    for padded in (False, True):
        if padded:
            pj, pt = j_trees.pad_forest(pj, pj.n_nodes + 7), t_trees.pad_forest(pt, pt.n_nodes + 7)
        for field in ("feature", "threshold", "left", "right", "value"):
            _bits_equal(getattr(pj, field), getattr(pt, field).numpy())
        assert pj.max_depth == pt.max_depth == depth
        for fn in ("leaves", "proba", "votes", "value"):
            _bits_equal(getattr(j_eval, fn)(pj, jnp.asarray(xe)),
                        getattr(t_eval, fn)(pt, torch.from_numpy(xe)).numpy())

    # A 3-class fit: the value planes of a MultiForest (one a class, in the
    # gather and path-matrix forms), their class probabilities and predicted
    # classes; then quantized storage of the path-matrix forms (bf16
    # thresholds, int8 and bf16 leaves; thresholds fitted on bf16-snapped
    # edges), its leaves in the gemm form widened where they are read.
    if depth != 4:
        return
    y3 = np.digitize(x[:, 0] + 0.3 * x[:, 1], [-0.5, 0.5]).astype(np.int32)
    bj = j_train.make_bins(jnp.asarray(x), 32, quantize="int8")
    bt = t_train.make_bins(torch.from_numpy(x), 32, quantize="int8")
    cj, yj, wj = j_train.gather_fit_window(bj.codes, jnp.asarray(y3), jnp.asarray(mask), 300)
    ct, yt, wt = t_train.gather_fit_window(
        bt.codes, torch.from_numpy(y3), torch.from_numpy(mask), 300)
    fj = j_train.fit_forest_device(cj, yj, wj, bj.edges, jax.random.key(6), n_trees=n_trees,
                                   max_depth=depth, n_classes=3)
    ft = t_train.fit_forest_device(ct, yt, wt, bt.edges, prng.key(6), n_trees=n_trees,
                                   max_depth=depth, n_classes=3)
    for a, b in zip(fj, ft):
        _bits_equal(a, b.numpy())
    xj, xt = jnp.asarray(xe[300:]), torch.from_numpy(xe[300:])
    for build in ("heap_packed_forest", "heap_gemm_forest"):
        mj = getattr(j_train, build)(*fj, depth)
        mt = getattr(t_train, build)(*ft, depth)
        assert isinstance(mt, t_multi.MultiForest) and mt.n_classes == 3
        for pj_, pt_ in zip(mj.planes, mt.planes):
            _bits_equal(getattr(j_eval, "leaves")(pj_, xj), t_eval.leaves(pt_, xt).numpy())
        _bits_equal(j_multi.proba_multi(mj, xj), t_multi.proba_multi(mt, xt).numpy())
        _bits_equal(j_multi.predict_class(mj, xj), t_multi.predict_class(mt, xt).numpy())
        if build == "heap_packed_forest":
            continue
        for mode in ("int8", "bf16"):
            qj = j_train.quantize_forest(mj, mode)
            qt = t_train.quantize_forest(mt, mode)
            for pj_, pt_ in zip(qj.planes, qt.planes):
                _bits_equal(pj_.thresholds, _bf16_bits(pt_.thresholds))
                _bits_equal(pj_.value, _bf16_bits(pt_.value))
                _bits_equal(j_eval.leaves(pj_, xj), t_eval.leaves(pt_, xt).numpy())
            _bits_equal(j_multi.proba_multi(qj, xj), t_multi.proba_multi(qt, xt).numpy())
    with pytest.raises(ValueError, match="path-matrix"):
        t_train.quantize_forest(t_train.heap_packed_forest(*ft, depth).planes[0], "int8")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        t_train.quantize_forest(mt, "fp4")


def _cli_on_a_file_and_plots(tmp_path):
    from distributed_active_learning_tpu import run as j_run
    from distributed_active_learning_tpu_torch import run as t_run
    from distributed_active_learning_tpu_torch.data import formats
    from distributed_active_learning_tpu_torch.runtime import results

    csv = str(tmp_path / "creditcard.csv")
    formats.write_credit_card_csv(csv, n_rows=1000, n_fraud=40, seed=3)
    argv = ["--dataset", "credit_card_fraud", "--data-path", csv, "--fit", "device", "--kernel",
            "pallas", "--fused-round", "--n-samples", "600", "--trees", "8", "--window", "15",
            "--rounds", "3", "--seed", "1", "--quiet"]
    logs = []
    for main, extra in ((j_run.main, []),
                        (t_run.main, ["--device", "cpu", "--plot", str(tmp_path / "run.png")])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert not main(argv + extra)
        logs.append(out.getvalue())
    assert logs[0] == logs[1] and logs[1].count("Iteration") == 3, logs
    # The plot functions: one run (the CLI's --plot above), a sweep's band,
    # a grid's bands, and bands and curves from reference-format logs.
    run = results.parse_reference_log(logs[1])
    assert run.to_reference_log() == logs[1]
    other = results.parse_reference_log(logs[1].replace("95.00", "93.50"))
    cells = [type("Cell", (), dict(strategy=s, dataset="cc", result=r))
             for s, r in (("uncertainty", run), ("uncertainty", other), ("random", other))]
    grid = type("Grid", (), dict(cells=cells))
    for i, r in enumerate((run, other)):
        r.save(str(tmp_path / f"log{i}.txt"))
    logs_ = [str(tmp_path / f"log{i}.txt") for i in range(2)]
    pngs = [str(tmp_path / "run.png"),
            results.plot_seed_band([run, other], str(tmp_path / "band.png")),
            results.plot_grid_bands(grid, str(tmp_path / "grid.png"), title="grid"),
            results.plot_mean_band([("us", logs_)], str(tmp_path / "mean.png")),
            results.plot_comparison([("a", logs_[0]), ("b", logs_[1])],
                                    str(tmp_path / "cmp.png"))]
    for png in pngs:
        with open(png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", png
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(__import__("sys").modules, "matplotlib", None)
        with pytest.raises(ImportError, match="matplotlib"):
            results.plot_result(run, str(tmp_path / "none.png"))
