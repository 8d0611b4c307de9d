"""Synthesize the LAL regressor's training rows and fit the regressor (the
port of ``models/lal_training.py``).

The reference trains its regressor offline on a file of (5 features ->
expected error reduction) rows (``lal_randomtree_simulatedunbalanced_big.txt``;
``tests/fixtures/lal_simulatedunbalanced_big.txt`` holds one), made by the
LAL "random tree" procedure over simulated unbalanced Gaussians: draw a
random two-cloud dataset, label a random subset, fit a small forest, measure
the held-out error, then for a few unlabeled candidates read their five
features, add each to the labeled set, refit, and record the error
reduction. :func:`generate_lal_dataset` is that procedure on the port's
device fit. A LAL run names its regressor's source in the strategy's
options:

- ``lal_data_path``: such a text file, read by the native loader
  (``data/formats._text_to_matrix``, as the JAX package reads it when its
  library is built); the regressor is fitted from it with scikit-learn
  (:func:`train_lal_regressor`, as in the JAX package);
- ``lal_model_path``: a forest file (``models/forest_io.py``) of the fitted
  regressor, loaded when its meta matches these options and fitted and
  written otherwise; a file written by either package loads in the other;
- neither: the rows are synthesized (``lal_seed``, ``lal_experiments``) and
  the regressor fitted from them, which needs scikit-learn (the card's
  machine has none, so there it raises naming scikit-learn).

The regressor stays the :class:`~..ops.trees.PackedForest` it is fitted as,
so the loop evaluates it in the gather form, as the JAX package does.
"""

from __future__ import annotations

import json
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import ForestConfig
from distributed_active_learning_tpu_torch.ops.trees import PackedForest

_LAL_BINS = 32  # MLlib's maxBins default, like the AL loop's device fit


def _err(forest, ex: torch.Tensor, ey: torch.Tensor) -> torch.Tensor:
    """Held-out error ``1 - mean(pred == y)`` as XLA computes it in the JAX
    package's batched program: the sum of 0/1 values is exact in any order
    (so XLA's windowed order is not needed), the mean is a multiplication by
    ``f32(1 / m)``, and LLVM fuses it into the subtraction:
    ``fma(-sum, f32(1 / m), 1)``."""
    from distributed_active_learning_tpu_torch.ops import forest_eval
    from distributed_active_learning_tpu_torch.ops.xla_f32 import fma_f32, recip_f32

    hits = ((forest_eval.proba(forest, ex) > 0.5).to(torch.int32) == ey).to(torch.float32)
    return fma_f32(-hits.sum(), recip_f32(ex.shape[0]), 1.0)


def _lal_experiment(x, y, ex, ey, mask, cand, key, n_trees: int, max_depth: int):
    """One simulated experiment (one vmapped slice of the JAX package's
    ``_lal_mc_batch``): bin the pool, fit the base forest on the labeled
    subset, its held-out error, the five LAL features of every candidate
    (``strategies.lal.lal_features``, the feature code the strategy scores
    with), then for each candidate a refit with it labeled and the error
    reduction. Returns ``(features [C, 5], targets [C])``."""
    from distributed_active_learning_tpu_torch.ops import trees_train
    from distributed_active_learning_tpu_torch.runtime.state import PoolState
    from distributed_active_learning_tpu_torch.strategies.lal import lal_features

    binned = trees_train.make_bins(x, _LAL_BINS)

    def fit(m, k):
        f, th, v = trees_train.fit_forest_device(
            binned.codes, y, m.to(torch.float32), binned.edges, k,
            n_trees=n_trees, max_depth=max_depth, n_bins=_LAL_BINS)
        return trees_train.heap_gemm_forest(f, th, v, max_depth)

    k_base, k_cand = prng.split(key)
    forest = fit(mask, k_base)
    err0 = _err(forest, ex, ey)
    feats = lal_features(forest, PoolState(x=x, oracle_y=y, labeled_mask=mask, key=key))[cand]
    cand_keys = prng.split(k_cand, cand.shape[0])
    targets = []
    for c in range(cand.shape[0]):
        m2 = mask.clone()
        m2[cand[c]] = True
        targets.append(err0 - _err(fit(m2, cand_keys[c]), ex, ey))
    return feats, torch.stack(targets)


def generate_lal_dataset(seed: int = 0, n_experiments: int = 60, candidates_per_experiment: int = 8,
                         pool_size: int = 200, n_trees: int = 10, max_depth: int = 6,
                         device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Monte-Carlo synthesis of ``(features [m, 5], error-reduction targets
    [m])``, the JAX package's rows for the same arguments.

    The host draws each experiment as the JAX package does
    (``make_gaussian_unbalanced`` from ``key(seed * 100003 + e)``, the
    labeled subset and the candidates from ``np.random.default_rng(seed)``),
    then every experiment's base fit, features and candidate refits run on
    ``device`` (default CUDA) with the port's device fit, one after another:
    a serial fit equals one slice of JAX's vmapped fit bit for bit. The i-th
    experiment's fit key is ``fold_in(key(seed ^ 0x1A1), i)``, the key JAX
    gives it in its padded batches whatever their width (JAX pads a batch
    to ``batch_experiments`` only to compile one program shape; the port
    compiles nothing and computes no padding)."""
    from distributed_active_learning_tpu_torch.data.synthetic import make_gaussian_unbalanced
    from distributed_active_learning_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    exps, cand_valid = [], []
    C = candidates_per_experiment
    for e in range(n_experiments):
        tx, ty, ex, ey = (t.numpy() for t in
                          make_gaussian_unbalanced(prng.key(seed * 100003 + e), pool_size, dim=2))
        if len(np.unique(ty)) < 2:
            continue
        # A random labeled subset holding both classes.
        n_lab = int(rng.integers(4, max(pool_size // 4, 6)))
        pos = rng.permutation(np.flatnonzero(ty == 1))
        neg = rng.permutation(np.flatnonzero(ty == 0))
        rest = rng.permutation(np.setdiff1d(np.arange(pool_size), [pos[0], neg[0]]))
        lab_idx = np.concatenate([[pos[0], neg[0]], rest[: max(n_lab - 2, 0)]])
        unlab_idx = np.setdiff1d(np.arange(pool_size), lab_idx)
        if len(unlab_idx) == 0:
            continue
        mask = np.zeros(pool_size, dtype=bool)
        mask[lab_idx] = True
        # Fewer than C unlabeled points: the candidates are padded (the first
        # pick repeated) and the padding's rows dropped below.
        take = min(C, len(unlab_idx))
        chosen = rng.choice(unlab_idx, size=take, replace=False)
        exps.append((tx, ty, ex, ey, mask, np.concatenate([chosen, np.full(C - take, chosen[0])])))
        cand_valid.append(np.arange(C) < take)
    if not exps:
        raise ValueError("every simulated experiment degenerated (single-class pool or no "
                         "unlabeled candidates)")
    master = prng.key(seed ^ 0x1A1)
    feats_out, targets_out = [], []
    dtypes = (torch.float32, torch.int32, torch.float32, torch.int32, torch.bool, torch.int64)
    for i, arrays in enumerate(exps):
        f, t = _lal_experiment(
            *(torch.as_tensor(a, dtype=dt).to(dev) for a, dt in zip(arrays, dtypes)),
            prng.fold_in(master, i), n_trees, max_depth)
        feats_out.append(f.cpu().numpy())
        targets_out.append(t.cpu().numpy())
    valid = np.stack(cand_valid)
    feats = np.stack(feats_out)[valid]
    targets = np.stack(targets_out)[valid]
    return feats.astype(np.float32), targets.astype(np.float32)


def train_lal_regressor(features: np.ndarray, targets: np.ndarray, n_trees: int = 200,
                        max_depth: int = 10, seed: int = 0) -> PackedForest:
    """Fit and pack the error-reduction regressor (scikit-learn; the
    reference uses 2000 trees, ``active_learner.py:357``)."""
    from distributed_active_learning_tpu_torch.models.forest import fit_forest_regressor

    cfg = ForestConfig(n_trees=n_trees, max_depth=max_depth, seed=seed)
    return fit_forest_regressor(features, targets, cfg)


_CACHE: dict = {}


def lal_meta(options: Mapping) -> str:
    """The meta string a regressor's forest file carries: the options but
    the file's path, as JSON (the JAX package's, so either package's file
    loads in the other)."""
    return json.dumps({k: str(v) for k, v in sorted(options.items()) if k != "lal_model_path"})


def load_or_train_lal_regressor(options: Mapping, device=None) -> PackedForest:
    """The LAL regressor that the strategy's ``options`` name, on
    ``device`` (default CUDA; cached per options and device in memory).

    ``lal_data_path``: a reference-format text file (5 features, then the
    target); ``lal_model_path``: a forest file, loaded when its meta (the
    options but the path, as a JSON string, the JAX package's) matches and
    written from a fit otherwise; without a data file the training rows are
    synthesized on ``device`` (:func:`generate_lal_dataset`, ``lal_seed``
    and ``lal_experiments`` (60)). ``lal_trees`` (200), ``lal_depth`` (10)
    and ``lal_seed`` (0) set the fit."""
    from distributed_active_learning_tpu_torch.device import resolve_device

    device = resolve_device(device)
    key = (tuple(sorted((k, str(v)) for k, v in options.items())), str(device))
    if key in _CACHE:
        return _CACHE[key]

    def _train() -> PackedForest:
        path: Optional[str] = options.get("lal_data_path")
        if path:
            from distributed_active_learning_tpu_torch.data.formats import _text_to_matrix

            raw = _text_to_matrix(path, None)
            feats, targets = raw[:, :-1], raw[:, -1]
        else:
            # The fit after the synthesis needs scikit-learn: refuse before
            # the experiments run, not after.
            from distributed_active_learning_tpu_torch.models.forest import require_sklearn

            require_sklearn()
            feats, targets = generate_lal_dataset(
                seed=int(options.get("lal_seed", 0)),
                n_experiments=int(options.get("lal_experiments", 60)), device=device)
        return train_lal_regressor(
            feats, targets,
            n_trees=int(options.get("lal_trees", 200)),
            max_depth=int(options.get("lal_depth", 10)),
            seed=int(options.get("lal_seed", 0)),
        )

    model_path: Optional[str] = options.get("lal_model_path")
    if model_path:
        from distributed_active_learning_tpu_torch.models.forest_io import load_or_train

        packed = load_or_train(model_path, _train, meta=lal_meta(options), device=device)
    else:
        packed = _train().to(device)
    _CACHE[key] = packed
    return packed



def _main(argv=None) -> int:
    """Write a reference-format LAL training file (the JAX package's
    ``_main``): rows of the 5 features and the error-reduction target,
    whitespace-separated, the format ``lal_data_path`` loads::

        python -m distributed_active_learning_tpu_torch.models.lal_training \\
            --seed 0 --experiments 720 --out lal_simulatedunbalanced_big.txt

    The experiments run on ``--device`` (default the card; ``cpu`` for the
    plain versions)."""
    import argparse

    ap = argparse.ArgumentParser(prog="lal_training")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--experiments", type=int, default=90)
    ap.add_argument("--candidates", type=int, default=8)
    ap.add_argument("--pool-size", type=int, default=200)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    feats, targets = generate_lal_dataset(
        seed=args.seed, n_experiments=args.experiments,
        candidates_per_experiment=args.candidates, pool_size=args.pool_size, device=args.device)
    np.savetxt(args.out, np.column_stack([feats, targets]), fmt="%.8g")
    print(f"{feats.shape[0]} rows -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
