"""The LAL regressor (the port of the regressor half of
``models/lal_training.py``): fit from a reference-format training file, or
loaded from a forest file, as the ``lal`` strategy's ``aux.lal_forest``.

The reference trains its regressor offline on a file of (5 features ->
expected error reduction) rows (``lal_randomtree_simulatedunbalanced_big.txt``;
``tests/fixtures/lal_simulatedunbalanced_big.txt`` holds one). A LAL run
names its regressor's source in the strategy's options:

- ``lal_data_path``: such a text file; the regressor is fitted from it with
  scikit-learn (:func:`train_lal_regressor`, as in the JAX package);
- ``lal_model_path``: a forest file (``models/forest_io.py``) of the fitted
  regressor, loaded when its meta matches these options and fitted and
  written otherwise; a file written by either package loads in the other.

The JAX package can also synthesize the training rows itself
(``generate_lal_dataset``, from ``make_gaussian_unbalanced``), which needs
normal draws the port's ``prng`` does not carry yet: without either option
the loader raises and names the slice that brings it. The regressor stays
the :class:`~..ops.trees.PackedForest` it is fitted as, so the loop
evaluates it in the gather form, as the JAX package does.
"""

from __future__ import annotations

import json
from typing import Mapping, Optional

import numpy as np

from distributed_active_learning_tpu_torch.config import ForestConfig
from distributed_active_learning_tpu_torch.ops.trees import PackedForest


def _text_to_matrix(path: str) -> np.ndarray:
    """A dense whitespace-separated numeric text file as a 2-D float32 array
    (the Python path of the JAX package's ``data/formats.py``; the same
    bits as its native loader)."""
    with open(path, "r") as f:
        raw = f.read()
    rows = [ln for ln in raw.splitlines() if ln.strip()]
    if not rows:
        raise ValueError(f"empty data file: {path}")
    ncol = len(rows[0].split())
    if all(len(r.split()) == ncol for r in rows):
        return np.asarray(raw.split(), dtype=np.float32).reshape(len(rows), ncol)
    raise ValueError(f"{path}: rows of different widths")


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
    written from a fit otherwise. ``lal_trees`` (200), ``lal_depth`` (10)
    and ``lal_seed`` (0) set the fit."""
    from distributed_active_learning_tpu_torch.device import resolve_device

    device = resolve_device(device)
    key = (tuple(sorted((k, str(v)) for k, v in options.items())), str(device))
    if key in _CACHE:
        return _CACHE[key]

    def _train() -> PackedForest:
        path: Optional[str] = options.get("lal_data_path")
        if not path:
            raise NotImplementedError(
                "the LAL regressor needs options['lal_data_path'] (a reference-format "
                "training file) or options['lal_model_path'] (a forest file): synthesizing "
                "its training rows (generate_lal_dataset) comes with the data slice "
                "(ROADMAP queue 1, \"Data, the rest\")")
        raw = _text_to_matrix(path)
        return train_lal_regressor(
            raw[:, :-1], raw[:, -1],
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
