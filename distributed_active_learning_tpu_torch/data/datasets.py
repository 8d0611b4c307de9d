"""Dataset registry producing train/test bundles (the port's subset of the
JAX package's ``data/datasets.py``: the synthetic checkerboards).

Bundles are numpy arrays, as in the JAX package; the loop moves them to the
device. Standardization runs on numpy (``data/scaler.py``) exactly as the JAX
package does for synthetic pools, so the pools agree bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import DataConfig
from distributed_active_learning_tpu_torch.data import scaler, synthetic


class DataBundle(NamedTuple):
    """Dense train/test arrays for one AL experiment."""

    train_x: np.ndarray
    train_y: np.ndarray  # [n] int32 — the oracle's labels, revealed via the mask
    test_x: np.ndarray
    test_y: np.ndarray   # [m] int32
    name: str = ""

    @property
    def n_pool(self) -> int:
        return self.train_x.shape[0]


_REGISTRY: Dict[str, Callable[[DataConfig], DataBundle]] = {}


def register_dataset(name: str):
    def deco(fn: Callable[[DataConfig], DataBundle]):
        _REGISTRY[name] = fn
        return fn
    return deco


def available_datasets():
    return sorted(_REGISTRY)


def get_dataset(cfg: DataConfig) -> DataBundle:
    if cfg.name not in _REGISTRY:
        raise KeyError(f"unknown dataset {cfg.name!r}; available: {available_datasets()}")
    bundle = _REGISTRY[cfg.name](cfg)
    if cfg.n_samples is not None and cfg.n_samples < bundle.n_pool:
        rng = np.random.default_rng(cfg.seed)
        idx = rng.permutation(bundle.n_pool)[: cfg.n_samples]
        bundle = bundle._replace(train_x=bundle.train_x[idx], train_y=bundle.train_y[idx])
    return bundle


def _standardize(bundle: DataBundle, cfg: DataConfig, independent_test: bool = False) -> DataBundle:
    if not cfg.standardize:
        return bundle
    if cfg.scale_test_independently is not None:
        independent_test = cfg.scale_test_independently
    st = scaler.fit_standard_scaler(bundle.train_x)
    train_x = np.asarray(scaler.transform(st, bundle.train_x), dtype=np.float32)
    if independent_test:
        test_x = np.asarray(scaler.fit_transform(bundle.test_x), dtype=np.float32)
    else:
        test_x = np.asarray(scaler.transform(st, bundle.test_x), dtype=np.float32)
    return bundle._replace(train_x=train_x, test_x=test_x)


def _synth(cfg: DataConfig, gen, n_train: int, n_test: int, name: str, **kw) -> DataBundle:
    if cfg.n_samples is not None:
        # Generated pools honor the requested size in both directions.
        n_train = cfg.n_samples
    keys = prng.split(prng.key(cfg.seed))
    train_x, train_y = gen(keys[0], n_train, **kw)
    test_x, test_y = gen(keys[1], n_test, **kw)
    bundle = DataBundle(
        train_x=train_x.numpy(), train_y=train_y.numpy(),
        test_x=test_x.numpy(), test_y=test_y.numpy(), name=name,
    )
    return _standardize(bundle, cfg)


@register_dataset("checkerboard2x2")
def _checkerboard2x2(cfg: DataConfig) -> DataBundle:
    return _synth(cfg, synthetic.make_checkerboard, 1000, 1000, "checkerboard2x2", grid=2)


@register_dataset("checkerboard4x4")
def _checkerboard4x4(cfg: DataConfig) -> DataBundle:
    return _synth(cfg, synthetic.make_checkerboard, 1000, 1000, "checkerboard4x4", grid=4)
