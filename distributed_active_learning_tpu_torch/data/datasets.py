"""Dataset registry producing train/test bundles (the port of the JAX
package's ``data/datasets.py``, all of its 14 entries).

Bundles are numpy arrays, as in the JAX package; the loop moves them to the
device. Generated pools are drawn on the CPU with the port's ``prng`` and
standardized on numpy (``data/scaler.py``) as the JAX package does, and
files are read by :mod:`.formats` (the native loader), so every bundle
equals the JAX package's for the same :class:`DataConfig` bit for bit.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.config import DataConfig
from distributed_active_learning_tpu_torch.data import formats, scaler, synthetic


class DataBundle(NamedTuple):
    """Dense train/test arrays for one AL experiment.

    ``train_x`` is ``[n, d] float32`` for tabular pools, ``[n, H, W, C]``
    float32 for image pools (cifar10), or ``[n, T] int32`` token ids for text
    pools (agnews; ``vocab_size`` set).
    """

    train_x: np.ndarray
    train_y: np.ndarray  # [n] int32 — the oracle's labels, revealed via the mask
    test_x: np.ndarray
    test_y: np.ndarray   # [m] int32
    name: str = ""
    vocab_size: Optional[int] = None  # token pools only

    @property
    def n_pool(self) -> int:
        return self.train_x.shape[0]

    @property
    def n_features(self) -> int:
        return self.train_x.shape[1]


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


def _standin_sizes(cfg: DataConfig, default_train: int = 2000) -> Tuple[int, int]:
    """Pool and test sizes of the generated deep-AL stand-ins (cifar10 and
    agnews without ``cfg.path``): ``n_samples`` sets the pool (generated,
    not subsampled), the test set is a fifth of it, at least 500."""
    n_train = cfg.n_samples or default_train
    return n_train, max(500, n_train // 5)


@register_dataset("checkerboard2x2")
def _checkerboard2x2(cfg: DataConfig) -> DataBundle:
    return _synth(cfg, synthetic.make_checkerboard, 1000, 1000, "checkerboard2x2", grid=2)


@register_dataset("checkerboard4x4")
def _checkerboard4x4(cfg: DataConfig) -> DataBundle:
    return _synth(cfg, synthetic.make_checkerboard, 1000, 1000, "checkerboard4x4", grid=4)


@register_dataset("rotated_checkerboard2x2")
def _rotated(cfg: DataConfig) -> DataBundle:
    return _synth(cfg, synthetic.make_rotated_checkerboard, 1000, 1000, "rotated_checkerboard2x2")


@register_dataset("blobs4")
def _blobs4(cfg: DataConfig) -> DataBundle:
    """The 4-class Gaussian-blob pool (the multiclass forest loop's)."""
    return _synth(cfg, synthetic.make_blobs, 2000, 2000, "blobs4", n_classes=4)


@register_dataset("xor")
def _xor(cfg: DataConfig) -> DataBundle:
    return _synth(cfg, synthetic.make_xor, 10000, 2000, "xor", d=10)


@register_dataset("striatum_like")
def _striatum_like(cfg: DataConfig) -> DataBundle:
    """The 10,000-row striatum stand-in (d = 50 oblique boundary, minority
    positives; :func:`synthetic.make_striatum_like`)."""
    return _synth(cfg, synthetic.make_striatum_like, 10000, 10000, "striatum_like")


def _register_file_checkerboard(base: str) -> None:
    """``<base>_file``: the reference's fixture files
    ``<base>_{train,test}.txt`` in the directory ``cfg.path``
    (``classes/dataset.py:149-238``), read by ``load_labeled_text``."""

    @register_dataset(f"{base}_file")
    def _loader(cfg: DataConfig, base: str = base) -> DataBundle:
        if cfg.path is None:
            raise ValueError(f"{base}_file dataset needs cfg.path (fixture directory)")
        train_x, train_y = formats.load_labeled_text(os.path.join(cfg.path, f"{base}_train.txt"))
        test_x, test_y = formats.load_labeled_text(os.path.join(cfg.path, f"{base}_test.txt"))
        return _standardize(DataBundle(train_x, train_y, test_x, test_y, f"{base}_file"), cfg)


for _base in ("checkerboard2x2", "checkerboard4x4", "rotated_checkerboard2x2"):
    _register_file_checkerboard(_base)


@register_dataset("striatum")
def _striatum(cfg: DataConfig) -> DataBundle:
    """``striatum_{train,test}_mini.txt`` (label last, ``-1 -> 0``) in the
    directory ``cfg.path``; the test set scaled by its own scaler, as the
    reference does (``dataset.py:245-273``)."""
    if cfg.path is None:
        raise ValueError("striatum dataset needs cfg.path")
    train_x, train_y = formats.load_labeled_text(os.path.join(cfg.path, "striatum_train_mini.txt"))
    test_x, test_y = formats.load_labeled_text(os.path.join(cfg.path, "striatum_test_mini.txt"))
    bundle = DataBundle(train_x, train_y, test_x, test_y, "striatum")
    return _standardize(bundle, cfg, independent_test=True)


@register_dataset("credit_card_fraud")
def _credit_card(cfg: DataConfig) -> DataBundle:
    """The Kaggle fraud CSV at ``cfg.path``, split 70/30 by a permutation
    seeded with ``cfg.seed`` (``mllib/credit_card_fraud.py:28``)."""
    if cfg.path is None:
        raise ValueError("credit_card_fraud dataset needs cfg.path (the CSV file)")
    x, y = formats.load_credit_card_csv(cfg.path)
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(x))
    split = int(0.7 * len(x))
    tr, te = perm[:split], perm[split:]
    return _standardize(DataBundle(x[tr], y[tr], x[te], y[te], "credit_card_fraud"), cfg)


@register_dataset("cifar10")
def _cifar10(cfg: DataConfig) -> DataBundle:
    """The CIFAR-10 image pool. With ``cfg.path``: the python-pickle batches
    (``data_batch_1..5``, ``test_batch``) scaled to ``x / 127.5 - 1``.
    Without: the generated stand-in at CIFAR's shape (32 x 32 x 3 float32,
    10 classes; multi-mode shifted prototypes, geometric class imbalance),
    one draw split into pool and test set."""
    if cfg.path is not None:
        def load_batch(fn):
            with open(os.path.join(cfg.path, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return x.astype(np.float32) / 127.5 - 1.0, np.asarray(d[b"labels"], dtype=np.int32)

        xs, ys = zip(*[load_batch(f"data_batch_{i}") for i in range(1, 6)])
        test_x, test_y = load_batch("test_batch")
        return DataBundle(np.concatenate(xs), np.concatenate(ys), test_x, test_y, "cifar10")
    n_train, n_test = _standin_sizes(cfg)
    x, y = synthetic.make_synthetic_images(
        prng.key(cfg.seed), n_train + n_test,
        noise=2.2, modes_per_class=4, max_shift=8, imbalance=0.30,
    )
    x, y = x.numpy(), y.numpy()
    return DataBundle(x[:n_train], y[:n_train], x[n_train:], y[n_train:], "cifar10")


@register_dataset("agnews")
def _agnews(cfg: DataConfig) -> DataBundle:
    """The AG-News token pool. With ``cfg.path``: ``train.csv`` and
    ``test.csv`` (``"class","title","description"``, class 1..4) hashed to
    token ids (:mod:`.text`). Without: the generated topic pool at its shape
    ([n, 64] int32 ids, 4 classes, vocabulary 4096)."""
    vocab, max_len = 4096, 64
    if cfg.path is not None:
        from distributed_active_learning_tpu_torch.data.text import load_agnews_csv

        train_x, train_y = load_agnews_csv(os.path.join(cfg.path, "train.csv"), vocab, max_len)
        test_x, test_y = load_agnews_csv(os.path.join(cfg.path, "test.csv"), vocab, max_len)
        return DataBundle(train_x, train_y, test_x, test_y, "agnews", vocab_size=vocab)
    hard = dict(topic_frac=0.4, overlap=0.25, imbalance=0.35)
    n_train, n_test = _standin_sizes(cfg)
    keys = prng.split(prng.key(cfg.seed))
    tx, ty = synthetic.make_synthetic_tokens(keys[0], n_train, vocab_size=vocab, max_len=max_len,
                                             **hard)
    ex, ey = synthetic.make_synthetic_tokens(keys[1], n_test, vocab_size=vocab, max_len=max_len,
                                             **hard)
    return DataBundle(tx.numpy(), ty.numpy(), ex.numpy(), ey.numpy(), "agnews", vocab_size=vocab)


@register_dataset("gaussian_unbalanced")
def _gaussian_unbalanced(cfg: DataConfig) -> DataBundle:
    """Two random Gaussian clouds, class-1 prior uniform in [10%, 90%], a
    test set 10 times the pool (``classes/test.py:150-187``; the LAL
    regressor's training distribution). Each seed draws a new geometry."""
    n = cfg.n_samples or 1000
    train_x, train_y, test_x, test_y = synthetic.make_gaussian_unbalanced(prng.key(cfg.seed), n)
    bundle = DataBundle(train_x.numpy(), train_y.numpy(), test_x.numpy(), test_y.numpy(),
                        "gaussian_unbalanced")
    return _standardize(bundle, cfg)
