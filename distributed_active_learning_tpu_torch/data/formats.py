"""File-format parsers for the reference's on-disk data formats (the port of
``data/formats.py``): whitespace-separated label-last text files (label
``-1`` remapped to ``0``), the Kaggle credit-card CSV (a header row, a
quoted label last) and ``i j value`` triplet files.

Each parser reads through the native loader (:mod:`._native`, built from
``cpp/loader.cpp``) by default. ``native=False`` takes the numpy route, the
JAX package's Python code byte for byte: it is each parser's plain version
and the tests' oracle, and it also runs where the built parser declines a
file (a ragged row, a hex-float token, an empty CSV field), so the port
accepts and refuses exactly the files the JAX package does.

The two routes round a decimal token differently: ``strtof`` rounds it to
float32 once, the numpy route goes through a double and can round twice
(``"1.00000005960464477539062500000001"`` is ``0x3F800001`` natively and
``0x3F800000`` on the numpy route). They differ by at most one float32 ulp,
on tokens of more than nine significant digits. Parsers return numpy
arrays; the loop moves them to the device.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np

from distributed_active_learning_tpu_torch.data import _native


def _text_to_matrix(path: str, sep: Optional[str], native: bool = True) -> np.ndarray:
    """A dense numeric text file as a 2-D float32 array."""
    if native:
        mat = _native.try_load_matrix(path, sep)
        if mat is not None:
            return mat
    with open(path, "r") as f:
        raw = f.read()
    rows = [ln for ln in raw.splitlines() if ln.strip()]
    if not rows:
        raise ValueError(f"empty data file: {path}")
    ncol = len(rows[0].split(sep))
    if sep is None:
        # One big whitespace split, valid only when every row has the same
        # width (a total-token check alone would shift row boundaries on a
        # ragged file).
        if all(len(r.split()) == ncol for r in rows):
            tokens = raw.split()
            return np.asarray(tokens, dtype=np.float32).reshape(len(rows), ncol)
    return np.loadtxt(io.StringIO(raw), dtype=np.float32, delimiter=sep, ndmin=2)


def load_labeled_text(path: str, sep: Optional[str] = None, label_last: bool = True,
                      remap_negative: bool = True, native: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """A label-last (or label-first) dataset: ``(features float32 [n, d],
    labels int32 [n])``, a ``-1`` label remapped to ``0``
    (``classes/dataset.py:253-259``)."""
    mat = _text_to_matrix(path, sep, native)
    if label_last:
        feats, labels = mat[:, :-1], mat[:, -1]
    else:
        feats, labels = mat[:, 1:], mat[:, 0]
    labels = labels.astype(np.int32)
    if remap_negative:
        labels = np.where(labels < 0, 0, labels)
    return np.ascontiguousarray(feats, dtype=np.float32), labels


def load_credit_card_csv(path: str, native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """The Kaggle credit-card-fraud CSV (``mllib/credit_card_fraud.py:22-24``):
    the header dropped, comma-split, every column but the last a feature,
    the last field the label with its quotes stripped. Returns ``(features
    float32 [n, d], labels int32 [n])``."""
    if native:
        parsed = _native.try_load_csv_label_last(path)
        if parsed is not None:
            return parsed
    feats_rows = []
    labels = []
    with open(path, "r") as f:
        f.readline()  # the header, as the reference's `find("Time")` check
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            feats_rows.append([float(p.strip('"')) for p in parts[:-1]])
            labels.append(int(float(parts[-1].strip('"'))))
    return (
        np.asarray(feats_rows, dtype=np.float32),
        np.asarray(labels, dtype=np.int32),
    )


def load_triplet_text(path: str, shape: Optional[Tuple[int, int]] = None,
                      native: bool = True) -> np.ndarray:
    """An ``i j value`` triplet file as a dense float32 matrix (the
    reference's ``CoordinateMatrix`` inputs, ``final_thesis/test.py:21-24``)."""
    trip = _text_to_matrix(path, None, native)
    rows = trip[:, 0].astype(np.int64)
    cols = trip[:, 1].astype(np.int64)
    vals = trip[:, 2].astype(np.float32)
    if shape is None:
        shape = (int(rows.max()) + 1, int(cols.max()) + 1)
    out = np.zeros(shape, dtype=np.float32)
    out[rows, cols] = vals
    return out


def write_triplet_text(path: str, mat: np.ndarray) -> None:
    """A dense matrix as ``i j value`` triplets (``final_thesis/gen.py``)."""
    with open(path, "w") as f:
        for i in range(mat.shape[0]):
            for j in range(mat.shape[1]):
                # .9g: enough significant digits for a float32 round trip
                f.write(f"{i} {j} {mat[i, j]:.9g}\n")


CREDIT_CARD_ROWS, CREDIT_CARD_FRAUD = 284_807, 492  # the Kaggle file's counts


def write_credit_card_csv(path: str, n_rows: int = CREDIT_CARD_ROWS,
                          n_fraud: int = CREDIT_CARD_FRAUD, seed: int = 0) -> None:
    """A CSV in the Kaggle credit-card file's layout, made from ``seed`` (no
    download): the header ``"Time","V1",...,"V28","Amount","Class"``;
    ``Time`` integer seconds in [0, 172,792], sorted; ``V1..V28`` normal
    draws written as ``repr`` of a float64 (13-17 significant digits, as
    the real file's PCA columns carry, so a token can round differently on
    the native and the numpy route); ``Amount`` a heavy-tailed nonnegative
    amount in cents; the label quoted, ``n_fraud`` positives: the rows with
    the largest ``V1 + 0.3 V2`` plus a little seeded noise, a rule trees
    can learn."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, 172_793, n_rows))
    v = rng.normal(size=(n_rows, 28))
    amount = np.round(np.expm1(rng.gamma(1.3, 2.4, n_rows)), 2)
    score = v[:, 0] + 0.3 * v[:, 1] + 0.25 * rng.normal(size=n_rows)
    fraud = np.zeros(n_rows, dtype=bool)
    fraud[np.argsort(-score, kind="stable")[:n_fraud]] = True
    header = ",".join(f'"{c}"' for c in ["Time", *(f"V{i}" for i in range(1, 29)),
                                          "Amount", "Class"])
    with open(path, "w") as f:
        f.write(header + "\n")
        for i, row in enumerate(v.tolist()):
            f.write(f'{t[i]},{",".join(map(repr, row))},{amount[i]:.2f},"{int(fraud[i])}"\n')
