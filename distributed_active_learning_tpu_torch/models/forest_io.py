"""Forest files (the port of ``models/forest_io.py``): one ``.npz`` holding a
:class:`~..ops.trees.PackedForest`'s five node arrays, its depth and a format
version, in the JAX package's format, so a file written by either package
loads in the other. A host-fit forest reaches a machine without
scikit-learn this way.

Format version 1: ``version`` (int32), ``feature`` (int32 ``[T, N]``),
``threshold`` (float32), ``left``, ``right`` (int32), ``value`` (float32),
``max_depth`` (int32) and, optionally, ``meta`` (the caller's string as
uint8 bytes).
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from distributed_active_learning_tpu_torch.device import resolve_device
from distributed_active_learning_tpu_torch.ops.trees import PackedForest
from distributed_active_learning_tpu_torch.utils.io import atomic_savez

_FORMAT_VERSION = 1
_DTYPES = {"feature": np.int32, "threshold": np.float32, "left": np.int32, "right": np.int32,
           "value": np.float32}


def save_forest(path: str, forest: PackedForest, meta: Optional[str] = None) -> str:
    """Write ``forest`` to ``path`` (npz, atomic); returns the path. ``meta``
    is an opaque caller string stored beside the arrays (:func:`load_or_train`
    compares it)."""
    payload = {"version": np.asarray(_FORMAT_VERSION, dtype=np.int32)}
    for name, dtype in _DTYPES.items():
        payload[name] = np.ascontiguousarray(getattr(forest, name).cpu().numpy(), dtype=dtype)
    payload["max_depth"] = np.asarray(forest.max_depth, dtype=np.int32)
    if meta is not None:
        payload["meta"] = np.frombuffer(meta.encode(), dtype=np.uint8)
    return atomic_savez(path, **payload)


def load_forest(path: str, device=None) -> Tuple[PackedForest, Optional[str]]:
    """``(forest, meta)`` from a file :func:`save_forest` (of either package)
    wrote, the forest on ``device`` (default CUDA; ``"cpu"`` to load without
    a card)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        version = int(z["version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported forest format version {version}")
        meta = bytes(z["meta"]).decode() if "meta" in z.files else None
        arrays = {name: torch.from_numpy(np.asarray(z[name], dtype=dtype)).to(dev)
                  for name, dtype in _DTYPES.items()}
        return PackedForest(**arrays, max_depth=int(z["max_depth"])), meta


def load_or_train(path: str, train_fn: Callable[[], PackedForest], meta: Optional[str] = None,
                  device=None) -> PackedForest:
    """Load the forest at ``path`` if there is one (and its ``meta`` matches
    when given), else train it with ``train_fn`` and save it there. A file
    that cannot be read is retrained over, with a warning; an ``OSError``
    propagates. The forest is returned on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    if os.path.exists(path):
        try:
            forest, stored_meta = load_forest(path, dev)
            if meta is None or stored_meta == meta:
                return forest
        except (ValueError, KeyError) as e:
            warnings.warn(f"stored forest at {path} unreadable ({e}); retraining", stacklevel=2)
    forest = train_fn()
    save_forest(path, forest, meta=meta)
    return forest.to(dev)
