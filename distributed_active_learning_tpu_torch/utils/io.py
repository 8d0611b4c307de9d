"""Atomic file writes for persisted models (the port of ``utils/io.py``): a
temp file in the target directory published with ``os.replace``, so readers
never see a half-written npz."""

from __future__ import annotations

import os
import tempfile

import numpy as np


def atomic_savez(path: str, **payload) -> str:
    """``np.savez(path, **payload)`` through a temp file and an atomic
    rename; returns ``path``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path
