"""Feature standardization (MLlib ``StandardScaler(withMean, withStd)``).

A numpy copy of the JAX package's ``data/scaler.py``: synthetic bundles are
standardized on numpy arrays there too (``datasets._synth`` converts before
``_standardize``), so running the same numpy code keeps the standardized pool
identical bit for bit. Sample std (ddof=1); zero-variance columns divide by 1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class StandardScalerState(NamedTuple):
    mean: np.ndarray  # [d]
    std: np.ndarray   # [d], sample std (ddof=1), zeros replaced by 1


def fit_standard_scaler(
    x: np.ndarray, with_mean: bool = True, with_std: bool = True
) -> StandardScalerState:
    """Fit mean/std over rows of ``x`` [n, d]."""
    mean = np.mean(x, axis=0)
    if x.shape[0] > 1:
        std = np.std(x, axis=0, ddof=1)
    else:
        std = np.zeros_like(mean)
    std = np.where(std == 0, np.ones_like(std), std)
    if not with_mean:
        mean = np.zeros_like(mean)
    if not with_std:
        std = np.ones_like(std)
    return StandardScalerState(mean=mean, std=std)


def transform(state: StandardScalerState, x: np.ndarray) -> np.ndarray:
    return (x - state.mean) / state.std


def fit_transform(x: np.ndarray, with_mean: bool = True, with_std: bool = True) -> np.ndarray:
    return transform(fit_standard_scaler(x, with_mean, with_std), x)
