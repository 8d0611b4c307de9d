"""Synthetic dataset generators (the port's subset of ``data/synthetic.py``).

Draws come from :mod:`~distributed_active_learning_tpu_torch.prng`, so a key
gives the same points as ``jax.random`` does in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from distributed_active_learning_tpu_torch import prng


def make_checkerboard(
    key: prng.Key, n: int, grid: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D checkerboard over [0,1]^2: ``x ~ U[0,1)^2``, label = parity of
    the ``grid x grid`` cell (the reference's checkerboard fixtures)."""
    x = prng.uniform(key, (n, 2))
    cells = torch.floor(x * grid).to(torch.int32)
    labels = (cells[:, 0] + cells[:, 1]) % 2
    return x, labels.to(torch.int32)
