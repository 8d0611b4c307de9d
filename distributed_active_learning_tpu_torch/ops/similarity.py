"""Cosine similarity over the pool (the port of ``ops/similarity.py``; plain
XLA there, so plain PyTorch here).

- :func:`similarity_mass`: the density strategy's per-row sum of cosine
  similarities against a masked set, in O(n d) as two matvecs over
  L2-normalized rows: ``mass = X^ (X^T m)``.
- :func:`pairwise_cosine`: the full ``[n, m]`` matrix, one product.
- :func:`blocked_pairwise_cosine_reduce`: a reduction over row slabs of the
  n x n matrix that never holds more than one slab.

Every product here runs in IEEE float32, the JAX package's
``Precision.HIGHEST``: on the card TF32 is switched off around each product
(:func:`_ieee_f32`) whatever the process-wide setting is. The mass is a float
sum over the pool whose order differs from XLA's, so it agrees with the JAX
package to a tolerance (``MASS_RTOL``), not bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

# Relative tolerance of the mass against the JAX package's, and between the
# card and the CPU: float32 sums over the pool in different orders.
MASS_RTOL = 1e-5


@contextlib.contextmanager
def _ieee_f32():
    """Float32 products on the card: TF32 off for the duration."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rows scaled to unit L2 norm (norms below ``eps`` divide by ``eps``)."""
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def pairwise_cosine(x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cosine-similarity matrix ``[n, m]`` of the rows of ``x`` and ``y``
    (``x`` with itself by default)."""
    xn = l2_normalize(x)
    yn = xn if y is None else l2_normalize(y)
    with _ieee_f32():
        return xn @ yn.T


def similarity_mass(x: torch.Tensor, count_mask: torch.Tensor,
                    normalized: bool = False) -> torch.Tensor:
    """``mass_i = sum_j count_mask_j cos(x_i, x_j)`` for every row, the self
    term included: ``X^ (X^T m)`` over the L2-normalized rows ``X^``."""
    xn = x if normalized else l2_normalize(x)
    with _ieee_f32():
        pooled = torch.mv(xn.T, count_mask.to(xn.dtype))
        return torch.mv(xn, pooled)


def blocked_pairwise_cosine_reduce(x: torch.Tensor,
                                   reduce_fn: Callable[[torch.Tensor], torch.Tensor],
                                   block: int = 1024) -> torch.Tensor:
    """``reduce_fn`` applied to each ``[block, n]`` row slab of the cosine
    matrix of ``x``, the results joined over the rows."""
    xn = l2_normalize(x)
    out = []
    with _ieee_f32():
        for slab in torch.split(xn, block):
            out.append(reduce_fn(slab @ xn.T))
    return torch.cat(out)
