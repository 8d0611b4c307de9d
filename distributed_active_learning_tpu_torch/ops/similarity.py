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


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(x * x, -1)`` of float32 rows in the order the JAX package's
    jitted code adds the squares on an AVX-512 host: a fused multiply-add
    chain for d = 1-4 and 9-32, a sequential sum of rounded squares for
    d = 5-8, and ``xla_f32.row_sum``'s 32-term windows past 32. The order
    below 33 moves with the host's vector instruction set (an AVX2 host
    contracts at d = 5 and 7 too, SSE4.2 and AVX hosts nowhere: ROADMAP
    queue 3); past 32 it is the same under every one. Elementwise
    operations only, so the card gives the CPU's bits."""
    from distributed_active_learning_tpu_torch.ops.xla_f32 import fma_f32, row_sum

    d = x.shape[-1]
    if d > 32:
        return row_sum((x * x).reshape(-1, d)).reshape(x.shape[:-1])
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(d):
        xi = x[..., i]
        acc = acc + xi * xi if 5 <= d <= 8 else fma_f32(xi, xi, acc)
    return acc


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rows scaled to unit L2 norm (norms below ``eps`` divide by ``eps``):
    the squares summed in the JAX package's order (:func:`_sum_squares`),
    the root taken in float64 and rounded once (correctly rounded, as
    XLA's; PyTorch's float32 root on the CPU is not everywhere)."""
    from distributed_active_learning_tpu_torch.ops.xla_f32 import sqrt_f32

    norm = sqrt_f32(_sum_squares(x))[..., None]
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
