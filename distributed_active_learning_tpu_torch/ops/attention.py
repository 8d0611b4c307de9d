"""Single-device exact attention (the port of ``ops/ring_attention.py``'s
``full_attention``).

The same two einsums and softmax as the JAX function, in plain PyTorch on
the ``[B, T, H, D]`` layout, so the card and the CPU compute one form.
``ring_attention`` (the sequence sharded over a mesh) waits for the
mesh-and-pod slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` over ``[B, T, H, D]`` tensors (a causal
    mask writes -1e30 above the diagonal)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        T = q.shape[1]
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
        scores = torch.where(mask[None, None], scores, torch.full((), -1e30, device=q.device))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
