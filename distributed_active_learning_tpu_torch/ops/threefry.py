"""The neural path's random draws on the card (K7, ``csrc/threefry.cu``).

Flax's dropout masks (``uniform < keep``), the training minibatch draw
(``jax.random.categorical`` over the labeled mask) and the selects' Gumbel
draws are jax.random's partitionable threefry, which :mod:`..prng` computes
bit for bit in plain PyTorch. That form is one pass over the tensor per
threefry operation (about 120 a draw); at CIFAR width a round draws
hundreds of millions of values, and PERF.md gives the measured seconds a
round of both forms. K7 hashes each counter in registers instead.

:func:`uniform` and :func:`categorical` take the kernel on a CUDA tensor and
the plain version (:func:`..prng.uniform`, :func:`..prng.categorical`) on a
CPU tensor, and never fall back: a CUDA launch that fails raises. ``launches``
counts the kernel's launches (both entry points).
"""

from __future__ import annotations

from typing import Sequence

import torch

from distributed_active_learning_tpu_torch import kernels, prng

launches = 0


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` for one key ``[2]``: ``shape``
    float32 on the key's device."""
    if key.dtype != torch.int64 or key.shape != (2,):
        raise ValueError("K7's uniform takes one int64 key [2]")
    shape = tuple(int(s) for s in shape)
    if key.device.type != "cuda":
        return prng.uniform(key, shape, key.device)
    return _launch_uniform(key, shape)


def categorical(key: torch.Tensor, logits: torch.Tensor, rows: int) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=(rows,))`` for ``logits
    [n]`` shared by the rows, or ``jax.random.categorical(key, logits)`` for
    per-row ``logits [rows, n]``: the Gumbel-max draw, ``[rows]`` int32 on
    the logits' device."""
    if logits.device.type != "cuda":
        if logits.dim() == 1:
            return prng.categorical(key, logits, (rows,))
        return prng.categorical(key, logits, logits.shape[:-1])
    return _launch_categorical(key, logits, rows)


def _launch_uniform(key: torch.Tensor, shape) -> torch.Tensor:
    global launches
    key = key.contiguous()
    out = torch.empty(shape, dtype=torch.float32, device=key.device)
    lib = kernels.load("threefry")
    with torch.cuda.device(key.device):
        err = lib.threefry_uniform(key.data_ptr(), out.numel(), out.data_ptr(),
                                   torch.cuda.current_stream(key.device).cuda_stream)
    kernels.check("threefry_uniform", err)
    launches += 1
    return out


def _launch_categorical(key: torch.Tensor, logits: torch.Tensor, rows: int) -> torch.Tensor:
    global launches
    if key.dtype != torch.int64 or key.shape != (2,) or logits.dtype != torch.float32:
        raise ValueError("K7's categorical takes one int64 key [2] and float32 logits")
    if logits.dim() == 2 and logits.shape[0] != rows:
        raise ValueError(f"per-row logits {tuple(logits.shape)} need {rows} rows")
    key = key.to(logits.device).contiguous()
    logits = logits.contiguous()
    n = logits.shape[-1]
    stride = n if logits.dim() == 2 else 0
    out = torch.empty((rows,), dtype=torch.int32, device=logits.device)
    lib = kernels.load("threefry")
    with torch.cuda.device(logits.device):
        err = lib.threefry_categorical(key.data_ptr(), rows, n, logits.data_ptr(), stride,
                                       out.data_ptr(),
                                       torch.cuda.current_stream(logits.device).cuda_stream)
    kernels.check("threefry_categorical", err)
    launches += 1
    return out
