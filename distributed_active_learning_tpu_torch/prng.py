"""``jax.random``'s threefry2x32 in PyTorch, partitionable mode, bit for bit.

The JAX package pins ``jax_threefry_partitionable`` (its ``__init__.py``),
and every pick, mask and bootstrap weight of the AL loop is a function of
that stream. Reproducing it exactly is what lets the port's runs equal the
JAX package's end to end. Definitions follow ``jax/_src/prng.py``
(``threefry_2x32``, ``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``, ``iota_2x32_shape``) and
``jax/_src/random.py`` (``_uniform``, ``_normal_real``, ``_randint``).

A key is an ``int64`` tensor whose last axis holds the two ``uint32`` words
of ``jax.random.key_data`` (leading axes batch several keys). A key may
live on the CPU (a few words; the per-round driver keeps it there, which
spares a launch per hash round) or on the device: the chunked driver carries
its key on the card, because whether a round is active is known only there,
and no function here copies a device key to the host. Draws are generated on
the requested device. The 32-bit arithmetic runs in ``int64`` masked to 32 bits, so it is the same on
every backend (PyTorch has no full unsigned 32-bit arithmetic on all of
them).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2_F32 = float(np.float32(math.sqrt(2.0)))
_TINY_F32 = float(np.finfo(np.float32).tiny)

Key = torch.Tensor


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of counter pairs ``(x1, x2)`` under key
    ``(k1, k2)``; all broadcastable ``int64`` tensors holding uint32 values.
    Five groups of four rounds with key injection, as
    ``_threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def key(seed: int, device=None) -> Key:
    """``jax.random.key(seed)``'s key data: the seed's high and low words
    (on the CPU unless ``device`` is given)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64, device=device)


def _words(k: Key, extra_dims: int, device=None):
    k = k.to(device) if device is not None else k
    shape = k.shape[:-1] + (1,) * extra_dims
    return k[..., 0].reshape(shape), k[..., 1].reshape(shape)


def split(k: Key, num: int = 2) -> Key:
    """``jax.random.split``: ``[..., 2] -> [..., num, 2]``."""
    k1, k2 = _words(k, 1)
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(k: Key, data: Union[int, torch.Tensor]) -> Key:
    """``jax.random.fold_in``: hash the counter pair ``(0, uint32(data))``.
    ``data`` is a Python int or an integer tensor on the key's device (the
    chunked driver's round counter); neither is copied between host and
    device."""
    k1, k2 = k[..., 0], k[..., 1]
    if torch.is_tensor(data):
        d = data.to(torch.int64) & _MASK
    else:
        d = int(data) & _MASK
    b1, b2 = threefry2x32(k1, k2, 0, d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """32 random bits per element (``int64`` holding uint32): the threefry
    hash of the element's row-major position, ``bits1 ^ bits2``. Batched
    keys ``[*B, 2]`` give ``[*B, *shape]``."""
    shape = tuple(int(s) for s in shape)
    device = k.device if device is None else torch.device(device)
    k1, k2 = _words(k, len(shape), device)
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    b1, b2 = threefry2x32(k1, k2, counts >> 32, counts & _MASK)
    return b1 ^ b2


def uniform(k: Key, shape: Sequence[int], device=None, *, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in ``[1, 2)``, minus one, then times
    ``f32(maxval) - f32(minval)`` plus ``f32(minval)`` as one fused
    multiply-add (XLA contracts the two inside JAX's jitted ``_uniform``),
    floored at ``minval``."""
    bits = random_bits(k, shape, device)
    one_bits = 0x3F800000
    f = ((bits >> 9) | one_bits).to(torch.int32).view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return f
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    if math.frexp(span)[0] == 0.5:
        # A power-of-two span: the product is exact, so the fused and the
        # rounded multiply-add agree, and the cheaper one runs.
        scaled = f * span + lo
    else:
        from distributed_active_learning_tpu_torch.ops.xla_f32 import fma_f32

        scaled = fma_f32(f, span, lo)
    return torch.clamp_min(scaled, lo)


def normal(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32 (``_normal_real``): a
    uniform draw on ``[nextafter(-1, 0), 1)``, then ``f32(sqrt 2) *
    erf_inv(u)`` with XLA's single-precision ``erf_inv``
    (:func:`~.ops.xla_f32.erfinv_f32`)."""
    from distributed_active_learning_tpu_torch.ops.xla_f32 import erfinv_f32

    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, device, minval=lo, maxval=1.0)
    return erfinv_f32(u) * _SQRT2_F32


def gumbel(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32 (the "low" mode, JAX's
    default): ``-log(-log(u))`` of a uniform draw on ``[tiny, 1)``, both
    logs XLA's (:func:`~.ops.xla_f32.log_f32`)."""
    from distributed_active_learning_tpu_torch.ops.xla_f32 import log_f32

    u = uniform(k, shape, device, minval=_TINY_F32, maxval=1.0)
    return -log_f32(-log_f32(u))


def categorical(k: Key, logits: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` for a 1-D
    ``logits`` of C classes: the Gumbel-max trick, the argmax (first index
    on a tie) of ``gumbel(key, shape + (C,)) + logits``, as int32 on the
    logits' device."""
    g = gumbel(k, tuple(shape) + (logits.shape[-1],), logits.device)
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


def randint(k: Key, shape: Sequence[int], minval: int, maxval: int, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32
    (``_randint``): two 32-bit draws from a split of the key, folded into
    ``[minval, maxval)`` by JAX's unsigned arithmetic, ``(hi % span) *
    (2^32 % span) + lo % span``, modulo the span, all mod 2^32."""
    minval, maxval = int(minval), int(maxval)
    if not (-2**31 <= minval < 2**31 and -2**31 <= maxval < 2**31):
        raise ValueError("randint here covers int32 bounds only")
    keys = split(k)
    hi = random_bits(keys[..., 0, :], shape, device)
    lo = random_bits(keys[..., 1, :], shape, device)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (((hi % span) * mult) & _MASK) + (lo % span)
    off = (off & _MASK) % span
    out = (off + minval) & _MASK
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)
