"""Synthetic dataset generators and drift schedules (the port's subset of
``data/synthetic.py``).

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


def drift_transform(x: torch.Tensor, step, kind: str = "mean_shift", rate: float = 0.1,
                    direction: torch.Tensor = None, fused: bool = True) -> torch.Tensor:
    """``step`` units of distribution drift applied to a feature batch (the
    scenario engine's and the drifting stream's shared schedule):
    ``mean_shift`` translates along ``direction`` (a unit vector; the first
    axis by default) by ``rate`` a step, ``rotation`` rotates the first two
    coordinates by ``rate`` radians a step. ``step`` is an int or a 0-d int
    tensor on ``x``'s device.

    ``mean_shift`` is ``x + (rate * t) * direction`` with no fused
    multiply-add, as XLA computes it. ``rotation`` is ``c * x0 - s * x1``
    and ``s * x0 + c * x1``: compiled inside one program (``fused``, the JAX
    package's drift inside a jitted round) XLA fuses the first product into
    the sum, while the eager spelling (``fused=False``, the JAX package's
    drifting stream) rounds each product. ``cos`` and ``sin`` are taken in
    float64 and rounded once, which is what XLA's float32 code gives at the
    angles the schedules reach (held in ``tests/test_torch_prng.py``)."""
    t = torch.as_tensor(step, device=x.device).to(torch.float32)
    if kind == "rotation":
        theta = (t * rate).double()
        c, s = torch.cos(theta).float(), torch.sin(theta).float()
        x0, x1 = x[..., 0], x[..., 1]
        if fused:
            from distributed_active_learning_tpu_torch.ops.xla_f32 import fma_f32

            r0, r1 = fma_f32(c, x0, -(s * x1)), fma_f32(s, x0, c * x1)
        else:
            r0, r1 = c * x0 - s * x1, s * x0 + c * x1
        return torch.cat([r0[..., None], r1[..., None], x[..., 2:]], dim=-1)
    if kind != "mean_shift":
        raise ValueError(f"unknown drift kind {kind!r}; 'mean_shift' or 'rotation'")
    if direction is None:
        direction = torch.zeros(x.shape[-1], dtype=torch.float32, device=x.device)
        direction[0] = 1.0
    return x + (t * rate) * direction


def make_drifting_stream(key: prng.Key, n_blocks: int, block_rows: int, d: int = 4,
                         kind: str = "mean_shift", rate: float = 0.25, warm_blocks: int = 0):
    """A drifting ingest stream: ``n_blocks`` blocks of ``(x [block_rows,
    d], y [block_rows])`` from a two-class mixture (``x = z + 2 y``), block
    ``i`` past the first ``warm_blocks`` drifted by ``i - warm_blocks``
    steps of :func:`drift_transform` (the eager spelling). Labels stay a
    function of the undrifted coordinates: the world moves under the model.
    The JAX package's ``make_drifting_stream``, bit for bit, drawn on the
    key's device."""
    blocks = []
    for i in range(n_blocks):
        k_lab, k_pts = prng.split(prng.fold_in(key, i))
        y = prng.randint(k_lab, (block_rows,), 0, 2)
        z = prng.normal(k_pts, (block_rows, d))
        x = z + 2.0 * y[:, None].to(torch.float32)
        step = max(i - warm_blocks, 0)
        if step > 0:
            x = drift_transform(x, step, kind=kind, rate=rate, fused=False)
        blocks.append((x, y))
    return blocks
