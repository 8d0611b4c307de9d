"""Synthetic dataset generators and drift schedules (the port of
``data/synthetic.py``).

Draws come from :mod:`~distributed_active_learning_tpu_torch.prng`, so a key
gives the same points as ``jax.random`` does in the JAX package, and the
arithmetic around them is spelled as the JAX package's CPU code computes it
(each generator runs there eagerly, one XLA program an operation), so every
generator's output equals the JAX package's bit for bit, with one named
exception: :func:`make_striatum_like`'s scores (see there). Generators run
on the key's device (the CPU unless the caller moved the key); the registry
draws on the CPU.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.ops.xla_f32 import (
    cholesky_f32, log1p_f32, ndtri_f32, small_matmul_f32,
)


def _class_labels(key: prng.Key, n: int, n_classes: int, imbalance: float) -> torch.Tensor:
    """Labels with a geometric class prior ``p_k ~ (1 - imbalance)^k``
    (``imbalance=0``: uniform), the deep-AL stand-ins' difficulty knob:
    ``categorical`` over ``arange(C) * log1p(-imbalance)``."""
    if imbalance > 0.0:
        step = log1p_f32(torch.tensor(-imbalance, dtype=torch.float32, device=key.device))
        logp = torch.arange(n_classes, device=key.device).to(torch.float32) * step
        return prng.categorical(key, logp, (n,))
    return prng.randint(key, (n,), 0, n_classes)


def make_xor(key: prng.Key, n: int, d: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """d-dimensional XOR: ``x ~ U[0,1)^d``, label = parity of the per-feature
    half-space bits (the reference's ``xor_generator.get_xor_data``)."""
    x = prng.uniform(key, (n, d))
    labels = (x > 0.5).to(torch.int32).sum(dim=1) % 2
    return x, labels.to(torch.int32)


def make_checkerboard(
    key: prng.Key, n: int, grid: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D checkerboard over [0,1]^2: ``x ~ U[0,1)^2``, label = parity of
    the ``grid x grid`` cell (the reference's checkerboard fixtures)."""
    x = prng.uniform(key, (n, 2))
    cells = torch.floor(x * grid).to(torch.int32)
    labels = (cells[:, 0] + cells[:, 1]) % 2
    return x, labels.to(torch.int32)


def make_rotated_checkerboard(key: prng.Key, n: int, grid: int = 2,
                              angle: float = 0.7853981633974483
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The checkerboard rotated by ``angle`` (45 degrees) about the board's
    centre (the reference's ``DatasetRotatedCheckerboard2x2``). ``cos`` and
    ``sin`` of the float32 angle are taken in float64 and rounded once (what
    XLA's float32 code gives at this angle); each product and sum is its
    own rounded operation, as in the JAX package's eager code."""
    x = prng.uniform(key, (n, 2))
    a = float(np.float32(angle))
    c, s = float(np.float32(math.cos(a))), float(np.float32(math.sin(a)))
    cx, cy = x[:, 0] - 0.5, x[:, 1] - 0.5
    un_rot = torch.stack([c * cx + s * cy, -s * cx + c * cy], dim=1) + 0.5
    cells = torch.floor(un_rot * grid).to(torch.int32)
    labels = (cells[:, 0] + cells[:, 1]) % 2
    return x, labels.to(torch.int32)


def make_gaussian_unbalanced(key: prng.Key, n_train: int, dim: int = 2, test_factor: int = 10):
    """Two random Gaussian clouds, class-1 prior uniform in [0.1, 0.9], a
    test set ``test_factor`` times the pool from the same mixture (the
    reference's ``DatasetSimulatedUnbalanced``, the LAL regressor's
    training distribution). Returns ``(train_x, train_y, test_x, test_y)``.

    The covariances ``a a^T + 0.1 I``, their Cholesky factors and the
    products ``z L^T`` are spelled as XLA computes them at ``dim = 2`` (the
    registry's and the LAL generator's; :func:`~.ops.xla_f32.
    small_matmul_f32`, :func:`~.ops.xla_f32.cholesky_f32`), so the clouds
    are the JAX package's bit for bit there; a larger ``dim`` agrees to
    ``xla_f32.CHOLESKY_RTOL``."""
    k = prng.split(key, 7)
    p1 = prng.uniform(k[0], (), minval=0.1, maxval=0.9)
    mean0 = prng.uniform(k[1], (dim,), minval=-1.0, maxval=1.0)
    mean1 = prng.uniform(k[2], (dim,), minval=-1.0, maxval=1.0)

    def rand_cov(kc):
        a = prng.uniform(kc, (dim, dim), minval=-1.0, maxval=1.0)
        eye = torch.eye(dim, device=a.device) * float(np.float32(0.1))
        return small_matmul_f32(a, a.T) + eye

    chol0, chol1 = cholesky_f32(rand_cov(k[3])), cholesky_f32(rand_cov(k[4]))

    def sample(ks, m):
        k_lab, k_pts = prng.split(ks)
        y = (prng.uniform(k_lab, (m,)) < p1).to(torch.int32)
        z = prng.normal(k_pts, (m, dim))
        x0 = small_matmul_f32(z, chol0.T) + mean0
        x1 = small_matmul_f32(z, chol1.T) + mean1
        return torch.where(y[:, None] == 1, x1, x0), y

    train_x, train_y = sample(k[5], n_train)
    test_x, test_y = sample(k[6], n_train * test_factor)
    return train_x, train_y, test_x, test_y


def make_blobs(key: prng.Key, n: int, d: int = 4, n_classes: int = 4, spread: float = 2.2
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """C-class Gaussian blobs (the multiclass tabular pool): unit clouds
    around a fixed lattice of means (``spread`` times the first C axes for
    C <= d, else a fixed normal draw), balanced labels."""
    k_lab, k_pts = prng.split(key)
    if n_classes <= d:
        means = torch.eye(n_classes, d, device=key.device) * float(np.float32(spread))
    else:
        means = prng.normal(prng.key(0, key.device), (n_classes, d)) * float(np.float32(spread))
    y = prng.randint(k_lab, (n,), 0, n_classes)
    z = prng.normal(k_pts, (n, d))
    return z + means[y.long()], y


def make_striatum_like(key: prng.Key, n: int, d: int = 50, pos_frac: float = 0.25,
                       decay: float = 0.5, label_noise: float = 0.01
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The striatum-shaped pool (the JAX package's scale-run dataset):
    ``x ~ N(0, I_d)``, labels from one fixed oblique hyperplane ``x . w >
    t`` with ``w_j = +-decay^j`` (every third sign flipped), ``t`` set so
    that positives are a ``pos_frac`` minority, then ``label_noise``
    symmetric flips.

    ``t`` is the JAX package's bits: ``||w||`` correctly rounded (what XLA
    gives at the registry's ``d = 50``) times JAX's float32 ``norm.ppf``
    (:func:`~.ops.xla_f32.ndtri_f32`). The scores ``x . w`` are summed in
    float64 and rounded once: XLA's order for this matrix-vector product
    depends on the host (ROADMAP queue 3), so they agree with the JAX
    package's to ``STRIATUM_SCORE_ATOL`` only, and a label could differ for
    a row whose score lies within that of ``t`` (about 6e-4 rows expected in
    a 10,000-row pool). The scores never leave this function; the labels
    are held bit-equal."""
    w, t = striatum_boundary(d, pos_frac, decay, key.device)
    k_x, k_flip = prng.split(key)
    x = prng.normal(k_x, (n, d))
    y = (striatum_scores(x, w) > t).to(torch.int32)
    if label_noise > 0.0:
        flip = prng.uniform(k_flip, (n,)) < label_noise
        y = torch.where(flip, 1 - y, y)
    return x, y


# How far make_striatum_like's scores may lie from the JAX package's (an
# absolute bound: a few float32 ulps of a 50-term sum of magnitude ~4).
STRIATUM_SCORE_ATOL = 4e-6


def striatum_boundary(d: int = 50, pos_frac: float = 0.25, decay: float = 0.5, device=None):
    """``(w [d] float32, t)`` of :func:`make_striatum_like`'s hyperplane:
    ``w_j = decay^j`` (float64, rounded once: exact for the registry's
    0.5), every third sign flipped, and ``t = f32(||w||) * ndtri(1 -
    pos_frac)`` in float32."""
    j = torch.arange(d, device=device)
    w = (decay ** j.double()).float() * torch.where(j % 3 == 1, -1.0, 1.0)
    norm = np.float32(math.sqrt(float((w.double() ** 2).sum())))
    q = ndtri_f32(torch.tensor([1.0 - pos_frac], dtype=torch.float32))[0].numpy()
    return w, float(norm * q)


def striatum_scores(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` summed in float64 and rounded once (within
    ``STRIATUM_SCORE_ATOL`` of XLA's host-dependent float32 order)."""
    return (x.double() @ w.double()).float()


def make_random_matrix(key: prng.Key, n: int, d: int) -> torch.Tensor:
    """A dense ``U[0, 1)`` matrix (the reference's similarity inputs)."""
    return prng.uniform(key, (n, d))


def _bilinear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize``'s bilinear (triangle) weights ``[n_in, n_out]``
    for an upsample: sample points ``(j + 0.5) / scale - 0.5``, weights
    ``max(0, 1 - |s - i|)`` normalized by their column sums, zero outside
    the input. At 4 -> 32 every weight is a dyadic fraction, computed
    exactly."""
    inv = float(np.float32(n_in / n_out))
    sample = (torch.arange(n_out, device=device, dtype=torch.float32) + 0.5) * inv - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(n_in, device=device, dtype=torch.float32)[:, None])
    w = torch.clamp_min(1.0 - dist, 0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize_bilinear(x: torch.Tensor, hw: int) -> torch.Tensor:
    """``jax.image.resize(x, (..., hw, hw, c), "bilinear")`` of ``[..., h,
    h, c]`` in float32 as XLA's CPU code computes it: the height contraction
    as a fused multiply-add chain over the inputs in order (from 0), then the
    width contraction as rounded products added in order (from 0); held bit
    for bit against JAX at 4 -> 32."""
    from distributed_active_learning_tpu_torch.ops.xla_f32 import fma_f32

    h = x.shape[-3]
    w = _bilinear_weights(h, hw, x.device)
    # Height: [..., h, h, c] -> [..., hw, h, c].
    rows = []
    for o in range(hw):
        acc = torch.zeros_like(x[..., 0, :, :])
        for k in range(h):
            acc = fma_f32(x[..., k, :, :], w[k, o], acc)
        rows.append(acc)
    x = torch.stack(rows, dim=-3)
    # Width: [..., hw, h, c] -> [..., hw, hw, c].
    cols = []
    for o in range(hw):
        acc = torch.zeros_like(x[..., :, 0, :])
        for k in range(h):
            acc = acc + x[..., :, k, :] * w[k, o]
        cols.append(acc)
    return torch.stack(cols, dim=-2)


def make_synthetic_images(key: prng.Key, n: int, n_classes: int = 10, hw: int = 32,
                          channels: int = 3, noise: float = 6.0, modes_per_class: int = 1,
                          max_shift: int = 0, imbalance: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CIFAR-shaped stand-in pool ``[n, hw, hw, c]`` float32 and its
    labels: per class ``modes_per_class`` smooth prototypes (4 x 4 normal
    patterns upsampled bilinearly), each sample its class's prototype of a
    drawn mode, circularly shifted by a drawn offset in ``[-max_shift,
    max_shift]^2``, plus ``noise`` times a normal draw. Train and test must
    come from one call (the prototypes are drawn from ``key``). Labels,
    modes, shifts and pixels equal the JAX package's bit for bit
    (:func:`_resize_bilinear` reproduces the resize's arithmetic)."""
    k_proto, k_noise, k_lab, k_mode, k_shift = prng.split(key, 5)
    coarse = prng.normal(k_proto, (n_classes, modes_per_class, 4, 4, channels))
    protos = _resize_bilinear(coarse, hw)
    y = _class_labels(k_lab, n, n_classes, imbalance)
    mode = prng.randint(k_mode, (n,), 0, modes_per_class)
    base = protos[y.long(), mode.long()]
    if max_shift > 0:
        shifts = prng.randint(k_shift, (n, 2), -max_shift, max_shift + 1).long()
        # jnp.roll per sample: out[h, w] = in[(h - s0) mod hw, (w - s1) mod hw].
        ar = torch.arange(hw, device=base.device)
        rows = (ar[None, :] - shifts[:, :1]) % hw
        cols = (ar[None, :] - shifts[:, 1:]) % hw
        idx = torch.arange(n, device=base.device)[:, None, None]
        base = base[idx, rows[:, :, None], cols[:, None, :]]
    x = base + float(np.float32(noise)) * prng.normal(k_noise, (n, hw, hw, channels))
    return x, y


def make_synthetic_tokens(key: prng.Key, n: int, n_classes: int = 4, vocab_size: int = 4096,
                          max_len: int = 64, topic_frac: float = 0.7, overlap: float = 0.0,
                          imbalance: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The AG-News-shaped stand-in pool ``[n, max_len]`` int32 token ids and
    labels: each class draws its topical tokens from its own (``overlap``
    widened) span of the vocabulary, the rest uniform "stopwords"
    (``topic_frac`` of the positions topical), classes by
    :func:`_class_labels`."""
    k_lab, k_tok, k_stop, k_mix = prng.split(key, 4)
    y = _class_labels(k_lab, n, n_classes, imbalance)
    span = (vocab_size - 1) // n_classes
    wide = min(int(span * (1.0 + 2.0 * overlap)), vocab_size - 1)
    lo = torch.clamp(1 + y[:, None] * span - int(span * overlap), 1, vocab_size - wide)
    topic = lo + prng.randint(k_tok, (n, max_len), 0, max(wide, 1))
    stop = 1 + prng.randint(k_stop, (n, max_len), 0, vocab_size - 1)
    is_topic = prng.uniform(k_mix, (n, max_len)) < topic_frac
    return torch.where(is_topic, topic, stop).to(torch.int32), y


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
