"""float32 arithmetic as the JAX package's CPU code computes it.

XLA's CPU code is not IEEE arithmetic operation by operation, and the port's
results must equal the JAX package's bit for bit, so four of its habits are
written out here:

- a division by a constant becomes a multiplication by the constant's
  float32 reciprocal (:func:`div_const`);
- LLVM contracts a multiply followed by an add into one fused multiply-add
  (:func:`fma_f32`, exact in float64 with a TwoSum correction);
- a sum over a row of more than 32 terms is not added in ascending order: XLA
  rewrites the reduce into windows of 32 (:func:`row_sum`);
- ``log`` is XLA's own float32 polynomial (Cephes' ``logf``, with its FMAs),
  not the C library's, and ``log2(x)`` is ``log(x) * f32(1 / ln 2)``
  (:func:`log_f32`, :func:`log2_f32`); ``log1p`` and ``erf_inv`` are XLA's
  own too (:func:`log1p_f32`, :func:`erfinv_f32`, which ``prng.normal``
  reads).

Each spelling was found by holding the jitted JAX expression against the
candidates over every input the port feeds it (``tests/test_torch_scoring.py``
checks the score tables for every tree count from 1 to 256). Every function
works on any device: the card computes the same bits as the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def div_const(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` for a constant ``c``: ``x * f32(1 / c)``, which differs from
    a true division in the last place when ``1/c`` is inexact (e.g. 13)."""
    return x * recip_f32(c)


def recip_f32(c) -> float:
    """The float32 reciprocal XLA folds a division by ``c`` into."""
    return float(np.float32(1.0) / np.float32(c))


_REDUCE_WINDOW = 32


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(x, axis=1)`` of ``[n, T]`` float32 in the order XLA's CPU
    code adds the T terms (read off the compiled HLO and held against the
    jitted sum for every T up to 299 and 512, 1000, 1024, 1025, 2000). Up to 32 terms
    are added to 0 in ascending order. Longer rows are rewritten before code
    generation (so the order is the same under every vector instruction set:
    checked under SSE4.2, AVX, AVX2 and AVX-512): the row is padded with
    zeros to a multiple of 32, ``pad // 2`` of them in front, each window of
    32 is added in ascending order, and the window sums are reduced the same
    way again. Elementwise adds only, so the card gives the CPU's bits."""
    n, T = x.shape
    W = _REDUCE_WINDOW
    if T > W:
        pad = -T % W
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).reshape(n, -1, W)
        acc = torch.zeros_like(x[..., 0])
        for t in range(W):
            acc = acc + x[..., t]
        return row_sum(acc)
    acc = torch.zeros_like(x[:, 0])
    for t in range(T):
        acc = acc + x[:, t]
    return acc


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add.

    In float64 the product of two float32 values is exact; the sum is
    rounded to float64 and then to float32, which differs from one rounding
    only when the float64 sum lands exactly halfway between two float32
    values; that case is resolved by the sign of the float64 sum's exact
    error term (TwoSum). Python numbers broadcast against the tensors.
    """
    ref = next(t for t in (a, b, c) if torch.is_tensor(t))
    # torch.full fills on the device: no host-to-device copy, so the call can
    # be captured into a CUDA graph.
    a, b, c = (t if torch.is_tensor(t) else torch.full((), t, dtype=torch.float32, device=ref.device)
               for t in (a, b, c))
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()
    cd = c.double()
    r = p + cd
    bv = r - p
    err = (p - (r - bv)) + (cd - bv)
    r32 = r.float()
    toward = torch.where(r > r32.double(), torch.full_like(r32, math.inf), torch.full_like(r32, -math.inf))
    other = torch.nextafter(r32, toward)
    midpoint = (r32.double() + other.double()) * 0.5 == r
    pick_other = midpoint & (((err > 0) & (other > r32)) | ((err < 0) & (other < r32)))
    return torch.where(pick_other, other, r32)


# Cephes' logf coefficients, as XLA's CPU code carries them.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRT_HALF = 0.707106781186547524
_MIN_NORMAL = float(np.float32(2.0) ** -126)
_INV_LN2 = float(np.float32(1.0 / math.log(2.0)))


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log``: split ``x = m * 2^e`` with ``m`` in
    ``[sqrt(1/2), sqrt(2))``, a degree-9 polynomial in ``t = m - 1`` evaluated
    with FMAs, and ``e * ln 2`` added in two parts. Subnormals are flushed to
    the smallest normal; 0 gives -inf, negatives and NaN give NaN, +inf
    gives +inf."""
    x = x.to(torch.float32)
    xc = torch.clamp_min(x, _MIN_NORMAL)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _SQRT_HALF
    e = e - low.to(torch.float32)
    t = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = fma_f32(fma_f32(t, p[0], p[1]), t, p[2])
    y1 = fma_f32(fma_f32(t, p[3], p[4]), t, p[5])
    y2 = fma_f32(fma_f32(t, p[6], p[7]), t, p[8])
    y = fma_f32(fma_f32(y, x3, y1), x3, y2)
    y = fma_f32(y, x3, e * _LOG_Q1)
    out = ((t - 0.5 * x2) + y) + e * _LOG_Q2
    out = torch.where(x == 0.0, -math.inf, out)
    out = torch.where(x == math.inf, math.inf, out)
    return torch.where((x < 0.0) | torch.isnan(x), math.nan, out)


def log2_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` on XLA's CPU: ``log(x) / log(2)``, the division folded
    into a multiplication by ``f32(1 / ln 2)``."""
    return log_f32(x) * _INV_LN2


# XLA's log1p for |x| < sqrt(2) - 1: Cephes' rational approximation, its two
# polynomials evaluated by Horner's rule in ascending order of the lists.
_LOG1P_SMALL = float(np.float32(0.41421356237309504880))
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner_f32(x: torch.Tensor, coeffs) -> torch.Tensor:
    """XLA's ``EvaluatePolynomial``: ``p = x * 0 + c0``, then ``p = p * x +
    c_i`` contracted into FMAs (the first product has another use, so it
    stays a separate multiply)."""
    p = x * 0.0 + float(np.float32(coeffs[0]))
    for c in coeffs[1:]:
        p = fma_f32(p, x, float(np.float32(c)))
    return p


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log1p``: :func:`log_f32` of ``1 + x`` for large
    ``|x|``, else ``x + (x^2 * -0.5 + x^3 * num(x) / den(x))`` with the
    first product fused into the final sum."""
    x = x.to(torch.float32)
    x2 = x * x
    ratio = _horner_f32(x, _LOG1P_NUM) / _horner_f32(x, _LOG1P_DEN)
    small = x + fma_f32(x2, -0.5, (x * x2) * ratio)
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, log_f32(x + 1.0))


# XLA's single-precision erf_inv (Giles' approximation): coefficients for
# w < 5 and for w >= 5, highest degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` as XLA's CPU code computes it in float32: ``w =
    -log1p(-x * x)``, a degree-8 polynomial in ``w - 2.5`` (``w < 5``) or
    ``sqrt(w) - 3`` evaluated with FMAs, times ``x``; ``+-1`` give
    ``+-inf``. Subnormal inputs and results flush to a signed zero, as
    XLA's CPU code runs with denormals off."""
    x = _flush(x.to(torch.float32))
    w = -log1p_f32(x * -x)
    lt = w < 5.0
    # XLA's sqrt is the IEEE one; PyTorch's vectorized float32 sqrt on the
    # CPU is not correctly rounded everywhere, so it is taken in float64 and
    # rounded once (exact for a square root).
    t = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma_f32(t, p, torch.where(lt, float(np.float32(a)), float(np.float32(b))).to(torch.float32))
    return _flush(x * torch.where(torch.abs(x) == 1.0, math.inf, p))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal values to a zero of their sign."""
    return torch.where(torch.abs(x) < _MIN_NORMAL, x * 0.0, x)


# Cephes' ndtri coefficients, as JAX's ``jax.scipy.special.ndtri`` carries
# them (highest degree first).
_NDTRI_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1, -5.66762857469070293439E1,
             1.39312609387279679503E1, -1.23916583867381258016E0)
_NDTRI_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0, 8.63602421390890590575E1,
             -2.25462687854119370527E2, 2.00260212380060660359E2, -8.20372256168333339912E1,
             1.59056225126211695515E1, -1.18331621121330003142E0)
_NDTRI_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1, 5.71628192246421288162E1,
             4.40805073893200834700E1, 1.46849561928858024014E1, 2.18663306850790267539E0,
             -1.40256079171354495875E-1, -3.50424626827848203418E-2, -8.57456785154685413611E-4)
_NDTRI_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1, 4.13172038254672030440E1,
             1.50425385692907503408E1, 2.50464946208309415979E0, -1.42182922854787788574E-1,
             -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_NDTRI_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0, 3.93881025292474443415E0,
             1.33303460815807542389E0, 2.01485389549179081538E-1, 1.23716634817820021358E-2,
             3.01581553508235416007E-4, 2.65806974686737550832E-6, 6.23974539184983293730E-9)
_NDTRI_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0, 1.37702099489081330271E0,
             2.16236993594496635890E-1, 1.34204006088543189037E-2, 3.28014464682127739104E-4,
             2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _polyval_f32(coeffs, x: torch.Tensor) -> torch.Tensor:
    """``jnp.polyval`` (a jitted scan from ``y = 0``): ``y = y * x + c`` for
    each coefficient, highest degree first, each step one fused
    multiply-add."""
    y = torch.zeros_like(x)
    for c in coeffs:
        y = fma_f32(y, x, float(np.float32(c)))
    return y


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """IEEE float32 square root (taken in float64 and rounded once: exact;
    PyTorch's vectorized float32 CPU root is not correctly rounded
    everywhere)."""
    return torch.sqrt(x.double()).float()


def ndtri_f32(p: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.ndtri`` (``norm.ppf``) in float32 as JAX computes
    it on the CPU: Cephes' three rational approximations, each operation
    outside the polynomials its own eagerly dispatched (IEEE) operation,
    ``log`` XLA's (:func:`log_f32`), the polynomials ``jnp.polyval``'s fused
    multiply-adds. JAX's result is not correctly rounded (``ndtri(0.75)``
    is ``0.6744898``, the float32 nearest the true quantile
    ``0.67448974``), which is why it is written out."""
    p = p.to(torch.float32)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    mcp = torch.where(p > f32(-np.expm1(-2.0)), 1.0 - p, p)
    mcp = torch.where(mcp == 0.0, torch.full_like(mcp, 0.5), mcp)
    w = mcp - 0.5
    ww = w * w
    big = w + (w * ww) * (_polyval_f32(_NDTRI_P0, ww) / _polyval_f32(_NDTRI_Q0, ww))
    big = big * -f32(np.sqrt(2.0 * np.pi))
    z = sqrt_f32(-2.0 * log_f32(mcp))
    first = z - log_f32(z) / z
    rz = 1.0 / z
    small = first - _polyval_f32(_NDTRI_P2, rz) / _polyval_f32(_NDTRI_Q2, rz) / z
    other = first - _polyval_f32(_NDTRI_P1, rz) / _polyval_f32(_NDTRI_Q1, rz) / z
    x = torch.where(mcp > f32(np.exp(-2.0)), big, torch.where(z >= 8.0, small, other))
    x = torch.where(p > f32(1.0 - np.exp(-2.0)), x, -x)
    x = torch.where(p == 0.0, -math.inf, x)
    return torch.where(p == 1.0, math.inf, x)


def small_matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for an inner dimension of 2 as XLA's CPU code computes an
    eagerly dispatched small product: ``fma(a_1, b_1, a_0 * b_0)`` (held
    against ``jnp`` on 3,000 random 2 x 2 products). Another inner
    dimension falls back to ``torch.matmul``, within ``CHOLESKY_RTOL``."""
    if a.shape[-1] != 2:
        return a @ b
    return fma_f32(a[..., :, 1:2], b[..., 1:2, :], a[..., :, 0:1] * b[..., 0:1, :])


# How far a Cholesky factor (or small product) of a dimension other than 2
# may lie from the JAX package's, relative to the factor's largest entry.
CHOLESKY_RTOL = 1e-5


def cholesky_f32(a: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.cholesky`` of a symmetric positive definite matrix. At
    2 x 2 (the only size the registry and the LAL generator use) it is XLA's
    CPU spelling, bit for bit: ``l00 = sqrt(a00)``, ``l10 = a10 *
    f32(1 / l00)``, ``l11 = sqrt(a11 - l10 * l10)`` with no fused
    multiply-add, zeros above the diagonal. Larger matrices take
    ``torch.linalg.cholesky``, which agrees to ``CHOLESKY_RTOL``."""
    if a.shape[-1] != 2:
        return torch.linalg.cholesky(a)
    l00 = sqrt_f32(a[..., 0, 0])
    l10 = a[..., 1, 0] * (1.0 / l00)
    l11 = sqrt_f32(a[..., 1, 1] - l10 * l10)
    zero = torch.zeros_like(l00)
    return torch.stack([torch.stack([l00, zero], -1), torch.stack([l10, l11], -1)], -2)
