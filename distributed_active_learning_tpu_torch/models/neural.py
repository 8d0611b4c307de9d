"""Neural base learners for deep active learning (the port of
``models/neural.py``).

``SmallCNN`` and ``MLP`` are ``torch.nn`` modules with the flax modules'
architecture and arithmetic, applied to a parameter dict whose names are
flax's paths (``Conv_0.weight``, ``Dense_1.bias``, ...);
:class:`NeuralLearner` trains them on the masked labeled subset and
predicts over the pool, as the JAX learner does:

- **Init** is flax 0.12.3's, bit for bit: each parameter's key is
  ``fold_in(key, uint32(sha1(path + counter)[:4]))`` (flax's ``LazyRng``),
  Dense and Conv kernels are ``lecun_normal`` (a truncated normal on (-2, 2)
  as ``jax.random.truncated_normal`` draws it, times ``sqrt(1/fan_in) /
  .87962566103423978``), biases zero, ``Embed`` tables ``normal *
  sqrt(1/fan_in)``. Layouts are PyTorch's (Linear ``[out, in]``, Conv
  ``OIHW``); ``interop.neural_params_from_numpy`` maps flax's trees.
- **Dropout** is flax's: each ``Dropout`` folds its own path into the
  ``dropout`` key and keeps ``uniform < 1 - rate``; kept values are divided by
  the keep rate (XLA's multiplication by the float32 reciprocal).
- **Training** draws each step's minibatch as ``categorical(k_idx, where(mask,
  0, -inf))`` broadcast to ``[batch, n]`` (static shapes for any labeled
  count) and runs ``optax.adam`` written out (b1 0.9, b2 0.999, eps 1e-8,
  bias correction by the int32 step count; multi-tensor ops, the bias
  corrections applied as reciprocals) on the mean integer-label cross
  entropy. The parameters match JAX's only to :data:`NEURAL_TRAIN_RTOL`: XLA
  orders its products and contracts its multiply-adds differently.
- **Predictions** run the pool through the network in ``predict_chunk``-row
  chunks. In an MC-dropout pass every chunk uses the sample's one key, so
  every chunk sees the same masks (JAX's ``lax.map`` over chunks); the masks
  are drawn once a sample and reused.

Convolutions keep flax's NHWC activations (the conv runs on the
channels-last NCHW view) and flatten ``(H, W, C)`` before the dense layer;
flax's ``SAME`` padding at stride 2 is asymmetric (0 before, 1 after) and is
padded explicitly. On the card every random draw goes through K7
(``ops/threefry.py``) and nothing reads back to the host, so a whole round
can be captured into a CUDA graph.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.ops import threefry
from distributed_active_learning_tpu_torch.ops.xla_f32 import div_const, erfinv_f32

#: Relative tolerance of trained parameters and probabilities against the
#: JAX learner's: the same draws and the same steps, but XLA sums products in
#: another order and fuses multiply-adds, and adam amplifies the last bits.
NEURAL_TRAIN_RTOL = 1e-3

# jax 0.9.0's truncated_normal(-2, 2) range: erf(-2/sqrt 2) and erf(2/sqrt 2)
# as XLA computes them in float32 (probed; the bits of -0.9544997 and
# 0.9544997).
_TRUNC_A = float(np.uint32(3212073496).view(np.float32))
_TRUNC_B = float(np.uint32(1064589848).view(np.float32))
_TRUNC_STD = np.float32(0.87962566103423978)
_SQRT2_F32 = float(np.float32(np.sqrt(2)))
_TRUNC_LO = float(np.nextafter(np.float32(-2.0), np.float32(np.inf)))
_TRUNC_HI = float(np.nextafter(np.float32(2.0), np.float32(-np.inf)))


# ---------------------------------------------------------------------------
# flax's parameter keys and initializers
# ---------------------------------------------------------------------------


def path_hash(path: Tuple) -> int:
    """flax's ``_fold_in_static`` hash of a scope path (names and counters):
    the first 4 bytes of the SHA-1 of the parts, big-endian."""
    h = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            h.update(x.encode("utf-8"))
        else:
            h.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(h.digest()[:4], byteorder="big")


def fold_path(key: prng.Key, path: Tuple) -> prng.Key:
    """The key flax's ``make_rng`` gives at ``path`` (the scope names then the
    rng counter)."""
    return prng.fold_in(key, path_hash(path))


def _fans(shape, in_axis=-2, out_axis=-1):
    receptive = math.prod(shape) / shape[in_axis] / shape[out_axis]
    return shape[in_axis] * receptive


def lecun_normal(key: prng.Key, shape) -> torch.Tensor:
    """``jax.nn.initializers.lecun_normal()(key, shape)`` in float32, in
    flax's layout."""
    u = prng.uniform(key, shape, minval=_TRUNC_A, maxval=_TRUNC_B)
    out = torch.clamp(erfinv_f32(u) * _SQRT2_F32, _TRUNC_LO, _TRUNC_HI)
    std = np.sqrt(np.float32(1.0 / _fans(shape))) / _TRUNC_STD
    return out * float(np.float32(std))


def embed_normal(key: prng.Key, shape) -> torch.Tensor:
    """flax's ``Embed`` init, ``variance_scaling(1, "fan_in", "normal",
    out_axis=0)``."""
    std = np.sqrt(np.float32(1.0 / _fans(shape, out_axis=0)))
    return prng.normal(key, shape) * float(std)


def flax_repr(obj, fields) -> str:
    """The repr of a flax dataclass module with these attribute values (the
    neural fingerprint hashes it, so it must print as flax prints it)."""
    lines = [f"{type(obj).__name__}(", "    # attributes"]
    for name in fields:
        v = getattr(obj, name)
        lines.append(f"    {name} = {v.__name__ if callable(v) else repr(v)}")
    return "\n".join(lines + [")"])


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------


class DropoutRng:
    """The ``dropout`` rng of one apply: ``keys`` maps each ``Dropout``'s
    path to its key, ``fold_path(apply key, path + (1,))``
    (:func:`batched_dropout_keys`), and the ``Dropout`` at ``path`` keeps
    ``uniform(key, shape) < keep``. Masks are cached by (path, shape), so
    the chunks of one MC sample reuse them."""

    def __init__(self, keys: Dict[Tuple, torch.Tensor]):
        self._keys = keys
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def mask(self, path: Tuple, shape, keep: float) -> torch.Tensor:
        cached = self._masks.get((path, tuple(shape)))
        if cached is None:
            cached = threefry.uniform(self._keys[path], shape) < float(np.float32(keep))
            self._masks[(path, tuple(shape))] = cached
        return cached


def batched_dropout_keys(key_batch: torch.Tensor, paths) -> Dict[Tuple, torch.Tensor]:
    """``fold_path(k, path + (1,))`` for every key of ``key_batch [B, 2]``
    and every dropout path, in one pass a path: ``{path: [B, 2]}``."""
    return {p: prng.fold_in(key_batch, path_hash(p + (1,))) for p in paths}


def dropout(x: torch.Tensor, rate: float, rng: Optional[DropoutRng], path: Tuple,
            mask_shape=None, rows: Optional[int] = None) -> torch.Tensor:
    """flax's ``Dropout(rate)`` at ``path``: identity without an rng (or at
    rate 0), else ``where(uniform < keep, x / keep, 0)``. ``mask_shape`` is
    the shape the mask is drawn at (the activation's, in flax's layout) and
    ``rows`` how many of its leading rows ``x`` takes (a short last chunk)."""
    if rng is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = tuple(x.shape) if mask_shape is None else tuple(mask_shape)
    mask = rng.mask(path, shape, keep)
    if rows is not None and rows != shape[0]:
        mask = mask[:rows]
    return torch.where(mask, div_const(x, np.float32(keep)), torch.zeros((), dtype=x.dtype, device=x.device))


class _Ctx(NamedTuple):
    """What a forward pass needs besides its input: the dropout rng (None:
    deterministic) and the row count its masks are drawn at."""

    rng: Optional[DropoutRng]
    mask_rows: int


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class FlaxModule(nn.Module):
    """A module whose parameters flax would name and initialize: subclasses
    list ``_init_plan`` (each parameter's state-dict name, flax path, shape
    in flax's layout and initializer) and ``_dropout_paths``."""

    _fields: Tuple[str, ...] = ()

    def __repr__(self) -> str:
        return flax_repr(self, self._fields)

    def _init_plan(self, input_shape):  # pragma: no cover - abstract
        raise NotImplementedError

    def dropout_paths(self) -> Tuple[Tuple, ...]:
        return ()

    #: An input shape for :meth:`param_names` (names never depend on it).
    _any_input: Tuple[int, ...] = (1,)

    def param_names(self):
        """The state-dict names of the parameters."""
        return [name for name, *_ in self._init_plan(self._any_input)]

    def init_params(self, key: prng.Key, input_shape) -> Dict[str, torch.Tensor]:
        """flax's ``module.init({"params": key}, zeros((1, *input_shape)))``,
        as a state dict in the port's layouts (on the key's device)."""
        params = {}
        for name, path, shape, kind in self._init_plan(tuple(input_shape)):
            if kind == "zeros":
                v = torch.zeros(shape)
            elif kind == "ones":
                v = torch.ones(shape)
            elif kind == "lecun":
                v = to_port_layout(name, lecun_normal(fold_path(key, path), shape))
            elif kind == "embed":
                v = embed_normal(fold_path(key, path), shape)
            else:
                raise ValueError(kind)
            params[name] = v.to(torch.float32).contiguous()
        return params


def to_port_layout(name: str, w):
    """A flax kernel in the port's layout: Dense ``[in, out] -> [out, in]``,
    Conv ``HWIO -> OIHW``; other leaves unchanged. Works on tensors and numpy
    arrays."""
    if not name.endswith(".weight") or w.ndim not in (2, 4):
        return w
    if w.ndim == 2:
        return w.T
    return w.transpose(3, 2, 0, 1) if isinstance(w, np.ndarray) else w.permute(3, 2, 0, 1)


def to_flax_layout(name: str, w):
    """The inverse of :func:`to_port_layout`."""
    if not name.endswith(".weight") or w.ndim not in (2, 4):
        return w
    if w.ndim == 2:
        return w.T
    return w.transpose(2, 3, 1, 0) if isinstance(w, np.ndarray) else w.permute(2, 3, 1, 0)


def _dense_plan(prefix: Tuple, name: str, n_in: int, n_out: int, bias: bool = True):
    plan = [(f"{'.'.join(prefix + (name,))}.weight", prefix + (name, 1), (n_in, n_out), "lecun")]
    if bias:
        plan.append((f"{'.'.join(prefix + (name,))}.bias", prefix + (name, 2), (n_out,), "zeros"))
    return plan


def _conv_same(x: torch.Tensor, weight, bias, stride: int) -> torch.Tensor:
    """flax ``Conv(feats, (3, 3), strides)`` with ``SAME`` padding on an NHWC
    activation: XLA pads ``(k - 1) // 2``-ish asymmetrically at stride 2
    (total ``max((out - 1) * s + k - in, 0)``, the smaller half before)."""
    h, w = x.shape[1], x.shape[2]
    pads = []
    for size in (w, h):
        out = -(-size // stride)
        total = max((out - 1) * stride + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, (0, 0, *pads))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride)
    return y.permute(0, 2, 3, 1)


class SmallCNN(FlaxModule):
    """Compact conv net for CIFAR-shaped NHWC inputs (BASELINE.json config
    4): two blocks of conv 3x3 + relu, strided conv 3x3 + relu, dropout;
    then Dense(128) + relu + dropout and the head."""

    _fields = ("n_classes", "dropout_rate")
    _any_input = (4, 4, 1)

    def __init__(self, n_classes: int = 10, dropout_rate: float = 0.25):
        super().__init__()
        self.n_classes = n_classes
        self.dropout_rate = dropout_rate

    def _init_plan(self, input_shape):
        h, w, c = input_shape
        plan = []
        for i, feats in enumerate((32, 64)):
            for j, stride in enumerate((1, 2)):
                name = f"Conv_{2 * i + j}"
                plan.append((f"{name}.weight", (name, 1), (3, 3, c, feats), "lecun"))
                plan.append((f"{name}.bias", (name, 2), (feats,), "zeros"))
                c = feats
                if stride == 2:
                    h, w = -(-h // 2), -(-w // 2)
        plan += _dense_plan((), "Dense_0", h * w * c, 128)
        plan += _dense_plan((), "Dense_1", 128, self.n_classes)
        return plan

    def dropout_paths(self):
        return (("Dropout_0",), ("Dropout_1",), ("Dropout_2",))

    def apply(self, params, x, ctx: _Ctx, return_features: bool = False):
        rows = x.shape[0]
        for i in range(2):
            for j, stride in enumerate((1, 2)):
                name = f"Conv_{2 * i + j}"
                x = F.relu(_conv_same(x, params[f"{name}.weight"], params[f"{name}.bias"], stride))
            x = dropout(x, self.dropout_rate, ctx.rng, (f"Dropout_{i}",),
                        (ctx.mask_rows,) + tuple(x.shape[1:]), rows)
        x = x.reshape(rows, -1)
        x = F.relu(F.linear(x, params["Dense_0.weight"], params["Dense_0.bias"]))
        x = dropout(x, self.dropout_rate, ctx.rng, ("Dropout_2",), (ctx.mask_rows, x.shape[1]), rows)
        if return_features:
            return x
        return F.linear(x, params["Dense_1.weight"], params["Dense_1.bias"])


class MLP(FlaxModule):
    """Small MLP for tabular pools: Dense + relu + dropout per hidden width,
    then the head."""

    _fields = ("n_classes", "hidden", "dropout_rate")

    def __init__(self, n_classes: int = 2, hidden: Tuple[int, ...] = (128, 64), dropout_rate: float = 0.2):
        super().__init__()
        self.n_classes = n_classes
        self.hidden = tuple(hidden)
        self.dropout_rate = dropout_rate

    def _init_plan(self, input_shape):
        d = int(np.prod(input_shape))
        plan = []
        for i, h in enumerate(self.hidden):
            plan += _dense_plan((), f"Dense_{i}", d, h)
            d = h
        plan += _dense_plan((), f"Dense_{len(self.hidden)}", d, self.n_classes)
        return plan

    def dropout_paths(self):
        return tuple((f"Dropout_{i}",) for i in range(len(self.hidden)))

    def apply(self, params, x, ctx: _Ctx, return_features: bool = False):
        rows = x.shape[0]
        for i in range(len(self.hidden)):
            x = F.relu(F.linear(x, params[f"Dense_{i}.weight"], params[f"Dense_{i}.bias"]))
            x = dropout(x, self.dropout_rate, ctx.rng, (f"Dropout_{i}",), (ctx.mask_rows, x.shape[1]), rows)
        if return_features:
            return x
        i = len(self.hidden)
        return F.linear(x, params[f"Dense_{i}.weight"], params[f"Dense_{i}.bias"])


# ---------------------------------------------------------------------------
# The learner
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    """``optax.adam``'s state: the int32 step count and both moments."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: AdamState
    step: torch.Tensor


def clone_state(s: TrainState) -> TrainState:
    return TrainState(
        params={k: v.clone() for k, v in s.params.items()},
        opt_state=AdamState(s.opt_state.count.clone(),
                            {k: v.clone() for k, v in s.opt_state.mu.items()},
                            {k: v.clone() for k, v in s.opt_state.nu.items()}),
        step=s.step.clone())


def select_train_state(active: torch.Tensor, new: TrainState, old: TrainState) -> TrainState:
    """``new`` where the 0-d bool ``active`` else ``old``, leaf by leaf (the
    chunk's masked no-op), on the device."""
    def sel(a, b):
        return torch.where(active, a, b)
    return TrainState(
        params={k: sel(new.params[k], old.params[k]) for k in old.params},
        opt_state=AdamState(sel(new.opt_state.count, old.opt_state.count),
                            {k: sel(new.opt_state.mu[k], old.opt_state.mu[k]) for k in old.params},
                            {k: sel(new.opt_state.nu[k], old.opt_state.nu[k]) for k in old.params}),
        step=sel(new.step, old.step))


_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class NeuralLearner:
    """Trainer and MC predictor around a :class:`FlaxModule`, on ``device``
    (a ``torch.device``; the caller resolves it)."""

    def __init__(self, module: FlaxModule, input_shape, learning_rate: float = 1e-3,
                 batch_size: int = 64, train_steps: int = 200, mc_samples: int = 8,
                 predict_chunk: int = 4096, device="cpu"):
        self.module = module
        self.input_shape = tuple(input_shape)
        self.batch_size = batch_size
        self.train_steps = train_steps
        self.mc_samples = mc_samples
        self.predict_chunk = predict_chunk
        self.learning_rate = learning_rate
        self.device = torch.device(device)
        # Per-phase device split of the last fit, when a caller asks for it
        # (chip_smoke.py's draw / forward+backward / adam timing).
        self.phase_events = None

    # -- state ---------------------------------------------------------------

    def init(self, key: prng.Key) -> TrainState:
        params = {k: v.to(self.device) for k, v in self.module.init_params(key, self.input_shape).items()}
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        return TrainState(
            params=params,
            opt_state=AdamState(torch.zeros((), dtype=torch.int32, device=self.device),
                                zeros, {k: v.clone() for k, v in zeros.items()}),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    # -- forward -------------------------------------------------------------

    def _forward(self, params, x, rng: Optional[DropoutRng], mask_rows: int,
                 return_features: bool = False):
        return self.module.apply(params, x, _Ctx(rng, mask_rows), return_features=return_features)

    def _chunked(self, fn: Callable, x: torch.Tensor) -> torch.Tensor:
        """``fn(x_chunk, mask_rows)`` over ``predict_chunk``-row chunks: one
        call when the pool fits a chunk (masks at the pool's row count),
        else every chunk's masks at ``predict_chunk`` rows (JAX pads the tail
        chunk; its real rows see the same masks)."""
        n, chunk = x.shape[0], self.predict_chunk
        if n <= chunk:
            return fn(x, n)
        return torch.cat([fn(x[lo:lo + chunk], chunk) for lo in range(0, n, chunk)])

    @torch.no_grad()
    def predict_proba(self, state: TrainState, x: torch.Tensor) -> torch.Tensor:
        """Deterministic class probabilities ``[n, C]`` (dropout off)."""
        return self._chunked(
            lambda xc, r: torch.softmax(self._forward(state.params, xc, None, r), -1), x)

    @torch.no_grad()
    def embed(self, state: TrainState, x: torch.Tensor) -> torch.Tensor:
        """Penultimate representation ``[n, D]`` (dropout off)."""
        return self._chunked(
            lambda xc, r: self._forward(state.params, xc, None, r, return_features=True), x)

    @torch.no_grad()
    def predict_proba_samples(self, state: TrainState, x: torch.Tensor, key: prng.Key) -> torch.Tensor:
        """MC-dropout predictive samples ``[S, n, C]``: sample ``s`` runs with
        dropout key ``split(key, S)[s]``."""
        keys = prng.split(key.to(self.device), self.mc_samples)
        paths = self.module.dropout_paths()
        path_keys = batched_dropout_keys(keys, paths)
        out = []
        for s in range(self.mc_samples):
            rng = DropoutRng({p: k[s] for p, k in path_keys.items()})
            out.append(self._chunked(
                lambda xc, r: torch.softmax(self._forward(state.params, xc, rng, r), -1), x))
        return torch.stack(out)

    def accuracy_tensor(self, state: TrainState, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Test accuracy as a 0-d float32 tensor on the device (no sync)."""
        probs = self.predict_proba(state, x)
        hits = (torch.argmax(probs, -1) == y).to(torch.float32)
        return div_const(hits.sum(), hits.shape[0])

    def accuracy(self, state: TrainState, x: torch.Tensor, y: torch.Tensor) -> float:
        return float(self.accuracy_tensor(state, x, y))

    # -- training ------------------------------------------------------------

    def step_keys(self, key: prng.Key):
        """The per-step keys of :meth:`fit_on_mask`: ``(k_idx [T, 2],
        {dropout path: [T, 2]})``, from ``split(key, T)`` and each step's
        ``split(k, 2)``, all in a few batched passes."""
        keys = prng.split(key.to(self.device), self.train_steps)
        kk = prng.split(keys, 2)
        return kk[:, 0], batched_dropout_keys(kk[:, 1], self.module.dropout_paths())

    def fit_on_mask(self, state: TrainState, x: torch.Tensor, y: torch.Tensor,
                    labeled_mask: torch.Tensor, key: prng.Key) -> TrainState:
        """``train_steps`` minibatch adam steps on the labeled rows; each
        batch is ``batch_size`` indices drawn with replacement from the
        masked categorical."""
        logits_mask = torch.where(labeled_mask, torch.zeros((), device=x.device),
                                  torch.full((), -math.inf, device=x.device))
        k_idx, drop_keys = self.step_keys(key)
        params = {k: v.detach().clone() for k, v in state.params.items()}
        mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
        nu = {k: v.clone() for k, v in state.opt_state.nu.items()}
        count = state.opt_state.count.clone()
        names = sorted(params)
        ev = self.phase_events
        for t in range(self.train_steps):
            if ev is not None:
                ev[t][0].record()
            idx = threefry.categorical(k_idx[t], logits_mask, self.batch_size).long()
            xb, yb = x[idx], y[idx].long()
            if ev is not None:
                ev[t][1].record()
            rng = DropoutRng({p: k[t] for p, k in drop_keys.items()})
            leaves = [params[k].requires_grad_(True) for k in names]
            with torch.enable_grad():
                logits = self._forward(params, xb, rng, self.batch_size)
                loss = F.cross_entropy(logits, yb)
                grads = torch.autograd.grad(loss, leaves)
            if ev is not None:
                ev[t][2].record()
            with torch.no_grad():
                count = count + 1
                c = count.to(torch.float32)
                # The bias corrections as reciprocals, so that every update is
                # a multi-tensor op (a dozen launches a step, not a dozen a
                # parameter): a multiply where optax divides, within
                # NEURAL_TRAIN_RTOL.
                inv1 = 1.0 / (1.0 - torch.pow(torch.full((), _B1, device=c.device), c))
                inv2 = 1.0 / (1.0 - torch.pow(torch.full((), _B2, device=c.device), c))
                g = list(grads)
                m = torch._foreach_add(torch._foreach_mul(g, 1.0 - _B1),
                                       torch._foreach_mul([mu[k] for k in names], _B1))
                v = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - _B2),
                                       torch._foreach_mul([nu[k] for k in names], _B2))
                den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_mul(v, inv2)), _EPS)
                upd = torch._foreach_div(torch._foreach_mul(m, inv1), den)
                new = torch._foreach_add([params[k].detach() for k in names],
                                         torch._foreach_mul(upd, -self.learning_rate))
                mu, nu, params = (dict(zip(names, t)) for t in (m, v, new))
            if ev is not None:
                ev[t][3].record()
        return TrainState(params=params, opt_state=AdamState(count, mu, nu),
                          step=state.step + self.train_steps)
