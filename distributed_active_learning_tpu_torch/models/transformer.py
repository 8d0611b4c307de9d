"""Transformer text encoder for the AG-News-style deep-AL config (the port of
``models/transformer.py``).

``TransformerClassifier`` maps token ids ``[B, T]`` to class logits: token
and position ``Embed`` tables, a dropout, ``n_layers`` pre-norm encoder
blocks (attention through ``attention_fn``, by default
:func:`~..ops.ring_attention.full_attention`, then a
gelu MLP, each with dropout and a residual), a final LayerNorm, a mean over
the sequence and the head. It follows flax's modules to the letter:

- ``nn.gelu`` is the tanh approximation;
- ``LayerNorm`` has eps 1e-6 and the fast variance ``E[x^2] - E[x]^2``
  (clipped at 0), written out;
- the QKV projection is one bias-free Dense of width ``3 d``, split q, k, v;
- parameter names and init keys are flax's paths
  (``EncoderBlock_0.MultiHeadAttention_0.Dense_0``, ...).

The embedding gradient is a one-hot product (:class:`_Lookup`): PyTorch's
embedding backward scatters with atomics (or sorts and reads a count back to
the host), and the neural gates need the same bits every run inside a CUDA
graph.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from distributed_active_learning_tpu_torch.models.neural import (
    FlaxModule,
    _Ctx,
    _dense_plan,
    dropout,
)
from distributed_active_learning_tpu_torch.ops.ring_attention import full_attention

_LN_EPS = 1e-6


class _Lookup(torch.autograd.Function):
    """``table[ids]`` whose gradient is ``one_hot(ids)^T @ grad``: a GEMM,
    the same sum every run, with nothing read back."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n = table.shape[0]
        return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        vocab = torch.arange(ctx.n, device=ids.device)
        onehot = (ids.reshape(-1, 1) == vocab).to(grad.dtype)
        return onehot.T @ grad.reshape(-1, grad.shape[-1]), None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm()``: fast variance, eps 1e-6, then ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias``."""
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
    return (x - mean) * (torch.rsqrt(var + _LN_EPS) * scale) + bias


def _ln_plan(prefix: Tuple, name: str, d: int):
    base = ".".join(prefix + (name,))
    return [(f"{base}.scale", prefix + (name, 1), (d,), "ones"),
            (f"{base}.bias", prefix + (name, 2), (d,), "zeros")]


class TransformerClassifier(FlaxModule):
    """Token-id input ``[B, T]`` (any integer or float dtype) -> class
    logits ``[B, C]``."""

    _fields = ("vocab_size", "max_len", "d_model", "n_heads", "n_layers", "d_ff", "n_classes",
               "dropout_rate", "attention_fn")

    def __init__(self, vocab_size: int = 30522, max_len: int = 128, d_model: int = 128,
                 n_heads: int = 4, n_layers: int = 2, d_ff: int = 256, n_classes: int = 4,
                 dropout_rate: float = 0.1, attention_fn: Callable = full_attention):
        super().__init__()
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.d_ff = d_ff
        self.n_classes = n_classes
        self.dropout_rate = dropout_rate
        self.attention_fn = attention_fn

    def _init_plan(self, input_shape):
        d = self.d_model
        plan = [("Embed_0.embedding", ("Embed_0", 1), (self.vocab_size, d), "embed"),
                ("Embed_1.embedding", ("Embed_1", 1), (self.max_len, d), "embed")]
        for i in range(self.n_layers):
            blk = (f"EncoderBlock_{i}",)
            mha = blk + ("MultiHeadAttention_0",)
            plan += _ln_plan(blk, "LayerNorm_0", d)
            plan += _dense_plan(mha, "Dense_0", d, 3 * d, bias=False)
            plan += _dense_plan(mha, "Dense_1", d, d)
            plan += _ln_plan(blk, "LayerNorm_1", d)
            plan += _dense_plan(blk, "Dense_0", d, self.d_ff)
            plan += _dense_plan(blk, "Dense_1", self.d_ff, d)
        plan += _ln_plan((), "LayerNorm_0", d)
        plan += _dense_plan((), "Dense_0", d, self.n_classes)
        return plan

    def dropout_paths(self):
        paths = [("Dropout_0",)]
        for i in range(self.n_layers):
            paths += [(f"EncoderBlock_{i}", "Dropout_0"), (f"EncoderBlock_{i}", "Dropout_1")]
        return tuple(paths)

    def _attention(self, p, prefix: str, x):
        B, T, _ = x.shape
        H, d = self.n_heads, self.d_model
        qkv = F.linear(x, p[f"{prefix}.Dense_0.weight"])
        q, k, v = (t.reshape(B, T, H, d // H) for t in torch.split(qkv, d, dim=-1))
        out = self.attention_fn(q, k, v)
        return F.linear(out.reshape(B, T, d), p[f"{prefix}.Dense_1.weight"], p[f"{prefix}.Dense_1.bias"])

    def apply(self, params, ids, ctx: _Ctx, return_features: bool = False):
        ids = ids.to(torch.int32)
        B, T = ids.shape
        if T > self.max_len:
            raise ValueError(f"sequence length {T} exceeds max_len={self.max_len}")
        p = params
        x = _Lookup.apply(p["Embed_0.embedding"], ids) + p["Embed_1.embedding"][:T][None]
        mshape = (ctx.mask_rows, T, self.d_model)
        x = dropout(x, self.dropout_rate, ctx.rng, ("Dropout_0",), mshape, B)
        for i in range(self.n_layers):
            b = f"EncoderBlock_{i}"
            h = layer_norm(x, p[f"{b}.LayerNorm_0.scale"], p[f"{b}.LayerNorm_0.bias"])
            h = self._attention(p, f"{b}.MultiHeadAttention_0", h)
            x = x + dropout(h, self.dropout_rate, ctx.rng, (b, "Dropout_0"), mshape, B)
            h = layer_norm(x, p[f"{b}.LayerNorm_1.scale"], p[f"{b}.LayerNorm_1.bias"])
            h = F.gelu(F.linear(h, p[f"{b}.Dense_0.weight"], p[f"{b}.Dense_0.bias"]), approximate="tanh")
            h = F.linear(h, p[f"{b}.Dense_1.weight"], p[f"{b}.Dense_1.bias"])
            x = x + dropout(h, self.dropout_rate, ctx.rng, (b, "Dropout_1"), mshape, B)
        x = layer_norm(x, p["LayerNorm_0.scale"], p["LayerNorm_0.bias"])
        pooled = x.mean(1)
        if return_features:
            return pooled
        return F.linear(pooled, p["Dense_0.weight"], p["Dense_0.bias"])
