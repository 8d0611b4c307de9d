"""Exact attention, single-device and with the sequence over a ring (the
port of ``ops/ring_attention.py``).

:func:`full_attention` is the single-device form: two einsums and a softmax
on the ``[B, T, H, D]`` layout. :func:`ring_attention` splits the sequence
axis over a mesh's ring of devices: each shard attends its query block to a
K/V block that travels one step right a step, folding each block into an
online-softmax accumulator (:func:`_online_softmax_step`), so every shard
holds ``T / n`` rows of activations and the answer is exact. The arithmetic
is the JAX package's, in its order: the running max ``m`` starts at
``-inf`` (``exp(m - m_new)`` is 0 on the first block), a causal mask writes
the finite ``-1e30`` by global position (a wholly masked block then adds
``exp(0)`` terms that the next real block's rescale wipes, never a NaN), the
block a shard holds at step ``i`` came from shard ``(my - i) mod n``, and
the result is ``o / max(l, 1e-30)``.

The JAX package moves K/V with ``lax.ppermute``, not a Pallas kernel, so
the hop here is a plain copy to the right neighbour's device (on one card,
no copy at all): one process drives every shard, in ring order.
"""

from __future__ import annotations

from typing import Optional

import torch

#: The JAX package's name for the sequence axis; the port's mesh has
#: ``data`` and ``model`` axes and the sequence ring is ``Mesh.ring``.
SEQ_AXIS = "sp"


def _online_softmax_step(o, l, m, scores, v_cur):
    """Fold one block's ``scores [B, H, Tq, Tk]`` and values ``v_cur [B, Tk,
    H, D]`` into the running ``(o [B, H, Tq, D], l [B, H, Tq], m [B, H,
    Tq])``: the old accumulator rescaled by ``exp(m - m_new)``, the block's
    ``exp(scores - m_new)`` added."""
    m_blk = torch.amax(scores, dim=-1)
    m_new = torch.maximum(m, m_blk)
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_cur)
    l = l * alpha + torch.sum(p, dim=-1)
    return o, l, m_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = SEQ_AXIS, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of ``[B, T, H, D]`` tensors with ``T`` split into
    ``n = len(mesh.ring)`` contiguous blocks, block ``s`` on ``mesh.ring[s]``;
    returns ``[B, T, H, D]`` on ``q``'s device. ``axis_name`` is accepted for
    the JAX package's signature only: the ring is ``mesh.ring``."""
    del axis_name
    ring = mesh.ring
    n = len(ring)
    B, T, H, D = q.shape
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by the ring's {n} shards")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    tb = T // n

    def blocks(t):
        return [t[:, s * tb:(s + 1) * tb].to(ring[s]) for s in range(n)]

    qs, k_cur, v_cur = blocks(q), blocks(k), blocks(v)
    outs = []
    accs = []
    for s in range(n):
        zero = torch.zeros((B, H, tb), dtype=q.dtype, device=ring[s])
        accs.append((torch.zeros((B, H, tb, D), dtype=q.dtype, device=ring[s]), zero,
                     zero - torch.inf))
    for i in range(n):
        for my in range(n):
            o, l, m = accs[my]
            scores = torch.einsum("bqhd,bkhd->bhqk", qs[my], k_cur[my]) * scale
            if causal:
                src = (my - i) % n
                dev = ring[my]
                q_pos = my * tb + torch.arange(tb, device=dev)
                k_pos = src * tb + torch.arange(tb, device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]
                scores = torch.where(mask[None, None], scores,
                                     torch.full((), -1e30, dtype=scores.dtype, device=dev))
            accs[my] = _online_softmax_step(o, l, m, scores, v_cur[my])
        if i == n - 1:
            break  # the JAX loop's last hop brings back blocks no step reads
        # Circulate K/V one step right: shard s + 1 receives shard s's block.
        k_cur = [k_cur[(s - 1) % n].to(ring[s]) for s in range(n)]
        v_cur = [v_cur[(s - 1) % n].to(ring[s]) for s in range(n)]
    for o, l, _ in accs:
        out = o / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 2, 1, 3).to(q.device))
    return torch.cat(outs, dim=1)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` over ``[B, T, H, D]`` tensors (a causal
    mask writes -1e30 above the diagonal): the single-device form and the
    oracle of :func:`ring_attention`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        T = q.shape[1]
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
        scores = torch.where(mask[None, None], scores, torch.full((), -1e30, device=q.device))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
