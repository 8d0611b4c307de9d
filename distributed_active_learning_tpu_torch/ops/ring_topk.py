"""Ring-merged exact global top-k over per-shard candidate windows (the port
of ``ops/ring_topk.py``).

Each data shard keeps a k-row candidate window ``(values, global indices)``
of its own pool block; ``S - 1`` ring hops circulate the windows, and each
shard merges every window that arrives. Any global winner is among its own
shard's k best, and the merge order ``(value desc, index asc)`` is
``lax.top_k``'s full-vector order because shard blocks are contiguous index
ranges, so the merged window is the global stable top-k, on every shard.
Padding rows (``k > n_local``) carry ``(-inf, IDX_SENTINEL)`` and lose every
tie.

The copy (K4) is ``csrc/ring_hop.cu``, which replaces the Pallas
``_hop_kernel`` (a barrier-semaphore handshake with both neighbours, then a
remote DMA of the window to the right neighbour). Here one process drives
every shard, so the handshake becomes stream order, and one launch per
(sending device, ring step) copies every window that device's shards send
(:func:`ring_step`): a mesh on one card runs ``S - 1`` launches per merge,
not ``S (S - 1)``. :func:`ring_topk` allocates one ``[S, k]`` receive pair
per device and ping-pongs between two across steps; it records and waits on
events only between distinct cards (the sender's stream waits until the
receiver's has enqueued every earlier merge, the receiver's waits for the
copy), and on one card stream order is the whole handshake. A window on
another card is stored through a peer pointer under UVA. CPU windows take
the plain version, tensor copies (:func:`ring_step_plain`).
``remap_indices`` waits for serving's rebalance.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from distributed_active_learning_tpu_torch import kernels
from distributed_active_learning_tpu_torch.ops.topk import NEG_INF

#: Window-padding index: larger than any real pool index, so a padding row
#: (value -inf) loses the index tie-break against every real -inf row.
IDX_SENTINEL = int(np.iinfo(np.int32).max)

# Launches of csrc/ring_hop.cu, counted where the kernel is launched.
launches = 0
# Windows one launch takes (the kernel's parameter table).
MAX_WINDOWS = 16

Window = Tuple[torch.Tensor, torch.Tensor]


def pad_window(vals: torch.Tensor, idx: torch.Tensor, k: int) -> Window:
    """Pad a local candidate window to exactly ``k`` rows with
    ``(-inf, IDX_SENTINEL)`` (or cut it to ``k``): the ring's message size
    is static."""
    pad = k - vals.shape[0]
    if pad <= 0:
        return vals[:k], idx[:k]
    return (
        torch.cat([vals, vals.new_full((pad,), NEG_INF)]),
        torch.cat([idx, idx.new_full((pad,), IDX_SENTINEL)]),
    )


def merge_windows(a_vals, a_idx, b_vals, b_idx, k: int) -> Window:
    """Exact 2-window merge: the top ``k`` of the union under (value desc,
    index asc). A stable sort by index, then a stable sort by negated value,
    is the two-key sort ``lax.sort((-v, i), num_keys=2)``."""
    v = torch.cat([a_vals, b_vals])
    i = torch.cat([a_idx, b_idx])
    order = torch.sort(i, stable=True).indices
    v, i = v[order], i[order]
    order = torch.sort(-v, stable=True).indices
    return v[order][:k], i[order][:k]


def hop_plain(vals: torch.Tensor, idx: torch.Tensor, dst: torch.device) -> Window:
    """The plain version of a hop: a tensor copy to ``dst`` (a fresh copy
    on the same device too, as the kernel writes fresh buffers)."""
    return vals.to(dst, copy=True), idx.to(dst, copy=True)


def ring_step_plain(src: Sequence[Window], dst: Sequence[Window]) -> None:
    """The plain version of a ring step: each source window copied into its
    destination buffers (across devices where they differ)."""
    for (sv, si), (dv, di) in zip(src, dst):
        dv.copy_(sv)
        di.copy_(si)


def _launch_ring_step(src: Sequence[Window], dst: Sequence[Window]) -> None:
    """Launch csrc/ring_hop.cu on the sending device's current stream: every
    window of ``src`` (all on one CUDA device) into its ``dst`` buffers (on
    that card or a peer), ``MAX_WINDOWS`` to a launch. It orders no stream:
    :func:`ring_step` does, where devices differ."""
    global launches
    dev = src[0][0].device
    k = src[0][0].shape[0]
    for v, i in (*src, *dst):
        if (v.dtype != torch.float32 or i.dtype != torch.int32 or v.shape != (k,)
                or i.shape != (k,) or not (v.is_contiguous() and i.is_contiguous())
                or v.device.type != "cuda" or i.device != v.device):
            raise ValueError("a ring step copies contiguous CUDA windows of [k] float32 values "
                             "and [k] int32 indices")
    if any(v.device != dev for v, _ in src) or len(src) != len(dst):
        raise ValueError("a ring step launches for the windows one device sends")
    lib = kernels.load("ring_hop")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo in range(0, len(src), MAX_WINDOWS):
        s_, d_ = src[lo:lo + MAX_WINDOWS], dst[lo:lo + MAX_WINDOWS]
        m = len(s_)
        ptrs = (ctypes.c_void_p * (4 * m))(
            *[v.data_ptr() for v, _ in s_], *[i.data_ptr() for _, i in s_],
            *[v.data_ptr() for v, _ in d_], *[i.data_ptr() for _, i in d_])
        with torch.cuda.device(dev):
            err = lib.ring_step(ptrs, m, k, stream)
        kernels.check("ring_step", err)
        launches += 1


def ring_step(src: Sequence[Window], dst: Sequence[Window]) -> None:
    """Copy the windows one device sends into their receiving buffers. On
    CUDA: one kernel launch on the sender's stream, after the stream of
    every receiving card other than the sender's has enqueued its earlier
    work (merges that read the buffers), and before those streams go on. On
    the CPU: the plain copies."""
    if len(src) != len(dst) or not src:
        raise ValueError("a ring step needs one destination per source window")
    dev = src[0][0].device
    if dev.type == "cpu":
        ring_step_plain(src, dst)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    others = sorted({v.device for v, _ in dst} - {dev}, key=str)
    sender = torch.cuda.current_stream(dev)
    for d in others:
        free = torch.cuda.Event()
        free.record(torch.cuda.current_stream(d))
        sender.wait_event(free)
    _launch_ring_step(src, dst)
    if others:
        done = torch.cuda.Event()
        done.record(sender)
        for d in others:
            torch.cuda.current_stream(d).wait_event(done)


def hop(vals: torch.Tensor, idx: torch.Tensor, dst: torch.device) -> Window:
    """One ring hop of a window into fresh buffers on ``dst``: the
    one-window ring step."""
    k = vals.shape[0]
    out = (torch.empty(k, dtype=torch.float32, device=dst),
           torch.empty(k, dtype=torch.int32, device=dst))
    ring_step([(vals, idx)], [out])
    return out


def ring_topk(windows: Sequence[Window], k: int) -> List[Window]:
    """Merge the shards' ``k``-row windows (``pad_window``-normalized,
    global indices; shard ``s``'s on the ring's device ``s``) into the global
    top-k: each shard's original window travels right ``S - 1`` steps, and
    each shard merges every window that arrives into its accumulator. Each
    step is one :func:`ring_step` per sending device into that step's
    receive buffers. Returns every shard's merged window, all equal; with
    one shard, the window itself."""
    for v, i in windows:
        if v.shape != (k,) or i.shape != (k,):
            raise ValueError(
                f"ring_topk needs k-row windows, got {tuple(v.shape)}/{tuple(i.shape)} "
                f"for k={k}; normalize with pad_window first"
            )
    n = len(windows)
    if n == 1:
        return list(windows)
    devs = [v.device for v, _ in windows]
    # Two [S, k] receive pairs per device; shard s's row receives on s's device.
    recv: Dict[torch.device, tuple] = {}
    for d in devs:
        if d not in recv:
            recv[d] = tuple((torch.empty(n, k, dtype=torch.float32, device=d),
                             torch.empty(n, k, dtype=torch.int32, device=d)) for _ in range(2))
    senders: Dict[torch.device, List[int]] = {}
    for s, d in enumerate(devs):
        senders.setdefault(d, []).append(s)
    acc = list(windows)
    cur = [(v.contiguous(), i.contiguous()) for v, i in windows]
    for step in range(n - 1):
        nxt = [(recv[devs[r]][step % 2][0][r], recv[devs[r]][step % 2][1][r]) for r in range(n)]
        for shards in senders.values():
            ring_step([cur[s] for s in shards], [nxt[(s + 1) % n] for s in shards])
        for s in range(n):
            acc[s] = merge_windows(*acc[s], *nxt[s], k)
        cur = nxt
    return acc


def enable_peer_access(ring: Sequence[torch.device]) -> None:
    """Let each ring shard's device write to its right neighbour's memory
    (the hop stores there); raises where the cards cannot reach each
    other. A ring that repeats one card needs nothing."""
    n = len(ring)
    pairs = {(ring[s].index, ring[(s + 1) % n].index) for s in range(n)}
    pairs = {(a, b) for a, b in pairs if a != b}
    if not pairs:
        return
    lib = kernels.load("ring_hop")
    for a, b in sorted(pairs):
        err = lib.ring_hop_enable_peer(a, b)
        if err != 0:
            raise RuntimeError(
                f"cuda:{a} cannot write to cuda:{b}'s memory (cudaError {err}): the ring "
                "hop needs peer access between neighbouring cards"
            )
