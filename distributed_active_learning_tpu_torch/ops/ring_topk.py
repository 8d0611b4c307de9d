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

The hop (K4) is ``csrc/ring_hop.cu``, which replaces the Pallas
``_hop_kernel`` (a barrier-semaphore handshake with both neighbours, then a
remote DMA of the window to the right neighbour). Here one process drives
every shard, so the handshake becomes stream ordering: the copy kernel runs
on the sending shard's device and current stream and stores the window
straight into buffers on the right neighbour's device (a peer pointer under
UVA on distinct cards; the same device when the mesh repeats a card). The
sender's stream first waits on an event the neighbour's stream records once
the buffers are allocated and every earlier merge there has been enqueued;
the neighbour's stream then waits on an event recorded after the copy, and
``record_stream`` keeps the caching allocator from handing the buffers out
before the copy is done. A CPU tensor takes the plain version, a tensor copy
to the neighbour's device. ``remap_indices`` waits for serving's rebalance.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from distributed_active_learning_tpu_torch import kernels
from distributed_active_learning_tpu_torch.ops.topk import NEG_INF

#: Window-padding index: larger than any real pool index, so a padding row
#: (value -inf) loses the index tie-break against every real -inf row.
IDX_SENTINEL = int(np.iinfo(np.int32).max)

# Launches of csrc/ring_hop.cu, counted where the kernel is launched.
launches = 0

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
    """The plain version of the hop: a tensor copy to ``dst`` (a fresh copy
    on the same device too, as the kernel writes fresh buffers)."""
    return vals.to(dst, copy=True), idx.to(dst, copy=True)


def _launch_hop(vals: torch.Tensor, idx: torch.Tensor, dst: torch.device) -> Window:
    """Launch csrc/ring_hop.cu on the sender's stream, writing the window
    into fresh buffers on ``dst``, ordered by events on both streams."""
    global launches
    k = vals.shape[0]
    if vals.dtype != torch.float32 or idx.dtype != torch.int32 or idx.shape != (k,) or vals.ndim != 1:
        raise ValueError("a window is [k] float32 values and [k] int32 indices")
    if idx.device != vals.device or dst.type != "cuda":
        raise ValueError(f"a hop copies a CUDA window to a CUDA device, got {vals.device} -> {dst}")
    vals, idx = vals.contiguous(), idx.contiguous()
    src_stream = torch.cuda.current_stream(vals.device)
    dst_stream = torch.cuda.current_stream(dst)
    with torch.cuda.device(dst):
        out_v = torch.empty(k, dtype=torch.float32, device=dst)
        out_i = torch.empty(k, dtype=torch.int32, device=dst)
        free = torch.cuda.Event()
        free.record(dst_stream)
    src_stream.wait_event(free)
    lib = kernels.load("ring_hop")
    with torch.cuda.device(vals.device):
        err = lib.ring_hop(vals.data_ptr(), idx.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                           k, src_stream.cuda_stream)
        kernels.check("ring_hop", err)
        out_v.record_stream(src_stream)
        out_i.record_stream(src_stream)
        done = torch.cuda.Event()
        done.record(src_stream)
    dst_stream.wait_event(done)
    launches += 1
    return out_v, out_i


def hop(vals: torch.Tensor, idx: torch.Tensor, dst: torch.device) -> Window:
    """One ring hop of a window to ``dst``: the CUDA kernel for a CUDA
    window, the plain copy for a CPU one."""
    if vals.device.type == "cuda":
        return _launch_hop(vals, idx, torch.device(dst))
    if vals.device.type == "cpu":
        return hop_plain(vals, idx, torch.device(dst))
    raise ValueError(f"unsupported device {vals.device}")


def ring_topk(windows: Sequence[Window], k: int) -> List[Window]:
    """Merge the shards' ``k``-row windows (``pad_window``-normalized,
    global indices; shard ``s``'s on the ring's device ``s``) into the global
    top-k: each shard sends its original window right ``S - 1`` times,
    merging each arriving window into its accumulator. Returns every shard's
    merged window, all equal; with one shard, the window itself."""
    for v, i in windows:
        if v.shape != (k,) or i.shape != (k,):
            raise ValueError(
                f"ring_topk needs k-row windows, got {tuple(v.shape)}/{tuple(i.shape)} "
                f"for k={k}; normalize with pad_window first"
            )
    n = len(windows)
    acc = list(windows)
    cur = list(windows)
    for _ in range(n - 1):
        nxt = [None] * n
        for s in range(n):
            right = (s + 1) % n
            nxt[right] = hop(*cur[s], windows[right][0].device)
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
