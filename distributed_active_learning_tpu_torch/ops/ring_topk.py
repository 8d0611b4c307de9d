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
remote DMA of the window to the right neighbour). Where one process drives
every shard, the handshake becomes stream order, and one launch per
(sending device, ring step) copies every window that device's shards send
(:func:`ring_step`): a mesh on one card runs ``S - 1`` launches per merge,
not ``S (S - 1)``. :func:`ring_topk` allocates one ``[S, k]`` receive pair
per device and ping-pongs between two across steps; it records and waits on
events only between distinct cards (the sender's stream waits until the
receiver's has enqueued every earlier merge, the receiver's waits for the
copy), and on one card stream order is the whole handshake. A window on
another card is stored through a peer pointer under UVA. CPU windows take
the plain version, tensor copies (:func:`ring_step_plain`).

Over several processes (``ring_topk(..., members=rings)``; ``parallel/
multihost.py``) each ring names the rank of each of its windows, in ring
order; a rank may hold several consecutive windows of a ring, and windows
of several rings (a mesh whose ranks' cells cross a row boundary). A hop
between two windows of one rank stays on the rank; a hop to another rank is
the TPU kernel's remote write again on the card: each rank's receive slots
(one per window it receives from another rank, two parities) are
``cudaMalloc``'d inside the ring-hop library and shared by CUDA IPC, the
handles are exchanged once over gloo, and K4 stores through the mapped
pointer of the receiver's slot (:class:`IpcWindow`). A step is eager and
simple: the stream is synchronised, a gloo barrier, one K4 launch carrying
every window the rank sends (to its own buffers and through IPC alike), a
synchronise, a barrier, then the merges. A failed IPC open raises; nothing
falls back to gloo on the card. The plain version, and K4's oracle there,
is a gloo ``isend``/``irecv`` of each window that crosses ranks
(:func:`hop_processes_plain`) and tensor copies within a rank.
:func:`remap_indices` maps picks over a rebalanced pod pool back to the
rows they were before the epoch (``serving/slab.py``).
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_active_learning_tpu_torch import kernels
from distributed_active_learning_tpu_torch.analysis import costs
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
    _launch_ptrs(dev, k, [(v.data_ptr(), i.data_ptr()) for v, i in src],
                 [(v.data_ptr(), i.data_ptr()) for v, i in dst])


def _launch_ptrs(dev: torch.device, k: int, src, dst) -> None:
    """K4 over raw ``(values, indices)`` pointer pairs of k-row windows,
    ``MAX_WINDOWS`` to a launch, each launch counted."""
    lib = kernels.load("ring_hop")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo in range(0, len(src), MAX_WINDOWS):
        s_, d_ = src[lo:lo + MAX_WINDOWS], dst[lo:lo + MAX_WINDOWS]
        m = len(s_)
        ptrs = (ctypes.c_void_p * (4 * m))(
            *[v for v, _ in s_], *[i for _, i in s_], *[v for v, _ in d_], *[i for _, i in d_])
        with torch.cuda.device(dev):
            err = lib.ring_step(ptrs, m, k, stream)
        kernels.check("ring_step", err)
        kernels.count_launch(sys.modules[__name__])


def ring_step(src: Sequence[Window], dst: Sequence[Window]) -> None:
    """Copy the windows one device sends into their receiving buffers. On
    CUDA: one kernel launch on the sender's stream, after the stream of
    every receiving card other than the sender's has enqueued its earlier
    work (merges that read the buffers), and before those streams go on. On
    the CPU: the plain copies."""
    if len(src) != len(dst) or not src:
        raise ValueError("a ring step needs one destination per source window")
    with kernels.collective_work("ring_hop", "ring", src), kernels.kernel_work(
            "ring_hop", lambda: costs.ring_step([v.shape[0] for v, _ in src])):
        _ring_step(src, dst)


def _ring_step(src: Sequence[Window], dst: Sequence[Window]) -> None:
    dev = src[0][0].device
    if dev.type == "cpu":
        ring_step_plain(src, dst)
        return
    if dev.type == "meta":
        return  # a priced program's stand-in: the buffers exist, nothing moves
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


def ring_topk(windows: Sequence[Window], k: int, members=None,
              plain: bool = False, received: Optional[list] = None) -> List[Window]:
    """Merge the shards' ``k``-row windows (``pad_window``-normalized,
    global indices; shard ``s``'s on the ring's device ``s``) into the global
    top-k: each shard's original window travels right ``S - 1`` steps, and
    each shard merges every window that arrives into its accumulator. Each
    step is one :func:`ring_step` per sending device into that step's
    receive buffers. Returns every shard's merged window, all equal; with
    one shard, the window itself.

    With ``members`` the rings span processes (:func:`_ring_topk_processes`;
    COLLECTIVE over the job): one ring, the rank of each of its windows in
    ring order (``(0, 0, 1)``: rank 0 holds the first two), or a sequence of
    such rings of one length, which run together. ``windows`` are this
    rank's, ring by ring in ring order. Every rank of the job calls it with
    the same rings. ``None`` keeps the ring in this process. ``plain`` takes
    the gloo hop on the card too (K4's oracle), and ``received`` (a list)
    collects a copy of each window this rank receives from another rank, in
    step, ring and position order."""
    for v, i in windows:
        if v.shape != (k,) or i.shape != (k,):
            raise ValueError(
                f"ring_topk needs k-row windows, got {tuple(v.shape)}/{tuple(i.shape)} "
                f"for k={k}; normalize with pad_window first"
            )
    if members is not None:
        rings = _as_rings(members)
        if len(rings[0]) == 1:
            return list(windows)
        return _ring_topk_processes(windows, k, rings, plain, received)
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


Rings = Tuple[Tuple[int, ...], ...]


def _as_rings(members) -> Rings:
    """``members`` as a tuple of rings: one ring of ranks, or several."""
    members = tuple(members)
    if members and not isinstance(members[0], (tuple, list, range)):
        members = (members,)
    rings = tuple(tuple(int(r) for r in ring) for ring in members)
    if len({len(ring) for ring in rings}) != 1:
        raise ValueError(f"rings of one length run together, got {rings}")
    return rings


def positions(rings: Rings, rank: int) -> List[Tuple[int, int]]:
    """The ``(ring, position)`` of each window ``rank`` holds, in ring and
    position order (the order of its ``windows``)."""
    return [(j, s) for j, ring in enumerate(rings) for s, r in enumerate(ring) if r == rank]


def remote_slots(rings: Rings, rank: int) -> List[Tuple[int, int]]:
    """The positions at which ``rank`` receives from another rank: one
    receive slot each, in this order (every rank computes every rank's)."""
    return [(j, s) for j, s in positions(rings, rank) if rings[j][s - 1] != rank]


def hop_processes_plain(sends: Sequence[Tuple[Window, int, int]],
                        recvs: Sequence[Tuple[int, int]], k: int,
                        device: torch.device) -> List[Window]:
    """The plain hops of one ring step between processes: each ``(window,
    rank, tag)`` of ``sends`` to its rank, and one window from each ``(rank,
    tag)`` of ``recvs``, as gloo ``isend``/``irecv`` of ``[2k]`` int32 words
    staged through the host (the values' bits, then the indices). Returns
    the received windows in ``recvs``' order, fresh buffers on ``device``.
    COLLECTIVE over the ranks named."""
    import torch.distributed as dist

    reqs, got = [], []
    for (vals, idx), rank, tag in sends:
        msg = torch.cat([vals.contiguous().view(torch.int32), idx.to(torch.int32)]).cpu()
        reqs.append(dist.isend(msg, rank, tag=tag))
    for rank, tag in recvs:
        buf = torch.empty(2 * k, dtype=torch.int32)
        got.append(buf)
        reqs.append(dist.irecv(buf, rank, tag=tag))
    for q in reqs:
        q.wait()
    out = []
    for buf in got:
        buf = buf.to(device)
        out.append((buf[:k].view(torch.float32), buf[k:]))
    return out


class _CudaArray:
    """A raw device pointer as a 1-D array PyTorch can view
    (``__cuda_array_interface__``; no copy, no ownership)."""

    def __init__(self, ptr: int, n: int, typestr: str):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": typestr,
                                         "data": (ptr, False), "strides": None,
                                         "version": 2}


class IpcWindow:
    """This rank's receive slots of k-row windows (one per position at which
    it receives from another rank of ``rings``, two parities),
    ``cudaMalloc``'d in the ring-hop library and exported by CUDA IPC, and
    the slots of each rank it sends to mapped here. Made once per (card, k,
    rings) by every rank together (the handles cross over gloo); kept for
    the process's life. A failed allocation, export or open raises, naming
    the cause."""

    def __init__(self, dev: torch.device, k: int, rings: Rings):
        from distributed_active_learning_tpu_torch.parallel import multihost

        lib = kernels.load("ring_hop")
        rank = multihost.process_index()
        self.k = k
        self.vals_bytes = -(-4 * k // 256) * 256
        self.slot_bytes = 2 * self.vals_bytes
        self.slots = {q: remote_slots(rings, q) for q in range(multihost.process_count())}
        size = lib.ring_hop_ipc_handle_size()
        handle = ctypes.create_string_buffer(size)
        base = ctypes.c_void_p()
        n_mine = max(len(self.slots[rank]), 1)
        err = lib.ring_hop_ipc_alloc(dev.index, 2 * n_mine * self.slot_bytes,
                                     ctypes.byref(base), handle)
        if err != 0:
            raise RuntimeError(f"ring hop: cudaMalloc or cudaIpcGetMemHandle of the receive "
                               f"window failed on {dev} (cudaError {err})")
        self.local_base = base.value
        handles = multihost.all_gather(torch.frombuffer(bytearray(handle.raw), dtype=torch.uint8))
        L = len(rings[0])
        peers = sorted({rings[j][(s + 1) % L] for j, s in positions(rings, rank)} - {rank})
        self.remote_base = {}
        for q in peers:
            theirs = ctypes.create_string_buffer(bytes(handles[q].numpy().tobytes()), size)
            mapped = ctypes.c_void_p()
            err = lib.ring_hop_ipc_open(dev.index, theirs, ctypes.byref(mapped))
            if err != 0:
                raise RuntimeError(
                    f"ring hop: cudaIpcOpenMemHandle of rank {q}'s receive window failed on "
                    f"{dev} (cudaError {err}): CUDA IPC needs the ranks to share an IPC "
                    "namespace (and, across cards, peer access); the ring does not fall back "
                    "to gloo on the card")
            self.remote_base[q] = mapped.value
        self._n = {q: max(len(v), 1) for q, v in self.slots.items()}
        # Views of this rank's own slots, read by the merges.
        self._local = {}
        for parity in range(2):
            for i, pos in enumerate(self.slots[rank]):
                v, x = self._ptrs(self.local_base, rank, i, parity)
                self._local[parity, pos] = (
                    torch.as_tensor(_CudaArray(v, k, "<f4"), device=dev),
                    torch.as_tensor(_CudaArray(x, k, "<i4"), device=dev))

    def _ptrs(self, base: int, rank: int, slot: int, parity: int) -> Tuple[int, int]:
        at = base + (parity * self._n[rank] + slot) * self.slot_bytes
        return at, at + self.vals_bytes

    def remote(self, rank: int, pos: Tuple[int, int], parity: int) -> Tuple[int, int]:
        """``rank``'s slot for ring position ``pos`` as a ``(values,
        indices)`` pointer pair."""
        return self._ptrs(self.remote_base[rank], rank, self.slots[rank].index(pos), parity)

    def local(self, pos: Tuple[int, int], parity: int) -> Window:
        """This rank's slot for ring position ``pos`` as tensors (views of
        the shared window)."""
        return self._local[parity, pos]


_ipc_windows: Dict[tuple, IpcWindow] = {}


def ipc_window(dev: torch.device, k: int, rings: Rings) -> IpcWindow:
    """The :class:`IpcWindow` of (``dev``, ``k``, ``rings``), made on first
    use (COLLECTIVE then: every rank asks at the same point)."""
    key = (dev.index, k, rings)
    if key not in _ipc_windows:
        _ipc_windows[key] = IpcWindow(dev, k, rings)
    return _ipc_windows[key]


def _ring_topk_processes(windows: Sequence[Window], k: int, rings: Rings,
                         plain: bool, received: Optional[list]) -> List[Window]:
    """:func:`ring_topk` over processes: ``rings`` (one length ``L``, each
    naming the rank of each window in ring order), ``windows`` this rank's
    in :func:`positions` order. Every rank runs the same ``L - 1`` steps
    under the job's barriers; at each, the window at every position moves to
    the next one: to this rank's own buffer where the next position is this
    rank's, else to the holder's receive slot, by K4 through the IPC window
    on the card (one launch a step for every window the rank sends) or by
    the gloo hop on the CPU or with ``plain``. Every position then merges
    what arrived, so each of this rank's windows ends as the ring's merge,
    which is every ring's (a stable top-k with index tie-break, whatever
    the order of the merges)."""
    from distributed_active_learning_tpu_torch.parallel import multihost

    rank = multihost.process_index()
    mine = positions(rings, rank)
    if not mine or len(windows) != len(mine):
        raise ValueError(f"rank {rank} holds {len(mine)} windows of the rings {rings}, "
                         f"got {len(windows)}")
    L = len(rings[0])
    at = {pos: i for i, pos in enumerate(mine)}
    # Each window's next position and its holder, and where a window
    # arrives from another rank (from the previous position's holder).
    to = [(j, (s + 1) % L) for j, s in mine]
    to_rank = [rings[j][t] for j, t in to]
    from_rank = [rings[j][s - 1] for j, s in mine]
    dev = windows[0][0].device
    on_card = dev.type == "cuda" and not plain
    win = ipc_window(dev, k, rings) if on_card else None
    acc = list(windows)
    cur = [(v.contiguous(), i.contiguous()) for v, i in windows]
    bufs = [[(torch.empty(k, dtype=torch.float32, device=dev),
              torch.empty(k, dtype=torch.int32, device=dev)) for _ in mine] for _ in range(2)]

    def tag(step, j, s):
        return (step * len(rings) + j) * L + s

    for step in range(L - 1):
        parity = step % 2
        nxt = [bufs[parity][i] if r == rank else None for i, r in enumerate(from_rank)]
        with kernels.collective_work("ring_hop", "ring", cur), kernels.kernel_work(
                "ring_hop", lambda: costs.ring_step([k] * len(mine))):
            if dev.type == "meta":  # a priced program: the buffers exist, nothing moves
                nxt = list(bufs[parity])
            elif on_card:
                dst = [win.remote(q, t, parity) if q != rank else
                       (nxt[at[t]][0].data_ptr(), nxt[at[t]][1].data_ptr())
                       for q, t in zip(to_rank, to)]
                stream = torch.cuda.current_stream(dev)
                stream.synchronize()
                multihost.barrier()  # every receiving slot of this step is free
                _launch_ptrs(dev, k, [(v.data_ptr(), i.data_ptr()) for v, i in cur], dst)
                stream.synchronize()
                multihost.barrier()  # every window of this step has landed
                nxt = [b if b is not None else win.local(pos, parity)
                       for b, pos in zip(nxt, mine)]
            else:
                local = [(cur[i], nxt[at[t]]) for i, (q, t) in enumerate(zip(to_rank, to))
                         if q == rank]
                ring_step_plain([a for a, _ in local], [b for _, b in local])
                got = iter(hop_processes_plain(
                    [(cur[i], q, tag(step, *t)) for i, (q, t) in enumerate(zip(to_rank, to))
                     if q != rank],
                    [(r, tag(step, *pos)) for r, pos in zip(from_rank, mine) if r != rank],
                    k, dev))
                nxt = [b if b is not None else next(got) for b in nxt]
        if received is not None:
            received.extend((v.clone(), i.clone()) for r, (v, i) in zip(from_rank, nxt)
                            if r != rank)
        for i in range(len(mine)):
            acc[i] = merge_windows(*acc[i], *nxt[i], k)
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


def remap_indices(idx: torch.Tensor, moved_src: torch.Tensor,
                  moved_dst: torch.Tensor) -> torch.Tensor:
    """Selection indices over a rebalanced pool mapped back to the rows they
    were before the epoch: every index found in ``moved_dst`` (negative
    entries are padding) becomes its ``moved_src`` twin, the rest pass
    through. An O(k x moved) equality compare, window-sized on both axes
    (``serving.slab.make_rebalance_fn`` returns the map); the first match
    wins, as ``argmax`` over the hits does in the JAX package."""
    src = moved_src.reshape(-1).to(idx.device)
    dst = moved_dst.reshape(-1).to(idx.device)
    hit = (idx[..., None].to(dst.dtype) == dst) & (dst >= 0)
    found = hit.any(-1)
    at = torch.argmax(hit.to(torch.int8), dim=-1)
    return torch.where(found, src[at].to(idx.dtype), idx)
