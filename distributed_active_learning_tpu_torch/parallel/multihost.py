"""Meshes over several processes (the port of ``parallel/multihost.py``).

The JAX package joins a multi-host job with ``jax.distributed``: every
process runs the same program, the global mesh spans every process's
devices, and each process holds only its own shards. The port does the same
with a ``torch.distributed`` process group on the **gloo** backend, which is
host-staged and so works on the CPU, between processes that share one card
and across cards. (NCCL refuses two ranks on one card.) Every rank runs the
same program in the same order; a data-sharded value crosses processes only
through the collectives here (:func:`all_gather`, :func:`gather_rows`),
which every rank must call at the same point. The ring top-k's hop between
processes goes through CUDA IPC on the card (``ops/ring_topk.py``).

Launch contract, as the JAX package's: the env trio
``JAX_COORDINATOR_ADDRESS`` (``host:port``), ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``; or a GPU launcher's own (``torchrun``'s ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``).
``JAX_NUM_PROCESSES=1`` or ``WORLD_SIZE=1`` opts out. A rank's card is
``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK`` defaults to the process
index), so N processes on a one-card machine share ``cuda:0`` and on four
cards each rank has its own.

Process subgroups (:func:`make_groups`) are made by rank list; which ranks
share what is the mesh's to say (``parallel/mesh.py``'s ``Spread``: a
data row's ranks form its row group, over which the sums over ``model``
run; where a rank's cells cross a row boundary the groups overlap, and
every rank calls its groups in row order). On the meta device (a priced
program, ``analysis/memory.py``) a collective returns empty tensors of its
shapes and moves nothing.

Host-side writes (checkpoints, the metrics stream) belong to the primary
(:func:`is_primary`); the payload a write needs is gathered collectively
first, on every rank.
"""

from __future__ import annotations

import atexit
import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_ENV_COORD = "JAX_COORDINATOR_ADDRESS"
_ENV_NPROC = "JAX_NUM_PROCESSES"
_ENV_PID = "JAX_PROCESS_ID"

#: The process group's backend, named in every run's metadata.
BACKEND = "gloo"
#: How long a collective waits for the other ranks before it raises.
TIMEOUT_SECONDS = 600


def _dist():
    import torch.distributed as dist

    return dist


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v not in (None, ""):
            return int(v)
    return None


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the multi-process job: a gloo process group of ``num_processes``
    ranks meeting at ``coordinator_address`` (``host:port``, or a
    ``tcp://`` or ``file://`` URL). Arguments default to the JAX env trio,
    then to ``torchrun``'s env (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). Joining twice is a no-op."""
    dist = _dist()
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get(_ENV_COORD)
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _env_int(_ENV_NPROC, "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int(_ENV_PID, "RANK")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process job needs its coordinator address, process count and process "
            f"index: set {_ENV_COORD}, {_ENV_NPROC} and {_ENV_PID} (or torchrun's "
            "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(BACKEND, init_method=url, world_size=int(num_processes),
                            rank=int(process_id), timeout=timedelta(seconds=TIMEOUT_SECONDS))
    # Tear the group down before the interpreter does: its transport threads
    # must not outlive the objects they use at exit.
    atexit.register(_shutdown)


def _shutdown() -> None:
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()


def maybe_initialize() -> bool:
    """Join iff a multi-process launch is configured (the env trio, or
    ``WORLD_SIZE`` above 1); returns whether the process group is up.
    ``JAX_NUM_PROCESSES=1`` or ``WORLD_SIZE=1`` opts out (a standalone run
    of one worker)."""
    if _dist().is_initialized():
        return True
    nproc = _env_int(_ENV_NPROC, "WORLD_SIZE")
    if nproc is None or nproc <= 1:
        return False
    initialize()
    return True


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns host-side writes (checkpoints, the
    metrics stream)."""
    return process_index() == 0


def launched() -> bool:
    """Whether this process was launched as one rank of several (the env
    asks for a multi-process job, joined or not yet)."""
    return (_env_int(_ENV_NPROC, "WORLD_SIZE") or 1) > 1 or process_count() > 1


def local_device_index() -> int:
    """This rank's card: ``LOCAL_RANK`` (else the process index) modulo the
    visible cards."""
    local = _env_int("LOCAL_RANK", _ENV_PID, "RANK")
    if local is None:
        local = process_index()
    return local % max(torch.cuda.device_count(), 1)


def run_meta() -> dict:
    """The process layout a run's ``meta`` event carries: the process count,
    and over several processes this rank's index and the group's backend."""
    n = process_count()
    if n == 1:
        return {"process_count": 1}
    return {"process_count": n, "process_index": process_index(),
            "process_group_backend": BACKEND}


def barrier() -> None:
    if process_count() > 1:
        _dist().barrier()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous host tensor of a type gloo carries (bool as
    uint8, 16-bit floats as their int16 bits)."""
    h = t.detach().to("cpu")
    if h.dtype == torch.bool:
        h = h.to(torch.uint8)
    elif h.dtype in (torch.bfloat16, torch.float16):
        h = h.view(torch.int16)
    return h.contiguous()


def _unwire(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bool:
        h = h.to(torch.bool)
    elif like.dtype in (torch.bfloat16, torch.float16):
        h = h.view(like.dtype)
    return h.to(like.device)


#: The job's process subgroups by their ranks (:func:`make_groups`).
_groups: Dict[Tuple[int, ...], object] = {}


def make_groups(rank_lists: Sequence[Sequence[int]]) -> None:
    """Create the process group of each rank list that has none yet, in
    order. COLLECTIVE over the whole job: every rank calls it with the same
    lists, members or not (``parallel.mesh.make_mesh`` does, for a mesh's
    row groups)."""
    for ranks in rank_lists:
        key = tuple(int(r) for r in ranks)
        if key not in _groups:
            _groups[key] = _dist().new_group(list(key), backend=BACKEND)


def all_gather(t: torch.Tensor, ranks: Optional[Sequence[int]] = None,
               counts: Optional[Sequence[int]] = None, dim: int = 0) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order, on ``t``'s device:
    over the job, or over the group of ``ranks`` (made by
    :func:`make_groups`; it holds this rank). ``counts``, each rank's length
    along ``dim`` in rank order, lets the ranks' tensors differ there (a
    mesh's owners own different numbers of rows, a row's ranks hold
    different numbers of its cells): each is padded to the longest for the
    gather and cut back. COLLECTIVE over those ranks. The copy to the host
    and back is explicit: gloo moves host memory."""
    n = process_count() if ranks is None else len(ranks)
    if n == 1:
        return [t]
    if counts is not None:
        pad = list(t.shape)
        pad[dim] = max(counts) - t.shape[dim]
        parts = all_gather(torch.cat([t, t.new_zeros(pad)], dim=dim), ranks)
        return [p.narrow(dim, 0, c) for p, c in zip(parts, counts)]
    if t.device.type == "meta":  # a priced program: the shapes, nothing moves
        return [torch.empty_like(t) for _ in range(n)]
    group = None
    if ranks is not None:
        group = _groups.get(tuple(int(r) for r in ranks))
        if group is None:
            raise RuntimeError(f"no process group of ranks {list(ranks)}: every rank makes it "
                               "first (make_groups)")
    h = _wire(t)
    out = [torch.empty_like(h) for _ in range(n)]
    _dist().all_gather(out, h, group=group)
    return [_unwire(o, t) for o in out]


def gather_rows(local: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The global array from each rank's row block: this rank's ``local``
    rows (every rank's block padded to one length; padding rows only at the
    global end) gathered over the job, joined in rank order and cut to
    ``n_rows``. COLLECTIVE."""
    return torch.cat(all_gather(local))[:n_rows]


def gather_scalar_gauges(values: dict) -> dict:
    """Every rank's scalar gauges as ``{name: [v_rank0, ...]}``. COLLECTIVE
    when the job spans processes (every rank calls it at the same point with
    the same names); one-element lists otherwise."""
    names = sorted(values)
    local = torch.tensor([float(values[n]) for n in names], dtype=torch.float64)
    rows = torch.stack(all_gather(local))
    return {n: [float(v) for v in rows[:, i]] for i, n in enumerate(names)}


def host_np(x) -> np.ndarray:
    """``x`` on the host as numpy: a row-sharded array spanning processes
    is all-gathered first (COLLECTIVE), in shard order and cut to its
    logical rows; a replicated tensor is copied."""
    from distributed_active_learning_tpu_torch.parallel.mesh import Sharded

    if isinstance(x, Sharded):
        x = x.gather()
    return x.detach().cpu().numpy()
