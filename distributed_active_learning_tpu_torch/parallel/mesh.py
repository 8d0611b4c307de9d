"""Device meshes and placement of the pool and the forest (the port of
``parallel/mesh.py``).

The JAX package runs one program over a ``(data, model)`` mesh: pool rows
shard over ``data``, trees over ``model``, and XLA places each shard. Here
the mesh is a grid of ``torch.device``s driven by one process, and placement
is explicit: a row-sharded array is a :class:`Sharded` (each data shard's
contiguous row block, on its devices), a sharded forest is a ``[data][model]``
grid of forests holding each model shard's trees (:func:`shard_forest`).

A mesh may name one card several times (``make_mesh(4, 2, devices=[cuda:0]
* 8)``): every shard then lies on that card and moving a block to a shard is
free. That is how one card, or the CPU, runs a mesh; on distinct cards the
same code moves real bytes. A forest fitted inside a chunk's round step
is placed there by :func:`constrain_forest`, and wrapped for per-shard
evaluation as a :class:`ShardedForest` (``ops.trees_pallas.attach_mesh``).
Over several processes (``parallel/multihost.py``) the mesh is the global
one, filled row by row as JAX fills ``jax.devices()``: cell ``(s, m)`` is
global device ``s * model + m``, and rank ``r`` of ``P`` owns cells ``[r *
C / P, (r + 1) * C / P)`` of the ``C = data * model`` (:class:`Spread`).
A rank holds whole rows, a part of one row, or cells that cross a row
boundary partway (``Mesh.devices`` holds its cells row by row, ragged then;
``Mesh.row0`` is its first row's global index, ``Mesh.col_offsets`` each
row's first model index). A :class:`Sharded` holds the blocks of this
rank's rows (each rank holding a cell of a row holds a replica of its
block), and :func:`global_put` places the same logical host value on every
rank by keeping the rank's own shards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from distributed_active_learning_tpu_torch.ops.trees_train import to_device

AXIS_DATA = "data"
AXIS_MODEL = "model"


@dataclasses.dataclass(frozen=True)
class Spread:
    """How a ``(data, model)`` mesh's cells lie over the job's processes:
    all that a collective needs of a placement. The ``data * model`` cells
    are filled row by row, cell ``(s, m)`` global device ``s * model + m``,
    and rank ``r`` of ``procs`` holds cells ``[r * per, (r + 1) * per)``
    (``per = data * model / procs``), as JAX fills ``jax.devices()``. A
    rank may hold whole rows, a part of one row, or parts of two rows and
    whole ones between (its cells cross a row boundary partway). A rank
    that holds any cell of a row holds a replica of the row's pool block;
    the row's **owner** is the holder of its first cell, and joins over
    ``data`` take each row from its owner. ``rank`` is this process.
    ``Spread()`` is one process."""

    procs: int = 1
    data: int = 1
    model: int = 1
    rank: int = 0

    @property
    def per(self) -> int:
        """The cells each rank holds."""
        return self.data * self.model // self.procs

    def holder(self, s: int, m: int) -> int:
        """The rank that holds cell ``(s, m)``."""
        return (s * self.model + m) // self.per

    def rows_of(self, r: int) -> range:
        """The data rows rank ``r`` holds a cell of, in order."""
        return range(r * self.per // self.model, ((r + 1) * self.per - 1) // self.model + 1)

    def cols_of(self, r: int, s: int) -> range:
        """The model columns of row ``s`` that rank ``r`` holds."""
        lo = r * self.per - s * self.model
        return range(max(lo, 0), min(lo + self.per, self.model))

    def holders(self, s: int) -> range:
        """The ranks that hold row ``s``'s cells, in model order: its row
        group, over which the sum over ``model`` runs."""
        return range(s * self.model // self.per, ((s + 1) * self.model - 1) // self.per + 1)

    def owned(self, r: int) -> range:
        """The rows rank ``r`` owns (holds the first cell of): contiguous,
        possibly none, and in rank order over the ranks."""
        return range(-(-r * self.per // self.model), -(-(r + 1) * self.per // self.model))

    @property
    def rows(self) -> range:
        """This rank's rows."""
        return self.rows_of(self.rank)

    @property
    def spans_rows(self) -> bool:
        """Whether the data rows lie over several processes, so that a join
        or a sum over ``data`` gathers from the other ranks (the same on
        every rank: no rank holds every row then)."""
        return self.procs > 1 and self.data > 1

    @property
    def owners(self) -> Tuple[int, ...]:
        """Each row's owner, in row order: the ranks a join over ``data``
        takes rows from, so that every row counts once."""
        return tuple(self.holders(s)[0] for s in range(self.data))

    @property
    def row_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """Every row's holders, in row order. Where a rank's cells cross a
        row boundary the groups overlap: the rank is in two."""
        return tuple(tuple(self.holders(s)) for s in range(self.data))

    def column(self, m: int) -> Tuple[int, ...]:
        """The members of model column ``m``'s ring over ``data``: the
        holder of each row's cell ``(s, m)``, in row order (a rank holding
        several consecutive rows' cells appears once for each)."""
        return tuple(self.holder(s, m) for s in range(self.data))

    @property
    def ring_columns(self) -> Tuple[int, ...]:
        """The model columns whose rings the fused selection runs: column 0,
        then, for each rank in order that holds no cell of a column taken
        so far, the column of its first cell; so every rank holds a window
        of some ring and ends with the merged result. One ring where rows
        are whole; one a part where ranks split a row evenly."""
        cols: list = []
        for r in range(self.procs):
            if not any(r in self.column(m) for m in cols):
                cols.append(r * self.per % self.model)
        return tuple(cols)

    @property
    def rings(self) -> Tuple[Tuple[int, ...], ...]:
        """The members of each ring of :attr:`ring_columns`."""
        return tuple(self.column(m) for m in self.ring_columns)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``[data][model]`` grid of devices. Over several processes
    (``n_procs > 1``) ``devices`` holds this process's cells of the global
    grid, row by row (``devices[i]`` the cells of global row ``row0 + i``
    from model column ``col_offsets[i]`` on: ragged where the rank's cells
    cross a row boundary), ``rank`` the process's index and ``data`` and
    ``model`` the global axes (0: one process, the grid's own)."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    n_procs: int = 1
    rank: int = 0
    model: int = 0
    data: int = 0

    @property
    def shape(self):
        return {AXIS_DATA: self.data or len(self.devices),
                AXIS_MODEL: self.model or len(self.devices[0])}

    @property
    def spread(self) -> Spread:
        """How the cells lie over the processes (the collectives'
        placement)."""
        return Spread(self.n_procs, self.shape[AXIS_DATA], self.shape[AXIS_MODEL], self.rank)

    @property
    def row0(self) -> int:
        """The global data index of this process's first row."""
        return self.spread.rows.start

    @property
    def col_offsets(self) -> Tuple[int, ...]:
        """The global model index of this process's first cell in each of
        its rows."""
        sp = self.spread
        return tuple(sp.cols_of(self.rank, s).start for s in sp.rows)

    @property
    def first(self) -> torch.device:
        """This process's first device, where global results are gathered
        (on every process of a multi-process mesh)."""
        return self.devices[0][0]

    @property
    def ring(self) -> Tuple[torch.device, ...]:
        """This process's part of the data ring: its first cell's device in
        each of its data rows."""
        return tuple(row[0] for row in self.devices)

    @property
    def rings(self) -> Tuple[Tuple[int, ...], ...]:
        """The rings over ``data`` the fused selection runs, as member
        lists (``Spread.rings``)."""
        return self.spread.rings


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Mesh:
    """A ``(data, model)`` mesh, filled row by row from ``devices``.

    Without ``devices``: on CUDA the first ``data * model`` visible cards
    (raising when there are fewer, as JAX does); on the CPU every shard lies
    on ``cpu`` (the counterpart of the JAX tests' forced host devices).
    ``data`` defaults to every device on the data axis. An explicit list may
    repeat a card; on distinct cards, peer access is enabled from each ring
    shard to its right neighbour (the ring hop writes there) and its absence
    raises.

    In a multi-process job (``parallel.multihost``: joined here if the
    launch asks for one) the mesh spans the processes: the ``data * model``
    cells divide over them in row-major order (a ``ValueError`` naming the
    shape when they do not), every cell of a rank on the rank's own card
    (``multihost.local_device_index``) or on ``devices``, which then lists
    this process's devices. ``data`` defaults to one row a process. A rank
    holds whole rows, a part of one row, or cells that cross a row boundary
    partway (``MeshConfig(3, 2)`` over 2 processes: rank 0 holds row 0 and
    the first cell of row 1); its ``devices`` are then ragged. Where a row
    spans processes, every rank creates every such row's process group
    here, in row order (``multihost.make_groups``).
    """
    from distributed_active_learning_tpu_torch.parallel import multihost

    multihost.maybe_initialize()
    n_procs = multihost.process_count()
    kind = torch.device(device).type
    widths = None  # this process's cells in each of its rows
    if n_procs > 1:
        data = n_procs if data is None else data
        cells = data * model
        if data < 1 or model < 1 or cells % n_procs:
            raise ValueError(f"mesh {data}x{model}: its {cells} cells do not divide over "
                             f"{n_procs} processes")
        spread = Spread(n_procs, data, model, multihost.process_index())
        widths = [len(spread.cols_of(spread.rank, s)) for s in spread.rows]
    n_cells = sum(widths) if widths else (data or 1) * model
    if devices is not None:
        devs = [_indexed(torch.device(d)) for d in devices]
    elif kind == "cpu":
        devs = [torch.device("cpu")] * n_cells
    elif kind == "cuda" and n_procs > 1:
        devs = [torch.device("cuda", multihost.local_device_index())] * n_cells
    elif kind == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if data is None:
        if len(devs) % model:
            raise ValueError(f"{len(devs)} devices not divisible by model={model}")
        data = len(devs) // model
    if data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model} needs positive axes")
    if widths is None:
        widths = [model] * data
    if sum(widths) > len(devs):
        raise ValueError(f"mesh {data}x{model} exceeds {len(devs)} devices")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh lies on one kind of device, got {devs}")
    ends = np.cumsum([0, *widths])
    grid = tuple(tuple(devs[a:b]) for a, b in zip(ends[:-1], ends[1:]))
    if n_procs == 1:
        return _peered(Mesh(grid))
    mesh = Mesh(grid, n_procs=n_procs, rank=spread.rank, model=model, data=data)
    multihost.make_groups(g for g in dict.fromkeys(spread.row_groups) if len(g) > 1)
    return _peered(mesh)


def _peered(mesh: Mesh) -> Mesh:
    """``mesh``, peer access enabled along its ring on distinct cards."""
    if mesh.first.type == "cuda":
        from distributed_active_learning_tpu_torch.ops import ring_topk

        ring_topk.enable_peer_access(mesh.ring)
    return mesh


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` names the current card; a mesh names it by index."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A row-sharded array: ``blocks[i]`` holds data shard ``first + i``'s
    contiguous row block, once per device it is placed on (one replica per
    model device for the pool's features, as ``P(data, None)`` replicates
    them; one for masks and labels). ``n_rows`` is the logical row count;
    the last blocks may carry padding rows past it. In one process
    ``blocks`` are every shard's (``first`` 0); over several processes they
    are this process's rows', ``n_shards`` counts the global data axis, and
    ``spread`` says which processes hold each row (a replica on each of
    them, written the same way on every one)."""

    blocks: Tuple[Tuple[torch.Tensor, ...], ...]
    n_rows: int
    first: int = 0
    n_shards: Optional[int] = None
    spread: Spread = Spread()

    @property
    def shape(self):
        return (self.n_rows, *self.blocks[0][0].shape[1:])

    @property
    def device(self) -> torch.device:
        return self.blocks[0][0].device

    @property
    def n_local(self) -> int:
        return self.blocks[0][0].shape[0]

    @property
    def local_ids(self) -> range:
        """The global data indices of the blocks held here."""
        return range(self.first, self.first + len(self.blocks))

    @property
    def spans_processes(self) -> bool:
        """Whether other processes hold other rows (a join over ``data``
        gathers; the same on every rank)."""
        return self.n_shards is not None and self.spread.spans_rows

    @property
    def across_processes(self) -> bool:
        """Whether the array is placed over several processes at all (its
        rows spread, or each row held by several)."""
        return self.spread.procs > 1

    def block(self, s: int, m: int = 0) -> torch.Tensor:
        """Data shard ``s``'s block (a global index) on this process's
        ``m``-th device of the row; a shard this process does not hold
        raises."""
        i = s - self.first
        if not 0 <= i < len(self.blocks):
            raise ValueError(f"data shard {s} is not held by this process (it holds shards "
                             f"{list(self.local_ids)} of {self.n_shards or len(self.blocks)})")
        reps = self.blocks[i]
        return reps[m] if len(reps) > 1 else reps[0]

    def with_blocks(self, blocks) -> "Sharded":
        """The same placement over new blocks (``blocks[i]`` for shard
        ``first + i``)."""
        return dataclasses.replace(self, blocks=tuple(tuple(reps) for reps in blocks))

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Sharded":
        return self.with_blocks(tuple(fn(b) for b in reps) for reps in self.blocks)

    def gather(self) -> torch.Tensor:
        """The global array on the first device: blocks in shard order (the
        all-gather GSPMD inserts where a global value is needed; over
        processes a gloo all-gather taking each row from its owner,
        COLLECTIVE). Always a fresh tensor."""
        dev = self.device
        blocks = [reps[0].to(dev) for reps in self.blocks]
        if self.spans_processes:
            from distributed_active_learning_tpu_torch.parallel.collectives import owner_gather

            blocks = owner_gather(blocks, self.spread)
        return torch.cat(blocks)[: self.n_rows]


def gather(a) -> torch.Tensor:
    """A global tensor from a :class:`Sharded` (a tensor passes through)."""
    return a.gather() if isinstance(a, Sharded) else a


def shard_rows(a: torch.Tensor, mesh: Mesh, replicate: bool = False) -> Sharded:
    """Split ``a``'s rows into ``data`` contiguous blocks, padding the end
    with zeros (False for masks) to a multiple of the axis. Block ``s`` lies
    on ``mesh.devices[s][0]``, or on every device of row ``s`` with
    ``replicate``. Over several processes ``a`` is the same logical value
    on every rank, and each keeps its own rows' blocks (:func:`global_put`):
    on each of its cells' devices with ``replicate``, else on its first
    cell's, so that every rank of a row holds the row."""
    if isinstance(a, Sharded):
        return a
    n = a.shape[0]
    n_data = mesh.shape[AXIS_DATA]
    pad = (-n) % n_data
    if pad:
        a = torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
    n_local = a.shape[0] // n_data
    blocks = []
    for i, row in enumerate(mesh.devices):
        s = mesh.row0 + i
        blk = a[s * n_local:(s + 1) * n_local]
        devs = row if replicate else row[:1]
        blocks.append(tuple(blk.to(d) for d in devs))
    if mesh.n_procs > 1:
        return Sharded(tuple(blocks), n, first=mesh.row0, n_shards=n_data, spread=mesh.spread)
    return Sharded(tuple(blocks), n)


#: The placements :func:`global_put` takes, named after the JAX package's
#: specs: ``pool`` is ``P(data, None)`` (rows over data, each block on
#: every device of its row), ``mask`` is ``P(data)`` (each block on its
#: row's first device), ``replicated`` is ``P()``.
SPECS = ("pool", "mask", "replicated")


def global_put(a, mesh: Mesh, spec: str):
    """Place the host (or device) value ``a`` on ``mesh`` with ``spec`` (one
    of :data:`SPECS`), for a mesh over processes too: every rank holds the
    same logical value (the multi-controller model) and materialises only
    its own shards (the JAX package's ``make_array_from_callback``); a
    replicated value lies on this rank's first device. A PRNG key rides as
    its key data (the port's keys are their two uint32 words), so it is
    placed as any other tensor."""
    if spec not in SPECS:
        raise ValueError(f"unknown placement {spec!r}; one of {SPECS}")
    if isinstance(a, Sharded):
        return a
    t = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
    if spec == "replicated":
        return t.to(mesh.first)
    return shard_rows(t, mesh, replicate=spec == "pool")


def mesh_of(x: Sharded) -> Mesh:
    """The mesh a pool's features lie on (one replica a model device of
    this process's cells)."""
    devices = tuple(tuple(b.device for b in reps) for reps in x.blocks)
    if x.n_shards is None:
        return Mesh(devices)
    sp = x.spread
    return Mesh(devices, n_procs=sp.procs, rank=sp.rank, model=sp.model, data=sp.data)


def shard_fill_watermark(n_filled, n_pool: int, n_shards: int) -> torch.Tensor:
    """A global fill watermark split into the per-shard ``[S]`` int32 leaf.

    Shard ``s`` owns rows ``[s * rows, (s + 1) * rows)`` (``rows = n_pool //
    n_shards``), so a contiguously filled pool fills shard ``s`` to
    ``clip(n_filled - s * rows, 0, rows)``. The masks it induces
    (``PoolState.fill_mask``) equal the scalar's, and the global count is
    the sum (``runtime.state.filled_count``)."""
    rows = n_pool // n_shards
    n_filled = torch.as_tensor(n_filled, dtype=torch.int32)
    base = torch.arange(n_shards, dtype=torch.int32, device=n_filled.device) * rows
    return torch.clamp(n_filled - base, 0, rows).to(torch.int32)


def shard_pool_state(state, mesh: Mesh):
    """Place the pool's rows over the data axis: each data shard's block of
    ``x`` on every device of its row, of ``oracle_y`` and ``labeled_mask`` on
    its first device. Pool sizes not divisible by the axis must be padded
    first (``runtime.state.pad_for_sharding``); this raises otherwise.

    A scalar fill watermark ``n_filled`` becomes the per-shard ``[S]`` leaf
    (:func:`shard_fill_watermark`) on the mesh's first device; an ``[S]``
    leaf is checked against the data axis and kept."""
    n = state.n_pool
    n_data = mesh.shape[AXIS_DATA]
    if n % n_data:
        raise ValueError(
            f"pool size {n} not divisible by data axis {n_data}; call "
            "runtime.state.pad_for_sharding first"
        )
    n_filled = state.n_filled
    if n_filled is not None:
        if n_filled.ndim == 0:
            n_filled = shard_fill_watermark(n_filled, n, n_data)
        elif tuple(n_filled.shape) != (n_data,):
            raise ValueError(
                f"per-shard n_filled leaf {tuple(n_filled.shape)} does not match the data "
                f"axis ({n_data} shards)")
        n_filled = n_filled.to(mesh.first)
    return state.replace(
        x=shard_rows(gather(state.x), mesh, replicate=True),
        oracle_y=shard_rows(gather(state.oracle_y), mesh),
        labeled_mask=shard_rows(gather(state.labeled_mask), mesh),
        n_filled=n_filled,
    )


def forest_tree_specs(forest, mesh: Mesh) -> Tuple[slice, ...]:
    """The trees each model shard holds: contiguous tree ranges in order,
    applied to the leading (tree) axis of every forest field. The one source
    of the "tree axis first, rest replicated" rule."""
    n_model = mesh.shape[AXIS_MODEL]
    T = forest.n_trees
    if T % n_model:
        raise ValueError(f"n_trees={T} not divisible by mesh model axis {n_model}")
    per = T // n_model
    return tuple(slice(m * per, (m + 1) * per) for m in range(n_model))


def _map_fields(forest, fn):
    """Apply ``fn`` to every tensor field of a forest dataclass (nested
    forests included), building a fresh instance."""
    changes = {}
    for f in dataclasses.fields(forest):
        v = getattr(forest, f.name)
        if torch.is_tensor(v):
            changes[f.name] = fn(v)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _map_fields(v, fn)
    return dataclasses.replace(forest, **changes)


@dataclasses.dataclass(frozen=True)
class ShardedForest:
    """A forest placed on a mesh for per-shard evaluation: ``shards[s][m]``
    is model shard ``m``'s trees on ``mesh.devices[s][m]`` (a grid from
    :func:`shard_forest`), each of one evaluation form (gemm or gather;
    ``ops.trees_pallas.ShardedPallasForest`` is the leaf kernel's). Each
    shard evaluates its trees on its row block (``parallel.kernels``), as
    the JAX package's ``shard_map`` does; GSPMD partitions the plain forms
    the same way there."""

    shards: tuple
    mesh: Mesh

    @property
    def n_trees(self) -> int:
        return self.shards[0][0].n_trees * self.mesh.shape[AXIS_MODEL]


def shard_forest(forest, mesh: Mesh):
    """A ``[data][model]`` grid of forests: model shard ``m``'s trees on
    ``mesh.devices[s][m]`` for every data shard ``s`` (replicated over
    data, as ``P(model, None)``); over processes, this process's cells
    only, each holding its global model shard's trees (row ``i``'s cells
    from ``mesh.col_offsets[i]`` on). A device-fit forest's heap path and
    targets stay broadcasts of each device's own constant
    (``trees_train.to_device``), so no device checks them by value. A
    multiclass :class:`~..ops.trees_multi.MultiForest` shards plane by
    plane (a ``MultiForest`` of grids)."""
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest

    if isinstance(forest, MultiForest):
        return MultiForest(planes=tuple(shard_forest(p, mesh) for p in forest.planes))
    specs = forest_tree_specs(forest, mesh)
    return tuple(
        tuple(_map_fields(forest, lambda t, sl=specs[c0 + j], d=dev: to_device(t[sl], d))
              for j, dev in enumerate(row))
        for row, c0 in zip(mesh.devices, mesh.col_offsets)
    )


def constrain_forest(forest, mesh: Mesh):
    """:func:`shard_forest` for a forest fitted inside a round step (the
    chunked driver's in-step fit, ``runtime/loop.py`` ``make_chunk_fn``):
    the same placement, spelled with no host sync and no upload, so a CUDA
    graph can capture it. On one card every shard's trees are views of the
    fitted forest; across cards they are device-to-device copies queued on
    the current streams."""
    return shard_forest(forest, mesh)
