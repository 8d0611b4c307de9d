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
C / P, (r + 1) * C / P)`` of the ``C = data * model``. A rank holds either
whole rows (``Mesh.devices`` holds its rows, ``Mesh.row0`` the first one's
global index) or a part of one row (``Mesh.row_procs`` ranks share each
row, ``Mesh.col0`` is its first model index), as one card a rank always
gives; a rank whose cells would cross a row boundary partway is refused by
name. A :class:`Sharded` holds only the blocks of this rank's rows (a
row's ranks each hold a replica), and :func:`global_put` places the same
logical host value on every rank by keeping the rank's own shards.
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
    """How a mesh's data axis lies over the job's processes: all that a
    collective needs of a placement. ``procs`` ranks in all; the
    ``row_procs`` ranks ``[g, g + row_procs)`` share the same data rows (a
    replica each, the first of them the rows' owner); ``rank`` is this
    process. ``Spread()`` is one process."""

    procs: int = 1
    row_procs: int = 1
    rank: int = 0

    @property
    def spans_rows(self) -> bool:
        """Whether other processes hold other data rows (a join or a sum
        over ``data`` then gathers from them)."""
        return self.procs > self.row_procs

    @property
    def row_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """Every row block's ranks, in row order: the job's row groups."""
        return tuple(tuple(range(g, g + self.row_procs))
                     for g in range(0, self.procs, self.row_procs))

    @property
    def owners(self) -> Tuple[int, ...]:
        """The ranks a join over ``data`` takes rows from, in row order: the
        first of each row's ranks, so that every row counts once."""
        return tuple(g[0] for g in self.row_groups)

    @property
    def row_block(self) -> int:
        """This rank's rows' place among the owners' equal parts of the data
        axis."""
        return self.rank // self.row_procs

    @property
    def row_ranks(self) -> Tuple[int, ...]:
        """The ranks that share this rank's rows: its row group, over which
        the sums over ``model`` run."""
        return self.row_groups[self.row_block]

    @property
    def column_ring(self) -> Tuple[int, ...]:
        """The ranks of this rank's model column in row order, one a row
        block: the ring over ``data`` (every rank when rows are whole)."""
        return tuple(range(self.rank % self.row_procs, self.procs, self.row_procs))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``[data][model]`` grid of devices. Over several processes
    (``n_procs > 1``) ``devices`` holds this process's cells of the global
    grid, row by row, ``rank`` the process's index and ``model`` the global
    model axis (0: a whole row, ``len(devices[0])``). A process holds whole
    rows, each process as many, or ``row_procs`` processes share each row,
    one part of it each."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    n_procs: int = 1
    rank: int = 0
    model: int = 0

    @property
    def row_procs(self) -> int:
        """The processes that share each data row (1: rows are whole)."""
        return self.model // len(self.devices[0]) if self.model else 1

    @property
    def spread(self) -> Spread:
        """How the data axis lies over the processes (the collectives'
        placement)."""
        return Spread(self.n_procs, self.row_procs, self.rank)

    @property
    def shape(self):
        return {AXIS_DATA: len(self.devices) * self.n_procs // self.row_procs,
                AXIS_MODEL: self.model or len(self.devices[0])}

    @property
    def row0(self) -> int:
        """The global data index of this process's first row."""
        return self.spread.row_block * len(self.devices)

    @property
    def col0(self) -> int:
        """The global model index of this process's first cell in a row."""
        return self.rank % self.row_procs * len(self.devices[0])

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
    def ring_members(self) -> Tuple[int, ...]:
        """The processes of this process's data ring in row order: its model
        column's ranks (every rank when rows are whole)."""
        return self.spread.column_ring


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
    holds whole rows or one part of a row; where its cells would cross a
    row boundary partway (``MeshConfig(2, 3)`` over 3 processes) the mesh is
    refused by name. When a row spans processes, every rank creates every
    row's process group here (``multihost.make_groups``).
    """
    from distributed_active_learning_tpu_torch.parallel import multihost

    multihost.maybe_initialize()
    n_procs = multihost.process_count()
    kind = torch.device(device).type
    per_row, rows = model, data  # this process's cells in each of its rows, its rows
    if n_procs > 1:
        data = n_procs if data is None else data
        cells = data * model
        if data < 1 or model < 1 or cells % n_procs:
            raise ValueError(f"mesh {data}x{model}: its {cells} cells do not divide over "
                             f"{n_procs} processes")
        per = cells // n_procs
        if per % model and model % per:
            raise NotImplementedError(
                f"mesh {data}x{model} over {n_procs} processes: each would hold {per} cells, "
                "which cross a data row boundary partway; a rank holds whole rows or one part "
                "of a row, and this layout is the remaining entry of ROADMAP queue 1 item 8 "
                "(\"Mesh and pod\")")
        per_row, rows = min(per, model), max(per // model, 1)
    if devices is not None:
        devs = [_indexed(torch.device(d)) for d in devices]
    elif kind == "cpu":
        devs = [torch.device("cpu")] * ((rows or 1) * per_row)
    elif kind == "cuda" and n_procs > 1:
        devs = [torch.device("cuda", multihost.local_device_index())] * (rows * per_row)
    elif kind == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if rows is None:
        if len(devs) % model:
            raise ValueError(f"{len(devs)} devices not divisible by model={model}")
        rows = data = len(devs) // model
    if rows < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model} needs positive axes")
    if rows * per_row > len(devs):
        raise ValueError(f"mesh {data}x{model} exceeds {len(devs)} devices")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh lies on one kind of device, got {devs}")
    grid = tuple(tuple(devs[s * per_row:(s + 1) * per_row]) for s in range(rows))
    mesh = Mesh(grid, n_procs=n_procs, rank=multihost.process_index(),
                model=model if n_procs > 1 else 0)
    if mesh.row_procs > 1:
        multihost.make_groups(mesh.spread.row_groups)
    if devs[0].type == "cuda":
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
        gathers)."""
        return self.n_shards is not None and self.n_shards > len(self.blocks)

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
        local = torch.cat([reps[0].to(dev) for reps in self.blocks])
        if self.spans_processes:
            from distributed_active_learning_tpu_torch.parallel.multihost import gather_rows

            return gather_rows(local, self.n_rows, self.spread.owners)
        return local[: self.n_rows]


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
    return Mesh(devices, n_procs=x.spread.procs, rank=x.spread.rank,
                model=len(devices[0]) * x.spread.row_procs)


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
    only, each holding its global model shard's trees. A device-fit forest's heap path and
    targets stay broadcasts of each device's own constant
    (``trees_train.to_device``), so no device checks them by value. A
    multiclass :class:`~..ops.trees_multi.MultiForest` shards plane by
    plane (a ``MultiForest`` of grids)."""
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest

    if isinstance(forest, MultiForest):
        return MultiForest(planes=tuple(shard_forest(p, mesh) for p in forest.planes))
    specs = forest_tree_specs(forest, mesh)
    return tuple(
        tuple(_map_fields(forest, lambda t, sl=specs[mesh.col0 + j], d=dev: to_device(t[sl], d))
              for j, dev in enumerate(row))
        for row in mesh.devices
    )


def constrain_forest(forest, mesh: Mesh):
    """:func:`shard_forest` for a forest fitted inside a round step (the
    chunked driver's in-step fit, ``runtime/loop.py`` ``make_chunk_fn``):
    the same placement, spelled with no host sync and no upload, so a CUDA
    graph can capture it. On one card every shard's trees are views of the
    fitted forest; across cards they are device-to-device copies queued on
    the current streams."""
    return shard_forest(forest, mesh)
