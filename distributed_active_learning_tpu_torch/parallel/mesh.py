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
same code moves real bytes. ``global_put`` (multi-process meshes),
``shard_fill_watermark`` (serving) and ``constrain_forest`` (the chunked
driver) wait for their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from distributed_active_learning_tpu_torch.ops.trees_train import to_device

AXIS_DATA = "data"
AXIS_MODEL = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``[data][model]`` grid of devices."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self):
        return {AXIS_DATA: len(self.devices), AXIS_MODEL: len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """The mesh's first device, where global results are gathered."""
        return self.devices[0][0]

    @property
    def ring(self) -> Tuple[torch.device, ...]:
        """The data ring: model column 0's device of every data shard."""
        return tuple(row[0] for row in self.devices)


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
    """
    kind = torch.device(device).type
    if devices is not None:
        devs = [_indexed(torch.device(d)) for d in devices]
    elif kind == "cpu":
        devs = [torch.device("cpu")] * ((data or 1) * model)
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
    if data * model > len(devs):
        raise ValueError(f"mesh {data}x{model} exceeds {len(devs)} devices")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh lies on one kind of device, got {devs}")
    grid = tuple(tuple(devs[s * model:(s + 1) * model]) for s in range(data))
    mesh = Mesh(grid)
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
    """A row-sharded array: ``blocks[s]`` holds data shard ``s``'s
    contiguous row block, once per device it is placed on (one replica per
    model device for the pool's features, as ``P(data, None)`` replicates
    them; one for masks and labels). ``n_rows`` is the logical row count;
    the last blocks may carry padding rows past it."""

    blocks: Tuple[Tuple[torch.Tensor, ...], ...]
    n_rows: int

    @property
    def shape(self):
        return (self.n_rows, *self.blocks[0][0].shape[1:])

    @property
    def device(self) -> torch.device:
        return self.blocks[0][0].device

    @property
    def n_local(self) -> int:
        return self.blocks[0][0].shape[0]

    def block(self, s: int, m: int = 0) -> torch.Tensor:
        reps = self.blocks[s]
        return reps[m] if len(reps) > 1 else reps[0]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Sharded":
        return Sharded(tuple(tuple(fn(b) for b in reps) for reps in self.blocks), self.n_rows)

    def gather(self) -> torch.Tensor:
        """The global array on the first device: blocks in shard order (the
        all-gather GSPMD inserts where a global value is needed)."""
        dev = self.device
        return torch.cat([reps[0].to(dev) for reps in self.blocks])[: self.n_rows]


def gather(a) -> torch.Tensor:
    """A global tensor from a :class:`Sharded` (a tensor passes through)."""
    return a.gather() if isinstance(a, Sharded) else a


def shard_rows(a: torch.Tensor, mesh: Mesh, replicate: bool = False) -> Sharded:
    """Split ``a``'s rows into ``data`` contiguous blocks, padding the end
    with zeros (False for masks) to a multiple of the axis. Block ``s`` lies
    on ``mesh.devices[s][0]``, or on every device of row ``s`` with
    ``replicate``."""
    if isinstance(a, Sharded):
        return a
    n = a.shape[0]
    n_data = mesh.shape[AXIS_DATA]
    pad = (-n) % n_data
    if pad:
        a = torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
    n_local = a.shape[0] // n_data
    blocks = []
    for s, row in enumerate(mesh.devices):
        blk = a[s * n_local:(s + 1) * n_local]
        devs = row if replicate else row[:1]
        blocks.append(tuple(blk.to(d) for d in devs))
    return Sharded(tuple(blocks), n)


def shard_pool_state(state, mesh: Mesh):
    """Place the pool's rows over the data axis: each data shard's block of
    ``x`` on every device of its row, of ``oracle_y`` and ``labeled_mask`` on
    its first device. Pool sizes not divisible by the axis must be padded
    first (``runtime.state.pad_for_sharding``); this raises otherwise."""
    n = state.n_pool
    n_data = mesh.shape[AXIS_DATA]
    if n % n_data:
        raise ValueError(
            f"pool size {n} not divisible by data axis {n_data}; call "
            "runtime.state.pad_for_sharding first"
        )
    return state.replace(
        x=shard_rows(gather(state.x), mesh, replicate=True),
        oracle_y=shard_rows(gather(state.oracle_y), mesh),
        labeled_mask=shard_rows(gather(state.labeled_mask), mesh),
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


def shard_forest(forest, mesh: Mesh):
    """A ``[data][model]`` grid of forests: model shard ``m``'s trees on
    ``mesh.devices[s][m]`` for every data shard ``s`` (replicated over
    data, as ``P(model, None)``). A device-fit forest's heap path and
    targets stay broadcasts of each device's own constant
    (``trees_train.to_device``), so no device checks them by value. A
    multiclass :class:`~..ops.trees_multi.MultiForest` shards plane by
    plane (a ``MultiForest`` of grids)."""
    from distributed_active_learning_tpu_torch.ops.trees_multi import MultiForest

    if isinstance(forest, MultiForest):
        return MultiForest(planes=tuple(shard_forest(p, mesh) for p in forest.planes))
    specs = forest_tree_specs(forest, mesh)
    return tuple(
        tuple(_map_fields(forest, lambda t, sl=specs[m], d=dev: to_device(t[sl], d))
              for m, dev in enumerate(row))
        for row in mesh.devices
    )
