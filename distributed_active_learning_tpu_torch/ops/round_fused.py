"""The round megakernel: forest eval -> acquisition score -> per-tile top-k
in one pass over the pool (the port of ``ops/round_fused.py``).

- ``PallasForest`` on a CUDA tensor: ``csrc/round_megakernel.cu``, which
  replaces the Pallas ``_mega_kernel``. It walks the forest's heap form
  (``trees_pallas.HeapOperands``, shared with K1) held in shared memory
  (``csrc/heap_votes.cuh``); votes stay on chip, and neither the ``[n, T]``
  leaf matrix nor the score vector reaches device memory. Each 128-row tile
  yields its top ``min(k, 128)`` candidates, merged by
  ``ops.topk.merge_tile_topk`` (plain PyTorch, as it is plain XLA there). A
  forest that is not made of complete heap trees raises ``ValueError``.
- ``PallasForest`` on a CPU tensor: :func:`megakernel_plain`, the same
  function in plain PyTorch (plain K1, votes, score, mask, a stable top-k per
  tile). :func:`walk_votes_plain` is the kernels' own arithmetic (the walk,
  then the packed vote bits), for holding them on the card.
- ``GemmForest`` (and pallas forests past the tile limits):
  :func:`_xla_streamed`, the exact gemm tile body per row tile.
- ``ShardedPallasForest`` (a device mesh): :func:`_sharded_score_select`
  (a gemm forest on a mesh takes the same path with its exact votes).
  Each (data, model) shard counts its tree shard's votes on its row block
  with ``csrc/fused_votes.cu`` (K3, replacing the Pallas ``_votes_kernel``:
  the same heap walk as K2, its votes stored as ``[n]`` int32),
  a sum over ``model`` completes them, each data shard scores its block and
  keeps its stable top-k window, and the windows merge on the data ring
  (``ops/ring_topk.py``, K4 once per sending device and ring step).

The merge is exact for any tile width as long as each tile gives its
``min(k, tile rows)`` best in (value descending, index ascending) order, so
every route returns the same ``(vals, idx)`` as a stable top-k over the full
masked score vector whenever at least ``k`` rows are selectable.

Scores. Votes are integers in ``[0, T]``, so a strategy's score takes T + 1
values; the megakernel and its plain version look them up in a table the
wrapper computes with :mod:`.scoring` on ``arange(T + 1) / T``
(``_score_from_votes``). No transcendental runs in the kernel, so
entropy scores cannot drift between the kernel and its plain version.
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import torch

from distributed_active_learning_tpu_torch import kernels
from distributed_active_learning_tpu_torch.analysis import costs
from distributed_active_learning_tpu_torch.ops import ring_topk, scoring, trees_pallas
from distributed_active_learning_tpu_torch.ops.topk import NEG_INF, merge_tile_topk, stable_top_k
from distributed_active_learning_tpu_torch.ops.trees_gemm import (
    GemmForest,
    _predict_chunk,
    predict_leaves_gemm,
)
from distributed_active_learning_tpu_torch.ops.trees_pallas import PallasForest, ShardedPallasForest
from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib
from distributed_active_learning_tpu_torch.parallel.collectives import row_accumulate
from distributed_active_learning_tpu_torch.parallel.kernels import join_blocks, per_shard

# Launches of csrc/round_megakernel.cu, counted where the kernel is launched.
launches = 0
# Launches of csrc/fused_votes.cu (K3), counted where the kernel is launched.
votes_launches = 0
# K3 calls routed to the gemm form because the forest exceeds the tile limits.
votes_gemm_route_calls = 0
# Calls routed to the gemm stream (gemm forests, or past the tile limits).
stream_route_calls = 0

# Rows per megakernel tile, each giving its top min(k, TILE_ROWS) candidates:
# the kernel's row tile (csrc/heap_votes.cuh TILE) and megakernel_plain's.
TILE_ROWS = 128

#: Strategies the fused round serves: binary scores that are pure functions
#: of the hard vote fraction (``score_fn, higher_is_better``).
FUSED_STRATEGIES: Dict[str, Tuple] = {
    "uncertainty": (scoring.uncertainty_score, False),
    "entropy": (scoring.positive_entropy, True),
    "full_entropy": (scoring.full_entropy, True),
    "margin": (scoring.margin_score, False),
}


def supports(strategy_name: str) -> bool:
    return strategy_name in FUSED_STRATEGIES


def _score_from_votes(votes_f32: torch.Tensor, n_trees: int, strategy_name: str):
    """Vote counts -> directed score: ``p = votes / T`` as a
    :class:`.scoring.VoteFraction` (the unfused strategies' spelling), the
    strategy's scoring function, negated for ascending strategies so every
    caller maximizes."""
    score_fn, higher = FUSED_STRATEGIES[strategy_name]
    s = score_fn(scoring.VoteFraction(votes_f32, n_trees))
    return (s if higher else -s), higher


def score_table(n_trees: int, strategy_name: str, device) -> torch.Tensor:
    """Directed score of every vote count ``0..T`` (``[T + 1]`` f32)."""
    v = torch.arange(n_trees + 1, dtype=torch.float32, device=device)
    return _score_from_votes(v, n_trees, strategy_name)[0].contiguous()


def _stream_tile(n: int) -> int:
    """Row tile of the gemm stream: 2048, or one power of two for small
    pools."""
    return min(2048, max(256, 1 << max(n - 1, 1).bit_length()))


def _xla_streamed(gf: GemmForest, x, selectable, strategy_name: str, k: int):
    """Per-tile candidates from the exact gemm tile body (f32 compares)."""
    global stream_route_calls
    stream_route_calls += 1
    n = x.shape[0]
    T = gf.n_trees
    tile = _stream_tile(n)
    tv, ti = [], []
    for base in range(0, n, tile):
        xb = x[base:base + tile]
        sb = selectable[base:base + tile]
        votes = (_predict_chunk(gf, xb) > 0.5).sum(dim=1, dtype=torch.int32)
        s, _ = _score_from_votes(votes.to(torch.float32), T, strategy_name)
        work = torch.where(sb, s, torch.full_like(s, NEG_INF))
        pad = tile - work.shape[0]
        if pad:  # padding rows are unselectable (-inf)
            work = torch.cat([work, work.new_full((pad,), NEG_INF)])
        v, i = stable_top_k(work, k)
        tv.append(v)
        ti.append(i + base)
    return torch.stack(tv), torch.stack(ti)


def _tile_work(votes: torch.Tensor, selectable: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``[n_tiles, TILE_ROWS]`` directed scores, -inf where unselectable or
    past the pool (the kernel's ``table[votes] + pen``)."""
    n = votes.shape[0]
    pen = torch.where(selectable, 0.0, NEG_INF).to(torch.float32)
    work = table[votes.long()] + pen
    pad = (-n) % TILE_ROWS
    if pad:
        work = torch.cat([work, work.new_full((pad,), NEG_INF)])
    return work.reshape(-1, TILE_ROWS)


def tile_topk_plain(votes: torch.Tensor, selectable, table: torch.Tensor, k: int):
    """The megakernel's select in plain PyTorch: the score table at the
    votes, the selectable mask, then a stable top-``k`` per 128-row tile
    with pool-level indices."""
    work = _tile_work(votes, selectable, table)
    kk = min(k, TILE_ROWS)
    v, i = stable_top_k(work, kk)
    base = torch.arange(work.shape[0], device=votes.device)[:, None] * TILE_ROWS
    return v, (i + base).to(torch.int32)


def megakernel_plain(gf: GemmForest, x, selectable, table: torch.Tensor, k: int):
    """The plain PyTorch version of the megakernel: plain K1 leaves, hard
    votes, then :func:`tile_topk_plain`."""
    return tile_topk_plain(fused_votes_plain(gf, x), selectable, table, k)


def vote_bits(ops: trees_pallas.HeapOperands) -> torch.Tensor:
    """``[T, W]`` int64 words of vote bits, ``W = ceil(2^depth / 32)``: bit
    ``l % 32`` of word ``l // 32`` is ``val[t, l] > 0.5`` (the value widened
    from its storage dtype), as the kernels pack them with one ballot per 32
    leaves while they stage a tree."""
    L = 1 << ops.depth
    W = -(-L // 32)
    hit = torch.nn.functional.pad(ops.values()[:, :L] > 0.5, (0, 32 * W - L))
    shifts = torch.arange(32, device=hit.device, dtype=torch.int64)
    return (hit.reshape(ops.n_trees, W, 32).to(torch.int64) << shifts).sum(-1)


def packed_thresholds(ops: trees_pallas.HeapOperands) -> torch.Tensor:
    """``[T, I]`` f32: each threshold as the kernels pack it into a 4-byte
    node, the largest bf16 value not above it (a NaN stays a NaN). A bf16
    feature compares ``<=`` with it exactly as with the threshold."""
    t = ops.thr.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = t & 0xFFFF0000
    hi = torch.where(((t & 0x80000000) != 0) & ((t & 0xFFFF) != 0), hi + 0x10000, hi)
    hi = torch.where((t & 0x7FFFFFFF) > 0x7F800000, 0x7FC00000, hi)
    return torch.where(hi >= 2**31, hi - 2**32, hi).to(torch.int32).view(torch.float32)


def walk_votes_plain(ops: trees_pallas.HeapOperands, x: torch.Tensor) -> torch.Tensor:
    """K2's and K3's arithmetic in plain PyTorch: ``[n]`` int32 hard votes
    from the walk over the heap operands with the thresholds packed as the
    kernels pack them (:func:`packed_thresholds`) and the vote bits of the
    leaves it reaches (:func:`vote_bits`)."""
    bits = vote_bits(ops)
    tree = torch.arange(ops.n_trees, device=x.device)
    out = [((bits[tree, leaf >> 5] >> (leaf & 31)) & 1).sum(dim=1, dtype=torch.int32)
           for leaf in trees_pallas.walk_leaf_ids(ops, x, packed_thresholds(ops))]
    return torch.cat(out)


def _heap_args(ops: trees_pallas.HeapOperands):
    return (ops.nodes.data_ptr(), ops.val.data_ptr(), ops.payload, ops.n_trees, ops.depth,
            ops.nodes.shape[1], ops.val.shape[1])


def launch_config(name: str, ops: trees_pallas.HeapOperands, n: int, d: int, device) -> dict:
    """The configuration ``name`` ("round_megakernel" or "fused_votes")
    launches with for ``n`` rows of ``d`` features on ``device``: its mode
    (the forest resident in shared memory, or streamed in tree chunks), the
    groups of 128 threads a block, trees a chunk, shared memory bytes a
    block, the persistent grid and the blocks a multiprocessor holds, at the
    forest's leaf payload (a streamed stage holds the payload at its width)."""
    import ctypes

    got = (ctypes.c_int * 6)()
    lib = kernels.load(name)
    with torch.cuda.device(device):
        err = getattr(lib, f"{name}_config")(n, d, *_heap_args(ops)[2:], got)
    kernels.check(f"{name}_config", err)
    cfg = dict(zip(("mode", "groups", "trees_per_chunk", "smem_bytes", "grid", "blocks_per_sm"),
                   list(got)))
    cfg["mode"] = ("resident", "streamed")[cfg["mode"]]
    return cfg


def _launch_megakernel(ops: trees_pallas.HeapOperands, x, selectable, table, k: int):
    """Launch csrc/round_megakernel.cu: ``([n_tiles, kk] f32, [n_tiles, kk]
    int32)`` per-tile candidates."""
    sel = selectable.to(torch.bool).contiguous()
    table = table.to(torch.float32).contiguous()
    x = trees_pallas._check_x(x, ops, sel, table)
    n, d = x.shape
    kk = min(k, TILE_ROWS)
    ni = -(-n // TILE_ROWS)
    if sel.shape != (n,) or table.shape != (ops.n_trees + 1,):
        raise ValueError("selectable must be [n] and the score table [T + 1]")
    vals = torch.empty(ni, kk, dtype=torch.float32, device=x.device)
    idx = torch.empty(ni, kk, dtype=torch.int32, device=x.device)
    lib = kernels.load("round_megakernel")
    with torch.cuda.device(x.device):
        err = lib.round_megakernel(
            x.data_ptr(), n, d, *_heap_args(ops), sel.data_ptr(), table.data_ptr(), kk,
            vals.data_ptr(), idx.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check("round_megakernel", err)
    kernels.count_launch(sys.modules[__name__])
    return vals, idx


def _megakernel(forest: PallasForest, x, selectable, strategy_name: str, k: int):
    """Per-row-tile top-k candidates in one pass over the pool."""
    gf = forest.gf
    n, d = x.shape
    dims = trees_pallas.tile_dims(gf, n, d)
    if dims is None:
        # The JAX package's boundary: past the tile limits, the gemm stream.
        return _xla_streamed(gf, x, selectable, strategy_name, k)
    bn = dims[3]
    if k > bn:
        # Refused as the JAX megakernel refuses it, so both packages refuse
        # the same configurations.
        raise ValueError(f"window {k} exceeds the row tile ({bn})")
    table = score_table(gf.n_trees, strategy_name, x.device)
    ni, kk = -(-n // TILE_ROWS), min(k, TILE_ROWS)

    def cost():
        trees, depth, item = trees_pallas.heap_shape(forest)
        return costs.round_megakernel(n, d, trees, depth, k, item)

    with kernels.kernel_work("round_megakernel", cost,
                             lambda: trees_pallas.launch_shape(forest, n, d)):
        if x.device.type == "cuda":
            return _launch_megakernel(forest.heap, x, selectable, table, k)
        if x.device.type == "cpu":
            # Laid out as the kernel writes them, so what follows runs the
            # same operations on either route.
            return tuple(t.contiguous() for t in megakernel_plain(gf, x, selectable, table, k))
        if x.device.type == "meta":
            forest.heap
            return (torch.empty(ni, kk, dtype=torch.float32, device=x.device),
                    torch.empty(ni, kk, dtype=torch.int32, device=x.device))
    raise ValueError(f"unsupported device {x.device}")


def fused_votes_plain(gf: GemmForest, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3: ``[n]`` int32 hard votes from the
    plain K1 leaves."""
    return (trees_pallas.predict_leaves_plain(gf, x) > 0.5).sum(dim=1, dtype=torch.int32)


def _launch_votes(ops: trees_pallas.HeapOperands, x: torch.Tensor):
    """Launch csrc/fused_votes.cu: ``[n]`` int32 hard votes."""
    x = trees_pallas._check_x(x, ops)
    n, d = x.shape
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    lib = kernels.load("fused_votes")
    with torch.cuda.device(x.device):
        err = lib.fused_votes(
            x.data_ptr(), n, d, *_heap_args(ops), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check("fused_votes", err)
    kernels.count_launch(sys.modules[__name__], "votes_launches")
    return out


def fused_votes(forest, x: torch.Tensor) -> torch.Tensor:
    """Hard vote counts ``[n]`` int32 of a :class:`PallasForest` (or a bare
    :class:`GemmForest`) without the ``[n, T]`` leaf matrix: K3 for a CUDA
    tensor, its plain version for a CPU one, and past the tile limits the
    JAX package's named branch, the exact gemm eval (votes are integers, so
    every route agrees bit for bit)."""
    global votes_gemm_route_calls
    gf = forest.gf if isinstance(forest, PallasForest) else forest
    n, d = x.shape
    if trees_pallas.tile_dims(gf, n, d) is None:
        votes_gemm_route_calls += 1
        return (predict_leaves_gemm(gf, x) > 0.5).sum(dim=1, dtype=torch.int32)
    with kernels.kernel_work("fused_votes",
                             lambda: costs.fused_votes(n, d, *trees_pallas.heap_shape(forest)),
                             lambda: trees_pallas.launch_shape(forest, n, d)):
        if x.device.type == "cuda":
            return _launch_votes(trees_pallas.heap_operands_of(forest), x)
        if x.device.type == "cpu":
            return fused_votes_plain(gf, x)
        if x.device.type == "meta":
            trees_pallas.heap_operands_of(forest)
            return torch.empty(n, dtype=torch.int32, device=x.device)
    raise ValueError(f"unsupported device {x.device}")


def _exact_votes(forest, x: torch.Tensor) -> torch.Tensor:
    """Hard votes of a gemm or gather form: the exact f32 compare of the
    JAX package's streamed gemm round (no kernel there either)."""
    from distributed_active_learning_tpu_torch.ops import forest_eval

    return forest_eval.votes(forest, x)


def _vote_blocks(f, x):
    """Votes on each (row block, tree shard) cell this process holds, one
    sum over ``model`` per row block (across the row group where a row
    spans processes): the votes of each of this process's data shards on
    its first device, and the logical row count. K3 for the leaf kernel's
    shards; a gemm forest's shards count their exact votes (the JAX package
    runs its streamed gemm round on such a forest)."""
    local = fused_votes if isinstance(f, ShardedPallasForest) else _exact_votes
    grid, n = per_shard(f, x, local)
    sp = f.mesh.spread
    return [row_accumulate(row, sp, s) for s, row in zip(sp.rows, grid)], n


def _sharded_fused_votes(f: ShardedPallasForest, x) -> torch.Tensor:
    """Global vote counts ``[n]`` on the mesh's first device, the blocks
    joined in shard order."""
    blocks, n = _vote_blocks(f, x)
    return join_blocks(blocks, f.mesh, n)


def _sharded_score_select(f, x, selectable, strategy_name: str, k: int):
    """Fully distributed fused selection: per-shard K3 votes, one sum over
    ``model``, then per data shard the score (the strategy's table), the
    masked stable top-``min(k, n_local)`` of its block with global indices,
    ``pad_window`` to ``k`` rows, and the ring merge over ``data``.

    In the JAX package every model column runs its own ring, because
    ``out_specs=P()`` replicates the result on every device. In one
    process, and over processes that hold whole rows, the port needs the
    result once a process, so one ring runs, over model column 0's cells;
    otherwise the rings of the columns ``Mesh.rings`` names run together
    (``Spread.ring_columns``: column 0, then the first column of each rank
    that holds no cell of those, so every rank holds a window of some ring
    and ends with the result, no broadcast needed). A rank puts its row's
    window in every ring that passes one of its cells; where its cells
    cross a row boundary it holds consecutive members of a ring, and may sit
    in two rings.
    Returns DIRECTED ``(vals [k], idx [k])`` on the mesh's first device.
    The blocks are contiguous index ranges in shard order, so the result
    equals the stable top-k of the global masked score vector, ties and the
    ``(-inf, IDX_SENTINEL)`` tail included.
    """
    sel = mesh_lib.shard_rows(selectable, f.mesh)  # pads False: unselectable
    blocks, _ = _vote_blocks(f, x)
    n_local = sel.n_local
    kk = min(k, n_local)
    table = score_table(f.n_trees, strategy_name, f.mesh.first)
    windows = {}
    for s, votes in zip(sel.local_ids, blocks):
        work = torch.where(sel.block(s), table.to(votes.device).index_select(0, votes), NEG_INF)
        loc_v, loc_i = stable_top_k(work, kk)
        glob_i = (loc_i + s * n_local).to(torch.int32)
        windows[s] = ring_topk.pad_window(loc_v, glob_i, k)
    if not sel.across_processes:
        return ring_topk.ring_topk(list(windows.values()), k)[0]
    rings = f.mesh.rings
    rank = f.mesh.rank
    mine = [windows[s] for ring in rings for s, r in enumerate(ring) if r == rank]
    return ring_topk.ring_topk(mine, k, members=rings)[0]


def fused_score_select(
    forest, x: torch.Tensor, selectable_mask: torch.Tensor, strategy_name: str, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused eval -> score -> select: ``(vals [k], picked [k])`` with the
    value/index contract of ``select_top_k`` / ``select_bottom_k`` over the
    unfused score vector (ascending strategies' values un-negated)."""
    if strategy_name not in FUSED_STRATEGIES:
        raise ValueError(
            f"strategy {strategy_name!r} has no fused round; fused: "
            f"{sorted(FUSED_STRATEGIES)}"
        )
    _, higher = FUSED_STRATEGIES[strategy_name]
    if isinstance(forest, mesh_lib.ShardedForest):
        vals, idx = _sharded_score_select(forest, x, selectable_mask, strategy_name, k)
        return (vals, idx) if higher else (-vals, idx)
    gf = forest.gf if isinstance(forest, PallasForest) else forest
    if not isinstance(gf, GemmForest):
        raise TypeError(
            "fused_score_select needs a path-matrix forest (gemm/pallas "
            f"kernels), got {type(forest).__name__}"
        )
    if isinstance(forest, PallasForest):
        tv, ti = _megakernel(forest, x, selectable_mask, strategy_name, k)
    else:
        tv, ti = _xla_streamed(gf, x, selectable_mask, strategy_name, k)
    vals, idx = merge_tile_topk(tv, ti, k)
    return (vals, idx) if higher else (-vals, idx)
