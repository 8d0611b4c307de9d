"""The round megakernel: forest eval -> acquisition score -> per-tile top-k
in one pass over the pool (the port of ``ops/round_fused.py``).

- ``PallasForest`` on a CUDA tensor: ``csrc/round_megakernel.cu``, which
  replaces the Pallas ``_mega_kernel``. Votes stay in registers; neither the
  ``[n, T]`` leaf matrix nor the score vector reaches device memory. Each
  128-row tile yields its top ``min(k, 128)`` candidates, merged by
  ``ops.topk.merge_tile_topk`` (plain PyTorch, as it is plain XLA there).
- ``PallasForest`` on a CPU tensor: :func:`megakernel_plain`, the same
  function in plain PyTorch (plain K1, votes, score, mask, a stable top-k per
  tile).
- ``GemmForest`` (and pallas forests past the tile limits):
  :func:`_xla_streamed`, the exact gemm tile body per row tile.

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

from typing import Dict, Tuple

import torch

from distributed_active_learning_tpu_torch import kernels
from distributed_active_learning_tpu_torch.ops import scoring, trees_pallas
from distributed_active_learning_tpu_torch.ops.topk import NEG_INF, merge_tile_topk, stable_top_k
from distributed_active_learning_tpu_torch.ops.trees_gemm import GemmForest, _predict_chunk
from distributed_active_learning_tpu_torch.ops.trees_pallas import PallasForest

# Launches of csrc/round_megakernel.cu, counted where the kernel is launched.
launches = 0
# Calls routed to the gemm stream (gemm forests, or past the tile limits).
stream_route_calls = 0

# Rows per megakernel tile (csrc/forest_eval.cuh ROWS).
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
    """Vote counts -> directed score: ``p = votes / T`` (f32, in the JAX
    package's reciprocal form, :func:`.scoring.div_const`), the strategy's
    scoring function, negated for ascending strategies so every caller
    maximizes."""
    score_fn, higher = FUSED_STRATEGIES[strategy_name]
    p = scoring.div_const(votes_f32, n_trees)
    s = score_fn(p)
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


def megakernel_plain(gf: GemmForest, x, selectable, table: torch.Tensor, k: int):
    """The plain PyTorch version of the megakernel: plain K1 leaves, hard
    votes, the score table, the selectable mask, then a stable top-``k``
    per 128-row tile with pool-level indices."""
    leaves = trees_pallas.predict_leaves_plain(gf, x)
    votes = (leaves > 0.5).sum(dim=1)
    work = _tile_work(votes, selectable, table)
    kk = min(k, TILE_ROWS)
    v, i = stable_top_k(work, kk)
    base = torch.arange(work.shape[0], device=x.device)[:, None] * TILE_ROWS
    return v, (i + base).to(torch.int32)


def _launch_megakernel(ops, x, selectable, table, k: int):
    """Launch csrc/round_megakernel.cu: ``([n_tiles, kk] f32, [n_tiles, kk]
    int32)`` per-tile candidates."""
    global launches
    sel = selectable.to(torch.bool).contiguous()
    table = table.to(torch.float32).contiguous()
    x = trees_pallas._check_x(x, ops, sel, table)
    n, d = x.shape
    T = ops.feat.shape[0]
    kk = min(k, TILE_ROWS)
    ni = -(-n // TILE_ROWS)
    if sel.shape != (n,) or table.shape != (T + 1,):
        raise ValueError("selectable must be [n] and the score table [T + 1]")
    vals = torch.empty(ni, kk, dtype=torch.float32, device=x.device)
    idx = torch.empty(ni, kk, dtype=torch.int32, device=x.device)
    lib = kernels.load("round_megakernel")
    with torch.cuda.device(x.device):
        err = lib.round_megakernel(
            x.data_ptr(), n, d,
            ops.feat.data_ptr(), ops.thr.data_ptr(), ops.plus.data_ptr(), ops.minus.data_ptr(),
            ops.tgt.data_ptr(), ops.val.data_ptr(), T, ops.i_pad, ops.n_leaves,
            sel.data_ptr(), table.data_ptr(), kk, vals.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check("round_megakernel", err)
    launches += 1
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
    if x.device.type == "cuda":
        return _launch_megakernel(forest.operands, x, selectable, table, k)
    if x.device.type == "cpu":
        return megakernel_plain(gf, x, selectable, table, k)
    raise ValueError(f"unsupported device {x.device}")


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
