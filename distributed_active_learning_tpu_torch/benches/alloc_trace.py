"""The caching allocator's own trace of the pre-flight's programs, beside
what the pre-flight prices for them.

The programs are ``chip_smoke.py`` phase 4t's: the forest chunk's round
step at the bench width, 4n's CNN chunk step, 4o (b)'s serving capacity
of 291,840 rows and 4i's LAL round (a 200 x depth-10 regressor, captured
as a graph of one round). Each is priced on the meta device
(``analysis.memory.program_memory``), built on the card from the seed, run
once eagerly on a side stream (kernels, cuBLAS's per-stream workspace), then
run again eagerly and captured as ``GraphedChunk`` does, each under
``torch.cuda.memory._record_memory_history``. The allocations of each
trace go through ``memory.PoolModel`` (the allocator as the pre-flight
models it) and are set against the graph's captured private pool.

Printed per program: the allocations of the eager step and of the capture,
the captured pool, ``PoolModel`` over the capture's own trace, the
pre-flight's pool (with ``memory.POOL_HEADROOM``) and peak against
``max_memory_allocated``, and the source lines whose eager allocations add
up to the most bytes. The last line is one JSON object of the same numbers.

Run: ``python -m distributed_active_learning_tpu_torch.benches.alloc_trace
[--seed 0] [--programs forest cnn serve lal]``. Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import subprocess

import torch

TOP = 8  # source lines listed by bytes allocated
_PACKAGE = "distributed_active_learning_tpu_torch"


def _programs(seed: int) -> dict:
    from distributed_active_learning_tpu_torch.analysis import programs
    from distributed_active_learning_tpu_torch.runtime import loop, neural_loop

    return {
        "forest": (programs.forest_program("chunk", programs.BENCH_CONFIG, programs.BENCH_SHAPES,
                                           seed=seed), loop.CARRY_FIELDS),
        "cnn": (programs.neural_chunk_program(programs.CNN_SHAPES, seed=seed),
                neural_loop.NEURAL_CARRY_FIELDS),
        "serve": (programs.serve_program("serve_chunk", programs.serve_config(8),
                                         programs.SERVE_CONFIG, 291_840, 30, 85_443, seed=seed),
                  loop.CARRY_FIELDS),
        "lal": (round_step(programs.forest_program("round", lal_round_config(),
                                                   programs.BENCH_SHAPES, seed=seed)),
                loop.CARRY_FIELDS, ()),
    }


def lal_round_config():
    """4i's LAL round: the headline forest unfused, a round a launch, the
    regressor of the options' defaults (200 trees of depth 10)."""
    import dataclasses

    from distributed_active_learning_tpu_torch.analysis import programs
    from distributed_active_learning_tpu_torch.config import StrategyConfig

    return dataclasses.replace(programs.BENCH_CONFIG, fused_round=False, rounds_per_launch=1,
                               strategy=StrategyConfig(name="lal", window_size=100))


def round_step(make):
    """A round program as a graph's step: ``(new_state, the rest)``."""
    from distributed_active_learning_tpu_torch.analysis import programs

    def make_step(device):
        unit = make(device)
        return programs.ProgramUnit(lambda *a: (lambda r: (r[0], r[1:]))(unit.fn(*a)),
                                    unit.args)

    return make_step


def _line(event: dict) -> str:
    """The innermost frame of the port (or of ``torch.nn``) that made the
    allocation."""
    for f in event.get("frames", []):
        name = f.get("filename", "")
        if _PACKAGE in name or "torch/nn" in name:
            return f"{name.rsplit('/', 1)[-1]}:{f.get('line')}"
    return "?"


def _recorded(body):
    """``body()``'s allocator events on the current card."""
    torch.cuda.memory._record_memory_history(max_entries=4_000_000, stacks="python")
    try:
        body()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(None)
    return snap, snap["device_traces"][torch.cuda.current_device()]


def _replay(events) -> int:
    """The bytes ``PoolModel`` reserves for these allocations and frees."""
    from distributed_active_learning_tpu_torch.analysis.memory import PoolModel

    pool, live = PoolModel(), {}
    for e in events:
        if e["action"] == "alloc":
            live[e["addr"]] = pool.alloc(e["size"])
        elif e["action"] == "free_completed" and e["addr"] in live:
            pool.free(live.pop(e["addr"]))
    return pool.reserved


def trace_program(name: str, make, fields, input_args=(6,)) -> dict:
    from distributed_active_learning_tpu_torch.analysis import memory
    from distributed_active_learning_tpu_torch.runtime import loop

    meta = make(torch.device("meta"))
    pred = memory.program_memory(meta.fn, *meta.args)
    del meta
    unit = make(torch.device("cuda", torch.cuda.current_device()))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        unit.fn(*unit.args)  # warm-up
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    inputs = sum(memory.block_bytes(n) for n in {
        t.untyped_storage()._cdata: t.untyped_storage().nbytes()
        for t in memory.tensor_leaves(unit.args) if t.is_cuda}.values())
    torch.cuda.reset_peak_memory_stats()

    def eager_step():
        with torch.cuda.stream(side):
            unit.fn(*unit.args)

    _, eager = _recorded(eager_step)
    peak = torch.cuda.max_memory_allocated() - base + inputs
    gc.collect()
    torch.cuda.empty_cache()
    graph = loop.GraphedChunk(loop.chunk_of(unit.fn, lambda rows, *a: (None, rows), 1),
                              input_args=input_args, carry_fields=fields)
    snap, captured = _recorded(lambda: graph.capture(*unit.args, stream=side, warm_up=False))
    segments = [(s["address"], s["total_size"]) for s in snap["segments"]
                if tuple(s.get("segment_pool_id", ())) == tuple(graph._graph.pool())]
    pool = sum(size for _, size in segments)
    in_pool = [e for e in captured if any(a <= e["addr"] < a + n for a, n in segments)]
    by_line = collections.Counter()
    for e in eager:
        if e["action"] == "alloc":
            by_line[_line(e)] += e["size"]
    row = {
        "eager_allocations": sum(e["action"] == "alloc" for e in eager),
        "capture_allocations": sum(e["action"] == "alloc" for e in in_pool),
        "captured_pool_bytes": pool,
        "pool_model_over_capture_bytes": _replay(in_pool),
        "pool_model_over_eager_bytes": _replay(eager),
        "priced_pool_bytes": pred["pool_bytes"],
        "priced_peak_bytes": pred["peak_hbm_bytes"],
        "measured_peak_bytes": peak,
        "top_lines_mib": {k: round(v / 2**20, 1) for k, v in by_line.most_common(TOP)},
    }
    del graph, unit
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> dict:
    from distributed_active_learning_tpu_torch.device import deterministic_cuda, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--programs", nargs="*", default=["forest", "cnn", "serve"])
    args = ap.parse_args(argv)
    resolve_device("cuda")
    deterministic_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    progs = _programs(args.seed)
    out = {"card": card, "torch": torch.__version__, "programs": {}}
    for name in args.programs:
        row = out["programs"][name] = trace_program(name, *progs[name])
        mib = {k: round(v / 2**20, 1) for k, v in row.items() if k.endswith("_bytes")}
        print(f"# {name}: allocations eager {row['eager_allocations']}, capture "
              f"{row['capture_allocations']}; pool captured {mib['captured_pool_bytes']} MiB, "
              f"PoolModel over the capture's trace {mib['pool_model_over_capture_bytes']}, over "
              f"the eager trace {mib['pool_model_over_eager_bytes']}, priced "
              f"{mib['priced_pool_bytes']}; peak priced {mib['priced_peak_bytes']} against "
              f"{mib['measured_peak_bytes']} ({card})", flush=True)
        print(f"#   the most bytes allocated by line: {row['top_lines_mib']}", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
