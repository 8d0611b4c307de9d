"""Command-line experiment driver of the port (a subset of the JAX package's
``run.py``, same flag names):

    python -m distributed_active_learning_tpu_torch.run \\
        --dataset checkerboard2x2 --fit device --kernel pallas --fused-round \\
        --strategy uncertainty --window 10 --rounds 5 --device cuda

Prints the reference-format log on stdout; ``--out`` writes it to a file.
``--device`` defaults to cuda and the run refuses to start without a card
unless ``--device cpu`` is given. ``--mesh-data D --mesh-model M`` shards
the pool's rows over D and the trees over M: on the first D x M cards, or
every shard on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

from distributed_active_learning_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ForestConfig,
    MeshConfig,
    StrategyConfig,
)

_STRATEGY_ALIASES = {"us": "uncertainty"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_active_learning_tpu_torch.run",
        description="pool-based active learning, PyTorch/CUDA port",
    )
    ap.add_argument("--dataset", default="checkerboard2x2")
    ap.add_argument("--n-samples", type=int, default=None, help="pool size")
    ap.add_argument("--strategy", default="uncertainty")
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument(
        "--kernel", choices=["gemm", "pallas", "gather"], default="gemm",
        help="forest evaluation: gemm (plain path-matrix form, default) or "
        "pallas (the hand-written CUDA leaf kernel; bf16 feature compares); "
        "gather is not ported yet",
    )
    ap.add_argument(
        "--fit", choices=["host", "device"], default="host",
        help="forest training; only device (the histogram trainer) is ported",
    )
    ap.add_argument(
        "--fused-round", action="store_true",
        help="score + select through the round megakernel (--kernel pallas) "
        "or the gemm tile stream (--kernel gemm); bit-identical picks",
    )
    # Device mesh for the sharded round (1x1 = single device). Pool rows ride
    # the data axis, trees the model axis; non-divisible pools are padded.
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--n-start", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument(
        "--rounds-per-launch", type=int, default=1,
        help="run this many AL rounds per launch (one CUDA graph per chunk "
        "on the card; the host touches down only at chunk boundaries; results "
        "identical, stopping exact). 1 = per-round driver",
    )
    ap.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="chunk launches allowed in flight at once (with "
        "--rounds-per-launch > 1): 2 overlaps each chunk's host touchdown "
        "with the next chunk's device execution, results bit-identical; "
        "1 = strict serial launch -> block -> touchdown order",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the reference-format results log")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    args.strategy = _STRATEGY_ALIASES.get(args.strategy, args.strategy)
    if args.fit == "host":
        ap.error(
            "--fit host is not ported yet: the host fit calls scikit-learn, "
            "which the port does not depend on; use --fit device"
        )
    if args.kernel == "gather":
        ap.error("--kernel gather is not ported yet; use gemm or pallas")

    from distributed_active_learning_tpu_torch.runtime.debugger import Debugger
    from distributed_active_learning_tpu_torch.runtime.loop import run_experiment

    cfg = ExperimentConfig(
        data=DataConfig(name=args.dataset, n_samples=args.n_samples, seed=args.seed),
        forest=ForestConfig(
            n_trees=args.trees, max_depth=args.depth, kernel=args.kernel, fit=args.fit,
        ),
        strategy=StrategyConfig(name=args.strategy, window_size=args.window),
        mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model),
        n_start=args.n_start,
        max_rounds=args.rounds,
        rounds_per_launch=args.rounds_per_launch,
        pipeline_depth=args.pipeline_depth,
        fused_round=args.fused_round,
        seed=args.seed,
    )
    dbg = Debugger(
        enabled=not args.quiet,
        printer=lambda *a: print(*a, file=sys.stderr),
    )
    result = run_experiment(cfg, debugger=dbg, device=args.device)
    sys.stdout.write(result.to_reference_log())
    if args.out:
        result.save(args.out, fmt="reference")
    if result.final_accuracy is not None and not args.quiet:
        print(
            f"# final: {result.records[-1].n_labeled} labeled, "
            f"accuracy {result.final_accuracy * 100:.2f}%, "
            f"total {dbg.total_time():.1f}s",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
