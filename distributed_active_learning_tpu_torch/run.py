"""Command-line experiment driver of the port (a subset of the JAX package's
``run.py``, same flag names):

    python -m distributed_active_learning_tpu_torch.run \\
        --dataset checkerboard2x2 --fit device --kernel pallas --fused-round \\
        --strategy uncertainty --window 10 --rounds 5 --device cuda

``--fit host`` fits scikit-learn's forest on the host every round (the
JAX package's default; it needs scikit-learn) and evaluates it in the
``--kernel`` form on the device; ``--strategy density`` weights the
one-sided entropy by the similarity mass. ``--quantize bf16|int8`` stores
the device fit's forest narrow (the kernels widen it where they read it);
``--strategy lal`` scores with a LAL regressor its options name
(``--strategy-option lal_data_path=...`` or ``lal_model_path=...``). A pool
of more than two classes fits one forest plane a class.

Prints the reference-format log on stdout; ``--out`` writes it to a file.
``--device`` defaults to cuda and the run refuses to start without a card
unless ``--device cpu`` is given. ``--mesh-data D --mesh-model M`` shards
the pool's rows over D and the trees over M: on the first D x M cards, or
every shard on the CPU with ``--device cpu``.

Observability and resume, as in the JAX package's CLI: ``--metrics-out``
(JSONL events with per-round RoundMetrics; render with
``benches/summarize_metrics.py``), ``--stream-rounds``, ``--profile-dir``
(a ``torch.profiler`` Chrome trace), ``--flight-recorder``, ``--ops-port``
(``/metrics``, ``/healthz``, ``/varz``, ``/flightz`` on localhost) and
``--checkpoint-dir`` with ``--checkpoint-every`` (a checkpoint of either
package resumes in the other). ``--roofline`` (with ``--metrics-out`` and
``--rounds-per-launch`` > 1) adds a ``roofline`` event after the run: the
chunk's counted FLOPs and bytes (``analysis/roofline.py``) joined with its
steady launch seconds. ``--budget N`` stops at N labels, ``--json`` prints
the records as JSON lines, ``--list`` the datasets and strategies.

``--audit`` is the pre-flight, before any kernel launch, in the JAX
package's order: the program auditor traces the programs this run launches
on the meta device at the data's shapes (``analysis/auditor.py``, the rules
of ``analysis/rules.py``: host syncs, transfers, 64-bit leaks, carry drift,
collectives), the recompile-hazard lint reads the port's driver code
(``analysis/lint.py``), and the memory pre-flight (``analysis/memory.py``)
prices the same programs' peak footprint against the card's memory (or
``--budget-table``'s, or ``DAL_MEMORY_BUDGET``'s) and their kernels' shared
memory a block against the card's; an error finding of any of the three
refuses the run with the findings printed, a clean one prints ``# audit
clean: ...``.

Sweeps and grids (``runtime/sweep.py``): ``--sweep-seeds N`` runs seeds
``--seed`` .. ``--seed + N - 1`` as one batched launch stream (each seed's
log under a ``# sweep seed`` header; ``--out`` writes ``out_s<seed>.txt``),
``--strategies A,B,...`` and ``--datasets A,B,...`` run the grid of those
strategies x datasets x seeds (each cell's log under a ``# grid cell``
header). The batched path needs ``--fit device``; a host fit runs the
experiments one after another. ``--plot PATH`` saves a PNG: one run's
accuracy and round-time curves, a sweep's mean +/- sd band, or a grid's
bands (matplotlib; the card's machine has none, and there it raises naming
it).

Files: ``--data-path`` names a file-backed dataset's file or directory
(``--dataset credit_card_fraud --data-path creditcard.csv``, ``striatum``,
the ``*_file`` checkerboards, ``cifar10``, ``agnews``), read through the
native loader (built from ``cpp/loader.cpp`` into ``build/kernels/`` at
first use).

Neural (``runtime/neural_loop.py``): ``--neural`` or a ``deep.*`` strategy
runs the deep-AL loop (a SmallCNN, MLP or transformer encoder, ``--model
auto`` choosing by the pool: images, tokens or tables) with the JAX
package's flags (``--train-steps``, ``--mc-samples``,
``--batchbald-max-configs``, ``--candidate-pool``, ``--batchbald-samples``,
``--coreset-space``, ``--beta``, ``--hidden``, ``--d-model``,
``--n-layers``, ``--n-heads``, ``--d-ff``; ``--sweep-seeds`` batches the
seeds, ``--rounds-per-launch`` chunks the rounds into one CUDA graph a
chunk) and its refusals; ``--phase-detail`` asks for per-phase timing (the
per-round driver).

Scenarios (``scenarios/``): ``--scenario KIND`` with its knobs
(``--flip-prob``, ``--abstain-prob``, ``--cost-budget``, ``--cost-spread``,
``--rare-class``, ``--drift-kind``, ``--drift-rate``, ``--scenario-seed``)
runs one experiment under a scenario (with ``--sweep-seeds`` through the
grid launcher), ``--scenarios A,B,...`` adds a scenario axis to the grid
(cells under ``# grid cell strategy/dataset/scenario/seed`` headers). They
need ``--fit device`` and refuse ``--fused-round``, as the JAX package's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from distributed_active_learning_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ForestConfig,
    MeshConfig,
    ScenarioConfig,
    StrategyConfig,
)

_STRATEGY_ALIASES = {"us": "uncertainty"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_active_learning_tpu_torch.run",
        description="pool-based active learning, PyTorch/CUDA port",
    )
    ap.add_argument("--dataset", default="checkerboard2x2")
    ap.add_argument(
        "--datasets", default=None, metavar="A,B,...",
        help="comma-separated dataset list: with --sweep-seeds/--strategies this adds a batched "
        "dataset axis to the grid launch (pools padded to one slab width, real rows marked by "
        "the fill watermark; runtime/sweep.py run_grid). Overrides --dataset",
    )
    ap.add_argument("--data-path", default=None, help="path for file-backed datasets")
    ap.add_argument("--n-samples", type=int, default=None, help="pool size")
    ap.add_argument("--strategy", default="uncertainty")
    ap.add_argument(
        "--strategies", default=None, metavar="A,B,...",
        help="comma-separated strategy list: run the strategies x seeds (x datasets) grid as ONE "
        "pipelined launch stream, one CUDA graph a chunk on the card (runtime/sweep.py "
        "run_grid); per-cell records equal the serial runs'. Overrides --strategy; the batched "
        "path needs --fit device (a host fit runs the cells one after another)",
    )
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument(
        "--strategy-option", action="append", default=[], metavar="K=V",
        help="per-strategy option (repeatable), e.g. --strategy-option "
        "lal_model_path=/tmp/lal.npz; values parse as int/float when they "
        "look like one",
    )
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument(
        "--kernel", choices=["gemm", "pallas", "gather"], default="gemm",
        help="forest evaluation: gemm (plain path-matrix form, default), "
        "pallas (the hand-written CUDA leaf kernel; bf16 feature compares) "
        "or gather (the traversal form; f32 compares). Depths past 10 always "
        "evaluate in the gather form",
    )
    ap.add_argument(
        "--fit", choices=["host", "device"], default="host",
        help="forest training: host (scikit-learn on the labeled rows, one "
        "round per host step; needs scikit-learn) or device (the histogram "
        "trainer)",
    )
    ap.add_argument(
        "--fused-round", action="store_true",
        help="score + select through the round megakernel (--kernel pallas) "
        "or the gemm tile stream (--kernel gemm); bit-identical picks",
    )
    ap.add_argument(
        "--quantize", choices=["none", "bf16", "int8"], default="none",
        help="quantized forest storage (device fit only): bf16 thresholds and "
        "bf16 or int8 leaf values, widened inside the kernels; bf16 decision "
        "paths are those of f32 storage (the thresholds are bf16-snapped bin "
        "edges), int8 moves leaf probabilities by at most 1/254",
    )
    # The scenario engine (scenarios/): the JAX package's flags.
    ap.add_argument(
        "--scenario", default="none",
        choices=["none", "noisy_oracle", "cost_budget", "rare_event", "drift"],
        help="run under a scenario: noisy_oracle (label flips and an abstaining reveal; "
        "counts are of revealed labels, and --rounds is required when abstaining), "
        "cost_budget (per-point costs, greedy knapsack under a per-round spend cap), "
        "rare_event (recall of the rare class in RoundMetrics), drift (the test set drifts "
        "a round). Needs --fit device; with --sweep-seeds it runs through the grid launcher",
    )
    ap.add_argument(
        "--scenarios", default=None, metavar="A,B,...",
        help="comma-separated scenario list: a scenario axis of the grid launch (scenario x "
        "strategy x seed [x dataset] as one launch stream, runtime/sweep.py run_grid), the "
        "entries sharing the knobs below; 'none' cells equal the clean grid's. Overrides "
        "--scenario",
    )
    ap.add_argument("--flip-prob", type=float, default=0.0,
                    help="noisy_oracle: per-point label-flip probability")
    ap.add_argument("--abstain-prob", type=float, default=0.0,
                    help="noisy_oracle: per-reveal abstain probability")
    ap.add_argument("--cost-budget", type=float, default=0.0,
                    help="cost_budget: per-round labeling spend cap")
    ap.add_argument("--cost-spread", type=float, default=4.0,
                    help="cost_budget: synthetic costs in [1, 1+spread]")
    ap.add_argument("--rare-class", type=int, default=1, help="rare_event: the hunted class id")
    ap.add_argument("--drift-kind", choices=["mean_shift", "rotation"], default="mean_shift")
    ap.add_argument("--drift-rate", type=float, default=0.0,
                    help="drift: per-round drift magnitude")
    ap.add_argument("--scenario-seed", type=int, default=0,
                    help="seed of the scenario draws (flips, costs, drift direction), apart "
                    "from --seed so that clean cells keep their streams")
    # Device mesh for the sharded round (1x1 = single device). Pool rows ride
    # the data axis, trees the model axis; non-divisible pools are padded.
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--n-start", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--budget", type=int, default=None, help="stop at N labeled")
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
    ap.add_argument(
        "--sweep-seeds", type=int, default=1, metavar="N",
        help="run N seeds (--seed .. --seed+N-1) as ONE batched launch stream over the shared "
        "pool (runtime/sweep.py run_sweep): per round step the N fits, one stacked leaf-kernel "
        "launch on the pool and one on the test set, N rounds; per-seed results equal N serial "
        "runs. stdout prints each seed's log under a '# sweep seed' header, --out writes "
        "out_s<seed>.txt. Needs --fit device for the batched path",
    )
    # Observability (runtime/telemetry.py, runtime/obs.py) and resume
    # (runtime/checkpoint.py).
    ap.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="write rank-tagged JSONL telemetry events: one 'round' event per AL round (with "
        "the device-computed score/entropy/histogram metrics; a chunked run computes them "
        "inside its CUDA graph), plus launch accounting, transfer counters and memory "
        "gauges; summarize with benches/summarize_metrics.py",
    )
    ap.add_argument(
        "--stream-rounds", action="store_true",
        help="with --metrics-out and --rounds-per-launch > 1: one 'round_stream' JSONL event "
        "per round, emitted at the chunk's touchdown (a callback cannot run inside a "
        "replayed CUDA graph)",
    )
    ap.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the whole run into DIR (a Chrome trace; open "
        "in Perfetto); phases are named al_phase/train|round|eval",
    )
    ap.add_argument(
        "--roofline", action="store_true",
        help="with --metrics-out and --rounds-per-launch > 1: count the launched chunk's FLOPs "
        "and bytes after the run (analysis/roofline.py; its kernels at their declared work) and "
        "emit a 'roofline' JSONL event joining them with the steady launch seconds: achieved "
        "FLOP/s and bytes/s, the shares of the card's peaks and the bound verdict",
    )
    ap.add_argument(
        "--audit", action="store_true",
        help="audit the programs this run launches BEFORE running them (on the meta device at "
        "the data's shapes): the program rules (analysis/auditor.py), the recompile-hazard "
        "lint (analysis/lint.py), then peak device memory against the card's (or "
        "--budget-table's) and the kernels' shared memory a block (analysis/memory.py); "
        "refuse on an error finding",
    )
    ap.add_argument(
        "--budget-table", default=None, metavar="PATH",
        help="with --audit: a JSON budget {\"hbm_bytes\": N, \"smem_bytes\": N} in place of "
        "the card's (default: the DAL_MEMORY_BUDGET variable's path, else the card)",
    )
    ap.add_argument(
        "--flight-recorder", default=None, metavar="PATH",
        help="record launch/touchdown/veto/recompile events into a bounded in-process ring "
        "and dump the last N as one JSON artifact at PATH on SIGUSR1, SIGTERM, an unhandled "
        "crash and normal exit",
    )
    ap.add_argument(
        "--ops-port", type=int, default=0, metavar="PORT",
        help="serve the live ops plane (runtime/obs.py) on localhost:PORT for the run: "
        "/metrics (Prometheus text), /healthz, /varz, /flightz; 0 (default) = off",
    )
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the reference-format results log")
    ap.add_argument("--plot", default=None, help="save accuracy/time curves as PNG")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--json", action="store_true", help="print per-round records as JSON lines")
    ap.add_argument("--list", action="store_true", help="list datasets and strategies")
    ap.add_argument(
        "--phase-detail", action="store_true",
        help="force per-phase (train/acquire/eval) host wall splits; with --rounds-per-launch "
        "> 1 this takes the per-round driver (phases cannot be attributed inside one graph)",
    )
    # Neural (deep-AL) mode, the JAX package's flags and defaults.
    ap.add_argument("--neural", action="store_true", help="use the neural-learner path")
    ap.add_argument(
        "--model", choices=["auto", "mlp", "cnn", "transformer"], default="auto",
        help="neural learner (auto: cnn for image pools, transformer for token pools, mlp for "
        "tabular)",
    )
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--mc-samples", type=int, default=8)
    ap.add_argument("--batchbald-max-configs", type=int, default=4096)
    ap.add_argument(
        "--batchbald-samples", "--batchbald-mc-samples", dest="batchbald_samples", type=int,
        default=256,
        help="MC configurations carried past the exact-joint cap",
    )
    ap.add_argument("--candidate-pool", type=int, default=512)
    ap.add_argument("--coreset-space", choices=["input", "embedding"], default="input",
                    help="deep.coreset feature space: raw pool features or the trained "
                    "network's penultimate representation")
    ap.add_argument("--beta", type=float, default=1.0,
                    help="deep.density: entropy x mass ** beta")
    ap.add_argument("--hidden", default="128,64", help="MLP hidden sizes (neural mode)")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=256)
    return ap


def _parse_strategy_options(pairs) -> dict:
    """Repeated ``K=V`` flags as a dict; values that parse as an int or a
    float become one (the LAL knobs are ints, paths stay strings)."""
    options = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--strategy-option needs K=V, got {pair!r}")
        k, v = pair.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        options[k] = v
    return options


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    args.strategy = _STRATEGY_ALIASES.get(args.strategy, args.strategy)

    if args.list:
        from distributed_active_learning_tpu_torch.data.datasets import available_datasets
        from distributed_active_learning_tpu_torch.runtime.neural_loop import (
            available_deep_strategies,
        )
        from distributed_active_learning_tpu_torch.strategies import available_strategies

        print("datasets:", ", ".join(available_datasets()))
        print("strategies:", ", ".join(available_strategies()))
        print("deep strategies:", ", ".join(available_deep_strategies()))
        return 0

    from distributed_active_learning_tpu_torch.runtime import telemetry
    from distributed_active_learning_tpu_torch.runtime.debugger import Debugger
    from distributed_active_learning_tpu_torch.runtime.loop import run_experiment

    grid_strategies = ([_STRATEGY_ALIASES.get(x.strip(), x.strip())
                        for x in args.strategies.split(",") if x.strip()]
                       if args.strategies else None)
    grid_datasets = ([x.strip() for x in args.datasets.split(",") if x.strip()]
                     if args.datasets else None)
    if grid_strategies is not None:
        from distributed_active_learning_tpu_torch.strategies import available_strategies

        unknown = [x for x in grid_strategies if x not in available_strategies()]
        if unknown:
            ap.error(f"unknown strategies {unknown}; the grid launcher drives the classic "
                     f"registry: {', '.join(available_strategies())}")
        if len(set(grid_strategies)) != len(grid_strategies):
            # Duplicates would run identical groups and overwrite each
            # other's per-cell output files.
            ap.error(f"duplicate strategies in --strategies: {grid_strategies}")
    if grid_datasets is not None and len(set(grid_datasets)) != len(grid_datasets):
        ap.error(f"duplicate datasets in --datasets: {grid_datasets}")
    # Both drivers gate persistence on dir AND interval; half a request
    # would be silently ignored.
    if bool(args.checkpoint_dir) != bool(args.checkpoint_every):
        ap.error("checkpointing needs both --checkpoint-dir and --checkpoint-every")
    if args.profile_dir:
        try:
            telemetry.prepare_profile_dir(args.profile_dir)
        except ValueError as e:
            ap.error(str(e))
    base_scenario, scenario_cfgs = _scenarios(ap, args)
    from distributed_active_learning_tpu_torch.runtime.neural_loop import is_deep_strategy

    neural = args.neural or args.strategy.startswith("deep.")
    if neural:
        _check_neural(ap, args, base_scenario, scenario_cfgs)
    else:
        from distributed_active_learning_tpu_torch.strategies import available_strategies

        if args.strategy not in available_strategies() and is_deep_strategy(args.strategy):
            ap.error(f"{args.strategy!r} is a deep strategy; spell it "
                     f"'deep.{args.strategy}' (or pass --neural)")
    # Join a multi-process job before any device use, iff the launch asks
    # for one (the env trio or torchrun's WORLD_SIZE; parallel/multihost.py):
    # after the argument checks, so a bad command line never waits at the
    # process group's rendezvous. JAX_NUM_PROCESSES=1 opts a worker out.
    from distributed_active_learning_tpu_torch.parallel import multihost

    multihost.maybe_initialize()
    if args.flight_recorder:
        telemetry.install_flight_recorder(args.flight_recorder)
    ops_server = None
    if args.ops_port:
        # The primary binds; every rank of a multi-process job runs this
        # main(), and N ranks binding one port would collide.
        if multihost.is_primary():
            from distributed_active_learning_tpu_torch.runtime.obs import OpsServer

            ops_server = OpsServer(port=args.ops_port).start()
            print(f"# ops plane: http://127.0.0.1:{ops_server.port}/metrics "
                  "(/healthz /varz /flightz)", file=sys.stderr, flush=True)
        else:
            print(f"# ops plane: skipped on host {multihost.process_index()} "
                  "(primary host binds --ops-port)", file=sys.stderr, flush=True)

    cfg = ExperimentConfig(
        data=DataConfig(name=grid_datasets[0] if grid_datasets else args.dataset,
                        path=args.data_path, n_samples=args.n_samples, seed=args.seed),
        forest=ForestConfig(
            n_trees=args.trees, max_depth=args.depth, kernel=args.kernel, fit=args.fit,
            quantize=args.quantize,
        ),
        strategy=StrategyConfig(name=grid_strategies[0] if grid_strategies else args.strategy,
                                window_size=args.window,
                                options=_parse_strategy_options(args.strategy_option)),
        mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model),
        # One scenario rides the config; a --scenarios axis rides run_grid.
        scenario=(base_scenario if base_scenario.active and scenario_cfgs is None
                  else ScenarioConfig()),
        n_start=args.n_start,
        max_rounds=args.rounds,
        label_budget=args.budget,
        rounds_per_launch=args.rounds_per_launch,
        pipeline_depth=args.pipeline_depth,
        sweep_seeds=args.sweep_seeds,
        stream_round_events=args.stream_rounds,
        fused_round=args.fused_round,
        roofline=args.roofline,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    dbg = Debugger(
        enabled=not args.quiet,
        printer=lambda *a: print(*a, file=sys.stderr),
        phase_detail=args.phase_detail,
    )
    # A scenario with a seed sweep runs through the grid launcher: the seed
    # sweep has no scenario wiring, and the grid's one-strategy shape is a
    # scenario x seed sweep.
    use_grid = (grid_strategies is not None or grid_datasets is not None
                or scenario_cfgs is not None
                or (base_scenario.active and args.sweep_seeds > 1))
    seeds = list(range(args.seed, args.seed + args.sweep_seeds))
    bundle = None
    if args.audit:
        bundle = _audit_or_die(args, cfg, neural, use_grid, grid_strategies, grid_datasets,
                               scenario_cfgs)
    writer = telemetry.MetricsWriter(args.metrics_out) if args.metrics_out else None
    try:
        with telemetry.profile_session(args.profile_dir):
            if neural:
                out = _run_neural(args, dbg, metrics=writer)
                if args.sweep_seeds > 1:
                    results = out
                else:
                    result = out
            elif use_grid:
                from distributed_active_learning_tpu_torch.runtime.sweep import run_grid

                grid = run_grid(cfg, grid_strategies or [cfg.strategy.name], seeds,
                                datasets=grid_datasets, scenarios=scenario_cfgs, debugger=dbg,
                                metrics=writer, device=args.device)
            elif args.sweep_seeds > 1:
                from distributed_active_learning_tpu_torch.runtime.sweep import run_sweep

                results = run_sweep(cfg, seeds, debugger=dbg, metrics=writer, device=args.device)
            else:
                result = run_experiment(cfg, bundle=bundle, debugger=dbg, metrics=writer,
                                        device=args.device)
    finally:
        if writer is not None:
            writer.close()
        if ops_server is not None:
            ops_server.stop()
    if args.flight_recorder:
        telemetry.flight_dump("exit")
    if use_grid and not neural:
        _emit_grid(args, grid, dbg)
    elif args.sweep_seeds > 1:
        _emit_sweep(args, results, seeds, dbg)
    else:
        _emit(args, result, dbg)
    return 0


def _check_neural(ap, args, base_scenario, scenario_cfgs) -> None:
    """The JAX package's refusals of the neural path, with its messages."""
    from distributed_active_learning_tpu_torch.runtime.neural_loop import (
        available_deep_strategies,
        is_deep_strategy,
    )

    if base_scenario.active or scenario_cfgs is not None:
        ap.error("scenarios drive the forest loop; the neural path has no "
                 "scenario wiring yet (a named ROADMAP follow-up)")
    if args.fused_round:
        ap.error(
            "--fused-round serves the single forest experiment only; the "
            "sweep/grid launchers (--sweep-seeds > 1 / --strategies / "
            "--datasets) and the neural loop run their own fused chunks "
            "without it (ROADMAP: serving the megakernel from the batched "
            "launchers is a follow-up)")
    if args.strategies or args.datasets:
        ap.error("--strategies/--datasets drive the forest grid launcher; "
                 "the neural path batches the seed axis only (--sweep-seeds)")
    if args.sweep_seeds > 1 and args.checkpoint_dir:
        ap.error("checkpointing is not supported by the batched neural sweep; run the seeds "
                 "serially")
    if args.mesh_model != 1:
        ap.error("the neural path shards pool rows only (--mesh-data); "
                 "--mesh-model applies to the forest ensemble axis")
    if not is_deep_strategy(args.strategy):
        ap.error(f"--neural needs a deep strategy, got {args.strategy!r}; "
                 f"pick one of: {', '.join(available_deep_strategies())}")


def _run_neural(args, dbg, metrics=None):
    """The deep-AL path over a registry dataset (the JAX CLI's
    ``_run_neural``): ``--model auto`` takes the CNN for an image pool, the
    transformer for a token pool and the MLP otherwise."""
    import dataclasses

    import numpy as np

    from distributed_active_learning_tpu_torch.data.datasets import get_dataset
    from distributed_active_learning_tpu_torch.device import resolve_device
    from distributed_active_learning_tpu_torch.models.neural import MLP, NeuralLearner, SmallCNN
    from distributed_active_learning_tpu_torch.runtime.neural_loop import (
        NeuralExperimentConfig,
        run_neural_experiment,
        run_neural_sweep,
    )

    dev = resolve_device(args.device)
    data_cfg = DataConfig(name=args.dataset, path=args.data_path, n_samples=args.n_samples,
                          seed=args.seed)
    bundle = get_dataset(data_cfg, device=dev)
    n_classes = max(int(bundle.train_y.max()) + 1, 2)
    kind = args.model
    if kind == "auto":
        if bundle.train_x.ndim == 4:
            kind = "cnn"
        elif np.issubdtype(np.asarray(bundle.train_x).dtype, np.integer):
            kind = "transformer"
        else:
            kind = "mlp"
    if kind == "cnn":
        if bundle.train_x.ndim != 4:
            raise ValueError(f"--model cnn needs an image pool, got shape {bundle.train_x.shape}")
        module = SmallCNN(n_classes=n_classes)
        input_shape = tuple(int(s) for s in bundle.train_x.shape[1:])
    elif kind == "transformer":
        from distributed_active_learning_tpu_torch.models.transformer import TransformerClassifier

        if bundle.train_x.ndim != 2:
            raise ValueError(
                f"--model transformer needs a token pool, got shape {bundle.train_x.shape}")
        max_len = int(bundle.train_x.shape[1])
        vocab = bundle.vocab_size or int(np.asarray(bundle.train_x).max()) + 1
        module = TransformerClassifier(vocab_size=vocab, max_len=max_len, n_classes=n_classes,
                                       d_model=args.d_model, n_layers=args.n_layers,
                                       n_heads=args.n_heads, d_ff=args.d_ff)
        input_shape = (max_len,)
    else:
        module = MLP(n_classes=n_classes, hidden=tuple(int(h) for h in args.hidden.split(",") if h))
        if bundle.train_x.ndim > 2:
            flat = int(np.prod(bundle.train_x.shape[1:]))
            bundle = bundle._replace(
                train_x=np.asarray(bundle.train_x).reshape(len(bundle.train_x), flat),
                test_x=np.asarray(bundle.test_x).reshape(len(bundle.test_x), flat))
        input_shape = (int(bundle.train_x.shape[1]),)
    learner = NeuralLearner(module, input_shape, train_steps=args.train_steps,
                            mc_samples=args.mc_samples, device=dev)
    cfg = NeuralExperimentConfig(
        strategy=args.strategy, window_size=args.window, n_start=args.n_start,
        max_rounds=args.rounds, label_budget=args.budget, seed=args.seed,
        batchbald_max_configs=args.batchbald_max_configs,
        batchbald_candidate_pool=args.candidate_pool,
        batchbald_mc_samples=args.batchbald_samples, beta=args.beta,
        coreset_space=args.coreset_space, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, rounds_per_launch=args.rounds_per_launch,
        pipeline_depth=args.pipeline_depth, stream_round_events=args.stream_rounds,
        mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model))
    ident = dataclasses.asdict(data_cfg)
    if args.sweep_seeds > 1:
        return run_neural_sweep(cfg, learner, bundle.train_x, bundle.train_y, bundle.test_x,
                                bundle.test_y, seeds=list(range(args.seed,
                                                                args.seed + args.sweep_seeds)),
                                debugger=dbg, data_ident=ident, metrics=metrics)
    return run_neural_experiment(cfg, learner, bundle.train_x, bundle.train_y, bundle.test_x,
                                 bundle.test_y, debugger=dbg, data_ident=ident, metrics=metrics)


def _scenarios(ap, args):
    """The scenario flags: one base :class:`ScenarioConfig` carrying the
    knobs, and the ``--scenarios`` axis (None when absent or all ``none``),
    with the JAX package's refusals."""
    from distributed_active_learning_tpu_torch.scenarios import SCENARIO_KINDS, scenario_from_name

    base = ScenarioConfig(
        kind=args.scenario, flip_prob=args.flip_prob, abstain_prob=args.abstain_prob,
        cost_budget=args.cost_budget, cost_spread=args.cost_spread, rare_class=args.rare_class,
        drift_kind=args.drift_kind, drift_rate=args.drift_rate, seed=args.scenario_seed)
    axis = None
    if args.scenarios:
        names = [x.strip() for x in args.scenarios.split(",") if x.strip()]
        unknown = [x for x in names if x not in SCENARIO_KINDS]
        if unknown:
            ap.error(f"unknown scenarios {unknown}; one of {list(SCENARIO_KINDS)}")
        if len(set(names)) != len(names):
            ap.error(f"duplicate scenarios in --scenarios: {names}")
        axis = [scenario_from_name(x, base) for x in names]
        if not any(sc.active for sc in axis):
            axis = None  # `--scenarios none` is the clean grid
    if axis is not None or base.active:
        if args.fused_round:
            ap.error(
                "--fused-round fuses the CLEAN eval->score->top-k chain; "
                "scenarios perturb the round body (probabilistic reveal / "
                "knapsack select / drifted eval) — drop one of the two"
            )
        if args.fit != "device":
            ap.error("scenarios run inside the jitted round and need --fit device")
    return base, axis


def _audit_or_die(args, cfg: ExperimentConfig, neural: bool, use_grid: bool, strategies=None,
                  datasets=None, scenarios=None):
    """``--audit``: trace the program this run launches on the meta device
    at the data's shapes against the program rules (``analysis/auditor.py``),
    lint the driver code (``analysis/lint.py``), price the same program
    (``analysis/memory.py``) against the budget, and refuse to run on an
    error finding of any of them, the findings printed; launches nothing on
    the card. The program is the run's own
    (``analysis.programs.specs_for_run``): the grid chunk of its exact
    cells, the batched seed sweep, the neural sweep's lanes, the scenario
    round, the mesh at its configured shape (this rank's cells over
    processes), LAL with the regressor its options name. Returns the single
    forest run's data bundle (loaded once here for its shapes and handed to
    the run), else None."""
    import numpy as np

    from distributed_active_learning_tpu_torch import analysis
    from distributed_active_learning_tpu_torch.analysis import memory as memory_lib
    from distributed_active_learning_tpu_torch.analysis import programs as programs_lib
    from distributed_active_learning_tpu_torch.data.datasets import get_dataset

    try:
        budget = memory_lib.budget_from_env_or(args.budget_table)
    except (OSError, ValueError) as e:
        raise SystemExit(f"audit: {e}") from None
    bundle = None
    if neural:
        lanes = args.sweep_seeds if args.sweep_seeds > 1 and args.mesh_data <= 1 else 0
        if args.mesh_data > 1:
            print("# audit: a neural run on a data mesh is priced as its chunk on one device",
                  file=sys.stderr)
        name = (f"neural_sweep/{args.strategy}/lanes{lanes}" if lanes
                else f"neural_chunk/{args.strategy}")
        specs = [programs_lib.ProgramSpec(
            name, "neural_sweep" if lanes else "neural_chunk",
            programs_lib.neural_chunk_program(_neural_shapes(args), lanes=lanes))]
    else:
        shapes = []
        for name in datasets or [cfg.data.name]:
            b = get_dataset(dataclasses.replace(cfg.data, name=name))
            train_x = np.asarray(b.train_x)
            shapes.append(programs_lib.ForestShapes(
                pool_rows=train_x.shape[0], features=train_x.shape[-1],
                test_rows=np.asarray(b.test_x).shape[0],
                n_classes=max(int(np.asarray(b.train_y).max()) + 1, 2)))
        if not use_grid and args.sweep_seeds <= 1:
            bundle = b
        specs = programs_lib.specs_for_run(
            cfg, shapes, strategies=strategies, n_seeds=args.sweep_seeds,
            scenarios=scenarios, grid=use_grid, with_metrics=bool(args.metrics_out))
    report, table = analysis.preflight(specs, budget)
    if report.findings:
        print(report.render_table(), file=sys.stderr)
    if report.gate("error"):
        raise SystemExit("audit failed: error-severity findings in the audited programs (see "
                         "above); fix them or re-run without --audit")
    if not args.quiet:
        peak = max((max(e.get("peak_hbm_bytes", 0), e.get("graph_hbm_bytes", 0))
                    for e in table.values()), default=0)
        print(f"# audit clean: {', '.join(report.programs)} (footprint {peak / 2**20:.1f} MiB of "
              f"{budget.source}'s {(budget.hbm_bytes or 0) / 2**20:.0f} MiB)", file=sys.stderr)
    return bundle


def _neural_shapes(args):
    """The neural run's program shapes: the generated CIFAR-10 and AG-News
    stand-ins' from their sizes (``data.datasets._standin_sizes``: drawing
    them is the run's own work), any other pool's from its data."""
    import numpy as np

    from distributed_active_learning_tpu_torch.analysis.programs import NeuralShapes
    from distributed_active_learning_tpu_torch.data import datasets

    data_cfg = DataConfig(name=args.dataset, path=args.data_path, n_samples=args.n_samples,
                          seed=args.seed)
    vocab = 4096
    if args.dataset in ("cifar10", "agnews") and args.data_path is None:
        n, n_test = datasets._standin_sizes(data_cfg)
        shape, n_classes = (((32, 32, 3), 10) if args.dataset == "cifar10" else ((64,), 4))
    else:
        bundle = datasets.get_dataset(data_cfg)
        train_x = np.asarray(bundle.train_x)
        n, n_test, shape = train_x.shape[0], np.asarray(bundle.test_x).shape[0], train_x.shape[1:]
        n_classes = max(int(np.asarray(bundle.train_y).max()) + 1, 2)
        vocab = bundle.vocab_size or (int(train_x.max()) + 1 if len(shape) == 1 else vocab)
    kind = args.model
    if kind == "auto":
        kind = ("cnn" if len(shape) == 3 else "transformer"
                if args.dataset == "agnews" else "mlp")
    if kind == "mlp" and len(shape) > 1:
        shape = (int(np.prod(shape)),)
    return NeuralShapes(
        model=kind, input_shape=tuple(int(s) for s in shape), pool_rows=int(n),
        test_rows=int(n_test), n_classes=n_classes, strategy=args.strategy, window=args.window,
        train_steps=args.train_steps, mc_samples=args.mc_samples,
        rounds_per_launch=max(args.rounds_per_launch, 1), vocab_size=int(vocab),
        hidden=tuple(int(h) for h in args.hidden.split(",") if h), d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff)


def _emit(args, result, dbg) -> None:
    sys.stdout.write(result.to_jsonl() if args.json else result.to_reference_log())
    if args.out:
        result.save(args.out, fmt="reference")
    if args.plot:
        from distributed_active_learning_tpu_torch.runtime.results import plot_result

        plot_result(result, args.plot, title=f"{args.dataset} / {args.strategy}")
    if result.final_accuracy is not None and not args.quiet:
        print(
            f"# final: {result.records[-1].n_labeled} labeled, "
            f"accuracy {result.final_accuracy * 100:.2f}%, "
            f"total {dbg.total_time():.1f}s",
            file=sys.stderr,
        )


def _emit_sweep(args, results, seeds, dbg) -> None:
    """A sweep's logs: each seed's under a '# sweep seed' header on stdout,
    ``--out`` as per-seed files."""
    import numpy as np

    from distributed_active_learning_tpu_torch.runtime.sweep import _sweep_result_path

    for seed, result in zip(seeds, results):
        if args.json:
            for r in result.records:
                sys.stdout.write(json.dumps({"seed": seed, **dataclasses.asdict(r)}) + "\n")
        else:
            sys.stdout.write(f"# sweep seed {seed}\n")
            sys.stdout.write(result.to_reference_log())
        if args.out:
            result.save(_sweep_result_path(args.out, seed), fmt="reference")
    if args.plot:
        from distributed_active_learning_tpu_torch.runtime.results import plot_seed_band

        plot_seed_band(results, args.plot,
                       title=f"{args.dataset} / {args.strategy} ({len(seeds)} seeds)")
    finals = [r.final_accuracy for r in results if r.final_accuracy is not None]
    if finals and not args.quiet:
        print(f"# sweep final: {len(seeds)} seeds, accuracy {np.mean(finals) * 100:.2f}% +/- "
              f"{np.std(finals) * 100:.2f}%, total {dbg.total_time():.1f}s", file=sys.stderr)


def _emit_grid(args, grid, dbg) -> None:
    """A grid's logs: each cell's under a '# grid cell' header on stdout,
    ``--out`` as per-cell files."""
    import numpy as np

    from distributed_active_learning_tpu_torch.runtime.sweep import _grid_result_path

    datasets = sorted({c.dataset for c in grid.cells})
    with_scn = sorted({c.scenario for c in grid.cells}) != ["none"]
    for cell in grid.cells:
        if args.json:
            row = {"strategy": cell.strategy, "dataset": cell.dataset, "seed": cell.seed}
            if with_scn:
                row["scenario"] = cell.scenario
            for r in cell.result.records:
                sys.stdout.write(json.dumps({**row, **dataclasses.asdict(r)}) + "\n")
        else:
            sc = f"/{cell.scenario}" if with_scn else ""
            sys.stdout.write(f"# grid cell {cell.strategy}/{cell.dataset}{sc}/seed "
                             f"{cell.seed}\n")
            sys.stdout.write(cell.result.to_reference_log())
        if args.out:
            cell.result.save(_grid_result_path(args.out, cell.strategy, cell.dataset, cell.seed,
                                               len(datasets) > 1, cell.scenario, with_scn),
                             fmt="reference")
    if args.plot:
        from distributed_active_learning_tpu_torch.runtime.results import plot_grid_bands

        plot_grid_bands(grid, args.plot, title=f"grid ({len(grid.cells)} cells)")
    if not args.quiet:
        finals = [c.result.final_accuracy for c in grid.cells
                  if c.result.final_accuracy is not None]
        acc = (f"accuracy {np.mean(finals) * 100:.2f}% +/- {np.std(finals) * 100:.2f}%"
               if finals else "no accuracy records")
        strategies = sorted({c.strategy for c in grid.cells})
        print(f"# grid final: {len(grid.cells)} cells ({len(strategies)} strategies x "
              f"{len(datasets)} datasets), {acc}, launches={grid.launches} "
              f"recompiles_after_warmup={grid.recompiles_after_warmup}, "
              f"total {dbg.total_time():.1f}s", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
