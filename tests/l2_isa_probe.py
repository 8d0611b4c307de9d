"""Probe: the order in which the JAX package's jitted ``l2_normalize`` sums
its squares, under each of XLA's CPU vector instruction sets, against the
port's ``ops/similarity.l2_normalize``; then the density runs whose picks
sit on a boundary tie (ROADMAP queue 3), port against JAX.

Not a test (pytest does not collect it); run it from the repository root:

    python tests/l2_isa_probe.py [--density]

Each instruction set runs JAX in a child process under
``XLA_FLAGS=--xla_cpu_max_isa=<ISA>``; the report gives, per width, the rows
of 1,000 (5,000 for ``big``: 5,000 x 30) whose normalized bits differ from
the port's.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ISAS = ("SSE4_2", "AVX", "AVX2", "AVX512")
WIDTHS = list(range(1, 41)) + [48, 64]


def _inputs():
    for d in WIDTHS:
        yield f"d{d}", np.random.default_rng(d).normal(size=(1000, d)).astype(np.float32)
    yield "big", np.random.default_rng(5000).normal(size=(5000, 30)).astype(np.float32)


def _jax_child(isa: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = f"--xla_cpu_max_isa={isa}"
    import jax
    import jax.numpy as jnp

    from distributed_active_learning_tpu.ops.similarity import l2_normalize

    f = jax.jit(l2_normalize)
    out = {k: np.asarray(f(jnp.asarray(x))).view(np.int32).tolist() for k, x in _inputs()}
    json.dump(out, sys.stdout)


def _isa_report() -> dict:
    import torch

    from distributed_active_learning_tpu_torch.ops.similarity import l2_normalize

    port = {k: l2_normalize(torch.from_numpy(x)).numpy().view(np.int32) for k, x in _inputs()}
    report = {}
    for isa in ISAS:
        out = subprocess.run([sys.executable, __file__, "--jax-child", isa], capture_output=True,
                             text=True, check=True)
        jax_bits = json.loads(out.stdout)
        report[isa] = {k: int((np.asarray(jax_bits[k], np.int32) != v).any(axis=1).sum())
                       for k, v in port.items()}
    return report


def _density_ties() -> dict:
    """The two watched configurations (the grid test's and the scenario
    tests'), seeds 0-3: the first record where the port's density run and
    JAX's differ, or None."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    from distributed_active_learning_tpu import config as jc
    from distributed_active_learning_tpu.runtime import loop as jl
    from distributed_active_learning_tpu_torch import config as tc
    from distributed_active_learning_tpu_torch.runtime import loop as tl

    def rec(res):
        return [(r.round, r.n_labeled, r.accuracy) for r in res.records]

    out = {}
    for name, n, trees, window, rounds in (("grid", 160, 6, 10, 5), ("scenario", 96, 4, 8, 4)):
        for seed in range(4):
            j = jc.ExperimentConfig(
                data=jc.DataConfig(name="checkerboard2x2", n_samples=n, seed=2),
                forest=jc.ForestConfig(n_trees=trees, max_depth=3, fit="device", kernel="pallas",
                                       fit_budget=n),
                strategy=jc.StrategyConfig(name="density", window_size=window), n_start=10,
                max_rounds=rounds, seed=seed)
            a = rec(jl.run_experiment(j))
            b = rec(tl.run_experiment(tc.from_dict(dataclasses.asdict(j)), device="cpu"))
            first = next((x[0] for x, y in zip(a, b) if x != y), None)
            out[f"{name} seed {seed}"] = first
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax-child", metavar="ISA")
    ap.add_argument("--density", action="store_true",
                    help="also re-run the density tie configurations (first differing record)")
    args = ap.parse_args()
    if args.jax_child:
        _jax_child(args.jax_child)
        return 0
    report = _isa_report()
    for isa, rows in report.items():
        differing = {k: v for k, v in rows.items() if v}
        print(f"{isa}: {differing or 'every width equal'}")
    if args.density:
        print(json.dumps({"density_first_differing_record": _density_ties()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
