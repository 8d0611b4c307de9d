"""Where a chunked neural round spends its device time on one device and on a
data mesh of the same card.

The run is ``chip_smoke.py``'s phase 4n CNN entropy run (the CIFAR-10
stand-in: 50,000 images, ``SmallCNN(10)``, 200 steps, 8 MC samples, 4
rounds chunked at K = 2, one CUDA graph of a round replayed) made twice:
once on one device and once on ``MeshConfig(data=8)`` over the card repeated
8 times. Each whole run goes under ``torch.profiler`` (one eager warm-up
round, the capture, four replayed rounds), and each graph replay (one
round) is bracketed by CUDA events on its stream (``runtime.loop.
replay_counted`` wrapped for the run). Then one MC pass of the pool
(``predict_proba_samples``, 8 samples) is timed with CUDA events on the one
tensor and on the sharded pool, after the same number of untimed passes.

Printed per configuration: the replayed seconds a round as the chunked loop
records them (a chunk's wall from the later of its dispatch and the
previous chunk's read, over its rounds), each replay's event time, the device kernels
the run launched and their device time, and the kernel names whose device
time differs most between the two, with the MC pass times. The last line
is one JSON object of the same numbers.

Run: ``python -m distributed_active_learning_tpu_torch.benches.neural_mesh_profile
[--seed 0]``. Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

import torch

N_IMAGES, ROUNDS, K, SHARDS = 50_000, 4, 2, 8
TOP = 12  # kernel names listed by device-time difference


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def _device_times(prof) -> dict:
    """``{kernel name: (launches, device ms)}`` of a profile's device events."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = (e.count, us / 1e3)
    return out


def _mc_pass_ms(learner, state, x, key, reps: int = 3) -> list:
    for _ in range(reps):
        learner.predict_proba_samples(state, x, key)
    times = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        learner.predict_proba_samples(state, x, key)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return times


def _replay_events(loop):
    """Wrap ``loop.replay_counted`` so that every replay is bracketed by
    CUDA events on the current stream; returns the list the pairs go to
    and the function to put back."""
    pairs, plain = [], loop.replay_counted

    def timed(graph, launches):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        plain(graph, launches)
        t1.record()
        pairs.append((t0, t1))

    loop.replay_counted = timed
    return pairs, plain


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("neural_mesh_profile needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.config import DataConfig, MeshConfig
    from distributed_active_learning_tpu_torch.data.datasets import get_dataset
    from distributed_active_learning_tpu_torch.device import deterministic_cuda
    from distributed_active_learning_tpu_torch.models.neural import NeuralLearner, SmallCNN
    from distributed_active_learning_tpu_torch.parallel import make_mesh, shard_rows
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.runtime import neural_loop as nl

    deterministic_cuda()
    dev = torch.device("cuda", 0)
    card = _card()
    bc = get_dataset(DataConfig(name="cifar10", n_samples=N_IMAGES, seed=args.seed), device=dev)
    cnn = NeuralLearner(SmallCNN(n_classes=10, dropout_rate=0.25), (32, 32, 3), train_steps=200,
                        batch_size=64, mc_samples=8, device=dev)
    cfg = nl.NeuralExperimentConfig(strategy="entropy", window_size=100, n_start=100,
                                    max_rounds=ROUNDS, seed=args.seed, rounds_per_launch=K)
    ring = [dev] * SHARDS
    configs = {"one_device": (cfg, None),
               f"mesh_{SHARDS}": (dataclasses.replace(cfg, mesh=MeshConfig(data=SHARDS)), ring)}
    report = {"card": card, "configs": {}}
    for name, (c, devices) in configs.items():
        torch.cuda.synchronize()
        pairs, plain = _replay_events(loop)
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = nl.run_neural_experiment(c, cnn, bc.train_x, bc.train_y, bc.test_x,
                                               bc.test_y, devices=devices)
                torch.cuda.synchronize()
        finally:
            loop.replay_counted = plain
        kernels = _device_times(prof)
        report["configs"][name] = {
            "replayed_seconds_per_round": statistics.median(
                r.total_time for r in res.records[K:]),
            "replay_event_ms": [t0.elapsed_time(t1) for t0, t1 in pairs],
            "capture_seconds": res.graph_stats["capture_seconds"],
            "device_kernels": sum(n for n, _ in kernels.values()),
            "device_ms": sum(ms for _, ms in kernels.values()),
            "kernels": kernels,
        }
    state = cnn.init(prng.key(args.seed))
    key = prng.key(args.seed + 1)
    x = torch.as_tensor(bc.train_x, device=dev)
    mesh = make_mesh(SHARDS, 1, devices=ring)
    mc = {"one_device": _mc_pass_ms(cnn, state, x, key),
          f"mesh_{SHARDS}": _mc_pass_ms(cnn, state, shard_rows(x, mesh), key)}
    names = list(configs)
    a, b = (report["configs"][n]["kernels"] for n in names)
    diff = sorted(set(a) | set(b), key=lambda k: -abs(a.get(k, (0, 0.0))[1]
                                                    - b.get(k, (0, 0.0))[1]))[:TOP]
    for n in names:
        r = report["configs"][n]
        print(f"# {n}: {r['replayed_seconds_per_round']:.4f} s a replayed round as recorded, "
              f"replays {[round(t, 2) for t in r['replay_event_ms']]} ms (CUDA events), capture "
              f"{r['capture_seconds']:.2f} s; the run launched {r['device_kernels']} device "
              f"kernels, {r['device_ms']:.1f} ms device time; an MC pass (8 samples) "
              f"{min(mc[n]):.2f} ms (CUDA events, best of {len(mc[n])}) ({card})")
    print(f"# kernels by device-time difference ({names[0]} - {names[1]}), launches and ms:")
    for k in diff:
        (na, ta), (nb, tb) = a.get(k, (0, 0.0)), b.get(k, (0, 0.0))
        print(f"#   {ta - tb:+9.2f} ms  {na:6d} x {ta:9.2f} ms | {nb:6d} x {tb:9.2f} ms  {k[:110]}")
    report["mc_pass_ms"] = mc
    report["top_differences"] = [{"kernel": k, names[0]: a.get(k, (0, 0.0)),
                                  names[1]: b.get(k, (0, 0.0))} for k in diff]
    for n in names:
        del report["configs"][n]["kernels"]
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
