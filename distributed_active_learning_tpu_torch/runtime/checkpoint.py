"""Checkpoint/resume of one AL experiment (the port of the single-experiment
half of ``runtime/checkpoint.py``).

A checkpoint holds what a resume needs and nothing else: the labeled mask,
the PRNG key, the round counter and the records. Pool features are not
stored (the dataset config reproduces them); mask and key make the resumed
run bit-identical to an uninterrupted one.

The file format is the JAX package's, field by field, so a checkpoint
written by either package resumes in the other: ``alstate_<round>.npz``
holding

- ``labeled_mask``: bool over the REAL pool rows (mesh padding is a
  placement detail, so a checkpoint written on a mesh resumes on one device
  and the other way round);
- ``key``: the two words of ``jax.random.key_data`` as ``uint32[2]`` (the
  port's key holds the same words in ``int64``);
- ``round``: ``int32``;
- ``records_json``: the records as UTF-8 JSON bytes (``uint8``);
- ``config_fingerprint`` and ``forest_kernel``: UTF-8 bytes.

The fingerprint hashes the experiment's identity (data, forest, strategy,
seeding) from the config dataclasses, whose fields are the JAX package's,
so the same experiment has the same fingerprint in both packages. Loop
controls, the mesh and ``rounds_per_launch`` stay out of it: the chunked and
per-round drivers give bit-identical state, so a checkpoint written by one
resumes under the other, at any chunk size. The chunked driver writes at
the first chunk boundary at or after each multiple of ``checkpoint_every``.

The batched half (``runtime/sweep.py``): one ``sweepstate_<round>.npz`` a
sweep and one ``gridstate_<round>.npz`` a grid, each holding every
experiment's (or cell's) ``labeled_mask`` ``[E, n]``, ``key`` ``uint32[E,
2]``, ``round`` ``int32[E]`` and records (a list of record lists), with the
fingerprint of the whole batch (:func:`sweep_fingerprint`,
:func:`grid_fingerprint`): the JAX package's format, so either package
resumes the other's; a scenario grid's fingerprint carries its scenario axis.
A neural experiment's file (:func:`save_neural`) adds the loop key, the
network's parameters and its adam state in flax's leaf order and layouts,
as the JAX package writes them. The serve format of the JAX module comes
with its slice (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from distributed_active_learning_tpu_torch.runtime import state as state_lib
from distributed_active_learning_tpu_torch.runtime.results import ExperimentResult
from distributed_active_learning_tpu_torch.runtime.state import PoolState

_STEP_RE = re.compile(r"^alstate_(\d+)\.npz$")


def fingerprint_from_ident(ident: dict) -> str:
    """Stable 16-hex-digit hash of an experiment-identity dict."""
    blob = json.dumps(ident, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _forest_ident(cfg, with_mesh: bool) -> dict:
    forest_ident = dataclasses.asdict(cfg.forest)
    # The evaluation kernel is a performance knob (votes agree across
    # kernels, except the bf16 compare of host-fit features, which
    # _kernel_swap_exact warns about): switching it is a legitimate resume.
    forest_ident.pop("kernel", None)
    # Unquantized storage stays out of the identity, as in the JAX package.
    if forest_ident.get("quantize", "none") == "none":
        forest_ident.pop("quantize", None)
    ident = {
        "data": dataclasses.asdict(cfg.data),
        "forest": forest_ident,
        "strategy": {**dataclasses.asdict(cfg.strategy), "options": dict(cfg.strategy.options)},
        "n_start": cfg.n_start,
        "seed": cfg.seed,
    }
    scn = getattr(cfg, "scenario", None)
    if scn is not None and getattr(scn, "kind", "none") != "none":
        ident["scenario"] = dataclasses.asdict(scn)
    if with_mesh:
        ident["mesh"] = dataclasses.asdict(cfg.mesh)
    return ident


def config_fingerprint(cfg) -> str:
    """Hash of the experiment's identity fields: dataset, forest, strategy,
    seeding. Resuming with a larger round budget or another mesh is
    legitimate; resuming under another strategy or dataset is refused by
    :func:`restore_latest`."""
    return fingerprint_from_ident(_forest_ident(cfg, with_mesh=False))


def accepted_fingerprints(cfg) -> tuple:
    """The current fingerprint and the legacy mesh-included form, which
    checkpoints of the JAX package from before the mesh left the identity
    carry."""
    return (config_fingerprint(cfg), fingerprint_from_ident(_forest_ident(cfg, with_mesh=True)))


def kernel_ident(cfg) -> str:
    """``"<fit>:<kernel>"``, recorded in the payload (not the fingerprint)
    so a resume can warn on the one kernel swap that is not vote-exact."""
    return f"{cfg.forest.fit}:{cfg.forest.kernel}"


def _kernel_swap_exact(stored: str, current: str) -> bool:
    """Whether resuming ``stored`` under ``current`` keeps votes exact: the
    pallas kernel compares features in bf16, exact for device-fit forests
    (integer bin codes) but not for host-fit float features."""
    (s_fit, s_kern), (c_fit, c_kern) = stored.split(":", 1), current.split(":", 1)
    if s_kern == c_kern:
        return True
    return "pallas" not in (s_kern, c_kern) or "host" not in (s_fit, c_fit)


def _as_bytes(text: str) -> np.ndarray:
    return np.frombuffer(text.encode(), dtype=np.uint8)


def _base_payload(state: PoolState, result: ExperimentResult, fingerprint: Optional[str],
                  kernel: Optional[str] = None) -> dict:
    """The checkpoint fields, the mask over the real rows only (gathered
    from the shards on a mesh)."""
    mask = state_lib.global_labeled_mask(state)
    payload = {
        "labeled_mask": mask.cpu().numpy().astype(bool),
        "key": state.key.cpu().numpy().astype(np.uint32),
        "round": np.asarray(int(state.round), dtype=np.int32),
        "records_json": _as_bytes(json.dumps([dataclasses.asdict(r) for r in result.records])),
    }
    if fingerprint is not None:
        payload["config_fingerprint"] = _as_bytes(fingerprint)
    if kernel is not None:
        payload["forest_kernel"] = _as_bytes(kernel)
    return payload


def save(ckpt_dir: str, state: PoolState, result: ExperimentResult,
         fingerprint: Optional[str] = None, kernel: Optional[str] = None) -> str:
    """Write the checkpoint of the state's current round; returns its path.
    A write that fails raises."""
    from distributed_active_learning_tpu_torch.utils.io import atomic_savez

    payload = _base_payload(state, result, fingerprint, kernel)
    os.makedirs(ckpt_dir, exist_ok=True)
    return atomic_savez(os.path.join(ckpt_dir, f"alstate_{int(state.round)}.npz"), **payload)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(ckpt_dir) if (m := _STEP_RE.match(fn))]
    return max(steps) if steps else None


def _restore_base(z, step: int, state: PoolState, result: ExperimentResult,
                  fingerprint, kernel: Optional[str] = None) -> Tuple[PoolState, ExperimentResult]:
    """Rebuild (state, result) from an open npz payload, enforcing the
    fingerprint and pool-size guards and re-applying mesh padding. The
    restored mask is one tensor on the state's device (re-shard it on a
    mesh); the key lands on the CPU and the round as a Python int, the
    per-round driver's forms."""
    del result
    mask = np.asarray(z["labeled_mask"]).astype(bool)
    key = torch.from_numpy(np.asarray(z["key"]).astype(np.int64))
    rnd = int(z["round"])
    records = json.loads(bytes(z["records_json"]).decode())
    stored_fp = bytes(z["config_fingerprint"]).decode() if "config_fingerprint" in z.files else None
    accepted = (fingerprint,) if isinstance(fingerprint, str) else fingerprint
    if fingerprint is not None and stored_fp is not None and stored_fp not in accepted:
        raise ValueError(
            f"checkpoint config fingerprint {stored_fp} != current experiment "
            f"{accepted[0]}: refusing to resume a different experiment's state")
    if fingerprint is not None and stored_fp is None:
        warnings.warn(f"resuming unfingerprinted checkpoint alstate_{step}.npz: the "
                      "config-mismatch guard did not apply", stacklevel=3)
    stored_kernel = bytes(z["forest_kernel"]).decode() if "forest_kernel" in z.files else None
    if (kernel is not None and stored_kernel is not None and stored_kernel != kernel
            and not _kernel_swap_exact(stored_kernel, kernel)):
        warnings.warn(
            f"resuming a '{stored_kernel}' checkpoint under '{kernel}': the pallas kernel "
            "compares host-fit float features in bfloat16, so a vote whose feature sits within "
            "bf16 rounding (~0.4%) of a threshold can flip across this swap; the resumed curve "
            "may diverge from an uninterrupted run", stacklevel=3)
    n_stored = mask.shape[0]
    if n_stored == state.n_valid:
        # Padding rows read as labeled, so selection never picks them.
        mask = np.concatenate([mask, np.ones(state.n_pool - n_stored, dtype=bool)])
    elif n_stored != state.n_pool:  # n_pool: the legacy mask over padded rows
        raise ValueError(
            f"checkpoint pool size ({n_stored},) != experiment pool ({state.n_valid},)")
    new_state = state.replace(labeled_mask=torch.from_numpy(mask).to(state.labeled_mask.device),
                              key=key, round=rnd)
    return new_state, ExperimentResult.from_record_dicts(records)


def restore_latest(ckpt_dir: str, state: PoolState, result: ExperimentResult,
                   fingerprint=None, kernel: Optional[str] = None
                   ) -> Optional[Tuple[PoolState, ExperimentResult]]:
    """Load the newest checkpoint into (state, result); None if there is
    none. A stored fingerprint outside ``fingerprint`` (one hash or a tuple
    of accepted ones) raises; a kernel swap that is not vote-exact warns."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    with np.load(os.path.join(ckpt_dir, f"alstate_{step}.npz")) as z:
        return _restore_base(z, step, state, result, fingerprint, kernel)


# ---------------------------------------------------------------------------
# Batched launches: sweeps and grids
# ---------------------------------------------------------------------------

_SWEEP_STEP_RE = re.compile(r"^sweepstate_(\d+)\.npz$")
_GRID_STEP_RE = re.compile(r"^gridstate_(\d+)\.npz$")


def sweep_fingerprint(cfg, seeds, windows) -> str:
    """Identity hash of a batched sweep: the experiment's identity plus the
    seed and window vectors. The file stores every experiment's state by
    position, so it resumes only the same batch (the same seeds in the same
    order, the same windows)."""
    ident = _forest_ident(cfg, with_mesh=False)
    ident["sweep"] = {"seeds": [int(s) for s in seeds], "windows": [int(w) for w in windows]}
    return fingerprint_from_ident(ident)


def grid_fingerprint(cfg, strategies, seeds, datasets, windows, scenarios=None) -> str:
    """Identity hash of a grid launch: the sweep's extended with the strategy
    and dataset axes. The strategy and dataset names, the window and the
    seed of the anchoring config live in the axes, so they leave the base
    identity; the shared knobs (options, data path and sampling, forest,
    n_start) stay. A scenario axis (its kinds, in order) joins the identity
    only when present, so a clean grid's fingerprint is unchanged."""
    ident = _forest_ident(cfg, with_mesh=False)
    ident["strategy"].pop("name", None)
    ident["strategy"].pop("window_size", None)
    ident["data"].pop("name", None)
    ident.pop("seed", None)
    ident["grid"] = {
        "strategies": [str(s) for s in strategies],
        "seeds": [int(s) for s in seeds],
        "datasets": [str(d) for d in datasets],
        "windows": [int(w) for w in windows],
    }
    if scenarios:
        ident["grid"]["scenarios"] = [str(s) for s in scenarios]
    return fingerprint_from_ident(ident)


def _save_batched(ckpt_dir: str, prefix: str, masks, keys, rounds, results, n_cols: int,
                  fingerprint: Optional[str]) -> str:
    """One npz file covering every row (experiment or grid cell) of a batched
    launch, named after the largest round of its rows (a finished row's
    round freezes, so once every row has stopped later saves overwrite the
    same file). ``masks [rows, n]`` are cut to their first ``n_cols``
    columns (a grid's common width)."""
    from distributed_active_learning_tpu_torch.utils.io import atomic_savez

    rounds_np = np.asarray(torch.as_tensor(rounds).cpu(), dtype=np.int32)
    payload = {
        "labeled_mask": torch.as_tensor(masks).cpu().numpy().astype(bool)[:, :n_cols],
        "key": torch.as_tensor(keys).cpu().numpy().astype(np.uint32),
        "round": rounds_np,
        "records_json": _as_bytes(json.dumps(
            [[dataclasses.asdict(r) for r in res.records] for res in results])),
    }
    if fingerprint is not None:
        payload["config_fingerprint"] = _as_bytes(fingerprint)
    os.makedirs(ckpt_dir, exist_ok=True)
    return atomic_savez(os.path.join(ckpt_dir, f"{prefix}_{int(rounds_np.max())}.npz"), **payload)


def _latest_batched_step(ckpt_dir: str, step_re) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(ckpt_dir) if (m := step_re.match(fn))]
    return max(steps) if steps else None


def _restore_latest_batched(ckpt_dir: str, prefix: str, step_re, n_cols: int, n_rows: int,
                            fingerprint: Optional[str], kind: str, row_noun: str,
                            width_noun: str, width_target: str):
    """``(masks [rows, n_cols] bool, keys [rows, 2] int64, rounds [rows]
    int32, results)`` of the newest file, or None without one. A fingerprint
    or shape that is not this launch's raises: resuming another launch's
    state by position would cross-wire every row."""
    step = _latest_batched_step(ckpt_dir, step_re)
    if step is None:
        return None
    with np.load(os.path.join(ckpt_dir, f"{prefix}_{step}.npz")) as z:
        stored_fp = (bytes(z["config_fingerprint"]).decode()
                     if "config_fingerprint" in z.files else None)
        if fingerprint is not None and stored_fp is not None and stored_fp != fingerprint:
            raise ValueError(
                f"{kind} checkpoint fingerprint {stored_fp} != current {kind} "
                f"{fingerprint}: refusing to resume a different {kind}'s state")
        masks = np.asarray(z["labeled_mask"]).astype(bool)
        keys = np.asarray(z["key"]).astype(np.int64)
        rounds = np.asarray(z["round"]).astype(np.int32)
        records = json.loads(bytes(z["records_json"]).decode())
    if masks.shape[0] != n_rows:
        raise ValueError(
            f"{kind} checkpoint holds {masks.shape[0]} {row_noun}, the current {kind} has "
            f"{n_rows}")
    if masks.shape[1] != n_cols:
        raise ValueError(
            f"{kind} checkpoint {width_noun} ({masks.shape[1]},) != {width_target} ({n_cols},)")
    return masks, keys, rounds, [ExperimentResult.from_record_dicts(r) for r in records]


def save_sweep(ckpt_dir: str, masks, keys, rounds, results, n_valid: int,
               fingerprint: Optional[str] = None) -> str:
    """One checkpoint of all E experiments of a sweep: ``masks [E, n]``,
    ``keys [E, 2]`` and ``rounds [E]`` are the dispatch-time snapshot of the
    sweep's carry (``runtime.loop.ckpt_snapshot``)."""
    return _save_batched(ckpt_dir, "sweepstate", masks, keys, rounds, results, n_valid,
                         fingerprint)


def latest_sweep_step(ckpt_dir: str) -> Optional[int]:
    return _latest_batched_step(ckpt_dir, _SWEEP_STEP_RE)


def restore_latest_sweep(ckpt_dir: str, n_valid: int, n_experiments: int,
                         fingerprint: Optional[str] = None):
    """The newest sweep checkpoint as ``(masks [E, n_valid], keys [E, 2],
    rounds [E], results)``; None without one."""
    return _restore_latest_batched(
        ckpt_dir, "sweepstate", _SWEEP_STEP_RE, n_valid, n_experiments, fingerprint,
        kind="sweep", row_noun="experiments", width_noun="pool size",
        width_target="experiment pool")


def save_grid(ckpt_dir: str, masks, keys, rounds, results, n_store: int,
              fingerprint: Optional[str] = None) -> str:
    """One checkpoint of every cell of a grid: ``masks [C, n]`` cut to
    ``n_store``, the common width of its datasets' pools."""
    return _save_batched(ckpt_dir, "gridstate", masks, keys, rounds, results, n_store,
                         fingerprint)


def latest_grid_step(ckpt_dir: str) -> Optional[int]:
    return _latest_batched_step(ckpt_dir, _GRID_STEP_RE)


def restore_latest_grid(ckpt_dir: str, n_store: int, n_cells: int,
                        fingerprint: Optional[str] = None):
    """The newest grid checkpoint as ``(masks [C, n_store], keys [C, 2],
    rounds [C], results)``; None without one."""
    return _restore_latest_batched(
        ckpt_dir, "gridstate", _GRID_STEP_RE, n_store, n_cells, fingerprint,
        kind="grid", row_noun="cells", width_noun="pool width", width_target="grid slab")


# ---------------------------------------------------------------------------
# Neural experiments
# ---------------------------------------------------------------------------


def save_neural(ckpt_dir: str, state: PoolState, result: ExperimentResult, net_state,
                loop_key: torch.Tensor, fingerprint: Optional[str] = None) -> str:
    """A neural experiment's checkpoint: the base fields plus the loop's key
    (``loop_key``), the network's step (``net_step``), its parameters
    (``net_param_<i>``) and its adam state (``net_opt_<i>``: the count, then
    the first and the second moments), numbered in the order of the flax
    tree's leaves and stored in flax's layouts: the JAX package's file, so
    either package resumes the other's."""
    from distributed_active_learning_tpu_torch.interop import flax_leaf_order
    from distributed_active_learning_tpu_torch.models.neural import to_flax_layout
    from distributed_active_learning_tpu_torch.utils.io import atomic_savez

    payload = _base_payload(state, result, fingerprint)
    payload["loop_key"] = loop_key.cpu().numpy().astype(np.uint32)
    payload["net_step"] = np.asarray(int(net_state.step), dtype=np.int32)
    names = flax_leaf_order(net_state.params)

    def flax_np(name, t):
        return np.ascontiguousarray(to_flax_layout(name, t.detach().cpu().numpy()))

    for i, k in enumerate(names):
        payload[f"net_param_{i}"] = flax_np(k, net_state.params[k])
    opt = net_state.opt_state
    leaves = ([np.asarray(int(opt.count), dtype=np.int32)]
              + [flax_np(k, opt.mu[k]) for k in names] + [flax_np(k, opt.nu[k]) for k in names])
    for i, leaf in enumerate(leaves):
        payload[f"net_opt_{i}"] = leaf
    os.makedirs(ckpt_dir, exist_ok=True)
    return atomic_savez(os.path.join(ckpt_dir, f"alstate_{int(state.round)}.npz"), **payload)


def _numbered(z, prefix: str, count: int, step: int) -> list:
    stored = sorted(int(k[len(prefix):]) for k in z.files if k.startswith(prefix))
    if stored != list(range(count)):
        raise ValueError(
            f"checkpoint alstate_{step}.npz holds {len(stored)} '{prefix}*' arrays but the "
            f"network has {count}: not a checkpoint of this model (or not a neural checkpoint)")
    return [z[f"{prefix}{i}"] for i in range(count)]


def restore_latest_neural(ckpt_dir: str, state: PoolState, result: ExperimentResult,
                          template_net_state, fingerprint: Optional[str] = None):
    """Load the newest neural checkpoint: ``(state, result, net_state,
    loop_key)``, or None when there is none. The network is rebuilt against
    ``template_net_state`` (a freshly initialized TrainState, on the device
    it is to live on): a leaf count or shape that differs raises."""
    from distributed_active_learning_tpu_torch.interop import flax_leaf_order
    from distributed_active_learning_tpu_torch.models.neural import (
        AdamState,
        TrainState,
        to_port_layout,
    )

    step = latest_step(ckpt_dir)
    if step is None:
        return None
    names = flax_leaf_order(template_net_state.params)
    tmpl = template_net_state.params
    dev = tmpl[names[0]].device
    with np.load(os.path.join(ckpt_dir, f"alstate_{step}.npz")) as z:
        new_state, new_result = _restore_base(z, step, state, result, fingerprint)
        if "loop_key" not in z.files:
            raise ValueError(
                f"alstate_{step}.npz is not a neural checkpoint (no loop_key/network arrays) "
                "- it was written by the forest loop")
        loop_key = torch.from_numpy(np.asarray(z["loop_key"]).astype(np.int64))
        params_np = _numbered(z, "net_param_", len(names), step)
        opt_np = _numbered(z, "net_opt_", 1 + 2 * len(names), step)
        net_step = int(z["net_step"])

    def port(name, arr):
        t = torch.from_numpy(np.ascontiguousarray(to_port_layout(name, np.asarray(arr))))
        if tuple(t.shape) != tuple(tmpl[name].shape):
            raise ValueError(f"checkpoint leaf {name} shape {tuple(t.shape)} != network leaf "
                             f"shape {tuple(tmpl[name].shape)}: different architecture")
        return t.to(torch.float32).to(dev)

    k = len(names)
    net = TrainState(
        params={n: port(n, a) for n, a in zip(names, params_np)},
        opt_state=AdamState(torch.tensor(int(opt_np[0]), dtype=torch.int32, device=dev),
                            {n: port(n, a) for n, a in zip(names, opt_np[1:1 + k])},
                            {n: port(n, a) for n, a in zip(names, opt_np[1 + k:])}),
        step=torch.tensor(net_step, dtype=torch.int32, device=dev))
    return new_state, new_result, net, loop_key
