"""numpy-only converters that carry a forest or pool state of the JAX package
into the port (``np.asarray`` of each field of the JAX pytree on one side,
torch tensors on the other). They import nothing of JAX; the tests use them
to feed one forest and one state to both packages."""

from __future__ import annotations

import numpy as np
import torch

from distributed_active_learning_tpu_torch.ops.trees_gemm import GemmForest
from distributed_active_learning_tpu_torch.ops.trees_pallas import PallasForest
from distributed_active_learning_tpu_torch.runtime.state import PoolState


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype, order="C")).to(device)


def _stored(a, device) -> torch.Tensor:
    """A threshold or leaf array in its storage dtype: a quantized forest's
    bfloat16 (numpy's ``ml_dtypes`` type) or int8 is kept, anything else
    becomes float32."""
    a = np.array(a, order="C")
    if a.dtype == np.int8:
        return torch.from_numpy(a).to(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return _t(a, np.float32, device)


def gemm_forest_from_numpy(
    feat_ids, thresholds, path, target, value, device="cpu", pallas: bool = False
):
    """A :class:`GemmForest` (or a :class:`PallasForest` with ``pallas``)
    from the arrays of a JAX ``GemmForest``; a quantized forest keeps its
    storage dtypes."""
    gf = GemmForest(
        feat_ids=_t(feat_ids, np.int32, device),
        thresholds=_stored(thresholds, device),
        path=_t(path, np.float32, device),
        target=_t(target, np.float32, device),
        value=_stored(value, device),
    )
    return PallasForest(gf=gf) if pallas else gf


def pool_state_from_numpy(x, oracle_y, labeled_mask, key_data, round=0, device="cpu") -> PoolState:
    """A :class:`PoolState` from a JAX ``PoolState``'s arrays; ``key_data``
    is ``jax.random.key_data(state.key)`` (two uint32 words)."""
    kd = np.asarray(key_data, dtype=np.uint32).astype(np.int64)
    return PoolState(
        x=_t(x, np.float32, device),
        oracle_y=_t(oracle_y, np.int32, device),
        labeled_mask=_t(labeled_mask, np.bool_, device),
        key=torch.as_tensor(kd),
        round=int(round),
    )


def flax_path(name: str) -> tuple:
    """A port parameter name's flax path: ``"Dense_0.weight"`` ->
    ``("Dense_0", "kernel")``."""
    parts = name.split(".")
    return tuple(parts[:-1]) + ({"weight": "kernel"}.get(parts[-1], parts[-1]),)


def flax_leaf_order(names) -> list:
    """Port parameter names in the order of ``jax.tree_util.tree_leaves`` of
    the flax params tree (keys sorted at every level)."""
    return sorted(names, key=flax_path)


def neural_params_from_numpy(params, module, device="cpu") -> dict:
    """A flax params tree of numpy arrays (nested dicts) as the port
    module's state dict: Dense ``[in, out]`` -> ``[out, in]``, Conv ``HWIO`` ->
    ``OIHW``, Embed tables and LayerNorm scales and biases as they are. The
    names must be the module's."""
    from distributed_active_learning_tpu_torch.models.neural import to_port_layout

    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v

    walk(params, ())
    out = {}
    for path, arr in flat.items():
        name = ".".join(path[:-1] + ({"kernel": "weight"}.get(path[-1], path[-1]),))
        out[name] = _t(to_port_layout(name, np.asarray(arr, dtype=np.float32)), np.float32, device)
    expected = set(module.param_names())
    if set(out) != expected:
        raise ValueError(f"flax params {sorted(out)} are not those of {type(module).__name__}: "
                         f"{sorted(expected)}")
    return out


def neural_params_to_numpy(state_dict, module=None) -> dict:
    """The inverse of :func:`neural_params_from_numpy`: a nested dict of
    numpy arrays in flax's names and layouts."""
    from distributed_active_learning_tpu_torch.models.neural import to_flax_layout

    out: dict = {}
    for name, v in state_dict.items():
        path = flax_path(name)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(to_flax_layout(name, v.detach().cpu().numpy()))
    return out
