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
