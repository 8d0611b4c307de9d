"""Shared host-side utilities."""

from distributed_active_learning_tpu_torch.utils.io import atomic_savez  # noqa: F401
