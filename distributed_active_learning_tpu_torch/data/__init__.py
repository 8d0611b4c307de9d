"""Datasets (registry, synthetic generators, scaling) of the port."""

from distributed_active_learning_tpu_torch.data.datasets import (
    DataBundle,
    available_datasets,
    get_dataset,
)

__all__ = ["DataBundle", "available_datasets", "get_dataset"]
