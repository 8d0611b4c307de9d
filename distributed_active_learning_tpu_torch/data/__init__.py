"""Data layer of the port: file-format parsers (on the native loader),
standardization, synthetic generators and the dataset registry."""

from distributed_active_learning_tpu_torch.data.formats import (
    load_labeled_text,
    load_credit_card_csv,
    load_triplet_text,
    write_triplet_text,
)
from distributed_active_learning_tpu_torch.data.scaler import (
    StandardScalerState,
    fit_standard_scaler,
    transform,
    fit_transform,
)
from distributed_active_learning_tpu_torch.data.synthetic import (
    make_xor,
    make_checkerboard,
    make_rotated_checkerboard,
    make_gaussian_unbalanced,
    make_random_matrix,
)
from distributed_active_learning_tpu_torch.data.datasets import (
    DataBundle,
    get_dataset,
    register_dataset,
    available_datasets,
)

__all__ = [
    "load_labeled_text",
    "load_credit_card_csv",
    "load_triplet_text",
    "write_triplet_text",
    "StandardScalerState",
    "fit_standard_scaler",
    "transform",
    "fit_transform",
    "make_xor",
    "make_checkerboard",
    "make_rotated_checkerboard",
    "make_gaussian_unbalanced",
    "make_random_matrix",
    "DataBundle",
    "get_dataset",
    "register_dataset",
    "available_datasets",
]
