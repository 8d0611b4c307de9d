"""Device resolution shared by every entry point of the port.

Entry points default to CUDA and raise when no card is present, unless the
caller names the CPU explicitly (as the tests do): a run that silently fell
back to the CPU would report CPU numbers under a GPU's name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means CUDA. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: "
                "--device cpu) to run the port's plain PyTorch versions"
            )
        # The device fit relies on f32 products and sums of small integers
        # being exact (histogram counts, prefix sums, one-hot contractions);
        # TF32 keeps 10 mantissa bits and would round them. Both switches are
        # set explicitly: cuDNN's default is TF32 on.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (phase timing); no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def deterministic_cuda() -> None:
    """Same bits every run on the card for the neural path: cuDNN takes only
    deterministic convolution algorithms (its default backward ones add with
    atomics) and does not benchmark, and cuBLAS gets the fixed per-stream
    workspace PyTorch documents for reproducible products
    (``CUBLAS_WORKSPACE_CONFIG=:4096:8``; it takes effect only if set before
    the process's first cuBLAS call, so a script that needs it sets it at
    start). The embedding gradient is a one-hot product
    (``models/transformer.py``), so no operation of the path adds with
    atomics."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
