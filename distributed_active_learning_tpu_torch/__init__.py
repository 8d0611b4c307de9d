"""PyTorch/CUDA port of ``distributed_active_learning_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; this package keeps its
module layout and function names so each port module has an obvious
counterpart (``ops/trees_pallas.py`` here mirrors ``ops/trees_pallas.py``
there). It imports ``torch`` and never ``jax`` or anything of the JAX package.

What is ported: the device-fit forest AL loop, one round per host step
(``runtime.loop.run_experiment``), with the two Pallas kernels on its path
rewritten as hand-written CUDA C++ for ``sm_90a``:

- ``csrc/forest_leaves.cu``: per-tree leaf values (``ForestConfig.kernel=
  "pallas"``), replacing ``trees_pallas._kernel``;
- ``csrc/round_megakernel.cu``: forest eval -> vote score -> per-tile top-k
  in one pass (``ExperimentConfig.fused_round``), replacing
  ``round_fused._mega_kernel``.

Randomness reproduces ``jax.random``'s partitionable threefry bit for bit
(``prng.py``), so picks and masks match the JAX package end to end.

Every entry point takes an explicit ``device`` that defaults to CUDA and
refuses to run when no card is present unless the caller asks for the CPU
(``device.resolve_device``); on the CPU each kernel wrapper takes its plain
PyTorch version.
"""

__version__ = "0.1.0"

from distributed_active_learning_tpu_torch import config  # noqa: F401, E402
