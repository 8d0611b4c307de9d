"""PyTorch/CUDA port of ``distributed_active_learning_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; this package keeps its
module layout and function names so each port module has an obvious
counterpart (``ops/trees_pallas.py`` here mirrors ``ops/trees_pallas.py``
there). It imports ``torch`` and never ``jax`` or anything of the JAX package.

What is ported: the forest AL loop (``runtime.loop.run_experiment``) with
the device fit or the host (scikit-learn) fit, per round or chunked, on one
device or a ``(data, model)`` mesh; the gather, path-matrix and kernel forms
of a forest (``ops/trees.py``, ``ops/trees_gemm.py``, ``ops/trees_pallas.py``)
and forest files (``models/forest_io.py``); the core strategies and density;
the data layer (``data/``: every dataset registry entry, the file parsers on
the native loader built from ``cpp/loader.cpp``); and the port's bench. Every Pallas kernel of the JAX package is rewritten as
hand-written CUDA C++ for ``sm_90a`` (``csrc/``), among them:

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
