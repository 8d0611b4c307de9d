"""Streaming AL as an online service (the port of ``serving/``).

- :mod:`serving.slab` — the slab-paged pool: slab-quantized capacity, the
  fill watermark on the device, in-place ingest, fixed-width resident
  scoring;
- :mod:`serving.drift` — entropy/margin drift triggers deciding when a
  re-fit chunk launch is worth dispatching;
- :mod:`serving.tenants` — the multi-tenant core: N resident tenants in one
  process, grouped scoring, tenant-axis batched re-fits (the grid chunk with
  tenants as the dataset axis), one CUDA graph a capacity with the next
  capacity captured ahead by a background worker;
- :mod:`serving.frontend` — the thread-safe/asyncio front queue: admission
  control, per-tenant fairness, re-fit backpressure, one dispatcher thread
  owning all device work;
- :mod:`serving.service` — the single-tenant front (:class:`ALService`
  routes through a 1-tenant manager).

Entry points: ``python -m distributed_active_learning_tpu_torch.serving``
(a simulated stream over a registry dataset) and ``python -m
distributed_active_learning_tpu_torch.bench --mode serve|serve-multi``. The
multi-process fleet (``serving/fleet.py`` of the JAX package, ``bench
--mode serve-fleet``) is not ported yet (ROADMAP queue 1 item 7's fleet
remainder); importing its names raises, naming it.
"""

from distributed_active_learning_tpu_torch.serving.drift import DriftMonitor  # noqa: F401
from distributed_active_learning_tpu_torch.serving.frontend import (  # noqa: F401
    AdmissionError,
    ServiceFrontend,
)
from distributed_active_learning_tpu_torch.serving.service import ALService  # noqa: F401
from distributed_active_learning_tpu_torch.serving.slab import (  # noqa: F401
    SlabPool,
    flat_state,
    grow_slab,
    init_slab_pool,
    make_ingest_fn,
    make_score_fn,
)
from distributed_active_learning_tpu_torch.serving.tenants import (  # noqa: F401
    ServeStats,
    Tenant,
    TenantManager,
    make_batched_score_fn,
)

_FLEET = ("Fleet", "HashRing", "RouterServer", "TenantSpec", "fleet")


def __getattr__(name: str):
    if name in _FLEET:
        raise NotImplementedError(
            f"serving.{name} is the multi-process fleet, which is not ported yet "
            "(ROADMAP queue 1 item 7, the fleet remainder)")
    if name == "RebalanceHysteresis":
        raise NotImplementedError(
            "serving.RebalanceHysteresis is the pod-sharded slab pool's, which comes with the "
            "mesh-and-pod slice (ROADMAP queue 1 item 8)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
