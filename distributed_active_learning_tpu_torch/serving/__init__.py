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
  routes through a 1-tenant manager);
- :mod:`serving.fleet` — the shared-nothing multi-process fleet: N spawned
  worker processes (each a whole manager, frontend and ops plane on its
  device) behind a consistent-hash router with health-gated forwarding.

Entry points: ``python -m distributed_active_learning_tpu_torch.serving``
(a simulated stream over a registry dataset) and ``python -m
distributed_active_learning_tpu_torch.bench --mode
serve|serve-multi|serve-fleet``. The pod-sharded slab pool (a pool over a
mesh's data axis, its sharded ingest and its rebalance epochs) is in
:mod:`serving.slab`; ``--mode round`` of the bench times its pod legs.
"""

from distributed_active_learning_tpu_torch.serving.drift import DriftMonitor  # noqa: F401
from distributed_active_learning_tpu_torch.serving.fleet import (  # noqa: F401
    Fleet,
    HashRing,
    RouterServer,
    TenantSpec,
)
from distributed_active_learning_tpu_torch.serving.frontend import (  # noqa: F401
    AdmissionError,
    ServiceFrontend,
)
from distributed_active_learning_tpu_torch.serving.service import ALService  # noqa: F401
from distributed_active_learning_tpu_torch.serving.slab import (  # noqa: F401
    RebalanceHysteresis,
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

