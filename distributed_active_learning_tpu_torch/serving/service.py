"""Streaming AL service: the single-tenant front of the tenant manager (the
port of ``serving/service.py``).

:class:`ALService` routes through a 1-tenant
:class:`~.tenants.TenantManager`: there is ONE event loop
(:class:`~.tenants.Tenant`). This module keeps the single-tenant surface:
the constructor, ``score``/``submit``/``flush``/``refit_now``/
``save_checkpoint``/``summary``/``recompiles_after_warmup``, the ``bench
--mode serve`` key set (``summary()``'s keys are the JAX package's, byte for
byte), and the tenant-less ``servestate_<round>.npz`` checkpoint names. The
wrapper inherits the capacity precompile (a slab growth swaps in a chunk
graph captured ahead) and the tenant-tagged telemetry. ``device`` defaults
to CUDA and raises without a card unless it is ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from distributed_active_learning_tpu_torch.config import ExperimentConfig, ServeConfig
from distributed_active_learning_tpu_torch.serving.tenants import (  # noqa: F401
    ServeStats,
    Tenant,
    TenantManager,
    _CapacityPrograms,
    _ProgramTracker,
)


class ALService:
    """The long-running single-tenant service driver (compatibility front).

    ``cfg`` supplies the model/strategy/seeding half (the same
    :class:`ExperimentConfig` the batch drivers take — ``forest.fit`` must be
    ``"device"``; the whole point is a resident device loop); ``serve``
    supplies the streaming knobs. ``train_x/train_y`` seed the pool (the
    service's cold-start corpus), ``test_x/test_y`` feed the chunk's accuracy
    eval exactly as in the batch loop. Internally this is a
    :class:`~serving.tenants.TenantManager` holding one tenant named
    ``default`` — no duplicated event loop.
    """

    def __init__(
        self,
        cfg: ExperimentConfig,
        serve: ServeConfig,
        train_x,
        train_y,
        test_x,
        test_y,
        metrics=None,
        checkpoint_dir: Optional[str] = None,
        device=None,
    ):
        self.manager = TenantManager(metrics=metrics, checkpoint_dir=checkpoint_dir,
                                     device=device)
        if metrics is not None:
            metrics.meta(
                config=dataclasses.asdict(cfg),
                serve=dataclasses.asdict(serve),
                backend=self.manager.device.type,
                loop="serve",
            )
        # ckpt_name=None keeps the single-tenant checkpoint file names,
        # so services started before the tenant axis existed keep resuming.
        self._tenant = self.manager.add_tenant(
            "default", cfg, serve, train_x, train_y, test_x, test_y,
            ckpt_name=None,
        )

    # -- the public endpoints (delegation, not reimplementation) -------------

    def score(self, queries) -> np.ndarray:
        return self._tenant.score(queries)

    def submit(self, x, y) -> None:
        self._tenant.submit(x, y)

    def flush(self) -> None:
        self._tenant.flush()

    def refit_now(self, reason: str = "manual") -> bool:
        return self._tenant.refit_now(reason)

    def save_checkpoint(self) -> Optional[str]:
        return self._tenant.save_checkpoint()

    def recompiles_after_warmup(self) -> int:
        return self.manager.recompiles_after_warmup()

    def summary(self) -> Dict:
        """The JAX package's single-tenant key set, byte-compatible (``bench
        --mode serve`` reads these names)."""
        t = self._tenant
        out = {
            "queries": t.stats.queries,
            "scored_points": t.stats.scored_points,
            "ingest_blocks": t.stats.ingest_blocks,
            "ingested_points": t.stats.ingested_points,
            "refits": t.stats.refits,
            "refit_rounds": t.stats.refit_rounds,
            "refit_reasons": dict(t.refit_reasons),
            "refits_skipped_fit_budget": t.stats.refits_skipped_fit_budget,
            "slab_growths": t.stats.slab_growths,
            "capacity": t._slab.capacity,
            "fill": t._fill,
            "labeled": t._labeled,
            "recompiles_after_warmup": self.recompiles_after_warmup(),
        }
        if t.slo is not None:
            # present ONLY when ServeConfig configures an objective, so the
            # key set of an SLO-less service is untouched
            out["slo"] = t.slo.snapshot()
        return out

    # -- state passthroughs (tests, __main__, and benches read these) --------

    @property
    def cfg(self) -> ExperimentConfig:
        return self._tenant.cfg

    @property
    def serve(self) -> ServeConfig:
        return self._tenant.serve

    @property
    def metrics(self):
        return self._tenant.metrics

    @property
    def checkpoint_dir(self) -> Optional[str]:
        return self._tenant.checkpoint_dir

    @property
    def stats(self) -> ServeStats:
        return self._tenant.stats

    @property
    def refit_reasons(self) -> Dict[str, int]:
        return self._tenant.refit_reasons

    @property
    def result(self):
        return self._tenant.result

    @property
    def n_classes(self) -> int:
        return self._tenant.n_classes

    @property
    def drift(self):
        return self._tenant.drift

    @property
    def _slab(self):
        return self._tenant._slab

    @property
    def _aux(self):
        return self._tenant._aux

    @property
    def _fill(self) -> int:
        return self._tenant._fill

    @property
    def _labeled(self) -> int:
        return self._tenant._labeled

    @property
    def _forest(self):
        return self._tenant._forest
