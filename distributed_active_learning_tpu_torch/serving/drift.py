"""Drift-aware re-fit triggers for the streaming AL service (a copy of the
JAX package's ``serving/drift.py``, which is pure Python).

A batch AL loop re-fits on a fixed cadence because nothing else changes; a
service should re-fit when the WORLD changes — the incoming traffic no longer
looks like what the resident forest was trained on, or the last labeling
round's selection boundary collapsed. Both signals already exist in the
codebase, free:

- **Serve-time entropy** — the scoring endpoint returns per-query predictive
  entropy alongside the scores (serving/slab.py ``make_score_fn``); an EMA of
  the served batches is the live view of the traffic.
- **Chunk RoundMetrics** — every fused re-fit chunk ships per-round
  device-computed metrics in its scan ys (runtime/telemetry.py); the final
  round's pool entropy is the baseline the live EMA drifts against, and the
  chunk-mean selection margin shifting between consecutive chunks flags a
  crowding/thinning boundary.

:class:`DriftMonitor` folds these into one host-side decision,
``should_refit``, with a staleness backstop so a quiet-but-drifting stream
still re-fits eventually. It is pure host arithmetic — no device work, no
syncs — and deterministic (pinned unit tests in the JAX package's tests/test_serving.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

_EPS = 1e-6


class DriftMonitor:
    """Entropy/margin drift thresholds deciding when a re-fit chunk launch
    is worth dispatching (instead of a fixed round cadence).

    ``entropy_shift``/``margin_shift`` are RELATIVE thresholds: a trigger
    fires when the live signal departs its baseline by more than that
    fraction. Entropy and margin triggers additionally require at least
    ``min_fresh`` points ingested since the last re-fit — drift with nothing
    new to label is not actionable by a labeling round. ``max_staleness``
    (serve observations since the last re-fit; 0 disables) is the backstop
    cadence of last resort.
    """

    def __init__(
        self,
        entropy_shift: float = 0.25,
        margin_shift: float = 0.5,
        min_fresh: int = 32,
        max_staleness: int = 512,
        ema: float = 0.2,
    ):
        self.entropy_shift = entropy_shift
        self.margin_shift = margin_shift
        self.min_fresh = min_fresh
        self.max_staleness = max_staleness
        self.ema = ema
        self.baseline_entropy: Optional[float] = None
        self.baseline_margin: Optional[float] = None
        self.serve_entropy: Optional[float] = None
        self.fresh_points = 0
        self.serves_since_refit = 0
        self._margin_shifted = False

    # -- observations --------------------------------------------------------

    def observe_serve(self, mean_entropy: float) -> None:
        """One served batch's mean predictive entropy (EMA-folded)."""
        self.serves_since_refit += 1
        if self.serve_entropy is None:
            self.serve_entropy = float(mean_entropy)
        else:
            self.serve_entropy += self.ema * (
                float(mean_entropy) - self.serve_entropy
            )

    def observe_ingest(self, n_points: int) -> None:
        self.fresh_points += int(n_points)

    def observe_chunk(self, round_metrics: List[Dict]) -> None:
        """Fold one re-fit chunk's in-scan RoundMetrics stream.

        The final active round's ``pool_entropy`` becomes the new entropy
        baseline (and re-seeds the live EMA — the forest just re-fit, so the
        served traffic SHOULD look like the pool again); the chunk-mean
        ``score_margin`` is compared against the previous chunk's to detect a
        boundary shift, then replaces it.
        """
        self.fresh_points = 0
        self.serves_since_refit = 0
        self._margin_shifted = False
        ents = [m["pool_entropy"] for m in round_metrics if m.get("pool_entropy") is not None]
        margins = [m["score_margin"] for m in round_metrics if m.get("score_margin") is not None]
        if ents:
            self.baseline_entropy = float(ents[-1])
            self.serve_entropy = float(ents[-1])
        if margins:
            mean_margin = float(sum(margins) / len(margins))
            if self.baseline_margin is not None:
                denom = max(abs(self.baseline_margin), _EPS)
                if abs(mean_margin - self.baseline_margin) / denom > self.margin_shift:
                    self._margin_shifted = True
            self.baseline_margin = mean_margin

    # -- the decision --------------------------------------------------------

    def entropy_drift(self) -> Optional[float]:
        """Relative departure of the live serve-entropy EMA from the last
        chunk's pool-entropy baseline (None until both exist)."""
        if self.baseline_entropy is None or self.serve_entropy is None:
            return None
        denom = max(abs(self.baseline_entropy), _EPS)
        return abs(self.serve_entropy - self.baseline_entropy) / denom

    def should_refit(self) -> Optional[str]:
        """The re-fit decision: a reason string, or None to keep serving.

        Checked cheapest-signal-first; the reason rides the service's
        ``refit`` JSONL event so a metrics stream explains every chunk
        launch.
        """
        if self.fresh_points >= self.min_fresh:
            drift = self.entropy_drift()
            if drift is not None and drift > self.entropy_shift:
                return "entropy_shift"
            if self._margin_shifted:
                return "margin_shift"
        if self.max_staleness and self.serves_since_refit >= self.max_staleness:
            return "staleness"
        return None
