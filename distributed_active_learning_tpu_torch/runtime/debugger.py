"""Structured phase timing (the port of ``runtime/debugger.py``).

Each phase records ``(label, seconds)``; the per-round driver synchronizes
the device inside the phase (where the JAX driver calls
``block_until_ready``), so a phase's time covers its device work. Phases are
also ``torch.profiler.record_function`` spans, so a profiler trace
(:func:`profiler_trace`, ``run.py --profile-dir``) shows the
train/round/eval segments by name.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple


class Debugger:
    """Phase timer with structured ``(label, seconds)`` records.

    ``phase_detail`` asks for per-phase (train / acquire / eval) splits,
    which a chunked driver cannot attribute inside one launch: the neural
    driver then takes its per-round loop (as the JAX package's does)."""

    def __init__(self, enabled: bool = True, printer=print, phase_detail=None):
        self.enabled = enabled
        self.printer = printer
        self.phase_detail = bool(phase_detail) if phase_detail is not None else False
        self.records: List[Tuple[str, float]] = []
        self._start = time.perf_counter()
        self._last = self._start

    def timestamp(self, label: str) -> float:
        """Record the seconds since the previous timestamp under ``label``
        (printed with the running total when enabled) and return them."""
        now = time.perf_counter()
        elapsed = now - self._last
        self._last = now
        self.records.append((label, elapsed))
        if self.enabled:
            self.printer(f"[{label}] {elapsed:.3f}s (total {now - self._start:.3f}s)")
        return elapsed

    def debug(self, *args) -> None:
        if self.enabled:
            self.printer("[DEBUG]", *args)

    @contextlib.contextmanager
    def phase(self, label: str):
        import torch.profiler

        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"al_phase/{label}"):
                yield
        finally:
            elapsed = time.perf_counter() - t0
            self.records.append((label, elapsed))
            if self.enabled:
                self.printer(f"[{label}] {elapsed:.3f}s")

    def totals(self) -> Dict[str, float]:
        """Seconds summed per label."""
        out: Dict[str, float] = {}
        for label, elapsed in self.records:
            out[label] = out.get(label, 0.0) + elapsed
        return out

    def total_time(self) -> float:
        return time.perf_counter() - self._start


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Wrap a block in a ``torch.profiler`` trace when ``log_dir`` is set:
    host activity, and the card's kernels and copies when the block runs on
    CUDA, written as a Chrome trace (``<log_dir>/trace_<pid>.json``, open in
    Perfetto or ``chrome://tracing``)."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
