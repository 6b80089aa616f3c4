"""Engine span timer (port of ``engine/profiling.py``'s :class:`SpanTimer`).

Accumulates named wall-time spans (prefill, decode) that
``Engine.telemetry()`` reports. Device traces are ``torch.profiler``'s
(``chip_smoke.py --profile``), so the JAX module's ``device_trace`` and
``annotate`` have no counterpart here.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class SpanTimer:
    """Accumulating named wall-time spans (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add(name, time.monotonic() - t0)

    def add(self, name: str, dt: float) -> None:
        """Record an externally timed span."""
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def summary(self) -> dict:
        with self._lock:
            return {
                name: {
                    "total_s": round(self.totals[name], 4),
                    "count": self.counts[name],
                    "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
                }
                for name in sorted(self.totals)
            }
