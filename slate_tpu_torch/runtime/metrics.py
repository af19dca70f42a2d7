"""Serving metrics: monotone counters, gauges and latency histograms
with p50/p99 (counterpart of ``slate_tpu/runtime/metrics.py``, same
counter names for what the slice serves)."""

from __future__ import annotations

import collections
import threading
from typing import Dict


class Histogram:
    """Exact count/sum/min/max plus the most recent ``cap`` samples for
    nearest-rank percentiles."""

    def __init__(self, cap: int = 8192):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = 0.0
        self._samples = collections.deque(maxlen=cap)

    def observe(self, value: float):
        self.count += 1
        self.total += value
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)
        self._samples.append(value)

    def percentile(self, q: float) -> float:
        """q in [0, 100]; nearest rank over the retained window."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        return s[min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))]

    def snapshot(self) -> Dict[str, float]:
        empty = self.count == 0
        return {"count": self.count, "sum": self.total,
                "min": None if empty else self.vmin,
                "max": None if empty else self.vmax,
                "mean": None if empty else self.total / self.count,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class Metrics:
    """Thread-safe registry of one Session.

    Counters: solves_total, dispatches_total, cache_hits, cache_misses,
    evictions, evicted_bytes, factors_total, flops_total,
    factor_flops_total, solve_flops_total, budget_overflows.
    Histograms (seconds): factor_latency, solve_latency.
    Gauges: resident_bytes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._hists: Dict[str, Histogram] = {}
        self._gauges: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] += value

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def set_gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)

    def histogram(self, name: str) -> Dict[str, float]:
        with self._lock:
            h = self._hists.get(name)
            return (h or Histogram()).snapshot()

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self._counters),
                    "histograms": {k: h.snapshot()
                                   for k, h in self._hists.items()},
                    "gauges": dict(self._gauges)}
