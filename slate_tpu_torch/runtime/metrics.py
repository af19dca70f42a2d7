"""Serving metrics: monotone counters, gauges and latency histograms
with p50/p99, the derived serving rates, and JSON / Prometheus text
export (counterpart of ``slate_tpu/runtime/metrics.py``, with the same
names for what the port serves). ``phase`` times a block into a
histogram; it records no span (tracing is ROADMAP Queue 1 item 10)."""

from __future__ import annotations

import collections
import json
import re
import threading
import time
from typing import Dict, Optional


class Histogram:
    """Exact count/sum/min/max plus the most recent ``cap`` samples for
    nearest-rank percentiles, and the exemplar of the worst tagged
    observation (a join key the caller passes)."""

    __slots__ = ("cap", "count", "total", "vmin", "vmax", "_samples",
                 "exemplar")

    def __init__(self, cap: int = 8192):
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = 0.0
        self._samples = collections.deque(maxlen=cap)
        self.exemplar: Optional[Dict[str, float]] = None

    def observe(self, value: float, exemplar=None):
        self.count += 1
        self.total += value
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)
        if exemplar is not None and (self.exemplar is None
                                     or value >= self.exemplar["value"]):
            self.exemplar = {"trace_id": exemplar, "value": value}
        self._samples.append(value)

    def percentile(self, q: float) -> float:
        """q in [0, 100]; nearest rank over the retained window."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        return s[min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))]

    def snapshot(self) -> Dict[str, float]:
        # min/max/mean are None while empty: a fabricated 0.0 would read
        # as a real zero-latency sample
        empty = self.count == 0
        return {"count": self.count, "sum": self.total,
                "min": None if empty else self.vmin,
                "max": None if empty else self.vmax,
                "mean": None if empty else self.total / self.count,
                "p50": self.percentile(50), "p99": self.percentile(99),
                "exemplar": dict(self.exemplar) if self.exemplar else None}


class Metrics:
    """Thread-safe registry of one Session.

    Counters (monotone): solves_total, requests_total, batches_total,
    dispatches_total, batched_programs, cache_hits, cache_misses,
    evictions, evicted_bytes, factors_total, retries, aot_compiles
    (CUDA graph captures), graph_replays,
    flops_total (factor + solve work), factor_flops_total,
    solve_flops_total, budget_overflows; the request outcomes
    completed_requests, failed_requests_total, deadline_expired_total,
    shed_requests_total, admission_rejected_total and
    cancelled_requests, which partition requests_total; failed_batches,
    load_sheds_total, degraded_dispatches_total, breaker_trips_total,
    breaker_probes_total, breaker_closes_total, breaker_short_circuits,
    faults_injected_total and fault:{kind}; mixed precision:
    refine_converged_total, refine_fallbacks_total (a low-precision factor
    that failed, or a refined solve that did not converge, served at
    working precision), refine_demotions_total (the Executor's
    working_precision rung) and refine_flops_total (the refinement
    steps' residual gemms and factor applies, also in flops_total).
    Histograms (seconds, except batch_size and refine_iterations):
    factor_latency, solve_latency, request_latency, batch_size,
    warmup_compile_latency, retry_backoff_s, refine_iterations (residual
    checks per refined solve), and the request stages stage_queue_wait,
    stage_batch_form, stage_reply.
    Gauges (set, not incremented): resident_bytes; queue_depth,
    queued_buckets, oldest_request_age_s, max_bucket_backlog (Batcher),
    inflight_batches (Executor), shedding_active,
    circuit_breakers_open."""

    def __init__(self, clock=time.time):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._hists: Dict[str, Histogram] = {}
        self._gauges: Dict[str, float] = {}
        # every gauge write is stamped with the clock at set time
        self._gauge_ts: Dict[str, float] = {}
        self._clock = clock
        self._t0 = time.perf_counter()

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] += value

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def set_gauge(self, name: str, value: float,
                  t: Optional[float] = None):
        """Point-in-time gauge, last write wins; ``t`` overrides the
        clock's timestamp."""
        now = self._clock() if t is None else t
        with self._lock:
            self._gauges[name] = float(value)
            self._gauge_ts[name] = now

    def set_gauges(self, values: Dict[str, float],
                   t: Optional[float] = None):
        """N gauges under one lock hold and one timestamp (the Batcher's
        per-enqueue backpressure update)."""
        now = self._clock() if t is None else t
        with self._lock:
            for name, value in values.items():
                self._gauges[name] = float(value)
                self._gauge_ts[name] = now

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def drop_gauge(self, name: str):
        """Remove a gauge from the scrape surface (no error if absent)."""
        with self._lock:
            self._gauges.pop(name, None)
            self._gauge_ts.pop(name, None)

    def observe(self, name: str, value: float, exemplar=None):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value, exemplar=exemplar)

    def histogram(self, name: str) -> Dict[str, float]:
        with self._lock:
            h = self._hists.get(name)
            return (h or Histogram()).snapshot()

    def phase(self, name: str, hist: Optional[str] = None):
        """Context manager timing its block into histogram ``hist``
        (default ``name``); ``.elapsed`` holds the seconds after exit."""
        return _Phase(self, hist or name)

    # -- derived views -----------------------------------------------------

    @staticmethod
    def _derive(hits: float, misses: float, solves: float, flops: float,
                solve_seconds: float) -> Dict[str, float]:
        """The serving headline formulas, shared by the accessors and the
        snapshot: gflops is solve_flops_total over solve_latency seconds,
        so amortized factorizations do not inflate it."""
        total = hits + misses
        return {
            "cache_hit_rate": hits / total if total else 0.0,
            "solves_per_sec": (solves / solve_seconds
                               if solve_seconds > 0 else 0.0),
            "gflops": (flops / solve_seconds / 1e9
                       if solve_seconds > 0 else 0.0),
        }

    def _derived_now(self) -> Dict[str, float]:
        with self._lock:
            h = self._hists.get("solve_latency")
            return self._derive(
                self._counters.get("cache_hits", 0.0),
                self._counters.get("cache_misses", 0.0),
                self._counters.get("solves_total", 0.0),
                self._counters.get("solve_flops_total", 0.0),
                h.total if h is not None else 0.0)

    def cache_hit_rate(self) -> float:
        return self._derived_now()["cache_hit_rate"]

    def solves_per_sec(self) -> float:
        """Solves over accumulated solve time (dispatch to device done),
        not wall time."""
        return self._derived_now()["solves_per_sec"]

    def gflops(self) -> float:
        return self._derived_now()["gflops"]

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            hists = {k: h.snapshot() for k, h in self._hists.items()}
            gauges = dict(self._gauges)
            gauge_ts = dict(self._gauge_ts)
            uptime = time.perf_counter() - self._t0
        solve = hists.get("solve_latency", {})
        return {
            "uptime_s": uptime, "counters": counters, "histograms": hists,
            "gauges": gauges, "gauge_ts": gauge_ts,
            "derived": self._derive(
                counters.get("cache_hits", 0.0),
                counters.get("cache_misses", 0.0),
                counters.get("solves_total", 0.0),
                counters.get("solve_flops_total", 0.0),
                solve.get("sum", 0.0)),
        }

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        """The snapshot as JSON; written to ``path`` when given."""
        text = json.dumps(self.snapshot(), indent=indent, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    def to_prometheus(self, path: Optional[str] = None,
                      prefix: str = "slate_tpu") -> str:
        """Prometheus text exposition of the snapshot: counters as
        ``counter``, histograms as ``summary`` (p50/p99, sum, count) with
        min/max/mean gauges beside them (left out while empty), the
        derived rates and the gauges as ``gauge``."""
        text = render_prometheus(self.snapshot(), prefix)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text


class _Phase:
    __slots__ = ("_metrics", "_hist", "_t0", "elapsed")

    def __init__(self, metrics: Metrics, hist: str):
        self._metrics = metrics
        self._hist = hist
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        self._metrics.observe(self._hist, self.elapsed)
        return False


_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _san(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def render_prometheus(snapshot: dict, prefix: str = "slate_tpu") -> str:
    """A ``Metrics.snapshot()`` as Prometheus text (format 0.0.4)."""
    lines = []

    def emit(name, value, mtype):
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name} {_num(value)}")

    emit(f"{prefix}_uptime_seconds", snapshot.get("uptime_s", 0.0), "gauge")
    for k in sorted(snapshot.get("counters", {})):
        emit(f"{prefix}_{_san(k)}", snapshot["counters"][k], "counter")
    for k in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][k]
        base = f"{prefix}_{_san(k)}"
        lines.append(f"# TYPE {base} summary")
        lines.append(f'{base}{{quantile="0.5"}} {_num(h.get("p50", 0.0))}')
        lines.append(f'{base}{{quantile="0.99"}} {_num(h.get("p99", 0.0))}')
        lines.append(f"{base}_sum {_num(h.get('sum', 0.0))}")
        lines.append(f"{base}_count {_num(h.get('count', 0))}")
        for stat in ("min", "max", "mean"):
            if h.get(stat) is not None:
                emit(f"{base}_{stat}", h[stat], "gauge")
    for k in sorted(snapshot.get("derived", {})):
        emit(f"{prefix}_{_san(k)}", snapshot["derived"][k], "gauge")
    for k in sorted(snapshot.get("gauges", {})):
        emit(f"{prefix}_{_san(k)}", snapshot["gauges"][k], "gauge")
    return "\n".join(lines) + "\n"
