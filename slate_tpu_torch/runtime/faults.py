"""Deterministic fault injection and the serving degradation ladder (the
port's own copy of ``slate_tpu/runtime/faults.py``, stdlib only).

* :class:`FaultSpec` / :class:`FaultPlan`: a declarative, seeded
  schedule of fault classes (transient dispatch failures, slow-device
  latency, compile stalls, HBM-budget exhaustion, ...);
* :class:`FaultInjector`: the evaluator the Session consults at its
  seams. A decision is a PURE FUNCTION of ``(seed, kind, per-site
  sequence number)`` (a keyed hash, not a shared RNG stream), so two
  runs that present the same opportunity sequence fire the same faults
  whatever the thread interleaving, and the port fires the reference's
  schedule for the same plan and seed;
* the serving-reflex exceptions (:class:`TransientDispatchError`,
  :class:`DeadlineExceeded`, :class:`RequestShed`, :class:`QuotaExceeded`)
  that the Batcher and Executor fail futures with;
* :data:`DEGRADATION_LADDER`: the declared next rung down per serving
  path, which the Executor's circuit breaker walks.

``Session.faults`` defaults to ``None`` and every seam guards with one
``faults is None`` check: injection disabled calls nothing here. The
Session's seams in the port are "dispatch", "hbm" and "compile" (the
CUDA graph capture); the other sites belong to slices not ported yet and
are kept so that a plan's schedule stays the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from ..core.exceptions import SlateError

# every fault class the injector can schedule (the reference's list)
KINDS = (
    "dispatch_error",      # transient dispatch failure -> retryable raise
    "slow_device",         # added dispatch latency
    "compile_stall",       # added latency at the compile (capture) seam
    "hbm_exhaustion",      # budget collapses to 0 for one insert
    "lo_factor_fail",      # low-precision factor comes back singular
    "refine_no_converge",  # iterative refinement stagnates
    "snapshot_drop",       # a process snapshot never reaches the fleet
    "process_crash",       # a Session process dies mid-soak
    "restore_corrupt",     # a checkpoint blob is corrupted in flight
    "replica_stale",       # a replica's resident predates the primary's
    "migration_abort",     # a migration transfer dies mid-flight
    "update_abort",        # a rank-k update dies mid-apply
)

# seam name -> fault kinds evaluated there: one seam check covers every
# class that can fire at it
SITES: Dict[str, Tuple[str, ...]] = {
    "dispatch": ("dispatch_error", "slow_device"),
    "compile": ("compile_stall",),
    "hbm": ("hbm_exhaustion",),
    "refine.lo_factor": ("lo_factor_fail",),
    "refine.converge": ("refine_no_converge",),
    "snapshot": ("snapshot_drop",),
    "restore": ("restore_corrupt",),
    "fleet.process": ("process_crash",),
    "fleet.replica": ("replica_stale",),
    "fleet.migrate": ("migration_abort",),
    "update": ("update_abort",),
    "tuner.compile": ("compile_stall", "dispatch_error"),
}

# The declared degradation ladder: when a serving path keeps failing
# (circuit breaker open), the next rung down — never a wrong answer,
# always a counted decision.
#   grouped -> per_request        one batched pass per bucket degrades
#                                 to B independent solves
#   mixed   -> working_precision  a refined operator is demoted: its
#                                 low-precision resident evicted, then
#                                 per-request solves at full precision
#   dense   -> per_request        a coalesced dense bucket degrades to
#                                 per-request solves
#   mesh    -> reject             (multi-device: ROADMAP item 12)
DEGRADATION_LADDER: Dict[str, str] = {
    "grouped": "per_request",
    "mixed": "working_precision",
    "dense": "per_request",
    "mesh": "reject",
}


# -- serving-reflex exceptions ----------------------------------------------


class TransientDispatchError(RuntimeError):
    """A retryable dispatch failure (the class the Executor's backoff
    and retry loop covers; deliberately NOT a SlateError, which signals
    a deterministic failure and fails fast)."""


class DeadlineExceeded(SlateError):
    """The request's deadline passed before its solve dispatched; it
    failed fast instead of occupying a batch lane. Never retried."""


class RequestShed(SlateError):
    """The request was turned away (admission control) or dropped from
    the queue (load shedding), cheapest-to-recompute first. Never
    retried server-side."""


class QuotaExceeded(SlateError):
    """A tenant over its own limits (tenant quotas: ROADMAP Queue 1
    item 11; nothing in this slice raises it)."""


# -- the plan ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault class's schedule: ``rate`` is the per-opportunity
    firing probability (evaluated by keyed hash), ``after`` skips the
    first N opportunities at the kind's sites, ``count`` caps the
    firings (None: unlimited), ``latency_s`` is the injected sleep of
    the latency-shaped kinds."""

    kind: str
    rate: float
    latency_s: float = 0.0
    after: int = 0
    count: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"FaultSpec: unknown kind {self.kind!r} "
                             f"(one of {KINDS})")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"FaultSpec {self.kind}: rate must be in "
                             f"[0, 1], got {self.rate}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed plus the fault classes to schedule under it; immutable
    and JSON-serializable."""

    seed: int
    specs: Tuple[FaultSpec, ...]

    def __post_init__(self):
        kinds = [s.kind for s in self.specs]
        if len(set(kinds)) != len(kinds):
            raise ValueError(f"FaultPlan: duplicate kinds in {kinds}")

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(s.kind for s in self.specs)

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "specs": [s.to_dict() for s in self.specs]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(seed=int(d["seed"]),
                   specs=tuple(FaultSpec(**s) for s in d["specs"]))


def _unit(seed: int, stream: str, seq: int) -> float:
    """Deterministic uniform in [0, 1) keyed by (seed, stream, seq): a
    keyed hash, not an RNG stream, so one site's draw count never shifts
    another site's decisions."""
    h = hashlib.blake2b(f"{seed}:{stream}:{seq}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


class FaultInjector:
    """Runtime evaluator of a :class:`FaultPlan`.

    The serving seams call :meth:`fire` with their site name; every spec
    mapped to that site is evaluated against the site's own monotone
    opportunity counter. Fired decisions are appended to ``self.log``,
    the fault schedule. Thread-safe: one lock around the counters; the
    decisions are pure functions of (seed, kind, seq)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._by_site: Dict[str, Tuple[FaultSpec, ...]] = {
            site: tuple(s for s in plan.specs if s.kind in kinds)
            for site, kinds in SITES.items()}
        self._lock = threading.Lock()
        self._seq: Dict[str, int] = defaultdict(int)
        self._fired: Dict[str, int] = defaultdict(int)
        # the schedule: (site, kind, site-sequence) per firing
        self.log: List[Tuple[str, str, int]] = []

    def fire(self, site: str) -> Tuple[FaultSpec, ...]:
        """One opportunity at ``site``: bump the site counter and return
        the specs that fire at this sequence number (possibly none). The
        caller applies the effects (sleep, raise, budget collapse)."""
        specs = self._by_site.get(site)
        with self._lock:
            seq = self._seq[site]
            self._seq[site] = seq + 1
            fired = []
            for spec in specs or ():
                if seq < spec.after:
                    continue
                if spec.count is not None \
                        and self._fired[spec.kind] >= spec.count:
                    continue
                if _unit(self.plan.seed, spec.kind, seq) < spec.rate:
                    self._fired[spec.kind] += 1
                    self.log.append((site, spec.kind, seq))
                    fired.append(spec)
        return tuple(fired)

    def uniform(self, stream: str) -> float:
        """Deterministic jitter draw (the Executor's backoff jitter uses
        it when an injector is attached, so retry timing replays)."""
        with self._lock:
            seq = self._seq[f"uniform:{stream}"]
            self._seq[f"uniform:{stream}"] = seq + 1
        return _unit(self.plan.seed, f"uniform:{stream}", seq)

    def fired_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._fired)

    def opportunity_counts(self) -> Dict[str, int]:
        with self._lock:
            return {k: v for k, v in self._seq.items()
                    if not k.startswith("uniform:")}

    def schedule(self) -> List[Tuple[str, str, int]]:
        with self._lock:
            return list(self.log)

    def schedule_digest(self) -> str:
        """Stable digest of the fault schedule (the reproducibility
        token two same-seed runs compare)."""
        payload = json.dumps(self.schedule(), separators=(",", ":"))
        return "sha256:" + hashlib.sha256(payload.encode()).hexdigest()


def default_plan(seed: int = 1) -> FaultPlan:
    """The chaos-soak default: every injectable class enabled at rates
    that exercise each reflex in a few hundred requests while most
    traffic still completes."""
    return FaultPlan(seed=seed, specs=(
        FaultSpec("dispatch_error", rate=0.12),
        FaultSpec("slow_device", rate=0.10, latency_s=2e-3),
        FaultSpec("compile_stall", rate=0.5, latency_s=5e-3),
        FaultSpec("hbm_exhaustion", rate=0.10),
        FaultSpec("lo_factor_fail", rate=1.0, count=1),
        FaultSpec("refine_no_converge", rate=1.0, count=1),
        FaultSpec("snapshot_drop", rate=1.0, count=1),
    ))
