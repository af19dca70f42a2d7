"""Shape-bucketing request batcher (counterpart of
``slate_tpu/runtime/batching.py``).

N callers each asking for one right-hand side against the same resident
operator should cost one solve, not N: requests are bucketed by
(handle, right-hand-side shape, dtype), column-stacked into one (rows,
K) right-hand side, solved once through the Session, and split back.
Every *_solve_using_factor verb is column-independent and dense
right-hand sides are tile-padded to the operator's nb, so a K ≤ nb
bucket runs the same padded shape (the same warmed CUDA graph) as one
request and returns each request's per-request bits.

Small-problem operators ("lu_small"/"chol_small") are grouped ACROSS
handles: requests whose operators share (op, n, dtype) and whose
right-hand sides share a shape land in one bucket, dispatched as one
``Session.solve_small_batched`` pass. A singular item fails its own
future with its info; its neighbours are served as without it.

A bucket dispatches when it reaches ``max_batch`` or when its oldest
request has waited ``max_wait`` seconds. Requests may carry a deadline
(failed fast with ``DeadlineExceeded``); a ``ShedPolicy`` adds admission
control and load shedding. The Batcher owns no thread: the Executor
drives ``pop_ready``/``run``, and ``flush`` serves synchronous callers.
Futures are resolved outside every lock (a done-callback may submit
again). Tenants and SLO burn-rate shedding are later slices (ROADMAP
Queue 1 items 11 and 10) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

from ..core.exceptions import SlateError
from .faults import DeadlineExceeded, RequestShed
from .session import Session

_TENANTS_LATER = "tenants are not ported yet (ROADMAP Queue 1 item 11)"


@dataclasses.dataclass
class _Request:
    b: np.ndarray          # always 2-D (rows, 1..k) column block
    vector: bool           # original rank (reshape on completion)
    future: Future
    t_submit: float
    # the operator this request targets (grouped small buckets hold
    # requests against distinct handles)
    handle: Hashable = None
    # absolute monotonic deadline; None = no deadline
    deadline: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """Admission control and load shedding.

    ``max_queue_depth`` is the ADMISSION bound: a submit that would push
    the queue past it fails at once with :class:`RequestShed` and is
    never enqueued. ``max_age_s`` triggers SHEDDING of queued requests
    when the oldest live one is older than it: a shed event drops
    ``shed_fraction`` of the queue, cheapest to recompute first
    (``Session.recompute_cost``: a request against a resident factor
    re-costs one solve, a cold one factor + solve), never below
    ``min_queue_depth``. ``burn_threshold`` (SLO burn-rate shedding) is
    ROADMAP Queue 1 item 10 and raises. ``None`` disables a trigger."""

    max_queue_depth: Optional[int] = None
    max_age_s: Optional[float] = None
    burn_threshold: Optional[float] = None
    shed_fraction: float = 0.5
    min_queue_depth: int = 1

    def __post_init__(self):
        if not (0.0 < self.shed_fraction <= 1.0):
            raise ValueError("ShedPolicy: shed_fraction must be in "
                             f"(0, 1], got {self.shed_fraction}")
        if self.burn_threshold is not None:
            raise NotImplementedError(
                "ShedPolicy: burn_threshold needs SLO tracking, which is "
                "not ported yet (ROADMAP Queue 1 item 10)")


BucketKey = Tuple[Hashable, Tuple[int, ...], str]

# first element of a grouped small-problem bucket key: a private sentinel,
# so no user handle can collide with it
_SMALL = object()


class Batcher:
    """Coalesces same-operator/same-shape solve requests (see module
    docstring). Thread-safe; dispatch runs on the caller of ``run``."""

    def __init__(self, session: Session, max_batch: int = 32,
                 max_wait: float = 2e-3,
                 shed_policy: Optional[ShedPolicy] = None,
                 tenant_policies=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if tenant_policies is not None:
            raise NotImplementedError(f"Batcher: {_TENANTS_LATER}")
        self.session = session
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.shed_policy = shed_policy
        self._lock = threading.Lock()
        self._buckets: Dict[BucketKey, List[_Request]] = {}
        # incrementally kept backpressure state: the submit path
        # publishes gauges from these instead of scanning every bucket;
        # pop_ready recomputes them exactly
        self._depth = 0
        self._max_backlog = 0
        self._oldest: Optional[float] = None  # head submit time

    # -- submission --------------------------------------------------------

    def submit(self, handle: Hashable, b, timeout_s: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue one solve request; resolves to the solution array with
        the same rank as ``b``. ``timeout_s``: a deadline after which the
        request fails fast with ``DeadlineExceeded`` instead of taking a
        batch lane. Against a full queue (``ShedPolicy.max_queue_depth``)
        the future returned has already failed with ``RequestShed``."""
        req, rejection = self.submit_deferred(handle, b, timeout_s=timeout_s,
                                              tenant=tenant)
        if rejection is not None:
            self.reject_admission(req, rejection)
        return req.future

    def submit_deferred(self, handle: Hashable, b,
                        timeout_s: Optional[float] = None,
                        tenant: Optional[str] = None
                        ) -> Tuple[_Request, Optional[Exception]]:
        """The enqueue half of :meth:`submit`: returns ``(request,
        rejection)`` without resolving a rejected future, for callers
        that hold their own lock across the enqueue and must call
        :meth:`reject_admission` after releasing it."""
        if tenant is not None:
            raise NotImplementedError(f"Batcher.submit: {_TENANTS_LATER}")
        b = np.asarray(b)
        vector = b.ndim == 1
        b2 = b[:, None] if vector else b
        skey = self.session.small_group_key(handle)
        if skey is not None:
            key: BucketKey = (_SMALL,) + skey + (tuple(b2.shape),
                                                 str(b2.dtype))
        else:
            key = (handle, tuple(b2.shape), str(b2.dtype))
        req = _Request(b2, vector, Future(), time.monotonic(), handle=handle)
        if timeout_s is not None:
            req.deadline = req.t_submit + timeout_s
        self.session.metrics.inc("requests_total")
        pol = self.shed_policy
        with self._lock:
            if (pol is not None and pol.max_queue_depth is not None
                    and self._depth >= pol.max_queue_depth):
                return req, RequestShed(
                    f"admission control: queue depth >= "
                    f"{pol.max_queue_depth}; request rejected at the "
                    "door (retry with backoff)")
            bucket = self._buckets.setdefault(key, [])
            bucket.append(req)
            self._depth += 1
            self._max_backlog = max(self._max_backlog, len(bucket))
            if self._oldest is None:
                self._oldest = req.t_submit  # only pops move it back
            self.session.metrics.set_gauges({
                "queue_depth": self._depth,
                "queued_buckets": len(self._buckets),
                "max_bucket_backlog": self._max_backlog,
                "oldest_request_age_s": req.t_submit - self._oldest,
            })
        return req, None

    def reject_admission(self, req: _Request, rejection: Exception):
        """Resolve an admission-rejected request (call with no lock held:
        set_exception may run client callbacks)."""
        self.session.metrics.inc("admission_rejected_total")
        req.future.set_exception(rejection)

    def pending(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._buckets.values())

    # -- backpressure ------------------------------------------------------

    @staticmethod
    def _head_submit(reqs) -> Optional[float]:
        """Submit time of the oldest LIVE request in a bucket: a cancelled
        one must not pin ``oldest_request_age_s`` high (and trigger
        spurious shedding)."""
        for r in reqs:
            if not r.future.cancelled():
                return r.t_submit
        return None

    def _update_backpressure_locked(self, now: Optional[float] = None):
        """Caller holds the lock. Publish the queue's state as gauges
        (exact recompute on pops; also resyncs the incremental
        counters)."""
        now = time.monotonic() if now is None else now
        depths = [len(v) for v in self._buckets.values() if v]
        self._depth = sum(depths)
        self._max_backlog = max(depths, default=0)
        heads = [self._head_submit(reqs)
                 for reqs in self._buckets.values() if reqs]
        self._oldest = min((h for h in heads if h is not None),
                           default=None)
        self.session.metrics.set_gauges({
            "queue_depth": self._depth,
            "queued_buckets": len(depths),
            "max_bucket_backlog": self._max_backlog,
            "oldest_request_age_s": (0.0 if self._oldest is None
                                     else now - self._oldest),
        })

    def backpressure(self) -> dict:
        """Point-in-time queue state, per bucket."""
        now = time.monotonic()
        with self._lock:
            per_bucket = {}
            for key, reqs in self._buckets.items():
                if not reqs:
                    continue
                head = self._head_submit(reqs)
                per_bucket[repr(key)] = {
                    "backlog": len(reqs),
                    "oldest_age_s": 0.0 if head is None else now - head}
        return {
            "queue_depth": sum(v["backlog"] for v in per_bucket.values()),
            "queued_buckets": len(per_bucket),
            "oldest_request_age_s": max(
                (v["oldest_age_s"] for v in per_bucket.values()),
                default=0.0),
            "per_bucket": per_bucket,
        }

    # -- readiness ---------------------------------------------------------

    def next_deadline(self) -> Optional[float]:
        """Earliest monotonic time the worker must act: a bucket's
        max-wait deadline or a request's own deadline."""
        with self._lock:
            vals = []
            for reqs in self._buckets.values():
                if not reqs:
                    continue
                vals.append(reqs[0].t_submit + self.max_wait)
                vals.extend(r.deadline for r in reqs
                            if r.deadline is not None)
        return min(vals) if vals else None

    def pop_ready(self, now: Optional[float] = None, force: bool = False,
                  expired_out: Optional[List[_Request]] = None
                  ) -> List[Tuple[BucketKey, List[_Request]]]:
        """Detach buckets that are full or past their max wait (all of
        them when ``force``); requests beyond max_batch stay queued.
        Requests past their own deadline leave the queue here and fail
        fast without a dispatch; ``expired_out`` collects them instead,
        for a caller that holds a lock and runs :meth:`_fail_expired`
        after releasing it."""
        now = time.monotonic() if now is None else now
        out: List[Tuple[BucketKey, List[_Request]]] = []
        expired: List[_Request] = []
        with self._lock:
            for key in list(self._buckets):
                reqs = self._buckets[key]
                if any(r.deadline is not None and r.deadline <= now
                       for r in reqs):
                    live = []
                    for r in reqs:
                        if (r.deadline is not None and r.deadline <= now
                                and not r.future.done()):
                            expired.append(r)
                        else:
                            live.append(r)
                    self._buckets[key] = reqs = live
                while (len(reqs) >= self.max_batch
                       or (reqs and force)
                       or (reqs and now - reqs[0].t_submit >= self.max_wait)):
                    take, rest = reqs[:self.max_batch], reqs[self.max_batch:]
                    out.append((key, take))
                    self._buckets[key] = reqs = rest
                if not reqs:
                    del self._buckets[key]
            if out or expired:
                self._update_backpressure_locked(now)
        if expired_out is None:
            self._fail_expired(expired, now)
        else:
            expired_out.extend(expired)
        return out

    def _fail_expired(self, reqs: List[_Request], now: float):
        """Fail deadline-expired requests (outside the queue lock),
        counted in ``deadline_expired_total``."""
        for r in reqs:
            try:
                r.future.set_exception(DeadlineExceeded(
                    f"deadline exceeded after {now - r.t_submit:.4f}s in "
                    "queue (failed fast without occupying a batch lane)"))
            except InvalidStateError:
                continue  # the client cancelled first
            self.session.metrics.inc("deadline_expired_total")

    # -- load shedding -----------------------------------------------------

    def maybe_shed(self, now: Optional[float] = None) -> int:
        """The load-shedding reflex, driven by the Executor each wakeup
        (one is-None check without a policy). When the oldest live
        request is older than ``max_age_s``, drop ``shed_fraction`` of the
        queue, cheapest to recompute first (newest first among equals),
        failing those futures with ``RequestShed``. Returns the number
        shed."""
        pol = self.shed_policy
        if pol is None:
            return 0
        m = self.session.metrics
        now = time.monotonic() if now is None else now
        with self._lock:
            depth, oldest = self._depth, self._oldest
        if (depth < max(pol.min_queue_depth, 1) or pol.max_age_s is None
                or oldest is None or now - oldest <= pol.max_age_s):
            m.set_gauge("shedding_active", 0.0)
            return 0
        trigger = f"oldest_request_age_s > {pol.max_age_s}"
        with self._lock:
            queued = [(key, r) for key, reqs in self._buckets.items()
                      for r in reqs if not r.future.done()]
            n_shed = min(max(1, int(len(queued) * pol.shed_fraction)),
                         len(queued) - max(pol.min_queue_depth, 1))
            if n_shed <= 0:
                m.set_gauge("shedding_active", 0.0)
                return 0
            queued.sort(key=lambda kr: (
                self.session.recompute_cost(kr[1].handle, kr[1].b.shape[1]),
                -kr[1].t_submit))
            drop = {id(r) for _, r in queued[:n_shed]}
            for key in list(self._buckets):
                kept = [r for r in self._buckets[key] if id(r) not in drop]
                if kept:
                    self._buckets[key] = kept
                else:
                    del self._buckets[key]
            victims = [r for _, r in queued[:n_shed]]
            self._update_backpressure_locked(now)
        m.inc("load_sheds_total")
        m.set_gauge("shedding_active", 1.0)
        shed = 0
        for r in victims:
            try:
                r.future.set_exception(RequestShed(
                    f"load shed ({trigger}); cheapest-to-recompute first — "
                    "retry with backoff"))
            except InvalidStateError:
                continue  # cancelled concurrently
            shed += 1
        m.inc("shed_requests_total", shed)
        return shed

    # -- dispatch ----------------------------------------------------------

    def run(self, key: BucketKey, reqs: List[_Request]):
        """Solve one detached bucket: stack → one Session solve → split.
        Exceptions propagate to the caller with the unresolved futures
        left pending, so the caller can retry; already-done requests
        (resolved earlier, or cancelled) are skipped, so a retry covers
        only what is unresolved."""
        if key and key[0] is _SMALL:
            return self._run_small(key, reqs)
        handle = key[0]
        now = time.monotonic()
        live = self._live(reqs, now)
        if not live:
            return
        m = self.session.metrics
        for r in live:
            m.observe("stage_queue_wait", now - r.t_submit)
        t_form = time.monotonic()
        stacked = np.concatenate([r.b for r in live], axis=1)
        m.observe("stage_batch_form", time.monotonic() - t_form)
        x = self.session.solve(handle, stacked)
        m.inc("batches_total")
        m.observe("batch_size", float(len(live)))
        done = time.monotonic()
        col = 0
        for r in live:
            w = r.b.shape[1]
            xi = x[:, col:col + w]
            col += w
            self._resolve(r, xi[:, 0] if r.vector else xi, done)
        m.observe("stage_reply", time.monotonic() - done)

    def _resolve(self, r: _Request, x, done: float):
        m = self.session.metrics
        try:
            r.future.set_result(x)
        except InvalidStateError:
            # the client cancelled between the done() check and here
            m.inc("cancelled_requests")
            return
        m.inc("completed_requests")
        m.observe("request_latency", done - r.t_submit)

    def _fail(self, r: _Request, err: BaseException):
        try:
            r.future.set_exception(err)
            self.session.metrics.inc("failed_requests_total")
        except InvalidStateError:
            self.session.metrics.inc("cancelled_requests")

    def _live(self, reqs: List[_Request], now: float) -> List[_Request]:
        """Dispatch-start filter: drop already-resolved requests and fail
        the deadline-expired ones fast (a request can expire between
        detach and dispatch, e.g. while an earlier bucket retried)."""
        live, expired = [], []
        for r in reqs:
            if r.future.done():
                continue
            if r.deadline is not None and r.deadline <= now:
                expired.append(r)
            else:
                live.append(r)
        self._fail_expired(expired, now)
        return live

    def _run_small(self, key: BucketKey, reqs: List[_Request]):
        """Grouped small-problem dispatch: one bucket of requests against
        distinct operators → one ``Session.solve_small_batched`` pass. A
        singular item fails its own future with its info (the SlateError
        the per-request path raises); its neighbours are served."""
        now = time.monotonic()
        live = self._live(reqs, now)
        if not live:
            return
        m = self.session.metrics
        for r in live:
            m.observe("stage_queue_wait", now - r.t_submit)
        xs, infos = self.session.solve_small_batched(
            [r.handle for r in live], [r.b for r in live])
        m.inc("batches_total")
        m.observe("batch_size", float(len(live)))
        done = time.monotonic()
        for i, r in enumerate(live):
            if infos[i] != 0:
                self._fail(r, SlateError(
                    f"Session: operator {r.handle!r} factorization failed "
                    f"(info={infos[i]})"))
                continue
            self._resolve(r, xs[i][:, 0] if r.vector else xs[i], done)
        m.observe("stage_reply", time.monotonic() - done)

    def run_degraded(self, key: BucketKey, reqs: List[_Request]):
        """The per-request rung of the degradation ladder (grouped and
        dense → per_request), walked by the Executor when a bucket's
        circuit breaker is open: every live request runs as its own
        ``Session.solve``, and one whose solve raises fails only its own
        future. Futures resolve exactly once."""
        now = time.monotonic()
        live = self._live(reqs, now)
        if not live:
            return
        self.session.metrics.inc("degraded_dispatches_total")
        for r in live:
            try:
                x = self.session.solve(r.handle, r.b)
            except Exception as e:  # noqa: BLE001 — per-item isolation
                self._fail(r, e)
                continue
            self._resolve(r, x[:, 0] if r.vector else x, time.monotonic())

    def flush(self):
        """Synchronously dispatch everything pending (caller's thread)."""
        for key, reqs in self.pop_ready(force=True):
            self.run(key, reqs)
