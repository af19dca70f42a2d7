"""Async submit/future front end for the solve service (counterpart of
``slate_tpu/runtime/executor.py``).

An ``Executor`` owns a worker thread that drives the Batcher: callers
``submit(handle, b)`` and get a ``concurrent.futures.Future``; the
worker sleeps until a bucket is full, its max-wait deadline passes or a
request's own deadline needs failing, then dispatches the bucket as one
stacked Session solve. On a CUDA session the worker runs under
``torch.cuda.device(session.device)``.

Failure reflexes: transient dispatch failures are retried with
exponential backoff and jitter (deterministic under a FaultInjector); a
per-(op, n) circuit breaker trips after repeated failures and walks the
declared degradation ladder (``faults.DEGRADATION_LADDER``): grouped
and dense buckets replay per request; a mixed bucket (a refined
operator) is demoted to working precision
(``Session.demote_to_working_precision``) and then replayed per request.
The ladder's mesh rung belongs to ROADMAP Queue 1 item 12; no ported op
reaches it.
The worker also drives the Batcher's load-shedding reflex.

``warmup`` factors each operator off the request path and, on a card,
captures its solve as a CUDA graph (``Session.warmup``), so the first
request pays neither the factorization nor the capture.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Hashable, Iterable, Optional, Tuple

import torch

from ..core.exceptions import SlateError
from .batching import Batcher, ShedPolicy, _SMALL
from .faults import DEGRADATION_LADDER
from .session import Session


class _Breaker:
    """Per-(op, n) circuit breaker, touched only by the Executor's worker
    thread (dispatch is serialized), so it has no lock.

    closed → open after ``threshold`` consecutive final (post-retry)
    transient dispatch failures; open → half_open after ``cooldown_s``
    (one probe dispatch through the normal path); the probe's outcome
    closes or re-opens it. While open, buckets walk the ladder."""

    __slots__ = ("threshold", "cooldown_s", "failures", "state",
                 "opened_at")

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.failures = 0
        self.state = "closed"
        self.opened_at = 0.0

    def allow(self, now: float) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open" and now - self.opened_at >= self.cooldown_s:
            self.state = "half_open"
            return True  # the probe
        return False

    def record_ok(self) -> bool:
        """Returns True when this success closes an open breaker."""
        self.failures = 0
        was = self.state
        self.state = "closed"
        return was != "closed"

    def record_failure(self, now: float) -> bool:
        """Returns True when this failure TRIPS the breaker open."""
        self.failures += 1
        if self.state == "half_open" or (self.state == "closed"
                                         and self.failures
                                         >= self.threshold):
            self.state = "open"
            self.opened_at = now
            return True
        if self.state == "open":
            self.opened_at = now
        return False


class Executor:
    """Background-thread serving front end over a Session::

        sess = Session(hbm_budget=8 << 30)
        h = sess.register(A, op="chol")
        with Executor(sess, max_batch=32, max_wait=2e-3) as ex:
            ex.warmup([h])
            futs = [ex.submit(h, b) for b in rhs_stream]
            xs = [f.result(timeout=60) for f in futs]

    ``retries`` bounds the transient-failure retries per bucket; retry i
    sleeps ``backoff_base · 2^i`` (at most ``backoff_max``) times a
    jitter in [0.5, 1.0). ``breaker_threshold`` consecutive
    exhausted-retry failures on one (op, n) open its breaker for
    ``breaker_cooldown`` seconds. ``shed_policy`` goes to the Batcher;
    ``timeout_s`` on submit is the per-request deadline."""

    def __init__(self, session: Session, max_batch: int = 32,
                 max_wait: float = 2e-3, retries: int = 2,
                 backoff_base: float = 0.01, backoff_max: float = 0.5,
                 breaker_threshold: int = 3,
                 breaker_cooldown: float = 1.0,
                 shed_policy: Optional[ShedPolicy] = None):
        self.session = session
        self.retries = retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self._breakers: dict = {}
        self.batcher = Batcher(session, max_batch=max_batch,
                               max_wait=max_wait,
                               shed_policy=shed_policy)
        self._cv = threading.Condition()
        self._stop = False
        self._kick = False  # work arrived since the worker last looked
        self._inflight = 0  # batches detached from the Batcher, unsolved
        self._thread = threading.Thread(target=self._run,
                                        name="slate-torch-serve",
                                        daemon=True)
        self._thread.start()

    # -- client surface ----------------------------------------------------

    def submit(self, handle: Hashable, b, timeout_s: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue one solve request; never blocks on the device. The
        shutdown check and the enqueue are one step under the lock, so no
        request lands in a drained Batcher after the worker has exited.
        A rejected request's future is resolved after the lock is
        released (a done-callback may submit again)."""
        with self._cv:
            if self._stop:
                raise RuntimeError("Executor is shut down")
            req, rejection = self.batcher.submit_deferred(
                handle, b, timeout_s=timeout_s, tenant=tenant)
            self._kick = True
            self._cv.notify_all()
        if rejection is not None:
            self.batcher.reject_admission(req, rejection)
        return req.future

    def warmup(self, handles: Iterable[Hashable], nrhs: int = 1):
        """``Session.warmup`` for each handle (nrhs = 1 covers every
        dense width up to the operator's nb)."""
        for h in handles:
            self.session.warmup(h, nrhs)

    def flush(self):
        """Block until everything queued at call time has been solved
        (queued buckets and batches already detached to the worker)."""
        with self._cv:
            self._kick = True
            self._cv.notify_all()
            while self.batcher.pending() or self._inflight:
                deadline = self.batcher.next_deadline()
                if deadline is None:
                    self._cv.wait()
                else:
                    self._cv.wait(max(deadline - time.monotonic(), 0.0)
                                  + 1e-3)

    def shutdown(self, wait: bool = True):
        """Stop the worker; pending requests are force-dispatched first."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if wait:
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- worker ------------------------------------------------------------

    def _run(self):
        dev = self.session.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            self._loop()

    def _loop(self):
        while True:
            with self._cv:
                # a notify that fires while this thread is dispatching is
                # consumed by nobody: the _kick flag carries it, else a
                # bucket filled meanwhile would sleep out its max_wait
                if not self._stop and not self._kick:
                    deadline = self.batcher.next_deadline()
                    if deadline is None:
                        self._cv.wait()
                    else:
                        timeout = deadline - time.monotonic()
                        if timeout > 0:
                            self._cv.wait(timeout)
                self._kick = False
                stopping = self._stop
                # detach and count in flight under one lock hold, so
                # flush() never sees pending() == 0 while a batch sits
                # between pop_ready and dispatch; expired requests are
                # failed after the lock drops
                expired = []
                batches = self.batcher.pop_ready(force=stopping,
                                                 expired_out=expired)
                self._inflight += len(batches)
                if batches:
                    self.session.metrics.set_gauge("inflight_batches",
                                                   self._inflight)
            if expired:
                self.batcher._fail_expired(expired, time.monotonic())
            self.batcher.maybe_shed()
            for key, reqs in batches:
                # requests that arrive during a long batch queue behind it:
                # the population an overload shed must reach
                self.batcher.maybe_shed()
                try:
                    self._dispatch(key, reqs)
                finally:
                    with self._cv:
                        self._inflight -= 1
                        self.session.metrics.set_gauge("inflight_batches",
                                                       self._inflight)
                        self._cv.notify_all()
            if stopping and not batches:
                with self._cv:
                    if not self.batcher.pending() and not self._inflight:
                        return

    # -- dispatch: retry, breaker, degradation ladder ----------------------

    def _breaker_key(self, key) -> Optional[Tuple]:
        """(op, n) of a bucket, the breaker's grain; None for unknown
        handles (a deterministic failure)."""
        if key and key[0] is _SMALL:
            return (key[1], key[2])
        return self.session.op_meta(key[0])

    def _publish_breakers(self):
        self.session.metrics.set_gauge(
            "circuit_breakers_open",
            sum(1 for b in self._breakers.values() if b.state != "closed"))

    def _backoff_sleep(self, attempt: int):
        """Exponential backoff with a multiplicative jitter in [0.5, 1.0),
        drawn from the injector when one is attached."""
        delay = min(self.backoff_base * (2.0 ** attempt), self.backoff_max)
        inj = self.session.faults
        u = inj.uniform("backoff") if inj is not None else random.random()
        delay *= 0.5 + 0.5 * u
        self.session.metrics.observe("retry_backoff_s", delay)
        time.sleep(delay)

    def _dispatch(self, key, reqs):
        """Run one bucket, retrying TRANSIENT failures with backoff. A
        SlateError is deterministic (unknown handle, info ≠ 0) and fails
        fast without a retry. Retry exhaustion charges the bucket's
        breaker; when it trips (or is open) the bucket walks the ladder
        instead of failing."""
        m = self.session.metrics
        bk = self._breaker_key(key)
        br = self._breakers.get(bk) if bk is not None else None
        if br is not None and not br.allow(time.monotonic()):
            m.inc("breaker_short_circuits")
            self._dispatch_degraded(key, reqs, None)
            return
        if br is not None and br.state == "half_open":
            m.inc("breaker_probes_total")
        err: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                self.batcher.run(key, reqs)
                if br is not None and br.record_ok():
                    m.inc("breaker_closes_total")
                    self._publish_breakers()
                return
            except SlateError as e:
                err = e
                break
            except Exception as e:  # noqa: BLE001 — failed futures carry it
                err = e
                if attempt < self.retries:
                    m.inc("retries")
                    self._backoff_sleep(attempt)
        if not isinstance(err, SlateError) and bk is not None:
            if br is None:
                br = self._breakers[bk] = _Breaker(self.breaker_threshold,
                                                   self.breaker_cooldown)
            if br.record_failure(time.monotonic()):
                m.inc("breaker_trips_total")
                self._publish_breakers()
            if br.state == "open":
                # the tripping bucket itself takes the degraded lane
                self._dispatch_degraded(key, reqs, err)
                return
        self._fail_batch(reqs, err)

    def _dispatch_degraded(self, key, reqs, err):
        """One rung of ``faults.DEGRADATION_LADDER`` for a bucket whose
        breaker is open: grouped and dense buckets replay per request
        (``Batcher.run_degraded``); a mixed bucket's operator is demoted
        to working precision (its low-precision resident evicted, counted
        in ``refine_demotions_total``), then the bucket replays per
        request. The mesh family has no ported rung (ROADMAP item 12),
        and an unknown handle's bucket fails with its error."""
        family = ("grouped" if key and key[0] is _SMALL
                  else self.session.degrade_class(key[0]))
        rung = DEGRADATION_LADDER.get(family or "")
        if rung == "working_precision":
            self.session.demote_to_working_precision(key[0])
            rung = "per_request"
        if rung == "per_request":
            self.batcher.run_degraded(key, reqs)
            return
        self._fail_batch(reqs, err if err is not None else SlateError(
            f"Session: unknown bucket {key!r}"))

    def _fail_batch(self, reqs, err):
        """Final failure: fail every still-unresolved future with ``err``
        (cancelled or already-resolved requests are not failures)."""
        m = self.session.metrics
        m.inc("failed_batches")
        for r in reqs:
            if r.future.done():
                continue
            try:
                r.future.set_exception(err)
                m.inc("failed_requests_total")
            except InvalidStateError:
                pass  # the client cancelled concurrently
