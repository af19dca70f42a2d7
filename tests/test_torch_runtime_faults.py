"""Fault injection, the serving reflexes and Metrics of the port's runtime
on the CPU (``slate_tpu_torch.runtime.faults``, ``executor``,
``metrics``).

- The port's ``FaultInjector`` fires the reference's schedule for the
  same plan and seed (decisions and jitter draws are a keyed hash of
  (seed, stream, seq), so this is exact), and is a pure function of the
  plan: a different seed is a different schedule, one site's draws never
  shift another's.
- The reference's fault tests (``tests/test_faults.py``) that this slice
  serves, port against port: plan validation, the declared ladder, the
  exception classes, injection off costs no call, retried dispatch
  failures with a replaying backoff, HBM exhaustion evicting under
  pressure, the breaker tripping a grouped bucket to per-request solves
  and a half-open probe closing it, cancellation during a backoff and
  during a degraded replay, and a small soak that resolves every future
  once with the conservation identity holding. The mixed and refine
  tests are in test_torch_refine_session.py; the SLO, mesh and artifact
  tests wait for their ROADMAP items.
- Metrics: percentiles, exemplars, gauges, the derived rates, JSON and
  Prometheus text.
n = 64, nb = 32; every result() has a timeout of 60 s or less.
"""

import json
import time

import numpy as np
import pytest
import torch

from slate_tpu.runtime import FaultInjector as RefInjector
from slate_tpu.runtime import FaultPlan as RefPlan
from slate_tpu.runtime import default_plan as ref_default_plan
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.runtime import (DEGRADATION_LADDER, Batcher,
                                     DeadlineExceeded, Executor,
                                     FaultInjector, FaultPlan, FaultSpec,
                                     Histogram, Metrics, RequestShed,
                                     TransientDispatchError, default_plan)
from slate_tpu_torch.runtime import faults as faults_mod

torch.set_num_threads(2)

N, NB = 64, 32
RNG = np.random.default_rng(14)


def _spd(n=N):
    a = RNG.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def _chol_handle(sess, n=N):
    spd = _spd(n)
    return sess.register(stt.hermitian(spd, NB, stt.Uplo.Lower,
                                       device="cpu"), op="chol"), spd


def _small_handles(sess, k=3, n=16):
    mats = [RNG.standard_normal((n, n)) + n * np.eye(n) for _ in range(k)]
    return [sess.register(m, op="lu_small") for m in mats], mats


def _conservation_holds(m):
    return m.get("requests_total") == (
        m.get("completed_requests") + m.get("failed_requests_total")
        + m.get("shed_requests_total") + m.get("admission_rejected_total")
        + m.get("deadline_expired_total") + m.get("cancelled_requests"))


# -- the injector: the reference's schedule, and determinism ----------------

_SITES = ("dispatch", "hbm", "compile", "dispatch", "refine.lo_factor",
          "dispatch", "snapshot", "update", "hbm", "tuner.compile")


def _drive(inj, steps=120):
    """A fixed opportunity sequence over every site, with jitter draws."""
    draws = []
    for i in range(steps):
        inj.fire(_SITES[i % len(_SITES)])
        if i % 7 == 0:
            draws.append(inj.uniform("backoff"))
    return (inj.schedule(), inj.schedule_digest(), inj.fired_counts(),
            inj.opportunity_counts(), draws)


_PLANS = [default_plan(s).to_dict() for s in (1, 2, 3)] + [
    {"seed": 42, "specs": [
        {"kind": "dispatch_error", "rate": 0.3},
        {"kind": "slow_device", "rate": 0.2, "latency_s": 0.0},
        {"kind": "hbm_exhaustion", "rate": 0.5, "after": 2, "count": 3},
        {"kind": "update_abort", "rate": 0.25, "count": 4}]}]


@pytest.mark.parametrize("plan", _PLANS, ids=["default1", "default2",
                                              "default3", "custom42"])
def test_injector_fires_the_reference_schedule(plan):
    port = _drive(FaultInjector(FaultPlan.from_dict(plan)))
    ref = _drive(RefInjector(RefPlan.from_dict(plan)))
    assert port == ref
    assert port[0], "the plan must fire at these rates"


def test_default_plan_is_the_reference_plan():
    for seed in (1, 7):
        assert default_plan(seed).to_dict() == ref_default_plan(seed).to_dict()
    assert faults_mod.KINDS == tuple(
        __import__("slate_tpu.runtime.faults", fromlist=["KINDS"]).KINDS)


def test_injector_schedule_is_pure_function_of_seed():
    plan = FaultPlan(seed=42, specs=(
        FaultSpec("dispatch_error", rate=0.3),
        FaultSpec("slow_device", rate=0.2, latency_s=0.0),
        FaultSpec("hbm_exhaustion", rate=0.5, after=2, count=3)))
    runs = []
    for _ in range(2):
        inj = FaultInjector(plan)
        for _ in range(50):
            inj.fire("dispatch")
        for _ in range(20):
            inj.fire("hbm")
        runs.append((inj.schedule(), inj.schedule_digest(),
                     inj.fired_counts()))
    assert runs[0] == runs[1]
    hbm = [s for s in runs[0][0] if s[1] == "hbm_exhaustion"]
    assert len(hbm) == 3 and all(seq >= 2 for _, _, seq in hbm)
    other = FaultInjector(FaultPlan(seed=43, specs=plan.specs))
    for _ in range(50):
        other.fire("dispatch")
    assert other.schedule() != [s for s in runs[0][0] if s[0] == "dispatch"]
    only = FaultInjector(plan)
    for _ in range(50):
        only.fire("dispatch")
    assert [s for s in runs[0][0] if s[0] == "dispatch"] == only.schedule()


def test_fault_plan_validation_and_roundtrip():
    with pytest.raises(ValueError):
        FaultSpec("nope", rate=0.5)
    with pytest.raises(ValueError):
        FaultSpec("dispatch_error", rate=1.5)
    with pytest.raises(ValueError):
        FaultPlan(seed=1, specs=(FaultSpec("dispatch_error", 0.1),
                                 FaultSpec("dispatch_error", 0.2)))
    plan = FaultPlan(seed=9, specs=(
        FaultSpec("compile_stall", rate=0.5, latency_s=1e-3),))
    assert FaultPlan.from_dict(plan.to_dict()) == plan
    assert DEGRADATION_LADDER == {
        "grouped": "per_request", "mixed": "working_precision",
        "dense": "per_request", "mesh": "reject"}


def test_transient_error_class_is_retryable_slate_error_is_not():
    assert issubclass(TransientDispatchError, RuntimeError)
    assert not issubclass(TransientDispatchError, SlateError)
    assert issubclass(DeadlineExceeded, SlateError)
    assert issubclass(RequestShed, SlateError)
    assert issubclass(stt.QuotaExceeded, SlateError)


# -- the Session's seams -------------------------------------------------------


def test_faults_disabled_is_never_consulted(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("FaultInjector consulted with faults=None")
    monkeypatch.setattr(FaultInjector, "fire", boom)
    monkeypatch.setattr(FaultInjector, "uniform", boom)
    sess = stt.Session(hbm_budget=1 << 14, device="cpu")  # evicts
    assert sess.faults is None
    h, _ = _chol_handle(sess)
    hs, _ = _small_handles(sess, k=2)
    sess.warmup(h)
    with Executor(sess, max_batch=4, max_wait=1e-3) as ex:
        futs = [ex.submit(h, RNG.standard_normal(N)) for _ in range(4)]
        futs += [ex.submit(hs[i % 2], RNG.standard_normal(16))
                 for i in range(4)]
        for f in futs:
            f.result(timeout=60)
    assert sess.metrics.get("evictions") > 0


def test_injected_dispatch_error_retried_with_deterministic_backoff():
    def run():
        sess = stt.Session(device="cpu")
        sess.enable_faults(FaultPlan(seed=7, specs=(
            FaultSpec("dispatch_error", rate=1.0, count=2),)))
        h, spd = _chol_handle(sess)
        sess.warmup(h)
        with Executor(sess, max_batch=4, max_wait=1e-3, retries=3,
                      backoff_base=1e-3, backoff_max=8e-3) as ex:
            b = RNG.standard_normal(N)
            x = ex.submit(h, b).result(timeout=60)
        assert np.abs(spd @ x - b).max() < 1e-8
        snap = sess.metrics.snapshot()
        return (snap["counters"]["retries"],
                snap["counters"]["fault:dispatch_error"],
                snap["histograms"]["retry_backoff_s"]["count"],
                snap["histograms"]["retry_backoff_s"]["sum"])
    a, b = run(), run()
    assert a[0] == 2 and a[1] == 2 and a[2] == 2
    assert a == b  # injector-keyed jitter: the backoff replays
    assert 1e-3 <= a[3] <= 8e-3 + 4e-3


def test_injected_hbm_exhaustion_forces_eviction_under_pressure():
    sess = stt.Session(device="cpu")  # unbounded: only the fault evicts
    sess.enable_faults(FaultPlan(seed=1, specs=(
        FaultSpec("hbm_exhaustion", rate=1.0, after=1, count=1),)))
    h1, _ = _chol_handle(sess)
    h2, _ = _chol_handle(sess)
    sess.solve(h1, RNG.standard_normal(N))  # insert 0: clean
    sess.solve(h2, RNG.standard_normal(N))
    assert sess.cached_handles() == [h2]
    assert sess.metrics.get("evictions") == 1
    assert sess.metrics.get("budget_overflows") == 1
    assert sess.metrics.get("fault:hbm_exhaustion") == 1


def test_slow_device_sleeps_at_the_dispatch_seam():
    sess = stt.Session(device="cpu")
    sess.enable_faults(FaultPlan(seed=1, specs=(
        FaultSpec("slow_device", rate=1.0, latency_s=0.05, count=1),)))
    hs, _ = _small_handles(sess, k=2)
    t0 = time.perf_counter()
    sess.solve_small_batched(hs, [RNG.standard_normal(16)] * 2)
    assert time.perf_counter() - t0 >= 0.05
    assert sess.faults.schedule() == [("dispatch", "slow_device", 0)]


# -- circuit breaker and the degradation ladder --------------------------------


def test_breaker_trips_and_degrades_grouped_bucket_to_per_request():
    sess = stt.Session(device="cpu")
    sess.enable_faults(FaultPlan(seed=3, specs=(
        FaultSpec("dispatch_error", rate=1.0, count=4),)))
    hs, mats = _small_handles(sess, k=3, n=16)
    with Executor(sess, max_batch=4, max_wait=1e-3, retries=0,
                  breaker_threshold=2, breaker_cooldown=60.0) as ex:
        futs, rhs = [], []
        for i in range(12):
            b = RNG.standard_normal(16)
            rhs.append((mats[i % 3], b))
            futs.append(ex.submit(hs[i % 3], b))
        outcomes = []
        for f in futs:
            err = f.exception(timeout=60)
            outcomes.append(("ok", f.result()) if err is None
                            else (type(err).__name__, None))
    m = sess.metrics
    assert m.get("breaker_trips_total") >= 1
    assert m.get("degraded_dispatches_total") >= 1
    served = [(x, a, b) for (o, x), (a, b) in zip(outcomes, rhs)
              if o == "ok"]
    assert served
    for x, a, b in served:
        assert np.abs(a @ x - b).max() < 1e-6
    assert _conservation_holds(m)
    assert m.get_gauge("circuit_breakers_open") >= 1


def test_breaker_half_open_probe_closes_on_success():
    sess = stt.Session(device="cpu")
    sess.enable_faults(FaultPlan(seed=3, specs=(
        FaultSpec("dispatch_error", rate=1.0, count=2),)))
    h, _ = _chol_handle(sess)
    sess.warmup(h)
    with Executor(sess, max_batch=2, max_wait=1e-3, retries=0,
                  breaker_threshold=2, breaker_cooldown=0.05) as ex:
        for _ in range(2):  # two failing buckets trip the breaker
            fs = [ex.submit(h, RNG.standard_normal(N)) for _ in range(2)]
            for f in fs:
                f.exception(timeout=60)
        assert sess.metrics.get("breaker_trips_total") == 1
        time.sleep(0.08)  # past the cooldown: the next bucket is a probe
        f = ex.submit(h, RNG.standard_normal(N))
        assert f.result(timeout=60).shape == (N,)
    m = sess.metrics
    assert m.get("breaker_probes_total") >= 1
    assert m.get("breaker_closes_total") == 1
    assert m.get_gauge("circuit_breakers_open") == 0
    assert _conservation_holds(m)


# -- cancellation races ----------------------------------------------------


def test_cancel_during_backoff_sleep():
    sess = stt.Session(device="cpu")
    sess.enable_faults(FaultPlan(seed=7, specs=(
        FaultSpec("dispatch_error", rate=1.0, count=1),)))
    h, spd = _chol_handle(sess)
    sess.warmup(h)
    with Executor(sess, max_batch=2, max_wait=1e-3, retries=2,
                  backoff_base=0.3, backoff_max=0.3) as ex:
        f_cancel = ex.submit(h, RNG.standard_normal(N))
        b = RNG.standard_normal(N)
        f_live = ex.submit(h, b)
        t0 = time.monotonic()
        while sess.metrics.get("retries") < 1:  # inside the backoff sleep
            assert time.monotonic() - t0 < 30
            time.sleep(0.005)
        assert f_cancel.cancel()
        x = f_live.result(timeout=60)
        assert np.abs(spd @ x - b).max() < 1e-8
    m = sess.metrics
    assert f_cancel.cancelled()
    assert m.get("completed_requests") == 1
    assert m.get("retries") == 1
    assert m.get("cancelled_requests") == 0
    assert m.get("failed_requests_total") == 0


def test_cancel_during_degraded_per_request_replay():
    sess = stt.Session(device="cpu")
    sess.enable_faults(FaultPlan(seed=3, specs=(
        FaultSpec("dispatch_error", rate=1.0, count=2),)))
    hs, _ = _small_handles(sess, k=2, n=16)
    bat = Batcher(sess, max_batch=4, max_wait=60.0)
    futs = [bat.submit(hs[i % 2], RNG.standard_normal(16)) for i in range(4)]
    popped = bat.pop_ready(force=True)
    assert len(popped) == 1  # one grouped bucket
    assert futs[2].cancel()
    bat.run_degraded(*popped[0])
    assert futs[2].cancelled()
    m = sess.metrics
    assert m.get("degraded_dispatches_total") == 1
    for i in (0, 1, 3):
        assert futs[i].done() and not futs[i].cancelled()
    resolved = sum(1 for i in (0, 1, 3) if futs[i].exception() is None)
    assert resolved == m.get("completed_requests")
    assert resolved + m.get("failed_requests_total") == 3
    assert m.get("failed_requests_total") == 2  # the two injected faults
    assert m.get("cancelled_requests") == 0


def test_conservation_and_correctness_under_injected_soak():
    sess = stt.Session(device="cpu")
    sess.enable_faults(FaultPlan(seed=2, specs=(
        FaultSpec("dispatch_error", rate=0.25, count=6),
        FaultSpec("slow_device", rate=0.2, latency_s=1e-3))))
    h, spd = _chol_handle(sess)
    sess.warmup(h)
    futs = []
    with Executor(sess, max_batch=4, max_wait=1e-3, retries=1,
                  backoff_base=1e-3, breaker_threshold=3,
                  breaker_cooldown=60.0) as ex:
        for _ in range(24):
            b = RNG.standard_normal(N)
            futs.append((ex.submit(h, b), b))
        for _ in range(3):
            futs.append((ex.submit(h, RNG.standard_normal((N, 2)),
                                   timeout_s=0.0), None))
        ex.flush()
        assert all(f.done() for f, _ in futs)  # no lost future
    wrong = sum(1 for f, b in futs
                if b is not None and f.exception() is None
                and np.abs(spd @ f.result() - b).max() >= 1e-8)
    assert wrong == 0
    m = sess.metrics
    assert m.get("deadline_expired_total") == 3
    assert m.get("faults_injected_total") >= 1
    assert _conservation_holds(m)


# -- Metrics --------------------------------------------------------------------


def test_histogram_percentiles_and_exemplar():
    m = Metrics()
    for v in range(1, 101):
        m.observe("lat", float(v), exemplar=None if v % 2 else f"t{v}")
    h = m.snapshot()["histograms"]["lat"]
    assert h["p50"] == pytest.approx(50, abs=1)
    assert h["p99"] == pytest.approx(99, abs=1)
    assert h["count"] == 100 and h["max"] == 100 and h["min"] == 1
    assert h["exemplar"] == {"trace_id": "t100", "value": 100.0}
    empty = Histogram().snapshot()
    assert empty["min"] is None and empty["max"] is None
    assert empty["mean"] is None and empty["p50"] == 0.0


def test_metrics_gauges_phase_and_derived_rates():
    clock = [1000.0]
    m = Metrics(clock=lambda: clock[0])
    m.set_gauges({"queue_depth": 3, "queued_buckets": 1})
    clock[0] = 1005.0
    m.set_gauge("resident_bytes", 42, t=7.0)
    snap = m.snapshot()
    assert snap["gauges"] == {"queue_depth": 3.0, "queued_buckets": 1.0,
                              "resident_bytes": 42.0}
    assert snap["gauge_ts"] == {"queue_depth": 1000.0,
                                "queued_buckets": 1000.0,
                                "resident_bytes": 7.0}
    m.drop_gauge("queued_buckets")
    m.drop_gauge("absent")
    assert m.get_gauge("queued_buckets", -1.0) == -1.0
    with m.phase("stage_x") as ph:
        time.sleep(0.01)
    assert ph.elapsed >= 0.01
    assert m.histogram("stage_x")["count"] == 1
    m.inc("cache_hits", 3)
    m.inc("cache_misses")
    m.inc("solves_total", 8)
    m.inc("solve_flops_total", 4e9)
    m.observe("solve_latency", 2.0)
    assert m.cache_hit_rate() == pytest.approx(0.75)
    assert m.solves_per_sec() == pytest.approx(4.0)
    assert m.gflops() == pytest.approx(2.0)
    assert m.snapshot()["derived"] == {"cache_hit_rate": 0.75,
                                       "solves_per_sec": 4.0, "gflops": 2.0}


def test_metrics_json_and_prometheus(tmp_path):
    sess = stt.Session(device="cpu")
    h, _ = _chol_handle(sess)
    for _ in range(3):
        sess.solve(h, RNG.standard_normal(N))
    snap = sess.metrics.snapshot()
    assert snap["counters"]["solves_total"] == 3
    assert snap["counters"]["cache_misses"] == 1
    lat = snap["histograms"]["solve_latency"]
    assert lat["count"] == 3 and 0 < lat["p50"] <= lat["p99"] <= lat["max"]
    assert snap["derived"]["cache_hit_rate"] == pytest.approx(2 / 3)
    assert snap["derived"]["solves_per_sec"] > 0
    assert snap["derived"]["gflops"] > 0
    out = tmp_path / "metrics.json"
    text = sess.metrics.to_json(str(out))
    assert json.loads(out.read_text()) == json.loads(text)
    prom = sess.metrics.to_prometheus(str(tmp_path / "m.prom"))
    assert prom == (tmp_path / "m.prom").read_text()
    lines = prom.splitlines()
    assert "# TYPE slate_tpu_solves_total counter" in lines
    assert "slate_tpu_solves_total 3.0" in lines
    assert "# TYPE slate_tpu_solve_latency summary" in lines
    assert any(ln.startswith('slate_tpu_solve_latency{quantile="0.99"} ')
               for ln in lines)
    assert "slate_tpu_solve_latency_count 3" in lines
    assert "# TYPE slate_tpu_cache_hit_rate gauge" in lines
    assert "slate_tpu_resident_bytes" in prom
