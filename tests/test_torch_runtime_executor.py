"""The port's Executor and the Session surface it serves through, on the
CPU (``slate_tpu_torch.runtime.executor``, ``session``).

- The reference's Executor tests (``tests/test_runtime.py``,
  ``tests/test_faults.py``), port against port: futures under concurrent
  submits (fewer batches than requests), the max-wait flush and an
  unknown handle failing fast without retries, transient failures
  retried, ``flush`` waiting for batches in flight, no lost wakeup with a
  large max_wait, deadlines waking an idle worker, and done-callbacks
  that submit again from the caller's thread and from the worker's.
- Warmup on the CPU: the factor runs once, nothing is captured
  (``aot_compiles == 0``: CUDA graphs are captured only on a card) and
  the warmed answer equals an unwarmed session's bit for bit; a small op
  runs its zero right-hand side without counting a solve. A capture that
  fails raises a SlateError naming the op and the failing call, and a
  request of the warmed shape then raises too: no path serves eagerly
  after a failed warmup.
- The Session's serving surface: op_meta, degrade_class, clear_cache,
  recompute_cost, close and the context manager,
  default_session, and the later slices' NotImplementedError pointers.
n = 64 and 70, nb = 32, float64 and float32; every Executor is closed in
a ``with`` and every result() has a timeout of 60 s or less.
"""

import threading
import time

import numpy as np
import pytest
import torch

import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.runtime import (DeadlineExceeded, Executor, RequestShed,
                                     ShedPolicy)
from slate_tpu_torch.runtime import session as session_mod

torch.set_num_threads(2)

N, NB = 64, 32
RNG = np.random.default_rng(11)


def _spd(n=N, dtype=np.float64):
    a = RNG.standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(dtype)


def _chol_handle(sess, n=N, dtype=np.float64):
    spd = _spd(n, dtype)
    return sess.register(stt.hermitian(spd, NB, stt.Uplo.Lower,
                                       device="cpu"), op="chol"), spd


def _lu_handle(sess, n=N):
    a = RNG.standard_normal((n, n)) + n * np.eye(n)
    return sess.register(stt.from_dense(a, NB, device="cpu"), op="lu"), a


# -- the reference's Executor tests ------------------------------------------


@pytest.mark.parametrize("n", [N, 70])
def test_executor_futures_under_concurrent_submits(n):
    sess = stt.Session(device="cpu")
    h, spd = _chol_handle(sess, n)
    sess.warmup(h)
    bs = [RNG.standard_normal(n) for _ in range(24)]
    results = [None] * len(bs)
    with Executor(sess, max_batch=8, max_wait=1e-3) as ex:
        def client(lo, hi):
            futs = [(i, ex.submit(h, bs[i])) for i in range(lo, hi)]
            for i, f in futs:
                results[i] = f.result(timeout=60)
        threads = [threading.Thread(target=client, args=(i * 8, (i + 1) * 8))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for b, x in zip(bs, results):
        assert np.abs(spd @ x - b).max() < 1e-8
    m = sess.metrics
    assert m.get("requests_total") == 24
    assert m.get("solves_total") == 24
    assert m.get("completed_requests") == 24
    assert m.get("batches_total") < 24


def test_executor_deadline_flush_and_failfast():
    sess = stt.Session(device="cpu")
    h, _ = _lu_handle(sess)
    with Executor(sess, max_batch=64, max_wait=5e-3) as ex:
        f = ex.submit(h, RNG.standard_normal(N))
        assert f.result(timeout=60).shape == (N,)  # only max_wait flushes
        bad = ex.submit("ghost", RNG.standard_normal(N))
        with pytest.raises(SlateError):
            bad.result(timeout=60)
    assert sess.metrics.get("retries") == 0
    assert sess.metrics.get("failed_batches") == 1
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit(h, RNG.standard_normal(N))


def test_executor_retries_transient_failures():
    sess = stt.Session(device="cpu")
    h, _ = _lu_handle(sess)
    real_solve = sess.solve
    fail_left = [2]

    def flaky(handle, b, **kw):
        if fail_left[0]:
            fail_left[0] -= 1
            raise RuntimeError("transient dispatch failure")
        return real_solve(handle, b, **kw)

    sess.solve = flaky
    with Executor(sess, max_batch=4, max_wait=1e-3, retries=2,
                  backoff_base=1e-3) as ex:
        assert ex.submit(h, RNG.standard_normal(N)).result(
            timeout=60).shape == (N,)  # the third attempt wins
    assert sess.metrics.get("retries") == 2
    assert sess.metrics.get("failed_batches") == 0


def test_executor_flush_waits_for_inflight():
    sess = stt.Session(device="cpu")
    h, _ = _chol_handle(sess)
    sess.warmup(h)
    with Executor(sess, max_batch=4, max_wait=1e-4) as ex:
        futs = [ex.submit(h, RNG.standard_normal(N)) for _ in range(8)]
        ex.flush()
        assert all(f.done() for f in futs)
        assert all(f.result(timeout=0).shape == (N,) for f in futs)


def test_executor_no_lost_wakeup_with_large_max_wait():
    sess = stt.Session(device="cpu")
    h, _ = _chol_handle(sess)
    sess.warmup(h)
    with Executor(sess, max_batch=1, max_wait=3600.0) as ex:
        for i in range(150):
            f = ex.submit(h, RNG.standard_normal(N))
            ex.flush()
            assert f.done(), f"submit {i} slept into max_wait"


def test_deadline_wakes_idle_worker():
    sess = stt.Session(device="cpu")
    h, _ = _chol_handle(sess)
    sess.warmup(h)
    with Executor(sess, max_batch=64, max_wait=60.0) as ex:
        t0 = time.monotonic()
        f = ex.submit(h, RNG.standard_normal(N), timeout_s=0.05)
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=30)
        assert time.monotonic() - t0 < 10.0  # not the 60 s bucket wait
    assert sess.metrics.get("deadline_expired_total") == 1


def test_admission_reject_callback_may_reenter_submit():
    sess = stt.Session(device="cpu")
    h, _ = _chol_handle(sess)
    sess.warmup(h)
    resubmitted = []
    # max_wait keeps the first two queued until the shutdown at the end
    # of the with, so the third submit meets a full queue however fast
    # the worker is
    with Executor(sess, max_batch=64, max_wait=30.0,
                  shed_policy=ShedPolicy(max_queue_depth=2)) as ex:
        def retry_once(f):
            if isinstance(f.exception(), RequestShed) and not resubmitted:
                resubmitted.append(ex.submit(h, RNG.standard_normal(N)))
        futs = [ex.submit(h, RNG.standard_normal(N)) for _ in range(2)]
        rej = ex.submit(h, RNG.standard_normal(N))  # rejected at the door
        rej.add_done_callback(retry_once)  # runs inline: already done
        with pytest.raises(RequestShed):
            rej.result(timeout=30)
        assert resubmitted
    for f in futs:  # the shutdown dispatched them
        assert f.result(timeout=30) is not None
    resubmitted[0].exception(timeout=30)
    assert resubmitted[0].done()


def test_expiry_callback_may_reenter_submit_on_worker_thread():
    sess = stt.Session(device="cpu")
    h, _ = _chol_handle(sess)
    sess.warmup(h)
    resubmitted = []
    with Executor(sess, max_batch=64, max_wait=0.2) as ex:
        def retry_once(f):
            if isinstance(f.exception(), DeadlineExceeded) \
                    and not resubmitted:
                resubmitted.append(ex.submit(h, RNG.standard_normal(N),
                                             timeout_s=60.0))
        exp = ex.submit(h, RNG.standard_normal((N, 2)), timeout_s=0.0)
        exp.add_done_callback(retry_once)
        with pytest.raises(DeadlineExceeded):
            exp.result(timeout=30)
        t0 = time.monotonic()
        while not resubmitted and time.monotonic() - t0 < 30:
            time.sleep(0.005)
        assert resubmitted  # re-entered from the worker, no deadlock
        assert resubmitted[0].result(timeout=30).shape == (N,)


def test_executor_stress_many_clients_short_switch_interval():
    """More client threads than cores against two operators, with the
    interpreter switching threads every microsecond: every future
    resolves to its own answer, and no count is lost."""
    import sys
    sess = stt.Session(device="cpu")
    h1, spd = _chol_handle(sess)
    h2, a = _lu_handle(sess)
    clients, per = 12, 10
    bs = [[RNG.standard_normal(N) for _ in range(per)]
          for _ in range(clients)]
    out = [[None] * per for _ in range(clients)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with Executor(sess, max_batch=8, max_wait=1e-3) as ex:
            def client(c):
                h = h1 if c % 2 else h2
                futs = [ex.submit(h, b) for b in bs[c]]
                for i, f in enumerate(futs):
                    out[c][i] = f.result(timeout=60)
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for c in range(clients):
        op = spd if c % 2 else a
        for x, b in zip(out[c], bs[c]):
            assert np.abs(op @ x - b).max() < 1e-8
    m = sess.metrics
    assert m.get("requests_total") == m.get("completed_requests") \
        == m.get("solves_total") == clients * per
    assert m.get("batches_total") == m.get("dispatches_total")
    assert m.histogram("request_latency")["count"] == clients * per


def test_executor_serves_small_operators_grouped():
    sess = stt.Session(device="cpu")
    mats = [RNG.standard_normal((16, 16)) + 16 * np.eye(16)
            for _ in range(12)]
    hs = [sess.register(m) for m in mats]
    bs = [RNG.standard_normal((16, 2)) for _ in hs]
    with Executor(sess, max_batch=8, max_wait=2e-3) as ex:
        ex.warmup(hs[:2])
        futs = [ex.submit(h, b) for h, b in zip(hs, bs)]
        xs = [f.result(timeout=60) for f in futs]
    for a, x, b in zip(mats, xs, bs):
        assert np.abs(a @ x - b).max() < 1e-10
    m = sess.metrics
    assert m.get("factors_total") == 12
    assert m.get("batches_total") < 12
    assert m.get("solves_total") == 24  # warmup's zero solves not counted


# -- warmup -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("op", ["chol", "lu", "qr"])
def test_warmup_on_the_cpu_factors_once_and_captures_nothing(op, dtype):
    n = 70
    a = (_spd(n) if op == "chol" else
         RNG.standard_normal((2 * n if op == "qr" else n, n))
         + (0 if op == "qr" else n * np.eye(n))).astype(dtype)

    def operator():
        if op == "chol":
            return stt.hermitian(a, NB, stt.Uplo.Lower, device="cpu")
        return stt.from_dense(a, NB, device="cpu")

    b = RNG.standard_normal(a.shape[0]).astype(dtype)
    warm = stt.Session(device="cpu")
    hw = warm.register(operator(), op=op)
    with Executor(warm, max_wait=1e-3) as ex:
        ex.warmup([hw])
        assert warm.metrics.get("factors_total") == 1
        assert warm.metrics.get("aot_compiles") == 0
        x = ex.submit(hw, b).result(timeout=60)
    assert warm.metrics.get("factors_total") == 1
    assert warm.metrics.get("graph_replays") == 0
    assert warm.factor(hw).graphs == {}
    cold = stt.Session(device="cpu")
    assert np.array_equal(x, cold.solve(cold.register(operator(), op=op), b))


def test_failed_capture_raises_and_never_serves_eagerly():
    sess = stt.Session(device="cpu")
    h, _ = _chol_handle(sess)
    res = sess.factor(h)
    key = (N, NB, torch.float64)
    with pytest.raises(SlateError) as err:
        sess._capture(h, sess._ops[h], res, key)
    assert "chol solve" in str(err.value) and " in " in str(err.value)
    assert res.graphs == {} and sess.metrics.get("aot_compiles") == 0
    # a warmed shape whose capture fails raises on the request path too
    sess._warm[h] = {key}
    with pytest.raises(SlateError, match="capturing the chol solve"):
        sess.solve(h, RNG.standard_normal(N))
    assert sess.metrics.get("solves_total") == 0


def test_update_k_raises_not_implemented():
    # incremental updates are ported: update_k no longer raises, and a CPU
    # warmup with it captures nothing
    sess = stt.Session(device="cpu")
    h, _ = _chol_handle(sess)
    sess.warmup(h, update_k=4)
    assert sess.metrics.get("aot_compiles") == 0


# -- the Session surface the front end uses -----------------------------------


def test_session_serving_surface():
    sess = stt.Session(device="cpu")
    h, spd = _chol_handle(sess)
    hs = sess.register(RNG.standard_normal((16, 16)) + 16 * np.eye(16))
    assert sess.op_meta(h) == ("chol", N)
    assert sess.op_meta(hs) == ("lu_small", 16)
    assert sess.op_meta("ghost") is None
    assert sess.degrade_class(h) == "dense" == sess.degrade_class(hs)
    assert sess.degrade_class("ghost") is None
    cold = sess.recompute_cost(h, 2)
    sess.factor(h)
    hot = sess.recompute_cost(h, 2)
    assert hot == 2.0 * N * N * 2 and cold == hot + N ** 3 / 3.0
    assert sess.recompute_cost("ghost") == 0.0
    # solves count the right-hand side's columns
    b = RNG.standard_normal((N, 4))
    x = sess.solve(h, b)
    assert np.abs(spd @ x - b).max() < 1e-8
    assert sess.metrics.get("solves_total") == 4
    assert sess.metrics.get("solve_flops_total") == 2.0 * N * N * 4
    sess.solve(hs, RNG.standard_normal(16))
    total = sess.cached_bytes
    assert total > 0 and len(sess.cached_handles()) == 2
    sess.clear_cache()
    assert sess.cached_bytes == 0 and sess.cached_handles() == []
    assert sess.metrics.get("evictions") == 2
    assert sess.metrics.get("evicted_bytes") == total
    assert sess.metrics.get_gauge("resident_bytes") == 0
    with sess as s:
        s.solve(h, RNG.standard_normal(N))
    assert sess.cached_handles() == []  # close released the factor
    sess.close()  # idempotent


def test_default_session_is_process_wide(monkeypatch):
    monkeypatch.setattr(session_mod, "_DEFAULT", None)
    monkeypatch.setenv("SLATE_TPU_SERVE_HBM_BUDGET", "12345")
    s1 = stt.default_session(device="cpu")
    assert stt.default_session(device="cpu") is s1
    assert s1.hbm_budget == 12345
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SlateError):
        stt.default_session()


def test_no_card_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SlateError, match="no CUDA device"):
        stt.Session()
    with pytest.raises(SlateError, match="no CUDA device"):
        Executor(stt.Session())
    with Executor(stt.Session(device="cpu")) as ex:
        assert ex.session.device.type == "cpu"


def test_later_slices_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="item 11"):
        stt.Session(device="cpu", tenant_policies={})
    with pytest.raises(NotImplementedError, match="item 10"):
        stt.Session(device="cpu", tracer=object())
    sess = stt.Session(device="cpu")
    h, _ = _chol_handle(sess)
    for call in (lambda: sess.register(np.eye(4), tenant="a"),
                 lambda: sess.solve(h, np.ones(N), tenant="a"),
                 lambda: sess.solve_matrix(h, None, tenant="a")):
        with pytest.raises(NotImplementedError, match="item 11"):
            call()
    for name in ("enable_slo", "enable_attribution", "enable_recorder"):
        with pytest.raises(NotImplementedError, match="item 10"):
            getattr(sess, name)()
    with Executor(sess) as ex:
        with pytest.raises(NotImplementedError, match="item 11"):
            ex.submit(h, np.ones(N), tenant="a")
