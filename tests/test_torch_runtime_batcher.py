"""The port's Batcher (``slate_tpu_torch.runtime.batching``) on the CPU.

- Against the reference: the same submit sequence through the reference's
  ``Batcher`` + ``flush`` and the port's gives the same counters
  (requests_total, batches_total, solves_total, cache_hits, cache_misses,
  completed_requests, failed_batches) and answers within 1e-10 relative
  (to each answer's largest entry) in float64 and 1e-4 in float32 (the
  sums run in another order); with the same fault plan the two sessions'
  injectors fire the same schedule.
- Against the port itself: a dense bucket of K ≤ nb columns equals the
  per-request ``Session.solve`` bit for bit (the same padded shape, and
  the solves are column-independent), and a grouped small bucket equals
  per-request solves bit for bit at k = 2 (CPU torch's batched products
  are batch-independent there, as ``test_torch_small_session.py`` pins).
- The reference's Batcher tests (``tests/test_runtime.py``,
  ``tests/test_faults.py``): max_batch splits, shape bucketing,
  cancelled requests, deadlines, admission control, load shedding
  cheapest first, the min_queue_depth floor, backpressure without
  cancelled requests, a cancel between detach and dispatch, and a
  singular small item failing only its own future.
n = 64 and 70 (uneven), nb = 32.
"""

import time

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.runtime import Batcher as RefBatcher
from slate_tpu.runtime import FaultPlan as RefFaultPlan
from slate_tpu.runtime import Session as RefSession
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.runtime import (Batcher, DeadlineExceeded, RequestShed,
                                     ShedPolicy)

torch.set_num_threads(2)

N, NB = 64, 32
COUNTERS = ("requests_total", "batches_total", "solves_total", "cache_hits",
            "cache_misses", "completed_requests", "failed_batches")
TOL = {np.float64: 1e-10, np.float32: 1e-4}


def _rng(seed=17):
    return np.random.default_rng(seed)


def _spd(rng, n=N, dtype=np.float64):
    a = rng.standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(dtype)


def _chol(sess, rng, n=N):
    spd = _spd(rng, n)
    return sess.register(stt.hermitian(spd, NB, stt.Uplo.Lower,
                                       device="cpu"), op="chol"), spd


def _lu(sess, rng, n=N):
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    return sess.register(stt.from_dense(a, NB, device="cpu"), op="lu"), a


def _conservation_holds(m):
    return m.get("requests_total") == (
        m.get("completed_requests") + m.get("failed_requests_total")
        + m.get("shed_requests_total") + m.get("admission_rejected_total")
        + m.get("deadline_expired_total") + m.get("cancelled_requests"))


# -- against the reference ---------------------------------------------------


def _operators(dtype, n=70, small_n=16):
    """chol, lu and a tall qr operator at n = 70, three lu_small and two
    chol_small ones at n = 16, as numpy arrays of ``dtype``."""
    rng = _rng(23)
    g = rng.standard_normal((n, n))
    sm = [rng.standard_normal((small_n, small_n)) + small_n * np.eye(small_n)
          for _ in range(3)]
    sc = [_spd(rng, small_n) for _ in range(2)]
    return {"chol": _spd(rng, n).astype(dtype),
            "lu": (g + n * np.eye(n)).astype(dtype),
            "qr": rng.standard_normal((2 * n, n // 2)).astype(dtype),
            "lu_small": [m.astype(dtype) for m in sm],
            "chol_small": [m.astype(dtype) for m in sc]}


def _requests(ops, dtype, small, n=70, small_n=16):
    """A submit sequence: vectors and 2-column blocks against the dense
    operators (two shapes per operator, so buckets split) and, with
    ``small``, vectors against the small ones, interleaved."""
    rng = _rng(29)
    seq = []
    for i in range(6):
        for name, rows in (("chol", n), ("lu", n), ("qr", 2 * n)):
            shape = (rows,) if i % 3 else (rows, 2)
            seq.append((name, rng.standard_normal(shape).astype(dtype)))
        if not small:
            continue
        for j in range(len(ops["lu_small"])):
            seq.append((("lu_small", j),
                        rng.standard_normal(small_n).astype(dtype)))
        seq.append((("chol_small", i % 2),
                    rng.standard_normal(small_n).astype(dtype)))
    return seq


def _serve_both(dtype, plan=None, small=True):
    ops = _operators(dtype)
    ref = RefSession()
    port = stt.Session(device="cpu")
    if plan is not None:
        ref.enable_faults(RefFaultPlan.from_dict(plan))
        port.enable_faults(plan)
    rh, ph = {}, {}
    rh["chol"] = ref.register(st.hermitian(np.tril(ops["chol"]), nb=NB,
                                           uplo=st.Uplo.Lower), op="chol")
    ph["chol"] = port.register(stt.hermitian(ops["chol"], NB, stt.Uplo.Lower,
                                             device="cpu"), op="chol")
    for name in ("lu", "qr"):
        rh[name] = ref.register(st.from_dense(ops[name], nb=NB), op=name)
        ph[name] = port.register(stt.from_dense(ops[name], NB, device="cpu"),
                                 op=name)
    for kind in ("lu_small", "chol_small"):
        for j, a in enumerate(ops[kind]):
            rh[(kind, j)] = ref.register(a, op=kind)
            ph[(kind, j)] = port.register(a, op=kind)
    seq = _requests(ops, dtype, small)
    out = []
    for sess, hs, cls in ((ref, rh, RefBatcher), (port, ph, Batcher)):
        bat = cls(sess, max_batch=4, max_wait=60.0)
        futs = [bat.submit(hs[name], b) for name, b in seq]
        bat.flush()
        out.append((sess, [f.result(timeout=0) for f in futs]))
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batcher_matches_reference_counters_and_answers(dtype):
    (ref, xr), (port, xp) = _serve_both(dtype)
    for name in COUNTERS:
        assert port.metrics.get(name) == ref.metrics.get(name), name
    assert port.metrics.get("requests_total") == len(xr)
    for a, b in zip(xp, xr):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= TOL[dtype] * np.abs(b).max()


def test_fault_schedule_matches_reference_session():
    """hbm_exhaustion (evictions, refactors on miss) and zero-latency
    slow_device at the dispatch seam on the dense operators: the same
    opportunities in the same order on both sides, so the same
    schedule, evictions and misses. (Small operators are left out: when
    the budget evicts an item its own grouped call factored, the port
    serves it from that call and the reference refactors it at B = 1,
    one more miss; ROADMAP queue 3.)"""
    plan = {"seed": 5, "specs": [
        {"kind": "hbm_exhaustion", "rate": 0.4},
        {"kind": "slow_device", "rate": 0.5, "latency_s": 0.0}]}
    (ref, xr), (port, xp) = _serve_both(np.float64, plan, small=False)
    assert port.faults.schedule() == ref.faults.schedule()
    assert port.faults.schedule()  # the plan fired
    assert (port.faults.opportunity_counts()
            == ref.faults.opportunity_counts())
    for name in COUNTERS + ("evictions", "faults_injected_total",
                            "budget_overflows"):
        assert port.metrics.get(name) == ref.metrics.get(name), name
    for a, b in zip(xp, xr):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()


# -- against the port's own per-request solves --------------------------------


@pytest.mark.parametrize("n", [N, 70])
@pytest.mark.parametrize("op", ["chol", "lu"])
def test_dense_bucket_bit_identical_to_per_request(op, n):
    rng = _rng(n)
    sess = stt.Session(device="cpu")
    h, a = (_chol if op == "chol" else _lu)(sess, rng, n)
    bs = [rng.standard_normal(n) for _ in range(6)] + [
        rng.standard_normal((n, 3))]
    individual = [sess.solve(h, b) for b in bs]
    bat = Batcher(sess, max_batch=8, max_wait=10.0)
    futs = [bat.submit(h, b) for b in bs]
    bat.flush()
    for ind, f in zip(individual, futs):
        assert np.array_equal(ind, f.result(timeout=0))
    # vectors and the (n, 3) block are two buckets
    assert sess.metrics.get("batches_total") == 2
    assert sess.metrics.get("solves_total") == 2 * (6 + 3)
    assert np.abs(a @ individual[0] - bs[0]).max() < 1e-8


def test_qr_bucket_bit_identical_to_per_request():
    rng = _rng(3)
    sess = stt.Session(device="cpu")
    a = rng.standard_normal((100, 40))
    h = sess.register(stt.from_dense(a, NB, device="cpu"))
    bs = [rng.standard_normal(100) for _ in range(5)]
    individual = [sess.solve(h, b) for b in bs]
    bat = Batcher(sess, max_batch=8, max_wait=10.0)
    futs = [bat.submit(h, b) for b in bs]
    bat.flush()
    for ind, f in zip(individual, futs):
        assert f.result(timeout=0).shape == (40,)
        assert np.array_equal(ind, f.result(timeout=0))


@pytest.mark.parametrize("op", ["lu_small", "chol_small"])
def test_grouped_small_bucket_bit_identical_to_per_request(op):
    rng = _rng(41)
    mats = ([_spd(rng, 16) for _ in range(5)] if op == "chol_small" else
            [rng.standard_normal((16, 16)) + 16 * np.eye(16)
             for _ in range(5)])
    bs = [rng.standard_normal((16, 2)) for _ in range(5)]
    ref = stt.Session(device="cpu")
    per = [ref.solve(ref.register(m, op=op), b) for m, b in zip(mats, bs)]
    sess = stt.Session(device="cpu")
    hs = [sess.register(m, op=op) for m in mats]
    bat = Batcher(sess, max_batch=8, max_wait=10.0)
    futs = [bat.submit(h, b) for h, b in zip(hs, bs)]
    bat.flush()
    for x, f in zip(per, futs):
        assert np.array_equal(x, f.result(timeout=0))
    assert sess.metrics.get("batches_total") == 1
    assert sess.metrics.get("batched_programs") == 2  # factor + solve


def test_grouped_singular_item_fails_only_its_future():
    rng = _rng(43)
    mats = [rng.standard_normal((16, 16)) + 16 * np.eye(16)
            for _ in range(4)]
    mats[2][:, 5] = 0.0
    bs = [rng.standard_normal((16, 2)) for _ in range(4)]
    ref = stt.Session(device="cpu")
    good = {i: ref.solve(ref.register(mats[i]), bs[i]) for i in (0, 1, 3)}
    sess = stt.Session(device="cpu")
    hs = [sess.register(m) for m in mats]
    bat = Batcher(sess, max_batch=8, max_wait=10.0)
    futs = [bat.submit(h, b) for h, b in zip(hs, bs)]
    bat.flush()
    with pytest.raises(SlateError, match="info=6"):
        futs[2].result(timeout=0)
    for i in (0, 1, 3):
        assert np.array_equal(futs[i].result(timeout=0), good[i])
    m = sess.metrics
    assert m.get("failed_requests_total") == 1
    assert m.get("completed_requests") == 3
    assert _conservation_holds(m)


def test_bucket_counts_each_client_column_as_a_solve():
    rng = _rng(47)
    sess = stt.Session(device="cpu")
    h, a = _chol(sess, rng)
    bs = [rng.standard_normal(N) for _ in range(3)]
    bat = Batcher(sess, max_batch=8, max_wait=10.0)
    futs = [bat.submit(h, b) for b in bs]
    bat.flush()
    for f, b in zip(futs, bs):
        assert np.abs(a @ f.result(timeout=0) - b).max() < 1e-8
    m = sess.metrics
    assert m.get("batches_total") == m.get("dispatches_total") == 1
    assert m.get("solves_total") == 3
    assert m.get("solve_flops_total") == 2.0 * N * N * 3


# -- the reference's Batcher tests ------------------------------------------


def test_batcher_max_batch_splits():
    rng = _rng(5)
    sess = stt.Session(device="cpu")
    h, _ = _lu(sess, rng)
    bat = Batcher(sess, max_batch=4, max_wait=10.0)
    futs = [bat.submit(h, rng.standard_normal(N)) for _ in range(10)]
    ready = bat.pop_ready()  # two full buckets before the deadline
    assert [len(r) for _, r in ready] == [4, 4]
    for key, reqs in ready:
        bat.run(key, reqs)
    bat.flush()
    assert all(f.result(timeout=0).shape == (N,) for f in futs)
    assert sess.metrics.get("batches_total") == 3


def test_batcher_skips_cancelled_requests():
    rng = _rng(7)
    sess = stt.Session(device="cpu")
    h, _ = _lu(sess, rng)
    bat = Batcher(sess, max_batch=8, max_wait=10.0)
    futs = [bat.submit(h, rng.standard_normal(N)) for _ in range(4)]
    assert futs[1].cancel()
    bat.flush()
    assert futs[1].cancelled()
    assert all(futs[i].result(timeout=0).shape == (N,) for i in (0, 2, 3))
    assert sess.metrics.get("cancelled_requests") == 0  # caught pre-solve
    before = sess.metrics.get("batches_total")
    assert bat.pop_ready(force=True) == []
    assert sess.metrics.get("batches_total") == before


def test_deadline_expired_fails_fast_without_occupying_a_lane():
    rng = _rng(9)
    sess = stt.Session(device="cpu")
    h, _ = _chol(sess, rng)
    sess.warmup(h)
    bat = Batcher(sess, max_batch=8, max_wait=60.0)
    dead = bat.submit(h, rng.standard_normal(N), timeout_s=0.0)
    live = bat.submit(h, rng.standard_normal(N))
    time.sleep(0.002)
    assert bat.pop_ready() == []  # live bucket not ready; expired drained
    with pytest.raises(DeadlineExceeded):
        dead.result(timeout=0)
    assert not live.done()
    assert sess.metrics.get("deadline_expired_total") == 1
    assert sess.metrics.get("batches_total") == 0
    bat.flush()
    assert live.result(timeout=0).shape == (N,)
    assert _conservation_holds(sess.metrics)


def test_batcher_next_deadline_includes_request_deadlines():
    rng = _rng(11)
    sess = stt.Session(device="cpu")
    h, _ = _chol(sess, rng)
    bat = Batcher(sess, max_batch=8, max_wait=60.0)
    assert bat.next_deadline() is None
    bat.submit(h, rng.standard_normal(N))
    bucket_dl = bat.next_deadline()
    assert bucket_dl is not None
    bat.submit(h, rng.standard_normal(N), timeout_s=0.5)
    assert bat.next_deadline() < bucket_dl
    bat.flush()


def test_admission_control_rejects_at_the_door():
    rng = _rng(13)
    sess = stt.Session(device="cpu")
    h, _ = _chol(sess, rng)
    bat = Batcher(sess, max_batch=64, max_wait=60.0,
                  shed_policy=ShedPolicy(max_queue_depth=3))
    futs = [bat.submit(h, rng.standard_normal(N)) for _ in range(5)]
    rejected = [f for f in futs if f.done()]
    assert len(rejected) == 2
    assert all(isinstance(f.exception(), RequestShed) for f in rejected)
    assert sess.metrics.get("admission_rejected_total") == 2
    bat.flush()
    assert sum(1 for f in futs if f.exception() is None) == 3
    assert _conservation_holds(sess.metrics)


def test_load_shedding_drops_cheapest_to_recompute_first():
    rng = _rng(15)
    sess = stt.Session(device="cpu")
    warm, _ = _chol(sess, rng)
    cold, _ = _chol(sess, rng)
    sess.warmup(warm)  # resident; cold never factored
    assert sess.recompute_cost(warm) < sess.recompute_cost(cold)
    bat = Batcher(sess, max_batch=64, max_wait=60.0,
                  shed_policy=ShedPolicy(max_age_s=0.01, shed_fraction=0.5,
                                         min_queue_depth=2))
    warm_futs = [bat.submit(warm, rng.standard_normal(N)) for _ in range(4)]
    cold_futs = [bat.submit(cold, rng.standard_normal(N)) for _ in range(4)]
    time.sleep(0.05)
    assert bat.maybe_shed() == 4
    assert all(isinstance(f.exception(), RequestShed) for f in warm_futs)
    assert not any(f.done() for f in cold_futs)
    assert sess.metrics.get("shed_requests_total") == 4
    assert sess.metrics.get("load_sheds_total") == 1
    bat.flush()
    assert all(f.result(timeout=0).shape == (N,) for f in cold_futs)
    assert _conservation_holds(sess.metrics)


def test_shed_no_trigger_is_free_and_inactive():
    rng = _rng(19)
    sess = stt.Session(device="cpu")
    h, _ = _chol(sess, rng)
    assert Batcher(sess, max_batch=64, max_wait=60.0).maybe_shed() == 0
    bat = Batcher(sess, max_batch=64, max_wait=60.0,
                  shed_policy=ShedPolicy(max_age_s=10.0))
    bat.submit(h, rng.standard_normal(N))
    bat.submit(h, rng.standard_normal(N))
    assert bat.maybe_shed() == 0  # a young queue: no trigger
    assert sess.metrics.get_gauge("shedding_active") == 0.0
    bat.flush()


def test_shed_respects_min_queue_depth_floor():
    rng = _rng(21)
    sess = stt.Session(device="cpu")
    h, _ = _chol(sess, rng)
    sess.warmup(h)
    bat = Batcher(sess, max_batch=64, max_wait=60.0,
                  shed_policy=ShedPolicy(max_age_s=0.01, shed_fraction=1.0,
                                         min_queue_depth=4))
    futs = [bat.submit(h, rng.standard_normal(N)) for _ in range(6)]
    time.sleep(0.05)
    assert bat.maybe_shed() == 2  # the floor keeps 4 live
    assert sum(1 for f in futs if f.done()) == 2
    assert bat.maybe_shed() == 0
    assert sess.metrics.get_gauge("shedding_active") == 0.0
    bat.flush()
    assert sum(1 for f in futs if f.exception() is None) == 4


def test_backpressure_excludes_cancelled_requests():
    rng = _rng(25)
    sess = stt.Session(device="cpu")
    h, _ = _chol(sess, rng)
    bat = Batcher(sess, max_batch=8, max_wait=60.0)
    f_old = bat.submit(h, rng.standard_normal(N))
    time.sleep(0.05)
    f_new = bat.submit(h, rng.standard_normal(N))
    assert bat.backpressure()["oldest_request_age_s"] >= 0.05
    assert f_old.cancel()
    assert bat.backpressure()["oldest_request_age_s"] < 0.05
    bat._update_backpressure_locked()
    assert sess.metrics.get_gauge("oldest_request_age_s") < 0.05 + 0.02
    assert sess.metrics.get_gauge("queue_depth") == 2
    assert not f_new.done()
    bat.flush()
    assert f_new.result(timeout=0).shape == (N,)


def test_cancel_between_detach_and_dispatch():
    rng = _rng(27)
    sess = stt.Session(device="cpu")
    h, _ = _chol(sess, rng)
    sess.warmup(h)
    bat = Batcher(sess, max_batch=4, max_wait=60.0)
    futs = [bat.submit(h, rng.standard_normal(N)) for _ in range(4)]
    popped = bat.pop_ready(force=True)
    assert len(popped) == 1
    assert futs[1].cancel()
    bat.run(*popped[0])
    assert futs[1].cancelled()
    assert all(futs[i].result(timeout=0).shape == (N,) for i in (0, 2, 3))
    m = sess.metrics
    assert m.get("cancelled_requests") == 0
    assert m.get("completed_requests") == 3
    assert m.get("requests_total") == 4


def test_later_slices_raise_not_implemented():
    sess = stt.Session(device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        Batcher(sess, tenant_policies={"a": None})
    with pytest.raises(NotImplementedError, match="item 11"):
        Batcher(sess).submit(1, np.ones(4), tenant="a")
    with pytest.raises(NotImplementedError, match="item 10"):
        ShedPolicy(burn_threshold=2.0)
    with pytest.raises(ValueError):
        ShedPolicy(shed_fraction=0.0)
    with pytest.raises(ValueError):
        Batcher(sess, max_batch=0)
