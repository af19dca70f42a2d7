"""The port Session's small-problem operators ("lu_small", "chol_small")
on the CPU: registration and its validation (the reference's cases),
per-request solves with cache hits and misses, ``solve_small_batched``
(misses factored in one batched call, every request served by one
batched solve) bit for bit against per-request solves, mixed buckets,
duplicate handles, and a bad item that flags only itself. Also the
reference Session's per-request answers on the same operators.

Tolerances: the reference Session's X within X_TOL (1e-4 in float32)
relative to its largest entry; the port's grouped and per-request
answers bit for bit (k = 2 right-hand sides: CPU torch's batched
products are batch-independent there; see test_torch_batched_verbs.py).
"""

import zlib

import numpy as np
import pytest
import torch

from slate_tpu.runtime.session import Session as RefSession
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError

torch.set_num_threads(2)

N = 32
X_TOL = 1e-4


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _ops_and_rhs(nops, spd=False, k=2):
    rng = _rng(nops, spd, k)
    a = rng.standard_normal((nops, N, N))
    if spd:
        a = a @ a.transpose(0, 2, 1) / N + np.eye(N)
    b = rng.standard_normal((nops, N, k) if k else (nops, N))
    return list(a.astype(np.float32)), list(b.astype(np.float32))


def _counters(sess):
    return sess.metrics.snapshot()["counters"]


def test_register_array_gives_lu_small_and_serves_per_request():
    mats, rhs = _ops_and_rhs(2, k=0)
    sess = stt.Session(device="cpu")
    h = sess.register(mats[0])                       # auto -> lu_small
    assert sess._ops[h].op == "lu_small"
    assert sess.small_group_key(h) == ("lu_small", N, "float32")
    x = sess.solve(h, rhs[0])
    assert x.shape == (N,) and np.abs(mats[0] @ x - rhs[0]).max() < 1e-2
    sess.solve(h, rhs[1])                            # resident: a hit
    c = _counters(sess)
    assert c["cache_hits"] == 1 and c["cache_misses"] == 1
    assert c["factors_total"] == 1 and c["solves_total"] == 2
    with pytest.raises(SlateError, match="small-problem"):
        sess.solve_matrix(h, stt.from_dense(rhs[0][:, None], 16,
                                            device="cpu"))
    hd = sess.register(stt.from_dense(mats[0], 16, device="cpu"))
    assert sess.small_group_key(hd) is None


@pytest.mark.parametrize("op,spd", [("lu_small", False),
                                    ("chol_small", True)])
def test_small_ops_serve_the_reference_sessions_answers(op, spd):
    mats, rhs = _ops_and_rhs(3, spd=spd)
    ref = RefSession()
    port = stt.Session(device="cpu")
    for a, b in zip(mats, rhs):
        want = ref.solve(ref.register(a, op=op), b)
        got = port.solve(port.register(a, op=op), b)
        assert got.dtype == np.float32 and got.shape == (N, 2)
        assert np.abs(got - want).max() <= X_TOL * np.abs(want).max()


def test_register_small_validation():
    """The reference's test_session_register_small_validation cases, and
    the port's own: a tensor goes to the session's device, complex is not
    ported."""
    sess = stt.Session(device="cpu")
    with pytest.raises(SlateError):
        sess.register(np.zeros((4, 6)))               # not square
    with pytest.raises(SlateError):
        sess.register(np.zeros((4, 4)), op="lu")      # dense op, array
    with pytest.raises(SlateError):                   # small op, matrix
        sess.register(stt.from_dense(np.eye(8), 4, device="cpu"),
                      op="lu_small")
    with pytest.raises(SlateError):
        sess.register(np.zeros((2, 4, 4)), op="chol_small")
    hc = sess.register(np.eye(4, dtype=np.complex64))
    assert sess.small_group_key(hc) == ("lu_small", 4, "complex64")
    with pytest.raises(SlateError, match="floating-point or complex"):
        sess.register(np.eye(4, dtype=np.int32))
    hq = sess.register(stt.from_dense(np.eye(8, 4, dtype=np.complex64), 4,
                                      device="cpu"), op="qr")
    assert sess.small_group_key(hq) is None
    np.testing.assert_allclose(
        sess.solve(hq, np.arange(8, dtype=np.complex64)[:, None] * 1j),
        np.arange(4)[:, None] * 1j, atol=1e-6)
    h = sess.register(torch.eye(4, dtype=torch.float64), op="chol_small")
    assert sess.small_group_key(h) == ("chol_small", 4, "float64")
    assert sess._ops[h].A.device == sess.device


@pytest.mark.parametrize("op,spd", [("lu_small", False),
                                    ("chol_small", True)])
def test_grouped_solve_equals_per_request(op, spd):
    mats, rhs = _ops_and_rhs(6, spd=spd)
    s_ref = stt.Session(device="cpu")
    ref = [s_ref.solve(s_ref.register(m, op=op), b)
           for m, b in zip(mats, rhs)]
    sess = stt.Session(device="cpu")
    hs = [sess.register(m, op=op) for m in mats]
    # cold: one batched factor of the six misses, one batched solve
    xs, infos = sess.solve_small_batched(hs, rhs)
    assert infos == [0] * 6 and xs.shape == (6, N, 2)
    for a, b in zip(ref, xs):
        assert np.array_equal(a, b)
    c = _counters(sess)
    assert c["batched_programs"] == 2 and c["cache_misses"] == 6
    assert c["factors_total"] == 6 and c["dispatches_total"] == 1
    # hot: the residents stacked, one batched solve
    xs2, _ = sess.solve_small_batched(hs, rhs)
    assert np.array_equal(xs, xs2)
    c = _counters(sess)
    assert c["batched_programs"] == 3 and c["cache_hits"] == 6
    assert c["solves_total"] == 24 and c["factors_total"] == 6
    # a resident factor is the B = 1 factor's: per-request solves on the
    # grouped session give the same bits
    assert np.array_equal(sess.solve(hs[4], rhs[4]), ref[4])


def test_mixed_or_bad_buckets_raise():
    mats, rhs = _ops_and_rhs(2)
    sess = stt.Session(device="cpu")
    h_lu = sess.register(mats[0])
    h_chol = sess.register(mats[1] @ mats[1].T + N * np.eye(N,
                                                            dtype=np.float32),
                           op="chol_small")
    h_64 = sess.register(mats[0].astype(np.float64))
    h_n = sess.register(np.eye(8, dtype=np.float32))
    h_dense = sess.register(stt.from_dense(mats[0], 16, device="cpu"))
    for other in (h_chol, h_64, h_n):
        with pytest.raises(SlateError, match="mixed bucket"):
            sess.solve_small_batched([h_lu, other], rhs)
    with pytest.raises(SlateError, match="not a small-problem"):
        sess.solve_small_batched([h_lu, h_dense], rhs)
    with pytest.raises(SlateError, match="equal-length"):
        sess.solve_small_batched([h_lu], rhs)
    with pytest.raises(SlateError, match="equal-length"):
        sess.solve_small_batched([], [])


def test_duplicate_handles_count_one_miss():
    mats, rhs = _ops_and_rhs(1)
    sess = stt.Session(device="cpu")
    h = sess.register(mats[0])
    xs, infos = sess.solve_small_batched([h, h, h], rhs * 3)
    assert infos == [0, 0, 0]
    c = _counters(sess)
    assert c["cache_misses"] == 1 and c["cache_hits"] == 2
    assert c["factors_total"] == 1
    assert np.array_equal(xs[0], xs[2])


def test_grouped_solve_keeps_the_byte_budget():
    """Each cached factor owns its own storage, so the budget bounds the
    bytes that stay allocated; a factor evicted during the call that made
    it is served from that call, never refactored."""
    mats, rhs = _ops_and_rhs(12)
    item = N * N * 4 + N * 4                      # lu f32 + perm int32
    sess = stt.Session(device="cpu", hbm_budget=3 * item)
    hs = [sess.register(m) for m in mats]
    sess.solve_small_batched(hs[:3], rhs[:3])     # fills the budget
    for h in hs[:3]:
        for t in sess._cache[h].payload:
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    xs, infos = sess.solve_small_batched(hs[3:], rhs[3:])
    assert infos == [0] * 9
    assert sess.cached_handles() == hs[-3:]
    assert sess.cached_bytes == 3 * item
    c = _counters(sess)
    assert c["factors_total"] == 12 and c["cache_misses"] == 12
    assert c["evictions"] == 9 and c.get("cache_hits", 0) == 0
    for i in (0, 5, 8):
        assert np.abs(mats[3 + i] @ xs[i] - rhs[3 + i]).max() < 1e-2


def test_bad_item_flags_only_itself():
    mats, rhs = _ops_and_rhs(5)
    sess_ok = stt.Session(device="cpu")
    x_ok, _ = sess_ok.solve_small_batched(
        [sess_ok.register(m) for m in mats], rhs)
    mats[2] = np.zeros_like(mats[2])
    sess = stt.Session(device="cpu")
    hs = [sess.register(m) for m in mats]
    xs, infos = sess.solve_small_batched(hs, rhs)
    assert infos == [0, 0, 1, 0, 0]
    for i in (0, 1, 3, 4):
        assert np.array_equal(xs[i], x_ok[i])
    with pytest.raises(SlateError, match="info=1"):
        sess.solve(hs[2], rhs[2])
    assert sess.factor_info(hs[2]) == 1


def test_not_positive_definite_flags_only_itself():
    mats, rhs = _ops_and_rhs(4, spd=True)
    mats[1] = mats[1].copy()
    mats[1][9, 9] = -1.0
    sess = stt.Session(device="cpu")
    hs = [sess.register(m, op="chol_small") for m in mats]
    _, infos = sess.solve_small_batched(hs, rhs)
    assert infos == [0, 10, 0, 0]
    # the reference's Session gives the same info
    ref = RefSession()
    hr = ref.register(mats[1], op="chol_small")
    assert ref.factor_info(hr) == 10
    # and the dense path is unchanged: a TiledMatrix operator is "lu"
    h = sess.register(stt.from_dense(mats[0], 16, device="cpu"))
    assert sess._ops[h].op == "lu"
