"""Complex64 and complex128 through the port's CALU and threshold
pivoting, its batched engine (getrf/potrf/gesv/posv_batched) and its
Session (dense chol/lu, and lu_small/chol_small per request and
grouped), against slate_tpu on the same numpy inputs (CPU: every kernel
runs its plain version). Helpers, sizes and tolerances are
tests/test_torch_complex_drivers.py's: factors and solutions within 1e-4
(complex64) / 1e-10 (complex128) of the reference relative to their
largest entry, perm and info exact, every scaled residual ≤ 30 in
complex128. Batched lanes equal their B = 1 calls bit for bit at k = 2
right-hand sides (the CPU rule of tests/test_torch_batched_verbs.py).
"""

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import Options as ROptions
from slate_tpu.linalg import batched as ref_batched
from slate_tpu.runtime.session import Session as RefSession
import slate_tpu_torch as stt
from slate_tpu_torch.linalg import batched

from test_torch_complex_drivers import (BOUND, CTYPES, TOL, _cgauss, _cpu,
                                        _problem, _ref, _rel, _residual,
                                        _rng)

torch.set_num_threads(2)

CALU = stt.Options(method_lu=stt.MethodLU.CALU)


# ---------------------------------------------------------------------------
# LU by the tournament, and threshold pivoting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", CTYPES)
def test_calu_and_threshold_match_reference(dt):
    _, gen, _, b = _problem(150, dt)
    LU, perm, info = stt.getrf_tntpiv(_cpu(gen))
    LU_r, perm_r, info_r = st.getrf_tntpiv(_ref(gen))
    assert int(info) == int(info_r) == 0
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))
    assert _rel(LU.to_numpy(), LU_r.to_numpy()) < TOL[dt]
    X, _ = stt.gesv(_cpu(gen), _cpu(b), CALU)
    assert _residual(gen, X.to_numpy(), b) <= BOUND
    thr = stt.Options(pivot_threshold=0.5)
    LU, perm, info = stt.getrf(_cpu(gen), thr)
    LU_r, perm_r, _ = st.getrf(_ref(gen), ROptions(pivot_threshold=0.5))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))
    assert _rel(LU.to_numpy(), LU_r.to_numpy()) < TOL[dt]
    X, _ = stt.gesv(_cpu(gen), _cpu(b), thr)
    assert _residual(gen, X.to_numpy(), b) <= BOUND


# ---------------------------------------------------------------------------
# the batched engine
# ---------------------------------------------------------------------------

def _stacks(kind, n, bsz, dt):
    rng = _rng(kind, n, bsz, np.dtype(dt).name)
    a = _cgauss(rng, (bsz, n, n))
    if kind == "posv":
        a = a @ a.conj().transpose(0, 2, 1) / n + np.eye(n)
    return a.astype(dt), _cgauss(rng, (bsz, n, 2)).astype(dt)


@pytest.mark.parametrize("n", [7, 40])
@pytest.mark.parametrize("dt", CTYPES)
def test_batched_verbs_match_reference(n, dt):
    for kind, verb, ref in (("gesv", stt.gesv_batched,
                             ref_batched.gesv_batched),
                            ("posv", stt.posv_batched,
                             ref_batched.posv_batched)):
        a, b = _stacks(kind, n, 3, dt)
        x, info = verb(a, b, device="cpu")
        x_r, info_r = ref(a, b)
        np.testing.assert_array_equal(info.numpy(), np.asarray(info_r))
        assert not info.any()
        x = x.numpy()
        assert _rel(x, np.asarray(x_r)) < TOL[dt]
        for i in range(3):
            assert _residual(a[i], x[i], b[i]) <= BOUND
            # a lane equals its B = 1 call bit for bit
            one, _ = verb(a[i:i + 1], b[i:i + 1], device="cpu")
            np.testing.assert_array_equal(one.numpy()[0], x[i])


@pytest.mark.parametrize("dt", CTYPES)
def test_batched_factors_match_reference_and_flag_bad_items(dt):
    a, _ = _stacks("gesv", 40, 3, dt)
    a[1, :, 5] = 0
    lu, perm, info = batched.getrf_batched(a, device="cpu")
    lu_r, perm_r, info_r = ref_batched.getrf_batched(a)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))
    assert info.tolist() == np.asarray(info_r).tolist() == [0, 6, 0]
    ok = [0, 2]
    assert _rel(lu.numpy()[ok], np.asarray(lu_r)[ok]) < TOL[dt]
    h, _ = _stacks("posv", 40, 3, dt)
    h[2, 9, 9] = -50
    l, info = batched.potrf_batched(h, device="cpu")
    l_r, info_r = ref_batched.potrf_batched(h)
    assert info.tolist() == np.asarray(info_r).tolist() == [0, 0, 10]
    assert _rel(l.numpy()[:2], np.asarray(l_r)[:2]) < TOL[dt]


# ---------------------------------------------------------------------------
# the Session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", CTYPES)
def test_session_dense_complex_operators(dt):
    hpd, gen, _, b = _problem(150, dt)
    ref = RefSession()
    port = stt.Session(device="cpu")
    for kind, a in (("hpd", hpd), (None, gen)):
        want = ref.solve(ref.register(_ref(a, kind)), b)
        h = port.register(_cpu(a, kind))
        assert port._ops[h].op == ("chol" if kind else "lu")
        x = port.solve(h, b)
        assert x.dtype == dt and _rel(x, want) < TOL[dt]
        assert _residual(a, x, b) <= BOUND
        x1 = port.solve(h, b[:, 0])
        assert x1.shape == (150,) and _residual(a, x1, b[:, 0]) <= BOUND
    hc = port.register(_cpu(gen), op="lu", opts=CALU)
    assert _residual(gen, port.solve(hc, b), b) <= BOUND


@pytest.mark.parametrize("op", ["lu_small", "chol_small"])
@pytest.mark.parametrize("dt", CTYPES)
def test_session_small_complex_operators(op, dt):
    """complex lu_small/chol_small operators serve the reference
    Session's answers, and a grouped solve equals the per-request ones
    bit for bit."""
    kind = "posv" if op == "chol_small" else "gesv"
    mats, rhs = _stacks(kind, 40, 4, dt)
    ref = RefSession()
    port = stt.Session(device="cpu")
    hs = []
    for a, b in zip(mats, rhs):
        want = ref.solve(ref.register(a, op=op), b)
        h = port.register(a, op=op)
        assert port.small_group_key(h) == (op, 40, np.dtype(dt).name)
        got = port.solve(h, b)
        assert got.dtype == dt and _rel(got, want) < TOL[dt]
        assert _residual(a, got, b) <= BOUND
        hs.append(h)
    grouped, infos = port.solve_small_batched(hs, list(rhs))
    assert infos == [0] * 4 and grouped.shape == (4, 40, 2)
    for h, b, x in zip(hs, rhs, grouped):
        np.testing.assert_array_equal(x, port.solve(h, b))
