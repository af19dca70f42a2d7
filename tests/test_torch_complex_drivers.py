"""Complex64 and complex128 through the port's dense LU and Cholesky
drivers and their verbs, against slate_tpu on the same numpy inputs
(CPU: every kernel runs its plain version); the CALU, batched and Session
cases are in tests/test_torch_complex_batched.py, which shares this
file's helpers.

Covered here: posv/potrf/potrs/potri on Hermitian positive definite
operands (lower and upper storage; an imaginary part on the diagonal is
not read), gesv/getrf/getrs/getri, getrf_nopiv/gesv_nopiv, gesv_rbt, and
gels by CholQR (whose Gram factor is a complex potrf). Sizes are small
and uneven (n ∈ {77, 150}, nb = 32) to keep the reference's complex
compiles cheap; its outputs are cached per module.

Tolerances: factors and solutions within 1e-4 (complex64) / 1e-10
(complex128) of the reference relative to their largest entry (Gaussian
operators with κ below 1e3: both packages' errors are about κ·ε);
perm and info exact; every solution's scaled residual
‖b − A·x‖∞ / (n·ε·‖A‖∞·‖x‖∞) ≤ 30 and every inverse's
‖I − A·X‖₁ / (n·ε·‖A‖₁·‖X‖₁) ≤ 30, in complex128 (the tester's bounds).
"""

import functools
import zlib

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import (MethodGels as RMethodGels,
                                  Options as ROptions, Uplo as RUplo)
import slate_tpu_torch as stt

torch.set_num_threads(2)

NB = 32
CTYPES = [np.complex64, np.complex128]
TOL = {np.complex64: 1e-4, np.complex128: 1e-10}
BOUND = 30.0


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _cgauss(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@functools.lru_cache(maxsize=None)
def _problem(n, dt):
    """(hpd, general, dominant, rhs) of order n in type dt."""
    rng = _rng(n, np.dtype(dt).name)
    x = _cgauss(rng, (n, n))
    hpd = x @ x.conj().T / n + np.eye(n)
    gen = x / np.sqrt(n) + 2 * np.eye(n)
    gen = gen[rng.permutation(n)]
    dom = _cgauss(rng, (n, n)) + 2 * n * np.eye(n)
    b = _cgauss(rng, (n, 2))
    return tuple(m.astype(dt) for m in (hpd, gen, dom, b))


def _cpu(a, kind=None):
    if kind == "hpd":
        return stt.hermitian(a, NB, stt.Uplo.Lower, device="cpu")
    return stt.from_dense(a, NB, device="cpu")


def _ref(a, kind=None):
    if kind == "hpd":
        return st.hermitian(a, NB, RUplo.Lower)
    return st.from_dense(a, NB)


def _rel(x, y):
    return np.abs(x - y).max() / np.abs(y).max()


def _eps(a):
    return np.finfo(a.real.dtype).eps


def _residual(a, x, b):
    a64, x64 = a.astype(np.complex128), x.astype(np.complex128)
    x64 = x64.reshape(len(x64), -1)
    b64 = b.astype(np.complex128).reshape(len(x64), -1)
    r = np.abs(b64 - a64 @ x64).max()
    return r / (a.shape[0] * _eps(a) * np.abs(a64).sum(1).max()
                * np.abs(x64).max())


def _inverse_residual(a, x):
    a64, x64 = a.astype(np.complex128), x.astype(np.complex128)
    r = np.abs(np.eye(len(a)) - a64 @ x64).sum(0).max()
    return r / (len(a) * _eps(a) * np.abs(a64).sum(0).max()
                * np.abs(x64).sum(0).max())


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [77, 150])
@pytest.mark.parametrize("dt", CTYPES)
def test_posv_potri_match_reference(n, dt):
    hpd, _, _, b = _problem(n, dt)
    X, info = stt.posv(_cpu(hpd, "hpd"), _cpu(b))
    X_r, info_r = st.posv(_ref(hpd, "hpd"), _ref(b))
    assert int(info) == int(info_r) == 0
    x = X.to_numpy()
    assert _rel(x, X_r.to_numpy()) < TOL[dt]
    assert _residual(hpd, x, b) <= BOUND
    L, _ = stt.potrf(_cpu(hpd, "hpd"))
    L_r, _ = st.potrf(_ref(hpd, "hpd"))
    assert _rel(L.to_numpy(), L_r.to_numpy()) < TOL[dt]
    assert not np.diagonal(L.to_numpy()).imag.any()
    inv = stt.potri(L).to_numpy()
    assert _rel(inv, st.potri(L_r).to_numpy()) < TOL[dt]
    assert _inverse_residual(hpd, inv) <= BOUND


@pytest.mark.parametrize("dt", CTYPES)
def test_potrf_upper_storage_and_imaginary_diagonal(dt):
    """Upper storage factors to U = Lᴴ; an imaginary part on the diagonal
    is not read (the reference's test_potrf_complex_ignores_imag_diagonal)
    and a non-positive-definite operand gives the reference's info."""
    hpd, _, _, b = _problem(77, dt)
    L, _ = stt.potrf(_cpu(hpd, "hpd"))
    U, info = stt.potrf(stt.hermitian(hpd, NB, stt.Uplo.Upper,
                                      device="cpu"))
    assert int(info) == 0
    np.testing.assert_allclose(U.to_numpy(), L.to_numpy().conj().T,
                               atol=TOL[dt])
    junk = hpd.copy()
    junk[np.arange(77), np.arange(77)] += 7j
    L2, _ = stt.potrf(_cpu(junk, "hpd"))
    np.testing.assert_array_equal(L2.to_numpy(), L.to_numpy())
    bad = hpd.copy()
    bad[40, 40] = -100
    _, info = stt.potrf(_cpu(bad, "hpd"))
    _, info_r = st.potrf(_ref(bad, "hpd"))
    assert int(info) == int(info_r) == 41


# ---------------------------------------------------------------------------
# LU with partial pivoting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [77, 150])
@pytest.mark.parametrize("dt", CTYPES)
def test_gesv_getri_match_reference(n, dt):
    _, gen, _, b = _problem(n, dt)
    LU, perm, info = stt.getrf(_cpu(gen))
    LU_r, perm_r, info_r = st.getrf(_ref(gen))
    assert int(info) == int(info_r) == 0
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))
    assert _rel(LU.to_numpy(), LU_r.to_numpy()) < TOL[dt]
    X, info = stt.gesv(_cpu(gen), _cpu(b))
    x = X.to_numpy()
    assert _rel(x, st.gesv(_ref(gen), _ref(b))[0].to_numpy()) < TOL[dt]
    assert _residual(gen, x, b) <= BOUND
    inv = stt.getri(LU, perm).to_numpy()
    assert _rel(inv, st.getri(LU_r, perm_r).to_numpy()) < TOL[dt]
    assert _inverse_residual(gen, inv) <= BOUND


def test_getrf_singular_info_matches_reference():
    _, gen, _, _ = _problem(150, np.complex128)
    a = gen.copy()
    a[:, 40] = 0
    _, perm, info = stt.getrf(_cpu(a))
    _, perm_r, info_r = st.getrf(_ref(a))
    assert int(info) == int(info_r) == 41
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))


# ---------------------------------------------------------------------------
# LU without pivoting, by butterflies, and by the tournament
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [77, 150])
@pytest.mark.parametrize("dt", CTYPES)
def test_nopiv_matches_reference(n, dt):
    _, _, dom, b = _problem(n, dt)
    LU, info = stt.getrf_nopiv(_cpu(dom))
    LU_r, info_r = st.getrf_nopiv(_ref(dom))
    assert int(info) == int(info_r) == 0
    assert _rel(LU.to_numpy(), LU_r.to_numpy()) < TOL[dt]
    X, info = stt.gesv_nopiv(_cpu(dom), _cpu(b))
    assert _residual(dom, X.to_numpy(), b) <= BOUND
    a = dom.copy()  # an exactly zero pivot at step 41
    a[40, :40] = 0
    a[:40, 40] = 0
    a[40, 40] = 0
    assert int(stt.getrf_nopiv(_cpu(a))[1]) \
        == int(st.getrf_nopiv(_ref(a))[1]) == 41


@pytest.mark.parametrize("dt", CTYPES)
def test_gesv_rbt_solves(dt):
    """The butterflies are real (the two packages' RBTs are different
    random transforms of the same kind), the no-pivot factor complex: the
    solution meets the bound as the reference's does."""
    _, gen, _, b = _problem(150, dt)
    X, info = stt.gesv_rbt(_cpu(gen), _cpu(b))
    X_r, info_r = st.gesv_rbt(_ref(gen), _ref(b))
    assert int(info) == int(info_r) == 0
    assert _residual(gen, X.to_numpy(), b) <= BOUND
    assert _rel(X.to_numpy(), X_r.to_numpy()) < 100 * TOL[dt]


def test_cholqr_gels_matches_reference():
    """gels by CholQR: herk, a complex potrf of the Gram matrix (K1 and
    P1) and a trsm."""
    rng = _rng("cholqr")
    a = _cgauss(rng, (200, 60))
    b = _cgauss(rng, (200, 2))
    opts = stt.Options(method_gels=stt.MethodGels.CholQR)
    X = stt.gels(_cpu(a), _cpu(b), opts).to_numpy()
    X_r = st.gels(_ref(a), _ref(b),
                  ROptions(method_gels=RMethodGels.CholQR)).to_numpy()
    assert _rel(X, X_r) < 1e-10
    np.testing.assert_allclose(X, np.linalg.lstsq(a, b, rcond=None)[0],
                               atol=1e-10)
