"""The port's Hermitian eigensolver drivers against slate_tpu on the same
numpy inputs (CPU):

- heev on every dispatch arm the port runs — MethodEig.QR through he2td
  and through two_stage (he2hb + hb2td), and Auto below ``_DC_MIN_N``
  (he2hb + a dense eigh of the band) — values only and with vectors, in
  float32, float64, complex64 and complex128 at an uneven n (70, nb 16):
  eigenvalues against the reference's within its own tests' tolerances
  (tests/test_eig_svd.py: 1e-9 absolute and relative in float64 and
  complex128; 1e-4·‖A‖ in float32 and complex64), Z by residual and
  orthogonality (< 500 in units of n·ε, the reference's bounds) and
  against the reference's Z column by column up to a unit phase, on a
  spectrum with eigenvalues 2/(n − 1) apart (tolerance 10·n²·ε);
- the scaling arm: ‖A‖ just past LAPACK's rmin = √(tiny/ε) and rmax = 1/rmin
  (both packages agree) and at the types' ends (1e±160 in float64,
  1e±21 in float32), where the reference, which scales to √tiny and
  √max, fails (ROADMAP queue 3);
- hegst, itypes 1–3 with Lower and Upper factors, against the
  reference's (1e3·n·ε·max|ref|); hegv's eigenvalues against the
  reference's and its X by the problem's residual, and a B that is not
  positive definite: potrf's info (5), NaN results, no exception, as the
  reference's;
- the divide & conquer arms (stedc): MethodEig.DC, Auto at
  n ≥ ``_DC_MIN_N`` (patched to 64) and hegv under both, against the
  reference's heev and hegv with MethodEig.DC in every type, values only
  and with vectors (eigenvalues within the tolerances above, Z by the
  gates and up to a unit phase); QR above the steqr cap warns with the
  reference's RuntimeWarning word for word and returns DC's result;
- profile_factors.py imports nothing of JAX or slate_tpu (the AST scan of
  tests/test_torch_session.py covers the package and chip_smoke.py).
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import (MethodEig as RMethodEig,
                                  Options as ROptions, Uplo as RUplo)
import slate_tpu_torch as stt
from slate_tpu_torch.linalg import cholesky, eig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NB = 70, 16
TYPES = (np.float64, np.complex128, np.float32, np.complex64)
ARMS = {"qr_he2td": dict(method_eig="QR"),
        "qr_two_stage": dict(method_eig="QR", eig_stage1="two_stage"),
        "auto_band_dense": dict()}


def _opts(pkg_opts, pkg_method, arm):
    kw = dict(ARMS[arm])
    if "method_eig" in kw:
        kw["method_eig"] = getattr(pkg_method, kw["method_eig"])
    return pkg_opts(**kw)


def _eps(dt):
    return np.finfo(np.dtype(dt).type(0).real.dtype).eps


def _is_complex(dt):
    return np.iscomplexobj(np.zeros(1, dt))


def _separated(n, seed, dt):
    """Q·diag(λ)·Qᴴ with λ = linspace(−1, 1, n) and Q from the QR of a
    seeded Gaussian: eigenvalues 2/(n − 1) apart."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    if _is_complex(dt):
        g = g + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(g)
    a = (q * np.linspace(-1.0, 1.0, n)) @ q.conj().T
    return ((a + a.conj().T) / 2).astype(dt)


def _value_tol(dt, w):
    if dt in (np.float32, np.complex64):
        return 1e-4 * max(1.0, np.abs(w).max())
    return 1e-9 + 1e-9 * np.abs(w)


def _gates(a, w, z, dt):
    n = a.shape[0]
    a = a.astype(np.complex128)
    eps = _eps(dt)
    res = np.linalg.norm(a @ z - z * w[None, :], 1) / (
        np.linalg.norm(a, 1) * n * eps)
    orth = np.linalg.norm(z.conj().T @ z - np.eye(n), 1) / (n * eps)
    return res, orth


def _same_up_to_phase(z, zr, tol):
    """Each column of z equals the reference's times a unit phase."""
    ph = np.sum(zr.conj() * z, axis=0)
    ph = ph / np.abs(ph)
    return np.abs(z - zr * ph[None, :]).max() <= tol


@pytest.fixture(scope="module")
def heev_runs():
    """Both packages' heev on every arm, type, and with/without vectors."""
    out = {}
    for dt in TYPES:
        a = _separated(N, 3, dt)
        A = stt.hermitian(np.tril(a), NB, stt.Uplo.Lower, device="cpu")
        R = st.hermitian(np.tril(a), nb=NB, uplo=RUplo.Lower)
        for arm in ARMS:
            o = _opts(stt.Options, stt.MethodEig, arm)
            ro = _opts(ROptions, RMethodEig, arm)
            w, Z = stt.heev(A, o)
            wv, Zv = stt.heev(A, o, want_vectors=False)
            rw, RZ = st.heev(R, ro)
            rwv, _ = st.heev(R, ro, want_vectors=False)
            out[(dt, arm)] = dict(
                a=a, w=w.numpy(), z=Z.to_numpy().astype(np.complex128),
                wv=wv.numpy(), Zv=Zv, rw=np.asarray(rw),
                rz=np.asarray(RZ.to_numpy()).astype(np.complex128),
                rwv=np.asarray(rwv), wdtype=w.dtype)
    return out


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("dt", TYPES)
def test_heev_values_match_reference(heev_runs, dt, arm):
    r = heev_runs[(dt, arm)]
    real = torch.float32 if dt in (np.float32, np.complex64) else \
        torch.float64
    assert r["wdtype"] == real and r["Zv"] is None
    for got, want in ((r["w"], r["rw"]), (r["wv"], r["rwv"]),
                      (r["w"], np.linalg.eigvalsh(r["a"].astype(
                          np.complex128)))):
        assert got.shape == (N,)
        assert np.all(np.abs(got - want) <= _value_tol(dt, want))
    assert np.all(np.diff(r["w"]) >= 0)


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("dt", TYPES)
def test_heev_vectors_gates_and_reference(heev_runs, dt, arm):
    r = heev_runs[(dt, arm)]
    res, orth = _gates(r["a"], r["w"], r["z"], dt)
    assert res < 500 and orth < 500, (res, orth)
    assert _same_up_to_phase(r["z"], r["rz"], 10 * N * N * _eps(dt))


def _scaled_heev(dt, arm, scale):
    a = _separated(40, 9, dt) * np.asarray(scale, dtype=dt)
    A = stt.hermitian(np.tril(a), NB, stt.Uplo.Lower, device="cpu")
    R = st.hermitian(np.tril(a), nb=NB, uplo=RUplo.Lower)
    w, Z = stt.heev(A, _opts(stt.Options, stt.MethodEig, arm))
    w = w.numpy() / scale
    assert np.abs(w - np.linspace(-1, 1, 40)).max() \
        <= np.max(_value_tol(dt, np.ones(1)))
    z = Z.to_numpy().astype(np.complex128)
    assert np.abs(z.conj().T @ z - np.eye(40)).max() < 40 * 50 * _eps(dt)
    return w, R


@pytest.mark.parametrize("dt,arm,scale", [
    (np.float64, "qr_he2td", 1e-148), (np.float64, "auto_band_dense", 1e148),
    (np.complex64, "qr_two_stage", 1e17), (np.float32, "qr_he2td", 1e17)])
def test_heev_scales_near_the_ends_like_the_reference(dt, arm, scale):
    """‖A‖ just inside LAPACK's rmin = √(tiny/ε) or outside rmax = 1/rmin:
    the port scales, the reference (thresholds √tiny, √max) does not, and
    both return the spectrum."""
    w, R = _scaled_heev(dt, arm, scale)
    rw, _ = st.heev(R, _opts(ROptions, RMethodEig, arm))
    assert np.all(np.abs(w - np.asarray(rw) / scale)
                  <= _value_tol(dt, np.linspace(-1, 1, 40)))


@pytest.mark.parametrize("dt,arm,scale", [
    (np.float64, "qr_he2td", 1e-160), (np.float64, "qr_he2td", 1e160),
    (np.float64, "auto_band_dense", 1e160),
    (np.float32, "auto_band_dense", 1e-21),
    (np.complex64, "qr_two_stage", 1e21)])
def test_heev_scales_extreme_norms(dt, arm, scale):
    """At the types' ends the port holds the spectrum; the reference,
    scaled to √tiny or √max, lets a reflector's |x|² underflow or
    overflow there (ROADMAP queue 3)."""
    _scaled_heev(dt, arm, scale)


def test_reference_heev_overflows_at_huge_norms():
    """The reference's side of the difference: at ‖A‖ ≈ 1e160 its scaled
    reflector norms overflow and its steqr does not converge."""
    a = _separated(40, 9, np.float64) * 1e160
    R = st.hermitian(np.tril(a), nb=NB, uplo=RUplo.Lower)
    with pytest.raises(Exception, match="did not converge"):
        st.heev(R, ROptions(method_eig=RMethodEig.QR))


def test_heev_of_an_empty_matrix():
    A = stt.hermitian(np.zeros((0, 0)), 8, stt.Uplo.Lower, device="cpu")
    w, Z = stt.heev(A)
    assert w.shape == (0,) and Z is None


# -- hegst / hegv -----------------------------------------------------------

def _pair(n, seed, dt):
    rng = np.random.default_rng(seed)
    a = _separated(n, seed, dt)
    g = rng.standard_normal((n, n))
    if _is_complex(dt):
        g = g + 1j * rng.standard_normal((n, n))
    b = (g @ g.conj().T / n + np.eye(n)).astype(dt)
    return a, b


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("itype", [1, 2, 3])
@pytest.mark.parametrize("dt", [np.float64, np.complex128])
def test_hegst_matches_reference(dt, itype, lower):
    n = 40
    a, b = _pair(n, 21, dt)
    l = np.linalg.cholesky(b)
    f = l if lower else l.conj().T
    uplo, ruplo = ((stt.Uplo.Lower, RUplo.Lower) if lower
                   else (stt.Uplo.Upper, RUplo.Upper))
    A = stt.hermitian(np.tril(a), NB, stt.Uplo.Lower, device="cpu")
    L = stt.triangular(f, NB, uplo, device="cpu")
    R = st.hermitian(np.tril(a), nb=NB, uplo=RUplo.Lower)
    RL = st.triangular(f, nb=NB, uplo=ruplo)
    got = stt.hegst(A, L, itype=itype).full_dense()[:n, :n].numpy()
    want = np.asarray(st.hegst(R, RL, itype=itype).full_dense_canonical()
                      )[:n, :n]
    assert np.abs(got - want).max() <= 1e3 * n * _eps(dt) * np.abs(
        want).max()
    # the congruence the itype asks for
    linv = np.linalg.inv(l)
    ref = linv @ a @ linv.conj().T if itype == 1 else l.conj().T @ a @ l
    assert np.abs(got - ref).max() <= 1e3 * n * _eps(dt) * np.abs(ref).max()


@pytest.mark.parametrize("itype,lower", [(1, True), (1, False), (2, True),
                                         (3, False)])
def test_hegv_matches_reference(itype, lower):
    n = 40
    a, b = _pair(n, 23, np.float64)
    A = stt.hermitian(np.tril(a), NB, stt.Uplo.Lower, device="cpu")
    B = stt.hermitian(np.tril(b) if lower else np.triu(b), NB,
                      stt.Uplo.Lower if lower else stt.Uplo.Upper,
                      device="cpu")
    R = st.hermitian(np.tril(a), nb=NB, uplo=RUplo.Lower)
    RB = st.hermitian(np.tril(b) if lower else np.triu(b), nb=NB,
                      uplo=RUplo.Lower if lower else RUplo.Upper)
    w, X, info = stt.hegv(A, B, itype=itype)
    rw, _, rinfo = st.hegv(R, RB, itype=itype)
    assert int(info) == int(rinfo) == 0
    w = w.numpy()
    assert np.all(np.abs(w - np.asarray(rw)) <= 1e-9 + 1e-9 * np.abs(w))
    x = X.to_numpy()
    lhs = {1: a @ x, 2: a @ b @ x, 3: b @ a @ x}[itype]
    rhs = (b @ x if itype == 1 else x) * w[None, :]
    assert np.linalg.norm(lhs - rhs, 1) / (np.linalg.norm(a, 1) * n) < 1e-10
    wv, Xv, _ = stt.hegv(A, B, itype=itype, want_vectors=False)
    assert Xv is None and np.allclose(wv.numpy(), w, atol=1e-12)


@pytest.mark.parametrize("opts", [None, "qr"])
def test_hegv_not_positive_definite_reports_info(opts):
    """The reference's test_hegv_not_pd_info: info 5 and no exception.
    Under Auto both packages return NaN eigenvalues and vectors (the
    port's band-dense path returns NaN where torch's eigh would raise).
    Under QR the port returns the same, without handing the NaN
    tridiagonal to steqr; the reference's steqr raises there after its
    60·n sweeps (ROADMAP queue 3)."""
    n = 16
    rng = np.random.default_rng(17)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    bad = np.eye(n)
    bad[4, 4] = -2.0
    A = stt.hermitian(np.tril(a), 8, stt.Uplo.Lower, device="cpu")
    B = stt.hermitian(np.tril(bad), 8, stt.Uplo.Lower, device="cpu")
    if opts is None:
        w, X, info = stt.hegv(A, B)
        rw, RX, rinfo = st.hegv(st.hermitian(np.tril(a), nb=8,
                                             uplo=RUplo.Lower),
                                st.hermitian(np.tril(bad), nb=8,
                                             uplo=RUplo.Lower))
        assert int(info) == int(rinfo) == 5
        assert np.isnan(w.numpy()).all() and np.isnan(np.asarray(rw)).all()
        assert np.isnan(X.to_numpy()).all()
        assert np.isnan(np.asarray(RX.to_numpy())).all()
    else:
        qr = stt.Options(method_eig=stt.MethodEig.QR)
        w, X, info = stt.hegv(A, B, qr)
        assert int(info) == 5
        assert np.isnan(w.numpy()).all() and np.isnan(X.to_numpy()).all()
        wv, Xv, infov = stt.hegv(A, B, qr, want_vectors=False)
        assert int(infov) == 5 and Xv is None
        assert np.isnan(wv.numpy()).all()
        with pytest.raises(st.SlateError, match="did not converge"):
            st.hegv(st.hermitian(np.tril(a), nb=8, uplo=RUplo.Lower),
                    st.hermitian(np.tril(bad), nb=8, uplo=RUplo.Lower),
                    ROptions(method_eig=RMethodEig.QR))


# -- divide & conquer (stedc) ------------------------------------------------

DC_N = 96  # tests/test_eig_svd.py test_hegv_with_dc's order and tile


def _dc_pair(dt):
    """test_hegv_with_dc's shape: a symmetric A and an SPD B (n = 96)."""
    a = _separated(DC_N, 31, dt)
    rng = np.random.default_rng(31)
    g = rng.standard_normal((DC_N, DC_N))
    if _is_complex(dt):
        g = g + 1j * rng.standard_normal((DC_N, DC_N))
    b = (g @ g.conj().T + DC_N * np.eye(DC_N)).astype(dt)
    return a, b


def _check_dc(dt, a, w, Z, rw, RZ, vectors=True):
    w = w.numpy()
    assert np.all(np.abs(w - np.asarray(rw)) <= _value_tol(dt, np.asarray(
        rw)))
    assert np.all(np.diff(w) >= 0)
    if not vectors:
        assert Z is None
        return
    z = Z.to_numpy().astype(np.complex128)
    res, orth = _gates(a, w, z, dt)
    assert res < 500 and orth < 500, (res, orth)
    rz = np.asarray(RZ.to_numpy()).astype(np.complex128)
    assert _same_up_to_phase(z, rz, 10 * DC_N * DC_N * _eps(dt))


def test_dc_and_large_auto_raise_naming_item_8b(monkeypatch):
    """Under its old name (these calls raised NotImplementedError naming
    ROADMAP item 8(b) until stedc was ported): MethodEig.DC and Auto at
    n ≥ ``_DC_MIN_N`` (patched to 64) run stedc and match the reference's
    heev and hegv with MethodEig.DC, in float64."""
    dt = np.float64
    a, b = _dc_pair(dt)
    A = stt.hermitian(np.tril(a), NB, stt.Uplo.Lower, device="cpu")
    B = stt.hermitian(np.tril(b), NB, stt.Uplo.Lower, device="cpu")
    R = st.hermitian(np.tril(a), nb=NB, uplo=RUplo.Lower)
    RB = st.hermitian(np.tril(b), nb=NB, uplo=RUplo.Lower)
    rdc = ROptions(method_eig=RMethodEig.DC)
    rw, RZ = st.heev(R, rdc)
    rwv, _ = st.heev(R, rdc, want_vectors=False)
    monkeypatch.setattr(eig, "_DC_MIN_N", 64)
    dc = stt.Options(method_eig=stt.MethodEig.DC)
    for opts in (dc, stt.Options()):
        assert eig._heev_method(DC_N, opts) is stt.MethodEig.DC
        w, Z = stt.heev(A, opts)
        _check_dc(dt, a, w, Z, rw, RZ)
        wv, Zv = stt.heev(A, opts, want_vectors=False)
        _check_dc(dt, a, wv, Zv, rwv, None, vectors=False)
        gw, X, info = stt.hegv(A, B, opts)
        grw, _, rinfo = st.hegv(R, RB, rdc)
        assert int(info) == int(rinfo) == 0
        assert np.all(np.abs(gw.numpy() - np.asarray(grw))
                      <= _value_tol(dt, np.asarray(grw)))
        x = X.to_numpy()
        # test_hegv_with_dc's residual bound
        assert np.abs(a @ x - (b @ x) * gw.numpy()).max() < DC_N * 1e-11 * \
            max(1.0, np.abs(gw.numpy()).max())


@pytest.mark.parametrize("vectors", [True, False])
@pytest.mark.parametrize("dt", TYPES)
def test_heev_dc_matches_reference(dt, vectors):
    a, _ = _dc_pair(dt)
    A = stt.hermitian(np.tril(a), NB, stt.Uplo.Lower, device="cpu")
    R = st.hermitian(np.tril(a), nb=NB, uplo=RUplo.Lower)
    w, Z = stt.heev(A, stt.Options(method_eig=stt.MethodEig.DC),
                    want_vectors=vectors)
    rw, RZ = st.heev(R, ROptions(method_eig=RMethodEig.DC),
                     want_vectors=vectors)
    real = torch.float32 if dt in (np.float32, np.complex64) else \
        torch.float64
    assert w.dtype == real
    _check_dc(dt, a, w, Z, rw, RZ, vectors)
    if vectors:
        assert Z.dtype == A.dtype


@pytest.mark.parametrize("dt", [np.float64, np.complex128, np.float32])
def test_hegv_dc_matches_reference(dt):
    a, b = _dc_pair(dt)
    A = stt.hermitian(np.tril(a), NB, stt.Uplo.Lower, device="cpu")
    B = stt.hermitian(np.tril(b), NB, stt.Uplo.Lower, device="cpu")
    w, X, info = stt.hegv(A, B, stt.Options(method_eig=stt.MethodEig.DC))
    rw, _, rinfo = st.hegv(st.hermitian(np.tril(a), nb=NB, uplo=RUplo.Lower),
                           st.hermitian(np.tril(b), nb=NB, uplo=RUplo.Lower),
                           ROptions(method_eig=RMethodEig.DC))
    assert int(info) == int(rinfo) == 0
    w = w.numpy()
    assert np.all(np.abs(w - np.asarray(rw)) <= _value_tol(dt, np.asarray(rw)))
    x = X.to_numpy().astype(np.complex128)
    a64, b64 = a.astype(np.complex128), b.astype(np.complex128)
    tol = DC_N * (1e-11 if dt is not np.float32 else 1e-2)
    assert np.abs(a64 @ x - (b64 @ x) * w).max() < tol * max(
        1.0, np.abs(w).max())


def test_qr_above_the_cap_raises_where_the_reference_redirects(monkeypatch):
    """Under its old name (the port raised here until stedc was ported):
    as tests/test_eig_svd.py's test_heev_qr_redirects_above_cap, with the
    cap at 64 and n = 96, both packages warn with the same RuntimeWarning
    and run DC; hegv warns once. At the cap QR runs."""
    import warnings

    from slate_tpu.linalg import eig as reig
    a = _separated(96, 1, np.float64)
    A = stt.hermitian(np.tril(a), 32, stt.Uplo.Lower, device="cpu")
    R = st.hermitian(np.tril(a), nb=32, uplo=RUplo.Lower)
    qr = stt.Options(method_eig=stt.MethodEig.QR)
    monkeypatch.setattr(eig, "_STEQR_MAX_N", 64)
    monkeypatch.setattr(reig, "_STEQR_MAX_N", 64)
    monkeypatch.setattr(reig, "_STEQR_PY_MAX_N", 64)

    def warned(call):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = call()
        return out, [(r.category, str(r.message)) for r in rec]

    (w, Z), got = warned(lambda: stt.heev(A, qr))
    (rw, RZ), want = warned(lambda: st.heev(
        R, ROptions(method_eig=RMethodEig.QR)))
    assert got == want and len(got) == 1 and got[0][0] is RuntimeWarning
    assert "redirecting n=96 to MethodEig.DC" in got[0][1]
    wd, Zd = stt.heev(A, stt.Options(method_eig=stt.MethodEig.DC))
    assert torch.equal(w, wd) and torch.equal(Z.data, Zd.data)
    _check_dc(np.float64, a, w, Z, rw, RZ)
    B = stt.hermitian(np.eye(96) * 2.0, 32, stt.Uplo.Lower, device="cpu")
    (_, _, info), got = warned(lambda: stt.hegv(A, B, qr))
    assert int(info) == 0 and got == want
    monkeypatch.setattr(eig, "_STEQR_MAX_N", 96)
    (w, _), got = warned(lambda: stt.heev(A, qr, want_vectors=False))
    assert got == []  # at the cap it runs QR
    assert np.abs(w.numpy() - np.linspace(-1, 1, 96)).max() < 1e-12


# -- stage hooks ------------------------------------------------------------

@pytest.mark.parametrize("arm,stages", [
    ("qr", {"he2td", "steqr", "unmtr_he2td"}),
    ("two_stage", {"he2hb", "hb2td", "steqr", "unmtr_hb2td",
                   "unmtr_he2hb"}),
    ("auto", {"he2hb", "unmtr_he2hb"}),
    ("hegv", {"potrf", "hegst", "he2td", "steqr", "unmtr_he2td"}),
    ("dc", {"he2td", "stedc", "unmtr_he2td"}),
    ("dc_two_stage", {"he2hb", "hb2td", "stedc", "unmtr_hb2td",
                      "unmtr_he2hb"}),
    ("auto_dc", {"he2td", "stedc", "unmtr_he2td"}),
    ("hegv_dc", {"potrf", "hegst", "he2td", "stedc", "unmtr_he2td"}),
])
def test_drivers_call_every_stage_through_the_hooks(arm, stages,
                                                    monkeypatch):
    """chip_smoke.py times and profile_factors.py profiles the eig stages
    by replacing their module names (obs/stages.py): each driver arm
    calls exactly its stages through them, and the hooks are restored."""
    from slate_tpu_torch.obs.stages import EIG_STAGES, wrapped_stages
    n = 40
    a = _separated(n, 3, np.float64)
    A = stt.hermitian(np.tril(a), 8, stt.Uplo.Lower, device="cpu")
    called = []

    def note(name, fn):
        def run(*args, **kw):
            called.append(name)
            return fn(*args, **kw)
        return run

    qr, dc = stt.MethodEig.QR, stt.MethodEig.DC
    if arm == "auto_dc":
        monkeypatch.setattr(eig, "_DC_MIN_N", 32)
    with wrapped_stages(note) as saved:
        if arm.startswith("hegv"):
            B = stt.hermitian(np.eye(n) * 2.0, 8, stt.Uplo.Lower,
                              device="cpu")
            w, _, info = stt.hegv(A, B, stt.Options(
                method_eig=dc if arm == "hegv_dc" else qr))
            assert int(info) == 0
        else:
            opts = {"qr": stt.Options(method_eig=qr),
                    "two_stage": stt.Options(method_eig=qr,
                                             eig_stage1="two_stage"),
                    "auto": stt.Options(),
                    "dc": stt.Options(method_eig=dc),
                    "dc_two_stage": stt.Options(method_eig=dc,
                                                eig_stage1="two_stage"),
                    "auto_dc": stt.Options()}[arm]
            w, _ = stt.heev(A, opts)
    assert set(called) == stages and set(called) <= set(EIG_STAGES)
    assert np.isfinite(w.numpy()).all()
    for name, fn in saved.items():
        assert getattr(cholesky if name == "potrf" else eig, name) is fn


def test_profile_factors_imports_no_jax_and_no_reference():
    path = os.path.join(ROOT, "profile_factors.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "slate_tpu")
