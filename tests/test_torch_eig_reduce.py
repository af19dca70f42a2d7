"""The port's reductions to band and tridiagonal form and its tridiagonal
QR iteration against slate_tpu on the same numpy inputs (CPU):

- he2hb: the band (full_dense), every level's (offset, Vs, Ts) and
  unmtr_he2hb (Q·C and Qᴴ·C) against the reference's;
- he2td: d, e, Vs, Ts and unmtr_he2td, the last column's zero reflector
  (V column 0, tau 0, as the reference's guard leaves it);
- hb2td on he2hb's band: d, e, Vh, Th, phase and unmtr_hb2td, at
  s = 3·b (the window pinned to the top and the bottom at once) and at
  uneven n;
- Q·T·Qᴴ = A for both stage-1 paths, and a band of only the stored
  triangle in, the full band out;
- steqr: the port's host library against the reference's plain
  recurrence ``_steqr_py`` and its C library ``_steqr_native`` (where the
  reference's library builds), eigenvalues within n·1e-14·max(1, |w|),
  Z up to the sign of each column; the library bit for bit its own run at
  one and at two threads; sterf; the refusals (above the cap, and a
  failed build raising SlateError with its command).

Sizes n ≤ 112 at nb ∈ {8, 16, 32}, uneven n included, in float32,
float64, complex64 and complex128; each shape's reference outputs are
computed once per module. Tolerance: 1e3·n·ε·‖A‖ elementwise (‖A‖ about
1 here), ε of the working type; both packages run the same Householder
algorithm, and they differ in summation order and in the port's
restriction of each update to the active trailing block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import Uplo as RUplo
from slate_tpu.linalg import eig as ref_eig
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.linalg import eig
from slate_tpu_torch.ops import _build

torch.set_num_threads(2)

TYPES = (np.float64, np.complex128, np.float32, np.complex64)


def _eps(dt):
    return np.finfo(np.dtype(dt).type(0).real.dtype).eps


def _herm(n, seed, dt):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    if np.iscomplexobj(np.zeros(1, dt)):
        g = g + 1j * rng.standard_normal((n, n))
    return ((g + g.conj().T) / (2 * np.sqrt(n))).astype(dt)


def _tol(n, dt, a):
    return 1e3 * n * _eps(dt) * max(1.0, np.abs(a).max() * np.sqrt(n))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.complex128) - want.astype(np.complex128))
    assert err.max(initial=0.0) <= tol, (what, err.max(), tol)


def _both(a, nb):
    n = a.shape[0]
    A = stt.hermitian(np.tril(a), nb, stt.Uplo.Lower, device="cpu")
    R = st.hermitian(np.tril(a), nb=nb, uplo=RUplo.Lower)
    return A, R, n


# -- he2hb, he2td, hb2td ----------------------------------------------------

# (type, n, nb): 100 at 16 pads to 112 (he2hb in two levels, he2td in two
# panels); 70 at 16 pads to 80; 24 at 8 and 48 at 16 chase at s = 3·b
CASES = [(np.float64, 100, 16), (np.complex128, 70, 16),
         (np.float32, 24, 8), (np.complex64, 48, 16)]


@pytest.fixture(scope="module")
def runs():
    """Both packages' reductions of one operator per case, and their
    back-transforms of one block C."""
    out = {}
    for dt, n, nb in CASES:
        a = _herm(n, n + nb, dt)
        A, R, _ = _both(a, nb)
        npad = -(-n // nb) * nb
        c = _herm(npad, 7, dt)[:, :5]
        ct, cj = torch.as_tensor(c), jnp.asarray(c)
        band, refl = stt.he2hb(A)
        rband, rrefl = st.he2hb(R)
        td, rtd = stt.he2td(A), st.he2td(R)
        hb, rhb = stt.hb2td(band), st.hb2td(rband)
        out[(dt, n, nb)] = dict(
            a=a, c=c, band=band, refl=refl, rband=rband, rrefl=rrefl,
            td=td, rtd=rtd, hb=hb, rhb=rhb,
            qc=stt.unmtr_he2hb(refl, ct),
            qhc=stt.unmtr_he2hb(refl, ct, trans=True),
            rqc=st.unmtr_he2hb(rrefl, cj),
            rqhc=st.unmtr_he2hb(rrefl, cj, trans=True),
            tdc=stt.unmtr_he2td(td[2], td[3], ct),
            rtdc=st.unmtr_he2td(rtd[2], rtd[3], cj),
            hbc=stt.unmtr_hb2td(hb[2], hb[3], ct, hb[4]),
            rhbc=st.unmtr_hb2td(rhb[2], rhb[3], cj, rhb[4]))
    return out


@pytest.mark.parametrize("dt,n,nb", CASES)
def test_he2hb_band_and_reflectors_match_reference(runs, dt, n, nb):
    r = runs[(dt, n, nb)]
    tol = _tol(n, dt, r["a"])
    assert r["band"].kind is stt.MatrixKind.HermitianBand
    assert (r["band"].kl, r["band"].ku) == (nb, nb)
    _close(r["band"].full_dense()[:n, :n],
           np.asarray(r["rband"].full_dense_canonical())[:n, :n], tol, "band")
    # the padding block stays exactly decoupled (Auto's eigh of the
    # logical block relies on it)
    assert not r["band"].full_dense()[n:, :n].any()
    assert [o for o, _, _ in r["refl"]] == [o for o, _, _ in r["rrefl"]]
    for (off, Vs, Ts), (_, RVs, RTs) in zip(r["refl"], r["rrefl"]):
        _close(Vs, RVs, tol, f"Vs at {off}")
        _close(Ts, RTs, tol, f"Ts at {off}")


@pytest.mark.parametrize("dt,n,nb", CASES)
def test_unmtr_he2hb_matches_reference_both_ways(runs, dt, n, nb):
    r = runs[(dt, n, nb)]
    tol = _tol(n, dt, r["a"])
    _close(r["qc"], r["rqc"], tol, "Q·C")
    _close(r["qhc"], r["rqhc"], tol, "Qᴴ·C")
    back = stt.unmtr_he2hb(r["refl"], r["qc"], trans=True)
    _close(back, r["c"], tol, "Qᴴ·Q·C")


@pytest.mark.parametrize("dt,n,nb", CASES)
def test_he2td_matches_reference(runs, dt, n, nb):
    r = runs[(dt, n, nb)]
    tol = _tol(n, dt, r["a"])
    for got, want, what in zip(r["td"], r["rtd"], ("d", "e", "Vs", "Ts")):
        _close(got, want, tol, what)
    _close(r["tdc"], r["rtdc"], tol, "unmtr_he2td")
    d, e, Vs, Ts = r["td"]
    real = torch.float32 if dt in (np.float32, np.complex64) else \
        torch.float64
    assert d.dtype == e.dtype == real
    # the last column (npad − 1) has no reflector: zero V column, tau 0
    npad = Vs.shape[1]
    k, j = divmod(npad - 1, Vs.shape[2])
    if k < Vs.shape[0]:
        assert not Vs[k, :, j].any() and not Ts[k, :, j].any()


@pytest.mark.parametrize("dt,n,nb", CASES)
def test_hb2td_matches_reference(runs, dt, n, nb):
    r = runs[(dt, n, nb)]
    tol = _tol(n, dt, r["a"])
    for got, want, what in zip(r["hb"], r["rhb"],
                               ("d", "e", "Vh", "Th", "phase")):
        _close(got, want, tol, what)
    _close(r["hbc"], r["rhbc"], tol, "unmtr_hb2td")
    s = r["band"].data.shape[0]
    assert r["hb"][2].shape == (s - 2, -(-s // nb), nb)
    # no reflector past each sweep's hops, in either package
    for j, nh in enumerate(eig.chase_hops(s, nb)):
        assert not _np(r["hb"][3][j, nh:]).any()
        assert not np.asarray(r["rhb"][3])[j, nh:].any()


@pytest.mark.parametrize("dt,n,nb", CASES)
def test_both_stage_one_paths_reconstruct_a(runs, dt, n, nb):
    r = runs[(dt, n, nb)]
    tol = _tol(n, dt, r["a"])
    d, e, Vs, Ts = r["td"]
    npad = d.shape[0]
    eye = torch.eye(npad, dtype=Vs.dtype)
    q = stt.unmtr_he2td(Vs, Ts, eye)
    t = torch.diag(d) + torch.diag(e, -1) + torch.diag(e, 1)
    _close((q @ t.to(q.dtype) @ q.mH)[:n, :n], r["a"], tol, "Q·T·Qᴴ")
    _close(q.mH @ q, np.eye(npad), tol, "QᴴQ")
    d, e, Vh, Th, phase = r["hb"]
    q = stt.unmtr_he2hb(r["refl"], stt.unmtr_hb2td(Vh, Th, eye, phase))
    t = torch.diag(d) + torch.diag(e, -1) + torch.diag(e, 1)
    _close((q @ t.to(q.dtype) @ q.mH)[:n, :n], r["a"], tol, "Q₁Q₂D·T·(…)ᴴ")


def test_he2td_leaves_the_callers_operand():
    a = _herm(40, 5, np.float64)
    A = stt.from_dense(a, 16, kind=stt.MatrixKind.Hermitian,
                       uplo=stt.Uplo.Lower, device="cpu")
    before = A.data.clone()
    stt.he2td(A)
    assert torch.equal(A.data, before)


def test_hermitian_band_full_dense_masks_and_mirrors():
    a = _herm(20, 3, np.complex128)
    junk = a.copy()
    junk[np.triu_indices(20, 1)] = 7.0  # only the lower triangle is read
    B = stt.from_dense(junk, 8, kind=stt.MatrixKind.HermitianBand,
                       uplo=stt.Uplo.Lower, kl=3, ku=3, device="cpu")
    R = st.from_dense(junk, 8, kind=st.MatrixKind.HermitianBand,
                      uplo=RUplo.Lower, kl=3, ku=3)
    _close(B.full_dense(), np.asarray(R.full_dense_canonical()), 0.0,
           "band mask")
    r, c = np.indices((24, 24))
    assert not _np(B.full_dense())[np.abs(r - c) > 3].any()
    assert (B.T.kl, B.T.ku) == (3, 3)
    with pytest.raises(NotImplementedError, match="item 9"):
        stt.from_dense(a, 8, kind=stt.MatrixKind.Band, kl=2, ku=1,
                       device="cpu").full_dense()


def test_hb2td_refuses_a_small_band():
    a = _herm(20, 3, np.float64)
    B = stt.from_dense(a, 8, kind=stt.MatrixKind.HermitianBand,
                       uplo=stt.Uplo.Lower, kl=9, ku=9, device="cpu")
    with pytest.raises(SlateError, match="3·bandwidth"):
        stt.hb2td(B)
    with pytest.raises(SlateError, match="Hermitian band"):
        stt.hb2td(stt.from_dense(a, 8, device="cpu"))


# -- steqr / sterf ----------------------------------------------------------

def _tridiag(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


def _same_up_to_sign(z, zr, tol):
    s = np.sign(np.sum(z * zr, axis=0))
    assert np.abs(z * s - zr).max() <= tol


@pytest.mark.parametrize("n,kind", [(2, "random"), (7, "random"),
                                    (64, "random"), (150, "random"),
                                    (100, "graded"), (80, "clustered")])
def test_steqr_library_matches_reference(n, kind):
    d, e = _tridiag(n, n)
    if kind == "graded":
        d = np.logspace(-6, 6, n)
        e = 0.25 * np.sqrt(d[:-1] * d[1:])
    elif kind == "clustered":
        d = 1.0 + 1e-12 * d
        e = 1e-8 * (1.0 + 0.5 * e)
    w, z = stt.steqr(d, e)
    wp, zp = ref_eig._steqr_py(d, e, True, 60)
    scale = max(1.0, np.abs(wp).max())
    assert np.abs(w - wp).max() <= n * 1e-14 * scale
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    assert np.abs(t @ z - z * w).max() <= n * 1e-13 * scale
    assert np.abs(z.T @ z - np.eye(n)).max() <= n * 1e-14
    if kind == "random":  # separated eigenvalues: vectors up to sign
        _same_up_to_sign(z, zp, 1e-9)
    native = ref_eig._steqr_native(d, e, True, 60)
    if native is not None:
        # both libraries run the same recurrence and rotations
        assert np.array_equal(w, native[0])
        assert np.array_equal(z, native[1])
    wv, zv = stt.steqr(d, e, compute_z=False)
    assert zv is None and np.array_equal(wv, w)


def test_steqr_library_threads_do_not_change_the_bits(monkeypatch):
    d, e = _tridiag(97, 4)
    w1, z1 = stt.steqr(d, e)
    monkeypatch.setattr(torch, "get_num_threads", lambda: 1)
    w2, z2 = stt.steqr(d, e)
    assert np.array_equal(w1, w2) and np.array_equal(z1, z2)


def test_steqr_extreme_ranges_and_trivial_sizes():
    for scale in (1e-160, 1e170):
        rng = np.random.default_rng(3)
        dn = scale * (1 + 0.1 * rng.standard_normal(48))
        en = scale * 0.3 * rng.standard_normal(47)
        t = np.diag(dn) + np.diag(en, 1) + np.diag(en, -1)
        wref = np.linalg.eigvalsh(t)
        w, _ = stt.steqr(dn, en, compute_z=False)
        assert np.abs(w - wref).max() < 1e-13 * np.abs(wref).max()
    w, z = stt.steqr(np.array([3.0]), np.array([]))
    assert w.tolist() == [3.0] and z.tolist() == [[1.0]]
    d, e = _tridiag(9, 1)
    stt.steqr(d, e)  # works on copies
    assert np.array_equal(d, _tridiag(9, 1)[0])


def test_sterf_matches_reference_values():
    d, e = _tridiag(60, 8)
    w = stt.sterf(d, e)
    np.testing.assert_allclose(w, np.asarray(st.sterf(d, e)), atol=1e-12)
    wt = stt.sterf(torch.as_tensor(d, dtype=torch.float32),
                   torch.as_tensor(e, dtype=torch.float32))
    assert wt.dtype == torch.float32
    np.testing.assert_allclose(wt.numpy(), w, atol=1e-5)


def test_steqr_refuses_above_cap_and_a_failed_build_raises(monkeypatch,
                                                             tmp_path):
    with pytest.raises(SlateError, match="cutoff"):
        stt.steqr(np.zeros(eig._STEQR_MAX_N + 1),
                  np.zeros(eig._STEQR_MAX_N))
    # no quiet fallback: a failed build raises, naming its command
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "GXX_FLAGS", ("-O3", "--no-such-flag"))
    with pytest.raises(SlateError,
                       match=r"build failed for steqr\.cc .*g\+\+"):
        stt.steqr(*_tridiag(5, 0))
