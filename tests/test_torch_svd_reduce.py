"""The port's SVD reductions and its bidiagonal SVD against slate_tpu on
the same numpy inputs (CPU):

- ge2bd: d and e against the reference's within 1e3·n·ε·‖A‖ (the
  reference reads them from the updated matrix's diagonals, the port
  takes larfg's betas: they differ by rounding), the reflectors Vl, Ur
  and their T factors against the reference's, Q_lᴴ·A·Q_r = bidiag(d, e)
  with the bidiagonal real for complex A, and the last column's missing
  right reflector (u = 0, τ = 0);
- ge2tb: the band and every level's (offset, Vs, Ts) of U and V against
  the reference's, the band's shape (upper, bandwidth nb, zero padding),
  U·B·Vᴴ = A and the back-transforms both ways (Q·C and Qᴴ·C);
- bdsqr: σ against the reference's and numpy's, U and Vᵀ against the
  reference's up to the sign of each column, by B = U·Σ·Vᵀ and by their
  orthogonality (within twice the reference's: the Golub–Kahan halves
  lose it as ε·σ₁/σ_k), the
  ``logical_k`` completion of a rank-deficient padded bidiagonal (the
  reference's own test, tests/test_eig_svd.py), and a complex (d, e)
  raising in both packages.

Shapes (m, n, nb): (70, 50, 16), (45, 45, 8) (square: the last panel's
LQ falls off the edge), (100, 37, 16) (a pad that is not a multiple of
32) and (100, 90, 8) for ge2tb (three levels); float32, float64,
complex64 and complex128. Each shape's reference outputs are computed
once per module.
"""

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.exceptions import SlateError as RSlateError
from slate_tpu.linalg import svd_module as ref_svd
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.linalg import svd as svd_mod

torch.set_num_threads(2)

TYPES = (np.float64, np.complex128, np.float32, np.complex64)
BD_SHAPES = ((70, 50, 16), (45, 45, 8), (100, 37, 16))
TB_SHAPES = ((70, 50, 16), (45, 45, 8), (100, 90, 8))


def _eps(dt):
    return np.finfo(np.dtype(dt).type(0).real.dtype).eps


def _matrix(m, n, seed, dt):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    if np.iscomplexobj(np.zeros(1, dt)):
        a = a + 1j * rng.standard_normal((m, n))
    return (a / np.sqrt(max(m, n))).astype(dt)


def _tol(n, dt):
    """1e3·n·ε·‖A‖ with ‖A‖ about 2 for these matrices."""
    return 1e3 * n * _eps(dt) * 2.0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def bd_runs():
    out = {}
    for dt in TYPES:
        for m, n, nb in BD_SHAPES:
            a = _matrix(m, n, 7, dt)
            d, e, ql, qr = stt.ge2bd(stt.from_dense(a, nb, device="cpu"))
            rd, re_, rql, rqr = ref_svd.ge2bd(st.from_dense(a, nb=nb))
            out[(dt, m, n, nb)] = dict(
                a=a, d=d, e=e, ql=ql, qr=qr, rd=_np(rd), re=_np(re_),
                rql=tuple(_np(x) for x in rql),
                rqr=tuple(_np(x) for x in rqr))
    return out


@pytest.mark.parametrize("m,n,nb", BD_SHAPES)
@pytest.mark.parametrize("dt", TYPES)
def test_ge2bd_matches_reference(bd_runs, dt, m, n, nb):
    r = bd_runs[(dt, m, n, nb)]
    tol = _tol(n, dt)
    real = torch.float32 if dt in (np.float32, np.complex64) else \
        torch.float64
    assert r["d"].dtype == real and r["e"].dtype == real
    kt = min(-(-m // nb), -(-n // nb)) * nb
    assert r["d"].shape == (kt,) and r["e"].shape == (kt - 1,)
    assert np.abs(r["d"].numpy() - r["rd"]).max() <= tol
    assert np.abs(r["e"].numpy() - r["re"]).max() <= tol
    for got, want in zip(r["ql"] + r["qr"], r["rql"] + r["rqr"]):
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= tol


@pytest.mark.parametrize("m,n,nb", BD_SHAPES)
@pytest.mark.parametrize("dt", TYPES)
def test_ge2bd_reflectors_bidiagonalize(bd_runs, dt, m, n, nb):
    """Q_lᴴ·A·Q_r = bidiag(d, e) on the padded size, real for complex A;
    the last column has no right reflector."""
    r = bd_runs[(dt, m, n, nb)]
    (Vl, Tl), (Ur, Tr) = r["ql"], r["qr"]
    mpad, npad = Vl.shape[1], Ur.shape[1]
    Ql, Qr = svd_mod.unmbr_ge2bd(
        r["ql"], r["qr"], torch.eye(mpad, dtype=Vl.dtype),
        torch.eye(npad, dtype=Vl.dtype))
    ap = np.zeros((mpad, npad), r["a"].dtype)
    ap[:m, :n] = r["a"]
    b = Ql.numpy().conj().T @ ap @ Qr.numpy()
    want = np.zeros((mpad, npad))
    kt = r["d"].shape[0]
    want[np.arange(kt), np.arange(kt)] = r["d"].numpy()
    want[np.arange(kt - 1), np.arange(1, kt)] = r["e"].numpy()
    assert np.abs(b - want).max() <= 1e2 * max(m, n) * _eps(dt)
    for q in (Ql, Qr):
        qn = q.numpy()
        assert np.abs(qn.conj().T @ qn - np.eye(qn.shape[0])).max() \
            <= 1e2 * max(m, n) * _eps(dt)
    last = (kt - 1) % svd_mod._BD_PANEL
    if kt == npad:
        assert not Ur[-1][:, last].any() and Tr[-1][:, last].abs().max() == 0
    assert np.isfinite(Tl.numpy()).all()


@pytest.fixture(scope="module")
def tb_runs():
    out = {}
    for dt in TYPES:
        for m, n, nb in TB_SHAPES:
            a = _matrix(m, n, 11, dt)
            band, ur, vr = stt.ge2tb(stt.from_dense(a, nb, device="cpu"))
            rband, rur, rvr = st.ge2tb(st.from_dense(a, nb=nb))
            out[(dt, m, n, nb)] = dict(
                a=a, band=band, ur=ur, vr=vr, rband=_np(rband),
                rur=[(o, _np(v), _np(t)) for o, v, t in rur],
                rvr=[(o, _np(v), _np(t)) for o, v, t in rvr])
    return out


@pytest.mark.parametrize("m,n,nb", TB_SHAPES)
@pytest.mark.parametrize("dt", TYPES)
def test_ge2tb_band_and_reflectors_match_reference(tb_runs, dt, m, n, nb):
    r = tb_runs[(dt, m, n, nb)]
    tol = _tol(n, dt)
    band = r["band"].numpy()
    assert band.shape == r["rband"].shape
    assert np.abs(band - r["rband"]).max() <= tol
    # upper band of width nb, zero below the diagonal and in the padding
    i, j = np.indices(band.shape)
    assert not band[(j < i) | (j > i + nb)].any()
    for got, want in ((r["ur"], r["rur"]), (r["vr"], r["rvr"])):
        assert [o for o, _, _ in got] == [o for o, _, _ in want]
        assert len(got) > (2 if (m, n) == (100, 90) else 0)
        for (_, V, T), (_, rV, rT) in zip(got, want):
            assert V.shape == rV.shape and T.shape == rT.shape
            assert np.abs(V.numpy() - rV).max() <= tol
            assert np.abs(T.numpy() - rT).max() <= tol


@pytest.mark.parametrize("m,n,nb", TB_SHAPES)
@pytest.mark.parametrize("dt", TYPES)
def test_ge2tb_reconstructs_a_and_back_transforms(tb_runs, dt, m, n, nb):
    """U·B·Vᴴ = A, and Uᴴ·(U·C) = C, Vᴴ·(V·C) = C."""
    r = tb_runs[(dt, m, n, nb)]
    band = r["band"]
    mpad, npad = band.shape
    eye_m = torch.eye(mpad, dtype=band.dtype)
    eye_n = torch.eye(npad, dtype=band.dtype)
    U = svd_mod._apply_u(r["ur"], eye_m, nb, trans=False)
    V = svd_mod._apply_v(r["vr"], eye_n, nb, trans=False)
    rec = (U @ band @ V.mH).numpy()
    bound = 1e2 * max(m, n) * _eps(dt)
    assert np.abs(rec[:m, :n] - r["a"]).max() <= bound
    assert np.abs(rec[m:]).max(initial=0) <= bound
    assert np.abs(rec[:, n:]).max(initial=0) <= bound
    c = torch.as_tensor(_matrix(mpad, 3, 5, dt))
    back = svd_mod._apply_u(r["ur"], svd_mod._apply_u(r["ur"], c, nb, False),
                            nb, True)
    assert np.abs((back - c).numpy()).max() <= bound
    c = torch.as_tensor(_matrix(npad, 3, 6, dt))
    back = svd_mod._apply_v(r["vr"], svd_mod._apply_v(r["vr"], c, nb, True),
                            nb, False)
    assert np.abs((back - c).numpy()).max() <= bound


# -- bdsqr -------------------------------------------------------------------

@pytest.mark.parametrize("k,seed", [(12, 6), (40, 2), (75, 9)])
def test_bdsqr_matches_reference_and_numpy(k, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(k)
    e = rng.standard_normal(k - 1)
    b = np.diag(d) + np.diag(e, 1)
    s, u, vt = stt.bdsqr(d, e, compute_uv=True, device="cpu")
    sv = stt.bdsqr(torch.as_tensor(d), torch.as_tensor(e), device="cpu")
    rs, ru, rvt = (np.asarray(x) for x in st.bdsqr(d, e, compute_uv=True))
    rsv = np.asarray(st.bdsqr(d, e))
    want = np.linalg.svd(b, compute_uv=False)
    for got in (s.numpy(), sv.numpy()):
        assert got.dtype == np.float64 and got.shape == (k,)
        assert np.abs(got - want).max() <= 1e-13 * k * want[0]
        assert np.abs(got - rs).max() <= 1e-13 * k * want[0]
    assert np.abs(rsv - want).max() <= 1e-13 * k * want[0]
    u, vt = u.numpy(), vt.numpy()
    assert np.abs(u * s.numpy()[None, :] @ vt - b).max() \
        <= 1e-13 * k * want[0]
    # the Golub–Kahan halves lose orthogonality as ε·σ₁/σ_k (5.7e-11 at
    # k = 75, σ_k = 4.6e-8): the port's within twice the reference's
    for got, want in ((u.T @ u, ru.T @ ru), (vt @ vt.T, rvt @ rvt.T)):
        ref_orth = np.abs(want - np.eye(k)).max()
        assert np.abs(got - np.eye(k)).max() <= 2 * ref_orth + 1e-13 * k
    # the same singular vectors as the reference's, up to a sign
    sign = np.sign(np.sum(u * ru, axis=0))
    assert np.abs(u - ru * sign).max() <= 1e-10
    assert np.abs(vt - rvt * sign[:, None]).max() <= 1e-10


def test_bdsqr_rank_deficient_logical_subspace():
    """tests/test_eig_svd.py::test_bdsqr_rank_deficient_logical_subspace on
    the port, and the reference's completion beside it: rank 4 of a
    logical 6 in a zero-padded 8; the completed columns are unit-norm
    inside the first 6 coordinates and zero beyond."""
    klog, kt = 6, 8
    d = np.zeros(kt)
    e = np.zeros(kt - 1)
    d[:4] = [3.0, 2.0, 1.5, 1.0]
    e[:3] = 0.3
    b = np.diag(d) + np.diag(e, 1)
    for pkg in ("port", "reference"):
        if pkg == "port":
            s, u, vt = (x.numpy() for x in stt.bdsqr(
                d, e, compute_uv=True, logical_k=klog, device="cpu"))
        else:
            s, u, vt = (np.asarray(x) for x in st.bdsqr(
                d, e, compute_uv=True, logical_k=klog))
        v = vt.T
        for j in range(klog):
            assert abs(np.linalg.norm(u[:klog, j]) - 1.0) < 1e-10
            assert abs(np.linalg.norm(v[:klog, j]) - 1.0) < 1e-10
            assert np.linalg.norm(u[klog:, j]) < 1e-10
            assert np.linalg.norm(v[klog:, j]) < 1e-10
        recon = (u[:klog, :klog] * s[None, :klog]) @ v[:klog, :klog].T
        assert np.linalg.norm(b[:klog, :klog] - recon) < 1e-9
        g = u[:klog, :klog]
        assert np.linalg.norm(g.T @ g - np.eye(klog)) < 1e-9
        assert np.abs(s[4:]).max() < 1e-14


def test_bdsqr_complex_raises_in_both_packages():
    d = np.ones(4, np.complex128)
    e = np.ones(3)
    with pytest.raises(SlateError, match="must be real"):
        stt.bdsqr(d, e, device="cpu")
    with pytest.raises(SlateError, match="must be real"):
        stt.bdsqr(torch.ones(4), torch.ones(3, dtype=torch.complex64),
                  device="cpu")
    with pytest.raises(RSlateError, match="must be real"):
        st.bdsqr(d, e)


def test_bdsqr_of_an_empty_bidiagonal():
    s = stt.bdsqr(np.zeros(0), np.zeros(0), device="cpu")
    assert s.shape == (0,)
    s, u, vt = stt.bdsqr(np.zeros(0), np.zeros(0), compute_uv=True,
                         device="cpu")
    assert u.shape == (0, 0) and vt.shape == (0, 0)
