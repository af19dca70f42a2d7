"""The port's BLAS-3 verbs, norms and elementwise helpers against slate_tpu.

Operands are seeded numpy Gaussians at uneven sizes (m, n, k) =
(150, 97, 60) with nb = 32, so every verb meets padding. Each reference
matrix is carried into the port by ``interop.reference.tiled_from_arrays``
(its padded storage, kind, uplo and diag), so both packages see the same
bits. Views (.T, .H) are taken on both sides.

Tolerances: 1e-12 relative to the reference's max entry in float64 and
complex128 (summation order differs between the packages); norms and the
elementwise helpers to 1e-13 relative; NaN results exactly NaN; the flop
models exactly equal.
"""

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core import types as rtypes
from slate_tpu.linalg import norms as ref_norms
from slate_tpu.obs import flops as ref_flops
import slate_tpu_torch as stt
from slate_tpu_torch.interop.reference import tiled_from_arrays
from slate_tpu_torch.linalg import elementwise as port_el
from slate_tpu_torch.obs import flops as port_flops

torch.set_num_threads(2)

NB = 32
M, N, K = 150, 97, 60
TOL = 1e-12


def _gauss(shape, seed, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
    return x


def _pair(a, kind=stt.MatrixKind.General, uplo=stt.Uplo.General,
          diag=stt.Diag.NonUnit):
    """The same matrix in both packages: (reference, port)."""
    ref = st.from_dense(a, NB, kind=getattr(rtypes.MatrixKind, kind.name),
                        uplo=getattr(rtypes.Uplo, uplo.name),
                        diag=getattr(rtypes.Diag, diag.name))
    port = tiled_from_arrays(np.asarray(ref.data), nb=NB, kind=kind,
                             uplo=uplo, diag=diag, logical_shape=ref.shape,
                             device="cpu")
    return ref, port


def _rside(side):
    return getattr(rtypes.Side, side.name)


def _close(port, ref, tol=TOL):
    got = port.to_numpy() if hasattr(port, "to_numpy") else np.asarray(port)
    want = ref.to_numpy() if hasattr(ref, "to_numpy") else np.asarray(ref)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale


def test_interop_carries_kind_uplo_and_unit_diag():
    a = _gauss((N, N), 1)
    ref, port = _pair(a, stt.MatrixKind.Triangular, stt.Uplo.Lower,
                      stt.Diag.Unit)
    assert port.diag is stt.Diag.Unit and port.uplo is stt.Uplo.Lower
    _close(port.full_dense()[:N, :N], np.asarray(ref.full_dense())[:N, :N])


@pytest.mark.parametrize("kind,uplo,diag,view", [
    ("General", "General", "NonUnit", "T"),
    ("Symmetric", "Lower", "NonUnit", "none"),
    ("Symmetric", "Upper", "NonUnit", "T"),
    ("Hermitian", "Upper", "NonUnit", "H"),
    ("Triangular", "Lower", "Unit", "T"),
    ("Triangular", "Upper", "NonUnit", "H")])
def test_views_and_full_dense_match_reference(kind, uplo, diag, view):
    cplx = kind == "Hermitian" or view == "H"
    a = _gauss((N, N) if kind != "General" else (M, N), 2, cplx)
    ref, port = _pair(a, getattr(stt.MatrixKind, kind),
                      getattr(stt.Uplo, uplo), getattr(stt.Diag, diag))
    if view != "none":
        ref, port = getattr(ref, view), getattr(port, view)
    assert port.shape == ref.shape and port.uplo.name == ref.uplo.name
    assert port.op.name == ref.op.name
    _close(port.full_dense_canonical(), np.asarray(ref.full_dense_canonical()))
    np.testing.assert_array_equal(stt.pad_mask(port).numpy(),
                                  np.asarray(st.pad_mask(ref)))


@pytest.mark.parametrize("ta,tb", [("n", "n"), ("T", "n"), ("n", "H")])
def test_multiply_gemm_matches_reference(ta, tb):
    a = _gauss((M, K) if ta == "n" else (K, M), 3, tb == "H")
    b = _gauss((K, N) if tb == "n" else (N, K), 4, tb == "H")
    c = _gauss((M, N), 5, tb == "H")
    (ra, pa), (rb, pb), (rc, pc) = _pair(a), _pair(b), _pair(c)
    if ta != "n":
        ra, pa = getattr(ra, ta), getattr(pa, ta)
    if tb != "n":
        rb, pb = getattr(rb, tb), getattr(pb, tb)
    _close(stt.multiply(1.5, pa, pb, -0.5, pc),
           st.multiply(1.5, ra, rb, -0.5, rc))
    _close(stt.gemm(2.0, pa, pb, 0.0, pc, stt.Options(
        method_gemm=stt.MethodGemm.C)), st.gemm(2.0, ra, rb, 0.0, rc))


def test_gemm_summa_raises():
    _, p = _pair(_gauss((8, 8), 6))
    with pytest.raises(NotImplementedError, match="SUMMA"):
        stt.gemm(1.0, p, p, 0.0, p,
                 stt.Options(method_gemm=stt.MethodGemm.SUMMA))


@pytest.mark.parametrize("kind,uplo,side", [
    ("Symmetric", "Lower", "Left"), ("Symmetric", "Upper", "Right"),
    ("Hermitian", "Lower", "Left"), ("Hermitian", "Upper", "Right")])
def test_multiply_symm_hemm_match_reference(kind, uplo, side):
    cplx = kind == "Hermitian"
    n_a = M if side == "Left" else N
    ra, pa = _pair(_gauss((n_a, n_a), 7, cplx), getattr(stt.MatrixKind, kind),
                   getattr(stt.Uplo, uplo))
    rb, pb = _pair(_gauss((M, N), 8, cplx))
    rc, pc = _pair(_gauss((M, N), 9, cplx))
    if side == "Left":
        got, want = (stt.multiply(0.7, pa, pb, 1.0, pc),
                     st.multiply(0.7, ra, rb, 1.0, rc))
    else:
        got, want = (stt.multiply(0.7, pb, pa, 1.0, pc),
                     st.multiply(0.7, rb, ra, 1.0, rc))
    _close(got, want)
    verb = "hemm" if cplx else "symm"
    s = getattr(stt.Side, side)
    _close(getattr(stt, verb)(s, 0.7, pa, pb, 1.0, pc,
                              stt.Options(method_hemm=stt.MethodHemm.A)),
           getattr(st, verb)(_rside(s), 0.7, ra, rb, 1.0, rc))


@pytest.mark.parametrize("kind,uplo,trans", [
    ("Symmetric", "Lower", False), ("Symmetric", "Upper", True),
    ("Hermitian", "Lower", True), ("Hermitian", "Upper", False)])
def test_rank_k_and_rank_2k_updates_match_reference(kind, uplo, trans):
    cplx = kind == "Hermitian"
    shape = (K, N) if trans else (N, K)
    (ra, pa), (rb, pb) = (_pair(_gauss(shape, s, cplx)) for s in (10, 11))
    if trans:
        view = "H" if cplx else "T"
        ra, pa, rb, pb = (getattr(x, view) for x in (ra, pa, rb, pb))
    rc, pc = _pair(_gauss((N, N), 12, cplx), getattr(stt.MatrixKind, kind),
                   getattr(stt.Uplo, uplo))
    _close(stt.rank_k_update(-1.0, pa, 2.0, pc),
           st.rank_k_update(-1.0, ra, 2.0, rc))
    alpha = 0.5 - 0.25j if cplx else 0.5
    _close(stt.rank_2k_update(alpha, pa, pb, 1.0, pc),
           st.rank_2k_update(alpha, ra, rb, 1.0, rc))
    out = stt.rank_k_update(1.0, pa, 0.0, pc)
    assert out.kind is pc.kind and out.uplo is pc.uplo


@pytest.mark.parametrize("uplo,diag,side,view", [
    ("Lower", "NonUnit", "Left", "none"), ("Upper", "Unit", "Right", "none"),
    ("Lower", "Unit", "Right", "T"), ("Upper", "NonUnit", "Left", "T")])
def test_triangular_multiply_and_solve_match_reference(uplo, diag, side,
                                                       view):
    n_a = M if side == "Left" else N
    t = _gauss((n_a, n_a), 13) + 4 * np.sqrt(n_a) * np.eye(n_a)
    ra, pa = _pair(t, stt.MatrixKind.Triangular, getattr(stt.Uplo, uplo),
                   getattr(stt.Diag, diag))
    if view == "T":
        ra, pa = ra.T, pa.T
    rb, pb = _pair(_gauss((M, N), 14))
    s = getattr(stt.Side, side)
    _close(stt.triangular_multiply(1.5, pa, pb, s),
           st.triangular_multiply(1.5, ra, rb, _rside(s)))
    want = st.triangular_solve(1.5, ra, rb, _rside(s))
    _close(stt.triangular_solve(1.5, pa, pb, s), want)
    # method_trsm is accepted and ignored: every method runs the same
    # recursion, bit for bit, and each matches the reference's method
    base = stt.trsm(s, 1.5, pa, pb).to_numpy()
    for method in (stt.MethodTrsm.A, stt.MethodTrsm.B):
        got = stt.trsm(s, 1.5, pa, pb, stt.Options(method_trsm=method))
        np.testing.assert_array_equal(got.to_numpy(), base)
        _close(got, st.trsm(_rside(s), 1.5, ra, rb, st.Options(
            method_trsm=getattr(rtypes.MethodTrsm, method.name))))


NORM_KINDS = [("General", "General", False), ("Symmetric", "Lower", False),
              ("Hermitian", "Upper", True), ("Triangular", "Lower", False)]


@pytest.mark.parametrize("kind,uplo,cplx", NORM_KINDS)
def test_norms_match_reference(kind, uplo, cplx):
    shape = (M, N) if kind == "General" else (N, N)
    ra, pa = _pair(_gauss(shape, 15, cplx), getattr(stt.MatrixKind, kind),
                   getattr(stt.Uplo, uplo),
                   stt.Diag.Unit if kind == "Triangular" else stt.Diag.NonUnit)
    for nk in (stt.Norm.Max, stt.Norm.One, stt.Norm.Inf, stt.Norm.Fro):
        rk = getattr(rtypes.Norm, nk.name)
        _close(stt.norm(pa, nk), st.norm(ra, rk), 1e-13)
        if nk is not stt.Norm.Inf:
            _close(stt.col_norms(pa, nk), ref_norms.col_norms(ra, rk), 1e-13)
            _close(stt.norm(pa, nk, stt.NormScope.Columns),
                   st.norm(ra, rk, rtypes.NormScope.Columns), 1e-13)
    _close(stt.norm(pa, stt.Norm.Inf, stt.NormScope.Rows),
           st.norm(ra, rtypes.Norm.Inf, rtypes.NormScope.Rows), 1e-13)


@pytest.mark.parametrize("kind,uplo,cplx", NORM_KINDS)
def test_norms_propagate_nan_like_reference(kind, uplo, cplx):
    shape = (M, N) if kind == "General" else (N, N)
    a = _gauss(shape, 16, cplx)
    a[40, 20] = np.nan  # in the stored (lower) triangle of every kind
    ra, pa = _pair(a, getattr(stt.MatrixKind, kind), getattr(stt.Uplo, uplo))
    if kind == "Hermitian":  # Upper storage: put it in the upper triangle
        ra, pa = _pair(a.T.copy(), stt.MatrixKind.Hermitian, stt.Uplo.Upper)
    for nk in (stt.Norm.Max, stt.Norm.One, stt.Norm.Inf, stt.Norm.Fro):
        assert np.isnan(float(stt.norm(pa, nk)))
        assert np.isnan(float(st.norm(ra, getattr(rtypes.Norm, nk.name))))


def test_norm_rejects_what_the_reference_rejects():
    _, p = _pair(_gauss((8, 8), 17))
    with pytest.raises(stt.SlateError):
        stt.norm(p, stt.Norm.Two)
    with pytest.raises(stt.SlateError):
        stt.norm(p, stt.Norm.Fro, stt.NormScope.Rows)


def test_elementwise_helpers_match_reference():
    (ra, pa), (rb, pb) = _pair(_gauss((M, N), 18)), _pair(_gauss((M, N), 19))
    _close(stt.add(2.0, pa, -3.0, pb), st.add(2.0, ra, -3.0, rb), 1e-13)
    _close(stt.scale(3.0, 7.0, pa.T), st.scale(3.0, 7.0, ra.T), 1e-13)
    r, c = np.linspace(1, 2, M), np.linspace(-1, 1, N)
    _close(stt.scale_row_col(r, c, pa), st.scale_row_col(r, c, ra), 1e-13)
    _close(stt.set_matrix(0.25, 4.0, pa), st.set_matrix(0.25, 4.0, ra))
    _close(stt.set_lambda(lambda i, j: i * 1000 + j, pb),
           st.set_lambda(lambda i, j: i * 1000 + j, rb))
    cp = stt.copy(pa, dtype=torch.float32)
    assert cp.dtype == torch.float32 and cp.data.data_ptr() != \
        pa.data.data_ptr()
    _close(cp, st.copy(ra, dtype=np.float32), 1e-7)
    _, s = _pair(_gauss((N, N), 20), stt.MatrixKind.Symmetric,
                 stt.Uplo.Lower)
    assert stt.copy(s).kind is stt.MatrixKind.Symmetric
    assert stt.copy(s, kind=stt.MatrixKind.General).kind is \
        stt.MatrixKind.General
    for out in (stt.add(1.0, pa, 1.0, pb), stt.set_matrix(1.0, 1.0, pa),
                stt.set_lambda(lambda i, j: i + j + 1.0, pa)):
        assert not out.data[M:].any() and not out.data[:, N:].any()
    with pytest.raises(NotImplementedError, match="grids"):
        port_el.redistribute(pa, None)
    with pytest.raises(stt.SlateError, match="shape"):
        stt.add(1.0, pa, 1.0, pa.T)


def test_constructors_and_flop_models_match_reference():
    z = stt.zeros(M, N, NB, torch.float64, device="cpu",
                  kind=stt.MatrixKind.Symmetric, uplo=stt.Uplo.Upper)
    rz = st.zeros(M, N, NB, np.float64)
    assert tuple(z.data.shape) == rz.data.shape and not z.data.any()
    assert z.kind is stt.MatrixKind.Symmetric
    a = _gauss((N, N), 21)
    for port_ctor, ref_ctor, extra in (
            (stt.symmetric, st.symmetric, ()),
            (stt.triangular, st.triangular, ())):
        p = port_ctor(a, NB, stt.Uplo.Upper, *extra, device="cpu")
        r = ref_ctor(a, NB, rtypes.Uplo.Upper, *extra)
        assert p.kind.name == r.kind.name
        _close(p.full_dense(), np.asarray(r.full_dense()), 0)
    for name, args in (("gemm", (M, N, K)), ("rank_k", (N, K)),
                       ("rank_2k", (N, K)), ("tri_mm", (N, K))):
        assert getattr(port_flops, name)(*args) == \
            getattr(ref_flops, name)(*args)
