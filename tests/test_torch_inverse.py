"""The inverse verbs of the port (trtri, trtrm, potri, getri, getri_oop and
the api's lu/chol_inverse_using_factor) against slate_tpu on the same
inputs.

Sizes n ∈ {28, 100, 200} with nb = 32: 28 is one leaf of P1, 100 and 200
are uneven (padding) and take the trtri recursion (no power-of-two leaf
grid), 128 takes trtri_lower_batched's one P1 launch over two leaves.
Triangular operands are diagonally dominant (condition numbers below
10), with 1e6 junk in the triangle they do not store.

Tolerances: the inverses agree to 1e-4 (float32) / 1e-11 (float64)
relative to their largest entry (the reference solves against I with
lax.linalg.triangular_solve, the port inverts by P1 leaves and gemms:
different rounding); ‖I − A·X‖ / (n·ε·‖A‖·‖X‖) ≤ 30 in float64.
"""

import functools

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import Diag as RDiag, Uplo as RUplo
import slate_tpu_torch as stt

torch.set_num_threads(2)

NB = 32
TOL = {np.float32: 1e-4, np.float64: 1e-11, np.complex128: 1e-11}
UPLO = {"lower": (stt.Uplo.Lower, RUplo.Lower),
        "upper": (stt.Uplo.Upper, RUplo.Upper)}
DIAG = {"nonunit": (stt.Diag.NonUnit, RDiag.NonUnit),
        "unit": (stt.Diag.Unit, RDiag.Unit)}


def _rel(x, y):
    return np.abs(x - y).max() / np.abs(y).max()


def _inverse_residual(a, x):
    """‖I − A·X‖₁ / (n·ε·‖A‖₁·‖X‖₁) in float64, ε of A's type."""
    n = a.shape[0]
    a64, x64 = a.astype(np.complex128), x.astype(np.complex128)
    one = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    eps = np.finfo(a.real.dtype).eps
    return one(np.eye(n) - a64 @ x64) / (n * eps * one(a64) * one(x64))


def _triangular(n, lower, unit, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal((n, n))
    tri = (np.tril if lower else np.triu)(x, -1 if lower else 1)
    tri = tri / (n if unit else np.sqrt(n)) + (2 + np.abs(x.diagonal())) \
        * np.eye(n)
    junk = 1e6 * (np.triu if lower else np.tril)(x, 1 if lower else -1)
    logical = tri.copy()
    if unit:
        logical[np.arange(n), np.arange(n)] = 1.0
    return (tri + junk).astype(dtype), logical.astype(dtype)


@pytest.mark.parametrize("diag", list(DIAG))
@pytest.mark.parametrize("uplo", list(UPLO))
@pytest.mark.parametrize("n", [28, 100, 200])
def test_trtri_matches_reference(n, uplo, diag):
    lower = uplo == "lower"
    stored, logical = _triangular(n, lower, diag == "unit", np.float64, n)
    ref = st.trtri(st.triangular(stored, NB, UPLO[uplo][1],
                                 DIAG[diag][1])).to_numpy()
    T = stt.triangular(stored, NB, UPLO[uplo][0], DIAG[diag][0],
                       device="cpu")
    X = stt.trtri(T)
    assert X.kind is stt.MatrixKind.Triangular and X.uplo is T.uplo
    assert X.diag is T.diag and X.shape == (n, n)
    x = X.to_numpy()
    assert _rel(x, ref) < TOL[np.float64]
    assert _inverse_residual(logical, x) <= 30


def test_trtri_complex_and_batched_leaves():
    """complex128 through P1's complex plain version, and n = 128 (two
    leaves, one P1 launch) in float32."""
    stored, logical = _triangular(100, True, False, np.complex128, 7)
    ref = st.trtri(st.triangular(stored, NB, RUplo.Lower)).to_numpy()
    x = stt.trtri(stt.triangular(stored, NB, stt.Uplo.Lower,
                                 device="cpu")).to_numpy()
    assert _rel(x, ref) < TOL[np.complex128]
    stored, logical = _triangular(128, True, False, np.float32, 8)
    ref = st.trtri(st.triangular(stored, NB, RUplo.Lower)).to_numpy()
    x = stt.trtri(stt.triangular(stored, NB, stt.Uplo.Lower,
                                 device="cpu")).to_numpy()
    assert _rel(x, ref) < TOL[np.float32]
    assert _inverse_residual(logical, x) <= 30


def test_trtri_refuses_non_triangular():
    with pytest.raises(stt.SlateError, match="triangular"):
        stt.trtri(stt.from_dense(np.eye(8), 4, device="cpu"))
    band = stt.from_dense(np.eye(8), 4, kind=stt.MatrixKind.TriangularBand,
                          uplo=stt.Uplo.Lower, device="cpu")
    with pytest.raises(NotImplementedError, match="band"):
        stt.trtri(band)


@pytest.mark.parametrize("uplo", list(UPLO))
def test_trtrm_matches_reference(uplo):
    stored, _ = _triangular(100, uplo == "lower", False, np.float64, 11)
    ref = st.trtrm(st.triangular(stored, NB, UPLO[uplo][1]))
    out = stt.trtrm(stt.triangular(stored, NB, UPLO[uplo][0], device="cpu"))
    assert out.kind is stt.MatrixKind.Hermitian and out.uplo is UPLO[uplo][0]
    assert _rel(out.to_numpy(), ref.to_numpy()) < TOL[np.float64]


@functools.lru_cache(maxsize=None)
def _spd(n, dtype):
    rng = np.random.default_rng(300 + n)
    x = rng.standard_normal((n, n))
    return (x @ x.T / n + np.eye(n)).astype(dtype)


@functools.lru_cache(maxsize=None)
def _general(n, dtype):
    rng = np.random.default_rng(400 + n)
    return (rng.standard_normal((n, n)) / np.sqrt(n)
            + 2 * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("uplo", list(UPLO))
@pytest.mark.parametrize("n,dtype", [(100, np.float32), (100, np.float64),
                                     (200, np.float64)])
def test_potri_matches_reference(n, dtype, uplo):
    a = _spd(n, dtype)
    L_ref, _ = st.potrf(st.hermitian(a, NB, UPLO[uplo][1]))
    ref = st.potri(L_ref).to_numpy()
    L, info = stt.potrf(stt.hermitian(a, NB, UPLO[uplo][0], device="cpu"))
    X = stt.potri(L)
    assert int(info) == 0 and X.kind is stt.MatrixKind.Hermitian
    x = X.to_numpy()
    assert _rel(x, ref) < TOL[dtype]
    assert _inverse_residual(a, x) <= 30


@pytest.mark.parametrize("n,dtype", [(100, np.float32), (100, np.float64),
                                     (200, np.float64)])
def test_getri_matches_reference(n, dtype):
    a = _general(n, dtype)
    LU_ref, perm_ref, _ = st.getrf(st.from_dense(a, NB))
    ref = st.getri(LU_ref, perm_ref).to_numpy()
    LU, perm, info = stt.getrf(stt.from_dense(a, NB, device="cpu"))
    for fn in (stt.getri, stt.getri_oop):
        x = fn(LU, perm).to_numpy()
        assert x.shape == (n, n)
        assert _rel(x, ref) < TOL[dtype]
        assert _inverse_residual(a, x) <= 30


def test_api_inverse_verbs_match_reference():
    a, s = _general(100, np.float64), _spd(100, np.float64)
    LU_ref, perm_ref, _ = st.lu_factor(st.from_dense(a, NB))
    lu_ref = st.lu_inverse_using_factor(LU_ref, perm_ref).to_numpy()
    LU, perm, _ = stt.lu_factor(stt.from_dense(a, NB, device="cpu"))
    assert _rel(stt.lu_inverse_using_factor(LU, perm).to_numpy(),
                lu_ref) < TOL[np.float64]
    L_ref, _ = st.chol_factor(st.hermitian(s, NB, RUplo.Lower))
    chol_ref = st.chol_inverse_using_factor(L_ref).to_numpy()
    L, _ = stt.chol_factor(stt.hermitian(s, NB, stt.Uplo.Lower,
                                         device="cpu"))
    assert _rel(stt.chol_inverse_using_factor(L).to_numpy(),
                chol_ref) < TOL[np.float64]
    from slate_tpu.obs import flops as ref_flops
    from slate_tpu_torch.obs import flops
    for name in ("trtri", "potri", "getri"):
        assert getattr(flops, name)(1000) == getattr(ref_flops, name)(1000)
