"""The no-pivot LU family of the port (getrf_nopiv, gesv_nopiv, the
random butterfly transform gerbt and gesv_rbt, the getrf/gesv dispatch
for MethodLU.NoPiv and RBT, and a Session operator with NoPiv) against
slate_tpu and numpy on the same inputs.

Operands are diagonally dominant, M = G/√n + 2·I (G Gaussian; matgen is
not ported), so no-pivot LU is stable; sizes n ∈ {96, 200} with nb = 32
(200 is uneven) and rectangular (150 × 90, 90 × 150). An exact zero pivot
comes from integer factors. The RBT case at n = 128 converges; at the
uneven n = 100 both packages' transforms are cut to the logical shape
and their refinement falls back to partial pivoting.

Tolerances: LU and X to 1e-4 (float32) / 1e-10 (float64) relative to
their largest entry (the reference solves its blocks with
lax.linalg.triangular_solve, the port with trsm_rec over P1 leaves);
scaled residual ≤ 30; info exact. The port's butterfly diagonals are not
jax.random's (different generators), so gerbt is compared by feeding
the reference's own diagonals to the port's ``_rbt_rows``.
"""

import functools

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import MethodLU as RMethodLU, Options as ROptions
import slate_tpu_torch as stt
from slate_tpu_torch.linalg import lu as port_lu

torch.set_num_threads(2)

NB = 32
TOL = {np.float32: 1e-4, np.float64: 1e-10}
NOPIV = stt.Options(method_lu=stt.MethodLU.NoPiv)
RBT = stt.Options(method_lu=stt.MethodLU.RBT)


def _rel(x, y):
    return np.abs(x - y).max() / np.abs(y).max()


def _scaled_residual(a, x, b):
    n = a.shape[0]
    eps = np.finfo(a.dtype).eps
    r = np.abs(b - a.astype(np.float64) @ x).max()
    return r / (n * eps * np.abs(a).sum(axis=1).max() * np.abs(x).max())


@functools.lru_cache(maxsize=None)
def _dominant(m, n, dtype):
    rng = np.random.default_rng(500 + m + n)
    a = rng.standard_normal((m, n)) / np.sqrt(max(m, n))
    k = min(m, n)
    a[np.arange(k), np.arange(k)] += 2.0
    return a.astype(dtype), rng.standard_normal((m, 2)).astype(dtype)


def _port(a):
    return stt.from_dense(a, NB, device="cpu")


@pytest.mark.parametrize("n,dtype", [(96, np.float32), (200, np.float32),
                                     (96, np.float64), (200, np.float64)])
def test_getrf_nopiv_gesv_nopiv_match_reference(n, dtype):
    a, b = _dominant(n, n, dtype)
    LU_ref, info_ref = st.getrf_nopiv(st.from_dense(a, NB))
    X_ref, _ = st.gesv_nopiv(st.from_dense(a, NB), st.from_dense(b, NB))
    LU, info = stt.getrf_nopiv(_port(a))
    assert info.dtype == torch.int32 and int(info) == int(info_ref) == 0
    assert LU.shape == (n, n)
    assert _rel(LU.to_numpy(), LU_ref.to_numpy()) < TOL[dtype]
    X, info = stt.gesv_nopiv(_port(a), _port(b))
    x = X.to_numpy()
    assert int(info) == 0 and _rel(x, X_ref.to_numpy()) < TOL[dtype]
    assert _scaled_residual(a, x, b) <= 30


@pytest.mark.parametrize("m,n", [(150, 90), (90, 150)])
def test_getrf_nopiv_rectangular(m, n):
    """The trailing rectangular leaf: P2 on its top square, trsm_rec on
    the rest; L·U reproduces A."""
    a, _ = _dominant(m, n, np.float64)
    LU_ref, info_ref = st.getrf_nopiv(st.from_dense(a, NB))
    LU, info = stt.getrf_nopiv(_port(a))
    lu = LU.to_numpy()
    assert int(info) == int(info_ref) == 0
    assert _rel(lu, LU_ref.to_numpy()) < TOL[np.float64]
    k = min(m, n)
    low = np.tril(lu, -1)[:, :k] + np.eye(m, k)
    assert np.abs(low @ np.triu(lu)[:k] - a).max() < 1e-12


def test_getrf_nopiv_zero_pivot_info():
    """An exact zero pivot at step 70 of n = 100 (in the second 64-row
    leaf of the padded 128) gives info = 71 in both packages."""
    n, z = 100, 70
    rng = np.random.default_rng(12)
    lo = np.tril(rng.integers(-1, 2, (n, n)), -1) + np.eye(n)
    up = np.triu(rng.integers(-1, 2, (n, n)), 1) + np.eye(n)
    up[z, z] = 0
    lo[z + 1:, z] = 0
    a = lo @ up
    _, info_ref = st.getrf_nopiv(st.from_dense(a, NB))
    LU, info = stt.getrf_nopiv(_port(a))
    assert int(info) == int(info_ref) == z + 1
    lu = LU.to_numpy()
    np.testing.assert_array_equal(np.triu(lu), up)
    np.testing.assert_array_equal(np.tril(lu, -1) + np.eye(n), lo)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_getrf_nopiv_tall_zero_pivot_in_the_last_leaf(dtype):
    """150 × 90 (padded to 160 × 96: the last leaf is 112 × 48, tall) with
    an exact zero pivot at step 70 from integer factors: the rows below
    the leaf's square solve with the bad pivot taken as 1, as the
    reference's unblocked loop divides by 1 there, so the factors stay
    finite and match the reference's; info is 71 in both."""
    m, n, z = 150, 90, 70
    rng = np.random.default_rng(1570)
    lo = np.tril(rng.integers(-1, 2, (m, n)), -1) + np.eye(m, n)
    up = np.triu(rng.integers(-1, 2, (n, n)), 1) + np.eye(n)
    up[z, z] = 0
    lo[z + 1:, z] = 0
    a = (lo @ up).astype(dtype)
    LU_ref, info_ref = st.getrf_nopiv(st.from_dense(a, NB))
    LU, info = stt.getrf_nopiv(_port(a))
    assert int(info) == int(info_ref) == z + 1
    lu, lu_ref = LU.to_numpy(), LU_ref.to_numpy()
    assert np.isfinite(lu_ref).all() and np.isfinite(lu).all()
    assert _rel(lu, lu_ref) < TOL[dtype]
    np.testing.assert_array_equal(np.triu(lu)[:n], up)


@pytest.mark.parametrize("zeros", [(10,), (70,), (190,), (70, 190)])
def test_getrf_nopiv_info_across_leaves(zeros):
    """n = 200 (padded to 224: leaves at 0, 56, 112, 168): an exact zero
    pivot in the first, a middle or the last leaf, or in two leaves, gives
    the reference's info, the first bad step of the whole factor, though
    every leaf after a bad one sees NaN pivots too."""
    n = 200
    rng = np.random.default_rng(sum(zeros))
    lo = np.tril(rng.integers(-1, 2, (n, n)), -1) + np.eye(n)
    up = np.triu(rng.integers(-1, 2, (n, n)), 1) + np.eye(n)
    for z in zeros:
        up[z, z] = 0
        lo[z + 1:, z] = 0
    a = lo @ up
    _, info_ref = st.getrf_nopiv(st.from_dense(a, NB))
    _, info = stt.getrf_nopiv(_port(a))
    assert info.dtype == torch.int32 and info.ndim == 0
    assert int(info) == int(info_ref) == zeros[0] + 1


def test_gerbt_matches_reference_with_its_diagonals():
    n = 128
    a, _ = _dominant(n, n, np.float64)
    At_ref, (u, du), (v, dv) = st.gerbt(st.from_dense(a, NB))
    u, v = torch.from_numpy(np.array(u)), torch.from_numpy(np.array(v))
    at = port_lu._rbt_rows(torch.from_numpy(a), u, du, transpose=True)
    at = port_lu._rbt_rows(at.mT, v, dv, transpose=True).mT
    np.testing.assert_allclose(at.numpy(), At_ref.to_numpy(), rtol=1e-13,
                               atol=1e-13)
    At, (pu, pdu), (pv, pdv) = stt.gerbt(_port(a))
    assert (pdu, pdv) == (du, dv) == (2, 2)
    assert pu.shape == tuple(u.shape) == (4, n) and pv.shape == (4, n)
    lo, hi = np.exp(-0.1) / np.sqrt(2), np.exp(0.1) / np.sqrt(2)
    assert float(pu.min()) >= lo and float(pu.max()) <= hi
    # the port's own transform with its own diagonals, checked in float64
    want = port_lu._rbt_rows(torch.from_numpy(a), pu, 2, transpose=True)
    want = port_lu._rbt_rows(want.mT, pv, 2, transpose=True).mT
    np.testing.assert_allclose(At.to_numpy(), want.numpy(), rtol=0, atol=0)
    # W and Wᵀ are each other's transposes: Wᵀ·(W·x) = W·(Wᵀ·x) for
    # butterflies made of diagonal blocks
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((n, 3)))
    w = port_lu._rbt_rows(x, pu, 2, transpose=False)
    wt = port_lu._rbt_rows(torch.eye(n, dtype=torch.float64), pu, 2,
                           transpose=True)
    np.testing.assert_allclose((wt.mT @ x).numpy(), w.numpy(), atol=1e-14)


@pytest.mark.parametrize("n", [128, 100])
def test_gesv_rbt_matches_reference_and_numpy(n):
    a = _general(n)
    b = np.random.default_rng(n).standard_normal((n, 2))
    X_ref, _ = st.gesv_rbt(st.from_dense(a, NB), st.from_dense(b, NB))
    X, info = stt.gesv_rbt(_port(a), _port(b))
    x = X.to_numpy()
    want = np.linalg.solve(a, b)
    assert int(info) == 0
    assert _rel(x, want) < 1e-10 and _rel(x, X_ref.to_numpy()) < 1e-10
    assert _scaled_residual(a, x, b) <= 30
    # n = 128 converges after the butterfly; the uneven n = 100 (its
    # transform cut to the logical shape) falls back to partial pivoting
    assert port_lu.RBT_LAST["fallback"] is (n == 100)
    assert port_lu.RBT_LAST["refinements"] <= (
        stt.Options().max_iterations + 1)


@functools.lru_cache(maxsize=None)
def _general(n):
    rng = np.random.default_rng(600 + n)
    return rng.standard_normal((n, n)) / np.sqrt(n) + 2 * np.eye(n)


def test_gesv_rbt_options_are_read():
    """max_iterations = 0 and no fallback: one solve, no refinement step
    taken past it, no partial-pivot rescue; depth 1 is one butterfly
    level."""
    a, b = _general(100), np.ones((100, 1))
    opts = stt.Options(max_iterations=0, use_fallback_solver=False)
    X, _ = stt.gesv_rbt(_port(a), _port(b), opts)
    assert port_lu.RBT_LAST == {"refinements": 1, "fallback": False}
    assert X.shape == (100, 1)
    _, (u, depth), _ = stt.gerbt(_port(a), stt.Options(depth=1))
    assert depth == 1 and u.shape == (2, 128)


def test_getrf_gesv_dispatch_nopiv_and_rbt():
    a, b = _dominant(96, 96, np.float64)
    LU, perm, info = stt.getrf(_port(a), NOPIV)
    LU2, _ = stt.getrf_nopiv(_port(a))
    LU_ref, perm_ref, _ = st.getrf(st.from_dense(a, NB),
                                   ROptions(method_lu=RMethodLU.NoPiv))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_ref))
    np.testing.assert_array_equal(perm.numpy(), np.arange(96))
    assert perm.dtype == torch.int32 and int(info) == 0
    torch.testing.assert_close(LU.data, LU2.data, rtol=0, atol=0)
    X, _ = stt.gesv(_port(a), _port(b), NOPIV)
    np.testing.assert_allclose(X.to_numpy(), np.linalg.solve(a, b),
                               rtol=1e-10, atol=1e-12)
    g = _general(128)
    X, _ = stt.gesv(_port(g), _port(b[:96].repeat(2, 0)[:128]), RBT)
    assert port_lu.RBT_LAST["fallback"] is False
    np.testing.assert_allclose(
        X.to_numpy(), np.linalg.solve(g, b[:96].repeat(2, 0)[:128]),
        rtol=1e-9, atol=1e-12)
    x = stt.lu_solve(_port(g), _port(np.ones((128, 1))), RBT).to_numpy()
    np.testing.assert_allclose(x, np.linalg.solve(g, np.ones((128, 1))),
                               rtol=1e-9, atol=1e-12)


def test_session_serves_a_nopiv_operator():
    a, _ = _dominant(200, 200, np.float64)
    sess = stt.Session(device="cpu")
    h = sess.register(_port(a), op="lu", opts=NOPIV)
    assert sess.factor_info(h) == 0
    LU, perm = sess._cache[h].payload
    np.testing.assert_array_equal(perm.numpy(), np.arange(224))
    rng = np.random.default_rng(3)
    for k in (1, 4):
        b = rng.standard_normal((200, k))
        x = sess.solve(h, b)
        np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-10,
                                   atol=1e-12)
        assert _scaled_residual(a, x, b) <= 30


def test_nopiv_complex_names_the_roadmap():
    """getrf_nopiv takes complex (P2 has complex instances), and so does
    geqrf since the Householder kernels have theirs: the QR of (2 − i)·I
    is Q = −((2 − i)/√5)·I, R = −√5·I (real diagonal, beta = −|alpha|)."""
    a = np.eye(8, dtype=np.complex128) * (2 - 1j)
    LU, info = stt.getrf_nopiv(stt.from_dense(a, 4, device="cpu"))
    assert int(info) == 0
    np.testing.assert_array_equal(LU.to_numpy(), a)
    QR = stt.geqrf(stt.from_dense(a, 4, device="cpu"))
    np.testing.assert_allclose(np.diag(QR.r_matrix.to_numpy()),
                               -np.sqrt(5.0) * np.ones(8), rtol=1e-15)
    np.testing.assert_allclose(stt.qr_multiply_explicit(QR).to_numpy(),
                               -(2 - 1j) / np.sqrt(5.0) * np.eye(8),
                               rtol=1e-14, atol=1e-15)
