"""potrf/potrs/posv of the port against slate_tpu on the same inputs.

Sizes n ∈ {96, 200} with nb = 32 (200 is uneven: the padding path),
float32 and float64 (the conftest enables x64). Inputs come from numpy
with fixed seeds and have condition numbers ≤ 1e3.

Tolerances: factor and X agree to 1e-4 (float32) / 1e-10 (float64)
relative to their max entry (reason: summation order differs between
the packages); scaled residual ‖b − A·x‖∞ / (n·ε·‖A‖∞·‖x‖∞) ≤ 30 (the
reference tester's bound); info exact.

The 2×2 recursion (more than ITER_MAX_NT = 64 block columns) is held to
the reference with ITER_MAX_NT lowered by monkeypatch: the reference's
potrf at a natural nt > 64 (n = 530, nb = 8) takes about a minute on the
CPU. At that natural size the port alone is held to float64 numpy's
Cholesky (1e-12 relative).
"""

import functools

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import Uplo as RUplo
import slate_tpu_torch as stt
from slate_tpu_torch.linalg import cholesky as port_chol
from slate_tpu_torch.ops import hopper_ops

torch.set_num_threads(2)

NB = 32
TOL = {np.float32: 1e-4, np.float64: 1e-10}
CASES = [(96, np.float32), (200, np.float32), (96, np.float64),
         (200, np.float64)]


@functools.lru_cache(maxsize=None)
def _problem(n, dtype):
    rng = np.random.default_rng(1000 + n)
    x = rng.standard_normal((n, n))
    a = (x @ x.T / n + 0.5 * np.eye(n)).astype(dtype)  # cond ≈ 20
    b = rng.standard_normal((n, 3)).astype(dtype)
    return a, b


@functools.lru_cache(maxsize=None)
def _reference(n, dtype, uplo="lower"):
    a, b = _problem(n, dtype)
    ru = RUplo.Lower if uplo == "lower" else RUplo.Upper
    L, info = st.potrf(st.hermitian(a, NB, ru))
    X = st.potrs(L, st.from_dense(b, NB))
    return L.to_numpy(), int(info), X.to_numpy()


def _port(a, opts=stt.Options(), uplo=stt.Uplo.Lower):
    return stt.potrf(stt.hermitian(a, NB, uplo, device="cpu"), opts)


def _rel(x, y):
    return np.abs(x - y).max() / np.abs(y).max()


def _scaled_residual(a, x, b):
    n = a.shape[0]
    eps = np.finfo(a.dtype).eps
    r = np.abs(b - a.astype(np.float64) @ x).max()
    return r / (n * eps * np.abs(a).sum(axis=1).max() * np.abs(x).max())


@pytest.mark.parametrize("n,dtype", CASES)
def test_potrf_posv_match_reference(n, dtype):
    a, b = _problem(n, dtype)
    l_ref, info_ref, x_ref = _reference(n, dtype)
    L, info = _port(a)
    assert int(info) == info_ref == 0
    assert L.kind is stt.MatrixKind.Triangular and L.shape == (n, n)
    assert _rel(L.to_numpy(), l_ref) < TOL[dtype]
    X, info = stt.posv(stt.hermitian(a, NB, stt.Uplo.Lower, device="cpu"),
                       stt.from_dense(b, NB, device="cpu"))
    x = X.to_numpy()
    assert _rel(x, x_ref) < TOL[dtype]
    assert _scaled_residual(a, x, b) <= 30


def test_potrf_upper_storage_matches_reference():
    n, dtype = 200, np.float64
    a, b = _problem(n, dtype)
    u_ref, info_ref, x_ref = _reference(n, dtype, "upper")
    junk = np.tril(np.full_like(a, 1e6), -1)   # never read under Upper
    U, info = _port(np.triu(a) + junk, uplo=stt.Uplo.Upper)
    assert int(info) == info_ref == 0 and U.uplo is stt.Uplo.Upper
    assert _rel(U.to_numpy(), u_ref) < TOL[dtype]
    X = stt.potrs(U, stt.from_dense(b, NB, device="cpu"))
    assert _rel(X.to_numpy(), x_ref) < TOL[dtype]


def test_potrf_reads_lower_triangle_only():
    a, _ = _problem(200, np.float32)
    junk = np.triu(np.full_like(a, np.nan), 1)
    L1, _ = _port(a)
    L2, info = _port(np.tril(a) + np.nan_to_num(junk, nan=7e5))
    assert int(info) == 0
    np.testing.assert_array_equal(L1.to_numpy(), L2.to_numpy())


def test_potrf_non_spd_info_matches_reference():
    n, dtype = 96, np.float64
    a, _ = _problem(n, dtype)
    a = a.copy()
    a[50, 50] = -10.0
    _, info_ref = st.potrf(st.hermitian(a, NB, RUplo.Lower))
    _, info = _port(a)
    assert int(info) == int(info_ref) == 51


def test_reference_only_options_are_accepted_and_ignored():
    """The knobs that pick the reference's other arms are accepted, and
    the port runs its one path under them."""
    a, _ = _problem(200, np.float64)
    base, _ = _port(a)
    L, info = _port(a, stt.Options(lookahead=0, factor_iter_large=False,
                                   update_precision="bfloat16_3x"))
    assert int(info) == 0
    np.testing.assert_array_equal(L.to_numpy(), base.to_numpy())


def test_potrf_recursion_path(monkeypatch):
    """The 2×2 recursion (herk_lower_rec, right-side trsm), which runs
    where the iterative loop does not apply (more than ITER_MAX_NT block
    columns), agrees with the reference; forced at n = 200 by lowering
    ITER_MAX_NT."""
    n, dtype = 200, np.float64
    a, _ = _problem(n, dtype)
    l_ref, _, _ = _reference(n, dtype)
    monkeypatch.setattr(port_chol, "_ITER_MAX_NT", 2)
    calls = []
    rec = port_chol._potrf_rec
    monkeypatch.setattr(port_chol, "_potrf_rec",
                        lambda a, nb: calls.append(a.shape[0]) or rec(a, nb))
    L, info = _port(a)
    assert calls[:3] == [224, 128, 64]
    assert int(info) == 0
    assert _rel(L.to_numpy(), l_ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_potrf_recursion_runs_k5_once_per_split(dtype, monkeypatch):
    """Every split of the recursion hands its trailing update to K5
    (``hopper_ops.herk_lower_update``) once, as the view a[h:, h:] of the
    working copy with A = a[h:, :h], and the factor still agrees with the
    reference (ITER_MAX_NT lowered to 2 at n = 200, nb = 32: three
    splits, 224 → 128 + 96, 128 → 64 + 64, 96 → 64 + 32)."""
    a, _ = _problem(200, dtype)
    l_ref, _, _ = _reference(200, dtype)
    monkeypatch.setattr(port_chol, "_ITER_MAX_NT", 2)
    seen = []
    k5 = hopper_ops.herk_lower_update

    def spy(c, x):
        seen.append((tuple(c.shape), x.shape[1], c.stride(0), x.stride(0)))
        out = k5(c, x)
        assert out is c
        return out
    monkeypatch.setattr(hopper_ops, "herk_lower_update", spy)
    L, info = _port(a)
    assert int(info) == 0
    # depth first: the 128 block's split, the top split, the 96 block's
    assert [s[:2] for s in seen] == [((64, 64), 64), ((96, 96), 128),
                                     ((32, 32), 64)]
    assert all(s[2] == s[3] == 224 for s in seen)  # views of the one copy
    assert _rel(L.to_numpy(), l_ref) < TOL[dtype]


def test_potrf_natural_recursion_above_64_block_columns(monkeypatch):
    """n = 530 at nb = 8 has 67 block columns, so the recursion owns the
    factor with no monkeypatch: one split (536 → 272 + 264), one K5
    call, two iterative leaves; L·Lᵀ = A to float64 rounding."""
    n = 530
    rng = np.random.default_rng(530)
    x = rng.standard_normal((n, n))
    a = x @ x.T / n + 0.5 * np.eye(n)
    seen = []
    k5 = hopper_ops.herk_lower_update
    monkeypatch.setattr(hopper_ops, "herk_lower_update",
                        lambda c, x: seen.append(tuple(c.shape)) or k5(c, x))
    L, info = stt.potrf(stt.hermitian(a, 8, stt.Uplo.Lower, device="cpu"))
    assert int(info) == 0 and seen == [(264, 264)]
    ref = np.linalg.cholesky(a)
    assert _rel(L.to_numpy(), ref) < 1e-12


def test_single_tile_potrf_matches_reference():
    n, dtype = 20, np.float64
    a, b = _problem(n, dtype)
    l_ref, _, x_ref = _reference(n, dtype)
    X, info = stt.posv(stt.hermitian(a, NB, stt.Uplo.Lower, device="cpu"),
                       stt.from_dense(b, NB, device="cpu"))
    assert int(info) == 0 and _rel(X.to_numpy(), x_ref) < TOL[dtype]


def test_potrf_rejects_general_operand():
    A = stt.from_dense(np.eye(4), 4, device="cpu")
    with pytest.raises(stt.SlateError):
        stt.potrf(A)
