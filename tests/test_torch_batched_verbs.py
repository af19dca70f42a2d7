"""The port's batched verbs (gesv/posv/gels_batched, the solves from
batched factors, vector right-hand sides) against slate_tpu on the CPU,
per-item failure isolation, batch independence, devices and refusals.

The reference's batched drivers are plain jnp, one compiled program per
shape; its outputs are cached per module. Inputs are numpy from a seed.

Tolerances: every served item's scaled residual
‖b − A·x‖∞ / (n·ε·‖A‖∞·‖x‖∞) ≤ 30 in float64 (the tester's bound, with
ε of the working type), and X within X_TOL (1e-3 in float32, 1e-9 in
float64) of the reference's X relative to its largest entry: both
packages' errors are about κ·ε and these Gaussian operators have κ
below 1e4. info exact.

Batch independence: every kernel computes each item alone, so a lane of
a batched call equals the same item's B = 1 call bit for bit wherever
the batched gemms are batch-independent. CPU torch's are for the shapes
pinned here (k = 2 right-hand sides, n ∈ {7, 32, 70}); its batched
products with a single output column or row (k = 1, or n = 33 at nb 32,
whose last panel is one column wide) reduce in an order that depends on
the batch size, so those shapes are not pinned here (the card's cuBLAS
is held by ``chip_smoke.py``).
"""

import functools
import zlib

import numpy as np
import pytest
import torch

from slate_tpu.linalg import batched as ref_batched
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.linalg import batched

torch.set_num_threads(2)

X_TOL = {np.float32: 1e-3, np.float64: 1e-9}
RESIDUAL_BOUND = 30.0
CASES = [(7, 3, None, np.float32), (33, 3, 16, np.float64),
         (70, 5, None, np.float64), (32, 1, None, np.float32)]


def _ids(case):
    n, bsz, nb, dt = case
    return f"n{n}-B{bsz}-nb{nb or 'default'}-{dt.__name__}"


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _operands(kind, n, bsz, dt, k=2):
    rng = _rng(kind, n, bsz, k)
    m = 2 * n if kind == "gels" else n
    a = rng.standard_normal((bsz, m, n))
    if kind == "posv":
        a = a @ a.transpose(0, 2, 1) / n + np.eye(n)
    return a.astype(dt), rng.standard_normal((bsz, m, k)).astype(dt)


VERBS = {"gesv": (stt.gesv_batched, ref_batched.gesv_batched),
         "posv": (stt.posv_batched, ref_batched.posv_batched),
         "gels": (stt.gels_batched, ref_batched.gels_batched)}


@functools.lru_cache(maxsize=None)
def _reference(kind, case):
    n, bsz, nb, dt = case
    x, info = VERBS[kind][1](*_operands(kind, n, bsz, dt), nb)
    return np.array(x), np.array(info)


def _rel(x, y):
    return np.abs(x - y).max() / np.abs(y).max()


def _scaled_residuals(a, x, b):
    a64, x64 = a.astype(np.float64), x.astype(np.float64)
    eps = np.finfo(a.dtype).eps
    r = np.abs(b - np.einsum("bij,bjk->bik", a64, x64)).max(axis=1)
    an = np.abs(a64).sum(axis=2).max(axis=1)
    return r / (a.shape[1] * eps * an[:, None]
                * np.abs(x64).max(axis=1))


@pytest.mark.parametrize("kind", ["gesv", "posv", "gels"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_verbs_match_reference(kind, case):
    n, bsz, nb, dt = case
    a, b = _operands(kind, n, bsz, dt)
    x, info = VERBS[kind][0](a, b, nb, device="cpu")
    r_x, r_info = _reference(kind, case)
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert tuple(x.shape) == r_x.shape == (bsz, n, 2)
    assert np.array_equal(info.numpy(), r_info)
    assert _rel(x.numpy(), r_x) <= X_TOL[dt]
    if kind != "gels":
        assert _scaled_residuals(a, x.numpy(), b).max() <= RESIDUAL_BOUND


def test_solves_from_the_reference_factors():
    """The reference's LU (gather perm), L and QR factors (V\\R, T stack)
    served by the port's batched solves give the reference's X."""
    n, bsz, dt = 33, 3, np.float64
    for kind, factor, solve in (
            ("gesv", ref_batched.getrf_batched,
             lambda f, b: batched.getrs_batched(f[0], f[1], b,
                                                device="cpu")),
            ("posv", ref_batched.potrf_batched,
             lambda f, b: batched.potrs_batched(f[0], b, device="cpu")),
            ("gels", ref_batched.geqrf_batched,
             lambda f, b: batched.gels_batched_using_factor(
                 *f, b, device="cpu"))):
        a, b = _operands(kind, n, bsz, dt)
        fac = tuple(np.array(t) for t in factor(a, 16))
        if kind == "gels":  # the reference stores −alpha on a degenerate
            assert not (fac[1] == 0).any()  # column; none here
        x = solve(fac, b).numpy()
        r_x, _ = VERBS[kind][1](a, b, 16)
        assert _rel(x, np.array(r_x)) <= X_TOL[dt]


def test_vector_rhs_matches_matrix_rhs_column():
    n = 32
    for kind in ("gesv", "posv", "gels"):
        a, b = _operands(kind, n, 4, np.float64, k=1)
        xm, _ = VERBS[kind][0](a, b, device="cpu")
        xv, _ = VERBS[kind][0](a, b[:, :, 0], device="cpu")
        assert tuple(xv.shape) == (4, n)
        assert torch.equal(xm[:, :, 0], xv)


def test_square_least_squares_is_a_solve():
    """gels_batched of square items equals the solve (the reference's
    degenerate last column breaks its square gels, ROADMAP queue 3)."""
    a, b = _operands("gesv", 8, 2, np.float64)
    x, info = stt.gels_batched(a, b, device="cpu")
    assert not info.any()
    assert np.abs(x.numpy() - np.linalg.solve(a, b)).max() <= 1e-10


# ---------------------------------------------------------------------------
# per-item failure isolation and batch independence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,fault,want", [
    ("gesv", "zero_item", 1), ("gesv", "zero_column", 11),
    ("posv", "negated", 1), ("posv", "indefinite_minor", 21)])
def test_bad_item_flags_itself_only(kind, fault, want):
    n, dt = 32, np.float64
    a, b = _operands(kind, n, 5, dt)
    x0, info0 = VERBS[kind][0](a, b, device="cpu")
    bad = a.copy()
    if fault == "zero_item":
        bad[2] = 0
    elif fault == "zero_column":
        bad[2, :, 10] = 0
    elif fault == "negated":
        bad[2] = -bad[2]
    else:  # the leading minor of order 21 is not positive
        bad[2, 20, 20] = -1.0
    x, info = VERBS[kind][0](bad, b, device="cpu")
    r_x, r_info = VERBS[kind][1](bad, b)
    assert np.array_equal(info.numpy(), np.array(r_info))
    assert info.tolist() == [0, 0, want, 0, 0] and not info0.any()
    keep = [0, 1, 3, 4]
    assert torch.equal(x[keep], x0[keep])


@pytest.mark.parametrize("n", [7, 32, 70])
def test_lanes_equal_single_item_calls(n):
    for kind in ("gesv", "posv", "gels"):
        a, b = _operands(kind, n, 4, np.float32)
        x, _ = VERBS[kind][0](a, b, device="cpu")
        for i in range(4):
            xi, _ = VERBS[kind][0](a[i:i + 1], b[i:i + 1], device="cpu")
            assert torch.equal(x[i], xi[0]), (kind, i)


# ---------------------------------------------------------------------------
# devices and refusals
# ---------------------------------------------------------------------------

def test_numpy_stacks_go_to_the_card_unless_cpu_is_asked(monkeypatch):
    a, b = _operands("gesv", 4, 2, np.float64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: stt.gesv_batched(a, b),
                 lambda: stt.posv_batched(a, b),
                 lambda: stt.gels_batched(a, b),
                 lambda: stt.geqrf_batched(a)):
        with pytest.raises(SlateError, match="no CUDA device"):
            call()
    # a tensor stays on its device, and the right-hand sides follow it
    x, _ = stt.gesv_batched(torch.from_numpy(a), b)
    assert x.device.type == "cpu"


def test_verbs_validate_shapes_and_types():
    with pytest.raises(SlateError):
        stt.gesv_batched(np.zeros((4, 4)), np.zeros((4, 1)), device="cpu")
    with pytest.raises(SlateError):
        stt.gels_batched(np.zeros((2, 3, 8)), np.zeros((2, 3, 1)),
                         device="cpu")
    with pytest.raises(SlateError, match="square"):
        stt.gesv_batched(np.zeros((2, 4, 3)), np.zeros((2, 4, 1)),
                         device="cpu")
    with pytest.raises(SlateError, match="rhs"):
        stt.posv_batched(np.zeros((2, 4, 4)), np.zeros((3, 4, 1)),
                         device="cpu")
    with pytest.raises(SlateError, match="m >= n"):
        stt.geqrf_batched(np.zeros((2, 3, 4)), device="cpu")
    x, info = stt.gesv_batched(np.eye(4, dtype=np.complex128)[None] * 2j,
                               np.ones((1, 4, 1)), device="cpu")
    assert x.dtype == torch.complex128 and info.tolist() == [0]
    np.testing.assert_allclose(x.numpy(), -0.5j * np.ones((1, 4, 1)))
    # complex least squares: (2i)·I·x = 1 → x = −i/2
    x, info = stt.gels_batched(np.eye(4, dtype=np.complex128)[None] * 2j,
                               np.ones((1, 4, 1)), device="cpu")
    assert x.dtype == torch.complex128 and info.tolist() == [0]
    np.testing.assert_allclose(x.numpy(), -0.5j * np.ones((1, 4, 1)),
                               atol=1e-15)
    vr, taus, ts = stt.geqrf_batched(np.eye(4, dtype=np.complex64)[None] * 2j,
                                     device="cpu")
    assert vr.dtype == taus.dtype == ts.dtype == torch.complex64
    with pytest.raises(SlateError, match="floating-point"):
        stt.geqrf_batched(np.zeros((2, 4, 4), np.int64), device="cpu")
