"""geqrf/unmqr/gels/gelqf of the port against slate_tpu on the same inputs.

Operands are Gaussian (seeded numpy) rounded to float32 values, at
uneven (m, n, nb) ∈ {(150, 97, 32), (200, 130, 64), (300, 260, 256)}:
nb = 32 runs only K3 bases, nb = 64 the K4 base at w = 64, nb = 256 the
width recursion 256 → 128 with K4 bases. The reference runs its fori
bases and width recursion on the CPU (its Pallas gates are TPU-only), so
the port's K4 route is held to it to rounding. The reference runs once
per shape, in float64; the port runs the same values in float32 and in
float64 and both are held to it.

Tolerances, relative to the max entry of the reference's result: 1e-4
in float32 and 1e-10 in float64 (Householder QR is backward stable and
these Gaussian panels are well conditioned, so the port's rounding, its
summation order and its K4 reassociation move entries by a small
multiple of ε·√m).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import Side as RSide
from slate_tpu.linalg import qr as ref_qr
from slate_tpu.ops import blocked as ref_blocked
import slate_tpu_torch as stt
from slate_tpu_torch.linalg import qr as port_qr
from slate_tpu_torch.ops import blocked, hopper_ops

torch.set_num_threads(2)

TOL = {np.float32: 1e-4, np.float64: 1e-10}
SHAPES = [(150, 97, 32), (200, 130, 64), (300, 260, 256)]
CASES = [(m, n, nb, dt) for (m, n, nb) in SHAPES
         for dt in (np.float32, np.float64)]


@functools.lru_cache(maxsize=None)
def _problem(m, n, dtype=np.float64):
    """(A, B, C) with float32 values, stored as ``dtype``."""
    rng = np.random.default_rng(7000 + m + n)
    return tuple(rng.standard_normal(s).astype(np.float32).astype(dtype)
                 for s in ((m, n), (m, 3), (4, m)))


@functools.lru_cache(maxsize=None)
def _reference(m, n, nb):
    a, b, _ = _problem(m, n)
    QR = ref_qr.geqrf(st.from_dense(a, nb))
    B = st.from_dense(b, nb)
    return {"vr": np.asarray(QR.vr), "t": np.asarray(QR.t),
            "qb": ref_qr.unmqr(RSide.Left, QR, B).to_numpy(),
            "qtb": ref_qr.unmqr(RSide.Left, QR, B, trans=True).to_numpy(),
            "q": ref_qr.qr_multiply_explicit(QR).to_numpy(),
            "x": ref_qr.gels_using_factor(QR, B).to_numpy()}


def _rel(x, y):
    return np.abs(x - y).max() / np.abs(y).max()


def _cpu(x, nb):
    return stt.from_dense(x, nb, device="cpu")


@pytest.mark.parametrize("m,n,nb,dtype", CASES)
def test_geqrf_unmqr_gels_match_reference(m, n, nb, dtype):
    """Packed V\\R, the T factors, Q·B and Qᴴ·B (side Left), C·Q and
    C·Qᴴ (side Right, held to C @ Q with the reference's explicit Q) and
    the least-squares X all agree with the reference."""
    a, b, c = _problem(m, n, dtype)
    ref = _reference(m, n, nb)
    QR = stt.geqrf(_cpu(a, nb))
    assert (QR.m, QR.n, QR.nb) == (m, n, nb)
    assert tuple(QR.vr.shape) == ref["vr"].shape
    assert tuple(QR.t.shape) == ref["t"].shape
    tol = TOL[dtype]
    assert _rel(QR.vr.numpy(), ref["vr"]) < tol
    assert _rel(QR.t.numpy(), ref["t"]) < tol
    B = _cpu(b, nb)
    assert _rel(stt.unmqr(stt.Side.Left, QR, B).to_numpy(), ref["qb"]) < tol
    assert _rel(stt.unmqr(stt.Side.Left, QR, B, trans=True).to_numpy(),
                ref["qtb"]) < tol
    q = ref["q"]
    C = _cpu(c, nb)
    cq = stt.unmqr(stt.Side.Right, QR, C).to_numpy()
    cqh = stt.unmqr(stt.Side.Right, QR, C, trans=True).to_numpy()
    assert cq.shape == cqh.shape == (4, m)
    # C·Q restricted to Q's first n columns is C @ q (q = thin Q)
    c64 = c.astype(np.float64)
    assert _rel(cq[:, :n], c64 @ q) < tol
    # C·Qᴴ·Q = C
    back = stt.unmqr(stt.Side.Right, QR, _cpu(cqh, nb)).to_numpy()
    assert _rel(back, c64) < tol
    X = stt.gels(_cpu(a, nb), B)
    assert X.shape == (n, 3)
    assert _rel(X.to_numpy(), ref["x"]) < tol


def test_unmqr_right_single_panel_matches_reference():
    """With one panel the reference's side-Right unmqr is right too, and
    the port gives its values (for several panels the reference applies
    them in the wrong order; ROADMAP Queue 3)."""
    rng = np.random.default_rng(3)
    a, c = rng.standard_normal((90, 30)), rng.standard_normal((5, 90))
    QRr = ref_qr.geqrf(st.from_dense(a, 32))
    QR = stt.geqrf(_cpu(a, 32))
    for trans in (False, True):
        ref = ref_qr.unmqr(RSide.Right, QRr, st.from_dense(c, 32),
                           trans=trans).to_numpy()
        got = stt.unmqr(stt.Side.Right, QR, _cpu(c, 32),
                        trans=trans).to_numpy()
        assert _rel(got, ref) < 1e-12


@functools.lru_cache(maxsize=None)
def _underdetermined():
    rng = np.random.default_rng(11)
    a, b = (rng.standard_normal(s).astype(np.float32).astype(np.float64)
            for s in ((97, 150), (97, 2)))
    return a, b, ref_qr.gels(st.from_dense(a, 32),
                             st.from_dense(b, 32)).to_numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gels_underdetermined_matches_reference(dtype):
    """m < n: the minimum-norm solution through gelqf/unmlq."""
    a, b, ref = _underdetermined()
    a, b = a.astype(dtype), b.astype(dtype)
    X = stt.least_squares_solve(_cpu(a, 32), _cpu(b, 32))
    assert X.shape == (150, 2)
    assert _rel(X.to_numpy(), ref) < TOL[dtype]
    np.testing.assert_allclose(a.astype(np.float64) @ X.to_numpy(), b,
                               atol=1e-3 if dtype == np.float32 else 1e-10)


def test_factor_verbs_and_thin_q():
    """qr_factor + least_squares_solve_using_factor equal gels; the thin
    Q has orthonormal columns and Q·R = A."""
    a, b, _ = _problem(150, 97)
    QR = stt.qr_factor(_cpu(a, 32))
    X = stt.least_squares_solve_using_factor(QR, _cpu(b, 32))
    np.testing.assert_array_equal(
        X.to_numpy(), stt.gels(_cpu(a, 32), _cpu(b, 32)).to_numpy())
    q = stt.qr_multiply_explicit(QR).to_numpy()
    assert q.shape == (150, 97)
    np.testing.assert_allclose(q.T @ q, np.eye(97), atol=1e-13)
    r = QR.r_matrix
    assert r.shape == (97, 97) and r.uplo is stt.Uplo.Upper
    np.testing.assert_allclose(q @ r.to_numpy(), a, atol=1e-12)


def test_lookahead_option_is_accepted_and_ignored():
    a, _, _ = _problem(200, 130)
    base = stt.geqrf(_cpu(a, 32))
    other = stt.geqrf(_cpu(a, 32), stt.Options(lookahead=0))
    np.testing.assert_array_equal(other.vr.numpy(), base.vr.numpy())


def _qr_product(QR):
    Q, R = QR
    return Q.to_numpy() @ R.to_numpy()


@pytest.mark.parametrize("call", [
    lambda A, B: (_qr_product(stt.cholqr(A)), np.eye(8, 4)),
    lambda A, B: (_qr_product(stt.tsqr(A)), np.eye(8, 4)),
    lambda A, B: (stt.gels(A, B, stt.Options(
        method_gels=stt.MethodGels.CholQR)).to_numpy(), np.ones((4, 1)))])
def test_cholqr_paths_raise_not_ported(call):
    """The CholQR paths, which raised NotImplementedError until syrk/herk
    were ported, now run: on A = I (8 × 4) Q·R = A and the CholQR least
    squares X of B = 1 is 1. (The name dates from when these paths
    raised.)"""
    A = _cpu(np.eye(8, 4), 4)
    B = _cpu(np.ones((8, 1)), 4)
    got, expected = call(A, B)
    np.testing.assert_allclose(got, expected, atol=1e-14)


@functools.lru_cache(maxsize=None)
def _cholqr_reference(m, n, nb):
    a, b, _ = _problem(m, n)
    A = st.from_dense(a, nb)
    Q, R = ref_qr.cholqr(A)
    Qt, Rt = ref_qr.tsqr(A)
    X = ref_qr.gels(A, st.from_dense(b, nb),
                    st.Options(method_gels=st.MethodGels.CholQR))
    return {"q": Q.to_numpy(), "r": R.to_numpy(), "qt": Qt.to_numpy(),
            "rt": Rt.to_numpy(), "x": X.to_numpy()}


# CholQR squares the condition number (κ(A) ≈ 9 at 150 × 97, so
# κ(AᵀA) ≈ 85): float32 is held to 1e-3 here, float64 to 1e-10
CHOLQR_TOL = {np.float32: 1e-3, np.float64: 1e-10}


@pytest.mark.parametrize("m,n,nb,dtype", [(150, 97, 32, np.float32),
                                          (150, 97, 32, np.float64),
                                          (200, 130, 64, np.float64)])
def test_cholqr_tsqr_gels_cholqr_match_reference(m, n, nb, dtype):
    """cholqr's Q and R, tsqr's Q and R (signs fixed: R's diagonal ≥ 0)
    and gels with MethodGels.CholQR against the reference."""
    a, b, _ = _problem(m, n, dtype)
    ref = _cholqr_reference(m, n, nb)
    tol = CHOLQR_TOL[dtype]
    Q, R = stt.cholqr(_cpu(a, nb))
    assert Q.shape == (m, n) and R.shape == (n, n)
    assert R.kind is stt.MatrixKind.Triangular and R.uplo is stt.Uplo.Upper
    assert _rel(Q.to_numpy(), ref["q"]) < tol
    assert _rel(R.to_numpy(), ref["r"]) < tol
    Qt, Rt = stt.tsqr(_cpu(a, nb))
    assert _rel(Qt.to_numpy(), ref["qt"]) < tol
    assert _rel(Rt.to_numpy(), ref["rt"]) < tol
    q = Qt.to_numpy().astype(np.float64)
    np.testing.assert_allclose(q.T @ q, np.eye(n), atol=10 * tol)
    X = stt.gels(_cpu(a, nb), _cpu(b, nb),
                 stt.Options(method_gels=stt.MethodGels.CholQR))
    assert X.shape == (n, 3)
    assert _rel(X.to_numpy(), ref["x"]) < tol


def test_cholqr_gram_above_64_block_columns_runs_k5(monkeypatch):
    """A Gram matrix of 68 block columns (n = 270 at nb = 4) takes
    potrf's recursion, whose trailing update is K5; Q·R = A and QᵀQ = I
    to float64 rounding."""
    rng = np.random.default_rng(270)
    a = rng.standard_normal((300, 270))
    seen = []
    k5 = hopper_ops.herk_lower_update
    monkeypatch.setattr(hopper_ops, "herk_lower_update",
                        lambda c, x: seen.append(tuple(c.shape)) or k5(c, x))
    Q, R = stt.cholqr(_cpu(a, 4))
    assert seen == [(136, 136)]  # 272 → 136 + 136
    q, r = Q.to_numpy(), R.to_numpy()
    np.testing.assert_allclose(q @ r, a, atol=1e-10)
    np.testing.assert_allclose(q.T @ q, np.eye(270), atol=1e-8)


def test_geqrf_complex_reaches_the_kernel_wrapper_and_raises():
    """A complex geqrf reaches the K3 wrapper, which runs its plain version
    on the CPU (the kernels have complex instances); a type without an
    instance still raises there."""
    A = _cpu(np.eye(8, 4).astype(np.complex128), 4)
    QR = port_qr.geqrf(A)
    np.testing.assert_allclose(np.abs(np.diag(QR.r_matrix.to_numpy())),
                               np.ones(4), rtol=1e-15)
    with pytest.raises(NotImplementedError, match="complex128"):
        port_qr.geqrf(_cpu(np.eye(8, 4).astype(np.float16), 4))


@pytest.mark.parametrize("w,bases", [
    (4, [("K3", 4)]), (32, [("K3", 32)]),
    (100, [("K4", 64), ("K3", 32), ("K3", 4)]), (128, [("K4", 128)]),
    (512, [("K4", 128)] * 4)])
def test_panel_geqrf_sends_every_base_to_a_kernel(w, bases, monkeypatch):
    """Every base of the width recursion is one kernel call — K3
    (qr_panel_base) at w ≤ 32 and on ragged tails, K4
    (qr_panel_base_wide) at 32 < w ≤ 128 with w % 32 == 0 — and the panel
    agrees with the reference's panel_geqrf (fori bases on the CPU)."""
    seen = []
    k3, k4 = hopper_ops.qr_panel_base, hopper_ops.qr_panel_base_wide
    monkeypatch.setattr(hopper_ops, "qr_panel_base",
                        lambda p: seen.append(("K3", p.shape[1])) or k3(p))
    monkeypatch.setattr(hopper_ops, "qr_panel_base_wide",
                        lambda p: seen.append(("K4", p.shape[1])) or k4(p))
    h = w + 64
    a = np.random.default_rng(60 + w).standard_normal((h, w))
    vr, taus = (x.numpy() for x in blocked.panel_geqrf(torch.from_numpy(a)))
    assert seen == bases
    # Q·R = A with Q = H₀·…·H_{w−1} built from the packed reflectors
    v = np.tril(vr, -1)
    v[np.arange(w), np.arange(w)] = 1.0
    qr = np.vstack([np.triu(vr)[:w], np.zeros((h - w, w))])
    for j in range(w - 1, -1, -1):
        qr -= taus[j] * np.outer(v[:, j], v[:, j] @ qr)
    assert np.abs(qr - a).max() < 1e-12
    if w <= 32:  # the reference's eager recursion compiles per base
        vr_r, taus_r = ref_blocked.panel_geqrf(jnp.asarray(a))
        assert _rel(vr, np.asarray(vr_r)) < 1e-10
        assert _rel(taus, np.asarray(taus_r)) < 1e-10


@pytest.mark.parametrize("w", [4, 64, 100])
def test_panel_off_the_cpu_never_runs_a_plain_base(w, monkeypatch):
    """A panel on a device other than the CPU reaches the kernel
    wrappers, which launch or raise; the plain bases never run."""
    def plain(_):
        raise AssertionError("plain base ran")
    monkeypatch.setattr(hopper_ops, "qr_panel_base_plain", plain)
    monkeypatch.setattr(hopper_ops, "qr_panel_base_wide_plain", plain)
    with pytest.raises(stt.SlateError, match="unsupported device"):
        blocked.panel_geqrf(torch.empty((256, w), device="meta"))


@pytest.mark.parametrize("w", [16, 64, 96])
def test_larft_matches_reference(w):
    """T from the column recurrence (w ≤ 32) and from the closed form
    T = D·(I + S·D)⁻¹ (w > 32) against the reference's larft, with a
    degenerate column (tau = 0 gives a zero column of T)."""
    rng = np.random.default_rng(w)
    v = np.tril(rng.standard_normal((w + 40, w)), -1)
    v[np.arange(w), np.arange(w)] = 1.0
    taus = rng.uniform(1.0, 2.0, w)
    taus[w // 3] = 0.0
    t = blocked.larft(torch.from_numpy(v), torch.from_numpy(taus)).numpy()
    t_r = np.asarray(ref_blocked.larft(jnp.asarray(v), jnp.asarray(taus)))
    assert _rel(t, t_r) < 1e-12
    assert not t[:, w // 3].any()
