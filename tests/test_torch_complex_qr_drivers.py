"""Complex64 and complex128 through the port's Householder drivers, against
slate_tpu on the same numpy inputs (CPU: every kernel runs its plain
version): geqrf with qr_multiply_explicit, unmqr on both sides, gelqf and
unmlq, gels by QR (m ≥ n), by LQ (m < n) and by CholQR, tsqr, the batched
geqrf/gels, the solve from the reference's own batched factors, and a
complex ``qr`` Session operator. The kernels' plain versions and plans are
in tests/test_torch_complex_qr_kernels.py.

Sizes are small and uneven ((150, 97) and (77, 77) at nb = 32; 97 × 150
wide) so that the reference's complex compiles stay cheap; its outputs are
cached per module.

Tolerances, relative to the reference's largest entry: 8·ε·√m·(n/nb + 1)
for the factors, Q and the products with Q (both packages run blocked
Householder QR, which is backward stable; they differ in summation order
and in K4's compact-WY reassociation, and each of the n/nb panels adds its
rounding), and κ(A) times that for least-squares solutions (Gaussian
operators, κ below 1e2). Solutions are also held to Aᴴ·(A·x − b) ≈ 0 in
complex128. Side Right of unmqr is held to C·Q with Q from the reference's
side-Left unmqr: the reference's own side Right applies its panels in the
wrong order for more than one panel (ROADMAP queue 3), and is equal to the
port's at one panel. The batched verbs pin the reference's degenerate-
column store in complex: a square item with a real last diagonal entry
left by upper-triangular structure is solved exactly by the port and off
in the reference (ROADMAP queue 3).
"""

import functools
import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import (MethodGels as RMethodGels,
                                  Options as ROptions, Side as RSide)
from slate_tpu.linalg import qr as ref_qr
from slate_tpu.ops import blocked as ref_blocked
import slate_tpu_torch as stt
from slate_tpu_torch.linalg import batched as port_batched
from slate_tpu_torch.ops import blocked

torch.set_num_threads(2)

NB = 32
CTYPES = [np.complex64, np.complex128]
SHAPES = [(150, 97), (77, 77)]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _cgauss(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _eps(dt):
    return np.finfo(np.empty(0, dt).real.dtype).eps


def _tol(dt, m, n):
    return 8 * _eps(dt) * math.sqrt(m) * (n / NB + 1)


def _rel(x, y):
    return np.abs(np.asarray(x) - np.asarray(y)).max() / np.abs(
        np.asarray(y)).max()


@functools.lru_cache(maxsize=None)
def _problem(m, n):
    """(A, B, C, D) in complex128 with complex64 values: A (m, n), B (m, 3),
    C (4, m) for side Right, D (m, 3) for the LQ's right-hand sides."""
    rng = _rng("cqr", m, n)
    return tuple(_cgauss(rng, s).astype(np.complex64).astype(np.complex128)
                 for s in ((m, n), (m, 3), (4, m), (n, 3)))


def _cpu(x, dt):
    return stt.from_dense(np.asarray(x).astype(dt), NB, device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(m, n):
    """The reference's complex128 results on _problem(m, n)."""
    a, b, c, _ = _problem(m, n)
    QR = ref_qr.geqrf(st.from_dense(a, NB))
    B = st.from_dense(b, NB)
    q_full = ref_qr.unmqr(RSide.Left, QR, st.from_dense(
        np.eye(m, dtype=np.complex128), NB)).to_numpy()
    return {"vr": np.asarray(QR.vr), "t": np.asarray(QR.t),
            "q": ref_qr.qr_multiply_explicit(QR).to_numpy(),
            "r": np.triu(QR.r_matrix.to_numpy()),
            "qb": ref_qr.unmqr(RSide.Left, QR, B).to_numpy(),
            "qhb": ref_qr.unmqr(RSide.Left, QR, B, trans=True).to_numpy(),
            "q_full": q_full,
            "x": ref_qr.gels(st.from_dense(a, NB), B).to_numpy(),
            "x_cholqr": ref_qr.gels(st.from_dense(a, NB), B, ROptions(
                method_gels=RMethodGels.CholQR)).to_numpy()}


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("m,n", SHAPES)
def test_geqrf_and_thin_q_match_reference(m, n, dt):
    """Packed V\\R, the T factors, the thin Q and R against the
    reference; Q·R = A and QᴴQ = I."""
    a = _problem(m, n)[0]
    ref = _reference(m, n)
    QR = stt.geqrf(_cpu(a, dt))
    tol = _tol(dt, m, n)
    assert QR.vr.dtype == torch.from_numpy(np.zeros(1, dt)).dtype
    assert _rel(QR.vr.numpy(), ref["vr"]) <= tol
    assert _rel(QR.t.numpy(), ref["t"]) <= tol
    q = stt.qr_multiply_explicit(QR).to_numpy()
    r = np.triu(QR.r_matrix.to_numpy())
    assert _rel(q, ref["q"]) <= tol and _rel(r, ref["r"]) <= tol
    assert _rel(q.astype(np.complex128) @ r, a) <= tol
    assert np.abs(q.conj().T @ q - np.eye(n)).max() <= tol
    np.testing.assert_array_equal(np.diag(r).imag, 0)


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("trans", [False, True])
def test_unmqr_left_matches_reference(m, n, trans, dt):
    """Q·B and Qᴴ·B (side Left) against the reference's."""
    a, b = _problem(m, n)[:2]
    ref = _reference(m, n)
    QR = stt.geqrf(_cpu(a, dt))
    got = stt.unmqr(stt.Side.Left, QR, _cpu(b, dt), trans=trans).to_numpy()
    assert _rel(got, ref["qhb" if trans else "qb"]) <= _tol(dt, m, n)


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("m,n", SHAPES)
def test_unmqr_right_is_c_times_q(m, n, dt):
    """C·Q and C·Qᴴ (side Right) against C @ Q with the full Q taken from
    the reference's side-Left unmqr of I (the port applies the panels in
    the right order; the reference's side Right does not, ROADMAP queue
    3), and (C·Qᴴ)·Q = C."""
    a, _, c, _ = _problem(m, n)
    q_full = _reference(m, n)["q_full"]
    QR = stt.geqrf(_cpu(a, dt))
    tol = _tol(dt, m, n)
    cq = stt.unmqr(stt.Side.Right, QR, _cpu(c, dt)).to_numpy()
    cqh = stt.unmqr(stt.Side.Right, QR, _cpu(c, dt), trans=True).to_numpy()
    assert _rel(cq, c @ q_full) <= tol
    assert _rel(cqh, c @ q_full.conj().T) <= tol
    back = stt.unmqr(stt.Side.Right, QR, _cpu(cqh, dt)).to_numpy()
    assert _rel(back, c) <= tol


def test_reference_unmqr_right_is_wrong_past_one_panel_in_complex():
    """Queue 3 in complex: the reference's side-Right unmqr is off by O(1)
    at (150, 97, nb 32) against C @ Q, and right at one panel (where the
    port equals it)."""
    a, _, c, _ = _problem(150, 97)
    QRr = ref_qr.geqrf(st.from_dense(a, NB))
    ref = ref_qr.unmqr(RSide.Right, QRr, st.from_dense(c, NB)).to_numpy()
    assert _rel(ref, c @ _reference(150, 97)["q_full"]) > 0.1
    a1, c1 = a[:90, :30], c[:, :90]
    QRr = ref_qr.geqrf(st.from_dense(a1, NB))
    QR = stt.geqrf(_cpu(a1, np.complex128))
    for trans in (False, True):
        want = ref_qr.unmqr(RSide.Right, QRr, st.from_dense(c1, NB),
                            trans=trans).to_numpy()
        got = stt.unmqr(stt.Side.Right, QR, _cpu(c1, np.complex128),
                        trans=trans).to_numpy()
        assert _rel(got, want) <= 1e-12


@functools.lru_cache(maxsize=None)
def _lq_reference():
    a, _, _, d = _problem(150, 97)
    aw = a.T.conj().copy()  # 97 × 150
    LQ = ref_qr.gelqf(st.from_dense(aw, NB))
    D = st.from_dense(np.vstack([d, np.zeros((53, 3))]), NB)
    return aw, {"vr": np.asarray(LQ.vr),
                "qd": ref_qr.unmlq(RSide.Left, LQ, D).to_numpy(),
                "qhd": ref_qr.unmlq(RSide.Left, LQ, D, trans=True).to_numpy(),
                "x": ref_qr.gels(st.from_dense(aw, NB),
                                 st.from_dense(d, NB)).to_numpy()}


@pytest.mark.parametrize("dt", CTYPES)
def test_gelqf_unmlq_match_reference(dt):
    """The LQ of a wide complex A (the QR of Aᴴ) and its Q applied both
    ways, against the reference."""
    aw, ref = _lq_reference()
    d = _problem(150, 97)[3]
    LQ = stt.gelqf(_cpu(aw, dt))
    tol = _tol(dt, 150, 97)
    assert _rel(LQ.vr.numpy(), ref["vr"]) <= tol
    D = _cpu(np.vstack([d, np.zeros((53, 3))]), dt)
    for trans, key in ((False, "qd"), (True, "qhd")):
        got = stt.unmlq(stt.Side.Left, LQ, D, trans=trans).to_numpy()
        assert _rel(got, ref[key]) <= tol


def _normal_residual(a, x, b):
    """‖Aᴴ(A·x − b)‖∞ / (‖A‖∞²·‖x‖∞) in complex128."""
    a = a.astype(np.complex128)
    r = a.conj().T @ (a @ x.astype(np.complex128) - b)
    return np.abs(r).max() / (np.abs(a).sum(1).max() ** 2
                              * np.abs(x).max())


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("method", ["qr", "lq", "cholqr"])
def test_gels_matches_reference(method, dt):
    """Least squares by QR (150 × 97), the minimum-norm solution by LQ
    (97 × 150) and CholQR (150 × 97) against the reference within
    100·_tol (κ(A) < 1e2); the QR and CholQR normal residuals within
    100·ε·√m, the LQ solution A·x = b within 100·ε·√n."""
    a, b = _problem(150, 97)[:2]
    opts = (stt.Options(method_gels=stt.MethodGels.CholQR)
            if method == "cholqr" else stt.Options())
    if method == "lq":
        aw, ref = _lq_reference()
        d = _problem(150, 97)[3]
        X = stt.gels(_cpu(aw, dt), _cpu(d, dt), opts).to_numpy()
        assert X.shape == (150, 3)
        assert _rel(X, ref["x"]) <= 100 * _tol(dt, 150, 97)
        assert _rel(aw @ X.astype(np.complex128), d) <= 100 * _eps(dt) \
            * math.sqrt(150)
        return
    ref = _reference(150, 97)["x_cholqr" if method == "cholqr" else "x"]
    X = stt.gels(_cpu(a, dt), _cpu(b, dt), opts).to_numpy()
    assert X.shape == (97, 3)
    assert _rel(X, ref) <= 100 * _tol(dt, 150, 97)
    assert _normal_residual(a, X, b) <= 100 * _eps(dt) * math.sqrt(150)


@pytest.mark.parametrize("dt", CTYPES)
def test_tsqr_matches_reference(dt):
    """tsqr's Q·R = A, QᴴQ = I and R against the reference's R (both
    make R's diagonal real and non-negative before the CholQR pass)."""
    a = _problem(150, 97)[0]
    Q, R = stt.tsqr(_cpu(a, dt))
    Qr, Rr = ref_qr.tsqr(st.from_dense(a, NB))
    q, r = Q.to_numpy(), np.triu(R.to_numpy())
    tol = 10 * _tol(dt, 150, 97)
    assert _rel(q.astype(np.complex128) @ r, a) <= tol
    assert np.abs(q.conj().T @ q - np.eye(97)).max() <= tol
    assert _rel(r, np.triu(Rr.to_numpy())) <= tol
    assert _rel(q, Qr.to_numpy()) <= tol


# ---------------------------------------------------------------------------
# the batched engine
# ---------------------------------------------------------------------------

BATCHED = [(70, 33, 16), (64, 32, None), (45, 20, 8)]


@functools.lru_cache(maxsize=None)
def _stack(m, n):
    rng = _rng("stack", m, n)
    a = _cgauss(rng, (4, m, n)).astype(np.complex64).astype(np.complex128)
    b = _cgauss(rng, (4, m, 2)).astype(np.complex64).astype(np.complex128)
    return a, b


def _ref_gels_batched(a, b, nb):
    """The reference's batched QR and solve (``ops/blocked.py``
    geqrf_batched, gels_qr_solve_batched), called outside its
    ``linalg/batched.py`` bucket programs: those are off by O(0.1) in
    complex128 at (4, 70, 33), nb = 16 on this host (ROADMAP queue 3),
    while the same ops agree with numpy's lstsq to 1e-15."""
    vr, taus, ts = ref_blocked.geqrf_batched(jnp.asarray(a), nb)
    x = ref_blocked.gels_qr_solve_batched(vr, taus, ts, jnp.asarray(b), nb)
    return tuple(np.asarray(t) for t in (vr, taus, ts, x))


@functools.lru_cache(maxsize=None)
def _batched_reference(m, n, nb):
    a, b = _stack(m, n)
    return _ref_gels_batched(a, b, nb or min(n, 32))


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("m,n,nb", BATCHED)
def test_geqrf_gels_batched_match_reference(m, n, nb, dt):
    """geqrf_batched (V\\R, taus, Ts) and gels_batched on tall complex
    items against the reference's batched QR and solve, and the solutions
    against numpy's lstsq."""
    a, b = _stack(m, n)
    r_vr, r_taus, r_ts, r_x = _batched_reference(m, n, nb)
    vr, taus, ts = stt.geqrf_batched(a.astype(dt), nb, device="cpu")
    tol = _tol(dt, m, n)
    assert vr.dtype == taus.dtype == ts.dtype
    assert _rel(vr.numpy(), r_vr) <= tol
    assert _rel(taus.numpy(), r_taus) <= tol
    assert _rel(ts.numpy(), r_ts) <= tol
    x, info = stt.gels_batched(a.astype(dt), b.astype(dt), nb, device="cpu")
    assert info.tolist() == [0] * 4
    assert _rel(x.numpy(), r_x) <= 100 * tol
    exact = np.stack([np.linalg.lstsq(a[i], b[i], rcond=None)[0]
                      for i in range(4)])
    assert _rel(x.numpy(), exact) <= 100 * tol
    for i in range(4):
        assert _normal_residual(a[i], x[i].numpy(), b[i]) \
            <= 100 * _eps(dt) * math.sqrt(m)


@pytest.mark.parametrize("dt", CTYPES)
def test_solve_from_the_reference_batched_factors(dt):
    """The port's batched QR solve (Qᴴ panel by panel: C − V·Tᴴ·Vᴴ·C)
    from the reference's own complex factors equals the reference's
    solve."""
    m, n, nb = 70, 33, 16
    a, b = _stack(m, n)
    r_vr, r_taus, r_ts, _ = _batched_reference(m, n, nb)
    want = r_x = _batched_reference(m, n, nb)[3]
    got = blocked.gels_qr_solve_batched(
        torch.from_numpy(r_vr.astype(dt)), torch.from_numpy(r_ts.astype(dt)),
        torch.from_numpy(b.astype(dt)), nb).numpy()
    assert _rel(got, want) <= 100 * _tol(dt, m, n)
    got2 = port_batched.gels_batched_using_factor(r_vr.astype(dt), r_taus, r_ts,
                                         b.astype(dt), device="cpu")
    assert _rel(got2.numpy(), want) <= 100 * _tol(dt, m, n)


@pytest.mark.parametrize("dt", CTYPES)
def test_square_items_pin_the_reference_degenerate_store(dt):
    """Queue 3 in complex: a square upper-triangular item whose last
    diagonal entry is real has a degenerate last column. The port keeps
    alpha there and solves A·x = b exactly; the reference stores −alpha
    and its answer is off by O(1) in the last unknown."""
    rng = _rng("square", np.dtype(dt).name)
    a = np.triu(_cgauss(rng, (2, 8, 8))) + 4 * np.eye(8)
    a[:, 7, 7] = 3.0
    b = _cgauss(rng, (2, 8, 1))
    exact = np.linalg.solve(a, b)
    x, _ = stt.gels_batched(a.astype(dt), b.astype(dt), device="cpu")
    assert _rel(x.numpy(), exact) <= 100 * _eps(dt)
    r_x = _ref_gels_batched(a, b, 8)[3]
    assert np.abs(r_x[:, 7] - exact[:, 7]).max() > 0.1


# ---------------------------------------------------------------------------
# the Session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", CTYPES)
def test_session_qr_operator_serves_least_squares(dt):
    """A complex ``qr`` operator registers (op "auto" infers it for a
    tall operand), factors once and serves 1- and 3-column requests, each
    within 100·_tol of the reference's gels and within the normal
    residual bound."""
    a, b = _problem(150, 97)[:2]
    ref = _reference(150, 97)["x"]
    sess = stt.Session(device="cpu")
    h = sess.register(_cpu(a, dt))
    assert sess._ops[h].op == "qr"
    assert sess.factor_info(h) == 0
    for rhs, want in ((b, ref), (b[:, :1], ref[:, :1])):
        x = sess.solve(h, rhs.astype(dt))
        assert x.dtype == np.dtype(dt) and x.shape == want.shape
        assert _rel(x, want) <= 100 * _tol(dt, 150, 97)
        assert _normal_residual(a, x, rhs) <= 100 * _eps(dt) * math.sqrt(150)
    m = sess.metrics.snapshot()["counters"]
    assert m.get("factorizations", m.get("factor_misses", 1)) >= 1
