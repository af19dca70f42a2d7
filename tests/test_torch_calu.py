"""Tournament pivoting in the port (CALU: getrf_tntpiv, MethodLU.CALU,
and threshold pivoting, pivot_threshold < 1) and its batched panel LU
(P3, hopper_ops.lu_panel_batched, whose plain version runs here) against
slate_tpu on the same numpy inputs.

The reference runs as its own tests run it on the CPU: its tournament
rounds are the jitted ``_panel_getrf_batched_impl`` (plain jnp, no
Pallas kernel). Sizes stay small (n ≤ 128, nb ∈ {16, 32}, uneven n) to
keep its compiles cheap, and its outputs are cached per module.

Tolerances: LU to 1e-4 (float32) / 1e-10 (float64) relative to its
largest finite entry (the port solves with trsm_rec over P1 leaves and
cuBLAS-style gemms, the reference with triangular_solve), P3's lu to
1e-5 / 1e-12 of its largest entry; perm and info exact (Gaussian data:
the two packages' winners agree on these seeds; the tournament-perm
tests use panels whose winners stand out by a factor of at least 40, so
no rounding can flip a choice). Residuals under the reference's own
bounds (tests/test_lu.py): ‖P·A − L·U‖max ≤ n·1e-13 in float64, scaled by
ε in float32 (PA_LU_C·n·ε), and the solve residual
‖b − A·x‖₁ / (‖A‖₁·‖x‖₁·n·ε) < 50.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import MethodLU as RMethodLU, Options as ROptions
from slate_tpu.linalg import lu as ref_lu
from slate_tpu.ops import blocked as ref_blocked
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.linalg import lu as port_lu
from slate_tpu_torch.ops import blocked, hopper_ops

torch.set_num_threads(2)

TOL = {np.float32: 1e-4, np.float64: 1e-10}
P3_TOL = {np.float32: 1e-5, np.float64: 1e-12}
PA_LU_C = 1e-13 / np.finfo(np.float64).eps  # tests/test_lu.py: n·1e-13
SOLVE_BOUND = 50.0                          # tests/test_lu.py: < 50
CALU = stt.Options(method_lu=stt.MethodLU.CALU)
THRESHOLD = stt.Options(pivot_threshold=0.5)
R_CALU = ROptions(method_lu=RMethodLU.CALU)
R_THRESHOLD = ROptions(pivot_threshold=0.5)


def _rel(x, y):
    ok = np.isfinite(y)
    return np.abs(x[ok] - y[ok]).max() / np.abs(y[ok]).max()


def _port(a, nb):
    return stt.from_dense(a, nb, device="cpu")


def _solve_residual(a, b, x):
    eps = np.finfo(a.dtype).eps
    a64 = a.astype(np.float64)
    return (np.linalg.norm(b - a64 @ x, 1)
            / (np.linalg.norm(a64, 1) * np.linalg.norm(x, 1) * a.shape[0]
               * eps))


def _pa_lu(a, lu, perm):
    """max |A[perm] − L·U| over A's logical rows and columns, from the
    factor's logical m × n part ``lu`` (the winners of A's columns are
    A's rows, so the first m entries of perm index A)."""
    m, n = a.shape
    k = min(m, n)
    lo = np.tril(lu, -1)[:, :k] + np.eye(m, k)
    return np.abs(a.astype(np.float64)[perm[:m]]
                  - lo.astype(np.float64) @ np.triu(lu)[:k]).max()


# ---------------------------------------------------------------------------
# P3: the batched panel LU
# ---------------------------------------------------------------------------

def _stack(shape, dtype, seed, fault=None):
    a = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    if fault == "zero_column":
        a[1, :, 3] = 0.0
    elif fault == "nan":
        a[0, [7, 11], 2] = np.nan
    elif fault == "tie":
        a[:, :, 0] = np.where(np.arange(shape[1]) % 2, -1.0, 1.0)
        a[-1, :, 1] = a[-1, :, 1].clip(-1, 1)  # rows 5 and 9 stay ahead
        a[-1, [5, 9], 1] = 7.0
    return a


def _p3_against_reference(a, same_nan=True):
    lu, perm, info = hopper_ops.lu_panel_batched(torch.from_numpy(a))
    lu_r, perm_r, info_r = (np.asarray(x) for x in
                            ref_blocked._panel_getrf_batched_impl(
                                jnp.asarray(a)))
    assert perm.dtype == info.dtype == torch.int32
    assert perm.shape == a.shape[:2] and info.shape == a.shape[:1]
    np.testing.assert_array_equal(perm.numpy(), perm_r)
    np.testing.assert_array_equal(info.numpy(), info_r)
    lu = lu.numpy()
    if same_nan:
        np.testing.assert_array_equal(np.isnan(lu), np.isnan(lu_r))
    both = np.isfinite(lu) & np.isfinite(lu_r)
    assert (np.abs(lu - lu_r)[both].max()
            <= P3_TOL[a.dtype.type] * np.abs(lu_r[both]).max())
    return lu, perm.numpy(), info.numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(4, 32, 32), (3, 64, 32), (2, 40, 24)])
def test_p3_plain_matches_reference_batched_panel(shape, dtype):
    a = _stack(shape, dtype, sum(shape))
    lu, perm, info = _p3_against_reference(a)
    assert not info.any()
    w = shape[2]
    for b in range(shape[0]):  # chunk[perm] = L·U
        low = np.tril(lu[b], -1)[:, :w] + np.eye(shape[1], w)
        np.testing.assert_allclose(a[b][perm[b]], low @ np.triu(lu[b])[:w],
                                   atol=20 * P3_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fault", ["zero_column", "nan", "tie"])
def test_p3_plain_failure_contracts_match_reference(fault, dtype):
    """A zero column (info 4 in that chunk, the column divides by 1), a
    NaN (it wins its column's pivot: info 3) and exact ties (the lowest
    row wins) give the reference's perm and info, and its lu where both
    are finite. The NaN spreads further in the reference, whose rank-1
    update also runs over the rows above the pivot (0·NaN); the port's
    touches only the trailing block, as K2's contract has it."""
    a = _stack((3, 48, 16), dtype, 7, fault)
    _, perm, info = _p3_against_reference(a, same_nan=fault != "nan")
    if fault == "zero_column":
        assert info.tolist() == [0, 4, 0]
    elif fault == "nan":
        assert info.tolist() == [3, 0, 0] and perm[0, 2] == 7
    else:
        assert (perm[:, 0] == 0).all() and perm[-1, 1] == 5


def test_p3_chunks_do_not_mix():
    """A NaN in one chunk and a zero column in another change nothing in
    the other chunks, and each chunk is bitwise ``lu_panel_base_plain``
    (K2's plain version) of that chunk alone."""
    a = _stack((4, 40, 24), np.float64, 3)
    bad = a.copy()
    bad[0, 13, 5] = np.nan
    bad[2, :, 9] = 0.0
    clean = hopper_ops.lu_panel_batched_plain(torch.from_numpy(a))
    got = hopper_ops.lu_panel_batched_plain(torch.from_numpy(bad))
    for b in (1, 3):
        assert all(torch.equal(x[b], y[b]) for x, y in zip(got, clean))
    assert got[2].tolist() == [6, 0, 10, 0]  # the NaN wins column 5
    for b in range(4):
        lu, perm, info = hopper_ops.lu_panel_base_plain(
            torch.from_numpy(bad[b]))
        nan = torch.isnan(lu)
        assert torch.equal(nan, torch.isnan(got[0][b]))
        assert torch.equal(got[0][b][~nan], lu[~nan])
        assert torch.equal(got[1][b], perm) and int(got[2][b]) == int(info)


def test_p3_dispatch_and_refusals():
    """A CPU stack runs the plain version and counts no launch; a stack on
    another device reaches the launcher, which raises; a complex stack runs
    its complex plain version; half precision, w > H and a 2-D input are
    refused; ``blocked.panel_getrf_batched`` hands P3 a
    contiguous stack."""
    hopper_ops.reset_launches()
    s = torch.from_numpy(_stack((2, 24, 8), np.float64, 1))
    out = hopper_ops.lu_panel_batched(s)
    ref = hopper_ops.lu_panel_batched_plain(s)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    t = s.mT.contiguous().mT  # a non-contiguous view of the same values
    assert not t.is_contiguous()
    assert all(torch.equal(x, y) for x, y in
               zip(blocked.panel_getrf_batched(t), ref))
    assert not any(hopper_ops.LAUNCHES.values())
    with pytest.raises(SlateError, match="unsupported device"):
        hopper_ops.lu_panel_batched(torch.empty((2, 24, 8), device="meta"))
    sc = s.to(torch.complex128)
    assert all(torch.equal(x, y) for x, y in
               zip(hopper_ops.lu_panel_batched(sc),
                   hopper_ops.lu_panel_batched_plain(sc)))
    with pytest.raises(NotImplementedError, match="complex128"):
        hopper_ops.lu_panel_batched(s.to(torch.float16))
    with pytest.raises(SlateError):
        hopper_ops.lu_panel_batched(s.mT)  # w > H
    with pytest.raises(SlateError):
        hopper_ops.lu_panel_batched(s[0])
    assert not any(hopper_ops.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the tournament
# ---------------------------------------------------------------------------

def _winner_panel(prows, w, seed):
    """Noise of size ≤ 0.1 with w distinct planted winners: row r_j holds
    4 in column j, so each round's pivot beats every other candidate by a
    factor of about 40 and both packages must pick the same rows."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.1, 0.1, (prows, w))
    rows = rng.choice(prows, w, replace=False)
    a[rows, np.arange(w)] = 4.0
    return a, rows


@pytest.mark.parametrize("prows,w,nb", [
    (128, 16, 16),   # 8 chunks: a power of two
    (80, 16, 16),    # 5 chunks, bucketed to 8 with sentinel chunks
    (100, 32, 32),   # 4 chunks, the last one padded with zero rows
    (100, 24, 32)])  # a panel narrower than nb (the recursion's base)
def test_tournament_perm_matches_reference(prows, w, nb):
    a, rows = _winner_panel(prows, w, prows + w)
    mpad = prows + 40
    want = np.asarray(ref_lu._tournament_perm(jnp.asarray(a), w, nb, prows,
                                              mpad))
    got = port_lu._tournament_perm(torch.from_numpy(a), w, nb, prows, mpad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:w], rows)
    np.testing.assert_array_equal(np.sort(got.numpy()), np.arange(prows))


@pytest.mark.parametrize("prows,nb,zero_cols", [(80, 16, (3,)),
                                                (100, 32, (0, 5, 31))])
def test_tournament_with_zero_columns_stays_a_permutation(prows, nb,
                                                          zero_cols):
    """A panel column that is entirely zero lets a sentinel win; each is
    replaced by a distinct unused row, so the perm is still a permutation,
    equal to the reference's, and only info names the singularity."""
    a, _ = _winner_panel(prows, nb, prows)
    a[:, list(zero_cols)] = 0.0
    want = np.asarray(ref_lu._tournament_perm(jnp.asarray(a), nb, nb, prows,
                                              prows + 64))
    got = port_lu._tournament_perm(torch.from_numpy(a), nb, nb, prows,
                                   prows + 64).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(prows))
    lu_r, p_r, i_r = ref_lu._tournament_panel(jnp.asarray(a), nb, nb, prows)
    lu, p, info = port_lu._tournament_panel(torch.from_numpy(a), nb, nb,
                                            prows)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_r))
    assert int(info) == int(i_r) == zero_cols[0] + 1
    np.testing.assert_array_equal(np.isfinite(lu.numpy()),
                                  np.isfinite(np.asarray(lu_r)))


# ---------------------------------------------------------------------------
# getrf_tntpiv and getrf with MethodLU.CALU
# ---------------------------------------------------------------------------

CALU_CASES = [(100, 100, 16, np.float64), (100, 100, 16, np.float32),
              (120, 72, 32, np.float64), (120, 72, 32, np.float32),
              (72, 120, 16, np.float64), (72, 120, 16, np.float32)]


@functools.lru_cache(maxsize=None)
def _problem(m, n, dtype):
    rng = np.random.default_rng(3000 + m + 7 * n)
    return (rng.standard_normal((m, n)).astype(dtype),
            rng.standard_normal((m, 3)).astype(dtype))


@functools.lru_cache(maxsize=None)
def _reference(m, n, nb, dtype, how):
    a, b = _problem(m, n, dtype)
    A = st.from_dense(a, nb)
    if how == "tntpiv":
        LU, perm, info = ref_lu.getrf_tntpiv(A)
    else:
        LU, perm, info = st.getrf(A, R_CALU if how == "calu"
                                  else R_THRESHOLD)
    return LU.to_numpy(), np.asarray(perm), int(info)


@pytest.mark.parametrize("m,n,nb,dtype", CALU_CASES)
def test_getrf_tntpiv_matches_reference(m, n, nb, dtype):
    a, b = _problem(m, n, dtype)
    lu_r, perm_r, info_r = _reference(m, n, nb, dtype, "tntpiv")
    LU, perm, info = stt.getrf_tntpiv(_port(a, nb))
    assert info.dtype == perm.dtype == torch.int32 and info.ndim == 0
    assert int(info) == info_r == 0
    np.testing.assert_array_equal(perm.numpy(), perm_r)
    lu = LU.to_numpy()
    assert LU.shape == (m, n) and _rel(lu, lu_r) < TOL[dtype]
    err = _pa_lu(a, lu, perm.numpy())
    assert err <= PA_LU_C * max(m, n) * np.finfo(dtype).eps
    if m == n:
        X = stt.getrs(LU, perm, _port(b, nb))
        assert _solve_residual(a, b, X.to_numpy()) < SOLVE_BOUND


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_calu_dispatch_getrf_gesv_and_api(dtype):
    """getrf with MethodLU.CALU is getrf_tntpiv (bitwise), and gesv,
    lu_factor/lu_solve_using_factor and lu_solve reach it."""
    m = n = 100
    nb = 16
    a, b = _problem(m, n, dtype)
    lu_r, perm_r, _ = _reference(m, n, nb, dtype, "calu")
    LU, perm, info = stt.getrf(_port(a, nb), CALU)
    LU2, perm2, _ = stt.getrf_tntpiv(_port(a, nb))
    torch.testing.assert_close(LU.data, LU2.data, rtol=0, atol=0)
    assert torch.equal(perm, perm2) and int(info) == 0
    np.testing.assert_array_equal(perm.numpy(), perm_r)
    assert _rel(LU.to_numpy(), lu_r) < TOL[dtype]
    X, info = stt.gesv(_port(a, nb), _port(b, nb), CALU)
    assert int(info) == 0
    assert _solve_residual(a, b, X.to_numpy()) < SOLVE_BOUND
    LU3, perm3, _ = stt.lu_factor(_port(a, nb), CALU)
    x3 = stt.lu_solve_using_factor(LU3, perm3, _port(b, nb)).to_numpy()
    np.testing.assert_array_equal(x3, X.to_numpy())
    x4 = stt.lu_solve(_port(a, nb), _port(b, nb), CALU).to_numpy()
    np.testing.assert_array_equal(x4, X.to_numpy())


@pytest.mark.parametrize("zero_col", [0, 20, 99])
def test_calu_singular_info_matches_reference(zero_col):
    """A zero column: info exact in both packages, the perm equal and a
    permutation, non-finite entries in the same places (the panel's rows
    below solve against the zero pivot in both)."""
    a, _ = _problem(100, 100, np.float64)
    a = a.copy()
    a[:, zero_col] = 0.0
    LU_r, perm_r, info_r = st.getrf(st.from_dense(a, 32), R_CALU)
    LU, perm, info = stt.getrf(_port(a, 32), CALU)
    assert int(info) == int(info_r) == zero_col + 1
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))
    np.testing.assert_array_equal(np.sort(perm.numpy()), np.arange(128))
    lu, lu_r = LU.to_numpy(), LU_r.to_numpy()
    np.testing.assert_array_equal(np.isfinite(lu), np.isfinite(lu_r))
    assert _rel(lu, lu_r) < TOL[np.float64]


@pytest.mark.parametrize("n,nb", [(128, 16), (100, 32)])
def test_calu_launch_counts(n, nb, monkeypatch):
    """One P3 call per tournament round (a round per halving of the
    chunk count, bucketed to a power of two, plus the final one) and one
    P2 call per 64-row leaf of each panel's nb × nb top — the counts
    chip_smoke.py holds the card's launches to at n = 16384 and 2048."""
    calls = {"p3": [], "p2": 0}
    p3, p2 = hopper_ops.lu_panel_batched, hopper_ops.lu_nopiv_base_inplace
    monkeypatch.setattr(hopper_ops, "lu_panel_batched",
                        lambda s: calls["p3"].append(s.shape) or p3(s))

    def count_p2(*args):
        calls["p2"] += 1
        return p2(*args)

    monkeypatch.setattr(hopper_ops, "lu_nopiv_base_inplace", count_p2)
    a, _ = _problem(n, n, np.float64)
    stt.getrf(_port(a, nb), CALU)
    npad = -(-n // nb) * nb
    rounds = 0
    for k0 in range(0, npad, nb):
        nck = 1
        while nck < -(-(npad - k0) // nb):
            nck *= 2
        rounds += nck.bit_length()
    assert len(calls["p3"]) == rounds
    assert calls["p3"][0] == (npad // nb, nb, nb)  # a power of two here
    assert calls["p2"] == npad // nb * -(-nb // 64)


# ---------------------------------------------------------------------------
# threshold pivoting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_threshold_pivoting_iterative_path(dtype):
    """pivot_threshold = 0.5 at n = 64, nb = 16: the iterative loop's
    panels are tournament panels, in getrf and gesv."""
    a, b = _problem(64, 64, dtype)
    lu_r, perm_r, info_r = _reference(64, 64, 16, dtype, "threshold")
    LU, perm, info = stt.getrf(_port(a, 16), THRESHOLD)
    assert int(info) == info_r == 0
    np.testing.assert_array_equal(perm.numpy(), perm_r)
    assert _rel(LU.to_numpy(), lu_r) < TOL[dtype]
    err = _pa_lu(a, LU.to_numpy(), perm.numpy())
    assert err <= PA_LU_C * 64 * np.finfo(dtype).eps
    X, _ = stt.gesv(_port(a, 16), _port(b, 16), THRESHOLD)
    assert _solve_residual(a, b, X.to_numpy()) < SOLVE_BOUND


def test_threshold_pivoting_recursion_tall_base(monkeypatch):
    """160 × 32, nb = 32: the recursion's tall single-panel base is a
    tournament panel (the reference's _getrf_rec; the port reaches its
    own with the iterative loop switched off, as the reference's
    factor_iter_large=False does)."""
    m, n, nb = 160, 32, 32
    a = np.random.default_rng(11).standard_normal((m, n))
    lu_r, p_r, i_r = ref_lu._getrf_rec(jnp.asarray(a), nb, None,
                                       threshold=0.5)
    lu, p, info = port_lu._getrf_rec(torch.from_numpy(a), nb, 0.5)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_r))
    assert int(info) == int(i_r) == 0
    assert _rel(lu.numpy(), np.asarray(lu_r)) < TOL[np.float64]
    LU_r, perm_r, _ = st.getrf(st.from_dense(a, nb), ROptions(
        pivot_threshold=0.5, factor_iter_large=False))
    monkeypatch.setattr(port_lu, "_ITER_MAX_NT", 0)
    seen = []
    panel = port_lu._tournament_panel
    monkeypatch.setattr(port_lu, "_tournament_panel",
                        lambda *x, **k: seen.append(x[0].shape) or
                        panel(*x, **k))
    LU, perm, info = stt.getrf(_port(a, nb), THRESHOLD)
    assert seen == [(m, n)]
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))
    assert _rel(LU.to_numpy(), LU_r.to_numpy()) < TOL[np.float64]
    err = _pa_lu(a, LU.to_numpy(), perm.numpy())
    assert err < m * 1e-13


def test_nopiv_ignores_pivot_threshold():
    """MethodLU.NoPiv with pivot_threshold = 0.5 is NoPiv, in both
    packages."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((72, 72)) / np.sqrt(72) + 2 * np.eye(72)
    nopiv = stt.Options(method_lu=stt.MethodLU.NoPiv)
    got = stt.getrf(_port(a, 16), nopiv.replace(pivot_threshold=0.5))
    base = stt.getrf(_port(a, 16), nopiv)
    assert torch.equal(got[0].data, base[0].data)
    assert torch.equal(got[1], base[1]) and torch.equal(got[2], base[2])
    r_nopiv = ROptions(method_lu=RMethodLU.NoPiv)
    ref_got = st.getrf(st.from_dense(a, 16), r_nopiv.replace(
        pivot_threshold=0.5))
    ref_base = st.getrf(st.from_dense(a, 16), r_nopiv)
    np.testing.assert_array_equal(ref_got[0].to_numpy(),
                                  ref_base[0].to_numpy())
    np.testing.assert_array_equal(np.asarray(ref_got[1]),
                                  np.asarray(ref_base[1]))
    assert _rel(got[0].to_numpy(), ref_got[0].to_numpy()) < TOL[np.float64]


def test_session_serves_a_calu_operator():
    a, _ = _problem(100, 100, np.float64)
    sess = stt.Session(device="cpu")
    h = sess.register(_port(a, 16), op="lu", opts=CALU)
    assert sess.factor_info(h) == 0
    LU, perm = sess._cache[h].payload
    _, perm_r, _ = _reference(100, 100, 16, np.float64, "calu")
    np.testing.assert_array_equal(perm.numpy(), perm_r)
    rng = np.random.default_rng(5)
    for k in (1, 4):
        b = rng.standard_normal((100, k))
        x = sess.solve(h, b)
        np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-9,
                                   atol=1e-11)
        assert _solve_residual(a, b, x) < SOLVE_BOUND
