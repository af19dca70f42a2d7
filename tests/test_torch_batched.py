"""The port's batched small-problem engine against slate_tpu on the CPU:
the batched factors (getrf/potrf/geqrf_batched), the plain versions of
its two new kernels (P4 chol_tile_batched, P5 qr_panel_batched) and
their plan, the kernel launches per factor and solve, and the small
Session ops served against the reference's batched verbs.

The reference runs as its own tests run it on the CPU: its batched
drivers are plain jnp (no Pallas kernel), one compiled program per
shape; its outputs are cached per module. Inputs are numpy from a seed.

Tolerances: the factors to TOL (1e-4 in float32, 1e-10 in float64)
relative to the reference's largest finite entry (the port's gemms and
trsm bases associate differently); perm and info exact (Gaussian data:
the two packages pick the same pivots on these seeds). P4's plain
version against the reference's ``_chol_unrolled_b`` and P5's against
``_panel_geqrf_batched`` to KERNEL_TOL (1e-5 / 1e-12) of the largest
entry: the same column steps, summed in another order (P5's H-long
sums). Solutions served by the Session to X_TOL (1e-4 / 1e-10) relative
to the reference's largest entry of X (κ of these operators is below
1e3).
"""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import batched as ref_batched
from slate_tpu.ops import blocked as ref_blocked
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.linalg import batched
from slate_tpu_torch.ops import blocked, hopper_ops

torch.set_num_threads(2)

TOL = {np.float32: 1e-4, np.float64: 1e-10}
KERNEL_TOL = {np.float32: 1e-5, np.float64: 1e-12}
X_TOL = {np.float32: 1e-4, np.float64: 1e-10}
# (n, B, nb) for the factors: one panel (n ≤ 32), a ragged tail panel
# (33 at nb 16, 70 at the default 32), n = 1
CASES = [(1, 1, None, np.float64), (7, 3, None, np.float32),
         (32, 5, None, np.float64), (33, 3, 16, np.float32),
         (70, 3, None, np.float64), (70, 1, 16, np.float32)]


def _ids(case):
    n, bsz, nb, dt = case
    return f"n{n}-B{bsz}-nb{nb or 'default'}-{dt.__name__}"


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _general(n, bsz, dt, m=None):
    return _rng("g", n, bsz, m).standard_normal(
        (bsz, m or n, n)).astype(dt)


def _spd(n, bsz, dt):
    x = _rng("s", n, bsz).standard_normal((bsz, n, n))
    return (x @ x.transpose(0, 2, 1) / n + np.eye(n)).astype(dt)


def _rel(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    ok = np.isfinite(y)
    scale = np.abs(y[ok]).max() if ok.any() else 1.0
    return np.abs(x[ok] - y[ok]).max() / max(scale, 1e-300)


def _np(*ts):
    return tuple(t.numpy() if isinstance(t, torch.Tensor) else np.array(t)
                 for t in ts)


@functools.lru_cache(maxsize=None)
def _ref_getrf(case):
    n, bsz, nb, dt = case
    return _np(*ref_batched.getrf_batched(_general(n, bsz, dt), nb))


@functools.lru_cache(maxsize=None)
def _ref_potrf(case):
    n, bsz, nb, dt = case
    return _np(*ref_batched.potrf_batched(_spd(n, bsz, dt), nb))


@functools.lru_cache(maxsize=None)
def _ref_geqrf(case):
    n, bsz, nb, dt = case
    return _np(*ref_batched.geqrf_batched(_general(n, bsz, dt, 2 * n), nb))


# ---------------------------------------------------------------------------
# the batched factors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_getrf_batched_matches_reference(case):
    n, bsz, nb, dt = case
    lu, perm, info = batched.getrf_batched(_general(n, bsz, dt), nb,
                                           device="cpu")
    r_lu, r_perm, r_info = _ref_getrf(case)
    assert lu.numpy().dtype == r_lu.dtype
    assert np.array_equal(perm.numpy(), r_perm)
    assert np.array_equal(info.numpy(), r_info)
    assert _rel(lu.numpy(), r_lu) <= TOL[dt]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_potrf_batched_matches_reference(case):
    n, bsz, nb, dt = case
    l, info = batched.potrf_batched(_spd(n, bsz, dt), nb, device="cpu")
    r_l, r_info = _ref_potrf(case)
    assert np.array_equal(info.numpy(), r_info)
    assert np.count_nonzero(np.triu(l.numpy(), 1)) == 0
    assert _rel(l.numpy(), r_l) <= TOL[dt]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_geqrf_batched_matches_reference(case):
    n, bsz, nb, dt = case
    vr, taus, ts = batched.geqrf_batched(_general(n, bsz, dt, 2 * n), nb,
                                         device="cpu")
    r_vr, r_taus, r_ts = _ref_geqrf(case)
    assert tuple(ts.shape) == r_ts.shape  # T zero-padded to nb
    for got, want in ((vr, r_vr), (taus, r_taus), (ts, r_ts)):
        assert _rel(got.numpy(), want) <= TOL[dt]


# panels wider than P5's 128 columns: (n, nb, type), one panel of 150 columns
# and a 136-wide panel with a 4-wide tail
WIDE = [(150, 256, np.float64), (140, 136, np.float32)]


@pytest.mark.parametrize("n,nb,dt", WIDE,
                         ids=[f"n{n}-nb{nb}-{dt.__name__}"
                              for n, nb, dt in WIDE])
def test_geqrf_and_gels_batched_with_panels_wider_than_p5(n, nb, dt,
                                                          monkeypatch):
    """A panel wider than 128 is factored in 128-wide P5 launches; the
    factors and the least-squares solution stay the reference's."""
    a = _general(n, 2, dt, 2 * n)
    b = _rng("wide", n).standard_normal((2, 2 * n, 2)).astype(dt)
    launches = []
    p5 = hopper_ops.qr_panel_batched
    monkeypatch.setattr(hopper_ops, "qr_panel_batched",
                        lambda st: launches.append(st.shape[-1]) or p5(st))
    vr, taus, ts = batched.geqrf_batched(a, nb, device="cpu")
    assert launches == [128, min(nb, n) - 128] + [n - nb] * (n > nb)
    r_vr, r_taus, r_ts = _np(*ref_batched.geqrf_batched(a, nb))
    assert tuple(ts.shape) == r_ts.shape
    for got, want in ((vr, r_vr), (taus, r_taus), (ts, r_ts)):
        assert _rel(got.numpy(), want) <= TOL[dt]
    x, info = stt.gels_batched(a, b, nb, device="cpu")
    r_x, r_info = _np(*ref_batched.gels_batched(a, b, nb))
    assert not info.any() and not r_info.any()
    assert _rel(x.numpy(), r_x) <= X_TOL[dt]


# ---------------------------------------------------------------------------
# P4 and P5: plain versions against the reference's column loops
# ---------------------------------------------------------------------------

def _chol_items(s, dt):
    """Four SPD items: clean, a zero column at 3, a NaN at (5, 2), and a
    non-positive pivot at s − 1."""
    d = _spd(s, 4, np.float64)
    d[1, :, min(3, s - 1)] = 0
    d[1, min(3, s - 1), :] = 0
    d[2, min(5, s - 1), min(2, s - 1)] = np.nan
    d[3, s - 1, s - 1] = -1.0
    return d.astype(dt)


@pytest.mark.parametrize("s", [1, 7, 32, 33, 64])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_chol_tile_batched_plain_matches_reference(s, dt):
    d = _chol_items(s, dt)
    l, info = hopper_ops.chol_tile_batched_plain(torch.from_numpy(d))
    r_l, r_info = ref_blocked._chol_unrolled_b(jnp.asarray(d), s)
    r_l, r_info = np.asarray(r_l), np.asarray(r_info)
    assert np.array_equal(info.numpy(), r_info)
    if s > 5:
        assert list(r_info) == [0, 4, 6, s]
    l = l.numpy()
    assert np.array_equal(np.isnan(l), np.isnan(r_l))
    assert _rel(l, r_l) <= KERNEL_TOL[dt]
    # only the lower triangle is read
    junk = d + np.triu(np.full_like(d, 1e6), 1)
    l2, _ = hopper_ops.chol_tile_batched_plain(torch.from_numpy(junk))
    assert np.array_equal(l2.numpy(), l, equal_nan=True)


def _qr_items(hh, w, dt):
    """Four panels: Gaussian, a zero column at 2, a NaN at (hh − 1, 3),
    and two degenerate columns (zero below the diagonal: columns 0 and 1,
    alpha = 3 in column 1)."""
    a = _rng("q", hh, w).standard_normal((4, hh, w))
    a[1, :, 2] = 0
    a[2, hh - 1, 3] = np.nan
    a[3, 1:, 0] = 0
    a[3, 2:, 1] = 0
    a[3, 1, 1] = 3.0
    return a.astype(dt)


@pytest.mark.parametrize("hh,w", [(64, 32), (40, 24), (9, 9)])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_qr_panel_batched_plain_matches_reference(hh, w, dt):
    """Equal to the reference within KERNEL_TOL, except where it is
    wrong: on a degenerate column with alpha ≠ 0 the reference stores
    −alpha as R's diagonal entry beside tau = 0 (ROADMAP queue 3), and a
    square panel's last column is always degenerate; the port keeps
    alpha, as larfg does, so that Q·R = A."""
    a = _qr_items(hh, w, dt)
    vr, taus = _np(*hopper_ops.qr_panel_batched_plain(torch.from_numpy(a)))
    r_vr, r_taus = _np(*ref_blocked._panel_geqrf_batched(jnp.asarray(a)))
    assert taus[1, 2] == r_taus[1, 2] == 0            # zero column
    degenerate = [(3, 0), (3, 1)] + [(i, w - 1) for i in (0, 1, 3)
                                     if hh == w]
    for i, j in degenerate:
        assert taus[i, j] == r_taus[i, j] == 0
        assert vr[i, j, j] * r_vr[i, j, j] < 0
        r_vr[i, j, j] = -r_vr[i, j, j]
    assert vr[3, 0, 0] == a[3, 0, 0] and vr[3, 1, 1] == 3.0
    for i in (0, 1, 3):
        assert _rel(vr[i], r_vr[i]) <= KERNEL_TOL[dt]
        assert _rel(taus[i], r_taus[i]) <= KERNEL_TOL[dt]
    # the NaN stays in its item in both packages; the port's taus are NaN
    # from its column on (but on a square panel's last column, which has
    # no tail: tau = 0) and its columns before stay finite (the
    # reference's rank-1 update of the whole item makes all of it NaN)
    assert np.isnan(taus[2, 3:min(w, hh - 1)]).all()
    assert np.isnan(r_vr[2]).any()
    assert np.isfinite(taus[2, :3]).all() and np.isfinite(vr[2, :, :3]).all()
    assert np.isfinite(np.delete(vr, 2, axis=0)).all()
    assert np.isfinite(np.delete(r_vr, 2, axis=0)).all()


def test_qr_panel_batched_plain_reconstructs():
    """Q·R = A in float64 for a panel with a degenerate column (the case
    the reference gets wrong)."""
    a = _qr_items(40, 24, np.float64)[3]
    vr, taus = _np(*hopper_ops.qr_panel_batched_plain(
        torch.from_numpy(a[None])))
    vr, taus = vr[0], taus[0]
    hh, w = a.shape
    qr = np.zeros((hh, w))
    qr[:w] = np.triu(vr[:w])
    for j in range(w - 1, -1, -1):
        v = np.concatenate([np.zeros(j), [1.0], vr[j + 1:, j]])
        qr -= taus[j] * np.outer(v, v @ qr)
    assert np.abs(qr - a).max() <= 1e-13 * np.abs(a).max() * hh


# ---------------------------------------------------------------------------
# the plans and the refusals
# ---------------------------------------------------------------------------

def test_qr_panel_batched_plan():
    plan = hopper_ops.qr_panel_batched_plan
    smem = hopper_ops.qr_panel_batched_smem_bytes
    # the engine's shapes: the rows in registers, a warp per 64 × 32 f32
    # panel (four a CTA), a CTA of 256 threads with two rows each per
    # 512 × 32 f32 panel; 512 × 32 f64 takes shared memory
    for (hh, w, it), team, threads, storage in (
            ((512, 32, 4), "cta", 256, "registers"),
            ((64, 32, 4), "warp", 32, "registers"),
            ((32, 32, 8), "warp", 32, "registers"),
            ((512, 32, 8), "cta", 256, "shared")):
        p = plan(hh, w, it)
        assert (p.team, p.threads, p.storage) == (team, threads, storage)
        assert p.items_per_cta == (hopper_ops.P5_WARP_ITEMS
                                   if team == "warp" else 1)
        assert p.smem_bytes == smem(hh, w, it, storage, threads)
    # the boundary: the last shared height and the first streaming one
    limit = hopper_ops.PANEL_SMEM_LIMIT
    for w, it in ((32, 4), (32, 8), (128, 4), (128, 8)):
        wp = -(-w // 32) * 32

        def base(hh):  # a team of 32·⌈hh/32⌉ threads, at most 256
            return 2 * min(hopper_ops.P5_THREADS // 32, -(-hh // 32)) * wp \
                + 2 * wp

        last = max(hh for hh in range(w, limit // it)
                   if (base(hh) + hh * (w | 1)) * it <= limit)
        p = plan(last, w, it)
        assert p.storage == "shared" and p.smem_bytes == (
            base(last) + last * (w | 1)) * it <= limit
        p = plan(last + 1, w, it)
        assert p.storage == "streaming"
        assert p.smem_bytes == base(last + 1) * it
    # at w ≤ 32 with kR = 8 // itemsize: a warp team up to 32·kR rows,
    # registers up to 256·kR
    for it in (4, 8):
        kr = 8 // it
        assert plan(32 * kr, 32, it).team == "warp"
        assert plan(32 * kr + 1, 32, it).team == "cta"
        assert plan(256 * kr, 32, it).storage == "registers"
        assert plan(256 * kr + 1, 32, it).storage == "shared"
        assert plan(100, 33, it).storage == "shared"
    for bad in ((8, 9, 4), (200, 129, 4), (10, 0, 4), (2 ** 24, 128, 4),
                (64, 32, 2)):
        with pytest.raises(SlateError):
            plan(*bad)


def test_kernels_refuse_bad_stacks():
    c = torch.zeros((2, 4, 4), dtype=torch.complex64)
    for f in (hopper_ops.chol_tile_batched, hopper_ops.lu_panel_batched,
              hopper_ops.qr_panel_batched):
        f(c)  # complex instances: the plain version here
        with pytest.raises(NotImplementedError, match="complex64"):
            f(c.real.half())
    with pytest.raises(SlateError):
        hopper_ops.chol_tile_batched(torch.zeros((2, 65, 65)))
    with pytest.raises(SlateError):
        hopper_ops.chol_tile_batched(torch.zeros((2, 4, 5)))
    with pytest.raises(SlateError):
        hopper_ops.qr_panel_batched(torch.zeros((2, 4, 5)))
    with pytest.raises(SlateError):
        hopper_ops.qr_panel_batched(torch.zeros((2, 200, 129)))
    # a CPU tensor never reaches a build
    assert not hopper_ops._build._libs


def test_kernels_read_strided_views_as_contiguous():
    """P4 and P5 take a block of a larger stack without a copy; the plain
    versions give the same bits as on the block's contiguous copy."""
    big = torch.from_numpy(_spd(48, 3, np.float64))
    view = big[:, 8:40, 8:40]
    assert not view.is_contiguous()
    for f in (hopper_ops.chol_tile_batched, hopper_ops.qr_panel_batched):
        for got, want in zip(f(view), f(view.contiguous())):
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# kernel launches per call (counted on the CPU by wrapping the launchers)
# ---------------------------------------------------------------------------

@pytest.fixture
def counts(monkeypatch):
    got = {}
    for name in ("trtri_leaves", "lu_panel_batched", "chol_tile_batched",
                 "qr_panel_batched"):
        def counted(*args, _f=getattr(hopper_ops, name), _n=name):
            got[_n] = got.get(_n, 0) + 1
            return _f(*args)
        monkeypatch.setattr(hopper_ops, name, counted)
    return got


# the launches the recursions make: n = 256 at nb = 32 (512 × 256 for QR), and
# n = 32 (one panel)
LAUNCHES = {
    (256, "getrf"): {"lu_panel_batched": 8, "trtri_leaves": 7},
    (256, "potrf"): {"chol_tile_batched": 8, "trtri_leaves": 7},
    (256, "getrs"): {"trtri_leaves": 16},
    (256, "potrs"): {"trtri_leaves": 16},
    (256, "geqrf"): {"qr_panel_batched": 8, "trtri_leaves": 8},
    (256, "gels_solve"): {"trtri_leaves": 8},
    (32, "getrf"): {"lu_panel_batched": 1},
    (32, "potrf"): {"chol_tile_batched": 1},
    (32, "getrs"): {"trtri_leaves": 2},
    (32, "potrs"): {"trtri_leaves": 2},
    (32, "geqrf"): {"qr_panel_batched": 1, "trtri_leaves": 1},
    (32, "gels_solve"): {"trtri_leaves": 1},
}


@pytest.mark.parametrize("n", [256, 32])
def test_launches_per_call(n, counts):
    dt = np.float32
    a, s = torch.from_numpy(_general(n, 2, dt)), torch.from_numpy(
        _spd(n, 2, dt))
    tall = torch.from_numpy(_general(n, 2, dt, 2 * n))
    b = torch.ones((2, n, 2), dtype=torch.float32)
    nb = batched.default_nb(n)

    def run(key, fn):
        counts.clear()
        out = fn()
        assert counts == LAUNCHES[(n, key)], key
        return out

    lu, perm, _ = run("getrf", lambda: blocked.getrf_batched(a, nb))
    l, _ = run("potrf", lambda: blocked.potrf_batched(s, nb))
    vr, _, ts = run("geqrf", lambda: blocked.geqrf_batched(tall, nb))
    run("getrs", lambda: blocked.getrs_batched(lu, perm, b))
    run("potrs", lambda: blocked.potrs_batched(l, b))
    run("gels_solve", lambda: blocked.gels_qr_solve_batched(
        vr, ts, torch.ones((2, 2 * n, 2)), nb))


# ---------------------------------------------------------------------------
# the small Session ops against the reference's batched verbs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["lu_small", "chol_small"])
def test_session_small_ops_match_reference_batched_verbs(op):
    n, bsz, dt = 32, 4, np.float32
    mats = _spd(n, bsz, dt) if op == "chol_small" else _general(n, bsz, dt)
    rhs = _rng("r", n, bsz).standard_normal((bsz, n, 2)).astype(dt)
    verb = (ref_batched.posv_batched if op == "chol_small"
            else ref_batched.gesv_batched)
    ref, r_info = _np(*verb(mats, rhs))
    assert not r_info.any()
    sess = stt.Session(device="cpu")
    hs = [sess.register(m, op=op if op == "chol_small" else "auto")
          for m in mats]
    assert sess.small_group_key(hs[0]) == (op, n, "float32")
    xs, infos = sess.solve_small_batched(hs[:2], list(rhs[:2]))
    assert infos == [0, 0]
    per_request = np.stack([sess.solve(h, b) for h, b in zip(hs, rhs)])
    assert _rel(per_request, ref) <= X_TOL[dt]
    assert _rel(xs, ref[:2]) <= X_TOL[dt]
