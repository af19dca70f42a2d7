"""Complex instances of the LU and Cholesky kernels (K1 chol_tile, K2
lu_panel_base, P2 lu_nopiv_base, P3 lu_panel_batched, P4
chol_tile_batched) on the CPU, where each launcher runs its plain
version: those plain versions against the reference's complex arms on the
same numpy inputs, a numpy model of the kernels' complex arithmetic
(csrc/cx.cuh) bit for bit against the plain versions' helpers and step
formulas, and the kernels' plans at itemsize 16.

The reference's Pallas gates take real float32 only, so its complex path
is plain jnp: ``_chol_unrolled`` (K1), ``_panel_getrf_base`` (K2),
``_lu_nopiv_unblocked`` (P2), ``_panel_getrf_batched_impl`` (P3) and
``_chol_unrolled_b`` (P4).

Tolerances: values within 1e-5 (complex64) / 1e-12 (complex128) of the
reference relative to its largest finite entry (the two packages divide
and multiply complex numbers in other roundings); perm and info exact;
NaN in the same places. The numpy model and the plain versions agree bit
for bit, except the modulus, which numpy's hypot and torch's may round
one unit apart (held to 1 ulp; it only ranks pivots). The modulus of
inf + nan·i is NaN, as the reference's jnp.abs gives it (IEEE hypot
gives inf), so such a pivot wins its column and is bad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import lu as ref_lu
from slate_tpu.ops import blocked as ref_blocked
from slate_tpu_torch.ops import hopper_ops as ho

torch.set_num_threads(2)

CTYPES = [np.complex64, np.complex128]
TOL = {np.complex64: 1e-5, np.complex128: 1e-12}
RNG_SEED = 1515


def _real(dt):
    return np.float32 if dt == np.complex64 else np.float64


def _cgauss(rng, shape, dt):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dt)


def _hpd(rng, s, dt, lead=()):
    x = _cgauss(rng, lead + (s, s), np.complex128)
    a = x @ np.conj(np.swapaxes(x, -1, -2)) / s + np.eye(s)
    return a.astype(dt)


def _rel(x, y):
    ok = np.isfinite(y)
    if not ok.any():
        return 0.0
    return np.abs(x[ok] - y[ok]).max() / max(np.abs(y[ok]).max(), 1e-300)


def _bits(x):
    """The bits of each real part, every NaN made the same NaN (a NaN's
    sign and payload are not part of the contract)."""
    x = np.ascontiguousarray(x)
    parts = x.view(x.real.dtype).copy()
    parts[np.isnan(parts)] = np.nan
    return parts.view(np.uint32 if x.real.dtype == np.float32 else np.uint64)


def _same_bits(x, y):
    return np.array_equal(_bits(np.asarray(x)), _bits(np.asarray(y)))


# ---------------------------------------------------------------------------
# a numpy model of csrc/cx.cuh, one rounded real operation at a time
# ---------------------------------------------------------------------------

def np_mul(a, b):
    """cx::mul_rn: (ar·br − ai·bi) + i·(ar·bi + ai·br)."""
    re = a.real * b.real - a.imag * b.imag
    im = a.real * b.imag + a.imag * b.real
    return _cx(re, im)


def _cx(re, im):
    out = np.empty(np.shape(re), np.result_type(re, np.complex64))
    out.real, out.imag = re, im
    return out


def np_divide(a, d):
    """cx::divide(a, make_divisor(d)): Smith's form, c10::complex's."""
    rt = a.real.dtype.type
    c, e = d.real, d.imag
    ac, ae = np.abs(c), np.abs(e)
    one = rt(1)
    with np.errstate(all="ignore"):
        if ac >= ae:
            if ac == 0 and ae == 0:
                return _cx(a.real / ac, a.imag / ae)
            rat = e / c
            scl = one / (c + e * rat)
            return _cx((a.real + a.imag * rat) * scl,
                       (a.imag - a.real * rat) * scl)
        rat = c / e
        scl = one / (e + c * rat)
        return _cx((a.real * rat + a.imag) * scl,
                   (a.imag * rat - a.real) * scl)


def _np_abs(x):
    """cx_abs: hypot, NaN where a part is NaN."""
    return np.where(np.isnan(x.real) | np.isnan(x.imag), np.nan,
                    np.hypot(x.real, x.imag))


def _specials(dt):
    rt = _real(dt)
    big = rt(1e30) if rt == np.float32 else rt(1e300)
    vals = [0.0, -0.0, 1.0, -2.5, np.inf, -np.inf, np.nan, 3.0, 4.0, big,
            rt(1e-30)]
    return np.array([complex(x, y) for x in vals for y in vals], dt)


@pytest.mark.parametrize("dt", CTYPES)
def test_numpy_model_of_the_arithmetic_is_the_plain_helpers(dt):
    """cx_mul (also of a conjugate view), cx_div and cx_div_real bit for
    bit their numpy model (the kernels' formulas) on Gaussian and special
    values, and Smith's quotient does not overflow where a·conj(b)/|b|²
    does."""
    rng = np.random.default_rng(RNG_SEED)
    a = np.concatenate([_cgauss(rng, 200, dt), _specials(dt)])
    b = np.concatenate([_cgauss(rng, 200, dt), _specials(dt)[::-1]])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with np.errstate(all="ignore"):
        assert _same_bits(ho.cx_mul(ta, tb).numpy(), np_mul(a, b))
        want = np.array([np_divide(x, y) for x, y in zip(a, b)])
        got = ho.cx_div(ta, ho.cx_divisor(tb)).numpy()
        assert _same_bits(got, want)
        r = np.abs(b.real) + _real(dt)(0.5)
        assert _same_bits(ho.cx_div_real(ta, torch.from_numpy(r)).numpy(),
                          _cx(a.real / r, a.imag / r))
        assert _same_bits(ho.cx_mul(ta, tb.conj()).numpy(),
                          np_mul(a, _cx(b.real, -b.imag)))
    # the divisor broadcasts: one divisor for a whole column
    d = b[3:4]
    got = ho.cx_div(ta, ho.cx_divisor(torch.from_numpy(d))).numpy()
    assert _same_bits(got, np.array([np_divide(x, d[0]) for x in a]))
    # Smith's form keeps a huge divisor finite
    big = _real(dt)(1e25 if dt == np.complex64 else 1e200)
    q = ho.cx_div(torch.tensor([complex(big, big)], dtype=ta.dtype),
                  ho.cx_divisor(torch.tensor([complex(big, -big)],
                                             dtype=ta.dtype)))
    np.testing.assert_allclose(q.numpy(), [1j], atol=1e-6)


@pytest.mark.parametrize("dt", CTYPES)
def test_modulus_is_hypot(dt):
    """cx_abs is hypot of the parts (within 1 ulp of numpy's), exact on
    3 + 4i, NaN where a part is NaN (inf + nan·i too), as the
    reference's jnp.abs, so ``bad_pivot`` is its isnan(|d|) |
    (|d| == 0)."""
    rng = np.random.default_rng(RNG_SEED + 1)
    a = _cgauss(rng, 500, dt)
    m = ho.cx_abs(torch.from_numpy(a)).numpy()
    ref = np.hypot(a.real, a.imag)
    assert np.all(np.abs(m - ref) <= np.spacing(ref))
    special = torch.tensor([3 + 4j, complex(np.inf, np.nan),
                            complex(np.nan, 0), 0j, -0j,
                            complex(-np.inf, 1), complex(1, np.nan)],
                           dtype=torch.from_numpy(a).dtype)
    m = ho.cx_abs(special)
    ref = np.asarray(jnp.abs(jnp.asarray(special.numpy())))
    np.testing.assert_array_equal(m.numpy(), ref)
    assert m[0] == 5 and torch.isnan(m[1]) and torch.isinf(m[5])
    assert ho.bad_pivot(special).tolist() == [False, True, True, True, True,
                                              False, True]


# ---------------------------------------------------------------------------
# K1 chol_tile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 7, 33, 64])
@pytest.mark.parametrize("dt", CTYPES)
def test_chol_tile_plain_matches_reference(s, dt):
    rng = np.random.default_rng(RNG_SEED + s)
    a = _hpd(rng, s, dt)
    ref = np.asarray(ref_blocked._chol_unrolled(jnp.asarray(a), s))
    # junk above the diagonal and an imaginary part on it are not read
    junk = np.tril(a) + 1e6 * np.triu(_cgauss(rng, (s, s), dt), 1)
    junk[np.arange(s), np.arange(s)] += 1j * rng.standard_normal(s)
    l = ho.chol_tile(torch.from_numpy(junk)).numpy()
    assert _rel(l, ref) <= TOL[dt]
    assert not np.triu(l, 1).any()
    assert not np.diagonal(l).imag.any() and (np.diagonal(l).real > 0).all()


@pytest.mark.parametrize("dt", CTYPES)
def test_chol_tile_plain_bad_pivots_poison_from_there(dt):
    """A non-positive real diagonal part (with any imaginary part) or a
    NaN makes that diagonal entry NaN and every one after it, as the
    reference's sqrt of a negative does. An exactly zero leading minor
    is NaN too (the port's contract: potrf reads failure off NaN; the
    reference keeps its 0 on the diagonal there)."""
    rng = np.random.default_rng(RNG_SEED + 2)
    s = 40
    for bad, value in ((0, -1.0 + 5j), (17, -2.0), (39, complex(np.nan, 0)),
                       (20, 0.0)):
        a = _hpd(rng, s, dt)
        a[bad, bad] = -np.abs(a).sum() if value == -2.0 else value
        if value == 0.0:  # a zero leading minor: L[bad, bad] = 0 exactly
            a[bad, :bad] = 0
            a[:bad, bad] = 0
        d = np.diagonal(ho.chol_tile_plain(torch.from_numpy(a)).numpy())
        ref = np.diagonal(np.asarray(
            ref_blocked._chol_unrolled(jnp.asarray(a), s)))
        assert np.isfinite(d[:bad]).all() and np.isnan(d[bad:]).all()
        if value != 0.0:
            assert np.array_equal(np.isnan(d), np.isnan(ref))


# ---------------------------------------------------------------------------
# K2 lu_panel_base and P3 lu_panel_batched
# ---------------------------------------------------------------------------

def _panel(rng, hh, w, dt, fault=None):
    a = _cgauss(rng, (hh, w), dt)
    if fault == "zero":
        a[:, min(3, w - 1)] = 0
    elif fault == "nan":
        a[hh - 2, min(2, w - 1)] = complex(np.nan, 1.0)
    elif fault == "infnan":
        a[hh - 3, 0] = complex(np.inf, np.nan)
    elif fault == "tie":  # |3 + 4i| = |−5| = |4 − 3i| = 5: the first wins
        a[:, 0] = a[:, 0] / 4
        a[5, 0], a[2, 0], a[9, 0] = -5, 4 - 3j, 3 + 4j
    return a


def _lu_against_reference(a, dt):
    lu, perm, info = ho.lu_panel_base(torch.from_numpy(a))
    lu_r, perm_r, info_r = (np.asarray(x) for x in
                            ref_blocked._panel_getrf_base(jnp.asarray(a)))
    np.testing.assert_array_equal(perm.numpy(), perm_r)
    assert int(info) == int(info_r)
    lu = lu.numpy()
    assert np.array_equal(np.isnan(lu), np.isnan(lu_r))
    assert _rel(np.where(np.isnan(lu), 0, lu),
                np.where(np.isnan(lu_r), 0, lu_r)) <= TOL[dt]
    return lu, perm.numpy(), int(info)


@pytest.mark.parametrize("w", [1, 7, 33, 64])
@pytest.mark.parametrize("dt", CTYPES)
def test_lu_panel_base_plain_matches_reference(w, dt):
    rng = np.random.default_rng(RNG_SEED + w)
    a = _panel(rng, 2 * w + 3, w, dt)
    lu, perm, info = _lu_against_reference(a, dt)
    assert info == 0
    low = np.tril(lu, -1)[:, :w] + np.eye(2 * w + 3, w)
    np.testing.assert_allclose(a[perm], low @ np.triu(lu)[:w],
                               atol=100 * TOL[dt])


@pytest.mark.parametrize("fault,info", [("zero", 4), ("nan", 3),
                                        ("infnan", 1), ("tie", 0)])
@pytest.mark.parametrize("dt", CTYPES)
def test_lu_panel_base_plain_faults_match_reference(fault, info, dt):
    """A zero column, a NaN and inf + nan·i (a NaN modulus: the maximum,
    it wins its column and is a bad pivot) and an exact tie of moduli
    (the lowest row wins): perm and info exact."""
    rng = np.random.default_rng(RNG_SEED + 3)
    a = _panel(rng, 40, 8, dt, fault)
    _, perm, got = _lu_against_reference(a, dt)
    assert got == info
    if fault == "tie":
        assert perm[0] == 2
    if fault == "infnan":
        assert perm[0] == 37


@pytest.mark.parametrize("dt", CTYPES)
def test_lu_panel_base_plain_is_the_numpy_model(dt):
    """K2's column step in the kernel's arithmetic (pivot by hypot, swap,
    one Smith divisor per column, each trailing entry x − l·u) bit for
    bit the plain version, with a tie and a bad pivot in the panel."""
    rng = np.random.default_rng(RNG_SEED + 4)
    a = _panel(rng, 20, 6, dt, "tie")
    a[:, 4] = 0
    lu = a.copy()
    perm = np.arange(20)
    info = 0
    for j in range(6):
        m = _np_abs(lu[j:, j])
        p = j + (int(np.argmax(np.isnan(m))) if np.isnan(m).any()
                 else int(np.argmax(m)))
        lu[[j, p]] = lu[[p, j]]
        perm[[j, p]] = perm[[p, j]]
        d = lu[j, j]
        bad = bool(np.isnan(_np_abs(d)) or d == 0)
        if bad and not info:
            info = j + 1
        d = dt(1) if bad else d
        for i in range(j + 1, 20):
            lu[i, j] = np_divide(lu[i, j], d)
            lu[i, j + 1:] = lu[i, j + 1:] - np_mul(lu[i, j], lu[j, j + 1:])
    got = ho.lu_panel_base_plain(torch.from_numpy(a))
    assert _same_bits(got[0].numpy(), lu)
    np.testing.assert_array_equal(got[1].numpy(), perm)
    assert int(got[2]) == info == 5


@pytest.mark.parametrize("dt", CTYPES)
def test_lu_panel_batched_plain_matches_reference_and_k2(dt):
    """P3's plain version against ``_panel_getrf_batched_impl`` (perm and
    info exact), each chunk bit for bit K2's plain version, the faults
    kept to their chunks."""
    rng = np.random.default_rng(RNG_SEED + 5)
    chunks = [_panel(rng, 40, 8, dt, f)
              for f in (None, "zero", "nan", "infnan", "tie")]
    s = np.stack(chunks)
    lu, perm, info = ho.lu_panel_batched(torch.from_numpy(s))
    lu_r, perm_r, info_r = (np.asarray(x) for x in
                            ref_blocked._panel_getrf_batched_impl(
                                jnp.asarray(s)))
    np.testing.assert_array_equal(perm.numpy(), perm_r)
    np.testing.assert_array_equal(info.numpy(), info_r)
    assert info.tolist() == [0, 4, 3, 1, 0]
    lu = lu.numpy()
    assert np.array_equal(np.isnan(lu), np.isnan(lu_r))
    assert _rel(np.where(np.isnan(lu), 0, lu),
                np.where(np.isnan(lu_r), 0, lu_r)) <= TOL[dt]
    for b, c in enumerate(chunks):
        one = ho.lu_panel_base_plain(torch.from_numpy(c))
        assert _same_bits(lu[b], one[0].numpy())
        assert torch.equal(perm[b], one[1]) and int(info[b]) == int(one[2])


# ---------------------------------------------------------------------------
# P2 lu_nopiv_base
# ---------------------------------------------------------------------------

def _dominant(rng, s, dt):
    return (_cgauss(rng, (s, s), np.complex128) + 2 * s * np.eye(s)).astype(dt)


@pytest.mark.parametrize("s", [1, 7, 33, 64])
@pytest.mark.parametrize("dt", CTYPES)
def test_lu_nopiv_plain_matches_reference(s, dt):
    rng = np.random.default_rng(RNG_SEED + 10 + s)
    a = _dominant(rng, s, dt)
    lu, info = ho.lu_nopiv_base(torch.from_numpy(a))
    ref, info_r = ref_lu._lu_nopiv_unblocked(jnp.asarray(a))
    assert int(info) == int(info_r) == 0
    assert _rel(lu.numpy(), np.asarray(ref)) <= TOL[dt]


@pytest.mark.parametrize("dt", CTYPES)
def test_lu_nopiv_plain_faults_and_numpy_model(dt):
    """A zero pivot at step 5 (info 5, the step divides by 1), a NaN and
    inf + nan·i on the diagonal (a NaN modulus: bad): info as the
    reference's, non-finite entries in the same places, and every entry
    bit for bit the numpy model of the kernel's step (the whole leaf,
    zeros included)."""
    rng = np.random.default_rng(RNG_SEED + 6)
    s = 16
    for where, value, want in ((4, 0j, 5), (6, complex(np.nan, 2), 7),
                               (3, complex(np.inf, np.nan), 4)):
        a = _dominant(rng, s, dt)
        a[where, where] = value
        if value == 0:  # an exactly zero pivot after four steps
            a[where, :where] = 0
            a[:where, where] = 0
        lu, info = ho.lu_nopiv_base_plain(torch.from_numpy(a))
        ref, info_r = ref_lu._lu_nopiv_unblocked(jnp.asarray(a))
        ref = np.asarray(ref)
        assert int(info) == int(info_r) == want
        assert np.array_equal(np.isfinite(lu.numpy()), np.isfinite(ref))
        m = a.copy()
        zero = dt(0)
        with np.errstate(all="ignore"):
            for i in range(s):
                d = m[i, i]
                bad = bool(np.isnan(_np_abs(d)) or d == 0)
                d = dt(1) if bad else d
                col = np.array([np_divide(m[r, i], d) if r > i else zero
                                for r in range(s)], dt)
                m[i + 1:, i] = col[i + 1:]
                urow = np.where(np.arange(s) > i, m[i], zero).astype(dt)
                m = m - np_mul(col[:, None], urow[None, :])
        assert _same_bits(lu.numpy(), m)


# ---------------------------------------------------------------------------
# P4 chol_tile_batched
# ---------------------------------------------------------------------------

def _chol_items(rng, s, dt):
    """Five HPD items: clean, an imaginary part on the diagonal, a
    non-positive real pivot at s − 1, a NaN at (min(5, s−1), 0), an exact
    zero pivot at min(3, s − 1)."""
    d = _hpd(rng, s, np.complex128, (5,))
    d[1][np.arange(s), np.arange(s)] += 3j
    d[2, s - 1, s - 1] = -1.0 + 1j
    d[3, min(5, s - 1), 0] = complex(np.nan, 0)
    z = min(3, s - 1)
    d[4, z, :] = 0
    d[4, :, z] = 0
    return d.astype(dt)


@pytest.mark.parametrize("s", [1, 7, 33, 64])
@pytest.mark.parametrize("dt", CTYPES)
def test_chol_tile_batched_plain_matches_reference(s, dt):
    rng = np.random.default_rng(RNG_SEED + 20 + s)
    d = _chol_items(rng, s, dt)
    l, info = ho.chol_tile_batched(torch.from_numpy(d))
    l_r, info_r = (np.asarray(x) for x in
                   ref_blocked._chol_unrolled_b(jnp.asarray(d), s))
    np.testing.assert_array_equal(info.numpy(), info_r)
    assert info.tolist() == [0, 0, s, min(5, s - 1) + 1, min(3, s - 1) + 1]
    l = l.numpy()
    assert np.array_equal(np.isnan(l), np.isnan(l_r))
    assert _rel(np.where(np.isnan(l), 0, l),
                np.where(np.isnan(l_r), 0, l_r)) <= TOL[dt]
    # the imaginary part of the diagonal is never read; junk above it
    # neither
    junk = d.copy()
    junk[:, np.arange(s), np.arange(s)] += 5j
    junk = junk + np.triu(np.full_like(junk, 1e6 + 1e6j), 1)
    l2, _ = ho.chol_tile_batched(torch.from_numpy(junk))
    assert _same_bits(np.where(np.isnan(l), 0, l),
                      np.where(np.isnan(l), 0, l2.numpy()))
    assert np.array_equal(np.isnan(l), np.isnan(l2.numpy()))


@pytest.mark.parametrize("s", [7, 16])
@pytest.mark.parametrize("dt", CTYPES)
def test_chol_tile_batched_plain_is_the_numpy_model(s, dt):
    """P4's step in the kernel's arithmetic (dj = re d[j, j], the guarded
    root, the parts divided apart, d[r][c] −= col[r]·conj(col[c]) as
    cx::mul_rn) bit for bit the plain version, faults included."""
    rng = np.random.default_rng(RNG_SEED + 30 + s)
    d = _chol_items(rng, s, dt)
    rt = _real(dt)
    want = d.copy()
    infos = []
    with np.errstate(all="ignore"):
        for a in want:
            info = 0
            for j in range(s):
                dj = a[j, j].real
                bad = np.isnan(dj) or dj <= 0
                if bad and not info:
                    info = j + 1
                # torch's square root: on the CPU it may round a unit
                # apart from numpy's (on the card both are IEEE's)
                root = rt(torch.sqrt(torch.tensor(rt(1) if bad else dj)))
                col = _cx(a[j + 1:, j].real / root, a[j + 1:, j].imag / root)
                a[j + 1:, j] = col
                a[j + 1:, j + 1:] = a[j + 1:, j + 1:] - np_mul(
                    col[:, None], np.conj(col)[None, :])
                a[j, j] = root
            infos.append(info)
    l, info = ho.chol_tile_batched_plain(torch.from_numpy(d))
    assert info.tolist() == infos
    assert _same_bits(l.numpy(), np.tril(want))


# ---------------------------------------------------------------------------
# the plans at itemsize 16
# ---------------------------------------------------------------------------

def test_plans_at_itemsize_16():
    """complex64 has float64's footprint, so it takes float64's plans;
    complex128 (itemsize 16) halves the rows that fit again: K1 at
    b = 128 needs a 4-CTA cluster and at 512 streams, K2's (16384, 128)
    panel streams, P3's CALU round (32, 512, 512) falls to the streaming
    plan while its engine round (10000, 32, 32) stays resident."""
    n_sm = 132
    assert ho.chol_tile_plan(128, 8) == ho.CholPlan(1, 32, True)
    assert ho.chol_tile_plan(128, 16) == ho.CholPlan(4, 32, True)
    assert ho.chol_tile_plan(512, 8) == ho.CholPlan(8, 32, False)
    assert ho.chol_tile_plan(512, 16) == ho.CholPlan(8, 32, False)
    assert ho.chol_tile_smem_bytes(128, 16, 4, True) == 8352 * 16
    for b in (1, 33, 128, 200, 512, 1024):
        p = ho.chol_tile_plan(b, 16)
        if p.resident:
            assert (ho.chol_tile_smem_bytes(b, 16, p.ctas, True)
                    <= ho.PANEL_SMEM_LIMIT)
    k2 = ho.PANEL_SMEM_RESERVE
    assert ho.panel_grid_plan(16384, 128, 8, n_sm, k2).resident
    p16 = ho.panel_grid_plan(16384, 128, 16, n_sm, k2)
    assert not p16.resident and p16.blocks == n_sm
    assert ho.panel_grid_plan(2000, 64, 16, n_sm, k2).resident
    p = ho.lu_panel_batched_plan(32, 512, 512, 8, n_sm)
    assert p.resident and p.ctas == 16
    p = ho.lu_panel_batched_plan(32, 512, 512, 16, n_sm)
    assert not p.resident and p.smem_bytes <= ho.PANEL_SMEM_LIMIT
    assert p == ho.lu_panel_batched_plan_with(512, 512, 16, p.ctas)
    for shape in ((10000, 32, 32), (1000, 256, 32)):
        p = ho.lu_panel_batched_plan(*shape, 16, n_sm)
        assert p.resident and p.smem_bytes <= ho.PANEL_SMEM_LIMIT


def test_real_only_kernels_name_their_roadmap_part():
    """K5 is the one kernel without complex instances and names ROADMAP
    item 3(c); the Householder kernels (item 3(b)) take complex now and
    run their plain versions here."""
    c = torch.zeros((64, 64), dtype=torch.complex64)
    with pytest.raises(NotImplementedError) as e:
        ho.herk_lower_update(c, c)
    assert "3(c)" in str(e.value)
    assert set(ho._COMPLEX_LATER) == {"herk_lower_update"}
    for f, arg in ((ho.qr_panel_base, c[:, :32]),
                   (ho.qr_panel_base_wide, c), (ho.qr_panel_batched, c[None])):
        vr, taus = f(arg)
        assert vr.dtype == taus.dtype == torch.complex64
        assert not taus.abs().any() and not vr.abs().any()


def test_complex_cuda_views_reach_the_kernels():
    """A complex tensor on another device than the CPU reaches the
    launcher, which raises there (no plain-version fallback); a
    conjugate view cannot be factored in place by P2."""
    m = torch.empty((64, 64), dtype=torch.complex64, device="meta")
    for f in (ho.chol_tile, ho.lu_panel_base):
        with pytest.raises(ho.SlateError, match="unsupported device"):
            f(m)
    with pytest.raises(ho.SlateError, match="unsupported device"):
        ho.lu_panel_batched(m[None])
    with pytest.raises(ho.SlateError, match="unsupported device"):
        ho.chol_tile_batched(m[None, :8, :8])
    with pytest.raises(ho.SlateError, match="unsupported device"):
        ho.lu_nopiv_base_inplace(m[:8, :8], torch.zeros(
            (), dtype=torch.int32, device="meta"))
