"""The complex Householder kernels' plain versions (K3, K4, P5) and their
plans on the CPU, against slate_tpu's complex arms on the same numpy
inputs; the drivers are in tests/test_torch_complex_qr_drivers.py.

The reference runs complex QR in plain jnp (its Pallas gates take real
float32 only), so no interpret mode is needed: the port's ``larfg``
against ``_larfg``, ``qr_panel_base_plain`` against
``_panel_geqrf_base``, ``qr_panel_base_wide_plain`` and
``blocked.panel_geqrf`` against ``panel_geqrf``'s width recursion,
``qr_panel_batched_plain`` against ``_panel_geqrf_batched``, and
``larft``/``larft_b`` against ``larft``/``larft_b``. Each repaired
real-only spot of the port (larfg's alpha², its ``alpha <= 0`` and its
degenerate test; the column step's vᵀ and tau; the compact-WY Tᵀ/Vᵀ of
K4's plain version; ``larft_b``'s Vᵀ) gives a wrong answer or raises
under the code before the repair, and one test here shows each.

Tolerances (ε of the working type, H the panel's height): the scalars
of larfg within 8·ε relative; panel factors and taus within
8·ε·√H·max(1, w/8) of the reference relative to its largest entry
(both packages run Householder QR, whose growth is benign; they differ
in summation order and in K4's reassociation); T factors within
8·ε·w·‖T‖. A degenerate column is pinned on both sides: the port keeps
alpha (tau = 0), the reference's batched arm stores beta = −alpha there
(ROADMAP queue 3).
"""

import functools
import math
import os
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops import blocked as ref_blocked
from slate_tpu_torch.ops import blocked, hopper_ops as ho

torch.set_num_threads(2)

CTYPES = [np.complex64, np.complex128]
CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "slate_tpu_torch",
                    "csrc")
H100_SMS = 132


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _cgauss(rng, shape, dt):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dt)


def _eps(dt):
    return np.finfo(np.empty(0, dt).real.dtype).eps


def _rel(x, y):
    return np.abs(np.asarray(x) - np.asarray(y)).max() / max(
        np.abs(np.asarray(y)).max(), 1e-300)


def _panel_tol(dt, hh, w):
    return 8 * _eps(dt) * math.sqrt(hh) * max(1.0, w / 8)


def _np(*xs):
    return tuple(np.array(x) for x in xs)


# ---------------------------------------------------------------------------
# larfg
# ---------------------------------------------------------------------------

def _larfg_cases(dt):
    """(alpha, tail) pairs: Gaussian, a zero tail under a real positive,
    negative and zero alpha (degenerate), under an alpha with an imaginary
    part and under a purely imaginary one (not degenerate), a tiny tail,
    and a NaN in the tail."""
    rng = _rng("larfg", np.dtype(dt).name)
    z = np.zeros(6, dt)
    cases = [(_cgauss(rng, (), dt), _cgauss(rng, (6,), dt)) for _ in range(4)]
    cases += [(dt(2.5), z), (dt(-1.5), z), (dt(0), z), (dt(1 + 2j), z),
              (dt(-3j), z), (dt(-0.5 + 0.25j), z),
              (dt(1 - 1j), np.full(6, 1e-3 + 1e-3j, dt))]
    nan = z.copy()
    nan[2] = np.nan
    cases.append((dt(1 + 1j), nan))
    return cases


@pytest.mark.parametrize("dt", CTYPES)
def test_larfg_matches_reference(dt):
    """beta, tau and scale of the port's complex larfg equal the
    reference's within 8·ε; a zero tail under a real alpha is degenerate
    (tau = 0, alpha kept), under an alpha with an imaginary part it is
    not (tau ≠ 0, beta = ∓|alpha| real): the imag(alpha) = 0 test the
    real-only larfg lacked."""
    tol = 8 * _eps(dt)
    for alpha, tail in _larfg_cases(dt):
        got = ho.larfg(torch.tensor(alpha),
                       ho.abs2(torch.from_numpy(tail)).sum())
        want = ref_blocked._larfg(jnp.asarray(alpha), jnp.asarray(tail))
        got = [complex(x) for x in got]
        want = [complex(x) for x in want]
        if np.isnan(tail).any():
            assert all(np.isnan(g) for g in got[1:])
            assert all(np.isnan(w) for w in want[1:])
            continue
        for g, w in zip(got, want):
            assert abs(g - w) <= tol * max(1.0, abs(w)), (alpha, got, want)
        zero_tail = not tail.any()
        if zero_tail and alpha.imag == 0:
            assert got == [complex(alpha), 0, 0]
        elif zero_tail:
            assert got[1] != 0 and got[0].imag == 0
            assert abs(abs(got[0]) - abs(alpha)) <= tol * abs(alpha)
            assert math.copysign(1, got[0].real) == -math.copysign(
                1, alpha.real) or alpha.real == 0


def test_larfg_real_bits_unchanged():
    """On real scalars the complex-ready larfg is bit for bit the real
    one it replaced."""
    rng = _rng("larfg-real")
    for dt in (torch.float32, torch.float64):
        alpha = torch.from_numpy(rng.standard_normal(64)).to(dt)
        alpha[:4] = torch.tensor([0.0, -0.0, 2.0, -3.0])
        sig = torch.from_numpy(rng.standard_normal(64) ** 2).to(dt)
        sig[:4] = 0
        one, zero = torch.ones_like(alpha), torch.zeros_like(alpha)
        anorm = torch.sqrt(alpha * alpha + sig)
        beta = torch.where(alpha <= 0, anorm, -anorm)
        degen = sig == 0
        tau = torch.where(degen, zero, (beta - alpha) / torch.where(
            degen | (beta == 0), one, beta))
        scale = torch.where(degen, zero,
                            1.0 / torch.where(degen, one, alpha - beta))
        got = ho.larfg(alpha, sig)
        for g, w in zip(got, (torch.where(degen, alpha, beta), tau, scale)):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the panel kernels' plain versions
# ---------------------------------------------------------------------------

def _panel(hh, w, dt, upper=False):
    a = _cgauss(_rng("panel", hh, w, np.dtype(dt).name), (hh, w), dt)
    return np.triu(a) if upper else a


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("hh,w", [(77, 20), (150, 32), (33, 32), (40, 7)])
def test_qr_panel_base_plain_matches_reference(hh, w, dt):
    """K3's plain version against ``_panel_geqrf_base``: the column step
    eliminates with Hᴴ = I − conj(τ)·v·vᴴ (w_row = vᴴ·A)."""
    a = _panel(hh, w, dt)
    vr, taus = _np(*ho.qr_panel_base_plain(torch.from_numpy(a)))
    r_vr, r_taus = _np(*ref_blocked._panel_geqrf_base(jnp.asarray(a)))
    tol = _panel_tol(dt, hh, w)
    assert _rel(vr, r_vr) <= tol and _rel(taus, r_taus) <= tol


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("hh,w", [(150, 64), (200, 128), (96, 96)])
def test_qr_panel_base_wide_plain_matches_reference(hh, w, dt):
    """K4's plain version (32-column micro-blocks, compact-WY updates
    C ← C − V·(Tᴴ·(Vᴴ·C))) against the reference's width recursion
    (``panel_geqrf``, which ends in ``_panel_geqrf_base`` on the CPU)."""
    a = _panel(hh, w, dt)
    vr, taus = _np(*ho.qr_panel_base_wide_plain(torch.from_numpy(a)))
    r_vr, r_taus = _np(*ref_blocked.panel_geqrf(jnp.asarray(a)))
    tol = _panel_tol(dt, hh, w)
    assert _rel(vr, r_vr) <= tol and _rel(taus, r_taus) <= tol


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("hh,w", [(200, 100), (300, 256)])
def test_panel_geqrf_matches_reference(hh, w, dt):
    """The port's width recursion (K4 bases at 64/128, K3 bases below)
    against the reference's."""
    a = _panel(hh, w, dt)
    vr, taus = _np(*blocked.panel_geqrf(torch.from_numpy(a)))
    r_vr, r_taus = _np(*ref_blocked.panel_geqrf(jnp.asarray(a)))
    tol = _panel_tol(dt, hh, w)
    assert _rel(vr, r_vr) <= tol and _rel(taus, r_taus) <= tol


def _reconstruct(a, vr, taus):
    """max |A − Q·R| / max |A| with Q = H₀·…·H_{w−1}, H = I − τ·v·vᴴ."""
    hh, w = a.shape
    qr = np.zeros((hh, w), np.complex128)
    qr[:w] = np.triu(vr[:w])
    for j in range(w - 1, -1, -1):
        v = np.concatenate([np.zeros(j), [1.0], vr[j + 1:, j]])
        qr -= taus[j] * np.outer(v, v.conj() @ qr)
    return np.abs(qr - a).max() / np.abs(a).max()


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("kernel", ["K3", "K4", "P5"])
def test_zero_tail_under_an_imaginary_alpha(kernel, dt):
    """An upper-triangular panel: every column has a zero tail. Where the
    diagonal has an imaginary part the column is not degenerate (tau ≠ 0,
    R's diagonal real, −sign(re α)·|α|); where it is real (column 3 set to
    2.5) it is (tau = 0, alpha kept); Q·R = A either way. The reference
    agrees: tau and |R| within tolerance."""
    w = 64 if kernel == "K4" else 32
    a = _panel(70, w, dt, upper=True)
    a[3, 3] = 2.5
    t = torch.from_numpy(a)
    if kernel == "K3":
        vr, taus = _np(*ho.qr_panel_base(t))
    elif kernel == "K4":
        vr, taus = _np(*ho.qr_panel_base_wide(t))
    else:
        vr, taus = (x[0] for x in _np(*ho.qr_panel_batched(t[None])))
    d = np.diag(a)
    assert taus[3] == 0 and vr[3, 3] == 2.5
    live = np.arange(w) != 3
    assert (taus[live] != 0).all()
    np.testing.assert_allclose(np.diag(vr)[live].imag, 0, atol=0)
    np.testing.assert_allclose(np.diag(vr)[live],
                               -np.sign(d[live].real) * np.abs(d[live]),
                               rtol=8 * _eps(dt))
    assert _reconstruct(a, vr, taus) <= 8 * _eps(dt) * w
    r_vr, r_taus = _np(*ref_blocked._panel_geqrf_base(jnp.asarray(a)))
    tol = _panel_tol(dt, 70, w)
    assert _rel(taus, r_taus) <= tol and _rel(vr, r_vr) <= tol


def _items(hh, w, dt):
    """A (5, H, w) stack: item 1 has a zero column 2, item 2 a NaN at
    (H − 1, 3), item 3 is upper triangular with a real 2.5 at (1, 1) (a
    degenerate column) and complex diagonal entries elsewhere."""
    rng = _rng("items", hh, w, np.dtype(dt).name)
    a = _cgauss(rng, (5, hh, w), dt)
    a[1, :, 2] = 0
    a[2, hh - 1, 3] = np.nan
    a[3] = np.triu(a[3])
    a[3, 1, 1] = 2.5
    return a


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("hh,w", [(64, 32), (100, 33), (40, 40), (7, 7)])
def test_qr_panel_batched_plain_matches_reference(hh, w, dt):
    """P5's plain version against ``_panel_geqrf_batched``'s complex arm
    within the panel tolerance, except on degenerate columns: there the
    port keeps alpha (tau = 0) and the reference stores beta = −alpha
    beside tau = 0 (ROADMAP queue 3), both sides pinned. A square item's
    last column is degenerate only if its alpha is real, which a complex
    Gaussian's is not: it is reflected in both. The NaN stays in its item
    in both packages."""
    a = _items(hh, w, dt)
    vr, taus = _np(*ho.qr_panel_batched_plain(torch.from_numpy(a)))
    r_vr, r_taus = _np(*ref_blocked._panel_geqrf_batched(jnp.asarray(a)))
    assert taus[1, 2] == r_taus[1, 2] == 0            # zero column
    assert vr[1, 2, 2] == r_vr[1, 2, 2] == 0
    # the degenerate column: alpha kept in the port, −alpha stored in the
    # reference, tau = 0 in both
    assert taus[3, 1] == r_taus[3, 1] == 0
    assert vr[3, 1, 1] == 2.5 and r_vr[3, 1, 1] == -2.5
    r_vr[3, 1, 1] = 2.5
    if hh == w:  # the last column: a complex alpha, no tail
        assert (taus[[0, 4], w - 1] != 0).all()
    tol = _panel_tol(dt, hh, w)
    for i in (0, 1, 3, 4):
        assert _rel(vr[i], r_vr[i]) <= tol
        assert _rel(taus[i], r_taus[i]) <= tol
    top = min(w, hh - 1)
    assert np.isnan(taus[2, 3:top]).all() and np.isfinite(taus[2, :3]).all()
    assert np.isfinite(vr[2, :, :3]).all() and np.isnan(r_vr[2]).any()
    assert np.isfinite(np.delete(vr, 2, axis=0)).all()
    assert _reconstruct(a[3], vr[3], taus[3]) <= 8 * _eps(dt) * w


@pytest.mark.parametrize("dt", CTYPES)
def test_qr_panel_batched_items_never_mix(dt):
    """An item's bits do not depend on its neighbours."""
    a = _items(64, 32, dt)
    vr, taus = ho.qr_panel_batched_plain(torch.from_numpy(a))
    v0, t0 = ho.qr_panel_batched_plain(torch.from_numpy(a[:1]))
    assert torch.equal(vr[0], v0[0]) and torch.equal(taus[0], t0[0])


# ---------------------------------------------------------------------------
# T factors
# ---------------------------------------------------------------------------

def _v_and_taus(hh, w, dt, batch=None):
    a = _panel(hh, w, dt) if batch is None else _items(hh, w, dt)[[0, 1, 3]]
    t = torch.from_numpy(a)
    if batch is None:
        vr, taus = ho.qr_panel_base_plain(t) if w <= 32 else \
            ho.qr_panel_base_wide_plain(t)
        return blocked._split_v(vr, w), taus
    vr, taus = ho.qr_panel_batched_plain(t)
    return blocked._split_v_b(vr, w), taus


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("w", [20, 64])
def test_larft_matches_reference(w, dt):
    """The port's larft (the column recurrence at w ≤ 32, the closed form
    on P1 above) against the reference's, on the same complex V."""
    v, taus = _v_and_taus(120, w, dt)
    t = blocked.larft(v, taus).numpy()
    r_t = np.asarray(ref_blocked.larft(jnp.asarray(v.numpy()),
                                       jnp.asarray(taus.numpy())))
    assert _rel(t, r_t) <= 8 * _eps(dt) * w


@pytest.mark.parametrize("dt", CTYPES)
@pytest.mark.parametrize("w", [7, 32])
def test_larft_b_matches_reference(w, dt):
    """The batched closed form T = D·(I + striu(VᴴV)·D)⁻¹ against the
    reference's ``larft_b`` (Vᴴ, where the real-only code took Vᵀ), with a
    tau = 0 column (item 1's zero column) giving a zero column of T."""
    v, taus = _v_and_taus(64, w, dt, batch=True)
    t = blocked.larft_b(v, taus).numpy()
    r_t = np.asarray(ref_blocked.larft_b(jnp.asarray(v.numpy()),
                                         jnp.asarray(taus.numpy())))
    assert _rel(t, r_t) <= 8 * _eps(dt) * w
    assert not t[1][:, 2].any()


# ---------------------------------------------------------------------------
# the plans: K3/K4's shared memory per element type, P5 in complex
# ---------------------------------------------------------------------------

def _constant_expr(fname, name):
    with open(os.path.join(CSRC, fname)) as f:
        src = f.read()
    m = re.search(rf"constexpr int {name}\s*=\s*([^;]+);", src)
    assert m, (fname, name)
    return " ".join(re.sub(r"//[^\n]*", "", m.group(1)).split())


@functools.lru_cache(maxsize=None)
def _qr_kfixed():
    """csrc/qr_panel.cu's kFixed, evaluated from its source."""
    env = {"kThreads": int(_constant_expr("grid_panel.cuh", "kThreads"))}
    env["kWarps"] = env["kThreads"] // 32
    for name in ("kMaxW", "kMB", "kMaxTrail", "kTS", "kFixed"):
        env[name] = eval(_constant_expr("qr_panel.cu", name), {}, env)
    return env["kFixed"]


def test_qr_panel_reserve_is_the_kernels_own():
    """The plan reserves K3/K4's kFixed elements beside a resident slab,
    per element type (the launcher sizes kFixed + R·w elements); K2 keeps
    its own reserve."""
    assert ho.QR_PANEL_FIXED_ELEMS == _qr_kfixed() == 5736
    assert ho.QR_PANEL_FIXED_ELEMS * 16 == 91_776
    assert ho.PANEL_SMEM_RESERVE == 49_152


QR_PLAN_SHAPES = [(h, w) for h in (32, 100, 1000, 4096, 8192, 10000, 16384,
                                   20000, 32768, 65536, 131072)
                  for w in (4, 32, 64, 128) if w <= h]


@pytest.mark.parametrize("itemsize", [4, 8, 16])
def test_qr_plan_never_exceeds_the_launch(itemsize):
    """No K3/K4 plan is resident unless the slab and the kernel's own
    shared memory fit one block; every plan covers the panel as K2's
    does, with the same blocks and rows."""
    for hh, w in QR_PLAN_SHAPES:
        plan = ho.panel_grid_plan(hh, w, itemsize, H100_SMS,
                                  ho.QR_PANEL_FIXED_ELEMS * itemsize)
        k2 = ho.panel_grid_plan(hh, w, itemsize, H100_SMS,
                                ho.PANEL_SMEM_RESERVE)
        assert (plan.blocks, plan.rows) == (k2.blocks, k2.rows)
        launch = (_qr_kfixed() + plan.rows * w) * itemsize
        assert plan.resident == (launch <= ho.PANEL_SMEM_LIMIT), (hh, w)


@pytest.mark.parametrize("hh,w,itemsize,mode", [
    (10000, 128, 16, "streaming"), (20000, 64, 16, "streaming"),
    (8192, 128, 8, "resident"), (8192, 128, 16, "resident"),
    (32768, 128, 8, "streaming"), (32768, 128, 16, "streaming"),
    (32768, 32, 8, "resident"), (32768, 32, 16, "resident")])
def test_qr_plan_at_the_complex_smoke_shapes(hh, w, itemsize, mode):
    """The c128 shapes the shared reserve made resident although the
    launch cannot give them shared memory ((10000, 128) and (20000, 64):
    a 155,648 B slab) stream; the smoke's resident and streaming K4
    shapes are what its rows expect."""
    plan = ho.panel_grid_plan(hh, w, itemsize, H100_SMS,
                              ho.QR_PANEL_FIXED_ELEMS * itemsize)
    assert plan.mode == mode
    if (hh, w, itemsize) in ((10000, 128, 16), (20000, 64, 16)):
        assert plan.rows * w * itemsize == 155_648
        assert ho.panel_grid_plan(hh, w, itemsize, H100_SMS,
                                  ho.PANEL_SMEM_RESERVE).resident


@pytest.mark.parametrize("hh,w,itemsize", [(16384, 128, 4), (4096, 128, 8),
                                           (16384, 128, 8), (16384, 128, 16),
                                           (2000, 64, 16), (65536, 128, 4)])
def test_k2_plans_do_not_move(hh, w, itemsize):
    """K2 keeps PANEL_SMEM_RESERVE: its recorded plans stand."""
    plan = ho.panel_grid_plan(hh, w, itemsize, H100_SMS,
                              ho.PANEL_SMEM_RESERVE)
    assert plan.resident == (plan.rows * w * itemsize + 49_152
                             <= ho.PANEL_SMEM_LIMIT)


@pytest.mark.parametrize("shape,want", [
    ((512, 32, 8), ("cta", 256, 1, 2, "shared")),
    ((512, 32, 16), ("cta", 256, 1, 2, "streaming")),
    ((64, 32, 8), ("cta", 64, 1, 1, "registers")),
    ((64, 32, 16), ("cta", 64, 1, 1, "shared")),
    ((32, 32, 8), ("warp", 32, 4, 1, "registers")),
    ((32, 32, 16), ("cta", 32, 1, 1, "shared")),
    ((2000, 128, 8), ("cta", 256, 1, 8, "streaming")),
    ((2000, 128, 16), ("cta", 256, 1, 8, "streaming")),
    ((256, 32, 8), ("cta", 256, 1, 1, "registers")),
    ((257, 32, 8), ("cta", 256, 1, 2, "shared")),
    ((422, 32, 16), ("cta", 256, 1, 2, "shared")),
    ((423, 32, 16), ("cta", 256, 1, 2, "streaming"))])
def test_p5_plan_in_complex(shape, want):
    """complex64 takes float64's plan (one row a thread in registers);
    complex128 never takes registers (its rows and partials would fill a
    thread's), and its item goes shared while it fits, in a CTA team of
    32·⌈H/32⌉ threads, at most 256 (one a CTA even at 32: the warp team
    is the register plan's)."""
    p = ho.qr_panel_batched_plan(*shape)
    assert (p.team, p.threads, p.items_per_cta, p.rows_per_thread,
            p.storage) == want
    assert p.smem_bytes <= ho.PANEL_SMEM_LIMIT
    assert p.smem_bytes == ho.qr_panel_batched_smem_bytes(
        shape[0], shape[1], shape[2], p.storage, p.threads)


@pytest.mark.parametrize("itemsize", [8, 16])
def test_p5_plan_covers_every_complex_shape(itemsize):
    for hh in (1, 7, 32, 33, 64, 100, 256, 257, 422, 423, 1000, 2000, 5000):
        for w in (1, 7, 16, 32, 33, 64, 128):
            if w > hh:
                continue
            p = ho.qr_panel_batched_plan(hh, w, itemsize)
            assert (p.rows_per_thread - 1) * p.threads < hh \
                <= p.rows_per_thread * p.threads
            if itemsize == 16:
                assert p.storage != "registers" and p.team == "cta"
                assert p.threads == min(256, -(-hh // 32) * 32)
            if p.storage == "registers":
                assert p.rows_per_thread <= 8 // itemsize


def test_p5_plan_refuses_other_itemsizes():
    for it in (2, 32):
        with pytest.raises(ho.SlateError):
            ho.qr_panel_batched_plan(64, 32, it)
