"""The port's kernel modules (slate_tpu_torch/ops/hopper_ops.py) on the CPU.

On a CPU tensor each launcher runs its plain PyTorch version; here those
plain versions are held against the reference's Pallas kernels run in
interpret mode (as tests/test_pallas.py runs them) and against the
reference's fori-loop bases, on the same numpy inputs. The CUDA kernels
themselves are held against the plain versions on the card by
chip_smoke.py.

Tolerances: values 1e-5 relative in float32 (summation order differs);
perm and info exact. QR panels (K3, K4) in float32: taus to 1e-6 and the
packed V\\R to 1e-4 absolute (entries of size ≤ ~16 at these heights;
the same bounds tests/test_pallas.py holds the Pallas kernels to against
the fori base), K4 against the unblocked base to 2e-6 / 2e-4 (its
compact-WY update reassociates); a zero column's tau exactly 0.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops import blocked as ref_blocked
from slate_tpu.ops import pallas_ops
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.ops import _build, hopper_ops

torch.set_num_threads(2)

RNG = np.random.default_rng(71)


def _spd(b, junk_upper):
    x = RNG.standard_normal((b, b))
    a = (x @ x.T / b + np.eye(b)).astype(np.float32)
    if junk_upper:
        a = np.tril(a) + 1e6 * np.triu(
            RNG.standard_normal((b, b)).astype(np.float32), 1)
    return a


def test_chol_tile_plain_matches_pallas_interpret():
    """b = 128 (one 128-panel, all four 32-micro steps of the Pallas
    kernel) with junk above the diagonal: only the lower triangle may be
    read, and the result is zero above the diagonal."""
    a = _spd(128, junk_upper=True)
    ref = np.asarray(pallas_ops.chol_tile(jnp.asarray(a), interpret=True))
    got = hopper_ops.chol_tile(torch.from_numpy(a)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
    assert not np.triu(got, 1).any()


def test_chol_tile_nan_contract_matches_reference_micro_step():
    """A non-SPD pivot poisons the diagonal from that column on, as the
    reference's micro factorization (the source of the Pallas kernel's
    poison) does; the columns before stay finite."""
    m = 32
    x = RNG.standard_normal((m, m)).astype(np.float32)
    a = (x @ x.T + m * np.eye(m)).astype(np.float32)
    a[10, 10] = -a[10, 10] - np.abs(a).sum()
    ref = np.asarray(pallas_ops._chol_cols_unrolled(jnp.asarray(a), m))
    got = hopper_ops.chol_tile(torch.from_numpy(a)).numpy()
    assert np.isnan(np.diag(got)[10:]).all()
    assert np.isfinite(got[:, :10]).all()
    np.testing.assert_array_equal(np.isnan(np.diag(got)),
                                  np.isnan(np.diag(ref)))


def test_chol_tile_zero_pivot_is_nan():
    """sqrt(0) would not poison: a zero pivot must still give NaN."""
    a = np.eye(8, dtype=np.float64)
    a[3, 3] = 0.0
    d = np.diag(hopper_ops.chol_tile(torch.from_numpy(a)).numpy())
    assert np.isfinite(d[:3]).all() and np.isnan(d[3:]).all()


def _lu_check(a, lu_t, p_t, i_t):
    lu_k, p_k, i_k = pallas_ops.lu_panel_base(jnp.asarray(a), interpret=True)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_k))
    assert int(i_t) == int(i_k)
    lu_k = np.asarray(lu_k)
    scale = np.abs(lu_k).max()
    assert np.abs(lu_t.numpy() - lu_k).max() <= 1e-5 * scale
    return lu_k


@pytest.mark.parametrize("h,w", [(64, 32), (256, 32), (128, 64)])
def test_lu_panel_plain_matches_pallas_interpret(h, w):
    a = RNG.standard_normal((h, w)).astype(np.float32)
    lu_t, p_t, i_t = hopper_ops.lu_panel_base(torch.from_numpy(a))
    _lu_check(a, lu_t, p_t, i_t)
    assert int(i_t) == 0 and p_t.dtype == torch.int32
    # the factorization itself: a[perm] = L·U
    lu = lu_t.numpy()
    lm = np.tril(lu, -1)[:, :w]
    lm[np.arange(w), np.arange(w)] = 1.0
    np.testing.assert_allclose(a[p_t.numpy()], lm @ np.triu(lu)[:w],
                               atol=1e-4)


def test_lu_panel_zero_column_info():
    a = RNG.standard_normal((64, 32)).astype(np.float32)
    a[:, 3] = 0.0
    lu_t, p_t, i_t = hopper_ops.lu_panel_base(torch.from_numpy(a))
    _lu_check(a, lu_t, p_t, i_t)
    assert int(i_t) == 4


def test_lu_panel_tied_pivots_take_lowest_index():
    """Exact ties in |a[i, j]| go to the lowest row, as jnp.argmax."""
    a = RNG.standard_normal((64, 32)).astype(np.float32)
    a[:, 0] = np.where(np.arange(64) % 2, -1.0, 1.0)   # all |.| tie
    a[[5, 9, 40], 1] = 7.0                             # a later tie
    lu_t, p_t, i_t = hopper_ops.lu_panel_base(torch.from_numpy(a))
    _lu_check(a, lu_t, p_t, i_t)
    assert int(p_t[0]) == 0


def test_lu_panel_nan_rule_matches_jnp_argmax():
    """A NaN candidate wins the pivot search (first NaN), as jnp.argmax
    in the reference's fori base."""
    a = RNG.standard_normal((64, 16))
    a[[20, 30], 2] = np.nan
    lu_t, p_t, i_t = hopper_ops.lu_panel_base(torch.from_numpy(a))
    _, p_r, i_r = ref_blocked._panel_getrf_base(jnp.asarray(a))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_r))
    assert int(i_t) == int(i_r) == 3


def test_cpu_dispatch_counts_no_launch_and_rejects_complex():
    hopper_ops.reset_launches()
    a = torch.from_numpy(_spd(16, junk_upper=False)).double()
    torch.testing.assert_close(hopper_ops.chol_tile(a),
                               hopper_ops.chol_tile_plain(a), rtol=0, atol=0)
    p = torch.from_numpy(RNG.standard_normal((32, 8)))
    out = hopper_ops.lu_panel_base(p)
    ref = hopper_ops.lu_panel_base_plain(p)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    for launcher, plain, w in ((hopper_ops.qr_panel_base,
                                hopper_ops.qr_panel_base_plain, 32),
                               (hopper_ops.qr_panel_base_wide,
                                hopper_ops.qr_panel_base_wide_plain, 64)):
        q = torch.from_numpy(RNG.standard_normal((96, w)))
        assert all(torch.equal(x, y) for x, y in zip(launcher(q), plain(q)))
    c, h = (torch.from_numpy(np.random.default_rng(5).standard_normal(s))
            for s in ((96, 96), (96, 8)))
    torch.testing.assert_close(
        hopper_ops.herk_lower_update(c.clone(), h),
        hopper_ops.herk_lower_update_plain(c.clone(), h), rtol=0, atol=0)
    assert set(hopper_ops.LAUNCHES) == {"chol_tile", "lu_panel_base",
                                        "qr_panel_base", "qr_panel_base_wide",
                                        "herk_lower_update", "trtri_leaves",
                                        "lu_nopiv_base", "lu_panel_batched",
                                        "chol_tile_batched",
                                        "qr_panel_batched",
                                        "chol_update_sweep",
                                        "qr_append_build",
                                        "qr_append_apply",
                                        "secular_roots"}
    assert not any(hopper_ops.LAUNCHES.values())
    # complex: K1-K4 take it (their plain versions here, no launch); K5
    # raises and names the ROADMAP part that brings it
    ac = a.to(torch.complex128)
    torch.testing.assert_close(hopper_ops.chol_tile(ac),
                               hopper_ops.chol_tile_plain(ac), rtol=0, atol=0)
    torch.testing.assert_close(hopper_ops.chol_tile(ac).real,
                               hopper_ops.chol_tile(a), rtol=1e-14,
                               atol=1e-14)
    pc = p.to(torch.complex128)
    assert all(torch.equal(x, y) for x, y in
               zip(hopper_ops.lu_panel_base(pc),
                   hopper_ops.lu_panel_base_plain(pc)))
    assert not any(hopper_ops.LAUNCHES.values())
    with pytest.raises(NotImplementedError, match=r"item 3\(c\)"):
        hopper_ops.herk_lower_update(c.to(torch.complex128),
                                     h.to(torch.complex128))
    for launcher, plain in ((hopper_ops.qr_panel_base,
                             hopper_ops.qr_panel_base_plain),
                            (hopper_ops.qr_panel_base_wide,
                             hopper_ops.qr_panel_base_wide_plain)):
        qc = torch.from_numpy(RNG.standard_normal((96, 64))
                              + 1j * RNG.standard_normal((96, 64)))
        qc = qc[:, :32] if launcher is hopper_ops.qr_panel_base else qc
        assert all(torch.equal(x, y) for x, y in zip(launcher(qc),
                                                     plain(qc)))
    assert not any(hopper_ops.LAUNCHES.values())
    for launcher in (hopper_ops.chol_tile, hopper_ops.lu_panel_base,
                     hopper_ops.qr_panel_base):
        with pytest.raises(NotImplementedError, match="complex64"):
            launcher(torch.zeros((8, 8), dtype=torch.float16))
    with pytest.raises(SlateError):
        hopper_ops.lu_panel_base(p.T)   # w > H
    with pytest.raises(SlateError):
        hopper_ops.qr_panel_base(p.T)   # w > H
    with pytest.raises(SlateError):
        hopper_ops.qr_panel_base(torch.zeros((96, 64)))  # wider than K3
    with pytest.raises(SlateError):
        hopper_ops.qr_panel_base_wide(p[:, :6])  # not a K4 width


def test_gates():
    """The width recursion stops at K2's widest base; there is no 8-row
    floor and no height or VMEM cap (TPU gates of the reference)."""
    assert hopper_ops.lu_panel_eligible(128)
    assert hopper_ops.lu_panel_eligible(1)
    assert hopper_ops.lu_panel_eligible(4)
    assert not hopper_ops.lu_panel_eligible(129)
    assert not hopper_ops.lu_panel_eligible(256)
    for w in (64, 96, 128):
        assert hopper_ops.qr_panel_wide_eligible(w)
    for w in (4, 32, 80, 100, 160, 256):
        assert not hopper_ops.qr_panel_wide_eligible(w)


@pytest.mark.parametrize("launcher,shape", [
    (hopper_ops.chol_tile, (8, 8)), (hopper_ops.lu_panel_base, (64, 4)),
    (hopper_ops.qr_panel_base, (64, 4)),
    (hopper_ops.qr_panel_base_wide, (64, 64))])
def test_non_cpu_tensor_never_runs_the_plain_version(launcher, shape):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device that is neither gets an error, not the plain version."""
    hopper_ops.reset_launches()
    with pytest.raises(SlateError, match="unsupported device"):
        launcher(torch.empty(shape, device="meta"))
    assert not any(hopper_ops.LAUNCHES.values())


def _qr_reconstruction_err(a, vr, taus):
    """max |Q·R − A| in float64 from packed V\\R and taus."""
    h, w = a.shape
    v = np.tril(vr, -1)[:, :w].astype(np.float64)
    v[np.arange(w), np.arange(w)] = 1.0
    qr = np.triu(vr)[:w].astype(np.float64)
    qr = np.vstack([qr, np.zeros((h - w, w))])
    for j in range(w - 1, -1, -1):       # Q·[R; 0] = H₀·…·H_{w−1}·[R; 0]
        qr -= float(taus[j]) * np.outer(v[:, j], v[:, j] @ qr)
    return np.abs(qr - a).max()


@pytest.mark.parametrize("h,w,zero_col", [(128, 32, None), (256, 16, None),
                                          (64, 8, 3)])
def test_qr_panel_plain_matches_pallas_interpret(h, w, zero_col):
    """K3's plain version against the Pallas kernel in interpret mode and
    against the reference's fori base; a column that is zero on input
    stays zero under the earlier reflectors and gets tau = 0 exactly."""
    a = RNG.standard_normal((h, w)).astype(np.float32)
    if zero_col is not None:
        a[:, zero_col] = 0.0
    vr, taus = (x.numpy() for x in hopper_ops.qr_panel_base(
        torch.from_numpy(a)))
    for ref in (pallas_ops.qr_panel_base(jnp.asarray(a), interpret=True),
                ref_blocked._panel_geqrf_base(jnp.asarray(a))):
        vr_r, tau_r = (np.asarray(x) for x in ref)
        assert tau_r.shape == taus.shape == (w,)
        np.testing.assert_allclose(taus, tau_r, atol=1e-6)
        np.testing.assert_allclose(vr, vr_r, atol=1e-4)
    assert _qr_reconstruction_err(a, vr, taus) < 5e-4
    if zero_col is not None:
        assert taus[zero_col] == 0.0 and float(tau_r[zero_col]) == 0.0


def test_qr_panel_wide_plain_matches_pallas_interpret():
    """K4's plain version at (128, 64) against the Pallas wide kernel in
    interpret mode (the same micro-blocked algorithm), with a zero column
    in the second micro-block."""
    a = RNG.standard_normal((128, 64)).astype(np.float32)
    a[:, 37] = 0.0
    vr, taus = (x.numpy() for x in hopper_ops.qr_panel_base_wide(
        torch.from_numpy(a)))
    vr_k, tau_k = (np.asarray(x) for x in pallas_ops.qr_panel_base_wide(
        jnp.asarray(a), interpret=True))
    np.testing.assert_allclose(taus, tau_k, atol=2e-6)
    np.testing.assert_allclose(vr, vr_k, atol=2e-4)
    assert taus[37] == 0.0 and tau_k[37] == 0.0


def test_qr_panel_wide_plain_matches_unblocked_base():
    """K4's plain version at (256, 128) — four micro-blocks, three
    compact-WY updates — against the reference's unblocked fori base."""
    a = RNG.standard_normal((256, 128)).astype(np.float32)
    vr, taus = (x.numpy() for x in hopper_ops.qr_panel_base_wide(
        torch.from_numpy(a)))
    vr_r, tau_r = (np.asarray(x) for x in ref_blocked._panel_geqrf_base(
        jnp.asarray(a)))
    np.testing.assert_allclose(taus, tau_r, atol=2e-6)
    np.testing.assert_allclose(vr, vr_r, atol=2e-4)
    assert _qr_reconstruction_err(a, vr, taus) < 1e-3


def test_qr_panel_nan_propagates():
    """A NaN in a column poisons that column's tau and every later
    column it reaches (no masking); the columns before stay finite."""
    a = RNG.standard_normal((96, 64))
    a[50, 5] = np.nan
    for launcher, w in ((hopper_ops.qr_panel_base, 32),
                        (hopper_ops.qr_panel_base_wide, 64)):
        vr, taus = launcher(torch.from_numpy(a[:, :w]))
        assert torch.isfinite(taus[:5]).all() and torch.isnan(taus[5:]).all()
        assert torch.isfinite(vr[:, :5]).all()


@pytest.mark.parametrize("name", _build.SOURCES)
def test_kernel_sources_and_build_flags(name):
    """Every kernel source is in the repo; the build targets sm_90a and
    never uses fast math (IEEE sqrt/division carry the NaN contracts)."""
    assert os.path.isfile(os.path.join(_build.CSRC_DIR, f"{name}.cu"))
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    path = _build._lib_path(name)
    assert path.startswith(_build.BUILD_DIR) and path == _build._lib_path(name)
