"""K5 of the port (``hopper_ops.herk_lower_update``) and the
``blocked.herk_lower_rec`` dispatch that reaches it, on the CPU.

On a CPU tensor the launcher runs its plain version (the Pallas kernel's
step per lower 128 × 128 tile pair, in place). It is held against the
reference's Pallas kernel in interpret mode at tests/test_pallas.py's
(n, k, block) cases, and against the reference's ``herk_lower_rec`` (its
jnp recursion: the Pallas route is opt-in) at ragged and float64 shapes,
on the same numpy inputs. The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py.

Tolerances: the lower triangle to atol 1e-4 / rtol 2e-6 in float32 (the
bounds tests/test_pallas.py holds the Pallas kernel to; summation order
differs) and to 1e-12 relative in float64. The strict upper triangle of
C must be bitwise unchanged: the port masks its diagonal tiles, where
the Pallas kernel updates them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops import blocked as ref_blocked
from slate_tpu.ops import pallas_ops
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.ops import blocked, hopper_ops

torch.set_num_threads(2)

RNG = np.random.default_rng(53)


def _operands(n, k, dtype):
    return (RNG.standard_normal((n, n)).astype(dtype),
            RNG.standard_normal((n, k)).astype(dtype))


def _lower(x):
    return np.tril(x)


def _assert_upper_kept(out, c):
    iu = np.triu_indices(c.shape[0], 1)
    np.testing.assert_array_equal(out[iu], c[iu])


@pytest.mark.parametrize("n,k,block", [(256, 128, 128), (512, 256, 128),
                                       (384, 128, 128)])
def test_herk_plain_matches_pallas_interpret(n, k, block):
    c, a = _operands(n, k, np.float32)
    ref = np.asarray(pallas_ops.herk_lower_update(
        jnp.asarray(c), jnp.asarray(a), block, interpret=True, force=True))
    ct = torch.from_numpy(c.copy())
    out = hopper_ops.herk_lower_update(ct, torch.from_numpy(a))
    assert out is ct  # in place, as the Pallas call aliases C
    got = out.numpy()
    np.testing.assert_allclose(_lower(got), _lower(ref), atol=1e-4,
                               rtol=2e-6)
    _assert_upper_kept(got, c)


@pytest.mark.parametrize("n,k,dtype", [(300, 100, np.float32),
                                       (300, 100, np.float64),
                                       (129, 1, np.float64),
                                       (200, 700, np.float64)])
def test_herk_lower_rec_matches_reference_ragged(n, k, dtype):
    """Ragged n and k (no multiple of the 128 tile) and float64 through
    the port's herk_lower_rec (K5) against the reference's recursion."""
    c, a = _operands(n, k, dtype)
    ref = np.asarray(ref_blocked.herk_lower_rec(jnp.asarray(c),
                                                jnp.asarray(a)))
    got = blocked.herk_lower_rec(torch.from_numpy(c.copy()),
                                 torch.from_numpy(a)).numpy()
    if dtype == np.float32:
        np.testing.assert_allclose(_lower(got), _lower(ref), atol=1e-4,
                                   rtol=2e-6)
    else:
        scale = np.abs(ref).max()
        assert np.abs(_lower(got) - _lower(ref)).max() < 1e-12 * scale
    _assert_upper_kept(got, c)


def test_herk_lower_rec_updates_a_strided_view_in_place():
    """C = big[h:, h:] and A = big[h:, :h], as the recursive potrf hands
    them over: K5 writes C through its row stride and returns it; every
    entry of big outside C's lower triangle is bitwise unchanged."""
    h, n = 150, 400
    big = RNG.standard_normal((n, n))
    ref = np.asarray(ref_blocked.herk_lower_rec(jnp.asarray(big[h:, h:]),
                                                jnp.asarray(big[h:, :h])))
    bt = torch.from_numpy(big.copy())
    view = bt[h:, h:]
    out = blocked.herk_lower_rec(view, bt[h:, :h])
    assert out.data_ptr() == view.data_ptr() and out.stride() == (n, 1)
    got = bt.numpy()
    assert np.abs(_lower(got[h:, h:]) - _lower(ref)).max() < 1e-12 * \
        np.abs(ref).max()
    keep = np.ones((n, n), bool)
    keep[h:, h:] = np.triu(np.ones((n - h, n - h), bool), 1)
    np.testing.assert_array_equal(got[keep], big[keep])


def test_herk_lower_rec_with_b_or_complex_takes_the_recursion(monkeypatch):
    """The reference's gates: with b given, or a complex dtype, the 2×2
    recursion runs (a new tensor) and K5 is never called."""
    def k5(*_):
        raise AssertionError("K5 called")
    monkeypatch.setattr(hopper_ops, "herk_lower_update", k5)
    n, k = 160, 40
    c = RNG.standard_normal((n, n)) + 1j * RNG.standard_normal((n, n))
    a = RNG.standard_normal((n, k)) + 1j * RNG.standard_normal((n, k))
    ct = torch.from_numpy(c.copy())
    out = blocked.herk_lower_rec(ct, torch.from_numpy(a), base=64)
    assert out.data_ptr() != ct.data_ptr()
    ref = np.asarray(ref_blocked.herk_lower_rec(jnp.asarray(c),
                                                jnp.asarray(a), base=64))
    assert np.abs(_lower(out.numpy()) - _lower(ref)).max() < 1e-12 * \
        np.abs(ref).max()
    cr, ar = _operands(n, k, np.float64)
    out = blocked.herk_lower_rec(torch.from_numpy(cr), torch.from_numpy(ar),
                                 torch.from_numpy(ar), base=64).numpy()
    np.testing.assert_allclose(_lower(out), _lower(cr - ar @ ar.T),
                               rtol=1e-12, atol=1e-12)


def test_herk_nan_row_poisons_its_row_and_column_only():
    """A NaN in row r of A makes row r and column r of the lower result
    NaN; every other entry stays finite."""
    n, k, r = 300, 50, 137
    c, a = _operands(n, k, np.float64)
    a[r, 7] = np.nan
    got = hopper_ops.herk_lower_update(torch.from_numpy(c.copy()),
                                       torch.from_numpy(a)).numpy()
    low = np.tril(np.ones((n, n), bool))
    poisoned = np.zeros((n, n), bool)
    poisoned[r, :] = poisoned[:, r] = True
    assert np.isnan(got[low & poisoned]).all()
    assert np.isfinite(got[low & ~poisoned]).all()
    _assert_upper_kept(got, c)


def test_herk_cpu_runs_count_no_launch_and_gates_raise():
    before = hopper_ops.LAUNCHES["herk_lower_update"]
    c, a = _operands(64, 8, np.float32)
    hopper_ops.herk_lower_update(torch.from_numpy(c), torch.from_numpy(a))
    assert hopper_ops.LAUNCHES["herk_lower_update"] == before
    with pytest.raises(NotImplementedError, match="real float32/float64"):
        hopper_ops.herk_lower_update(torch.zeros((4, 4), dtype=torch.half),
                                     torch.zeros((4, 2), dtype=torch.half))
    with pytest.raises(SlateError, match="needs C"):
        hopper_ops.herk_lower_update(torch.zeros((4, 5)), torch.zeros((4, 2)))
    with pytest.raises(SlateError, match="dtypes differ"):
        hopper_ops.herk_lower_update(torch.zeros((4, 4)),
                                     torch.zeros((4, 2), dtype=torch.float64))


def test_herk_off_the_cpu_never_runs_the_plain_version(monkeypatch):
    """A tensor on another device than the CPU reaches the launch path,
    which launches or raises; the plain version never runs, and neither
    does the recursion (no CPU detour, no fallback)."""
    def plain(*_):
        raise AssertionError("plain version ran")
    monkeypatch.setattr(hopper_ops, "herk_lower_update_plain", plain)
    c = torch.empty((256, 256), device="meta")
    a = torch.empty((256, 64), device="meta")
    with pytest.raises(SlateError, match="unsupported device"):
        blocked.herk_lower_rec(c, a)
    with pytest.raises(SlateError, match="unsupported device"):
        hopper_ops.herk_lower_update(torch.zeros((4, 4)),
                                     torch.empty((4, 2), device="meta"))
