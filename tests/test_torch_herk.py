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

The kernel's tile plan (``hopper_ops.herk_plan``) and its float32
arithmetic are held here too: the plan at the path's shapes and at
ragged and tiny n, and a numpy emulation of the 3×TF32 split (TF32
rounded to nearest, ties away, by a bit mask; float32 partials of
8-deep k-steps, each an exact float64 product rounded once) against the
entrywise contract ``HERK_ENTRY_C``, which 1×TF32 must fail.
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


# ---------------------------------------------------------------------------
# K5's tile plan and its 3×TF32 precision contract
# ---------------------------------------------------------------------------

H100_SMS = 132
SM_SMEM = 233_472  # 228 KB: an SM's shared memory, all blocks together


@pytest.mark.parametrize("n,itemsize,tile", [
    (8192, 4, 128), (4096, 4, 128), (2048, 4, 64),   # the path's shapes
    (8192, 8, 128), (2048, 8, 64), (16384, 4, 128),
    (1, 4, 64), (1, 8, 64), (129, 4, 64), (1000, 8, 64), (3000, 4, 64),
    (3968, 4, 64), (3969, 8, 128)])
def test_herk_plan_shapes(n, itemsize, tile):
    """128-wide tiles exactly where their pairs fill HERK_WIDE_WAVES waves
    of the SMs; the block's shared memory fits a block and its blocks per
    SM fit the SM; 8 warps of 64 × 32 or 4 of 32 × 32."""
    plan = hopper_ops.herk_plan(n, itemsize, H100_SMS)
    assert plan.tile == tile
    assert plan.warps == (8 if tile == 128 else 4)
    nt = -(-n // tile)
    assert plan.pairs(n) == nt * (nt + 1) // 2
    row = (hopper_ops.HERK_CHUNK_BYTES // itemsize
           + hopper_ops.HERK_PAD) * itemsize
    assert plan.smem_bytes == plan.stages * 2 * tile * row
    assert plan.smem_bytes <= hopper_ops.PANEL_SMEM_LIMIT
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= SM_SMEM
    # a 16-byte cp.async piece never straddles a padded shared row
    assert row % 16 == 0 and hopper_ops.HERK_CHUNK_BYTES % 16 == 0


def test_herk_plan_fills_the_card_at_n_2048():
    """n = 2048, four of the seven launches of the nb = 128 potrf: the
    64-wide pairs fill every resident block slot of 132 SMs at least
    once (one full wave), where 128-wide pairs would be 136 for 132
    single-block SMs."""
    plan = hopper_ops.herk_plan(2048, 4, H100_SMS)
    assert plan.pairs(2048) >= H100_SMS * plan.blocks_per_sm
    wide = hopper_ops.herk_plan(4096, 4, H100_SMS)
    assert wide.pairs(4096) >= hopper_ops.HERK_WIDE_WAVES * H100_SMS


@pytest.mark.parametrize("args", [(0, 4, 132), (64, 16, 132), (64, 4, 0)])
def test_herk_plan_rejects_bad_arguments(args):
    with pytest.raises(SlateError, match="herk_plan"):
        hopper_ops.herk_plan(*args)


def _tf32_rna(x):
    """float32 → TF32 (10 mantissa bits), to nearest with ties away from
    zero, by the kernel's bit mask."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    big = _tf32_rna(x)
    with np.errstate(invalid="ignore"):
        return big, _tf32_rna(x - big)


def _emulated_update(c, a, passes):
    """C − A·Aᵀ as the kernel sums it: per 8-deep k-step, the products of
    ``passes`` (pairs of row operands) each an exact float64 chunk,
    rounded into a fresh float32 partial in that order, the partial
    added to a float32 accumulator."""
    n, k = a.shape
    chunks = [np.einsum("ick,jck->cij", x.astype(np.float64).reshape(
        n, k // 8, 8), y.astype(np.float64).reshape(n, k // 8, 8))
        for x, y in passes]
    acc = np.zeros((n, n), np.float32)
    with np.errstate(invalid="ignore"):
        for ci in range(k // 8):
            p = np.float32(chunks[0][ci])
            for ch in chunks[1:]:
                p = np.float32(p.astype(np.float64) + ch[ci])
            acc = acc + p
    return c - acc


def _entry_ratio(got, c, a, keep=None):
    """The worst |got − C₆₄|ᵢⱼ / (ε·(|C| + |A|·|A|ᵀ)ᵢⱼ) on the lower
    triangle (and ``keep``), ε of float32."""
    a64 = a.astype(np.float64)
    ref = c.astype(np.float64) - a64 @ a64.T
    denom = np.finfo(np.float32).eps * (np.abs(c.astype(np.float64))
                                        + np.abs(a64) @ np.abs(a64).T)
    mask = np.tril(np.ones(c.shape, bool))
    if keep is not None:
        mask &= keep
    return (np.abs(got.astype(np.float64) - ref) / denom)[mask].max()


@pytest.fixture(scope="module")
def tf32_sample():
    """64 rows of A at k = 8192 (the widest update of the nb = 128
    potrf at n = 16384) and a 64 × 64 block of C."""
    rng = np.random.default_rng(71)
    return (rng.standard_normal((64, 64)).astype(np.float32),
            rng.standard_normal((64, 8192)).astype(np.float32))


def test_herk_3xtf32_meets_the_entrywise_contract(tf32_sample):
    """The kernel's split, small terms first, meets HERK_ENTRY_C (it reads
    a few ε), and beats the chip_smoke global tolerance by far."""
    c, a = tf32_sample
    big, small = _split(a)
    got = _emulated_update(c, a, [(small, big), (big, small), (big, big)])
    ratio = _entry_ratio(got, c, a)
    assert ratio <= hopper_ops.HERK_ENTRY_C / 2, ratio
    # the split is exact to about 2⁻²² of |a|
    assert np.abs((big.astype(np.float64) + small) - a).max() <= \
        2.0 ** -22 * np.abs(a).max()


def test_herk_1xtf32_fails_the_entrywise_contract(tf32_sample):
    """One TF32 pass (no small terms) must fail the same check that
    3×TF32 passes: the contract tells full float32 from TF32."""
    c, a = tf32_sample
    big, _ = _split(a)
    ratio = _entry_ratio(_emulated_update(c, a, [(big, big)]), c, a)
    assert ratio > hopper_ops.HERK_ENTRY_C, ratio


@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan])
def test_herk_3xtf32_nonfinite_row_stays_in_its_row_and_column(value):
    """An Inf (its small part is Inf − Inf = NaN) or a NaN in row r of A
    leaves row r and column r of the lower result non-finite and every
    other lower entry finite and within the entrywise contract."""
    rng = np.random.default_rng(72)
    n, k, r = 48, 64, 17
    c = rng.standard_normal((n, n)).astype(np.float32)
    a = rng.standard_normal((n, k)).astype(np.float32)
    a[r, 5] = value
    big, small = _split(a)
    assert np.isnan(small[r, 5]) and (np.isnan(big[r, 5])
                                      or big[r, 5] == value)
    got = _emulated_update(c, a, [(small, big), (big, small), (big, big)])
    low = np.tril(np.ones((n, n), bool))
    hit = np.zeros((n, n), bool)
    hit[r, :] = hit[:, r] = True
    assert not np.isfinite(got[low & hit]).any()
    assert np.isfinite(got[low & ~hit]).all()
    assert _entry_ratio(got, c, a, keep=~hit) <= hopper_ops.HERK_ENTRY_C
