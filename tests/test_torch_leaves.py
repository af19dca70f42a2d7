"""The port's two leaf kernels without a Pallas counterpart, on the CPU.

P1 ``hopper_ops.trtri_leaves`` (inverses of a stack of lower-triangular
leaves, s ≤ 64) and P2 ``hopper_ops.lu_nopiv_base`` (no-pivot LU of one
leaf) run their plain versions on a CPU tensor. Here those are held
against the reference's fused programs on the same numpy inputs: P1
against ``_trtri_unrolled_u`` under ``jax.vmap`` and P2 against
``_lu_nopiv_unblocked``. The CUDA kernels are held against the plain
versions on the card by chip_smoke.py.

Tolerances: P1 entrywise |X − X_ref|ᵢⱼ ≤ LEAF_ENTRY_C·s·ε·(|X_ref|·|L|·
|X_ref|)ᵢⱼ (the forward-error bound of triangular inversion; the sums
run in another order), with |L| taking 1 on a unit diagonal. P2 to
1e-5 (float32) / 1e-13 (float64) relative to the largest entry (the same
column loop; XLA may contract products into FMAs), info exact, NaN in
the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import lu as ref_lu
from slate_tpu.ops import blocked as ref_blocked
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.ops import _build, blocked, hopper_ops

torch.set_num_threads(2)

LEAF_SIZES = [1, 7, 33, 64]
P2_TOL = {np.float32: 1e-5, np.float64: 1e-13}


def _leaves(rng, nblk, s, dtype, unit):
    """A (nblk, s, s) stack of well-conditioned lower-triangular leaves
    with 1e6 junk in the strict upper triangles (never read)."""
    def draw():
        x = rng.standard_normal((nblk, s, s))
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal((nblk, s, s))
        return x
    off = np.tril(draw(), -1) / (s if unit else np.sqrt(s))
    diag = 2.0 + np.abs(draw()[:, np.arange(s), np.arange(s)])
    l = off + np.einsum("bi,ij->bij", diag, np.eye(s))
    return (l + 1e6 * np.triu(draw(), 1)).astype(dtype)


def _leaf_bound(x, l, unit):
    """LEAF_ENTRY_C·s·ε·(|X|·|L|·|X|) with the lower triangle of L."""
    s = l.shape[-1]
    lt = np.abs(np.tril(l))
    if unit:
        lt[:, np.arange(s), np.arange(s)] = 1.0
    ax = np.abs(x)
    eps = np.finfo(l.real.dtype).eps
    return hopper_ops.LEAF_ENTRY_C * s * eps * (ax @ lt @ ax)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("s", LEAF_SIZES)
def test_trtri_leaves_plain_matches_reference(s, unit, dtype):
    rng = np.random.default_rng(100 + s)
    l = _leaves(rng, 3, s, dtype, unit)
    ref = np.asarray(jax.vmap(
        lambda d: ref_blocked._trtri_unrolled_u(d, s, unit))(jnp.asarray(l)))
    out = hopper_ops.trtri_leaves(torch.from_numpy(l), unit).numpy()
    assert out.dtype == l.dtype and out.shape == l.shape
    assert not np.any(np.triu(out, 1))
    np.testing.assert_array_less(np.abs(out - ref),
                                 _leaf_bound(ref, l, unit) + 1e-300)


def test_trtri_leaves_zero_diagonal_is_confined():
    """A zero diagonal entry at p makes exactly the lower entries in rows
    ≥ p and columns ≤ p non-finite; the strict upper triangle stays 0."""
    s, p = 33, 20
    l = _leaves(np.random.default_rng(3), 2, s, np.float64, False)
    l[1, p, p] = 0.0
    out = hopper_ops.trtri_leaves(torch.from_numpy(l)).numpy()
    assert np.isfinite(out[0]).all()
    bad = np.zeros((s, s), dtype=bool)
    bad[p:, :p + 1] = True
    np.testing.assert_array_equal(~np.isfinite(out[1]), bad)
    assert not np.any(np.triu(out[1], 1))


def test_trtri_leaves_strided_and_conjugate_views():
    """The diagonal leaves of a matrix handed over as one strided view, a
    transposed view and a conjugate-transposed view give the inverses of
    the same leaves made contiguous."""
    rng = np.random.default_rng(4)
    n, s = 128, 64
    big = torch.from_numpy(_leaves(rng, 1, n, np.complex128, False)[0])
    view = blocked._blocks(big, 0, s, s)
    assert view.data_ptr() == big.data_ptr() and not view.is_contiguous()
    ref = hopper_ops.trtri_leaves_plain(view.contiguous())
    torch.testing.assert_close(hopper_ops.trtri_leaves(view), ref, rtol=0,
                               atol=0)
    up = big[:s, :s].mH.contiguous()  # upper: its .mH is lower
    for v in (up.mH[None], up.mT[None]):
        assert v.is_conj() or not v.is_contiguous()
        torch.testing.assert_close(
            hopper_ops.trtri_leaves(v),
            hopper_ops.trtri_leaves(v.resolve_conj().contiguous()),
            rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1, 1), (7, 7), (33, 33), (64, 64),
                                   (50, 20), (20, 50)])
def test_lu_nopiv_plain_matches_reference(shape, dtype):
    rng = np.random.default_rng(200 + shape[0] + shape[1])
    a = rng.standard_normal(shape)
    k = min(shape)
    a[np.arange(k), np.arange(k)] += max(shape)
    a = a.astype(dtype)
    ref, ref_info = ref_lu._lu_nopiv_unblocked(jnp.asarray(a))
    lu, info = hopper_ops.lu_nopiv_base_plain(torch.from_numpy(a))
    assert info.dtype == torch.int32 and info.ndim == 0
    assert int(info) == int(ref_info) == 0
    ref = np.asarray(ref)
    assert np.abs(lu.numpy() - ref).max() <= P2_TOL[dtype] * np.abs(ref).max()


def _exact_lu_with_zero_pivot(s, zero_at, dtype):
    """A = L·U with small integer entries, unit-diagonal U except
    U[zero_at, zero_at] = 0 and L zero below it: every step is exact, so
    the pivot of step ``zero_at`` is exactly 0 (info = zero_at + 1) and
    the factors after it are L and U again."""
    rng = np.random.default_rng(s)
    lo = np.tril(rng.integers(-1, 2, (s, s)), -1) + np.eye(s)
    up = np.triu(rng.integers(-1, 2, (s, s)), 1) + np.eye(s)
    up[zero_at, zero_at] = 0
    lo[zero_at + 1:, zero_at] = 0
    return (lo @ up).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lu_nopiv_zero_pivot_and_nan_info(dtype):
    """A zero pivot at step 20 gives info = 21 (that step divides by 1); a
    NaN at (5, 3) poisons row 5 at step 3 and its pivot sets info = 6;
    NaN in the same places as the reference's loop."""
    a = _exact_lu_with_zero_pivot(64, 20, dtype)
    ref, ref_info = ref_lu._lu_nopiv_unblocked(jnp.asarray(a))
    lu, info = hopper_ops.lu_nopiv_base(torch.from_numpy(a))
    assert int(info) == int(ref_info) == 21
    np.testing.assert_array_equal(lu.numpy(), np.asarray(ref))
    b = np.random.default_rng(9).standard_normal((64, 64)) + 64 * np.eye(64)
    b[5, 3] = np.nan
    b = b.astype(dtype)
    ref, ref_info = ref_lu._lu_nopiv_unblocked(jnp.asarray(b))
    lu, info = hopper_ops.lu_nopiv_base(torch.from_numpy(b))
    ref, lu = np.asarray(ref), lu.numpy()
    assert int(info) == int(ref_info) == 6
    np.testing.assert_array_equal(np.isnan(lu), np.isnan(ref))
    fin = ~np.isnan(ref)
    assert np.abs(lu[fin] - ref[fin]).max() <= (
        P2_TOL[dtype] * np.abs(ref[fin]).max())


def test_leaf_launchers_refuse_bad_input():
    with pytest.raises(NotImplementedError, match="trtri_leaves"):
        hopper_ops.trtri_leaves(torch.zeros((1, 4, 4), dtype=torch.int32))
    for shape in ((4, 4), (1, 4, 5), (1, 65, 65), (1, 0, 0)):
        with pytest.raises(SlateError, match="trtri_leaves"):
            hopper_ops.trtri_leaves(torch.zeros(shape))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        hopper_ops.lu_nopiv_base(torch.zeros((4, 4), dtype=torch.complex128))
    for shape in ((4, 5), (65, 65), (2, 4, 4)):
        with pytest.raises(SlateError, match="lu_nopiv_base"):
            hopper_ops.lu_nopiv_base(torch.zeros(shape))


def test_cpu_calls_never_reach_the_build(monkeypatch):
    """On CPU tensors both launchers run their plain versions: no kernel
    is built or loaded and no launch is counted."""
    def no_build(name):
        raise AssertionError(f"the CPU path tried to load {name}")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "_compile", no_build)
    hopper_ops.reset_launches()
    l = torch.from_numpy(_leaves(np.random.default_rng(5), 2, 16,
                                 np.float32, False))
    torch.testing.assert_close(hopper_ops.trtri_leaves(l),
                               hopper_ops.trtri_leaves_plain(l), rtol=0,
                               atol=0)
    a = torch.eye(16, dtype=torch.float64) * 3 + 0.1
    lu, info = hopper_ops.lu_nopiv_base(a)
    ref = hopper_ops.lu_nopiv_base_plain(a)
    assert torch.equal(lu, ref[0]) and int(info) == int(ref[1]) == 0
    blocked.trtri_lower_batched(torch.tril(torch.ones(128, 128)) + 128
                                * torch.eye(128))
    assert not any(hopper_ops.LAUNCHES.values())


@pytest.mark.parametrize("launcher,shape", [
    (hopper_ops.trtri_leaves, (2, 8, 8)), (hopper_ops.lu_nopiv_base, (8, 8)),
    (blocked.trtri_lower_batched, (256, 256)),
    (blocked.trtri_lower_rec, (100, 100))])
def test_non_cpu_tensor_reaches_the_leaf_kernels(launcher, shape):
    """Off the CPU the leaf launchers launch or raise, and the trtri
    helpers of the factors reach P1: a tensor on a device that is
    neither gets an error, not a plain version."""
    hopper_ops.reset_launches()
    with pytest.raises(SlateError, match="unsupported device"):
        launcher(torch.empty(shape, device="meta"))
    assert not any(hopper_ops.LAUNCHES.values())


def test_trtri_helpers_hand_p1_their_leaves_without_copies(monkeypatch):
    """trtri_lower_batched hands all its leaves to P1 at once as a view of
    the matrix; the recursion hands every base to P1 alone. No Python row
    loop is left between a factor and P1."""
    calls = []
    plain = hopper_ops.trtri_leaves

    def record(l, unit=False):
        calls.append((tuple(l.shape), l.data_ptr()))
        return plain(l, unit)

    monkeypatch.setattr(hopper_ops, "trtri_leaves", record)
    l = torch.tril(torch.rand(256, 256, dtype=torch.float64)) \
        + 256 * torch.eye(256, dtype=torch.float64)
    x = blocked.trtri_lower_batched(l)
    assert calls == [((4, 64, 64), l.data_ptr())]
    torch.testing.assert_close(x @ l, torch.eye(256, dtype=torch.float64),
                               rtol=0, atol=1e-13)
    calls.clear()
    blocked.trtri_lower_rec(l[:100, :100])
    assert [c[0] for c in calls] == [(1, 56, 56), (1, 44, 44)]
    assert not hasattr(blocked, "_trtri_leaves")
