"""The port's two leaf kernels without a Pallas counterpart, on the CPU.

P1 ``hopper_ops.trtri_leaves`` (inverses of a stack of lower-triangular
leaves, s ≤ 64) and P2 ``hopper_ops.lu_nopiv_base`` (no-pivot LU of one
leaf) run their plain versions on a CPU tensor. Here those are held
against the reference's fused programs on the same numpy inputs: P1
against ``_trtri_unrolled_u`` under ``jax.vmap`` and P2 against
``_lu_nopiv_unblocked``. The CUDA kernels are held against the plain
versions on the card by chip_smoke.py; P1's kernel sums in another
order than its plain version (8 × 8 sub-blocks by substitution, then a
level combine), and a plain-torch model of that order is held here
against both, on ill-conditioned leaves and zero diagonals too.

Tolerances: P1 entrywise |X − X_ref|ᵢⱼ ≤ LEAF_ENTRY_C·s·ε·(|X_ref|·|L|·
|X_ref|)ᵢⱼ (the forward-error bound of triangular inversion; the sums
run in another order), with |L| taking 1 on a unit diagonal. P2 to
1e-5 (float32) / 1e-13 (float64) relative to the largest entry (the same
column loop; XLA may contract products into FMAs), info exact, NaN in
the same places.
"""

import re

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


P1_SUB = 8  # csrc/trtri_leaves.cu's stage-1 sub-block (kSub)


def _masked_add(acc, mask, term):
    """acc + term where mask holds; a term left out (NaN or not) adds
    nothing, as a sum whose range skips it."""
    return acc + torch.where(mask, term, torch.zeros((), dtype=acc.dtype))


def _p1_two_stage_model(l, unit):
    """P1's arithmetic order in plain torch (csrc/trtri_leaves.cu):
    stage 1 inverts the 8 × 8 diagonal sub-blocks by column substitution,
    X[i][j] = (δᵢⱼ − Σ_{j≤k<i} L[i][k]·X[k][j]) / L[i][i], k ascending;
    stage 2 joins neighbouring t-blocks (t = 8, 16, 32 while t < s) by
    T[r][j] = Σ_{j≤k<t} B[r][k]·iA[k][j] and X₂₁[r][j] = −Σ_{0≤k≤r}
    iC[r][k]·T[k][j], k ascending. Sums run over the triangles and the
    real indices only; blocks past s are never formed."""
    nblk, s, _ = l.shape
    x = torch.zeros_like(l)
    for r0 in range(0, s, P1_SUB):
        n = min(P1_SUB, s - r0)
        for j in range(r0, r0 + n):
            for i in range(j, r0 + n):
                acc = torch.full((nblk,), float(i == j), dtype=l.dtype)
                for k in range(j, i):
                    acc = acc - l[:, i, k] * x[:, k, j]
                x[:, i, j] = acc if unit else acc / l[:, i, i]
    t = P1_SUB
    while t < s:
        for a0 in range(0, s - t, 2 * t):
            c0 = a0 + t
            m = min(t, s - c0)
            ia, ic = x[:, a0:a0 + t, a0:a0 + t], x[:, c0:c0 + m, c0:c0 + m]
            b = l[:, c0:c0 + m, a0:a0 + t]
            tt = torch.zeros((nblk, m, t), dtype=l.dtype)
            for k in range(t):  # T[r][j] over k ≥ j
                tt = _masked_add(tt, torch.arange(t) <= k,
                                 b[:, :, k:k + 1] * ia[:, k:k + 1, :])
            acc = torch.zeros((nblk, m, t), dtype=l.dtype)
            for k in range(m):  # X₂₁[r][j] over k ≤ r
                acc = _masked_add(acc, torch.arange(m)[:, None] >= k,
                                  ic[:, :, k:k + 1] * tt[:, k:k + 1, :])
            x[:, c0:c0 + m, a0:a0 + t] = -acc
        t *= 2
    return x


def _ill_leaves(rng, nblk, s, dtype, unit, kappa=1e7):
    """Lower-triangular leaves whose off-diagonal entries are scaled up
    until the worst κ₁ of the stack reaches about ``kappa`` (s > 1), with
    1e6 junk in the strict upper triangles (never read)."""
    def draw():
        x = rng.standard_normal((nblk, s, s))
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal((nblk, s, s))
        return x
    off = np.tril(draw(), -1)
    diag = np.eye(s) if unit else np.einsum(
        "bi,ij->bij", 0.5 + np.abs(draw()[:, np.arange(s), np.arange(s)]),
        np.eye(s))

    def cond(alpha):
        return max(np.linalg.cond(d, 1) for d in alpha * off + diag)

    lo, hi = -3.0, 3.0
    for _ in range(40):  # bisection on log10 of the off-diagonal scale
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if cond(10 ** mid) < kappa else (lo, mid)
    return (10 ** lo * off + diag + 1e6 * np.triu(draw(), 1)).astype(dtype)


def _within_leaf_bound(x, ref, l, unit):
    """|x − ref| ≤ LEAF_ENTRY_C·s·ε·(|ref|·|L|·|ref|) entrywise, in
    float64, where ref is finite; non-finite in the same places."""
    s = l.shape[-1]
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(x), fin)
    ax = np.abs(np.where(fin, ref, 0)).astype(np.float64)
    lt = np.abs(np.tril(l)).astype(np.float64)
    if unit:
        lt[:, np.arange(s), np.arange(s)] = 1.0
    bound = (hopper_ops.LEAF_ENTRY_C * s * np.finfo(l.real.dtype).eps
             * (ax @ lt @ ax))
    diff = np.abs(np.where(fin, x, 0).astype(np.complex128)
                  - np.where(fin, ref, 0).astype(np.complex128))
    np.testing.assert_array_less(diff, bound + 1e-300)


@pytest.mark.parametrize("conditioning", ["well", "ill"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("s", [1, 7, 8, 33, 64])
def test_p1_two_stage_order_matches_reference(s, unit, dtype, conditioning):
    """The kernel's two-stage order (sub-block substitution, then the
    level combine) agrees with the reference's ``_trtri_unrolled_u`` under
    ``jax.vmap`` and with ``trtri_leaves_plain`` within the unchanged
    LEAF_ENTRY_C·s·ε·(|X|·|L|·|X|) bound, on well-conditioned leaves and
    on leaves with large off-diagonal entries (κ₁ up to about 1e7)."""
    rng = np.random.default_rng(300 + s)
    l = (_leaves(rng, 3, s, dtype, unit) if conditioning == "well"
         else _ill_leaves(rng, 3, s, dtype, unit))
    model = _p1_two_stage_model(torch.from_numpy(l), unit).numpy()
    assert model.dtype == l.dtype and not np.any(np.triu(model, 1))
    ref = np.asarray(jax.vmap(
        lambda d: ref_blocked._trtri_unrolled_u(d, s, unit))(jnp.asarray(l)))
    plain = hopper_ops.trtri_leaves_plain(torch.from_numpy(l), unit).numpy()
    _within_leaf_bound(model, ref, l, unit)
    _within_leaf_bound(model, plain, l, unit)


@pytest.mark.parametrize("s,p", [(33, 0), (33, 7), (33, 8), (33, 20),
                                 (33, 32), (64, 0), (64, 7), (64, 8),
                                 (64, 20), (64, 63)])
def test_p1_two_stage_order_confines_a_zero_diagonal(s, p):
    """A zero diagonal entry at p makes exactly rows ≥ p, columns ≤ p of
    the two-stage order's inverse non-finite, as in the plain version, at
    the edges of the 8 × 8 sub-blocks and of the ragged last block."""
    l = _leaves(np.random.default_rng(400 + p), 2, s, np.float32, False)
    l[1, p, p] = 0.0
    model = _p1_two_stage_model(torch.from_numpy(l), False).numpy()
    plain = hopper_ops.trtri_leaves_plain(torch.from_numpy(l)).numpy()
    bad = np.zeros((s, s), dtype=bool)
    bad[p:, :p + 1] = True
    np.testing.assert_array_equal(~np.isfinite(model[1]), bad)
    np.testing.assert_array_equal(~np.isfinite(plain[1]), bad)
    assert np.isfinite(model[0]).all() and not np.any(np.triu(model, 1))
    _within_leaf_bound(model, plain, l, False)


P1_THREADS, P1_MAX, P1_SCRATCH = 256, 64, 32 * 33  # the kernel's constants


def _p1_smem_accesses(s):
    """Every shared-memory entry that P1's kernel (csrc/trtri_leaves.cu)
    reads or writes for one leaf of size s, by the kernel's own index
    arithmetic per thread: the load, stage 1, both products of each
    combine level and the store. Returns (entries allocated, indices)."""
    ld = s | 1
    ls, xs, ts = 0, s * ld, 2 * s * ld
    tid = np.arange(P1_THREADS)
    out = []
    # 1. load, either lane order (k ≤ i covers the unit diagonal's k < i)
    e = tid[:, None] + P1_THREADS * np.arange(P1_MAX * P1_MAX // P1_THREADS)
    f, g = e % P1_MAX, e // P1_MAX
    for i, k in ((g, f), (f, g)):
        out.append(ls + (i * ld + k)[(i < s) & (k <= i)])
    # 2. stage 1: thread (b, jj) < 64 on column 8b + jj of its sub-block
    t = tid[tid < P1_MAX]
    r0, jj = t // P1_SUB * P1_SUB, t % P1_SUB
    n = np.minimum(P1_SUB, s - r0)
    for ii in range(P1_SUB):
        act = (jj < n) & (ii >= jj) & (ii < n)
        row = ls + (r0 + ii) * ld + r0
        for kk in range(ii):
            out.append((row + kk)[act & (kk >= jj)])
        out += [(row + ii)[act], (xs + (r0 + ii) * ld + r0 + jj)[act]]
    # 3. the combine levels
    lane, w = tid % 32, tid // 32
    kt = P1_SUB
    while kt < s:
        km, kts = kt // P1_SUB, kt + 1
        p, q = lane // kt, lane % kt
        a0 = 2 * kt * p
        c0 = a0 + kt
        tp = ts + p * kt * kts
        live = c0 + q < s  # (a) T[q][j] = Σ_k B[q][k]·iA[k][j]
        brow = np.where(live, ls + (c0 + q) * ld + a0, ls)
        ia = np.where(c0 < s, xs + a0 * ld + a0, xs)
        for k in range(kt):
            out.append((brow + k)[k >= w])
            for m in range(km):
                out.append((ia + k * ld + w + P1_SUB * m)[
                    k >= w + P1_SUB * m])
        for m in range(km):
            out.append((tp + q * kts + w + P1_SUB * m)[live])
        ic = np.where(c0 < s, xs + c0 * ld + c0, xs)  # (b) X₂₁ = −iC·T
        for k in range(kt):
            out.append((tp + k * kts + q)[k <= w + P1_SUB * (km - 1)])
            for m in range(km):
                r = w + P1_SUB * m
                out.append((ic + r * ld + k)[(k <= r) & (r < s - c0)])
        for m in range(km):
            r = w + P1_SUB * m
            out.append((xs + (c0 + r) * ld + a0 + q)[r < s - c0])
        kt *= 2
    i, j = np.tril_indices(s)  # the store reads X's lower triangle
    out.append(xs + i * ld + j)
    return 2 * s * ld + P1_SCRATCH, np.concatenate(out)


@pytest.mark.parametrize("s", range(1, P1_MAX + 1))
def test_p1_shared_memory_stays_in_its_allocation(s):
    """Every shared-memory entry that P1's kernel touches for a leaf of
    size s lies inside the dynamic allocation it launches with
    (smem_bytes(s): L and X, s rows of s | 1 entries each, and a 32 × 33
    scratch block), for every s: an entry past it is a fault on the card.
    Ragged last blocks (s = 34, 36, 49, …) are where a sum could reach rows
    past s; the kernel's constants are read from its source."""
    src = open(f"{_build.CSRC_DIR}/trtri_leaves.cu").read()
    for decl in (f"kMaxLeaf = {P1_MAX};", f"kSub = {P1_SUB};",
                 f"kThreads = {P1_THREADS};", "kScratch = 32 * 33;",
                 "row_stride(int s) { return s | 1; }"):
        assert decl in src, decl
    size, idx = _p1_smem_accesses(s)
    assert idx.size and idx.min() >= 0 and idx.max() < size, (idx.max(), size)


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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("s", LEAF_SIZES)
def test_lu_nopiv_inplace_on_strided_views(s, dtype):
    """The in-place form on an s × s view inside a larger matrix (row
    stride 170) and on a transposed view (column stride 150): the view
    holds the plain version's L\\U bit for bit, every entry outside it is
    untouched, and a good leaf leaves the info slot at 0."""
    rng = np.random.default_rng(800 + s)
    big = rng.standard_normal((150, 170)).astype(dtype)
    for view_of in (lambda t: t[40:40 + s, 90:90 + s],
                    lambda t: t.T[100:100 + s, 20:20 + s]):
        b = torch.from_numpy(big.copy())
        v = view_of(b)
        v.diagonal().add_(2 * s)
        want = b.clone()
        lu, plain_info = hopper_ops.lu_nopiv_base_plain(v.clone())
        view_of(want).copy_(lu)
        info = torch.zeros((), dtype=torch.int32)
        hopper_ops.lu_nopiv_base_inplace(v, info, 7)
        assert int(info) == int(plain_info) == 0
        _bitwise_equal(b.numpy(), want.numpy())


def test_lu_nopiv_inplace_info_slot():
    """A bad pivot at 1-based step p writes offset + p into a slot that
    reads 0 and leaves a slot that already holds an earlier leaf's step
    as it is; lu_nopiv_base reports p itself."""
    a = torch.from_numpy(_exact_lu_with_zero_pivot(64, 20, np.float64))
    for slot, offset, want in ((0, 0, 21), (0, 128, 149), (5, 128, 5)):
        info = torch.tensor(slot, dtype=torch.int32)
        leaf = a.clone()
        hopper_ops.lu_nopiv_base_inplace(leaf, info, offset)
        assert int(info) == want
        assert torch.equal(leaf, hopper_ops.lu_nopiv_base_plain(a)[0])
    assert int(hopper_ops.lu_nopiv_base(a)[1]) == 21


def test_leaf_launchers_refuse_bad_input():
    with pytest.raises(NotImplementedError, match="trtri_leaves"):
        hopper_ops.trtri_leaves(torch.zeros((1, 4, 4), dtype=torch.int32))
    for shape in ((4, 4), (1, 4, 5), (1, 65, 65), (1, 0, 0)):
        with pytest.raises(SlateError, match="trtri_leaves"):
            hopper_ops.trtri_leaves(torch.zeros(shape))
    with pytest.raises(NotImplementedError, match="lu_nopiv_base"):
        hopper_ops.lu_nopiv_base(torch.zeros((4, 4), dtype=torch.int32))
    for shape in ((4, 5), (65, 65), (2, 4, 4)):
        with pytest.raises(SlateError, match="lu_nopiv_base"):
            hopper_ops.lu_nopiv_base(torch.zeros(shape))
    slot = torch.zeros((), dtype=torch.int32)
    for a, info in ((torch.zeros(1, 4).expand(4, 4), slot),
                    (torch.zeros(4, 4), slot.long()),
                    (torch.zeros(4, 4), torch.zeros(1, dtype=torch.int32))):
        with pytest.raises(SlateError, match="lu_nopiv_base_inplace"):
            hopper_ops.lu_nopiv_base_inplace(a, info)


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


# ---------------------------------------------------------------------------
# P2's kernel (csrc/lu_nopiv.cu): its schedule and shared indices, modelled
# ---------------------------------------------------------------------------

def _p2_constants():
    """The kernel's layout constants, read from its source (the models
    below follow them): columns per warp, warps, the load/store tile's
    row stride and the published cols' stride."""
    src = open(f"{_build.CSRC_DIR}/lu_nopiv.cu").read()
    for decl in ("kMaxLeaf = 64;", "kWarps = kMaxLeaf / kCols;",
                 "kThreads = 32 * kWarps;", "kTile = kMaxLeaf + 1;",
                 "kLd = kMaxLeaf;", "sizeof(T) * kMaxLeaf * kTile;",
                 "bar[kMaxLeaf];", "bad_w[kWarps];",
                 "cw = w * kCols;", "r0 = lane, r1 = lane + 32;",
                 "if (threadIdx.x < s) mbar_init(bar0 + 8 * threadIdx.x, 32);",
                 "mbar_wait0(bar0 + 8 * i);",
                 "sh[k * kLd + r0] = nxt0;", "sh[k * kLd + r1] = nxt1;",
                 "mbar_arrive(bar0 + 8 * k);  // every lane",
                 "sh[(by_rows ? hi : lo) * kTile + (by_rows ? lo : hi)] = v[t];",
                 "kLoads = kMaxLeaf * kMaxLeaf / kThreads;",
                 "if (w == 0) make_col(0, 0, true);",
                 "jn = (ii + 1) % kCols;",
                 "own_next = i + 1 < s && w == (ii + 1 < kCols ? wi : wi + 1);",
                 "if (own_next) make_col(i + 1, jn, h == 0);",
                 "if (low) {", "nxt0 = r0 > k ? q0 : T(0);",
                 "col0 = sh[i * kLd + r0];", "if (w >= wi) {",
                 "ur[j] = w > wi || j > ii ? u : T(0);",
                 "sh[r0 * kTile + cw + j] = m0[j];"):
        assert decl in src, decl
    assert src.count("__syncthreads();") == 4
    cols = int(re.search(r"kCols = (\d+);", src).group(1))
    return cols, 64 // cols, 65, 64


def _p2_kernel_model(a):
    """The kernel's schedule in numpy, warp by warp in each step, with its
    own index arithmetic: each warp's registers (its column block, all 64
    rows), the pivot and row i read from the lanes that hold them, urow
    zeroed by the kernel's predicate, the col of step k made by the warp
    holding column k in step k − 1 after that column's update (once per
    k), read by the other warps from the published cols, and the column-i
    base. Products and differences rounded separately, as on the card.
    Returns (L\\U, info)."""
    cols, warps, _, ld = _p2_constants()
    s = a.shape[0]
    dt = a.dtype.type
    reg = np.zeros((64, 64), dtype=a.dtype)
    reg[:s, :s] = a
    sh = np.full(64 * ld, np.nan, dtype=a.dtype)
    rows = np.arange(64)
    nxt = np.zeros((warps, 64), dtype=a.dtype)
    first_bad = [0] * warps
    made = []

    def make_col(w, k, jk, low):
        c = w * cols + jk
        assert c == k
        d = reg[(k & 32) + (k & 31), c]
        bad = bool(np.isnan(d) or d == 0)
        if bad and first_bad[w] == 0:
            first_bad[w] = k + 1
        q = np.divide(reg[:, c], dt(1) if bad else d)
        if not low:  # rows 0..31 are not divided in the second half
            q[:32] = np.nan
        nxt[w] = np.where(rows > k, q, dt(0))
        sh[k * ld + rows] = nxt[w]
        made.append(k)

    with np.errstate(all="ignore"):
        make_col(0, 0, 0, True)
        for i in range(s):
            ii, wi = i % cols, i // cols
            jn = (ii + 1) % cols
            for w in range(warps):
                own = w == wi
                own_next = i + 1 < s and w == (wi if ii + 1 < cols else wi + 1)
                ur = np.zeros(cols, dtype=a.dtype)
                if w >= wi:
                    u = reg[(i & 32) + (i & 31), w * cols:(w + 1) * cols]
                    ur = np.where((w > wi) | (np.arange(cols) > ii), u, dt(0))
                if own:
                    col = nxt[w].copy()
                else:
                    assert i in made  # the mbarrier it waits on has arrived
                    col = sh[i * ld + rows].copy()

                def update(j):
                    c = w * cols + j
                    base = reg[:, c]
                    if own and j == ii:  # column i: col below the pivot
                        base = np.where(rows > i, col, base)
                    reg[:, c] = np.subtract(base, np.multiply(col, ur[j]))

                update(jn)
                if own_next:
                    make_col(w, i + 1, jn, i < 32)
                for j in range(cols):
                    if j != jn:
                        update(j)
    assert made == list(range(s))
    return reg[:s, :s].copy(), next((b for b in first_bad if b), 0)


def _adversarial_leaf(rng, s, dtype, case):
    """A dominant leaf with exact zeros of both signs in a fifth of its
    entries each, then the case's poison: "inf" ±Inf at chosen entries,
    "nan" NaN at one, "zero_pivot" an exact zero pivot at step s // 2
    (integer factors), "signed_zeros" nothing more."""
    if case == "zero_pivot":
        return _exact_lu_with_zero_pivot(s, s // 2, dtype)
    a = rng.integers(-3, 4, (s, s)).astype(np.float64)
    pick = rng.random((s, s))
    a[pick < 0.2] = -0.0
    a[(pick >= 0.2) & (pick < 0.4)] = 0.0
    a[np.arange(s), np.arange(s)] = 4.0 * s * rng.choice([-1, 1], s)
    if case == "inf" and s > 1:
        a[s - 1, 0] = np.inf
        a[0, s - 1] = -np.inf
    if case == "nan":
        a[s // 2, s // 3] = np.nan
    return a.astype(dtype)


def _bitwise_equal(x, y):
    """NaN in the same places, and every other entry equal bit for bit
    (the sign of a zero included)."""
    nan = np.isnan(x)
    np.testing.assert_array_equal(nan, np.isnan(y))
    xb = x.view(np.uint32 if x.dtype == np.float32 else np.uint64)
    yb = y.view(xb.dtype)
    np.testing.assert_array_equal(xb[~nan], yb[~nan])


@pytest.mark.parametrize("case", ["signed_zeros", "inf", "nan",
                                  "zero_pivot"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("s", [1, 7, 16, 17, 33, 64])
def test_p2_kernel_schedule_is_bitwise_the_plain_version(s, dtype, case):
    """The kernel's schedule (registers by lane, published snapshots, the
    keep predicate, the shuffled column entry) gives bit for bit the plain
    version's L\\U and info on adversarial leaves: signed zeros, whose
    sign the 0·x terms flip, ±Inf and NaN that spread, and a zero pivot."""
    a = _adversarial_leaf(np.random.default_rng(700 + s), s, dtype, case)
    model, info = _p2_kernel_model(a)
    plain, plain_info = hopper_ops.lu_nopiv_base_plain(torch.from_numpy(a))
    _bitwise_equal(model, plain.numpy())
    assert info == int(plain_info)
    if case == "zero_pivot" and s > 1:
        assert info == s // 2 + 1


@pytest.mark.parametrize("s", range(1, 65))
def test_p2_shared_memory_and_barriers_stay_in_their_allocation(s):
    """Every shared entry P2's kernel touches for a leaf of size s lies in
    its allocation (sh: 64 rows of kTile), and every entry it reads was
    written before in the same phase: the load tile (all 64 × 64 entries,
    0 outside the leaf),
    the published cols (col of step k at k·kLd + r, for every row r < 64)
    and the store tile (all 64 rows of every warp's columns). mbarrier
    k < s is initialised with count 32 and arrived on by the 32 lanes of
    one warp once (the col of step k is made once), so no wait hangs;
    none past s is touched.
    Constants and index expressions from the source."""
    cols, warps, tile, ld = _p2_constants()
    size = 64 * tile
    w, lane = np.divmod(np.arange(32 * warps), 32)
    t = np.arange(64 * 64 // (32 * warps))
    e = np.arange(32 * warps)[:, None] + t * 32 * warps
    hi, lo = e // 64, e % 64
    load = set()
    for r, c in ((hi, lo), (lo, hi)):  # either lane order
        load |= set((r * tile + c).ravel().tolist())
        assert len(set((r * tile + c).ravel().tolist())) == 64 * 64
    rr, cc = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    for r in (lane, lane + 32):  # registers read the tile where r, c < s
        c = w[:, None] * cols + np.arange(cols)
        read = (r[:, None] * tile + c)[(r[:, None] < s) & (c < s)]
        assert set(read.tolist()) <= load
    published = {}
    for k in range(s):  # make_col(k): the warp holding column k
        owner = k // cols
        assert owner * cols <= k < s
        written = np.concatenate([k * ld + lane[w == owner],
                                  k * ld + lane[w == owner] + 32])
        assert np.unique(written).size == 64
        published[k] = set(written.tolist())
    for i in range(s):  # every other warp reads rows r0, r1 of step i
        read = np.concatenate([i * ld + lane, i * ld + lane + 32])
        assert set(read.tolist()) <= published[i]
    cols_used = set().union(*published.values())
    store = set()
    for r in (lane, lane + 32):
        store |= set((r[:, None] * tile + w[:, None] * cols
                      + np.arange(cols)).ravel().tolist())
    assert set((rr * tile + cc).ravel().tolist()) <= store  # the copy-out
    every = load | cols_used | store
    assert min(every) >= 0 and max(every) < size
    assert 64 * tile * 8 + 64 * 8 + warps * 4 <= 48 * 1024  # static, f64
