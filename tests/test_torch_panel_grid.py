"""The multi-block designs of K2 (lu_panel_base), K3 and K4
(qr_panel_base, qr_panel_base_wide) and K1 (chol_tile) on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there). What the CPU can hold is the design itself:

- the grid plan of K2, K3 and K4 (``hopper_ops.panel_grid_plan``) and
  the cluster plan of K1 (``hopper_ops.chol_tile_plan``), pure
  functions;
- what the G blocks of each kernel reduce across their row slabs after
  a grid barrier, in numpy here: K2's candidates give the same pivot in
  any reduction order, also for a tie or a NaN across slabs, and it is
  ``lu_panel_base_plain``'s; K4's per-column sums reduced in block order
  give the first reflector within the 4·ε·√H that chip_smoke.py holds
  the kernel to against ``qr_panel_base_wide_plain``, a zero column sums
  to exactly 0 and a NaN in another slab reaches every block's sum;
- the build hash, which must cover the shared header of the kernels.
"""

import math
import os
import shutil

import numpy as np
import pytest
import torch

from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.ops import _build, hopper_ops

torch.set_num_threads(2)

INT_MAX = 2 ** 31 - 1
H100_SMS = 132


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

RESERVE = hopper_ops.PANEL_SMEM_RESERVE  # K2's; rows and blocks ignore it
PLAN_SHAPES = [(h, w, s) for h in (4, 31, 32, 33, 256, 512, 1000, 4096,
                                   16384, 32768, 65536)
               for w in (4, 64, 128) for s in (4, 8) if w <= h]


@pytest.mark.parametrize("hh,w,itemsize", PLAN_SHAPES)
@pytest.mark.parametrize("n_sm", [H100_SMS, 16])
def test_plan_covers_the_panel(hh, w, itemsize, n_sm):
    """Slabs [b·R, min(H, (b+1)·R)) cover [0, H) exactly with no empty
    block; G ≤ n_sm; a resident slab fits the block's shared memory with
    the kernels' own beside it; a block gets at least PANEL_MIN_ROWS rows
    unless the panel is shorter."""
    plan = hopper_ops.panel_grid_plan(hh, w, itemsize, n_sm,
                                      hopper_ops.PANEL_SMEM_RESERVE)
    g, r = plan.blocks, plan.rows
    assert 1 <= g <= n_sm
    assert (g - 1) * r < hh <= g * r
    assert r >= min(hh, hopper_ops.PANEL_MIN_ROWS)
    covered = np.zeros(hh, dtype=int)
    for b in range(g):
        lo, hi = b * r, min(hh, (b + 1) * r)
        assert hi > lo
        covered[lo:hi] += 1
    assert (covered == 1).all()
    slab = r * w * itemsize
    assert plan.resident == (slab + hopper_ops.PANEL_SMEM_RESERVE
                             <= hopper_ops.PANEL_SMEM_LIMIT)
    assert plan.mode == ("resident" if plan.resident else "streaming")


@pytest.mark.parametrize("hh,w,itemsize,mode", [
    (16384, 128, 4, "resident"), (4096, 128, 8, "resident"),
    (32768, 128, 4, "resident"), (65536, 128, 4, "streaming"),
    (32768, 128, 8, "streaming"), (32768, 32, 4, "resident"),
    (131072, 32, 8, "streaming"), (262144, 32, 4, "streaming")])
def test_plan_modes_at_the_smoke_shapes(hh, w, itemsize, mode):
    """The main path's tallest bases (K2 at 16384 × 128 f32, K3 at
    32768 × 32 f32, K4 at 32768 × 128 f32) spread over all 132 SMs with
    resident slabs; the smoke's streaming cases stream. Each at its
    kernel's own reserve (K2's at 16384 × 128 f32 and 4096 × 128 f64)."""
    reserve = (hopper_ops.PANEL_SMEM_RESERVE
               if (hh, w) in ((16384, 128), (4096, 128))
               else hopper_ops.QR_PANEL_FIXED_ELEMS * itemsize)
    plan = hopper_ops.panel_grid_plan(hh, w, itemsize, H100_SMS, reserve)
    assert plan.mode == mode
    if hh >= 16384:
        assert plan.blocks == H100_SMS


def test_small_panels_take_few_blocks():
    plan = hopper_ops.panel_grid_plan(512, 128, 4, H100_SMS, RESERVE)
    assert plan.blocks < H100_SMS
    assert plan.rows >= hopper_ops.PANEL_MIN_ROWS
    assert hopper_ops.panel_grid_plan(20, 4, 4, H100_SMS,
                                      RESERVE).blocks == 1


def test_plan_rejects_bad_arguments():
    with pytest.raises(SlateError):
        hopper_ops.panel_grid_plan(0, 4, 4, H100_SMS, RESERVE)
    with pytest.raises(SlateError):
        hopper_ops.panel_grid_plan(64, 4, 4, 0, RESERVE)


# ---------------------------------------------------------------------------
# K1: the cluster plan
# ---------------------------------------------------------------------------

CHOL_SHAPES = [(b, s) for b in (1, 31, 32, 33, 100, 128, 165, 200, 233, 300,
                                512, 777, 1000, 1024, 2048)
               for s in (4, 8)]


@pytest.mark.parametrize("b,itemsize", CHOL_SHAPES)
def test_chol_plan_covers_every_row_once(b, itemsize):
    """The 32-row blocks are dealt cyclically (block g to CTA g mod C):
    every row of the tile lies in exactly one CTA's blocks, no CTA is
    empty, and the CTAs' row counts differ by at most one block."""
    plan = hopper_ops.chol_tile_plan(b, itemsize)
    step = plan.block_rows
    assert step == hopper_ops.CHOL_STEP == 32
    nblk = -(-b // step)
    assert 1 <= plan.ctas <= min(hopper_ops.CHOL_MAX_CLUSTER, nblk)
    covered = np.zeros(b, dtype=int)
    counts = []
    for cta in range(plan.ctas):
        blocks = plan.row_blocks(cta, b)
        assert blocks
        for lo, hi in blocks:
            assert lo % step == 0 and (lo // step) % plan.ctas == cta
            assert hi - lo == min(step, b - lo)
            covered[lo:hi] += 1
        counts.append(len(blocks))
    assert (covered == 1).all()
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("b,itemsize", CHOL_SHAPES)
def test_chol_plan_is_resident_iff_it_fits(b, itemsize):
    """One CTA exactly when the whole tile fits a block's shared memory;
    otherwise up to 8 CTAs, resident exactly when each CTA's row blocks
    and the panel copy fit."""
    plan = hopper_ops.chol_tile_plan(b, itemsize)
    limit = hopper_ops.PANEL_SMEM_LIMIT
    whole = hopper_ops.chol_tile_smem_bytes(b, itemsize, 1, True)
    assert (plan.ctas == 1) == (whole <= limit)
    used = hopper_ops.chol_tile_smem_bytes(b, itemsize, plan.ctas,
                                           plan.resident)
    assert used <= limit
    assert plan.resident == (hopper_ops.chol_tile_smem_bytes(
        b, itemsize, plan.ctas, True) <= limit)
    assert plan.mode == ("resident" if plan.resident else "streaming")


def test_chol_plan_smem_grows_with_the_tile():
    """A resident CTA holds its rows at a stride of b + 1 beside L11
    (32 × 33); the cluster's CTAs also hold the panel copy; streaming
    holds L11 only."""
    l11 = 32 * 33 * 4
    assert hopper_ops.chol_tile_smem_bytes(128, 4, 1, True) == \
        128 * 129 * 4 + l11
    assert hopper_ops.chol_tile_smem_bytes(512, 4, 8, True) == \
        (64 * 513 + 480 * 33) * 4 + l11
    assert hopper_ops.chol_tile_smem_bytes(1024, 4, 8, False) == l11


@pytest.mark.parametrize("b,itemsize,ctas,mode", [
    (1, 4, 1, "resident"), (33, 4, 1, "resident"), (128, 4, 1, "resident"),
    (200, 4, 1, "resident"), (512, 4, 8, "resident"),
    (1024, 4, 8, "streaming"), (512, 8, 8, "streaming"),
    (1024, 8, 8, "streaming")])
def test_chol_plan_modes_at_the_smoke_shapes(b, itemsize, ctas, mode):
    """chip_smoke.py's K1 cases cover each mode: one CTA holding the
    whole tile (b = 128 is the nb = 128 factor's tile), 8 CTAs holding
    their row blocks (b = 512, the nb = 512 factor's), 8 CTAs
    streaming."""
    plan = hopper_ops.chol_tile_plan(b, itemsize)
    assert (plan.ctas, plan.mode) == (ctas, mode)


def test_chol_plan_rejects_bad_arguments():
    with pytest.raises(SlateError):
        hopper_ops.chol_tile_plan(0, 4)
    with pytest.raises(SlateError):
        hopper_ops.chol_tile_plan(64, 0)


# ---------------------------------------------------------------------------
# K2: every block reduces the G candidates to the same pivot
# ---------------------------------------------------------------------------

def _beats(va, ia, vb, ib):
    """jnp.argmax's rule as a total order on (value, index)."""
    na, nb = bool(np.isnan(va)), bool(np.isnan(vb))
    if na != nb:
        return na
    if not na and va != vb:
        return bool(va > vb)
    return ia < ib


def slab_pivot(x, j, rows, order):
    """The pivot K2's blocks agree on at column step j of the column x:
    each block's first argmax of |x[i]| over its own rows i ≥ j (an empty
    candidate where it has none), the G candidates then reduced in
    ``order``."""
    hh = len(x)
    empty = (x.dtype.type(-1), INT_MAX)
    cands = []
    for b in range(-(-hh // rows)):
        bv, bi = empty
        for i in range(max(j, b * rows), min(hh, (b + 1) * rows)):
            if _beats(abs(x[i]), i, bv, bi):
                bv, bi = abs(x[i]), i
        cands.append((bv, bi))
    v, p = empty
    for k in order:
        if _beats(*cands[k], v, p):
            v, p = cands[k]
    return p


def _check_pivot_in_any_order(x, j, rows, expected):
    """The same pivot in forward, reverse and shuffled reduction orders,
    and it is the plain version's pivot of the panel x[j:]."""
    g = -(-len(x) // rows)
    rng = np.random.default_rng(g)
    orders = [range(g), range(g)[::-1]] + [rng.permutation(g)
                                           for _ in range(4)]
    pivots = {slab_pivot(x, j, rows, o) for o in orders}
    assert pivots == {expected}
    _, perm, info = hopper_ops.lu_panel_base_plain(
        torch.from_numpy(x[j:, None].copy()))
    assert int(perm[0]) + j == expected
    return int(info)


LU_CASES = ["tie_across_slab_boundary", "p_is_j", "p_in_js_slab",
            "p_in_last_ragged_slab", "nan_in_another_slab", "zero_column",
            "one_row_slabs"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", LU_CASES)
def test_lu_slab_emulation_is_bitwise_the_plain_version(case, dtype):
    """A tie or NaN across slabs, or a pivot in row j's own slab, gives
    the same pivot in any order of the G candidates, and it is the plain
    version's (61 rows in slabs of 8: the last block holds 5)."""
    x = np.clip(np.random.default_rng(LU_CASES.index(case))
                .standard_normal(61), -1, 1).astype(dtype)
    rows, j = 8, 0
    if case == "tie_across_slab_boundary":
        x[7], x[8] = -3.0, 3.0            # blocks 0 and 1: row 7 wins
        x[23], x[24] = 3.0, 3.0           # and again, not above them
        expected = 7
    elif case == "p_is_j":
        j, x[3], expected = 3, 5.0, 3
    elif case == "p_in_js_slab":
        j, x[5], expected = 2, 5.0, 5
    elif case == "p_in_last_ragged_slab":
        x[59], expected = 5.0, 59
    elif case == "nan_in_another_slab":
        j, expected = 2, 30               # row 2 is block 0's
        x[30] = x[45] = np.nan            # blocks 3 and 5: the first wins
    elif case == "zero_column":
        j, expected = 3, 3                # all-zero: the lowest row i ≥ j
        x[:] = 0.0
    else:                                 # "one_row_slabs"
        rows, j, expected = 1, 4, 10
        x[10], x[50] = -4.0, 4.0
    info = _check_pivot_in_any_order(x, j, rows, expected)
    assert info == (1 if case in ("nan_in_another_slab", "zero_column")
                    else 0)


def test_lu_slab_emulation_on_the_plan_of_a_taller_panel():
    """The plan's own slabs at 1000 rows (32 blocks of 32, the last of
    8): ties on both sides of slab boundaries above and below j = 40."""
    plan = hopper_ops.panel_grid_plan(1000, 16, 4, H100_SMS, RESERVE)
    assert (plan.blocks, plan.rows) == (32, 32)
    x = np.clip(np.random.default_rng(8).standard_normal(1000),
                -1, 1).astype(np.float32)
    x[31] = x[32] = 7.0                   # above j: not searched
    x[63] = x[64] = x[995] = -6.0         # row 63 wins
    _check_pivot_in_any_order(x, 40, plan.rows, 63)


# ---------------------------------------------------------------------------
# K4: per-column sums reduced in block order
# ---------------------------------------------------------------------------

def block_order_sums(a, j, rows):
    """σ = Σ a[i, j]² (entry 0) and p[c] = Σ a[i, j]·a[i, j + c] over
    the rows i > j, as every block of K4 reduces them: each block's
    partial over its own rows, the G partials summed in block order."""
    hh = a.shape[0]
    tot = np.zeros(a.shape[1] - j, dtype=a.dtype)
    for b in range(-(-hh // rows)):
        x = a[max(j + 1, b * rows):min(hh, (b + 1) * rows), j:]
        tot = tot + (x[:, :1] * x).sum(axis=0, dtype=a.dtype)
    return tot


@pytest.mark.parametrize("hh,w,rows,zero_col", [
    (96, 64, 7, 37),      # 14 blocks, ragged slab of 5 rows
    (200, 128, 32, None),  # the plan's slabs: 7 blocks, the last of 8 rows
    (130, 96, 1, 3),      # one row per block
    (64, 64, 64, None)])   # one block
def test_qr_wide_slab_emulation_within_the_smoke_tolerance(hh, w, rows,
                                                           zero_col):
    """The first reflector from the block-order sums (β, τ and the whole
    row 0 of R) is within chip_smoke's 4·ε·√H of the plain version's;
    a zero column's tail sums to exactly 0 in every slab order, and the
    plain version's τ there is exactly 0."""
    a = np.random.default_rng(hh * w).standard_normal((hh, w)).astype(
        np.float32)
    if zero_col is not None:
        a[:, zero_col] = 0.0
    vr_p, taus_p = (x.numpy() for x in hopper_ops.qr_panel_base_wide_plain(
        torch.from_numpy(a)))
    tot = block_order_sums(a, 0, rows)
    alpha, t = a[0, 0], np.float32
    beta = t(-np.copysign(np.sqrt(t(alpha * alpha) + tot[0]), alpha))
    tau = t((beta - alpha) / beta)
    r0 = a[0, 1:] - tau * (a[0, 1:] + tot[1:] / (alpha - beta))
    tol = 4 * np.finfo(np.float32).eps * math.sqrt(hh)
    scale = np.abs(np.triu(vr_p)).max()
    assert abs(tau - taus_p[0]) <= tol
    assert abs(beta - vr_p[0, 0]) <= tol * scale
    assert np.abs(r0 - vr_p[0, 1:]).max() <= tol * scale
    if zero_col is not None:
        assert block_order_sums(a, zero_col, rows)[0] == 0.0
        assert taus_p[zero_col] == 0.0


def test_qr_wide_plan_rows_match_the_emulation():
    assert hopper_ops.panel_grid_plan(
        200, 128, 4, H100_SMS, hopper_ops.QR_PANEL_FIXED_ELEMS * 4).rows == 32


def test_qr_wide_slab_emulation_nan_in_another_slab():
    """A NaN at row 50 (block 1 at 32-row slabs) of column 5 (row 5 is
    block 0's) reaches every block's sum for column 5 and none for
    column 0; the plain version's τ is NaN from column 5 on, finite
    before."""
    a = np.random.default_rng(3).standard_normal((96, 64)).astype(np.float32)
    a[50, 5] = np.nan
    tot = block_order_sums(a, 0, 32)
    assert np.isfinite(tot[:5]).all() and np.isnan(tot[5])
    _, taus = hopper_ops.qr_panel_base_wide_plain(torch.from_numpy(a))
    assert torch.isfinite(taus[:5]).all() and torch.isnan(taus[5:]).all()


# ---------------------------------------------------------------------------
# the build hash covers the shared header
# ---------------------------------------------------------------------------

def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """An edited or added header under csrc/ changes every library's path,
    so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    assert (csrc / "grid_panel.cuh").is_file()
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert before == {n: _build._lib_path(n) for n in _build.SOURCES}
    with open(csrc / "grid_panel.cuh", "a") as f:
        f.write("\n// edited\n")
    edited = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert all(edited[n] != before[n] for n in _build.SOURCES)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert all(added[n] != edited[n] for n in _build.SOURCES)
    assert all(os.path.dirname(p) == _build.BUILD_DIR for p in added.values())
