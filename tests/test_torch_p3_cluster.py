"""P3's cluster design on the CPU: the plan ``lu_panel_batched_plan`` and
a plain-torch emulation of the kernel's slot scheme, held bit for bit to
``lu_panel_batched_plain``.

The kernel (csrc/lu_panel_batched.cu) runs only on the card. What it
does differently from the plain version is held here: row i of a chunk
is CTA i mod C's slot i // C and never moves; a pivot step exchanges the
positions of two slots instead of swapping rows; every CTA publishes its
best candidate under jnp.argmax's rule on (|value|, position) and every
CTA reduces the C candidates itself; at the end each slot is scattered
to lu[position] and perm[position] = the slot's row. The emulation
replays that with the plain version's arithmetic (an IEEE division, a
rounded product, then a rounded difference), so lu, perm and info must
be bitwise equal: NaN in the same places, perm and info exact.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.ops import _build, hopper_ops

H100_SMS = 132
INT_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(32, 512, 512, 4), (16, 1024, 512, 4), (8, 1024, 512, 4),
               (1, 1024, 512, 4), (32, 512, 512, 8), (16, 1024, 512, 8),
               (1, 1000, 300, 4), (3, 777, 129, 8), (5, 45, 45, 4),
               (2, 64, 1, 8), (8, 512, 512, 4), (4, 1000, 64, 4),
               (4, 300, 40, 8), (1, 1744, 512, 4), (1, 1745, 512, 4),
               (64, 64, 32, 4), (1, 20000, 16, 8)]


@pytest.mark.parametrize("bsz,hh,w,itemsize", PLAN_SHAPES)
def test_p3_plan_deals_every_row_to_one_cta(bsz, hh, w, itemsize):
    """Every row of a chunk belongs to exactly one CTA, every CTA owns at
    least one, the fullest owns ``rows``; C is one of P3_CLUSTERS; the
    shared memory fits a block and resident slots are counted in it."""
    plan = hopper_ops.lu_panel_batched_plan(bsz, hh, w, itemsize, H100_SMS)
    assert plan.ctas in hopper_ops.P3_CLUSTERS
    owned = [list(plan.slots(r, hh)) for r in range(plan.ctas)]
    assert sorted(i for rows in owned for i in rows) == list(range(hh))
    assert min(map(len, owned)) >= 1
    assert max(map(len, owned)) == plan.rows == -(-hh // plan.ctas)
    assert all(i % plan.ctas == r for r, rows in enumerate(owned)
               for i in rows)
    assert plan.smem_bytes <= hopper_ops.PANEL_SMEM_LIMIT
    assert plan.smem_bytes == hopper_ops.lu_panel_batched_smem_bytes(
        hh, w, itemsize, plan.ctas, plan.resident)
    slots = plan.rows * w * itemsize
    assert plan.resident == (plan.smem_bytes >= slots + w * itemsize)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
def test_p3_plan_is_resident_iff_the_slots_fit(ctas, itemsize):
    """At every cluster size the resident bytes never exceed 227 KB, and
    a plan streams only where resident slots would not fit."""
    for hh, w in ((512, 512), (1024, 512), (1792, 512), (1793, 512),
                  (300, 40), (4096, 128)):
        plan = hopper_ops.lu_panel_batched_plan_with(hh, w, itemsize, ctas)
        res = hopper_ops.lu_panel_batched_smem_bytes(hh, w, itemsize, ctas,
                                                     True)
        assert plan.resident == (res <= hopper_ops.PANEL_SMEM_LIMIT)
        assert plan.smem_bytes <= hopper_ops.PANEL_SMEM_LIMIT
        assert plan.ctas == ctas and plan.rows == -(-hh // ctas)


# the plan the smoke's cases launch with on an H100 (132 SMs)
SMOKE_PLANS = [
    ((32, 512, 512, 4), 16, "resident"),
    ((16, 1024, 512, 4), 16, "resident"),
    ((1, 1024, 512, 4), 16, "resident"),
    ((32, 512, 512, 8), 16, "resident"),
    ((16, 1024, 512, 8), 16, "streaming"),
    ((1, 1744, 512, 4), 16, "resident"),
    ((1, 1745, 512, 4), 16, "streaming"),
    ((1, 1000, 300, 4), 16, "resident"),
    ((5, 45, 45, 4), 16, "resident"),
    ((2, 64, 1, 8), 16, "resident"),
    ((8, 512, 512, 4), 16, "resident"),
    ((400, 45, 45, 4), 1, "resident"),
]


@pytest.mark.parametrize("shape,ctas,mode", SMOKE_PLANS)
def test_p3_plan_at_the_smoke_shapes(shape, ctas, mode):
    plan = hopper_ops.lu_panel_batched_plan(*shape, H100_SMS)
    assert (plan.ctas, plan.mode) == (ctas, mode)


def test_p3_plan_resident_then_few_waves_then_wide():
    """Resident CTAs win over fewer waves; among resident plans the
    fewest waves, then the largest C; many small chunks take C = 1 (two
    clusters would need more waves); a chunk of fewer rows than 16 takes
    at most one CTA a row."""
    plan = hopper_ops.lu_panel_batched_plan
    # (16, 1024, 512) f32: only C = 16 is resident, in three waves
    assert plan(16, 1024, 512, 4, H100_SMS).resident
    # (64, 512, 512) f32: C = 8 and 16 are resident, 16 in as few waves
    assert plan(64, 512, 512, 4, H100_SMS).ctas == 16
    # 600 chunks of (64, 32): C = 1 in 3 waves, C = 2 in 5
    assert plan(600, 64, 32, 4, H100_SMS).ctas == 1
    # 100 of them: C = 2 in one wave of 200 CTAs, C = 4 would take two
    assert plan(100, 64, 32, 4, H100_SMS).ctas == 2
    assert plan(3, 5, 5, 8, H100_SMS).ctas == 4
    assert plan(3, 1, 1, 8, H100_SMS).ctas == 1
    # nothing resident: the fewest waves, then the largest C
    assert plan(16, 1024, 512, 8, H100_SMS) == \
        hopper_ops.lu_panel_batched_plan_with(1024, 512, 8, 16)


def test_p3_plan_rejects_bad_arguments():
    plan = hopper_ops.lu_panel_batched_plan
    for args in ((0, 64, 8, 4, H100_SMS), (2, 8, 64, 4, H100_SMS),
                 (2, 64, 0, 4, H100_SMS), (2, 64, 8, 0, H100_SMS),
                 (2, 64, 8, 4, 0)):
        with pytest.raises(SlateError):
            plan(*args)
    with_ = hopper_ops.lu_panel_batched_plan_with
    for args in ((64, 8, 4, 3), (64, 8, 4, 32), (8, 8, 4, 16),
                 (64, 65, 4, 2)):
        with pytest.raises(SlateError):
            with_(*args)
    with pytest.raises(SlateError, match="does not fit"):
        plan(1, 40000, 30000, 8, H100_SMS)  # the U row alone: 240 KB


def test_p3_plan_constants_are_the_kernels():
    """The plan's copy of the kernel's constants and of its shared-memory
    layout, read from csrc/lu_panel_batched.cu: the warps, the CTAs an
    SM its launch bounds allow, the largest cluster, and the layout's
    terms (on the card the smoke holds the sizes equal too)."""
    with open(os.path.join(_build.CSRC_DIR, "lu_panel_batched.cu")) as f:
        src = f.read()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    bounds = int(re.search(r"__launch_bounds__\(kThreads, (\d+)\)",
                           src)[1])
    largest = int(re.search(r"constexpr int kMaxCluster = (\d+);", src)[1])
    assert hopper_ops.P3_WARPS == threads // 32
    assert hopper_ops.P3_CTAS_PER_SM == bounds
    assert max(hopper_ops.P3_CLUSTERS) == largest
    assert ("size_t b = (2 * C * kWarps + 1) * 16 + align16(rows * "
            "sizeof(int)) +\n             2 * align16((size_t)w * itemsize);"
            ) in src
    assert "if (M == kResident) b += rows * w * itemsize;" in src
    # 257 records of 16 bytes, 64 slot positions, two U rows, 64 slots
    assert hopper_ops.lu_panel_batched_smem_bytes(1024, 512, 4, 16, True) \
        == 257 * 16 + 256 + 2 * 2048 + 64 * 2048


# ---------------------------------------------------------------------------
# the slot scheme, emulated
# ---------------------------------------------------------------------------

def _beats(va, ia, vb, ib):
    """jnp.argmax's rule as a total order on (value, index)."""
    na, nb = math.isnan(va), math.isnan(vb)
    if na != nb:
        return na
    if not na and va != vb:
        return va > vb
    return ia < ib


def slot_scheme(stack: torch.Tensor, ctas: int, order=None):
    """P3's kernel on a (B, H, w) CPU stack with clusters of ``ctas``
    CTAs, as plain torch: each CTA's slots (rows r, r + C, ...) stay in
    place, each slot carries its position, a pivot step swaps two
    positions. The C candidates are reduced in ``order`` (any order must
    give the same pivot). → (lu, perm, info) like the plain version."""
    bsz, hh, w = stack.shape
    order = list(range(ctas)) if order is None else order
    lu = torch.empty_like(stack)
    perm = torch.empty((bsz, hh), dtype=torch.int32)
    info = torch.zeros(bsz, dtype=torch.int32)
    one = torch.ones((), dtype=stack.dtype)
    for b in range(bsz):
        store = [stack[b, r::ctas].clone() for r in range(ctas)]
        pos = [list(range(r, hh, ctas)) for r in range(ctas)]
        for j in range(w):
            cands = []  # each CTA's best (|value|, position, slot)
            for r in range(ctas):
                best = (-1.0, INT_MAX, 0)
                for l, q in enumerate(pos[r]):
                    v = abs(float(store[r][l, j]))
                    if q >= j and _beats(v, q, best[0], best[1]):
                        best = (v, q, r + l * ctas)
                cands.append(best)
            win = (-1.0, INT_MAX, 0)
            for r in order:
                if _beats(cands[r][0], cands[r][1], win[0], win[1]):
                    win = cands[r]
            _, p, sp = win
            u = store[sp % ctas][sp // ctas].clone()
            d = u[j]
            bad = bool(torch.isnan(d)) or float(d) == 0.0
            if bad and info[b] == 0:
                info[b] = j + 1
            dsafe = one if bad else d
            for r in range(ctas):
                for l, q in enumerate(pos[r]):
                    s = r + l * ctas
                    pos[r][l] = j if s == sp else (p if q == j else q)
                active = [l for l, q in enumerate(pos[r]) if q > j]
                if not active:
                    continue
                rows = store[r][active]
                lcol = rows[:, j] / dsafe
                if j + 1 < w:
                    rows[:, j + 1:] = rows[:, j + 1:] - lcol[:, None] * u[
                        None, j + 1:]
                rows[:, j] = lcol
                store[r][active] = rows
        for r in range(ctas):
            for l, q in enumerate(pos[r]):
                lu[b, q] = store[r][l]
                perm[b, q] = r + l * ctas
    return lu, perm, info


def _stack(shape, dtype, seed, fault=None):
    a = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    if fault == "zero_column":
        a[-1, :, 3] = 0.0
    elif fault == "nan":
        a[0, [7, 11], 2] = np.nan
        a[0, [7, 11], :2] = 0.0
    elif fault == "tie":
        a[:, :, 0] = np.where(np.arange(shape[1]) % 2, -1.0, 1.0)
        a[-1, :, 1] = a[-1, :, 1].clip(-1, 1)
        a[-1, [5, 9], 1] = 7.0
    elif fault == "tie_after_swap":
        # column 0's pivot is row 9: slot 9 takes position 0, slot 0
        # position 9. Column 1 is left as it is by that step (u[1] = 0),
        # and its largest entries tie: slot 0 (position 9) and slot 5
        # (position 5). By position slot 5 wins; by slot it would be 0.
        a = a.clip(-1, 1)
        a[:, 9, 0], a[:, 9, 1] = 7.0, 0.0
        a[:, 0, 1], a[:, 5, 1] = 5.0, -5.0
    return a


def _assert_bitwise(got, want):
    lu, perm, info = got
    nan = torch.isnan(want[0])
    assert torch.equal(torch.isnan(lu), nan)
    assert torch.equal(lu[~nan], want[0][~nan])
    assert torch.equal(perm, want[1]) and torch.equal(info, want[2])


EMULATION_CASES = [
    ((3, 37, 16), None, 4), ((2, 40, 40), None, 8), ((2, 33, 12), None, 16),
    ((1, 29, 29), None, 1), ((3, 41, 9), None, 2),
    ((3, 24, 8), "zero_column", 4), ((2, 30, 6), "nan", 8),
    ((2, 21, 5), "tie", 4), ((2, 13, 4), "tie_after_swap", 4),
    ((1, 13, 4), "tie_after_swap", 1), ((2, 19, 6), "tie_after_swap", 16),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,fault,ctas", EMULATION_CASES)
def test_p3_slot_scheme_is_bitwise_the_plain_version(shape, fault, ctas,
                                                     dtype):
    """Gaussian stacks with H not a multiple of C (and C = 1, and C = 16
    with one or two rows a CTA), a zero column (info 4), a NaN that must
    win its column, exact ties, and a tie between two slots whose
    positions an earlier swap has put in the other order."""
    a = torch.from_numpy(_stack(shape, dtype, sum(shape) + ctas, fault))
    want = hopper_ops.lu_panel_batched_plain(a)
    _assert_bitwise(slot_scheme(a, ctas), want)
    if fault == "zero_column":
        assert want[2].tolist()[-1] == 4
    elif fault == "nan":
        assert int(want[2][0]) == 3 and int(want[1][0, 2]) == 7
    elif fault == "tie_after_swap":
        assert want[1][:, :2].tolist() == [[9, 5]] * shape[0]


def test_p3_slot_scheme_in_any_reduction_order():
    """The C candidates give the same pivot in forward, reverse and
    shuffled orders: every CTA may reduce them in its own order."""
    a = torch.from_numpy(_stack((2, 45, 10), np.float64, 5, "tie"))
    want = hopper_ops.lu_panel_batched_plain(a)
    rng = np.random.default_rng(0)
    for order in ([7, 6, 5, 4, 3, 2, 1, 0], list(rng.permutation(8)),
                  list(rng.permutation(8))):
        _assert_bitwise(slot_scheme(a, 8, order), want)


def test_p3_slot_scheme_on_the_plan_of_a_round():
    """The plan's own cluster size for a small round of the tournament
    (C = 16 at 64 rows: four slots a CTA), ties included."""
    a = torch.from_numpy(_stack((3, 64, 32), np.float32, 11, "tie"))
    plan = hopper_ops.lu_panel_batched_plan(3, 64, 32, 4, H100_SMS)
    assert (plan.ctas, plan.rows) == (16, 4)
    _assert_bitwise(slot_scheme(a, plan.ctas),
                    hopper_ops.lu_panel_batched_plain(a))
