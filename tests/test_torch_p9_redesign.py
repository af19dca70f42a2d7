"""P9's redesigned order of arithmetic (csrc/secular.cu), held on the CPU.

The kernel runs only on the card, so this file emulates its arithmetic
in plain torch, stage for stage as ``hopper_ops.secular_roots_plain``
but with every pole sum made as the kernel makes it: lane l of a root's
group of L lanes sums the terms of poles l, l + L, … in index order, the
L partials meet in the fixed xor butterfly (offsets 1, 2, …, L/2), each
term is z2ᵢ·(1/den) with its denominator clamped to |den| ≥ 1e-300 (sign
kept, a zero to +1e-300; the fixed point masks its own pole and a zero
denominator with 1e300), and ‖z‖² is a lane sum too. The reciprocal is
modelled as the kernel's: a seed of about 20 bits (the reciprocal with
its low 32 mantissa bits cut) and two Newton–Raphson steps; the kernel's
fused multiply-adds round twice here, so the model is not the kernel's
bits, only its order of summation and its guards.

On the spectra of ``tests/test_torch_stedc.py`` (random, clustered,
tiny z, two poles), on a merge of glued Wilkinson blocks cut short (where
the reference's near-pole fixed point jumps to a false root), and on a
spectrum with subnormal pole gaps, at each lanes-per-root value the plan
can choose, the model's roots are held to the reference's
``_secular_roots`` within SECULAR_ROOT_C·ε₆₄·max(max|δ|, ρ) (on the
glued merge: to the plain version's, and to the dense eigenvalues where
the reference jumps), the port's ``_revised_z`` of its roots within 1e-10
relative of the reference's, and every lane's butterfly result equal bit
for bit at every pass. ``secular_roots_plan`` covers every k from 1 to
20,000 with a resident or tiled choice within 227 KB.
"""

import os
import re

import numpy as np
import pytest
import torch

from slate_tpu.linalg import stedc as R
from slate_tpu_torch.linalg import stedc as S
from slate_tpu_torch.ops import hopper_ops as ho

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = np.finfo(np.float64).eps
LANES = (4, 8, 16, 32)
TINY, MASK = 1e-300, 1e300


class _Kernel:
    """The kernel's sums for L lanes a root; ``split`` records whether
    every lane of every group ended every pass with the same bits."""

    def __init__(self, lanes: int):
        self.lanes = lanes
        self.split = True
        self.passes = 0

    def lane_sum(self, v: torch.Tensor) -> torch.Tensor:
        """Each row of ``v`` (roots × k terms) summed in lane order, then
        by the xor butterfly; returns the first lane's sums after checking
        that all lanes agree bitwise."""
        L = self.lanes
        rows, k = v.shape
        part = torch.zeros((rows, L), dtype=v.dtype)
        for t0 in range(0, k, L):  # lane l adds term t0 + l, if it exists
            n = min(L, k - t0)
            part[:, :n] = part[:, :n] + v[:, t0:t0 + n]
        lanes = torch.arange(L)
        o = 1
        while o < L:  # both lanes of a pair add the same two values
            part = part + part[:, lanes ^ o]
            o *= 2
        bits = part.view(torch.int64)
        self.split &= bool((bits == bits[:, :1]).all())
        self.passes += 1
        return part[:, 0]


def _clamp(den: torch.Tensor) -> torch.Tensor:
    tiny = torch.full_like(den, TINY)
    tiny = torch.where(den < 0, -tiny, tiny)
    return torch.where(den.abs() < TINY, tiny, den)


def _recip(den: torch.Tensor) -> torch.Tensor:
    """The seed (1/den to about 20 bits) and two Newton–Raphson steps."""
    seed = (1.0 / den).view(torch.int64) & ~((1 << 32) - 1)
    x = seed.view(torch.float64)
    for _ in range(2):
        e = 1.0 - den * x
        x = x + x * e
    return x


def emulate(delta: torch.Tensor, z2: torch.Tensor, rho: float, lanes: int):
    """(upper, μ, the kernel model) of the kernel's schedule at ``lanes``
    lanes a root: the pole choice, SECULAR_BISECT bisections,
    SECULAR_NEWTON Newton steps and SECULAR_FIXED fixed-point steps."""
    kern = _Kernel(lanes)
    k = delta.numel()
    j = torch.arange(k)
    notlast = j < k - 1
    znorm2 = kern.lane_sum(z2[None, :])[0]
    w = torch.empty_like(delta)
    w[:-1] = delta[1:] - delta[:-1]
    w[-1] = rho * znorm2

    def f_of(gap, m):
        inv = _recip(_clamp(gap - m[:, None]))
        return 1.0 + rho * kern.lane_sum(z2[None, :] * inv)

    fmid = f_of(delta[None, :] - delta[:, None], 0.5 * w)
    upper = (fmid < 0) & notlast
    sj = j + upper.long()
    gap = delta[None, :] - delta[sj][:, None]
    zero = torch.zeros_like(w)
    lo = torch.where(upper, -0.5 * w, zero)
    hi = torch.where(upper, zero, torch.where(notlast, 0.5 * w, w))
    for _ in range(ho.SECULAR_BISECT):
        mid = 0.5 * (lo + hi)
        up = f_of(gap, mid) < 0
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
    blo, bhi = lo, hi
    m = 0.5 * (lo + hi)
    for _ in range(ho.SECULAR_NEWTON):
        inv = _recip(_clamp(gap - m[:, None]))
        r = z2[None, :] * inv
        f = 1.0 + rho * kern.lane_sum(r)
        fp = rho * kern.lane_sum(r * inv)
        up = f < 0
        lo = torch.where(up, m, lo)
        hi = torch.where(up, hi, m)
        m_new = m - torch.where(fp > 0, f / fp, zero)
        bad = (m_new <= lo) | (m_new >= hi) | ~torch.isfinite(m_new)
        m = torch.where(bad, 0.5 * (lo + hi), m_new)
    zp2 = z2[sj]
    own = torch.zeros((k, k), dtype=torch.bool)
    own[j, sj] = True
    weff = torch.where(upper, 0.5 * w, w)
    near_pole = m.abs() < 1e-6 * weff
    want = torch.where(upper, -1.0, 1.0).to(delta.dtype)
    for _ in range(ho.SECULAR_FIXED):
        den = gap - m[:, None]
        den = torch.where(own | (den == 0), MASK, _clamp(den))
        rest = 1.0 + rho * kern.lane_sum(z2[None, :] * _recip(den))
        cand = rho * zp2 / torch.where(rest == 0, 1e-300, rest)
        ok = (torch.isfinite(cand) & (rest != 0)
              & (torch.sign(cand) == want) & (cand.abs() < 1e-5 * weff)
              & (cand >= blo) & (cand <= bhi))
        m = torch.where(near_pole & ok, cand, m)
    return upper, m, kern


def _spectrum(case, rng):
    """(δ ascending, z2 > 0, ρ): test_torch_stedc.py's four spectra, a
    glued-Wilkinson merge, and subnormal pole gaps."""
    if case == "glued_merge":
        return _glued_merge()
    if case == "random":
        delta = np.sort(rng.standard_normal(300))
    elif case == "clustered":
        delta = np.sort(np.concatenate([
            0.3 + np.cumsum(rng.uniform(1e-9, 2e-9, 120)),
            rng.uniform(-2, 2, 120)]))
    elif case == "tiny_z":
        delta = np.sort(rng.uniform(-1, 1, 200))
    elif case == "subnormal_gaps":  # five poles 2e-310 to 7e-310 apart
        delta = np.sort(np.concatenate([
            rng.uniform(-1, 1, 60),
            np.cumsum([0.0, 2e-310, 5e-310, 7e-310, 3e-310])]))
    else:  # two poles
        delta = np.array([-0.25, 0.5])
    k = delta.size
    z = rng.standard_normal(k)
    if case == "tiny_z":  # roots against their poles
        z[::3] *= 1e-7
    z /= np.linalg.norm(z)
    return delta, z * z, 0.7


def _glued_merge():
    """The merge of k = 34 in stedc of glued Wilkinson blocks W21⁺ cut to
    n = 180 (test_torch_stedc.py's test_stedc_where_the_reference_fixed_
    point_jumps), captured from the port's stedc on the CPU at min_k = 16:
    a root there sits 1e-7 of the interval below a pole of negligible
    weight, and the reference's fixed point jumps to the pole."""
    n, m = 180, 21
    d = np.concatenate([np.abs(np.arange(m) - (m - 1) / 2.0)]
                       * -(-n // m))[:n]
    e = np.ones(n - 1)
    e[m - 1::m] = 1e-9
    merges = []
    roots = S._roots

    def capture(delta, z2, rho, dev):
        merges.append((delta.copy(), z2.copy(), rho))
        return roots(delta, z2, rho, dev)

    S._roots = capture
    try:
        S.stedc(d, e, compute_z=False, device="cpu", min_k=16)
    finally:
        S._roots = roots
    return next(mg for mg in merges if mg[0].size == 34)


CASES = ["random", "clustered", "tiny_z", "two_pole", "glued_merge",
         "subnormal_gaps"]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("case", CASES)
def test_kernel_order_matches_reference(case, lanes):
    delta, z2, rho = _spectrum(case, np.random.default_rng(11))
    k = delta.size
    dt, zt = torch.from_numpy(delta), torch.from_numpy(z2)
    up, mu, kern = emulate(dt, zt, rho, lanes)
    assert kern.split and kern.passes == 2 + ho.SECULAR_BISECT + 2 * (
        ho.SECULAR_NEWTON) + ho.SECULAR_FIXED
    assert torch.isfinite(mu).all() and not up[-1]
    shift = np.arange(k) + up.numpy()
    lam = delta[shift] + mu.numpy()
    # interlacing, in the shifted variable
    assert np.all(np.where(up.numpy(), mu.numpy() <= 0, mu.numpy() >= 0))
    tol = ho.SECULAR_ROOT_C * EPS * max(np.abs(delta).max(), rho)
    s_r, mu_r = R._secular_roots(delta, z2, rho)
    lam_r = delta[s_r] + mu_r
    if case == "glued_merge":
        # the port's contract is its plain version's; the reference jumps
        # at a few roots, where the model keeps the true eigenvalue
        up_p, mu_p = ho.secular_roots_plain(dt, zt, rho)
        shift_p = np.arange(k) + up_p.numpy()
        assert np.abs(lam - (delta[shift_p] + mu_p.numpy())).max() <= tol
        jumped = np.abs(lam - lam_r) > tol
        assert 0 < jumped.sum() <= 3
        dense = np.linalg.eigvalsh(np.diag(delta) + rho * np.outer(
            np.sqrt(z2), np.sqrt(z2)))
        assert np.abs(np.sort(lam) - dense).max() <= tol
        assert np.abs(lam - lam_r)[~jumped].max() <= tol
        # ẑ there moves with the order of summation (the plain version's
        # and the model's differ by up to 2e-10 relative, the reference's
        # by 6.7 at the jump): the merge's eigenvectors are held instead
        V = S._vectors(delta, np.sqrt(z2), rho, torch.from_numpy(shift), mu)
        orth = (V.T @ V - torch.eye(k, dtype=V.dtype)).abs().max()
        assert orth < k * ho.SECULAR_ORTH
        return
    assert np.abs(lam - lam_r).max() <= tol
    if case == "subnormal_gaps":
        return  # ẑ across gaps of 1e-310 is not resolved by either
    zhat_r = R._revised_z(delta, s_r, mu_r, rho)
    zhat = S._revised_z(dt, torch.from_numpy(shift), mu, rho).numpy()
    assert np.all(np.abs(zhat - zhat_r) <= 1e-10 * np.abs(zhat_r) + 1e-300)


@pytest.mark.parametrize("lanes", LANES)
def test_butterfly_gives_every_lane_the_same_bits(lanes):
    """Sums whose order matters (terms of mixed sign and magnitude): every
    lane of the butterfly ends with the same bits, which equal a plain
    sum's within the ordering error."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal((64, 257))
                         * 10.0 ** rng.integers(-8, 8, (64, 257)))
    kern = _Kernel(lanes)
    s = kern.lane_sum(v)
    assert kern.split
    ref = v.sum(dim=1)
    assert torch.all((s - ref).abs() <= 257 * EPS * v.abs().sum(dim=1))


def test_reciprocal_model_and_clamp():
    """The modelled reciprocal within 2 ulps of 1/den over 1e-300 ≤ |den|
    ≤ 1e300; the clamp keeps the sign, sends ±0 to +1e-300 and keeps every
    term finite for subnormal denominators."""
    rng = np.random.default_rng(5)
    den = torch.from_numpy(rng.uniform(1, 2, 4096)
                           * 10.0 ** rng.integers(-300, 300, 4096)
                           * rng.choice([-1.0, 1.0], 4096))
    inv = _recip(den)
    exact = 1.0 / den
    ulp = torch.from_numpy(np.spacing(np.abs(exact.numpy())))
    assert ((inv - exact).abs() <= 2 * ulp).all()
    sub = torch.tensor([5e-324, -5e-324, 1e-310, -3e-309, 0.0, -0.0],
                       dtype=torch.float64)
    c = _clamp(sub)
    assert c.tolist() == [TINY, -TINY, TINY, -TINY, TINY, TINY]
    assert torch.isfinite(0.5 * _recip(c)).all()


def test_plan_covers_every_k():
    prev = None
    for k in range(1, 20001):
        p = ho.secular_roots_plan(k)
        roots_a_warp = 32 // p.lanes
        assert p.lanes in LANES and 1 <= p.warps <= ho.SECULAR_MAX_WARPS
        # every root in exactly one group, no CTA without a root
        assert p.ctas * p.warps * roots_a_warp >= k
        assert (p.ctas - 1) * p.warps * roots_a_warp < k
        assert p.resident == (k <= ho.SECULAR_RESIDENT_MAX)
        assert p.smem == 16 * (k if p.resident else ho.SECULAR_TILE)
        assert p.smem <= ho.SECULAR_SMEM_MAX
        if prev is not None:  # lanes never widen as k grows
            assert p.lanes <= prev.lanes
        prev = p
    assert ho.SECULAR_TILE % 32 == 0  # a lane's poles in the same order
    for k, plan in ((64, (64, 1, 32, True)), (512, (128, 4, 32, True)),
                    (4096, (128, 16, 16, True)),
                    (16384, (128, 16, 4, False))):
        assert tuple(ho.secular_roots_plan(k))[:4] == plan
    with pytest.raises(Exception, match="no plan"):
        ho.secular_roots_plan(0)


def test_kernel_has_no_atomics_and_a_branch_free_reciprocal():
    """Two launches on one input give the same bits (no atomics), and a
    term's reciprocal is the seed and its Newton steps (the plan's
    constants are held to the source by test_torch_stedc.py)."""
    with open(os.path.join(ROOT, "slate_tpu_torch", "csrc",
                           "secular.cu")) as f:
        src = f.read()
    assert not re.search(r"atomic[A-Z]", src)
    assert "rcp.approx.ftz.f64" in src
    assert src.count("recip(") >= 5 and "z / den" not in src
