"""The port's stedc (slate_tpu_torch/linalg/stedc.py) and P9's plain
version against slate_tpu's on the same numpy inputs (CPU):

- ``hopper_ops.secular_roots_plain`` against the reference's host
  ``_secular_roots`` on random, clustered, tiny-z and two-pole spectra:
  the roots λ_j = δ[shift_j] + μ_j within SECULAR_ROOT_C·ε₆₄·max(max|δ|, ρ)
  (the two sum in other orders; a pole choice may flip where f at the
  midpoint is within rounding of zero, which moves μ, not λ), and the
  port's revised ẑ within 1e-10 of the reference's, relatively;
- stedc against the reference's host recursion
  (``stedc(use_device=False)``) on test_stedc_accuracy's five
  tridiagonals at n = 180, through the host recursion (the default
  ``min_k``, above n) and through the device merges on CPU tensors
  (``min_k`` = 64 and 16): w within 1e-12·max(1, |w|), ‖ZᵀZ − I‖max <
  n·1e-14, the residual under n·1e-13·max(1, |w|) (the reference's own
  bounds), and Z equal to the reference's up to column signs within 1e-9
  on the columns whose eigenvalue is further than 1e-6·‖T‖₁ from its
  neighbours (inside a cluster any orthonormal basis is right);
- glued Wilkinson blocks cut short, where the reference's near-pole
  fixed point returns a false root and the port's, held to the
  bisection's bracket, does not;
- values only, n = 0 and n = 1, the refusals (a non-float64 P9 call, a
  process grid), no environment variable in stedc, and P9's constants
  in csrc/secular.cu equal to hopper_ops's.
"""

import os
import re

import numpy as np
import pytest
import torch

from slate_tpu.linalg import stedc as R
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.linalg import stedc as S
from slate_tpu_torch.ops import hopper_ops as ho

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = np.finfo(np.float64).eps
N = 180


def _spectrum(case, rng):
    """(δ ascending, z2 > 0, ρ) of a merge after deflation."""
    if case == "random":
        k = 300
        delta = np.sort(rng.standard_normal(k))
    elif case == "clustered":
        delta = np.sort(np.concatenate([
            0.3 + np.cumsum(rng.uniform(1e-9, 2e-9, 120)),
            rng.uniform(-2, 2, 120)]))
    elif case == "tiny_z":
        delta = np.sort(rng.uniform(-1, 1, 200))
    else:  # two poles
        delta = np.array([-0.25, 0.5])
    k = delta.size
    z = rng.standard_normal(k)
    if case == "tiny_z":  # roots against their poles
        z[::3] *= 1e-7
    z /= np.linalg.norm(z)
    return delta, z, 0.7


@pytest.mark.parametrize("case", ["random", "clustered", "tiny_z",
                                  "two_pole"])
def test_secular_roots_plain_matches_reference(case):
    rng = np.random.default_rng(11)
    delta, z, rho = _spectrum(case, rng)
    k = delta.size
    s_r, mu_r = R._secular_roots(delta, z * z, rho)
    up, mu = ho.secular_roots_plain(torch.from_numpy(delta),
                                    torch.from_numpy(z * z), rho)
    assert up.dtype == torch.bool and mu.dtype == torch.float64
    assert not up[-1]  # the last root has no upper pole
    shift = np.arange(k) + up.numpy()
    lam, lam_r = delta[shift] + mu.numpy(), delta[s_r] + mu_r
    scale = max(np.abs(delta).max(), rho)
    assert np.abs(lam - lam_r).max() <= ho.SECULAR_ROOT_C * EPS * scale
    # interlacing, in the shifted variable (δ + μ may round to δ): root j
    # lies above δ_j and below δ_{j+1}
    assert np.all(np.where(up.numpy(), mu.numpy() < 0, mu.numpy() > 0))
    zhat = S._revised_z(torch.from_numpy(delta), torch.from_numpy(shift),
                        mu, rho).numpy()
    zhat_r = R._revised_z(delta, s_r, mu_r, rho)
    assert np.abs(zhat - zhat_r).max() <= 1e-10 * np.abs(zhat_r).max()
    assert np.all(np.abs(zhat - zhat_r) <= 1e-10 * np.abs(zhat_r) + 1e-300)


def _tridiag_case(case, n=N):
    """tests/test_stedc.py test_stedc_accuracy's tridiagonals."""
    rng = np.random.default_rng(7)
    if case == "random":
        return rng.standard_normal(n), rng.standard_normal(n - 1)
    if case == "gk_zero_diag":
        return np.zeros(n), np.ones(n - 1)
    if case == "glued_wilkinson":
        m = 21
        d = np.concatenate([np.abs(np.arange(m) - (m - 1) / 2.0)] * 8)
        e = np.ones(d.size - 1)
        e[m - 1::m] = 1e-9
        return d, e
    if case == "ties":
        return np.ones(n), 1e-12 * np.ones(n - 1)
    return np.arange(n) * 1.0, np.zeros(n - 1)


def _tridiag(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


CASES = ["random", "gk_zero_diag", "glued_wilkinson", "ties", "decoupled"]


@pytest.mark.parametrize("min_k", [None, 64, 16],
                         ids=["host", "merges64", "merges16"])
@pytest.mark.parametrize("case", CASES)
def test_stedc_matches_reference(case, min_k):
    d, e = _tridiag_case(case)
    n = d.size
    w, z = S.stedc(d, e, device="cpu", min_k=min_k)
    rw, rz = R.stedc(d, e, use_device=False)
    assert isinstance(w, np.ndarray) and w.dtype == np.float64
    assert z.dtype == torch.float64 and z.device.type == "cpu"
    z = z.numpy()
    scale = max(1.0, np.abs(rw).max())
    assert np.abs(w - rw).max() <= 1e-12 * scale
    assert np.abs(z.T @ z - np.eye(n)).max() < n * 1e-14
    t = _tridiag(d, e)
    assert np.abs(t @ z - z * w).max() < n * 1e-13 * scale
    gaps = np.minimum(np.r_[np.inf, np.diff(rw)], np.r_[np.diff(rw), np.inf])
    sep = gaps > 1e-6 * np.abs(t).sum(axis=0).max()
    sign = np.sign(np.sum(z * rz, axis=0))
    assert np.abs(z * sign - rz)[:, sep].max(initial=0.0) <= 1e-9


@pytest.mark.parametrize("min_k", [None, 16])
def test_stedc_where_the_reference_fixed_point_jumps(min_k):
    """Glued Wilkinson blocks of 21 cut to n = 180 (the last block 12
    rows): a merge there has a root about 2e-7 below a pole of negligible
    weight (z2 ~ 1e-22) whose place the other poles set. The reference's
    near-pole fixed point accepts a candidate at the pole and returns a
    false root 2e-7 off (residual 1e-4); the port takes a candidate only
    inside the bisection's bracket (ROADMAP queue 3) and meets the
    accuracy bounds above."""
    n, m = N, 21
    d = np.concatenate([np.abs(np.arange(m) - (m - 1) / 2.0)]
                       * -(-n // m))[:n]
    e = np.ones(n - 1)
    e[m - 1::m] = 1e-9
    t = _tridiag(d, e)
    w_true = np.linalg.eigvalsh(t)
    scale = max(1.0, np.abs(w_true).max())
    rw, _ = R.stedc(d, e, use_device=False)
    assert np.abs(rw - w_true).max() > 1e-8 * scale
    w, z = S.stedc(d, e, device="cpu", min_k=min_k)
    z = z.numpy()
    assert np.abs(w - w_true).max() <= 1e-12 * scale
    assert np.abs(z.T @ z - np.eye(n)).max() < n * 1e-14
    assert np.abs(t @ z - z * w).max() < n * 1e-13 * scale


@pytest.mark.parametrize("min_k", [None, 16])
def test_stedc_values_only(min_k):
    d, e = _tridiag_case("random", 100)
    w, z = S.stedc(d, e, compute_z=False, device="cpu", min_k=min_k)
    rw, _ = R.stedc(d, e, compute_z=False)
    assert z is None
    assert np.abs(w - rw).max() <= 1e-12 * max(1.0, np.abs(rw).max())
    np.testing.assert_allclose(w, np.linalg.eigvalsh(_tridiag(d, e)),
                               rtol=1e-12, atol=1e-12)


def test_stedc_tiny_and_empty():
    w, z = S.stedc(np.array([3.0]), np.array([]), device="cpu")
    assert w.tolist() == [3.0] and z.shape == (1, 1) and float(z) == 1.0
    w, z = S.stedc(np.zeros(0), np.zeros(0), device="cpu")
    assert w.shape == (0,) and z.shape == (0, 0)
    w, z = S.stedc(np.zeros(0), np.zeros(0), compute_z=False, device="cpu")
    assert z is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128,
                                   torch.int64])
def test_secular_roots_launcher_refuses_other_types(dtype):
    before = dict(ho.LAUNCHES)
    delta = torch.tensor([0.0, 1.0]).to(dtype)
    with pytest.raises(SlateError, match="float64 only"):
        ho.secular_roots(delta, delta, 0.5)
    with pytest.raises(SlateError, match="float64 only"):
        ho.secular_roots(torch.tensor([0.0, 1.0], dtype=torch.float64),
                         delta, 0.5)
    # CPU tensors of float64 run the plain version and count nothing
    ho.secular_roots(torch.tensor([0.0, 1.0], dtype=torch.float64),
                     torch.tensor([0.5, 0.5], dtype=torch.float64), 0.5)
    assert ho.LAUNCHES == before
    with pytest.raises(SlateError, match="unsupported device"):
        ho.secular_roots(torch.zeros(2, dtype=torch.float64, device="meta"),
                         torch.zeros(2, dtype=torch.float64, device="meta"),
                         0.5)


def test_stedc_refuses_a_process_grid_and_reads_no_environment():
    class Grid:
        size = 8
    with pytest.raises(SlateError, match="process grids"):
        S.stedc(np.ones(4), np.ones(3), device="cpu", grid=Grid())
    with open(S.__file__) as f:
        src = f.read()
    assert "environ" not in src and "getenv" not in src


def test_secular_kernel_constants_match_hopper_ops():
    with open(os.path.join(ROOT, "slate_tpu_torch", "csrc",
                           "secular.cu")) as f:
        src = f.read()
    for cname, value in (("kMaxWarps", ho.SECULAR_MAX_WARPS),
                         ("kMinLanes", ho.SECULAR_MIN_LANES),
                         ("kSms", ho.SECULAR_SMS),
                         ("kResidentMax", ho.SECULAR_RESIDENT_MAX),
                         ("kTile", ho.SECULAR_TILE),
                         ("kBisect", ho.SECULAR_BISECT),
                         ("kNewton", ho.SECULAR_NEWTON),
                         ("kFixed", ho.SECULAR_FIXED)):
        m = re.search(rf"constexpr int {cname} = (\d+);", src)
        assert m and int(m.group(1)) == value, cname
    # the same guards as the plain version
    assert "1e-300" in src and "1e300" in src
    # the resident poles (16 bytes each) fit the 227 KB a CTA may take
    assert 16 * ho.SECULAR_RESIDENT_MAX <= ho.SECULAR_SMEM_MAX
