"""getrf/getrs/gesv of the port against slate_tpu on the same inputs.

Operands are A = P·M with M = G/√n + 2·I (G Gaussian, P a random row
permutation): condition numbers ≤ 1e3 and well-separated pivots (|2|
against entries of size ~0.3), so both packages pick the same pivots and
the perm is compared exactly. Sizes n ∈ {96, 200}, nb = 32, float32 and
float64.

Tolerances: LU and X agree to 1e-4 (float32) / 1e-10 (float64)
relative to their max entry (summation order differs); scaled residual
≤ 30; perm and info exact.
"""

import functools

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.ops import blocked as ref_blocked
import slate_tpu_torch as stt
from slate_tpu_torch.linalg import lu as port_lu
from slate_tpu_torch.ops import blocked, hopper_ops

torch.set_num_threads(2)

NB = 32
TOL = {np.float32: 1e-4, np.float64: 1e-10}
CASES = [(96, np.float32), (200, np.float32), (96, np.float64),
         (200, np.float64)]


def _separated(rng, m, n):
    g = rng.standard_normal((m, n)) / np.sqrt(n)
    g[np.arange(min(m, n)), np.arange(min(m, n))] += 2.0
    return g[rng.permutation(m)]


@functools.lru_cache(maxsize=None)
def _problem(n, dtype):
    rng = np.random.default_rng(2000 + n)
    return (_separated(rng, n, n).astype(dtype),
            rng.standard_normal((n, 2)).astype(dtype))


@functools.lru_cache(maxsize=None)
def _reference(n, dtype):
    a, b = _problem(n, dtype)
    LU, perm, info = st.getrf(st.from_dense(a, NB))
    X = st.getrs(LU, perm, st.from_dense(b, NB))
    return LU.to_numpy(), np.asarray(perm), int(info), X.to_numpy()


def _port_getrf(a, opts=stt.Options()):
    return stt.getrf(stt.from_dense(a, NB, device="cpu"), opts)


def _rel(x, y):
    return np.abs(x - y).max() / np.abs(y).max()


def _scaled_residual(a, x, b):
    n = a.shape[0]
    eps = np.finfo(a.dtype).eps
    r = np.abs(b - a.astype(np.float64) @ x).max()
    return r / (n * eps * np.abs(a).sum(axis=1).max() * np.abs(x).max())


@pytest.mark.parametrize("n,dtype", CASES)
def test_getrf_gesv_match_reference(n, dtype):
    a, b = _problem(n, dtype)
    lu_ref, perm_ref, info_ref, x_ref = _reference(n, dtype)
    LU, perm, info = _port_getrf(a)
    assert int(info) == info_ref == 0
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), perm_ref)
    assert _rel(LU.to_numpy(), lu_ref) < TOL[dtype]
    X, info = stt.gesv(stt.from_dense(a, NB, device="cpu"),
                       stt.from_dense(b, NB, device="cpu"))
    x = X.to_numpy()
    assert _rel(x, x_ref) < TOL[dtype]
    assert _scaled_residual(a, x, b) <= 30


def test_getrf_singular_info_matches_reference():
    n, dtype = 96, np.float64
    a, _ = _problem(n, dtype)
    a = a.copy()
    a[:, 40] = 0.0
    _, _, info_ref = st.getrf(st.from_dense(a, NB))
    _, _, info = _port_getrf(a)
    assert int(info) == int(info_ref) == 41


def test_reference_only_options_are_accepted_and_ignored():
    """The knobs that pick the reference's other arms are accepted, and
    the port runs its one path under them."""
    a, _ = _problem(200, np.float64)
    base = _port_getrf(a)
    LU, perm, info = _port_getrf(a, stt.Options(
        lookahead=0, lu_pivot_fusion=False, factor_iter_large=False,
        update_precision="bfloat16_3x"))
    np.testing.assert_array_equal(LU.to_numpy(), base[0].to_numpy())
    np.testing.assert_array_equal(perm.numpy(), base[1].numpy())


def test_getrf_recursion_path(monkeypatch):
    """The 2×2 width recursion, which runs where the iterative loop does
    not apply (more than ITER_MAX_NT block columns; forced at n = 200 by
    lowering ITER_MAX_NT), gives the same perm and the same factor to
    tolerance."""
    n, dtype = 200, np.float64
    a, _ = _problem(n, dtype)
    lu_ref, perm_ref, _, _ = _reference(n, dtype)
    monkeypatch.setattr(port_lu, "_ITER_MAX_NT", 2)
    calls = []
    rec = port_lu._getrf_rec
    monkeypatch.setattr(port_lu, "_getrf_rec",
                        lambda a, nb, threshold=1.0: calls.append(a.shape[1])
                        or rec(a, nb, threshold))
    LU, perm, info = _port_getrf(a)
    assert calls[:3] == [224, 128, 64]
    assert int(info) == 0
    np.testing.assert_array_equal(perm.numpy(), perm_ref)
    assert _rel(LU.to_numpy(), lu_ref) < TOL[dtype]


def test_panel_getrf_width_recursion_matches_reference():
    """A 256-wide panel recurses on width down to 128-wide bases (the K2
    shape of the main path) and agrees with the reference's recursion."""
    rng = np.random.default_rng(5)
    a = _separated(rng, 512, 256)
    lu, perm, info = blocked.panel_getrf(torch.from_numpy(a))
    lu_r, perm_r, info_r = ref_blocked.panel_getrf(a)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))
    assert int(info) == int(info_r) == 0
    assert _rel(lu.numpy(), np.asarray(lu_r)) < 1e-10


@pytest.mark.parametrize("w,bases", [(1, [1]), (4, [4]), (7, [7]),
                                     (100, [100]), (256, [128, 128])])
def test_panel_getrf_sends_every_base_to_the_kernel(w, bases, monkeypatch):
    """Every base of the width recursion, narrow ones (w < 8) included,
    is one hopper_ops.lu_panel_base call — the K2 kernel on the card —
    and the result agrees with the reference's panel_getrf."""
    seen = []
    launcher = hopper_ops.lu_panel_base
    monkeypatch.setattr(hopper_ops, "lu_panel_base",
                        lambda p: seen.append(p.shape[1]) or launcher(p))
    rng = np.random.default_rng(40 + w)
    a = _separated(rng, 256, w)
    lu, perm, info = blocked.panel_getrf(torch.from_numpy(a))
    assert seen == bases
    lu_r, perm_r, info_r = ref_blocked.panel_getrf(a)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))
    assert int(info) == int(info_r) == 0
    assert _rel(lu.numpy(), np.asarray(lu_r)) < 1e-10


def test_narrow_panel_off_the_cpu_never_runs_the_plain_base():
    """A 4-wide panel on a device other than the CPU reaches the kernel
    wrapper, which launches or raises; the plain base is for CPU
    tensors only."""
    with pytest.raises(stt.SlateError, match="unsupported device"):
        blocked.panel_getrf(torch.empty((64, 4), device="meta"))


def test_getrs_transpose():
    a, b = _problem(96, np.float64)
    LU, perm, _ = _port_getrf(a)
    X = stt.getrs(LU, perm, stt.from_dense(b, NB, device="cpu"), trans=True)
    np.testing.assert_allclose(a.T @ X.to_numpy(), b, atol=1e-10)


def test_gemm_matches_reference():
    """blas3.gemm (α·A·B + β·C, uneven padding) against the reference."""
    from slate_tpu.linalg import blas3 as ref_blas3
    from slate_tpu_torch.linalg import blas3
    rng = np.random.default_rng(8)
    a, b, c = (rng.standard_normal(s) for s in ((70, 40), (40, 50), (70, 50)))
    ref = ref_blas3.gemm(2.0, st.from_dense(a, NB), st.from_dense(b, NB),
                         -0.5, st.from_dense(c, NB)).to_numpy()
    out = blas3.gemm(2.0, *(stt.from_dense(x, NB, device="cpu")
                            for x in (a, b)), -0.5,
                     stt.from_dense(c, NB, device="cpu"))
    assert out.logical_shape == (70, 50)
    np.testing.assert_allclose(out.to_numpy(), ref, rtol=1e-12, atol=1e-12)
