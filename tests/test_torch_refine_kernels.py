"""The bfloat16 kernels of the mixed-precision slice, on the CPU.

- K5 ``herk_lower_update`` in bfloat16 (its plain version, which the CPU
  runs) against the reference's Pallas kernel in bfloat16
  (``pallas_ops.herk_lower_update(..., interpret=True, force=True)``):
  on the lower triangle within two bfloat16 units in the last place of
  |C| + |A·Aᵀ| plus 2k·2⁻²⁴·(|A|·|A|ᵀ). Both take the k-long product in
  float32 (whose sums differ by at most the last term) and round it to
  bfloat16 before the bfloat16 subtraction, so where the two sums lie on
  either side of a rounding boundary the rounded products differ by one
  unit of |A·Aᵀ|, and the subtraction rounds once more, to the grid of
  the result, which can lie in the next binade (at n = 384 below:
  −0.902 − 3.828 → −4.719 against −0.902 − 3.844 → −4.75, one unit of
  the result and two of max(|C|, |A·Aᵀ|)). The strict upper triangle of
  C bitwise unchanged; NaN and Inf rows of A poison the same entries as
  the reference's;
- K5's tile plan at itemsize 2: the 16-byte row pad;
- the bf16 routes of K1, K2, P1, P2, P3 and P4 (launcher and plain
  version alike) equal "the float32 plain version of the upcast, rounded
  back" bit for bit, perm and info unchanged; a route's launch is counted
  under "bfloat16"; K3, K4 and P5 refuse bfloat16;
- a bfloat16 Cholesky with more than 64 block columns takes potrf's
  recursion, whose trailing updates are bf16 K5 calls, and a bfloat16
  getrf runs K2's route: both factor within bfloat16's accuracy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops import pallas_ops
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.ops import hopper_ops

torch.set_num_threads(2)

RNG = np.random.default_rng(180)
BF = torch.bfloat16


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF)


def _ulp_bf16(v):
    """One bfloat16 unit in the last place of |v| (8 significant bits)."""
    v = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(v)) - 7)


def _reference_herk(c, a, block):
    out = pallas_ops.herk_lower_update(
        jnp.asarray(c.float().numpy(), jnp.bfloat16),
        jnp.asarray(a.float().numpy(), jnp.bfloat16), block,
        interpret=True, force=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("n,k,block", [(256, 128, 128), (384, 256, 128),
                                       (256, 512, 128)])
def test_k5_bf16_plain_matches_the_pallas_kernel(n, k, block):
    c = _bf16(RNG.standard_normal((n, n)) * 4)
    a = _bf16(RNG.standard_normal((n, k)))
    ref = _reference_herk(c, a, block)
    got = hopper_ops.herk_lower_update(c.clone(), a).float().numpy()
    low = np.tril(np.ones((n, n), bool))
    a64 = a.double().numpy()
    c64 = c.double().numpy()
    prod = a64 @ a64.T
    tol = (2 * _ulp_bf16(np.abs(c64) + np.abs(prod))
           + 2 * k * 2.0 ** -24 * (np.abs(a64) @ np.abs(a64).T))
    assert (np.abs(got - ref)[low] <= tol[low]).all()
    # the port's rounding: the float32 product rounded, then subtracted
    want = (c.float() - (a.float() @ a.float().T).to(BF).float()).to(BF)
    # (the plain version's products are taken per tile pair; same sums)
    assert (np.abs(got - want.float().numpy())[low] <= tol[low]).all()
    # the strict upper triangle of C bitwise unchanged
    assert np.array_equal(got[~low], c.float().numpy()[~low])


@pytest.mark.parametrize("value", [np.nan, np.inf])
def test_k5_bf16_nonfinite_rows_poison_as_the_reference(value):
    n, k = 256, 128
    c = _bf16(RNG.standard_normal((n, n)))
    a_np = RNG.standard_normal((n, k)).astype(np.float32)
    a_np[37, 5] = value
    a = _bf16(a_np)
    ref = _reference_herk(c, a, 128)
    got = hopper_ops.herk_lower_update(c.clone(), a).float().numpy()
    low = np.tril(np.ones((n, n), bool))
    assert np.array_equal(np.isfinite(got) & low, np.isfinite(ref) & low)
    assert np.array_equal(np.isnan(got) & low, np.isnan(ref) & low)
    bad = np.zeros((n, n), bool)
    bad[37, :] = bad[:, 37] = True
    assert np.isfinite(got[low & ~bad]).all()
    assert np.array_equal(got[~low], c.float().numpy()[~low])


def test_k5_bf16_gate_and_plan():
    c, a = torch.zeros((8, 8), dtype=BF), torch.zeros((8, 2), dtype=BF)
    hopper_ops.herk_lower_update(c, a)  # accepted: the plain version
    with pytest.raises(SlateError, match="dtypes differ"):
        hopper_ops.herk_lower_update(c, a.float())
    with pytest.raises(NotImplementedError, match="bfloat16"):
        hopper_ops.herk_lower_update(c.half(), a.half())
    for n, tile in ((2048, 64), (8192, 128)):
        plan = hopper_ops.herk_plan(n, 2, 132)
        assert plan.tile == tile
        # 64 k per 128-byte chunk plus a 16-byte (8-element) pad
        row = (hopper_ops.HERK_CHUNK_BYTES // 2 + 8) * 2
        assert row % 16 == 0
        assert plan.smem_bytes == plan.stages * 2 * tile * row
        assert plan.smem_bytes <= hopper_ops.PANEL_SMEM_LIMIT
    # the float32/float64 plans keep their 4-element pad
    assert hopper_ops.herk_plan(2048, 4, 132).smem_bytes == 2 * 2 * 64 * (
        32 + 4) * 4


# -- the bf16 routes of K1, K2, P1, P2, P3 and P4 ----------------------------


def _spd_bf16(n, batch=None):
    shape = (n, n) if batch is None else (batch, n, n)
    x = RNG.standard_normal(shape)
    spd = x @ np.swapaxes(x, -1, -2) + n * np.eye(n)
    return _bf16(spd)


def _same(x, y):
    if isinstance(x, tuple):
        return all(_same(a, b) for a, b in zip(x, y))
    return x.dtype == y.dtype and torch.equal(x, y)


def _route_cases():
    tri = _bf16(np.tril(RNG.standard_normal((6, 33, 33))) + 4 * np.eye(33))
    return [
        ("chol_tile", hopper_ops.chol_tile, hopper_ops.chol_tile_plain,
         (_spd_bf16(70),)),
        ("lu_panel_base", hopper_ops.lu_panel_base,
         hopper_ops.lu_panel_base_plain,
         (_bf16(RNG.standard_normal((200, 48))),)),
        ("trtri_leaves", hopper_ops.trtri_leaves,
         hopper_ops.trtri_leaves_plain, (tri,)),
        ("trtri_leaves_unit", lambda x: hopper_ops.trtri_leaves(x, True),
         lambda x: hopper_ops.trtri_leaves_plain(x, True), (tri,)),
        ("lu_nopiv_base", hopper_ops.lu_nopiv_base,
         hopper_ops.lu_nopiv_base_plain,
         (_bf16(RNG.standard_normal((40, 40)) + 40 * np.eye(40)),)),
        ("lu_panel_batched", hopper_ops.lu_panel_batched,
         hopper_ops.lu_panel_batched_plain,
         (_bf16(RNG.standard_normal((5, 96, 32))),)),
        ("chol_tile_batched", hopper_ops.chol_tile_batched,
         hopper_ops.chol_tile_batched_plain, (_spd_bf16(48, batch=7),)),
    ]


@pytest.mark.parametrize("name,launcher,plain,args", _route_cases(),
                         ids=[c[0] for c in _route_cases()])
def test_bf16_routes_are_the_float32_version_rounded_back(name, launcher,
                                                          plain, args):
    x = args[0]
    f32 = plain(x.float())
    want = tuple(t.to(BF) if t.is_floating_point() else t
                 for t in (f32 if isinstance(f32, tuple) else (f32,)))
    for fn in (launcher, plain):
        got = fn(x)
        got = got if isinstance(got, tuple) else (got,)
        assert got[0].dtype == BF
        assert _same(got, want), name


def test_p2_inplace_bf16_route_and_its_info():
    a = RNG.standard_normal((64, 64)) + 64 * np.eye(64)
    a[20, 20] = 0.0
    a[20, :20] = 0.0  # step 21's pivot stays exactly zero
    a[:20, 20] = 0.0
    big = _bf16(np.pad(a, 3))
    view = big[3:67, 3:67]
    info = torch.zeros((), dtype=torch.int32)
    want, winfo = hopper_ops.lu_nopiv_base_plain(view.float())
    hopper_ops.lu_nopiv_base_inplace(view, info, offset=100)
    assert torch.equal(view, want.to(BF))
    assert int(info) == 100 + int(winfo) and int(winfo) == 21
    assert torch.equal(big[:3], torch.zeros_like(big[:3]))


def test_a_route_counts_its_launch_under_bfloat16():
    """The route marks the float32 instance's launch as a bfloat16 one;
    outside it a launch counts under its own type."""
    def launch(x):
        hopper_ops._count("chol_tile", x)
        return x

    before = dict(hopper_ops.TYPE_LAUNCHES["chol_tile"])
    routed = hopper_ops._via_f32(launch)
    routed(torch.zeros(2, dtype=BF))
    routed(torch.zeros(2))
    after = hopper_ops.TYPE_LAUNCHES["chol_tile"]
    assert after.get("bfloat16", 0) == before.get("bfloat16", 0) + 1
    assert after.get("float32", 0) == before.get("float32", 0) + 1
    hopper_ops.LAUNCHES["chol_tile"] -= 2
    hopper_ops.TYPE_LAUNCHES["chol_tile"] = before


def test_householder_kernels_refuse_bfloat16():
    p = torch.zeros((64, 32), dtype=BF)
    for fn in (hopper_ops.qr_panel_base, hopper_ops.qr_panel_base_wide):
        with pytest.raises((NotImplementedError, SlateError)):
            fn(p if fn is hopper_ops.qr_panel_base
               else torch.zeros((128, 64), dtype=BF))
    with pytest.raises(NotImplementedError):
        hopper_ops.qr_panel_batched(torch.zeros((2, 64, 32), dtype=BF))


# -- the bf16 factors --------------------------------------------------------


def test_bf16_potrf_recursion_runs_k5_in_bfloat16(monkeypatch):
    """n = 260 at nb = 4: 65 block columns, so potrf takes the 2×2
    recursion, whose every trailing update is one bf16 K5 call."""
    calls = []
    plain = hopper_ops.herk_lower_update_plain

    def spy(c, a, *args):
        calls.append(c.dtype)
        return plain(c, a, *args)

    monkeypatch.setattr(hopper_ops, "herk_lower_update_plain", spy)
    n, nb = 260, 4
    x = RNG.standard_normal((n, n))
    spd = x @ x.T / n + np.eye(n)
    A = stt.hermitian(_bf16(spd), nb, stt.Uplo.Lower, device="cpu")
    L, info = stt.potrf(A)
    assert int(info) == 0 and L.dtype == BF
    assert calls and set(calls) == {BF}
    l64 = L.to_numpy().astype(np.float64)
    a_bf = A.to_numpy().astype(np.float64)
    err = np.abs(l64 @ l64.T - a_bf).max() / np.abs(a_bf).max()
    assert err < n * 2.0 ** -8, err


def test_bf16_getrf_runs_the_panel_route():
    n, nb = 150, 32
    a = _bf16(RNG.standard_normal((n, n)) + 0 * np.eye(n))
    LU, perm, info = stt.getrf(stt.from_dense(a, nb, device="cpu"))
    assert int(info) == 0 and LU.dtype == BF
    lu = LU.to_numpy().astype(np.float64)
    l = np.tril(lu, -1) + np.eye(n)
    u = np.triu(lu)
    a64 = a.double().numpy()
    p = perm.numpy()[:n]
    err = np.abs(a64[p] - l @ u).max() / np.abs(a64).max()
    assert err < n * 2.0 ** -8, err
