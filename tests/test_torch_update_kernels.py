"""The plain versions of the update kernels P6 (``chol_update_sweep``), P7
(``qr_append_build``) and P8 (``qr_append_apply``) and the port's
``linalg/update.py`` against the reference's ``slate_tpu/linalg/update.py``
on the CPU, on the same numpy inputs from a seed.

- P6 against ``chol_update_dense``: real and complex, k ∈ {1, 3}, odd n
  with pad lanes (n = 21 in 32 rows), update and downdate, within 1e-12
  (float64/complex128) and 1e-5 relative (float32/complex64) of the
  reference's factor; a failed downdate reports the reference's info and
  stays finite; the downdate undoes the update (against numpy's
  Cholesky, the reference's own test);
- zero lanes are bitwise no-ops: W = 0 leaves L unchanged, and k = 3 at
  bucket 4 equals k = 3 at bucket 8; a B-stacked lane is bitwise its
  B = 1 run;
- P7 against ``qr_append_build`` (w, tau, r) within 1e-12 / 1e-5, a zero
  appended block leaves R unchanged bit for bit with tau = 0 and w = 0,
  and the live rows' results do not depend on the bucket;
- ``appended_gels`` (unmqr, P8, trsm) against the reference's and against
  numpy's least-squares solution of the stacked operand;
- the wrappers' checks (the rank buckets, shapes) and P6's plan.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slate_tpu.core.tiled_matrix import from_dense as ref_from_dense
from slate_tpu.linalg import update as ref_upd
from slate_tpu.linalg.qr import geqrf as ref_geqrf
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.interop.reference import factor_from_arrays
from slate_tpu_torch.linalg import update as upd
from slate_tpu_torch.ops import hopper_ops as ho

torch.set_num_threads(2)

N, NPAD, NB, M = 21, 32, 16, 45
TOL = {np.float64: 1e-12, np.complex128: 1e-12, np.float32: 1e-5,
       np.complex64: 1e-5}
TYPES = (np.float64, np.complex128, np.float32, np.complex64)


def _rng(seed):
    return np.random.default_rng(seed)


def _draw(rng, shape, dt):
    x = rng.standard_normal(shape)
    if np.iscomplexobj(np.zeros(1, dt)):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dt)


def _factor(rng, dt, n=N, npad=NPAD):
    """A padded lower Cholesky factor of an SPD (HPD) operand, and the
    operand."""
    x = _draw(rng, (n, n), np.complex128 if np.iscomplexobj(
        np.zeros(1, dt)) else np.float64)
    a = x @ x.conj().T + n * np.eye(n)
    l = np.zeros((npad, npad), dt)
    l[:n, :n] = np.linalg.cholesky(a)
    return l, a


def _vectors(rng, dt, k, kb, n=N, npad=NPAD):
    w = np.zeros((npad, kb), dt)
    w[:n, :k] = _draw(rng, (n, k), dt)
    return w


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("sign", [1, -1])
def test_chol_update_plain_matches_reference(dt, k, sign):
    rng = _rng(40 + k)
    l, _ = _factor(rng, dt)
    w = 0.3 * _vectors(rng, dt, k, upd.bucket_k(k))
    lr, ir = ref_upd.chol_update_dense(l, w, sign, n=N)
    lt = torch.tensor(l)
    info = ho.chol_update_sweep(lt, torch.tensor(w), sign, N)
    assert int(info) == int(ir) == 0
    assert _rel(lt.numpy(), np.asarray(lr)) <= TOL[dt]
    # the strict upper triangle and the padding are untouched
    assert np.array_equal(np.triu(lt.numpy(), 1), np.triu(l, 1))
    assert np.array_equal(lt.numpy()[N:], l[N:])


@pytest.mark.parametrize("dt", [np.float64, np.complex128])
def test_downdate_undoes_the_update(dt):
    rng = _rng(7)
    l, a = _factor(rng, dt)
    w = _vectors(rng, dt, 2, 2)
    wn = w[:N]
    l_up = np.zeros_like(l)
    l_up[:N, :N] = np.linalg.cholesky(a + wn @ wn.conj().T)
    lt = torch.tensor(l_up)
    assert int(ho.chol_update_sweep(lt, torch.tensor(w), -1, N)) == 0
    got = lt.numpy()[:N, :N]
    # column phases are a sweep choice in complex: compare L·Lᴴ
    np.testing.assert_allclose(got @ got.conj().T, a, rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("dt", TYPES)
def test_failed_downdate_info_is_the_reference_and_finite(dt):
    rng = _rng(8)
    l, _ = _factor(rng, dt)
    w = 10.0 * _vectors(rng, dt, 3, 4)
    lr, ir = ref_upd.chol_update_dense(l, w, -1, n=N)
    lt = torch.tensor(l)
    info = ho.chol_update_sweep(lt, torch.tensor(w), -1, N)
    assert int(info) == int(ir) > 0
    assert np.isfinite(lt.numpy()).all()
    # frozen from the failed rotation on: the columns after it untouched
    j = int(info)
    assert np.array_equal(lt.numpy()[:, j:], l[:, j:])
    assert _rel(lt.numpy(), np.asarray(lr)) <= TOL[dt]


@pytest.mark.parametrize("dt", TYPES)
def test_zero_lanes_are_bitwise_no_ops(dt):
    rng = _rng(9)
    l, _ = _factor(rng, dt)
    lt = torch.tensor(l)
    ho.chol_update_sweep(lt, torch.zeros((NPAD, 4), dtype=lt.dtype), 1, N)
    assert torch.equal(lt, torch.tensor(l))
    w = _vectors(rng, dt, 3, 8)
    l4, l8 = torch.tensor(l), torch.tensor(l)
    ho.chol_update_sweep(l4, torch.tensor(w[:, :4]), 1, N)
    ho.chol_update_sweep(l8, torch.tensor(w), 1, N)
    assert torch.equal(l4, l8)


@pytest.mark.parametrize("dt", [np.float32, np.complex128])
@pytest.mark.parametrize("sign", [1, -1])
def test_batched_lane_is_bitwise_its_single_run(dt, sign):
    rng = _rng(10)
    n, bsz = 16, 3
    ls = np.stack([_factor(rng, dt, n, n)[0] for _ in range(bsz)])
    ws = np.stack([_vectors(rng, dt, 2, 2, n, n) for _ in range(bsz)])
    ws[1] *= 10.0  # the middle item's downdate fails alone
    lb = torch.tensor(ls)
    infos = upd.chol_update_batched(lb, torch.tensor(ws), sign,
                                    inplace=True)[1]
    rb, ri = ref_upd.chol_update_batched(jnp.asarray(ls), jnp.asarray(ws),
                                         sign)
    assert infos.tolist() == np.asarray(ri).tolist()
    for i in range(bsz):
        l1 = torch.tensor(ls[i][None])
        i1 = ho.chol_update_sweep(l1, torch.tensor(ws[i][None]), sign)
        assert torch.equal(lb[i], l1[0]) and int(i1[0]) == int(infos[i])
        if int(infos[i]) == 0:
            assert _rel(lb[i].numpy(), np.asarray(rb[i])) <= TOL[dt]


def test_chol_update_factor_keeps_the_tiled_form_and_storage():
    rng = _rng(11)
    x = rng.standard_normal((N, N))
    a = x @ x.T + N * np.eye(N)
    L, _ = stt.chol_factor(stt.hermitian(a, NB, stt.Uplo.Lower,
                                         device="cpu"))
    w = torch.tensor(_vectors(rng, np.float64, 2, 2))
    L2, info = upd.chol_update_factor(L, w, 1)
    assert int(info) == 0 and L2.data.data_ptr() != L.data.data_ptr()
    assert (L2.m, L2.n, L2.nb, L2.kind, L2.uplo) == (L.m, L.n, L.nb, L.kind,
                                                      L.uplo)
    L3, _ = upd.chol_update_factor(L, w, 1, inplace=True)
    assert L3 is L and torch.equal(L.data, L2.data)
    ln = L.to_numpy()
    wn = w.numpy()[:N]
    np.testing.assert_allclose(ln @ ln.T, a + wn @ wn.T, rtol=1e-12)


def _qr_case(rng, dt, p, P):
    a = _draw(rng, (M, N), dt)
    qr = ref_geqrf(ref_from_dense(a, NB))
    u = np.zeros((P, np.asarray(qr.vr).shape[1]), dt)
    u[:p, :N] = _draw(rng, (p, N), dt)
    return a, qr, u


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("p", [1, 3])
def test_qr_append_build_plain_matches_reference(dt, p):
    rng = _rng(20 + p)
    _, qr, u = _qr_case(rng, dt, p, upd.bucket_k(p))
    wr, taur, rr = ref_upd.qr_append_build(qr.vr, jnp.asarray(u), N)
    w, tau, r = upd.qr_append_build(torch.tensor(np.asarray(qr.vr)),
                                    torch.tensor(u), N)
    for got, want in ((r, rr), (w, wr), (tau, taur)):
        assert _rel(got.numpy(), np.asarray(want)) <= TOL[dt]
    assert not torch.any(w[:, N:]) and not torch.any(tau[N:])


@pytest.mark.parametrize("dt", TYPES)
def test_zero_appended_rows_are_bitwise_no_ops(dt):
    rng = _rng(30)
    _, qr, u = _qr_case(rng, dt, 3, 8)
    vr = torch.tensor(np.asarray(qr.vr))
    r0 = torch.triu(vr[:NPAD, :NPAD])
    w, tau, r = upd.qr_append_build(vr, torch.zeros((4, NPAD),
                                                    dtype=vr.dtype), N)
    assert torch.equal(r, r0) and not torch.any(w) and not torch.any(tau)
    w4, tau4, r4 = upd.qr_append_build(vr, torch.tensor(u[:4]), N)
    w8, tau8, r8 = upd.qr_append_build(vr, torch.tensor(u), N)
    assert torch.equal(r4, r8) and torch.equal(tau4, tau8)
    assert torch.equal(w4[:3], w8[:3])


@pytest.mark.parametrize("dt", TYPES)
def test_appended_gels_matches_reference_and_lstsq(dt):
    rng = _rng(31)
    p = 3
    a, qr, u = _qr_case(rng, dt, p, 4)
    wr, taur, rr = ref_upd.qr_append_build(qr.vr, jnp.asarray(u), N)
    b = _draw(rng, (M + p, 2), dt)
    xr = ref_upd.appended_gels((qr, jnp.asarray(u), wr, taur, rr),
                               ref_from_dense(b, NB)).to_numpy()
    payload = factor_from_arrays(
        "qr", ((np.asarray(qr.vr), np.asarray(qr.t)), u, np.asarray(wr),
               np.asarray(taur), np.asarray(rr)), nb=NB, logical_shape=(M, N),
        device="cpu")
    x = upd.appended_gels(payload, stt.from_dense(b, NB, device="cpu"))
    assert x.shape == (N, 2)
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    want = np.linalg.lstsq(np.vstack([a, u[:p, :N]]).astype(wide),
                           b.astype(wide), rcond=None)[0]
    assert _rel(x.to_numpy(), np.asarray(xr)) <= 10 * TOL[dt]
    assert _rel(x.to_numpy(), want) <= 100 * TOL[dt]
    # P8 alone against its inputs' reference sweep: the port's P7 output
    pt = upd.qr_append_factor(payload[0], torch.tensor(u))
    ct = torch.tensor(_draw(rng, (NPAD, 3), dt))
    d = torch.zeros((4, 3), dtype=ct.dtype)
    d[:p] = torch.tensor(_draw(rng, (p, 3), dt))
    c1 = ct.clone()
    ho.qr_append_apply(c1, d, pt[0], pt[1], N)
    # applying the reflectors keeps ‖[ct[:N]; d]‖ (an orthogonal map)
    before = np.linalg.norm(np.vstack([ct.numpy()[:N], d.numpy()]))
    rest = np.linalg.norm(c1.numpy()[:N])
    assert rest <= before * (1 + 10 * TOL[dt])
    assert torch.equal(c1[N:], ct[N:])


def test_wrappers_check_buckets_and_shapes():
    l = torch.eye(8, dtype=torch.float64)
    with pytest.raises(SlateError, match="bucket"):
        ho.chol_update_sweep(l, torch.zeros((8, 3), dtype=l.dtype), 1)
    with pytest.raises(SlateError, match="sign"):
        ho.chol_update_sweep(l, torch.zeros((8, 2), dtype=l.dtype), 0)
    with pytest.raises(SlateError, match="expects"):
        ho.chol_update_sweep(l, torch.zeros((7, 2), dtype=l.dtype), 1)
    with pytest.raises(NotImplementedError):
        ho.chol_update_sweep(l.to(torch.int64), torch.zeros((8, 2),
                                                            dtype=torch.int64),
                             1)
    with pytest.raises(SlateError, match="bucket"):
        ho.qr_append_build(l.clone(), torch.zeros((5, 8), dtype=l.dtype), 8)
    with pytest.raises(SlateError, match="expects"):
        ho.qr_append_apply(l.clone(), torch.zeros((2, 8), dtype=l.dtype),
                           torch.zeros((2, 7), dtype=l.dtype),
                           torch.zeros(8, dtype=l.dtype), 8)
    with pytest.raises(NotImplementedError):
        ho.qr_append_build(l.to(torch.bfloat16),
                           torch.zeros((2, 8), dtype=torch.bfloat16), 8)


def test_chol_update_plan_and_buckets():
    assert ho.chol_update_plan(1, 1, 4) == (1, 32, 2)
    assert ho.chol_update_plan(256, 1, 4) == (1, 256, 2)
    assert ho.chol_update_plan(257, 1, 4) == (3, 128, 2)
    assert ho.chol_update_plan(16384, 1, 4) == (128, 128, 2)
    assert [upd.bucket_k(k) for k in (0, 1, 2, 3, 5, 16)] == [1, 1, 2, 4, 8,
                                                              16]
    with pytest.raises(SlateError):
        ho.chol_update_plan(0, 1, 4)


def test_bf16_route_sweeps_a_float32_copy():
    rng = _rng(12)
    l, _ = _factor(rng, np.float64)
    w = _vectors(rng, np.float64, 2, 2)
    lb = torch.tensor(l).to(torch.bfloat16)
    wb = torch.tensor(w).to(torch.bfloat16)
    l32 = lb.float()
    ho.chol_update_sweep(l32, wb.float(), 1, N)
    ptr = lb.data_ptr()
    ho.chol_update_sweep(lb, wb, 1, N)
    assert lb.data_ptr() == ptr and torch.equal(lb, l32.to(torch.bfloat16))


def test_cpu_runs_launch_nothing():
    ho.reset_launches()
    rng = _rng(13)
    l, _ = _factor(rng, np.float64)
    ho.chol_update_sweep(torch.tensor(l), torch.tensor(
        _vectors(rng, np.float64, 1, 1)), 1, N)
    assert ho.LAUNCHES["chol_update_sweep"] == 0
