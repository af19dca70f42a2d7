"""The refine engine and the mixed-precision drivers against the
reference, on the CPU (n ≤ 150, nb = 32, uneven n).

- Engine parity on the reference's own factor: the reference's
  low-precision resident (its ``make_factor_fn``) is carried into the
  port (``interop.reference.factor_from_arrays``, bfloat16 by its bits)
  and the port's ``start``/``step``/``drive`` run on it; held to the
  reference's ``drive`` on the same factor, operand and B: the same
  iteration count, and X within 10·n·ε_work·κ₁(A) relative (the two
  apply the same factor with differently ordered sums), in f32 ← bf16,
  f64 ← f32 and c128 ← c64, for lu and chol. This takes pivoting out of
  the comparison.
- End to end: ``gesv_mixed``, ``posv_mixed`` and their GMRES-IR siblings
  factor in the port: each X under the scaled-residual gate (‖B − A·X‖max
  / (‖A‖∞·‖X‖max·ε·n) ≤ 30, in float64) and within the same bound of the
  reference's X.
- The reference's own GMRES cases (tests/test_gmres.py) give the same
  codes: GMRES-IR converges where IR stagnates (cond 1e9), a singular low
  factor is −3, a hopeless one −(itermax+1) with the fallback's answer,
  and a same-dtype call short-circuits to 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import Uplo as RUplo
from slate_tpu.refine import RefinePolicy as RefPolicy
from slate_tpu.refine import engine as ref_engine
import slate_tpu_torch as stt
from slate_tpu_torch.interop.reference import factor_from_arrays
from slate_tpu_torch.refine import RefinePolicy, engine as port_engine

torch.set_num_threads(2)

N, NB = 70, 32
EPS = {"float32": 2.0 ** -23, "float64": 2.0 ** -52,
       "complex64": 2.0 ** -23, "complex128": 2.0 ** -52}
TORCH = {"float32": torch.float32, "float64": torch.float64,
         "complex64": torch.complex64, "complex128": torch.complex128}
LADDER = [("float32", "bfloat16"), ("float64", "float32"),
          ("complex128", "complex64")]


@functools.lru_cache(maxsize=None)
def _operands(dtype, n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    b = rng.standard_normal((n, 3))
    if dtype.startswith("complex"):
        x = x + 1j * rng.standard_normal((n, n))
        b = b + 1j * rng.standard_normal((n, 3))
    gen = x / np.sqrt(n) + 2 * np.eye(n)
    spd = x @ x.conj().T / n + np.eye(n)
    return gen.astype(dtype), spd.astype(dtype), b.astype(dtype)


def _kappa1(a):
    a = a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)
    return np.linalg.norm(a, 1) * np.linalg.norm(np.linalg.inv(a), 1)


def _bound(a, dtype):
    return 10 * a.shape[0] * EPS[dtype] * _kappa1(a)


def _rel(x, y):
    return np.abs(x - y).max() / np.abs(y).max()


def _scaled_residual(a, x, b, dtype):
    w = np.complex128 if np.iscomplexobj(a) else np.float64
    a, x, b = (np.asarray(v, w) for v in (a, x, b))
    return (np.abs(b - a @ x).max()
            / (np.abs(a).sum(1).max() * np.abs(x).max() * EPS[dtype]
               * a.shape[0]))


def _ref_matrix(op, a):
    return (st.hermitian(np.tril(a), nb=NB, uplo=RUplo.Lower) if op == "chol"
            else st.from_dense(a, nb=NB))


def _port_matrix(op, a):
    return (stt.hermitian(np.tril(a), NB, stt.Uplo.Lower, device="cpu")
            if op == "chol" else stt.from_dense(a, NB, device="cpu"))


@pytest.mark.parametrize("op", ["lu", "chol"])
@pytest.mark.parametrize("work,lo", LADDER)
def test_engine_on_the_reference_factor(op, work, lo):
    gen, spd, b = _operands(work)
    a = spd if op == "chol" else gen
    anorm = float(np.abs(a.astype(np.complex128)).sum(1).max())
    ref_pol = RefPolicy(factor_dtype=lo)
    factor, start, step = ref_engine._jitted_fns(
        op, st.Options(), ref_pol, work)
    RA, RB = _ref_matrix(op, a), st.from_dense(b, nb=NB)
    payload, info = factor(RA)
    assert int(info) == 0
    rx, riters, rconv = ref_engine.drive(start, step, payload, RA, RB, anorm,
                                         ref_pol, jnp.dtype(work))
    # the reference's resident, carried across (bf16 by its bits)
    arrays = ((np.asarray(payload[0].data), np.asarray(payload[1]))
              if op == "lu" else (np.asarray(payload[0].data),))
    port_payload = factor_from_arrays(op, arrays, nb=NB, logical_shape=(N, N),
                                      device="cpu")
    assert port_payload[0].dtype == getattr(torch, lo)
    pol = RefinePolicy(factor_dtype=lo)
    PA, PB = _port_matrix(op, a), stt.from_dense(b, NB, device="cpu")
    px, piters, pconv = port_engine.drive(
        port_engine.make_start_fn(op, stt.Options(), pol, TORCH[work]),
        port_engine.make_step_fn(op, stt.Options(), pol, TORCH[work]),
        port_payload, PA, PB, anorm, pol, TORCH[work])
    assert rconv and pconv
    assert piters == riters
    assert _rel(px.to_numpy(), rx.to_numpy()) <= _bound(a, work)


@pytest.mark.parametrize("op", ["lu", "chol"])
@pytest.mark.parametrize("work,lo", LADDER[:2])
def test_solve_refined_factors_in_the_port(op, work, lo):
    gen, spd, b = _operands(work)
    a = spd if op == "chol" else gen
    X, info, iters, conv = port_engine.solve_refined(
        _port_matrix(op, a), stt.from_dense(b, NB, device="cpu"), op,
        policy=RefinePolicy(factor_dtype=lo))
    assert info == 0 and conv and 1 <= iters <= 30
    assert _scaled_residual(a, X.to_numpy(), b, work) <= 30


# -- the drivers end to end ----------------------------------------------------

_DRIVERS = {"gesv_mixed": ("lu", st.gesv_mixed, stt.gesv_mixed),
            "posv_mixed": ("chol", st.posv_mixed, stt.posv_mixed),
            "gesv_mixed_gmres": ("lu", st.gesv_mixed_gmres,
                                 stt.gesv_mixed_gmres),
            "posv_mixed_gmres": ("chol", st.posv_mixed_gmres,
                                 stt.posv_mixed_gmres)}


@pytest.mark.parametrize("name,work,lo", [
    ("gesv_mixed", "float64", "float32"), ("gesv_mixed", "float32",
                                           "bfloat16"),
    ("posv_mixed", "float64", "float32"), ("posv_mixed", "float32",
                                           "bfloat16"),
    ("posv_mixed", "complex128", "complex64"),
    ("gesv_mixed_gmres", "float64", "float32"),
    ("posv_mixed_gmres", "float64", "float32")])
def test_mixed_drivers_against_the_reference(name, work, lo):
    op, ref_fn, port_fn = _DRIVERS[name]
    gen, spd, b = _operands(work, n=101, seed=3)
    a = spd if op == "chol" else gen
    n = a.shape[0]
    RA = (st.hermitian(np.tril(a), nb=NB, uplo=RUplo.Lower) if op == "chol"
          else st.from_dense(a, nb=NB))
    rx, rinfo, riters = ref_fn(RA, st.from_dense(b, nb=NB),
                               factor_dtype=jnp.dtype(lo))
    PA = (stt.hermitian(np.tril(a), NB, stt.Uplo.Lower, device="cpu")
          if op == "chol" else stt.from_dense(a, NB, device="cpu"))
    px, pinfo, piters = port_fn(PA, stt.from_dense(b, NB, device="cpu"),
                                factor_dtype=getattr(torch, lo))
    assert int(pinfo) == int(rinfo) == 0
    assert piters > 0 and riters > 0
    x = px.to_numpy()
    assert _scaled_residual(a, x, b, work) <= 30
    assert _rel(x, rx.to_numpy()) <= 10 * n * EPS[work] * _kappa1(a)


# -- the reference's GMRES cases (tests/test_gmres.py) ------------------------


def _cond_matrix(n, cond, rng):
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * np.logspace(0, -np.log10(cond), n)) @ v.T


def test_gmres_converges_where_ir_stagnates():
    """cond ≈ 1e9 (the reference's premise seed): IR from an f32 factor
    does not reach 1e-5 forward error; GMRES-IR does, in both packages."""
    n, nb = 96, 32
    rng = np.random.default_rng(0)
    a = _cond_matrix(n, 1e9, rng)
    x_true = rng.standard_normal((n, 1))
    b = a @ x_true
    ropts = st.Options(use_fallback_solver=False, max_iterations=90)
    popts = stt.Options(use_fallback_solver=False, max_iterations=90)
    _, _, r_iters = st.gesv_mixed_gmres(st.from_dense(a, nb=nb),
                                        st.from_dense(b, nb=nb), ropts)
    A = stt.from_dense(a, nb, device="cpu")
    B = stt.from_dense(b, nb, device="cpu")
    X1, _, _ = stt.gesv_mixed(A, B, popts)
    X, info, iters = stt.gesv_mixed_gmres(A, B, popts)

    def err(x):
        return np.linalg.norm(x - x_true) / np.linalg.norm(x_true)

    assert not err(X1.to_numpy()) < 1e-5  # the premise: IR stagnates
    assert int(info) == 0 and iters >= 0 and r_iters >= 0
    assert err(X.to_numpy()) < 1e-5


def test_gmres_singular_low_factor_is_minus_3():
    n = 8
    z, one = np.zeros((n, n)), np.ones((n, 1))
    _, rinfo, riters = st.gesv_mixed_gmres(
        st.from_dense(z, nb=8), st.from_dense(one, nb=8),
        st.Options(use_fallback_solver=False))
    _, pinfo, piters = stt.gesv_mixed_gmres(
        stt.from_dense(z, 8, device="cpu"),
        stt.from_dense(one, 8, device="cpu"),
        stt.Options(use_fallback_solver=False))
    assert piters == riters == -3
    assert int(pinfo) == int(rinfo) > 0


def test_gmres_hopeless_factor_falls_back_with_its_code():
    """cond 1e15, beyond f32: GMRES-IR itself fails, −(itermax+1), and
    the full-precision fallback answers (backward error ≤ 1e-12)."""
    n, nb = 64, 16
    rng = np.random.default_rng(42)
    a = _cond_matrix(n, 1e15, rng)
    b = a @ rng.standard_normal((n, 1))
    _, _, riters = st.gesv_mixed_gmres(st.from_dense(a, nb=nb),
                                       st.from_dense(b, nb=nb))
    X, _, piters = stt.gesv_mixed_gmres(stt.from_dense(a, nb, device="cpu"),
                                        stt.from_dense(b, nb, device="cpu"))
    assert piters == riters == -(stt.Options().max_iterations + 1)
    x = X.to_numpy()
    assert (np.linalg.norm(a @ x - b)
            / (np.linalg.norm(a) * np.linalg.norm(x))) < 1e-12


def test_gmres_same_dtype_short_circuits():
    gen, spd, b = _operands("float32", n=40, seed=5)
    for ref_fn, port_fn, a, make_r, make_p in (
            (st.posv_mixed_gmres, stt.posv_mixed_gmres, spd,
             lambda m: st.hermitian(np.tril(m), nb=8, uplo=RUplo.Lower),
             lambda m: stt.hermitian(np.tril(m), 8, stt.Uplo.Lower,
                                     device="cpu")),
            (st.gesv_mixed_gmres, stt.gesv_mixed_gmres, gen,
             lambda m: st.from_dense(m, nb=8),
             lambda m: stt.from_dense(m, 8, device="cpu"))):
        _, rinfo, riters = ref_fn(make_r(a), st.from_dense(b, nb=8),
                                  factor_dtype=jnp.float32)
        X, pinfo, piters = port_fn(make_p(a),
                                   stt.from_dense(b, 8, device="cpu"),
                                   factor_dtype=torch.float32)
        assert piters == riters == 0 and int(pinfo) == int(rinfo) == 0
        assert _scaled_residual(a, X.to_numpy(), b, "float32") <= 30
