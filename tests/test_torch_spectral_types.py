"""The port's spectral catalog and applies against slate_tpu's on the CPU
(``slate_tpu_torch/spectral/types.py`` and ``apply.py``):

- every weight function of ``EIG_FUNCTIONS`` and ``SVD_FUNCTIONS`` on the
  same numpy spectrum and θ, in float32 and float64, within 1 ulp of the
  reference's, with the edge rules named: a tied |λ| group kept whole,
  zero σ given zero weight, θ at rank 0, at n, past n, below 0 and at
  half-integers (rounded half to even), whiten's ridge added before the
  inverse (square root), and each function in the spectrum's type;
- the catalogs' shapes (names, directions) and ``function_catalog``;
- ``make_apply_fn`` (every function) and ``make_probe_fn`` on one
  reference resident (slate_tpu's ``heev_staged`` / ``svd_staged`` at
  uneven n, nb = 16, float64 and complex128) carried into the port by
  ``interop.reference.factor_from_arrays``: X to 1e-12 relative to the
  reference's, the probe's triple to 1e-12 relative.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu import spectral as rsp
from slate_tpu.core.types import MatrixKind as RMatrixKind
import slate_tpu_torch as stt
from slate_tpu_torch import spectral as sp
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.interop.reference import factor_from_arrays

torch.set_num_threads(2)

THETAS = (0.0, 0.37, -2.5, 1.0, 2.5, 3.5, 6.0, 7.0, 7.5, 100.0, -1.0)


def _spectra(dt):
    """Spectra with ties in |λ|, zeros and both signs (eig: ascending;
    svd: descending, non-negative, zeros last)."""
    lam = np.array([-3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0], dt)
    s = np.array([5.0, 4.0, 4.0, 2.5, 1.0, 0.0, 0.0], dt)
    return {"eig": lam, "svd": s}


def _both(op, fname, x, theta):
    """(port's weights, reference's weights) of one function as numpy."""
    wf = sp.function_catalog(op)[fname][0]
    rwf = rsp.function_catalog(op)[fname][0]
    tx = torch.as_tensor(x)
    got = wf(tx, torch.tensor(theta, dtype=tx.dtype))
    want = rwf(jnp.asarray(x), jnp.asarray(theta, x.dtype))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("op, fname", [("eig", f) for f in sp.EIG_FUNCTIONS]
                         + [("svd", f) for f in sp.SVD_FUNCTIONS])
def test_weights_match_the_reference(op, fname, dt):
    x = _spectra(dt)[op]
    rng = np.random.default_rng(3)
    spectra = [x, rng.standard_normal(13).astype(dt)]
    if op == "eig":
        spectra[1] = np.sort(spectra[1])
    else:
        spectra[1] = np.sort(np.abs(spectra[1]))[::-1].copy()
    for spec in spectra:
        for theta in THETAS + (float(rng.uniform(-3, 3)),):
            got, want = _both(op, fname, spec, theta)
            assert got.dtype == want.dtype == spec.dtype, (fname, theta)
            np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_eig_truncate_keeps_tied_groups_and_rounds_half_to_even():
    lam = torch.tensor([-3.0, -1.0, 1.0, 2.0, 3.0], dtype=torch.float64)
    wf = sp.EIG_FUNCTIONS["truncate"][0]

    def kept(theta):
        w = wf(lam, torch.tensor(theta, dtype=torch.float64))
        return (w != 0).tolist()

    assert kept(0.0) == [False] * 5            # rank 0
    assert kept(-1.0) == [False] * 5           # clamped to 0
    assert kept(1.0) == [True, False, False, False, True]  # |−3| = |3| tie
    assert kept(2.5) == kept(2.0)              # half to even: 2
    assert kept(3.5) == [True] * 5             # 4, and the |1| tie
    assert kept(5.0) == kept(9.0) == [True] * 5  # n and past n


def test_svd_weights_zero_sigma_and_rank_rules():
    s = torch.tensor([2.0, 1.0, 0.0, 0.0], dtype=torch.float64)
    th = functools.partial(torch.tensor, dtype=torch.float64)
    for fname in ("solve", "whiten"):
        w = sp.SVD_FUNCTIONS[fname][0](s, th(0.0))
        assert w[2:].tolist() == [0.0, 0.0] and bool((w[:2] > 0).all())
    tr = sp.SVD_FUNCTIONS["truncate"][0]
    assert tr(s, th(0.5)).tolist() == [0.0] * 4          # half to even: 0
    assert tr(s, th(1.5)).tolist() == [2.0, 1.0, 0, 0]   # 2
    assert tr(s, th(1e9)).tolist() == s.tolist()
    # whiten's ridge goes before the inverse (square root)
    lam = torch.tensor([-1.0, 3.0], dtype=torch.float64)
    assert sp.EIG_FUNCTIONS["whiten"][0](lam, th(1.0)).tolist() == \
        [0.0, 0.5]
    assert sp.SVD_FUNCTIONS["whiten"][0](s, th(2.0))[0] == 0.25


def test_catalogs_have_the_reference_shape():
    for op in ("eig", "svd"):
        cat, ref = sp.function_catalog(op), rsp.function_catalog(op)
        assert {k: v[1] for k, v in cat.items()} == \
            {k: v[1] for k, v in ref.items()}
    assert sorted(sp.__all__) == sorted(rsp.__all__)
    with pytest.raises(SlateError, match="unknown spectral function"):
        sp.make_apply_fn("eig", "sqrtm")


# -- applies on a reference resident ---------------------------------------

def _operand(op, m, n, dt, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((m, n))
    if np.iscomplexobj(np.zeros(1, dt)):
        g = g + 1j * rng.standard_normal((m, n))
    if op == "eig":
        g = (g + g.conj().T) / 2
    return g.astype(dt)


@functools.lru_cache(maxsize=None)
def _resident(op, dt):
    """A reference resident at uneven shapes, nb = 16, as numpy arrays,
    with its operand: eig (45, 45), svd (61, 37)."""
    m, n = (45, 45) if op == "eig" else (61, 37)
    a = _operand(op, m, n, dt, 11)
    if op == "eig":
        lam, V = rsp.heev_staged(st.from_dense(a, 16,
                                               kind=RMatrixKind.Hermitian))
        return a, (np.asarray(V.data), np.asarray(lam))
    s, U, V = rsp.svd_staged(st.from_dense(a, 16))
    return a, (np.asarray(U.data), np.asarray(s), np.asarray(V.data))


def _payloads(op, dt):
    a, arrays = _resident(op, dt)
    m, n = a.shape
    port = factor_from_arrays(op, arrays, nb=16, logical_shape=(m, n),
                              device="cpu")
    if op == "eig":
        ref = rsp.EigFactors(st.from_dense(arrays[0], 16,
                                           logical_shape=(n, n)),
                             jnp.asarray(arrays[1]))
    else:
        k = min(m, n)
        ref = rsp.SVDFactors(
            st.from_dense(arrays[0], 16, logical_shape=(m, k)),
            jnp.asarray(arrays[1]),
            st.from_dense(arrays[2], 16, logical_shape=(n, k)))
    return a, port, ref


@pytest.mark.parametrize("dt", [np.float64, np.complex128])
@pytest.mark.parametrize("op, fname", [("eig", f) for f in sp.EIG_FUNCTIONS]
                         + [("svd", f) for f in sp.SVD_FUNCTIONS])
def test_apply_matches_the_reference_on_one_resident(op, fname, dt):
    a, port, ref = _payloads(op, dt)
    m, n = a.shape
    rows = n if (op == "eig" or sp.function_catalog(op)[fname][1]) else m
    b = _operand("svd", rows, 3, dt, 12)
    theta = {"solve": 0.37, "truncate": 5.0}.get(fname, 0.25)
    X = sp.make_apply_fn(op, fname)(
        port, stt.from_dense(b, 16, device="cpu"),
        torch.tensor(theta, dtype=torch.float64))
    R = rsp.make_apply_fn(op, fname)(ref, st.from_dense(b, 16),
                                     jnp.asarray(theta, jnp.float64))
    x, xr = X.to_numpy(), R.to_numpy()
    out = m if (op == "svd" and rows == n) else n
    assert x.shape == xr.shape == (out, 3)
    np.testing.assert_allclose(x, xr, rtol=0,
                               atol=1e-12 * max(np.abs(xr).max(), 1.0))


@pytest.mark.parametrize("dt", [np.float64, np.complex128])
@pytest.mark.parametrize("op", ["eig", "svd"])
def test_probe_matches_the_reference_on_one_resident(op, dt):
    a, port, ref = _payloads(op, dt)
    kind = dict(kind=RMatrixKind.Hermitian) if op == "eig" else {}
    pkind = dict(kind=stt.MatrixKind.Hermitian) if op == "eig" else {}
    got = sp.make_probe_fn(op)(port, stt.from_dense(a, 16, device="cpu",
                                                    **pkind)).numpy()
    want = np.asarray(rsp.make_probe_fn(op)(ref, st.from_dense(a, 16,
                                                               **kind)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    assert got[0] < 1e-12 * got[2]  # a small eigen-residual
