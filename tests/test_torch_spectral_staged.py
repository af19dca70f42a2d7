"""The port's staged two-stage pipelines against slate_tpu's on the CPU
(``slate_tpu_torch/spectral/mesh.py``), on the same numpy operands:

- ``heev_staged`` at uneven n through the chased arm (he2hb, hb2td,
  stedc, unmtr_hb2td, unmtr_he2hb; n = 45 and 61 at nb = 16) in float32,
  float64, complex64 and complex128, and through the dense arm
  (npad < 3·nb: n = 30) in float64 and complex64: Λ ascending within 1e-10
  relative of the reference's in float64/complex128 (1e-4 in
  float32/complex64), the vectors compared by the phase-invariant
  |V_portᴴ·V_ref| = I (1e-8, float32/complex64 1e-3) on these
  well-separated spectra, and the port's own ‖A·V − V·Λ‖ and ‖VᴴV − I‖
  at 200·n·ε;
- ``svd_staged`` the same at (61, 45) and (70, 61) (chased: the
  Golub–Kahan embedding chased at 2·nb) and (50, 30) (dense): Σ
  descending, |U_portᴴ·U_ref| = |V_portᴴ·V_ref| = I, and the port's
  ‖A·V − U·Σ‖;
- each arm calls exactly its stages through ``obs/stages``' names (the
  dense arms: he2hb and unmtr_he2hb, ge2tb and unmbr_ge2tb);
- the level offsets equal the reference's; a wide svd operand, a
  general operand for heev and a multi-device grid raise.
"""

import functools
import types

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu import spectral as rsp
from slate_tpu.core.types import MatrixKind as RMatrixKind
import slate_tpu_torch as stt
from slate_tpu_torch import spectral as sp
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.obs.stages import wrapped_stages, wrapped_svd_stages

torch.set_num_threads(2)

NB = 16
EIG_STAGES = ("he2hb", "hb2td", "stedc", "unmtr_hb2td", "unmtr_he2hb")
SVD_STAGES = ("ge2tb", "hb2td", "stedc", "unmtr_hb2td", "unmbr_ge2tb")
CASES = ([(n, dt) for n, dt in ((45, np.float64), (61, np.complex128),
                                (45, np.float32), (61, np.complex64))]
         + [(30, np.float64), (30, np.complex64)])
SVD_CASES = ([((61, 45), dt) for dt in (np.float64, np.float32)]
             + [((70, 61), dt) for dt in (np.complex128, np.complex64)]
             + [((50, 30), dt) for dt in (np.float64, np.complex64)])


def _low(dt):
    return dt in (np.float32, np.complex64)


def _eps(dt):
    return np.finfo(np.dtype(dt).type(0).real.dtype).eps


def _operand(m, n, dt, seed, hermitian=False):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((m, n))
    if np.iscomplexobj(np.zeros(1, dt)):
        g = g + 1j * rng.standard_normal((m, n))
    if hermitian:
        g = (g + g.conj().T) / 2
    return g.astype(dt)


def _counting(calls):
    def wrap(name, fn):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return run
    return wrap


@functools.lru_cache(maxsize=None)
def _heev_pair(n, dt):
    a = _operand(n, n, dt, n, hermitian=True)
    calls = []
    with wrapped_stages(_counting(calls)):
        w, Z = sp.heev_staged(stt.from_dense(a, NB, kind=stt.MatrixKind
                                             .Hermitian, device="cpu"))
    wr, Zr = rsp.heev_staged(st.from_dense(a, NB,
                                           kind=RMatrixKind.Hermitian))
    return a, (w, Z), (np.asarray(wr), Zr.to_numpy()), calls


@functools.lru_cache(maxsize=None)
def _svd_pair(shape, dt):
    m, n = shape
    a = _operand(m, n, dt, m + n)
    calls = []
    with wrapped_svd_stages(_counting(calls)):
        s, U, V = sp.svd_staged(stt.from_dense(a, NB, device="cpu"))
    sr, Ur, Vr = rsp.svd_staged(st.from_dense(a, NB))
    return a, (s, U, V), (np.asarray(sr), Ur.to_numpy(), Vr.to_numpy()), \
        calls


def _phase_free(x, y):
    """max ||xᴴ·y| − I|: 0 when the columns agree up to a phase each."""
    return float(np.abs(np.abs(x.conj().T @ y) - np.eye(x.shape[1])).max())


@pytest.mark.parametrize("n, dt", CASES)
def test_heev_staged_matches_the_reference(n, dt):
    a, (w, Z), (wr, Vr), calls = _heev_pair(n, dt)
    assert w.dtype == torch.from_numpy(np.zeros(1, dt).real).dtype
    w, V = w.numpy(), Z.to_numpy()
    assert np.all(np.diff(w) >= 0)
    scale = np.abs(wr).max()
    tol = 1e-4 if _low(dt) else 1e-10
    np.testing.assert_allclose(w, wr, rtol=0, atol=tol * scale)
    assert _phase_free(V, Vr) < (1e-3 if _low(dt) else 1e-8)
    eps = _eps(dt)
    a64 = a.astype(np.complex128)
    assert np.abs(a64 @ V - V * w[None, :]).max() < 200 * n * eps * scale
    assert np.abs(V.conj().T @ V - np.eye(n)).max() < 200 * n * eps
    dense = -(-n // NB) * NB < 3 * NB
    assert tuple(calls) == (("he2hb", "unmtr_he2hb") if dense
                            else EIG_STAGES)


@pytest.mark.parametrize("shape, dt", SVD_CASES)
def test_svd_staged_matches_the_reference(shape, dt):
    a, (s, U, V), (sr, Ur, Vr), calls = _svd_pair(shape, dt)
    m, n = shape
    s, U, V = s.numpy(), U.to_numpy(), V.to_numpy()
    assert U.shape == (m, n) and V.shape == (n, n)
    assert np.all(np.diff(s) <= 0)
    tol = 1e-4 if _low(dt) else 1e-10
    np.testing.assert_allclose(s, sr, rtol=0, atol=tol * sr[0])
    assert max(_phase_free(U, Ur), _phase_free(V, Vr)) < \
        (1e-3 if _low(dt) else 1e-8)
    eps = _eps(dt)
    resid = np.abs(a.astype(np.complex128) @ V - U * s[None, :]).max()
    assert resid < 200 * max(m, n) * eps * s[0]
    dense = -(-n // NB) * NB < 3 * NB
    assert tuple(calls) == (("ge2tb", "unmbr_ge2tb") if dense
                            else SVD_STAGES)


@pytest.mark.parametrize("n, nb", [(45, 16), (64, 16), (200, 32), (33, 8)])
def test_level_offsets_match_the_reference(n, nb):
    assert sp.eig_level_offsets(n, nb) == rsp.eig_level_offsets(n, nb)
    assert sp.svd_level_offsets(n, nb) == rsp.svd_level_offsets(n, nb)


def test_staged_rejections():
    g = np.random.default_rng(2).standard_normal((16, 32))
    with pytest.raises(SlateError, match="wide operands are not servable"):
        sp.svd_staged(stt.from_dense(g, 16, device="cpu"))
    with pytest.raises(SlateError, match="Hermitian/Symmetric"):
        sp.heev_staged(stt.from_dense(g[:, :16], 16, device="cpu"))
    grid = types.SimpleNamespace(size=4)
    sym = stt.from_dense(np.eye(16), 16, kind=stt.MatrixKind.Hermitian,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        sp.heev_staged(sym, grid=grid)
    with pytest.raises(NotImplementedError, match="item 12"):
        sp.svd_staged(sym, grid=grid)
