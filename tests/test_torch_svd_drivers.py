"""The port's svd driver against slate_tpu and numpy on the same numpy
inputs (CPU):

- every arm of the reference's dispatch — MethodSVD.DC (ge2bd + bdsqr),
  Auto at min(m, n) ≥ ``_DC_MIN_N`` (patched to 48 in both packages),
  the band arm (ge2tb + hb2td + stedc on the Golub–Kahan embedding, both
  packages' ``_BAND_DC_MIN`` patched to 64), the dense band arm, the tall
  pre-QR arm (m ≥ 2n: geqrf, the SVD of R, unmqr) and the wide arm
  (through Aᴴ) — at uneven shapes in float32, float64, complex64 and
  complex128, with vectors and values only: σ against numpy's in every
  type, and against the reference's in one type per arm, the types
  rotated so that each appears (σ within 1e-9 absolute and relative in
  float64 and complex128, tests/test_eig_svd.py::test_svd_values, and
  1e-4·σ₁ in float32 and complex64); U·Σ·Vᴴ = A and UᴴU = VᴴV = I at
  tests/test_eig_svd.py's bounds in float64 and complex128 (entrywise
  1e-10·σ₁·max(m, n) and 1e-11·m), and in every type at the smoke's
  gates in units of ε (‖A − U·Σ·Vᴴ‖₁/(‖A‖₁·max(m, n)·ε) < 500,
  ‖UᴴU − I‖₁/(m·ε) < 500, ‖VᴴV − I‖₁/(n·ε) < 500);
- a rank-deficient A on the DC and band arms: the zero σ below
  1e-10·σ₁ and the completed columns orthonormal
  (tests/test_eig_svd.py::test_svd_band_gk_rank_deficient's bounds);
- each arm calls exactly its stages through ``obs/stages.SVD_STAGES``,
  and the hooks are restored;
- ``bdsqr`` and ``svd`` on a card by default: without one, bdsqr with no
  ``device`` raises, while svd of a CPU matrix runs on the CPU.
"""

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import MethodSVD as RMethodSVD, Options as ROptions
from slate_tpu.linalg import svd_module as ref_svd
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.linalg import svd as svd_mod

torch.set_num_threads(2)

TYPES = (np.float64, np.complex128, np.float32, np.complex64)
# arm: (m, n, nb, method, the type held to the reference)
ARMS = {"dc": (70, 50, 16, "DC", np.complex128),
        "auto_dc": (60, 50, 16, "Auto", np.float32),
        "band": (70, 60, 8, "Auto", np.float64),
        "dense_band": (70, 50, 8, "Auto", np.complex64),
        "tall": (100, 30, 16, "Auto", np.float64),
        "wide": (50, 70, 16, "QR", np.complex128)}


def _eps(dt):
    return np.finfo(np.dtype(dt).type(0).real.dtype).eps


def _is_complex(dt):
    return np.iscomplexobj(np.zeros(1, dt))


def _matrix(m, n, seed, dt, rank=None):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        g = rng.standard_normal(shape)
        return g + 1j * rng.standard_normal(shape) if _is_complex(dt) else g
    a = draw(m, n) if rank is None else draw(m, rank) @ draw(rank, n)
    return (a / np.sqrt(max(m, n))).astype(dt)


def _patch(monkeypatch, arm):
    """The thresholds that send the small test shapes down ``arm``, in
    both packages."""
    for mod in (svd_mod, ref_svd):
        if arm == "auto_dc":
            monkeypatch.setattr(mod, "_DC_MIN_N", 48)
        if arm == "band":
            monkeypatch.setattr(mod, "_BAND_DC_MIN", 64)


def _value_tol(dt, s):
    if dt in (np.float32, np.complex64):
        return 1e-4 * max(1.0, np.abs(s).max())
    return 1e-9 + 1e-9 * np.abs(s)


def _gates(a, s, u, v, dt):
    """(reconstruction, U orthogonality, V orthogonality) in units of ε,
    and the same three entrywise against the reference's bounds."""
    m, n = a.shape
    k = min(m, n)
    a = a.astype(np.complex128)
    eps = _eps(dt)
    rec = u @ (s[:, None] * v.conj().T) - a
    ou = u.conj().T @ u - np.eye(k)
    ov = v.conj().T @ v - np.eye(k)
    units = (np.linalg.norm(rec, 1) / (np.linalg.norm(a, 1) * max(m, n)
                                       * eps),
             np.linalg.norm(ou, 1) / (m * eps),
             np.linalg.norm(ov, 1) / (n * eps))
    entry = (np.abs(rec).max() / (s[0] * max(m, n)), np.abs(ou).max() / m,
             np.abs(ov).max() / n)
    return units, entry


@pytest.fixture(scope="module")
def runs():
    """Every arm in every type (the port), and the reference in the arm's
    type; values only and with vectors."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for arm, (m, n, nb, method, ref_dt) in ARMS.items():
            mp.undo()
            _patch(mp, arm)
            o = stt.Options(method_svd=getattr(stt.MethodSVD, method))
            for dt in TYPES:
                a = _matrix(m, n, 3, dt)
                A = stt.from_dense(a, nb, device="cpu")
                s, U, V = stt.svd(A, o, want_vectors=True)
                sv, Uv, Vv = stt.svd(A, o)
                r = dict(a=a, s=s, u=U.to_numpy().astype(np.complex128),
                         v=V.to_numpy().astype(np.complex128), sv=sv,
                         none=(Uv, Vv),
                         np=np.linalg.svd(a.astype(np.complex128),
                                          compute_uv=False))
                if dt is ref_dt:
                    ro = ROptions(method_svd=getattr(RMethodSVD, method))
                    R = st.from_dense(a, nb=nb)
                    r["ref"] = np.asarray(st.svd(R, ro,
                                                 want_vectors=True)[0])
                    r["ref_values"] = np.asarray(st.svd(R, ro)[0])
                out[(arm, dt)] = r
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("arm", list(ARMS))
def test_svd_values_match_numpy_and_reference(runs, arm, dt):
    r = runs[(arm, dt)]
    m, n = ARMS[arm][:2]
    k = min(m, n)
    real = torch.float32 if dt in (np.float32, np.complex64) else \
        torch.float64
    assert r["s"].dtype == real and r["sv"].dtype == real
    assert r["none"] == (None, None)
    pairs = [(r["s"].numpy(), r["np"]), (r["sv"].numpy(), r["np"])]
    if "ref" in r:
        pairs += [(r["s"].numpy(), r["ref"]),
                  (r["sv"].numpy(), r["ref_values"])]
    for got, want in pairs:
        assert got.shape == (k,)
        assert np.all(np.abs(got - want) <= _value_tol(dt, want))
    assert np.all(np.diff(r["s"].numpy()) <= 0)


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("arm", list(ARMS))
def test_svd_vectors_reconstruct_and_are_orthonormal(runs, arm, dt):
    r = runs[(arm, dt)]
    m, n = ARMS[arm][:2]
    k = min(m, n)
    assert r["u"].shape == (m, k) and r["v"].shape == (n, k)
    units, entry = _gates(r["a"], r["s"].numpy().astype(np.float64),
                          r["u"], r["v"], dt)
    assert max(units) < 500, units
    if dt in (np.float64, np.complex128):
        assert entry[0] < 1e-10 and entry[1] < 1e-11 \
            and entry[2] < 1e-11, entry


@pytest.mark.parametrize("arm,dt", [("dc", np.float64),
                                    ("dc", np.complex128),
                                    ("band", np.float64)])
def test_svd_rank_deficient(arm, dt, monkeypatch):
    """Rank 30 of 50 (DC) and 40 of 60 (band): the zero σ and the
    completed singular vectors, at the reference's own test's bounds."""
    _patch(monkeypatch, arm)
    m, n, nb, method, _ = ARMS[arm]
    rank = 30 if arm == "dc" else 40
    a = _matrix(m, n, 23, dt, rank=rank)
    A = stt.from_dense(a, nb, device="cpu")
    s, U, V = stt.svd(A, stt.Options(
        method_svd=getattr(stt.MethodSVD, method)), want_vectors=True)
    s = s.numpy()
    u, v = U.to_numpy(), V.to_numpy()
    assert np.abs(s[rank:]).max() < 1e-10 * s[0]
    assert np.abs(s[:rank] - np.linalg.svd(a, compute_uv=False)[:rank]).max() \
        < 1e-10 * s[0]
    assert np.abs(u.conj().T @ u - np.eye(n)).max() < 1e-10 * n
    assert np.abs(v.conj().T @ v - np.eye(n)).max() < 1e-10 * n
    assert np.abs(u @ np.diag(s) @ v.conj().T - a).max() < 1e-10 * s[0] * n
    sv = stt.svd(A, stt.Options(method_svd=getattr(stt.MethodSVD, method)))[0]
    assert np.abs(sv.numpy() - s).max() < 1e-10 * s[0]


# -- stage hooks --------------------------------------------------------------

@pytest.mark.parametrize("arm,vectors,stages", [
    ("dc", True, {"ge2bd", "bdsqr", "stedc", "unmbr_ge2bd"}),
    ("dc", False, {"ge2bd", "bdsqr", "stedc"}),
    ("auto_dc", True, {"ge2bd", "bdsqr", "stedc", "unmbr_ge2bd"}),
    ("band", True, {"ge2tb", "hb2td", "stedc", "unmtr_hb2td",
                    "unmbr_ge2tb"}),
    ("band", False, {"ge2tb", "hb2td", "stedc"}),
    ("dense_band", True, {"ge2tb", "unmbr_ge2tb"}),
    ("tall", True, {"geqrf", "ge2tb", "unmbr_ge2tb", "unmqr"}),
    ("tall", False, {"geqrf", "ge2tb"}),
    ("wide", True, {"ge2tb", "unmbr_ge2tb"}),
])
def test_svd_calls_every_stage_through_the_hooks(arm, vectors, stages,
                                                 monkeypatch):
    """chip_smoke.py times and profile_factors.py profiles the SVD stages
    by replacing their names in linalg/svd.py (obs/stages.py): each arm
    calls exactly its stages through them, and the hooks are restored."""
    from slate_tpu_torch.obs.stages import SVD_STAGES, wrapped_svd_stages
    _patch(monkeypatch, arm)
    m, n, nb, method, _ = ARMS[arm]
    A = stt.from_dense(_matrix(m, n, 3, np.float64), nb, device="cpu")
    called = []

    def note(name, fn):
        def run(*args, **kw):
            called.append(name)
            return fn(*args, **kw)
        return run

    with wrapped_svd_stages(note) as saved:
        s, U, V = stt.svd(A, stt.Options(
            method_svd=getattr(stt.MethodSVD, method)), want_vectors=vectors)
    assert set(called) == stages and set(called) <= set(SVD_STAGES)
    assert np.isfinite(s.numpy()).all() and (U is None) != vectors
    for name, fn in saved.items():
        assert getattr(svd_mod, name) is fn


# -- devices -----------------------------------------------------------------

def test_bdsqr_and_svd_default_to_the_card(monkeypatch):
    """Without a card, bdsqr with no ``device`` raises (even where its
    stedc would stay on the host), and svd of a CPU matrix passes A's
    device down every arm."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, e = np.ones(12), np.full(11, 0.5)
    with pytest.raises(SlateError, match="no CUDA device"):
        svd_mod.bdsqr(d, e)
    with pytest.raises(SlateError, match="no CUDA device"):
        svd_mod.bdsqr(d, e, compute_uv=True)
    for arm in ("dc", "band"):
        _patch(monkeypatch, arm)
        m, n, nb, method, _ = ARMS[arm]
        A = stt.from_dense(_matrix(m, n, 4, np.float64), nb, device="cpu")
        s, U, V = stt.svd(A, stt.Options(
            method_svd=getattr(stt.MethodSVD, method)), want_vectors=True)
        assert s.device.type == U.device.type == V.device.type == "cpu"
