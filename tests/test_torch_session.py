"""The port's serving Session, interop and package rules on the CPU.

- register/factor/solve and LRU eviction at n = 128 against the
  reference Session's ``solve`` on the same operators (X to 1e-10
  relative in float64: summation order differs), for chol, lu and a
  tall (200 × 96) least-squares operator under "qr";
- ``interop.reference`` carries the reference Session's resident
  factors (as numpy) into the port, whose potrs/getrs then give the
  reference's X;
- a "chol" operator with more than 64 block columns (n = 260 at nb = 4)
  is factored by potrf's 2×2 recursion, whose trailing update is K5, and
  serves the reference posv's X (at nb = 32, whose iterative loop
  compiles in seconds; the reference's recursion at nt > 64 takes about
  a minute on the CPU) to 1e-10 relative in float64;
- no module of the port, not chip_smoke.py and not its measurement scripts
  (profile_factors.py, tools/p*_ablation.py, p3_plans.py, stedc_split.py)
  imports jax or slate_tpu;
- entry points without ``device=`` raise when no CUDA device is present.
"""

import ast
import functools
import glob
import os

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import Uplo as RUplo
from slate_tpu.runtime.session import Session as RefSession
import slate_tpu_torch as stt
from slate_tpu_torch.interop.reference import (factor_from_arrays,
                                               tiled_from_arrays)
from slate_tpu_torch.ops import hopper_ops

torch.set_num_threads(2)

N, NB = 128, 32
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


@functools.lru_cache(maxsize=None)
def _operators():
    rng = np.random.default_rng(99)
    x = rng.standard_normal((N, N))
    spd = x @ x.T / N + np.eye(N)
    gen = x / np.sqrt(N) + 2 * np.eye(N)
    b = rng.standard_normal((N, 3))
    return spd, gen[rng.permutation(N)], b


@functools.lru_cache(maxsize=None)
def _reference_session():
    spd, gen, b = _operators()
    sess = RefSession()
    hc = sess.register(st.hermitian(spd, NB, RUplo.Lower))
    hl = sess.register(st.from_dense(gen, NB))
    xs = {"chol": sess.solve(hc, b), "lu": sess.solve(hl, b[:, 0])}
    payloads = {"chol": tuple(np.asarray(p.data) for p in
                              sess.factor(hc).payload),
                "lu": (np.asarray(sess.factor(hl).payload[0].data),
                       np.asarray(sess.factor(hl).payload[1]))}
    return xs, payloads


def _rel(x, y):
    return np.abs(x - y).max() / np.abs(y).max()


def _port_session(**kw):
    spd, gen, _ = _operators()
    sess = stt.Session(device="cpu", **kw)
    hc = sess.register(stt.hermitian(spd, NB, stt.Uplo.Lower, device="cpu"))
    hl = sess.register(stt.from_dense(gen, NB, device="cpu"))
    return sess, hc, hl


def test_session_solves_match_reference_session():
    _, _, b = _operators()
    xs, _ = _reference_session()
    sess, hc, hl = _port_session()
    assert sess._ops[hc].op == "chol" and sess._ops[hl].op == "lu"
    xc = sess.solve(hc, b)
    xl = sess.solve(hl, b[:, 0])
    assert xc.shape == (N, 3) and xl.shape == (N,)
    assert _rel(xc, xs["chol"]) < 1e-10
    assert _rel(xl, xs["lu"]) < 1e-10
    m = sess.metrics.snapshot()["counters"]
    assert m["cache_misses"] == 2 and m["factors_total"] == 2
    assert m["solves_total"] == 4 and m["dispatches_total"] == 2
    assert sess.metrics.histogram("solve_latency")["count"] == 2
    sess.solve(hc, b)
    assert sess.metrics.get("cache_hits") == 1


def test_interop_reference_factors_give_reference_solutions():
    _, _, b = _operators()
    xs, payloads = _reference_session()
    B = stt.from_dense(b, NB, device="cpu")
    (L,) = factor_from_arrays("chol", payloads["chol"], nb=NB,
                              logical_shape=(N, N), device="cpu")
    assert L.kind is stt.MatrixKind.Triangular
    assert _rel(stt.potrs(L, B).to_numpy(), xs["chol"]) < 1e-10
    LU, perm = factor_from_arrays("lu", payloads["lu"], nb=NB,
                                  logical_shape=(N, N), device="cpu")
    x = stt.getrs(LU, perm, stt.from_dense(b[:, :1], NB, device="cpu"))
    assert _rel(x.to_numpy()[:, 0], xs["lu"]) < 1e-10
    spd, _, _ = _operators()
    A = tiled_from_arrays(spd, nb=NB, kind=stt.MatrixKind.Hermitian,
                          uplo=stt.Uplo.Lower, device="cpu")
    np.testing.assert_array_equal(A.to_numpy(), spd)


@functools.lru_cache(maxsize=None)
def _qr_problem():
    rng = np.random.default_rng(123)
    a = rng.standard_normal((200, 96))
    b = rng.standard_normal((200, 2))
    sess = RefSession()
    h = sess.register(st.from_dense(a, NB))
    x = sess.solve(h, b)
    QR = sess.factor(h).payload[0]
    return a, b, x, (np.asarray(QR.vr), np.asarray(QR.t))


def test_session_serves_qr_like_reference_session():
    """A tall operator registered with op="auto" is served as "qr":
    m-row right-hand sides in, n-row least-squares solutions out, the
    reference Session's X; the resident bytes are V\\R and T."""
    a, b, x_ref, _ = _qr_problem()
    sess = stt.Session(device="cpu")
    h = sess.register(stt.from_dense(a, NB, device="cpu"))
    assert sess._ops[h].op == "qr"
    x = sess.solve(h, b)
    assert x.shape == (96, 2)
    assert _rel(x, x_ref) < 1e-10
    x1 = sess.solve(h, b[:, 0])
    assert x1.shape == (96,) and _rel(x1, x_ref[:, 0]) < 1e-10
    QR = sess.factor(h).payload[0]
    assert sess.cached_bytes == (QR.vr.numel() + QR.t.numel()) * 8
    m = sess.metrics.snapshot()["counters"]
    assert m["factors_total"] == 1 and m["solves_total"] == 3
    assert m["factor_flops_total"] == 2 * 200 * 96 ** 2 - 2 * 96 ** 3 / 3
    assert m["solve_flops_total"] == (4 * 200 * 96 - 2 * 96 ** 2) * 3


def test_interop_reference_qr_factor_gives_reference_solution():
    a, b, x_ref, arrays = _qr_problem()
    (QR,) = factor_from_arrays("qr", arrays, nb=NB, logical_shape=(200, 96),
                               device="cpu")
    assert isinstance(QR, stt.QRFactors) and (QR.m, QR.n) == (200, 96)
    X = stt.least_squares_solve_using_factor(
        QR, stt.from_dense(b, NB, device="cpu"))
    assert _rel(X.to_numpy(), x_ref) < 1e-10


def test_session_chol_above_64_block_columns_serves_through_k5(monkeypatch):
    n = 260
    rng = np.random.default_rng(260)
    x = rng.standard_normal((n, n))
    spd = x @ x.T / n + np.eye(n)
    b = rng.standard_normal((n, 2))
    X_ref, _ = st.posv(st.hermitian(spd, 32, RUplo.Lower),
                       st.from_dense(b, 32))
    seen = []
    k5 = hopper_ops.herk_lower_update
    monkeypatch.setattr(hopper_ops, "herk_lower_update",
                        lambda c, a: seen.append(tuple(c.shape)) or k5(c, a))
    sess = stt.Session(device="cpu")
    h = sess.register(stt.hermitian(spd, 4, stt.Uplo.Lower, device="cpu"),
                      op="chol")
    x = sess.solve(h, b)
    assert seen == [(128, 128)]  # one split, 260 → 132 + 128
    assert x.shape == (n, 2) and _rel(x, X_ref.to_numpy()) < 1e-10
    assert sess.factor_info(h) == 0


def test_lru_eviction_under_budget():
    factor_bytes = N * N * 8
    sess, hc, hl = _port_session(hbm_budget=factor_bytes + N * 4)
    _, _, b = _operators()
    sess.solve(hc, b)
    sess.solve(hl, b)                      # evicts hc (LRU)
    assert sess.cached_handles() == [hl]
    assert sess.metrics.get("evictions") == 1
    assert sess.metrics.get("evicted_bytes") == factor_bytes
    sess.solve(hc, b)                      # refactor on miss, evicts hl
    assert sess.cached_handles() == [hc]
    assert sess.metrics.get("cache_misses") == 3
    assert sess.cached_bytes == factor_bytes
    assert sess.evict(hc) and not sess.evict(hc)
    sess.unregister(hl)
    assert hl not in sess and sess.handles() == [hc]


def test_oversized_factor_is_kept_and_counted():
    sess, hc, _ = _port_session(hbm_budget=16)
    sess.factor(hc)
    assert sess.cached_handles() == [hc]
    assert sess.metrics.get("budget_overflows") == 1


def test_failed_factor_raises_on_solve():
    a = np.eye(N)
    a[7, 7] = -1.0
    sess = stt.Session(device="cpu")
    h = sess.register(stt.hermitian(a, NB, stt.Uplo.Lower, device="cpu"))
    assert sess.factor_info(h) == 8
    with pytest.raises(stt.SlateError, match="info=8"):
        sess.solve(h, np.ones(N))


def test_register_rejects_unported_and_bad_operands():
    sess = stt.Session(device="cpu")
    # eig is served (the reference's message for a plain array)
    with pytest.raises(stt.SlateError,
                       match="op 'eig' requires a TiledMatrix operand"):
        sess.register(np.eye(4), op="eig")
    with pytest.raises(NotImplementedError, match="band_lu"):
        sess.register(stt.from_dense(np.eye(4), 4, device="cpu"),
                      op="band_lu")
    with pytest.raises(stt.SlateError, match="wide"):
        sess.register(stt.from_dense(np.ones((4, 8)), 4, device="cpu"))
    with pytest.raises(stt.SlateError, match="square"):
        sess.register(stt.from_dense(np.ones((8, 4)), 4, device="cpu"),
                      op="lu")
    with pytest.raises(stt.SlateError, match="unknown op"):
        sess.register(stt.from_dense(np.eye(4), 4, device="cpu"), op="x")
    h = sess.register(stt.from_dense(np.eye(4), 4, device="cpu"), handle="a")
    with pytest.raises(stt.SlateError, match="already registered"):
        sess.register(stt.from_dense(np.eye(4), 4, device="cpu"), handle=h)
    with pytest.raises(stt.SlateError, match="unknown handle"):
        sess.solve("nope", np.ones(4))


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(stt.SlateError, match="no CUDA device"):
        stt.Session()
    with pytest.raises(stt.SlateError, match="no CUDA device"):
        stt.from_dense(np.eye(4), 4)
    with pytest.raises(stt.SlateError, match="no CUDA device"):
        stt.hermitian(np.eye(4), 4, stt.Uplo.Lower)
    with pytest.raises(stt.SlateError, match="no CUDA device"):
        tiled_from_arrays(np.eye(4), nb=4)


def _port_sources():
    pkg = os.path.join(ROOT, "slate_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    # the port's measurement scripts
    for f in ("profile_factors.py", "tools/p3_plans.py",
              "tools/stedc_split.py"):
        yield os.path.join(ROOT, f)
    yield from sorted(glob.glob(os.path.join(ROOT, "tools",
                                             "p*_ablation.py")))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_reference_package():
    sources = list(_port_sources())
    assert len(sources) > 15
    for path in sources:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "slate_tpu"), (path, name)
