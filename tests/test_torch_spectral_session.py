"""The port's spectral serving Session against slate_tpu's on the CPU
(``Session.register(..., op="eig" | "svd")``, ``apply``, ``eigvals``,
``solve`` through the Batcher and Executor):

- ``apply`` of every function of ``EIG_FUNCTIONS`` and ``SVD_FUNCTIONS``
  at several θ (ranks at 0, half-integers and past n included) against
  the reference Session's ``apply`` on the same operands (eig 45 × 45,
  svd 61 × 37, float64, nb = 16): X within 1e-10 relative;
- the svd directions (truncate takes n rows, solve and whiten m rows; a
  wrong row count raises), ``eigvals`` (Λ ascending, Σ descending, to
  1e-10 of the reference's) and ``solve`` as the catalog's "solve" at
  θ = 0;
- register validation and the apply/eigvals refusals with the
  reference's messages, and ``band_lu`` still a later slice;
- the Executor serving a spectral handle's default solve, and budget
  eviction of a spectral resident (its bytes V and Λ, or U, Σ and V);
- the solve graphs' keys, with a stand-in for the CUDA capture (graphs
  are captured only on a card): a spectral key is never taken as an
  appended qr key, each function of an svd operator finds its warmed
  key on the rows it takes (truncate: n), a replay at a new θ matches
  the eager apply with no new capture, and a failed capture names the
  function;
- the spectral arms of ``obs/flops`` against the reference's.
"""

import functools

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.types import MatrixKind as RMatrixKind
from slate_tpu.obs import flops as rflops
from slate_tpu.runtime.session import Session as RefSession
import slate_tpu_torch as stt
from slate_tpu_torch import spectral as sp
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.obs import flops
from slate_tpu_torch.runtime import session as session_mod

torch.set_num_threads(2)

NB, N, M, NS = 16, 45, 61, 37
THETAS = {"solve": (0.0, 0.37, -1.5), "truncate": (0.0, 2.5, 5.0, 99.0),
          "whiten": (0.0, 0.25), "psd_project": (0.0,)}


@functools.lru_cache(maxsize=None)
def _operands():
    rng = np.random.default_rng(21)
    a = rng.standard_normal((N, N))
    g = rng.standard_normal((M, NS))
    return (a + a.T) / 2, g


def _port(sess=None):
    a, g = _operands()
    sess = sess or stt.Session(device="cpu")
    he = sess.register(stt.from_dense(a, NB, kind=stt.MatrixKind.Hermitian,
                                      device="cpu"), op="eig", handle="e")
    hs = sess.register(stt.from_dense(g, NB, device="cpu"), op="svd",
                       handle="s")
    return sess, he, hs


@functools.lru_cache(maxsize=None)
def _sessions():
    a, g = _operands()
    ref = RefSession()
    ref.register(st.from_dense(a, NB, kind=RMatrixKind.Hermitian),
                 op="eig", handle="e")
    ref.register(st.from_dense(g, NB), op="svd", handle="s")
    return _port()[0], ref


def _rows(op, fname):
    return N if op == "eig" else (NS if sp.SVD_FUNCTIONS[fname][1] else M)


@pytest.mark.parametrize("op, fname", [("eig", f) for f in sp.EIG_FUNCTIONS]
                         + [("svd", f) for f in sp.SVD_FUNCTIONS])
def test_apply_matches_the_reference_session(op, fname):
    sess, ref = _sessions()
    h = "e" if op == "eig" else "s"
    b = np.random.default_rng(22).standard_normal((_rows(op, fname), 3))
    for theta in THETAS[fname]:
        x = sess.apply(h, b, fn=fname, theta=theta)
        xr = ref.apply(h, b, fn=fname, theta=theta)
        assert x.shape == xr.shape
        np.testing.assert_allclose(
            x, xr, rtol=0, atol=1e-10 * max(np.abs(xr).max(), 1.0))
    # a vector right-hand side keeps its rank
    assert sess.apply(h, b[:, 0], fn=fname).shape == xr.shape[:1]


def test_svd_directions_eigvals_and_the_default_solve():
    sess, ref = _sessions()
    rng = np.random.default_rng(23)
    with pytest.raises(SlateError, match=f"takes {NS}-row"):
        sess.apply("s", rng.standard_normal(M), fn="truncate", theta=2)
    with pytest.raises(SlateError, match=f"takes {M}-row"):
        sess.apply("s", rng.standard_normal(NS), fn="solve")
    w, s = sess.eigvals("e"), sess.eigvals("s")
    assert np.all(np.diff(w) >= 0) and np.all(np.diff(s) <= 0)
    np.testing.assert_allclose(w, ref.eigvals("e"), rtol=0, atol=1e-10)
    np.testing.assert_allclose(s, ref.eigvals("s"), rtol=0, atol=1e-10)
    b = rng.standard_normal((M, 2))
    np.testing.assert_array_equal(sess.solve("s", b),
                                  sess.apply("s", b, fn="solve"))
    x = sess.solve("e", b[:N, 0])
    a, _ = _operands()
    np.testing.assert_allclose(a @ x, b[:N, 0], atol=1e-10)


def _message(fn):
    try:
        fn()
    except (SlateError, st.SlateError) as e:
        return str(e)
    raise AssertionError("no error")


def test_register_and_serve_refusals_match_the_reference():
    rng = np.random.default_rng(24)
    g = rng.standard_normal((32, 32))
    wide = rng.standard_normal((16, 32))
    port, ref = stt.Session(device="cpu"), RefSession()
    pairs = [
        (lambda: port.register(stt.from_dense(g, 16, device="cpu"),
                               op="eig"),
         lambda: ref.register(st.from_dense(g, 16), op="eig")),
        (lambda: port.register(g, op="eig"),
         lambda: ref.register(g, op="eig")),
        (lambda: port.register(stt.from_dense(wide, 16, device="cpu"),
                               op="svd"),
         lambda: ref.register(st.from_dense(wide, 16), op="svd")),
        (lambda: port.register(stt.from_dense(g, 16, device="cpu"),
                               op="svd", refine=True),
         lambda: ref.register(st.from_dense(g, 16), op="svd", refine=True)),
    ]
    for mine, theirs in pairs:
        assert _message(mine) == _message(theirs)
    spd = g @ g.T / 32 + 32 * np.eye(32)
    for sess, mk in ((port, stt), (ref, st)):
        kw = {"device": "cpu"} if sess is port else {}
        herm = mk.MatrixKind.Hermitian if sess is port else \
            RMatrixKind.Hermitian
        sess.register(mk.from_dense(spd, 16, kind=herm, **kw), op="chol",
                      handle="c")
        sess.register(mk.from_dense((g + g.T) / 2, 16, kind=herm, **kw),
                      op="eig", handle="e")
    for call in (lambda s: s.apply("c", np.zeros(32)),
                 lambda s: s.apply("e", np.zeros(32), fn="sqrtm"),
                 lambda s: s.eigvals("c")):
        assert _message(lambda: call(port)) == _message(lambda: call(ref))
    with pytest.raises(NotImplementedError, match="item 9"):
        port.register(stt.from_dense(g, 16, device="cpu"), op="band_lu")
    with pytest.raises(SlateError, match="unknown handle"):
        port.apply("nope", np.zeros(32))


def test_executor_serves_the_default_solve_of_a_spectral_handle():
    sess, he, _ = _port()
    a, _ = _operands()
    rng = np.random.default_rng(25)
    bs = [rng.standard_normal(N) for _ in range(4)]
    with stt.Executor(sess, max_batch=4, max_wait=3600.0) as ex:
        ex.warmup([he])
        xs = [f.result(timeout=600) for f in
              [ex.submit(he, b) for b in bs]]
    for x, b in zip(xs, bs):
        assert x.shape == (N,)
        np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-9,
                                   atol=1e-9)
    m = sess.metrics
    assert m.get("completed_requests") == 4 and m.get("factors_total") == 1


def test_budget_evicts_a_spectral_resident():
    sess, he, hs = _port(stt.Session(device="cpu", hbm_budget=1))
    res_e = sess.factor(he)
    p = res_e.payload
    assert res_e.nbytes == p.v.data.numel() * 8 + p.lam.numel() * 8
    res_s = sess.factor(hs)
    q = res_s.payload
    assert res_s.nbytes == 8 * (q.u.data.numel() + q.s.numel()
                                + q.v.data.numel())
    # the newest resident is kept over budget, the older one evicted
    assert sess.cached_handles() == [hs]
    assert sess.metrics.get("evictions") == 1
    assert sess.cached_bytes == res_s.nbytes
    sess.hbm_budget = None
    sess.apply(he, np.ones(N), fn="psd_project")  # refactors: a miss
    assert sess.metrics.get("factors_total") == 3
    assert sess.cached_handles() == [hs, he]


# -- the solve graphs' keys, with a stand-in for the capture ----------------

class _StandIn:
    """A captured call's stand-in: replay() runs the call again on the
    static inputs and writes the result into the static output."""

    def __init__(self, call, out):
        self.call, self.out = call, out

    def replay(self):
        self.out.data.copy_(self.call().data)


def _eager_graphs(self, handle, entry, key, calls):
    outs = [call() for call in calls]
    return [_StandIn(c, o) for c, o in zip(calls, outs)], outs, 0


def test_spectral_graph_keys_with_a_stand_in_capture(monkeypatch):
    monkeypatch.setattr(stt.Session, "_graphs", _eager_graphs)
    sess, _, hs = _port()
    entry, res = sess._ops[hs], sess.factor(hs)
    # the keys warmup asks for: one per function, on the rows it takes
    keys = {(-(-_rows("svd", f) // NB) * NB, NB, torch.float64, "spectral",
             f) for f in sp.SVD_FUNCTIONS}
    assert {k[0] for k in keys} == {48, 64}
    for k in keys:
        assert session_mod._key_kind(k) == "spectral"
        assert sess._graph_payload(res, k) is res.payload
    sess._warm[hs] = keys
    rng = np.random.default_rng(26)
    m = sess.metrics
    for fname in sp.SVD_FUNCTIONS:
        rows = _rows("svd", fname)
        B = stt.from_dense(rng.standard_normal((rows, 2)), NB, device="cpu")
        graph = sess._graph_for(hs, entry, res, B, fname)
        assert graph is res.graphs[(48 if rows == NS else 64, NB,
                                    torch.float64, "spectral", fname)]
        # the other direction's rows never find a key of this function
        other = stt.from_dense(np.zeros((M + NS - rows, 1)), NB,
                               device="cpu")
        assert sess._graph_for(hs, entry, res, other, fname) is None
    assert m.get("aot_compiles") == 3 and len(res.graphs) == 3
    # replays at new θ: the eager apply's answer, no new capture
    for fname, theta in (("truncate", 7.5), ("solve", 0.3),
                         ("whiten", 0.1), ("truncate", 2.0)):
        b = rng.standard_normal((_rows("svd", fname), 3))
        want = sp.make_apply_fn("svd", fname)(
            res.payload, stt.from_dense(b, NB, device="cpu"),
            torch.tensor(theta, dtype=torch.float64)).to_numpy()
        np.testing.assert_array_equal(sess.apply(hs, b, fn=fname,
                                                 theta=theta), want)
    assert m.get("aot_compiles") == 3 and m.get("graph_replays") == 4
    # an appended-only clear keeps them; a full clear drops them
    sess._clear_graphs(res, appended_only=True)
    assert len(res.graphs) == 3
    sess._clear_graphs(res)
    assert res.graphs == {}


def test_failed_spectral_capture_names_the_function():
    sess, he, _ = _port()
    res = sess.factor(he)
    key = (48, NB, torch.float64, "spectral", "whiten")
    with pytest.raises(SlateError, match="capturing the eig whiten apply"):
        sess._capture(he, sess._ops[he], res, key)
    assert res.graphs == {} and sess.metrics.get("aot_compiles") == 0


@pytest.mark.parametrize("op, m, n", [("eig", 300, 300), ("svd", 500, 200),
                                      ("svd", 64, 64)])
def test_spectral_flops_match_the_reference(op, m, n):
    assert flops.factor_flops(op, m, n) == rflops.factor_flops(op, m, n)
    assert flops.solve_flops(op, m, n, 5) == rflops.solve_flops(op, m, n, 5)
    sess = stt.Session(device="cpu")
    h = sess.register(stt.from_dense(np.eye(m, n), 32, device="cpu",
                                     **({"kind": stt.MatrixKind.Hermitian}
                                        if op == "eig" else {})), op=op)
    assert sess.recompute_cost(h, 5) == (flops.solve_flops(op, m, n, 5)
                                         + flops.factor_flops(op, m, n))
