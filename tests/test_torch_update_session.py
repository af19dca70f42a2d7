"""``Session.update``, ``update_small_batched`` and ``warmup(update_k=...)``
against the reference's Session on the CPU (n ≤ 48, nb = 16).

- On one sequence (a chol operator: the k-bucket stream k = 1, 2, 3, 4, a
  downdate that undoes an update, an indefinite downdate, the update budget
  coming due, an injected ``update_abort`` under the same fault plan and
  seed; a qr operator: an append, deleting an appended row, back to the
  base, a base-row delete; three chol_small operators updated together at
  mixed ranks; a bf16-refined chol operator) the port's and the
  reference's Sessions return the same result dicts and count the same
  updates_total, update_refactors_total, update_downdate_failures_total,
  update_aborts_total, updates_deferred_total,
  update_budget_refactors_total, update_flops_total, factors_total and
  evictions, and their answers agree (float64: 1e-9 relative; the
  refined float32 operator under the scaled-residual gate);
- a chol resident's factor keeps its storage across an update (the
  invariant that keeps its solve graphs valid), and the arrays given to
  ``register`` are bitwise unchanged after updates;
- a chol_small update is bit for bit its lane of ``update_small_batched``;
- ``factor_from_arrays`` carries the reference's appended 5-tuple, which
  then solves as the reference's;
- the verbs' errors are the reference's; warmup with ``update_k`` on the
  CPU captures nothing and does not raise.
"""

import types

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.runtime import FaultPlan as RefPlan
from slate_tpu.runtime import FaultSpec as RefSpec
from slate_tpu.runtime.session import Session as RefSession
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.interop.reference import factor_from_arrays
from slate_tpu_torch.linalg import update as upd
from slate_tpu_torch.runtime import FaultPlan, FaultSpec

torch.set_num_threads(2)

N, NB, M = 40, 16, 48
EPS32 = 2.0 ** -23
COUNTERS = ("updates_total", "update_refactors_total",
            "update_downdate_failures_total", "update_aborts_total",
            "updates_deferred_total", "update_budget_refactors_total",
            "update_flops_total", "factors_total", "evictions")


def _operands():
    rng = np.random.default_rng(19)
    x = rng.standard_normal((N, N))
    spd = x @ x.T + N * np.eye(N)
    aq = rng.standard_normal((M, N))
    smalls = [y @ y.T + 16 * np.eye(16)
              for y in rng.standard_normal((3, 16, 16))]
    return rng, spd, aq, smalls


class _Pkg:
    def __init__(self, port: bool):
        self.port = port

    def session(self):
        return stt.Session(device="cpu") if self.port else RefSession()

    def chol(self, a):
        return (stt.hermitian(a, NB, stt.Uplo.Lower, device="cpu")
                if self.port else st.hermitian(a, nb=NB, uplo=st.Uplo.Lower))

    def dense(self, a):
        return (stt.from_dense(a, NB, device="cpu") if self.port
                else st.from_dense(a, nb=NB))

    def abort_plan(self):
        if self.port:
            return FaultPlan(seed=9, specs=(FaultSpec("update_abort",
                                                      rate=1.0, count=1),))
        return RefPlan(seed=9, specs=(RefSpec("update_abort", rate=1.0,
                                              count=1),))

    def enable(self, sess, plan):
        if self.port:
            sess.enable_faults(plan)
        else:
            from slate_tpu.runtime.faults import FaultInjector
            sess.faults = FaultInjector(plan)

    def policy(self):
        return (stt.RefinePolicy(factor_dtype="bfloat16") if self.port
                else st.refine.RefinePolicy(factor_dtype="bfloat16"))


def _sequence(pkg: _Pkg):
    """Every update of the sequence → (result dicts, answers, counters)."""
    rng, spd, aq, smalls = _operands()
    s = pkg.session()
    outs, xs = [], []
    s.register(pkg.chol(spd), op="chol", handle="c")
    # no resident yet: deferred, and the next factor absorbs it
    w0 = rng.standard_normal((N, 1))
    outs.append(s.update("c", w0))
    s.factor("c")
    for k in (1, 2, 3, 4):  # buckets 1, 2, 4, 4
        outs.append(s.update("c", 0.1 * rng.standard_normal((N, k))))
        xs.append(s.solve("c", rng.standard_normal((N, 2))))
    w = 0.3 * rng.standard_normal((N, 2))
    outs.append(s.update("c", w))
    outs.append(s.update("c", w, downdate=True))
    xs.append(s.solve("c", rng.standard_normal(N)))
    outs.append(s.update("c", 10.0 * rng.standard_normal((N, 2)),
                         downdate=True))
    # large updates weigh ‖W‖₁²/‖A‖₁ each: the budget comes due
    for _ in range(3):
        outs.append(s.update("c", 3.0 * rng.standard_normal((N, 16))))
    pkg.enable(s, pkg.abort_plan())
    outs.append(s.update("c", rng.standard_normal((N, 2))))
    outs.append(s.update("c", rng.standard_normal((N, 2))))
    s.register(pkg.dense(aq), op="qr", handle="q")
    s.factor("q")
    u = rng.standard_normal((3, N))
    outs.append(s.update("q", u))
    xs.append(s.solve("q", rng.standard_normal((M + 3, 2))))
    outs.append(s.update("q", delete=[M]))
    xs.append(s.solve("q", rng.standard_normal(M + 2)))
    outs.append(s.update("q", delete=[M, M + 1]))
    xs.append(s.solve("q", rng.standard_normal((M, 1))))
    outs.append(s.update("q", rng.standard_normal((1, N))))
    outs.append(s.update("q", delete=[0]))
    xs.append(s.solve("q", rng.standard_normal(M)))
    hs = [f"s{i}" for i in range(3)]
    for h, a in zip(hs, smalls):
        s.register(a.copy(), op="chol_small", handle=h)
    outs += s.update_small_batched(
        hs, [rng.standard_normal((16, i + 1)) for i in range(3)])
    outs += s.update_small_batched(
        hs, [0.1 * rng.standard_normal((16, 2)),
             30.0 * rng.standard_normal((16, 2)),
             0.1 * rng.standard_normal(16)], downdate=True)
    b16 = rng.standard_normal((16, 2))
    xs += [s.solve(h, b16) for h in (hs[0], hs[2])]
    # the indefinite item's refactor reports it: detected, never served
    with pytest.raises(Exception, match="factorization failed"):
        s.solve(hs[1], b16)
    counters = s.metrics.snapshot()["counters"]
    return outs, xs, {k: counters.get(k, 0.0) for k in COUNTERS}


def test_session_updates_as_the_reference_on_one_sequence():
    port_outs, port_xs, port_counts = _sequence(_Pkg(True))
    ref_outs, ref_xs, ref_counts = _sequence(_Pkg(False))
    assert port_outs == ref_outs
    assert port_counts == ref_counts
    reasons = [o.get("reason") for o in port_outs]
    for r in ("downdate_indefinite", "update_budget", "abort",
              "base_delete"):
        assert r in reasons
    assert port_outs[0]["deferred"]
    assert [o["k_bucket"] for o in port_outs[1:5]] == [1, 2, 4, 4]
    assert port_counts["update_aborts_total"] == 1
    for got, want in zip(port_xs, ref_xs):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9,
                                   atol=1e-9)


def test_answers_follow_the_mutated_operand():
    rng, spd, aq, _ = _operands()
    s = stt.Session(device="cpu")
    s.register(stt.hermitian(spd, NB, stt.Uplo.Lower, device="cpu"),
               op="chol", handle="c")
    s.register(stt.from_dense(aq, NB, device="cpu"), op="qr", handle="q")
    s.warmup("c", nrhs=2, update_k=2)
    s.warmup("q", nrhs=2, update_k=2)
    acc = spd.copy()
    for k in (1, 2):
        w = rng.standard_normal((N, k))
        assert s.update("c", w)["applied"]
        acc += w @ w.T
        b = rng.standard_normal((N, 2))
        np.testing.assert_allclose(s.solve("c", b), np.linalg.solve(acc, b),
                                   rtol=1e-9, atol=1e-11)
    u = rng.standard_normal((2, N))
    assert s.update("q", u)["applied"]
    b = rng.standard_normal((M + 2, 2))
    want = np.linalg.lstsq(np.vstack([aq, u]), b, rcond=None)[0]
    np.testing.assert_allclose(s.solve("q", b), want, rtol=1e-8, atol=1e-10)
    c = s.metrics.snapshot()["counters"]
    assert c["factors_total"] == 2 and c.get("aot_compiles", 0) == 0
    assert c.get("update_refactors_total", 0) == 0


def test_factor_storage_is_kept_and_operands_are_not_written():
    rng, spd, aq, smalls = _operands()
    s = stt.Session(device="cpu")
    A = stt.hermitian(spd, NB, stt.Uplo.Lower, device="cpu")
    Q = stt.from_dense(aq, NB, device="cpu")
    small = torch.tensor(smalls[0])
    a_bits, q_bits, s_bits = A.data.clone(), Q.data.clone(), small.clone()
    s.register(A, op="chol", handle="c")
    s.register(Q, op="qr", handle="q")
    s.register(small, op="chol_small", handle="s")
    L = s.factor("c").payload[0]
    ptr = L.data.data_ptr()
    ls = s.factor("s").payload[0]
    sptr = ls.data_ptr()
    s.factor("q")
    for _ in range(2):
        assert s.update("c", rng.standard_normal((N, 2)))["applied"]
        assert s.update("s", rng.standard_normal((16, 1)))["applied"]
        assert s.update("q", rng.standard_normal((1, N)))["applied"]
    res = s.factor("c")
    assert res.payload[0] is L and L.data.data_ptr() == ptr
    assert s.factor("s").payload[0].data_ptr() == sptr
    assert torch.equal(A.data, a_bits) and torch.equal(Q.data, q_bits)
    assert torch.equal(small, s_bits)


def test_small_update_is_its_grouped_lane_bit_for_bit():
    rng, _, _, smalls = _operands()
    ws = [rng.standard_normal((16, k)) for k in (1, 2, 2)]
    grouped, single = stt.Session(device="cpu"), stt.Session(device="cpu")
    for s in (grouped, single):
        for i, a in enumerate(smalls):
            s.register(a.copy(), op="chol_small", handle=i)
            s.factor(i)
    grouped.update_small_batched([0, 1, 2], ws)
    for i, w in enumerate(ws):
        # a rank-2 bucket for every lane: the group's bucket
        wp = np.zeros((16, 2))
        wp[:, :w.shape[1]] = w
        assert single.update(i, wp)["applied"]
    for i in range(3):
        assert torch.equal(grouped.factor(i).payload[0],
                           single.factor(i).payload[0])


def test_appended_payload_from_the_reference_solves_as_the_reference():
    rng, _, aq, _ = _operands()
    ref = RefSession()
    ref.register(st.from_dense(aq, nb=NB), op="qr", handle="q")
    ref.factor("q")
    u = rng.standard_normal((3, N))
    ref.update("q", u)
    qr, ru, rw, rtau, rr = ref.factor("q").payload
    payload = factor_from_arrays(
        "qr", ((np.asarray(qr.vr), np.asarray(qr.t)), np.asarray(ru),
               np.asarray(rw), np.asarray(rtau), np.asarray(rr)), nb=NB,
        logical_shape=(M, N), device="cpu")
    assert len(payload) == 5 and payload[0].m == M
    b = rng.standard_normal((M + 3, 2))
    x = upd.appended_gels(payload, stt.from_dense(b, NB, device="cpu"))
    want = np.asarray(ref.solve("q", b))
    np.testing.assert_allclose(x.to_numpy(), want, rtol=1e-10, atol=1e-12)


def test_refined_chol_update_serves_under_the_gate():
    rng, spd, _, _ = _operands()
    a32 = spd.astype(np.float32)
    outs = {}
    for pkg in (_Pkg(True), _Pkg(False)):
        s = pkg.session()
        s.register(pkg.chol(a32), op="chol", handle="r",
                   refine=pkg.policy())
        s.factor("r")
        w = (0.5 * rng.standard_normal((N, 3))).astype(np.float32)
        out = s.update("r", w)
        b = rng.standard_normal(N).astype(np.float32)
        x = np.asarray(s.solve("r", b), np.float64)
        a2 = a32.astype(np.float64) + w.astype(np.float64) @ w.T
        gate = (np.abs(b - a2 @ x).max()
                / (np.abs(a2).sum(1).max() * np.abs(x).max() * EPS32 * N))
        assert gate <= 30, gate
        outs[pkg.port] = out
    assert outs[True] == outs[False]


def test_errors_are_the_references():
    rng, spd, aq, _ = _operands()
    s = stt.Session(device="cpu")
    s.register(stt.from_dense(spd, NB, device="cpu"), op="lu", handle="l")
    s.register(stt.hermitian(spd, NB, stt.Uplo.Lower, device="cpu"),
               op="chol", handle="c")
    s.register(stt.from_dense(aq, NB, device="cpu"), op="qr", handle="q")
    with pytest.raises(SlateError, match="no incremental form"):
        s.update("l", np.ones((N, 1)))
    with pytest.raises(SlateError, match="delete= applies to qr"):
        s.update("c", delete=[0])
    with pytest.raises(SlateError, match=r"delta must be \(40, k\)"):
        s.update("c", np.ones((N + 1, 1)))
    with pytest.raises(SlateError, match="needs delta"):
        s.update("c")
    with pytest.raises(SlateError, match="exactly one of"):
        s.update("q")
    with pytest.raises(SlateError, match="out of range"):
        s.update("q", delete=[M])
    with pytest.raises(SlateError, match="underdetermined"):
        s.update("q", delete=list(range(M - N + 1)))
    with pytest.raises(SlateError, match="chol_small operators only"):
        s.update_small_batched(["c"], [np.ones((N, 1))])
    with pytest.raises(SlateError, match="length mismatch"):
        s.update_small_batched(["c"], [])
    assert s.update_small_batched([], []) == []
    with pytest.raises(SlateError, match="unknown handle"):
        s.update("nope", np.ones((N, 1)))
    with pytest.raises(NotImplementedError):
        s.update("c", np.ones((N, 1)), tenant="t")
    # warmup with update_k on the CPU prepares nothing to count
    s.warmup("c", update_k=4)
    s.warmup("q", update_k=4)
    assert s.metrics.snapshot()["counters"].get("aot_compiles", 0) == 0


def test_graph_payloads_and_append_slots():
    """Which payload a graph key is captured on (the capture itself needs
    a card): every base key the resident's own payload, lu's two-tensor
    one too. A qr append always writes the resident's append slots, made
    at the first append at its rows' bucket and regrown (their bytes
    charged anew, only the appended graphs dropped) when the appended
    rows outgrow them; an appended payload is the base with the slots. A
    warmed appended shape is matched by its columns and type, whatever
    its rows."""
    rng, spd, aq, _ = _operands()
    s = stt.Session(device="cpu")
    hs = {"lu": s.register(stt.from_dense(spd, NB, device="cpu"), op="lu"),
          "chol": s.register(stt.hermitian(spd, NB, stt.Uplo.Lower,
                                           device="cpu"), op="chol"),
          "qr": s.register(stt.from_dense(aq, NB, device="cpu"), op="qr")}
    for op, h in hs.items():
        res = s.factor(h)
        assert s._graph_payload(res, (64, 16, torch.float64)) is \
            res.payload, op
    res = s.factor(hs["qr"])
    base = res.payload[0]
    before, total = res.nbytes, s.cached_bytes
    assert res.slots is None

    def slot_bytes():
        return sum(t.numel() * t.element_size() for t in res.slots)

    u = rng.standard_normal((3, N))
    assert s.update(hs["qr"], u)["applied"]
    assert res.slots[0].shape[0] == 4
    assert res.payload == (base,) + res.slots
    assert res.nbytes == before + slot_bytes()
    assert s.cached_bytes == total + slot_bytes()
    key = (64, 16, torch.float64, "append")
    assert s._graph_payload(res, key) == res.payload
    b = rng.standard_normal((M + 3, 2))
    want = np.linalg.lstsq(np.vstack([aq, u]), b, rcond=None)[0]
    np.testing.assert_allclose(s.solve(hs["qr"], b), want, rtol=1e-8,
                               atol=1e-10)
    # five appended rows outgrow the 4-row slots: regrown to 8, the old
    # slots' bytes and the appended graphs leave the budget, the base
    # solve's graph stays (stand-ins: graphs are captured only on a card)
    base_graph = types.SimpleNamespace(nbytes=100)
    res.graphs = {(48, 16, torch.float64): base_graph,
                  key: types.SimpleNamespace(nbytes=7)}
    res.nbytes += 107
    s._cached_total += 107
    slots4 = res.slots
    u2 = rng.standard_normal((2, N))
    assert s.update(hs["qr"], u2)["applied"]
    assert res.slots[0].shape[0] == 8 and res.slots[0] is not slots4[0]
    assert res.payload == (base,) + res.slots
    assert res.graphs == {(48, 16, torch.float64): base_graph}
    assert res.nbytes == before + slot_bytes() + 100
    assert s.cached_bytes == total + slot_bytes() + 100
    res.graphs = {}
    res.nbytes -= 100
    s._cached_total -= 100
    b = rng.standard_normal((M + 5, 1))
    want = np.linalg.lstsq(np.vstack([aq, u, u2]), b, rcond=None)[0]
    np.testing.assert_allclose(s.solve(hs["qr"], b), want, rtol=1e-8,
                               atol=1e-10)
    # deleting an appended row stays in the 8-row slots
    slots8 = res.slots
    assert s.update(hs["qr"], delete=[M + 1])["applied"]
    assert res.slots is slots8 and res.payload == (base,) + res.slots
    # a warmed appended shape is its columns and type: a solve whose
    # padded rows differ from the warmed key's still goes to a graph,
    # whose capture fails here (no card) and raises
    s._warm[hs["qr"]] = {(9999, 16, torch.float64, "append")}
    with pytest.raises(SlateError, match="capturing the appended qr solve"):
        s.solve(hs["qr"], rng.standard_normal(M + 4))
