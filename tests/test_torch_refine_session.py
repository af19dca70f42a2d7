"""The refined Session operators and the Executor's working_precision rung
against the reference's, on the CPU (n ≤ 70, nb = 32).

- On one register/solve/fault sequence (dense chol f32 ← bf16, dense lu
  f64 ← f32, lu_small f32 ← bf16, a chol_small operator that is
  indefinite after bf16 rounding, an impossible tolerance, the
  ``lo_factor_fail`` and ``refine_no_converge`` faults, an eviction and a
  demotion) the port's and the reference's Sessions count the same
  refine_* counters, refine_iterations observations, evictions, hits,
  misses and factors, and every answer is under the scaled-residual
  gate (‖b − A·x‖max / (‖A‖∞·‖x‖max·ε·n) ≤ 30 in float64);
- a bf16 resident is charged n²·2 bytes (+ the int32 perm for lu), the
  reference's charge, half the float32 factor's;
- ``register(refine=True)`` resolves from the table (a carve-out hole
  registers unrefined); qr and band refine, a factor type equal to the
  working one, complex64 by the ladder and GMRES-IR on a small operator
  are rejected with the reference's messages; ``fallback=False`` raises;
- warmup of a refined operator on the CPU captures nothing, and later
  solves add no ``aot_compiles``;
- a grouped mixed bucket keys apart from plain buckets, serves each
  request within 1e-6 of its per-request refined solve (bit for bit only
  with two or more right-hand sides: at B = 1 torch's CPU matmul takes a
  matrix-vector path for one column, so the batched verbs' B = 1 ≡ lane
  pin in test_torch_refine_batched.py uses two), and isolates a per-item
  fallback;
- an Executor whose breaker trips on a mixed bucket demotes the operator
  (``refine_demotions_total`` = 1) and replays the bucket per request,
  as the reference's Executor does on the same fault plan.
"""

import functools

import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.core.exceptions import SlateError as RefSlateError
from slate_tpu.refine import PolicyTable as RefTable
from slate_tpu.refine import RefinePolicy as RefPolicy
from slate_tpu.runtime import Executor as RefExecutor
from slate_tpu.runtime import FaultPlan as RefPlan
from slate_tpu.runtime import FaultSpec as RefSpec
from slate_tpu.obs import flops as ref_flops
from slate_tpu.runtime.session import Session as RefSession
from slate_tpu.runtime.session import _solve_flops as ref_solve_flops
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.runtime import Executor, FaultPlan, FaultSpec

torch.set_num_threads(2)

N, NB = 70, 32
NPAD = 96
EPS = {np.float32: 2.0 ** -23, np.float64: 2.0 ** -52}


@functools.lru_cache(maxsize=None)
def _operands():
    rng = np.random.default_rng(81)
    x = rng.standard_normal((N, N))
    spd = x @ x.T / N + np.eye(N)
    gen = x / np.sqrt(N) + 2 * np.eye(N)
    small = rng.standard_normal((3, 24, 24)) / np.sqrt(24) + 2 * np.eye(24)
    bad = np.ones((16, 16)) + 1e-3 * np.eye(16)  # indefinite in bf16
    bs = rng.standard_normal((12, N))
    return spd, gen, small, bad, bs


def _gate(a, x, b, dtype):
    a, x, b = (np.asarray(v, np.float64) for v in (a, x, b))
    return (np.abs(b - a @ x).max()
            / (np.abs(a).sum(1).max() * np.abs(x).max() * EPS[dtype]
               * a.shape[0]))


class _Pkg:
    """The calls of the sequence, per package."""

    def __init__(self, port: bool):
        self.port = port
        self.Policy = stt.RefinePolicy if port else RefPolicy

    def session(self, **kw):
        return (stt.Session(device="cpu", **kw) if self.port
                else RefSession(**kw))

    def chol(self, a):
        return (stt.hermitian(np.tril(a), NB, stt.Uplo.Lower, device="cpu")
                if self.port else
                st.hermitian(np.tril(a), nb=NB, uplo=st.Uplo.Lower))

    def dense(self, a):
        return (stt.from_dense(a, NB, device="cpu") if self.port
                else st.from_dense(a, nb=NB))

    def plan(self, *specs):
        if self.port:
            return FaultPlan(seed=11, specs=tuple(FaultSpec(k, rate=1.0,
                                                            count=1)
                                                  for k in specs))
        return RefPlan(seed=11, specs=tuple(RefSpec(k, rate=1.0, count=1)
                                            for k in specs))


# refine_flops_total is iterations × per-step flops, and the iterations
# of a bf16 lu_small operator can differ: the port factors each bf16
# panel in float32 (P3's route) where the reference eliminates in
# bfloat16 (3 iterations against 4 on this sequence's lu_small solve),
# so each port solve's flops are held to its own iterations × the
# reference's per-step formula (_ref_step_flops) instead
_COUNTERS = ("refine_converged_total", "refine_fallbacks_total",
             "refine_demotions_total", "evictions", "cache_hits",
             "cache_misses", "factors_total")


def _ref_step_flops(op: str, n: int, k: int) -> float:
    """The reference Session's flops of one refinement step: the
    residual gemm and the factor apply."""
    return ref_flops.gemm(n, k, n) + ref_solve_flops(op, n, n, k)


def _sequence(pkg: _Pkg):
    spd, gen, small, bad, bs = _operands()
    f32, f64 = np.float32, np.float64
    sess = pkg.session()
    ops = {}  # handle → (op, n)
    steps = []  # per solve: (op, n, k, its iterations, its refine flops)

    def iters_sum():
        hist = sess.metrics.snapshot()["histograms"].get("refine_iterations")
        return 0.0 if hist is None else hist["sum"]

    def solve(h, b):
        it0, fl0 = iters_sum(), sess.metrics.get("refine_flops_total")
        x = np.asarray(sess.solve(h, b))
        steps.append((*ops[h], 1 if b.ndim == 1 else b.shape[1],
                      iters_sum() - it0,
                      sess.metrics.get("refine_flops_total") - fl0))
        return x

    def register(a, op, refine):
        h = sess.register(a, op=op, refine=refine)
        ops[h] = (op, a.shape[0])
        return h

    hc = register(pkg.chol(spd.astype(f32)), "chol", True)
    hl = register(pkg.dense(gen), "lu", True)
    hs = register(small[0].astype(f32), "lu_small", True)
    hb = register(bad.astype(f32), "chol_small", True)
    ht = register(pkg.chol(spd.astype(f32)), "chol",
                  pkg.Policy(factor_dtype="bfloat16", max_iters=2,
                             tol=1e-14))
    xs = []
    for i, (h, a, dt) in enumerate(((hc, spd, f32), (hl, gen, f64),
                                    (hs, small[0], f32),
                                    (hb, bad, f32), (ht, spd, f32),
                                    (hc, spd, f32))):
        b = bs[i, :a.shape[0]].astype(dt)
        xs.append((a, solve(h, b), b, dt))
    sess.enable_faults(pkg.plan("lo_factor_fail", "refine_no_converge"))
    sess.evict(hc)
    xs.append((spd, solve(hc, bs[6].astype(f32)), bs[6].astype(f32),
               f32))  # lo factor fault: fallback
    xs.append((gen, solve(hl, bs[7]), bs[7], f64))
    hc2 = register(pkg.chol(spd.astype(f32)), "chol", True)
    xs.append((spd, solve(hc2, bs[8].astype(f32)), bs[8].astype(f32),
               f32))
    assert sess.demote_to_working_precision(hc2)
    assert not sess.demote_to_working_precision(hc2)
    xs.append((spd, solve(hc2, bs[9].astype(f32)), bs[9].astype(f32),
               f32))
    classes = [sess.degrade_class(h) for h in (hc, hl, hs, hb, ht, hc2)]
    m = sess.metrics
    counts = {k: m.get(k) for k in _COUNTERS}
    hist = m.snapshot()["histograms"]["refine_iterations"]
    counts["refine_iterations"] = hist["count"]
    return counts, classes, xs, (hist["sum"], m.get("refine_flops_total"),
                                 steps)


def test_session_counts_as_the_reference_on_one_sequence():
    port_counts, port_classes, port_xs, (iters, flops, steps) = _sequence(
        _Pkg(True))
    ref_counts, ref_classes, _, _ = _sequence(_Pkg(False))
    assert port_counts == ref_counts
    # every solve's refine flops are its iterations × one step's flops
    assert iters > 0 and sum(s[3] for s in steps) == iters
    for op, n, k, its, fl in steps:
        assert fl == its * _ref_step_flops(op, n, k), (op, n, k, its, fl)
    assert flops == sum(s[4] for s in steps) > 0
    assert port_classes == ref_classes
    assert port_counts["refine_fallbacks_total"] >= 4
    assert port_counts["refine_demotions_total"] == 1
    for a, x, b, dt in port_xs:
        assert _gate(a, x, b, dt) <= 30


def test_bf16_resident_is_charged_half():
    spd, gen, *_ = _operands()
    for port in (True, False):
        pkg = _Pkg(port)
        sess = pkg.session()
        hc = sess.register(pkg.chol(spd.astype(np.float32)), op="chol",
                           refine=True)
        sess.factor(hc)
        assert sess.cached_bytes == NPAD * NPAD * 2
        hl = sess.register(pkg.dense(gen.astype(np.float32)), op="lu",
                           refine=True)
        sess.factor(hl)
        assert sess.cached_bytes == 2 * NPAD * NPAD * 2 + NPAD * 4
        hw = sess.register(pkg.chol(spd.astype(np.float32)), op="chol")
        sess.factor(hw)
        assert sess.cached_bytes == 3 * NPAD * NPAD * 2 + NPAD * 4 + \
            NPAD * NPAD * 2  # the float32 factor: twice a bf16 one


def test_register_resolves_and_rejects_as_the_reference():
    spd, gen, small, *_ = _operands()
    outcomes = []
    for port in (True, False):
        pkg = _Pkg(port)
        Table = stt.PolicyTable if port else RefTable
        sess = pkg.session(refine_policies=Table()
                           .add(None, op="lu", n_max=64)
                           .add(pkg.Policy(factor_dtype="bfloat16",
                                           max_iters=9), op="chol"))
        h = sess.register(pkg.chol(spd.astype(np.float32)), op="chol",
                          refine=True)
        hole = sess.register(pkg.dense(gen[:60, :60].astype(np.float32)),
                             op="lu", refine=True)
        got = [sess._ops[h].refine.max_iters, sess._ops[hole].refine,
               sess.degrade_class(hole)]
        tall = pkg.dense(np.vstack([gen, gen]).astype(np.float32))
        cases = [
            lambda: sess.register(tall, op="qr", refine=True),
            lambda: sess.register(pkg.chol(spd.astype(np.float32)),
                                  op="chol",
                                  refine=pkg.Policy(factor_dtype="float32")),
            lambda: sess.register(pkg.chol(spd.astype(np.complex64)),
                                  op="chol", refine=True),
            lambda: sess.register(small[0], op="lu_small",
                                  refine=pkg.Policy(strategy="gmres")),
        ]
        errs = []
        for case in cases:
            with pytest.raises((SlateError, RefSlateError)) as e:
                case()
            errs.append(str(e.value))
        outcomes.append((got, errs))
    (pgot, perrs), (rgot, rerrs) = outcomes
    assert pgot == rgot == [9, None, "dense"]
    for p, r in zip(perrs, rerrs):
        assert p == r
    # band operators are not ported (ROADMAP item 9), but their refine is
    # refused first, with the reference's message for a non-lu/chol op
    with pytest.raises(SlateError) as e:
        stt.Session(device="cpu").register(small[0], op="band_lu",
                                           refine=True)
    assert str(e.value) == rerrs[0].replace("'qr'", "'band_lu'")


def test_fallback_disabled_raises_and_forced_fallback_serves():
    spd, *_, bs = _operands()
    a = spd.astype(np.float32)
    sess = stt.Session(device="cpu")
    h = sess.register(stt.hermitian(np.tril(a), NB, stt.Uplo.Lower,
                                    device="cpu"), op="chol",
                      refine=stt.RefinePolicy(max_iters=1, tol=1e-14,
                                              fallback=False))
    with pytest.raises(SlateError, match="disables fallback"):
        sess.solve(h, bs[0].astype(np.float32))
    # counted before it raises, as the reference counts it
    assert sess.metrics.get("refine_fallbacks_total") == 1
    h2 = sess.register(stt.hermitian(np.tril(a), NB, stt.Uplo.Lower,
                                     device="cpu"), op="chol",
                       refine=stt.RefinePolicy(max_iters=2, tol=1e-14))
    x = sess.solve(h2, bs[1].astype(np.float32))
    assert _gate(spd, x, bs[1], np.float32) <= 30
    assert sess.metrics.get("refine_fallbacks_total") == 2
    assert sess.factor(h2).payload[0].dtype == torch.float32
    sess.solve(h2, bs[2].astype(np.float32))
    assert sess.metrics.get("refine_fallbacks_total") == 2


@pytest.mark.parametrize("op", ["chol", "lu", "chol_small"])
def test_warmup_of_a_refined_operator_adds_no_later_compiles(op):
    spd, gen, *_, bs = _operands()
    sess = stt.Session(device="cpu")
    a = (spd if op.startswith("chol") else gen).astype(np.float32)
    A = (a if op == "chol_small" else
         stt.hermitian(np.tril(a), NB, stt.Uplo.Lower, device="cpu")
         if op == "chol" else stt.from_dense(a, NB, device="cpu"))
    h = sess.register(A, op=op, refine=True)
    sess.warmup(h)
    before = sess.metrics.get("aot_compiles")
    for i in range(3):
        x = sess.solve(h, bs[i].astype(np.float32))
        assert _gate(a, x, bs[i], np.float32) <= 30
    assert sess.metrics.get("aot_compiles") == before == 0
    assert sess.metrics.get("cache_misses") == 1


def test_lo_factor_failure_takes_the_counted_fallback():
    *_, bad, _ = _operands()
    rng = np.random.default_rng(5)
    b = rng.standard_normal(16).astype(np.float32)
    sess = stt.Session(device="cpu")
    hs = sess.register(bad.astype(np.float32), op="chol_small", refine=True)
    hd = sess.register(stt.hermitian(np.tril(bad).astype(np.float32), 8,
                                     stt.Uplo.Lower, device="cpu"),
                       op="chol", refine=True)
    for h in (hs, hd):
        x = sess.solve(h, b)
        assert _gate(bad, x, b, np.float32) <= 30
        assert sess.degrade_class(h) == "dense"
    assert sess.metrics.get("refine_fallbacks_total") == 2
    h3 = sess.register(bad.astype(np.float32), op="chol_small",
                       refine=stt.RefinePolicy(fallback=False))
    with pytest.raises(SlateError, match="disables fallback"):
        sess.solve(h3, b)


def test_grouped_mixed_bucket():
    _, _, small, _, bs = _operands()
    small = small.astype(np.float32)
    sess = stt.Session(device="cpu")
    pol = stt.RefinePolicy()
    hs = [sess.register(m, op="lu_small", refine=pol) for m in small]
    plain = sess.register(small[0], op="lu_small")
    assert sess.small_group_key(hs[0]) == ("lu_small", 24, "float32", pol)
    assert sess.small_group_key(plain) == ("lu_small", 24, "float32")
    rhs = [bs[i, :24].astype(np.float32) for i in range(3)]
    xs, infos = sess.solve_small_batched(hs, rhs)
    assert infos == [0, 0, 0]
    for h, m, b, x in zip(hs, small, rhs, xs):
        assert np.abs(sess.solve(h, b) - x).max() <= 1e-6 * np.abs(x).max()
        assert _gate(m, x, b, np.float32) <= 30
    # with two columns the grouped lanes are the per-request solves'
    rhs2 = [np.stack([b, b[::-1]], 1) for b in rhs]
    xs2, _ = sess.solve_small_batched(hs, rhs2)
    for h, b, x in zip(hs, rhs2, xs2):
        assert np.array_equal(sess.solve(h, b), x)
    with pytest.raises(SlateError, match="mixed bucket"):
        sess.solve_small_batched([hs[0], plain], rhs[:2])
    # a per-item fallback leaves its neighbours' bits alone
    tight = stt.RefinePolicy(max_iters=1, tol=1e-14)
    sess2 = stt.Session(device="cpu")
    hs2 = [sess2.register(m, op="lu_small", refine=tight) for m in small]
    xs2, infos2 = sess2.solve_small_batched(hs2, rhs)
    assert infos2 == [0, 0, 0]
    assert sess2.metrics.get("refine_fallbacks_total") == 3
    for m, b, x in zip(small, rhs, xs2):
        assert _gate(m, x, b, np.float32) <= 30


def _executor_run(port: bool):
    spd, *_, bs = _operands()
    pkg = _Pkg(port)
    sess = pkg.session()
    h = sess.register(pkg.chol(spd.astype(np.float32)), op="chol",
                      refine=True)
    sess.warmup(h)
    sess.enable_faults(
        FaultPlan(seed=5, specs=(FaultSpec("dispatch_error", rate=1.0,
                                           count=2),)) if port else
        RefPlan(seed=5, specs=(RefSpec("dispatch_error", rate=1.0,
                                       count=2),)))
    Ex = Executor if port else RefExecutor
    served, classes = [], []
    with Ex(sess, max_batch=1, max_wait=1e-3, retries=0,
            breaker_threshold=2, breaker_cooldown=60.0) as ex:
        for i in range(4):
            b = bs[i].astype(np.float32)
            f = ex.submit(h, b)
            err = f.exception(timeout=60)
            served.append(err is None)
            if err is None:
                assert _gate(spd, f.result(), b, np.float32) <= 30
            classes.append(sess.degrade_class(h))
    m = sess.metrics
    return (served, classes, m.get("refine_demotions_total"),
            m.get("breaker_trips_total"), m.get("degraded_dispatches_total")
            > 0)


def test_breaker_on_a_mixed_bucket_walks_the_working_precision_rung():
    port = _executor_run(True)
    assert port == _executor_run(False)
    served, classes, demotions, trips, degraded = port
    assert served == [False, True, True, True]
    assert classes == ["mixed", "dense", "dense", "dense"]
    assert demotions == 1 and trips == 1 and degraded
