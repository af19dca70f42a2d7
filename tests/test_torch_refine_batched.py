"""The batched mixed-precision verbs against the reference, on the CPU.

- ``gesv_mixed_batched`` / ``posv_mixed_batched`` (f32 ← bf16, f64 ← f32,
  c128 ← c64) and the low-precision factors and refined solves behind
  them: every item under the scaled-residual gate (‖B − A·X‖max /
  (‖A‖∞·‖X‖max·ε·n) ≤ 30 in float64) and within 10·n·ε·κ₁(Aᵢ) of the
  reference's X; the same per-item iteration counts where the factors
  agree (f64 ← f32);
- per-item isolation: a singular item flags its own info and iters, its
  neighbours' lanes are bit for bit those of a bucket without it; the
  fallback splice re-solves only the non-converged items at working
  precision and leaves the other lanes' bits alone;
- a B = 1 run equals its lane of a B = 8 bucket bit for bit (the port's
  invariant on the CPU: a converged lane is never written again);
- the kind guards: a complex operand with a real factor type raises, and
  complex64 has no default factor type.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.linalg import batched as port_batched

torch.set_num_threads(2)

EPS = {"float32": 2.0 ** -23, "float64": 2.0 ** -52,
       "complex128": 2.0 ** -52}


def _stack(dtype, bsz, n, spd, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, n, n))
    b = rng.standard_normal((bsz, n, 2))
    if dtype.startswith("complex"):
        x = x + 1j * rng.standard_normal((bsz, n, n))
        b = b + 1j * rng.standard_normal((bsz, n, 2))
    if spd:
        a = x @ np.conj(np.swapaxes(x, 1, 2)) / n + np.eye(n)
    else:
        a = x / np.sqrt(n) + 2 * np.eye(n)
    return a.astype(dtype), b.astype(dtype)


def _scaled(a, x, b, dtype):
    w = np.complex128 if np.iscomplexobj(a) else np.float64
    a, x, b = (np.asarray(v, w) for v in (a, x, b))
    return (np.abs(b - a @ x).max()
            / (np.abs(a).sum(1).max() * np.abs(x).max() * EPS[dtype]
               * a.shape[0]))


def _kappa1(a):
    w = np.complex128 if np.iscomplexobj(a) else np.float64
    a = a.astype(w)
    return np.linalg.norm(a, 1) * np.linalg.norm(np.linalg.inv(a), 1)


@pytest.mark.parametrize("verb", ["gesv", "posv"])
@pytest.mark.parametrize("work,lo", [("float32", "bfloat16"),
                                     ("float64", "float32"),
                                     ("complex128", "complex64")])
def test_mixed_batched_verbs_against_the_reference(verb, work, lo):
    bsz, n = 5, 45
    a, b = _stack(work, bsz, n, verb == "posv", seed=1)
    ref = getattr(st, f"{verb}_mixed_batched")
    port = getattr(stt, f"{verb}_mixed_batched")
    store = np.tril(a) if verb == "posv" else a  # lower storage
    rx, rinfo, riters = ref(store, b, factor_dtype=jnp.dtype(lo))
    px, pinfo, piters = port(store, b, factor_dtype=lo, device="cpu")
    assert np.array_equal(pinfo.numpy(), np.asarray(rinfo))
    assert (piters.numpy() > 0).all() and (np.asarray(riters) > 0).all()
    if work == "float64":
        assert np.array_equal(piters.numpy(), np.asarray(riters))
    for i in range(bsz):
        xi = px[i].numpy()
        assert _scaled(a[i], xi, b[i], work) <= 30
        rel = np.abs(xi - np.asarray(rx[i])).max() / np.abs(xi).max()
        assert rel <= 10 * n * EPS[work] * _kappa1(a[i])


def test_low_factors_and_refined_solves_compose():
    bsz, n = 4, 40
    a, b = _stack("float32", bsz, n, False, seed=2)
    lu, perm, info = port_batched.getrf_mixed_batched(a, device="cpu")
    assert lu.dtype == torch.bfloat16 and (info == 0).all()
    x, iters, conv = port_batched.getrs_refined_batched(a, lu, perm, b,
                                                        device="cpu")
    X, _, iters2 = port_batched.gesv_mixed_batched(a, b, device="cpu")
    assert conv.all() and torch.equal(x, X) and torch.equal(iters, iters2)
    s, bs = _stack("float32", bsz, n, True, seed=3)
    l, info = port_batched.potrf_mixed_batched(np.tril(s), device="cpu")
    assert l.dtype == torch.bfloat16 and (info == 0).all()
    x, iters, conv = port_batched.potrs_refined_batched(np.tril(s), l, bs,
                                                        device="cpu")
    assert conv.all()
    for i in range(bsz):
        assert _scaled(s[i], x[i].numpy(), bs[i], "float32") <= 30
    # a vector right-hand side keeps its rank
    xv, _, _ = port_batched.gesv_mixed_batched(a, b[:, :, 0], device="cpu")
    assert xv.shape == (bsz, n) and torch.equal(xv, X[:, :, 0])


def test_per_item_info_isolation_and_fallback_splice():
    bsz, n = 6, 40
    a, b = _stack("float32", bsz, n, False, seed=4)
    bad = a.copy()
    bad[2] = 0.0  # singular in every precision
    X0, info0, it0 = stt.gesv_mixed_batched(a, b, fallback=False,
                                            device="cpu")
    X, info, iters = stt.gesv_mixed_batched(bad, b, fallback=False,
                                            device="cpu")
    assert int(info[2]) > 0 and int(iters[2]) < 0
    keep = [i for i in range(bsz) if i != 2]
    assert torch.equal(X[keep], X0[keep]) and torch.equal(iters[keep],
                                                          it0[keep])
    # the reference flags the same item the same way
    _, rinfo, riters = st.gesv_mixed_batched(bad, b)
    assert int(np.asarray(rinfo)[2]) > 0 and int(np.asarray(riters)[2]) < 0
    # the fallback splice: only the item that did not converge is
    # solved again at working precision; the others keep their bits
    s, bs = _stack("float32", bsz, 16, True, seed=5)
    s[3] = np.ones((16, 16)) + 1e-3 * np.eye(16)  # indefinite in bf16
    Xs, infos, its = stt.posv_mixed_batched(s, bs, device="cpu")
    Xn, _, itn = stt.posv_mixed_batched(s, bs, fallback=False,
                                        device="cpu")
    assert int(its[3]) < 0 and int(infos[3]) == 0
    assert _scaled(s[3], Xs[3].numpy(), bs[3], "float32") <= 30
    others = [i for i in range(bsz) if i != 3]
    assert torch.equal(Xs[others], Xn[others])
    assert torch.equal(its, itn)
    wx, winfo = stt.posv_batched(s[3:4], bs[3:4], device="cpu")
    assert torch.equal(Xs[3], wx[0]) and int(winfo[0]) == 0


@pytest.mark.parametrize("verb", ["gesv", "posv"])
def test_b1_run_equals_its_lane_of_a_bucket(verb):
    a, b = _stack("float32", 8, 33, verb == "posv", seed=6)
    fn = getattr(stt, f"{verb}_mixed_batched")
    X8, info8, it8 = fn(a, b, device="cpu")
    for i in (0, 5):
        X1, info1, it1 = fn(a[i:i + 1], b[i:i + 1], device="cpu")
        assert torch.equal(X1[0], X8[i])
        assert int(it1[0]) == int(it8[i]) and int(info1[0]) == int(info8[i])


def test_mixed_batched_kind_guards():
    a, b = _stack("complex128", 2, 8, False, seed=7)
    with pytest.raises(SlateError, match="both be real or both complex"):
        stt.gesv_mixed_batched(a, b, factor_dtype="bfloat16", device="cpu")
    with pytest.raises(SlateError, match="no lower factor precision"):
        stt.gesv_mixed_batched(a.astype(np.complex64), b.astype(
            np.complex64), device="cpu")
    with pytest.raises(SlateError):
        port_batched.getrf_mixed_batched(a, factor_dtype="float32",
                                         device="cpu")
    # the default follows the ladder: c128 → c64
    X, info, iters = stt.gesv_mixed_batched(a, b, device="cpu")
    assert (info == 0).all() and (iters > 0).all()
