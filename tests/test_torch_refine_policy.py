"""The port's refine policy against the reference's, and the package rules
of the mixed-precision slice, on the CPU.

- ``RefinePolicy`` / ``PolicyTable`` / the dtype ladder: on the same rule
  lists and queries (carve-out holes, op and dtype guards, n ranges, the
  ladder default) the port resolves, rejects (the same error type and
  message) and hashes as the reference does;
- ``check_cast_kinds`` and ``validate_for`` give the reference's messages;
- no module of the port, and not chip_smoke.py, imports ``ml_dtypes``;
- ``interop.reference.factor_from_arrays`` carries the reference's
  low-precision payloads (bfloat16 as ``ml_dtypes`` arrays, float32,
  complex64) into the port bit for bit.
"""

import ast
import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from slate_tpu.refine import policy as ref_policy
import slate_tpu_torch as stt
from slate_tpu_torch.interop.reference import (factor_from_arrays,
                                               tiled_from_arrays)
from slate_tpu_torch.refine import policy as port_policy

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
RNG = np.random.default_rng(18)


def _fields(p):
    return None if p is None else dataclasses.astuple(p)


@pytest.mark.parametrize("dtype", ["float64", "float32", "complex128",
                                   "complex64", "bfloat16", "bf16",
                                   np.float32, np.complex128])
def test_dtype_ladder_and_names(dtype):
    assert (port_policy.canonical_dtype_name(dtype)
            == ref_policy.canonical_dtype_name(dtype))
    assert (port_policy.default_factor_dtype(dtype)
            == ref_policy.default_factor_dtype(dtype))


def test_torch_dtypes_resolve_like_numpy_names():
    for td, name in ((torch.float32, "float32"), (torch.float64, "float64"),
                     (torch.bfloat16, "bfloat16"),
                     (torch.complex64, "complex64")):
        assert port_policy.canonical_dtype_name(td) == name
        assert port_policy.torch_dtype(name) is td
    assert port_policy.default_factor_dtype(torch.float32) == "bfloat16"
    assert port_policy.default_factor_dtype(torch.complex64) is None
    with pytest.raises((TypeError, ValueError)):
        port_policy.torch_dtype("int33")


def _both(fn):
    """(type, message) or ("ok", value) of ``fn`` on each package."""
    out = []
    for mod in (ref_policy, port_policy):
        try:
            out.append(("ok", fn(mod)))
        except Exception as e:  # noqa: BLE001 — compared across packages
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("kw", [
    {}, {"factor_dtype": "float32"}, {"factor_dtype": np.float32},
    {"strategy": "gmres", "max_iters": 5, "tol": 1e-9},
    {"residual_dtype": "float64"}, {"strategy": "lsqr"}, {"max_iters": 0},
    {"factor_dtype": "complex64", "fallback": False}])
def test_policy_construction_and_hash(kw):
    ref, port = _both(lambda m: m.RefinePolicy(**kw))
    assert ref[0] == port[0]
    if ref[0] == "ok":
        assert _fields(ref[1]) == _fields(port[1])
        assert hash(port[1]) == hash(port_policy.RefinePolicy(**kw))
        assert port[1] == port_policy.RefinePolicy(**kw)
    else:
        assert ref[1] == port[1]


@pytest.mark.parametrize("factor,working", [
    ("bfloat16", "float32"), ("float32", "float32"), ("bfloat16",
                                                      "complex64"),
    ("complex64", "complex128"), ("complex64", "float64"),
    ("float32", "float64")])
def test_validate_for_and_cast_kinds(factor, working):
    ref, port = _both(lambda m: m.RefinePolicy(
        factor_dtype=factor).validate_for(working).factor_dtype)
    assert ref == port
    ref, port = _both(lambda m: m.check_cast_kinds(working, factor, "what"))
    assert ref == port


def _rules(mod):
    P = mod.RefinePolicy
    return (mod.PolicyTable()
            .add(None, op="chol", dtype="float32", n_max=63)
            .add(P(factor_dtype="bfloat16", max_iters=9), op="chol")
            .add(P(factor_dtype="float32", strategy="gmres"), op="lu",
                 dtype=np.float64, n_min=100, n_max=300)
            .add(None, dtype="complex128", n_min=500)
            .add(P(factor_dtype="float32", tol=1e-12), dtype="float64"))


@pytest.mark.parametrize("op", ["chol", "lu"])
@pytest.mark.parametrize("n", [1, 63, 64, 100, 300, 301, 500, 4096])
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128",
                                   "complex64"])
def test_policy_table_resolves_as_the_reference(op, n, dtype):
    ref_t, port_t = _rules(ref_policy), _rules(port_policy)
    rm, rp = ref_t.lookup(op, n, dtype)
    pm, pp = port_t.lookup(op, n, dtype)
    assert (rm, _fields(rp)) == (pm, _fields(pp))
    for default in (True, False):
        assert (_fields(ref_t.resolve(op, n, dtype, default=default))
                == _fields(port_t.resolve(op, n, dtype, default=default)))


def test_policy_table_rules_introspection():
    ref_rules = _rules(ref_policy).rules()
    port_rules = _rules(port_policy).rules()
    assert [r[:4] for r in ref_rules] == [r[:4] for r in port_rules]
    assert ([_fields(r[4]) for r in ref_rules]
            == [_fields(r[4]) for r in port_rules])


# -- package rules ----------------------------------------------------------


def _port_sources():
    for d, _, files in os.walk(os.path.join(ROOT, "slate_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "profile_factors.py")


def test_port_imports_no_ml_dtypes():
    sources = list(_port_sources())
    assert any(s.endswith(os.path.join("refine", "engine.py"))
               for s in sources)
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "ml_dtypes", "jax", "jaxlib", "slate_tpu"), (path, name)


# -- interop of low-precision payloads ----------------------------------------


def test_bf16_payloads_cross_by_their_bits():
    n, nb = 45, 16
    npad = 48
    l = np.tril(RNG.standard_normal((npad, npad))).astype(ml_dtypes.bfloat16)
    (L,) = factor_from_arrays("chol", (l,), nb=nb, logical_shape=(n, n),
                              device="cpu")
    assert L.dtype == torch.bfloat16 and L.shape == (n, n)
    want = np.asarray(l, np.float32)
    want[n:, :] = 0
    want[:, n:] = 0
    assert np.array_equal(L.data.float().numpy(), want)
    lu = RNG.standard_normal((npad, npad)).astype(ml_dtypes.bfloat16)
    perm = RNG.permutation(npad).astype(np.int32)
    LU, p = factor_from_arrays("lu", (lu, perm), nb=nb, logical_shape=(n, n),
                               device="cpu")
    assert LU.dtype == torch.bfloat16 and p.dtype == torch.int32
    assert np.array_equal(LU.data[:n, :n].view(torch.int16).numpy(),
                          lu[:n, :n].view(np.int16))
    assert np.array_equal(p.numpy(), perm)
    # a bf16 operand too, and the other low types unchanged
    A = tiled_from_arrays(lu, nb=nb, logical_shape=(n, n), device="cpu")
    assert A.dtype == torch.bfloat16
    for dt, tdt in ((np.float32, torch.float32),
                    (np.complex64, torch.complex64)):
        x = (RNG.standard_normal((npad, npad))
             + (1j * RNG.standard_normal((npad, npad))
                if dt is np.complex64 else 0)).astype(dt)
        (L2,) = factor_from_arrays("chol", (x,), nb=nb,
                                   logical_shape=(npad, npad), device="cpu")
        assert L2.dtype == tdt and np.array_equal(L2.data.numpy(), x)


def test_package_exports_the_mixed_verbs():
    for name in ("gesv_mixed", "posv_mixed", "gesv_mixed_gmres",
                 "posv_mixed_gmres", "gesv_mixed_batched",
                 "posv_mixed_batched", "RefinePolicy", "PolicyTable"):
        assert hasattr(stt, name), name
